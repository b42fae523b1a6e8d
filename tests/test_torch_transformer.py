"""Parity of the port's TransformerLM and training step with the JAX package.

A flax ``horovod_tpu.models.TransformerLM`` is initialised by JAX; its
parameter tree, mapped to numpy, is carried into the port's module with
``params_from_flax``; the same numpy-seeded tokens go through both.

* Float32 logits agree to 1e-5 (one float32 network, summation order
  only), with dense attention and with the flash kernels' plain
  versions.
* bfloat16 compute logits agree to 5e-2 absolute on logits of unit
  scale: both round every Dense output, the embeddings and the residual
  stream to bfloat16, but XLA and PyTorch round elementwise chains
  (gelu, the bias add) at different points, one bfloat16 ulp (2^-8
  relative) at a time, and two layers compound it.
* Flash against dense inside the port, loss and gradients: ``rtol 5e-4,
  atol 5e-5``, the tolerance of tests/test_models.py's JAX pin.
* Three Adam steps of ``make_train_step`` (under ``DistributedOptimizer``
  in a world of one) against JAX ``create_train_state`` +
  ``apply_gradients`` with the bench lane's loss: the losses agree to
  1e-5 relative and the parameters to 2e-6 absolute. Adam's update
  ``m / (sqrt(v) + eps)`` is near ``lr * sign(g)`` for every gradient
  well above ``eps``, so parameters move by about 1e-4 a step whichever
  framework rounds; the bound leaves room for the few gradients near
  ``eps = 1e-8``, where the two frameworks' last-digit differences in g
  change the step, and fails on any real divergence (a wrong gradient
  moves a parameter by up to 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu.ops.attention import flash_attention as jflash_attention
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                  flax_parameter_map,
                                                  params_from_flax)
from horovod_tpu_torch.ops.attention import flash_attention

CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
           max_len=32)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 32, (2, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params(tokens):
    params = JLM(**CFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def world():
    """A gloo world of one for the port's collectives."""
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _port(flax_params, **kw):
    kw.setdefault("dtype", torch.float32)
    return params_from_flax(flax_params,
                            TransformerLM(**CFG, device="cpu", **kw))


def _jax_logits(params, tokens, **kw):
    kw.setdefault("dtype", jnp.float32)
    return np.asarray(JLM(**CFG, **kw).apply(
        {"params": params}, jnp.asarray(tokens), train=False))


def test_parameter_map_matches_the_flax_tree(flax_params):
    model = TransformerLM(**CFG, device="cpu")
    leaves = {tuple(str(getattr(k, "key", k)) for k in path): np.shape(v)
              for path, v in jax.tree_util.tree_leaves_with_path(
                  flax_params)}
    got = {path: tuple(p.shape[::-1] if t else p.shape)
           for path, p, t in flax_parameter_map(model)}
    assert got == leaves
    assert len(got) == len(list(model.parameters()))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_float32_logits_match_flax(flax_params, tokens, attn):
    flash = functools.partial(flash_attention, causal=True)
    jflash = functools.partial(jflash_attention, causal=True)
    want = _jax_logits(flax_params, tokens,
                       attn_fn=None if attn == "dense" else jflash)
    model = _port(flax_params, attn_fn=None if attn == "dense" else flash)
    with torch.no_grad():
        got = model(torch.tensor(tokens, dtype=torch.long))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pos_offset_and_hidden_match_flax(flax_params, tokens):
    want = np.asarray(JLM(**CFG, dtype=jnp.float32).apply(
        {"params": flax_params}, jnp.asarray(tokens), train=False,
        pos_offset=5, return_hidden=True))
    with torch.no_grad():
        got = _port(flax_params)(torch.tensor(tokens, dtype=torch.long),
                                 pos_offset=5, return_hidden=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bfloat16_compute_logits_match_flax(flax_params, tokens):
    want = _jax_logits(flax_params, tokens, dtype=jnp.bfloat16)
    model = _port(flax_params, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.tensor(tokens, dtype=torch.long))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)


def _loss_and_grads(model, tokens):
    model.zero_grad()
    t = torch.tensor(tokens, dtype=torch.long)
    loss = ttrain.next_token_loss(model(t), t)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_flash_model_trains_like_dense(flax_params, tokens, impl):
    flash = functools.partial(flash_attention, causal=True, bwd_impl=impl)
    ld, gd = _loss_and_grads(_port(flax_params), tokens)
    lf, gf = _loss_and_grads(_port(flax_params, attn_fn=flash), tokens)
    np.testing.assert_allclose(lf, ld, rtol=1e-5)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5)


def test_remat_gives_the_same_gradients(flax_params, tokens):
    _, g = _loss_and_grads(_port(flax_params), tokens)
    _, gr = _loss_and_grads(_port(flax_params, remat=True), tokens)
    for a, b in zip(gr, g):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_next_token_loss_matches_the_bench_loss(tokens):
    logits = np.random.default_rng(3).standard_normal(
        (2, 16, 32)).astype(np.float32)
    lp = jax.nn.log_softmax(jnp.asarray(logits)[:, :-1])
    want = float(jnp.mean(-jnp.take_along_axis(
        lp, jnp.asarray(tokens)[:, 1:, None], -1)))
    got = float(ttrain.next_token_loss(torch.tensor(logits),
                                       torch.tensor(tokens)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_three_adam_steps_match_jax(hvd, world, flax_params, tokens):
    jmodel = JLM(**CFG, dtype=jnp.float32)
    state, opt = jmodels.create_train_state(
        jax.random.PRNGKey(0), jmodel, optax.adam(1e-4),
        jnp.asarray(tokens))
    start = jax.tree_util.tree_map(np.asarray, state["params"])
    jt = jnp.asarray(tokens)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jt, train=False)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return jnp.mean(-jnp.take_along_axis(logp, jt[:, 1:, None], -1))

    model = _port(start)
    topt = ttrain.create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-4), device="cpu")
    step = ttrain.make_train_step(model, topt)
    tt = torch.tensor(tokens, dtype=torch.long)
    for _ in range(3):
        jloss, grads = jax.value_and_grad(loss_fn)(state["params"])
        state = jmodels.apply_gradients(opt, state, grads)
        tloss = step(tt)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    final = jax.tree_util.tree_map(np.asarray, state["params"])
    moved = 0.0
    for path, p, t in flax_parameter_map(model):
        want = functools.reduce(lambda d, k: d[k], path, final)
        got = p.detach().numpy()
        got = got.T if t else got
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                   err_msg="/".join(path))
        moved = max(moved, float(np.abs(got - functools.reduce(
            lambda d, k: d[k], path, start)).max()))
    assert moved > 2e-4        # three steps of lr 1e-4 really moved them


def test_create_train_state_and_model_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(**CFG)
    model = TransformerLM(**CFG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.create_train_state(model, torch.optim.Adam(
            model.parameters()))


def test_unported_and_malformed_inputs_raise(flax_params):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        TransformerLM(**CFG, scan_layers=True, device="cpu")
    bad = dict(flax_params)
    bad.pop("lm_head")
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(bad, TransformerLM(**CFG, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(flax_params, TransformerLM(
            **{**CFG, "vocab_size": 64}, device="cpu"))


def test_bench_defaults_are_the_jax_lane_defaults():
    import bench as jbench

    from horovod_tpu_torch import bench

    want = jbench.build_parser().parse_args(["--model", "transformer_lm"])
    got = bench.build_parser().parse_args([])
    for f in ("model", "seq_len", "lm_layers", "lm_dim", "lm_heads", "vocab",
              "fp32", "num_warmup_batches", "num_batches_per_iter",
              "num_iters"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.batch_size is None and got.batch_size == 8  # the LM's 8
    assert got.attention == "dense" and want.attention is None


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bench_lane_runs_a_tiny_model_on_the_cpu(attention):
    from horovod_tpu_torch import bench

    args = bench.build_parser().parse_args([
        "--seq-len", "16", "--batch-size", "2", "--lm-layers", "2",
        "--lm-dim", "16", "--lm-heads", "2", "--vocab", "32", "--fp32",
        "--attention", attention, "--num-warmup-batches", "1",
        "--num-batches-per-iter", "2", "--num-iters", "2"])
    try:
        rec = bench.run(args, device="cpu")
    finally:
        basics.shutdown()
    assert rec["metric"] == "tokens/sec" and rec["value"] > 0
    assert (rec["device"], rec["card"], rec["world_size"]) == ("cpu", "cpu",
                                                              1)
    assert rec["attention"] == attention and np.isfinite(rec["loss"])
    assert rec["buckets"]["count"] >= 1 and rec["replicas_in_sync"]


def test_bench_lane_defaults_to_the_card_and_waits_for_auto(monkeypatch):
    from horovod_tpu_torch import bench

    # --attention auto resolves by the H100's measured crossover: flash
    # at every length.
    for seq in (16, 2048, 8192):
        args = bench.build_parser().parse_args(
            ["--attention", "auto", "--seq-len", str(seq)])
        assert bench.resolve_attention(args) == "flash"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--num-iters", "1"])
    assert not basics.is_initialized()
