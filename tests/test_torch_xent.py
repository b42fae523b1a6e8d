"""The port's chunked fused cross-entropy against the JAX package.

``horovod_tpu_torch.ops.xent.fused_cross_entropy`` takes the head as
``nn.Linear.weight [V, E]``; the JAX function takes ``[E, V]``, so the
JAX side gets the transpose of the same numpy weights. Inputs come from
numpy seeds.

* Over tests/test_xent.py's (T, chunk) grid, T not always a multiple of
  the chunk (the padded rows): the loss to 1e-6 relative, ``dh`` and
  ``dw`` to rtol 1e-5 / atol 1e-6, against the JAX fused op and against
  the port's dense composition (float32 summation order only).
* bfloat16 hidden states: the loss to 1e-5, ``dh`` (returned in bf16) to
  rtol 2e-2 / atol 1e-3 (one bf16 ulp is 2^-8), ``dw`` to rtol 1e-4 /
  atol 1e-5, test_xent's tolerances.
* ``weights``/``denom``: the weighted loss as JAX computes it, and no
  gradient reaches them.
* ``next_token_nll_fused`` on the port's ``lm_apply`` hidden states
  against the JAX function and against the dense ``next_token_nll``.
* The bench lane's fused loss (``models.train.fused_next_token_loss``)
  on a flax ``TransformerLM``'s weights against JAX's ``loss_fn`` of
  ``bench.py --fused-ce``: loss 1e-5 relative, every gradient rtol 1e-4
  / atol 1e-6 (two float32 networks, summation order only).
* A ``TorchDispatchMode`` records the shape of every tensor the fused
  step creates (forward, loss, backward, update): none has ``T * V``
  elements or more, while the unfused step makes ``[B, L, V]`` logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import parallel_lm as jplm
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu.ops.xent import fused_cross_entropy as jfused
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import parallel_lm as tplm
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                  flax_parameter_map,
                                                  params_from_flax)
from horovod_tpu_torch.ops import xent


def _inputs(t, e, v, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, e)).astype(np.float32)
    w = rng.standard_normal((e, v)).astype(np.float32)
    return h, w, rng.integers(0, v, t)


def _port(h, w_ev, targets, chunk, h_dtype=torch.float32, **kw):
    """Loss, dh, dw of the port (``w_ev`` is the JAX [E, V] layout)."""
    th = torch.tensor(h).to(h_dtype).requires_grad_()
    tw = torch.tensor(w_ev.T.copy()).requires_grad_()
    loss = xent.fused_cross_entropy(th, tw, torch.tensor(targets), chunk,
                                    **kw)
    loss.backward()
    return (float(loss.detach()), th.grad, tw.grad.numpy().T)


def _port_dense(h, w_ev, targets):
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w_ev.T.copy(), requires_grad=True)
    logp = torch.log_softmax(th @ tw.t(), dim=-1)
    loss = -logp.gather(1, torch.tensor(targets)[:, None]).mean()
    loss.backward()
    return float(loss.detach()), th.grad.numpy(), tw.grad.numpy().T


@pytest.mark.parametrize("t,chunk", [(64, 16), (60, 16), (16, 16)])
def test_fused_cross_entropy_matches_jax_and_dense(t, chunk):
    h, w, tg = _inputs(t, 32, 97, seed=t)
    lj, (dhj, dwj) = jax.value_and_grad(
        lambda h, w: jfused(h, w, jnp.asarray(tg), chunk),
        argnums=(0, 1))(h, w)
    loss, dh, dw = _port(h, w, tg, chunk)
    for want_l, want_dh, want_dw in (
            (float(lj), np.asarray(dhj), np.asarray(dwj)),
            _port_dense(h, w, tg)):
        np.testing.assert_allclose(loss, want_l, rtol=1e-6)
        np.testing.assert_allclose(dh.numpy(), want_dh, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dw, want_dw, rtol=1e-5, atol=1e-6)


def test_fused_cross_entropy_bf16_hidden():
    h, w, tg = _inputs(48, 16, 53, seed=3)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    lj, (dhj, dwj) = jax.value_and_grad(
        lambda h, w: jfused(h.astype(jnp.float32), w, jnp.asarray(tg), 16),
        argnums=(0, 1))(jnp.asarray(h, jnp.bfloat16), w)
    loss, dh, dw = _port(hb, w, tg, 16, h_dtype=torch.bfloat16)
    assert dh.dtype == torch.bfloat16
    np.testing.assert_allclose(loss, float(lj), rtol=1e-5)
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(dhj, np.float32),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(dw, np.asarray(dwj), rtol=1e-4, atol=1e-5)


def test_weights_and_denom_are_bookkeeping():
    h, w, tg = _inputs(40, 8, 29, seed=5)
    wts = (np.random.default_rng(6).random(40) > 0.3).astype(np.float32)
    denom = np.float32(7.0)
    lj, (dhj, dwj) = jax.value_and_grad(
        lambda h, w: jfused(h, w, jnp.asarray(tg), 16,
                            weights=jnp.asarray(wts), denom=denom),
        argnums=(0, 1))(h, w)
    tw_ = torch.tensor(wts, requires_grad=True)
    td = torch.tensor(denom, requires_grad=True)
    loss, dh, dw = _port(h, w, tg, 16, weights=tw_, denom=td)
    np.testing.assert_allclose(loss, float(lj), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dhj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw, np.asarray(dwj), rtol=1e-5, atol=1e-6)
    for x in (tw_, td):
        assert x.grad is None or not x.grad.any()


def test_next_token_nll_fused_matches_jax():
    key = jax.random.PRNGKey(2)
    jp = jplm.init_lm_params(key, 64, 32, 2, 2, 8, 32)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 24))
    hidden = np.asarray(jplm.lm_apply(jp, jnp.asarray(tokens),
                                      return_hidden=True))

    def jloss(hidden, head):
        return jplm.next_token_nll_fused({**jp, "head": head}, hidden,
                                         jnp.asarray(tokens), t_chunk=16)

    lj, (dhj, dwj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jp["head"])
    tp = tplm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    th = torch.tensor(hidden, requires_grad=True)
    head = tp["head"].clone().requires_grad_()
    loss = tplm.next_token_nll_fused({**tp, "head": head}, th,
                                     torch.tensor(tokens), t_chunk=16)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dhj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(head.grad.numpy(), np.asarray(dwj),
                               rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        dense = tplm.next_token_nll(
            tplm.lm_apply(tp, torch.tensor(tokens)), torch.tensor(tokens))
    want = float(jplm.next_token_nll(jplm.lm_apply(jp, jnp.asarray(tokens)),
                                     jnp.asarray(tokens)))
    np.testing.assert_allclose(float(dense), want, rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(dense),
                               rtol=1e-6)


def test_unported_parallel_losses_raise():
    with pytest.raises(NotImplementedError, match="Queue 1, parallelism"):
        xent.tp_vocab_cross_entropy(None, None, None, "tp")
    params = tplm.init_lm_params(0, 16, 8, 1, 1, 4, 8, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    hidden = torch.zeros((1, 8, 4))
    for kw in (dict(sp="sp"), dict(tp="tp"), dict(vocab_parallel=True)):
        with pytest.raises(NotImplementedError, match="parallelism"):
            tplm.next_token_nll_fused(params, hidden, tokens, **kw)
    with pytest.raises(ValueError, match="t_chunk"):
        xent.fused_cross_entropy(torch.zeros(4, 2), torch.zeros(3, 2),
                                 torch.zeros(4, dtype=torch.long), 0)


# ------------------------------------------ the bench lane's fused loss

CFG = dict(vocab_size=96, num_layers=2, num_heads=2, embed_dim=16,
           max_len=32)


@pytest.fixture(scope="module")
def lm():
    # 24 x 31 = 744 scored tokens: two chunks of 512, the second padded,
    # so one chunk block holds fewer than T * V elements.
    tokens = np.random.default_rng(0).integers(0, 96, (24, 32)).astype(
        np.int32)
    params = JLM(**CFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens), train=False)["params"]
    return tokens, jax.tree_util.tree_map(np.asarray, params)


def _model(params, **kw):
    return params_from_flax(params, TransformerLM(
        **CFG, dtype=torch.float32, device="cpu", **kw))


def test_bench_fused_loss_matches_the_jax_lane(lm):
    tokens, params = lm
    jmodel = JLM(**CFG, dtype=jnp.float32)
    jt = jnp.asarray(tokens)

    def loss_fn(params):          # bench.py's --fused-ce loss_fn
        hidden = jmodel.apply({"params": params}, jt, train=False,
                              return_hidden=True)
        e = hidden.shape[-1]
        h = hidden[:, :-1].reshape(-1, e).astype(jnp.float32)
        wv = params["lm_head"]["kernel"].astype(jnp.float32)
        return jfused(h, wv, jt[:, 1:].reshape(-1))

    lj, gj = jax.value_and_grad(loss_fn)(params)
    model = _model(params)
    loss = ttrain.fused_next_token_loss(model, torch.tensor(tokens).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    for path, p, t in flax_parameter_map(model):
        want = np.asarray(functools.reduce(lambda d, k: d[k], path, gj))
        got = p.grad.numpy()
        np.testing.assert_allclose(got.T if t else got, want, rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))


def _created_shapes(step, tokens):
    shapes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    shapes.append(tuple(o.shape))
            return out

    with Record():
        step(tokens)
    return shapes


@pytest.mark.parametrize("remat", [False, True])
def test_fused_step_never_builds_full_logits(lm, remat, monkeypatch):
    # Chunks of 512 tokens: the 744 scored tokens span two of them.
    monkeypatch.setattr(ttrain, "FUSED_CE_CHUNK", 512)
    tokens, params = lm
    tt = torch.tensor(tokens).long()
    B, L = tokens.shape
    T, V = B * (L - 1), CFG["vocab_size"]
    basics.init(device="cpu")
    try:
        made = {}
        for fused in (False, True):
            model = _model(params, remat=remat)
            opt = ttrain.create_train_state(
                model, torch.optim.Adam(model.parameters(), lr=1e-3),
                device="cpu")
            step = ttrain.make_train_step(model, opt, fused_ce=fused)
            made[fused] = _created_shapes(step, tt)
    finally:
        basics.shutdown()
    big = {f: [s for s in shapes if int(np.prod(s)) >= T * V]
           for f, shapes in made.items()}
    assert (B, L, V) in big[False]       # the unfused step's logits
    assert not big[True], big[True]
    assert len(made[True]) > 100         # the mode saw the whole step


def test_fused_ce_step_trains_like_the_unfused_step(lm):
    """Three Adam steps with and without fused_ce from the same weights:
    losses to 1e-6 relative, parameters to 1e-6 absolute (lr 1e-3; a
    wrong gradient moves a parameter by about the learning rate)."""
    tokens, params = lm
    tt = torch.tensor(tokens).long()
    out = {}
    basics.init(device="cpu")
    try:
        for fused in (False, True):
            model = _model(params)
            opt = ttrain.create_train_state(
                model, torch.optim.Adam(model.parameters(), lr=1e-3),
                device="cpu")
            step = ttrain.make_train_step(model, opt, fused_ce=fused)
            losses = [float(step(tt)) for _ in range(3)]
            out[fused] = losses, [p.detach().numpy()
                                  for p in model.parameters()]
    finally:
        basics.shutdown()
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
