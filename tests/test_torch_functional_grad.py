"""Parity of the functional gradient API (``hvd.grad``,
``hvd.value_and_grad``, ``hvd.allreduce_gradients_transform``) with the
JAX package's (``horovod_tpu/jax/optimizer.py``).

One 4-rank gloo world for the module (``test_torch_tp.start_world``, in
a thread while the JAX side runs): every rank takes its 2 sequences of
one global batch of 8 and runs every case; its results are saved and
compared here with the JAX package's
``hvd.spmd_run`` over a 4-device virtual mesh on the same global batch
(the JAX package is initialised over 4 devices for this module and
restored after it). Two small LMs (2 layers, d_model 64):

* ``parallel_lm``: the JAX weights carried by ``params_from_numpy``;
* the flax ``TransformerLM`` on flash attention, carried by
  ``params_from_flax``: on the CPU the port's flash path is the plain
  version inside ``_FlashAttention``, the autograd Function the API
  differentiates through (its backward is counted).

Tolerances: float32, within 1e-5 of each leaf's largest entry (values
relative 1e-5). Outside an SPMD region the value is the rank's own;
inside one it is averaged, as in the JAX package. The int8 transform on
the ladder at inner 2 (2 "hosts" of 2) is held over two steps of
Gaussian gradients at the hierarchical tests' quantized tolerance: all
but at most 2% of the elements as the floats, the rest off by at most
one quantization step, where a quotient lands on a rounding tie
(``test_torch_hierarchical._close_but_for_ties``).
"""

import functools
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from test_torch_tp import start_world

WORLD = 4
B, L, V = 8, 16, 64                      # global batch, length, vocab
PLM = dict(vocab=V, max_len=L, layers=2, heads=4, head_dim=16, ffn=128)
FLM = dict(vocab_size=V, num_layers=2, num_heads=4, embed_dim=64,
           max_len=L)
THRESHOLD = 4096                          # several buckets over the LM
TX_STEPS = 2
SCALE = 0.75


def _tokens():
    return np.random.default_rng(7).integers(0, V, (B, L)).astype(np.int32)


def _tx_grads(shapes, rank, step):
    """Rank ``rank``'s Gaussian gradient tree for transform step
    ``step``, over the parallel_lm's leaf shapes (a dict of paths)."""
    rng = np.random.default_rng(1000 * step + rank)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _path_shapes(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_path_shapes(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_path_shapes(v, f"{prefix}{i:02d}/"))
    else:
        out[prefix[:-1]] = tuple(np.shape(tree))
    return out


# ------------------------------------------------------------ the ranks


def _np(tree):
    return torch.utils._pytree.tree_map(
        lambda t: t.detach().numpy() if torch.is_tensor(t) else t, tree)


def _worker(rank, n, init, out):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.compression import Compression
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      params_from_flax)
    from horovod_tpu_torch.ops import attention

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    hvd.init(device="cpu")
    with open(os.path.join(out, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    toks = torch.tensor(_tokens()[2 * rank:2 * rank + 2], dtype=torch.long)
    params = plm.params_from_numpy(weights["plm"], device="cpu")

    def loss(p, t):
        return plm.next_token_nll(plm.lm_apply(p, t), t)

    def loss_aux(p, t):
        logits = plm.lm_apply(p, t)
        return plm.next_token_nll(logits, t), {"mean": logits.mean()}

    def loss_scaled(p, scale, t):
        return scale * loss(p, t)

    res = {}
    vg = hvd.value_and_grad(loss)
    res["plm_out"] = _np(vg(params, toks))
    res["plm_in"] = _np(hvd.spmd_run(vg, params, toks))
    vga = hvd.value_and_grad(loss_aux, has_aux=True)
    res["aux_out"] = _np(vga(params, toks))
    res["aux_in"] = _np(hvd.spmd_run(vga, params, toks))
    scale = torch.tensor(SCALE)
    vgs = hvd.value_and_grad(loss_scaled, argnums=(0, 1))
    res["argnums_in"] = _np(hvd.spmd_run(vgs, params, scale, toks))
    res["grad_out"] = _np(hvd.grad(loss)(params, toks))
    res["grad_aux_out"] = _np(hvd.grad(loss_aux, has_aux=True)(params,
                                                              toks))

    # The flax TransformerLM on flash attention, differentiated through
    # _FlashAttention (its backward counted).
    model = params_from_flax(weights["flm"], TransformerLM(
        **FLM, dtype=torch.float32, device="cpu",
        attn_fn=functools.partial(attention.flash_attention, causal=True)))
    fparams = {k: p.detach() for k, p in model.named_parameters()}

    def floss(p, t):
        return next_token_loss(torch.func.functional_call(model, p, (t,)),
                               t)

    backward = attention._FlashAttention.backward
    calls = []

    def counted(ctx, *g):
        calls.append(1)
        return backward(ctx, *g)

    attention._FlashAttention.backward = staticmethod(counted)
    fvg = hvd.value_and_grad(floss)
    res["flm_out"] = _np(fvg(fparams, toks))
    res["flm_in"] = _np(hvd.spmd_run(fvg, fparams, toks))
    attention._FlashAttention.backward = backward
    res["flash_backwards"] = len(calls)

    # The transform: flat, then int8 on the ladder at inner 2.
    local = hvd.value_and_grad(loss)(params, toks)[1]
    tx = hvd.allreduce_gradients_transform(fusion_threshold=THRESHOLD)
    state = tx.init(params)
    res["tx_none"] = _np(tx.update(local, state, params))
    basics.config().hierarchical_inner_size = 2
    shapes = _path_shapes(weights["plm"])
    tx8 = hvd.allreduce_gradients_transform(
        compression=Compression.int8, hierarchical="on",
        fusion_threshold=THRESHOLD)
    st = tx8.init({k: torch.zeros(s) for k, s in shapes.items()})
    res["tx_res0"] = _np(st.residuals)
    res["tx_int8"] = []
    for s in range(TX_STEPS):
        g = {k: torch.tensor(v) for k, v in
             _tx_grads(shapes, rank, s).items()}
        upd, st = tx8.update(g, st)
        res["tx_int8"].append((_np(upd), _np(st.residuals)))
    res["ef_specs"] = hvd.ef_state_partition_specs((st, {"x": 1}))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    hvd.shutdown()
    dist.destroy_process_group()


# ---------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jhvd():
    """The JAX package over 4 of the 8 virtual devices, restored after."""
    import jax

    import horovod_tpu.jax as hvd
    from horovod_tpu.common import basics

    basics.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    yield hvd
    basics.shutdown()
    hvd.init()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import parallel_lm as jplm
    from horovod_tpu.models.transformer import TransformerLM as JLM

    plm = jplm.init_lm_params(jax.random.PRNGKey(3), PLM["vocab"],
                              PLM["max_len"], PLM["layers"], PLM["heads"],
                              PLM["head_dim"], PLM["ffn"])
    flm = JLM(**FLM, dtype=jnp.float32).init(
        jax.random.PRNGKey(4), jnp.asarray(_tokens()[:2]),
        train=False)["params"]
    tree = {"plm": jax.tree_util.tree_map(np.asarray, plm),
            "flm": jax.tree_util.tree_map(np.asarray, flm)}
    d = tmp_path_factory.mktemp("functional_grad")
    with open(d / "weights.pkl", "wb") as f:
        pickle.dump(tree, f)
    return str(d), tree


@pytest.fixture(scope="module")
def started(weights):
    """The rank world, started in a thread so that the JAX reference is
    computed while it runs; ``ranks`` joins it."""
    out = []
    t = threading.Thread(target=lambda: out.append(start_world(
        WORLD, weights[0], "test_torch_functional_grad")), daemon=True)
    t.start()
    return t, out


@pytest.fixture(scope="module")
def ranks(started, reference):
    t, out = started
    t.join(300)
    assert not t.is_alive() and out, "the rank world failed (see above)"
    return out[0]


def _jloss(p, t):
    from horovod_tpu.models import parallel_lm as jplm

    return jplm.next_token_nll(jplm.lm_apply(p, t), t)


def _jflm_loss(p, t):
    import functools as ft

    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import TransformerLM as JLM
    from horovod_tpu.ops.attention import flash_attention

    logits = JLM(**FLM, dtype=jnp.float32,
                 attn_fn=ft.partial(flash_attention, causal=True)).apply(
        {"params": p}, t, train=False)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, t[:, 1:, None], axis=-1).mean()


def _per_rank(jhvd, fn, *args):
    """``fn``'s value on each rank's shard (no averaging), stacked."""
    from jax.sharding import PartitionSpec as P

    return np.asarray(jhvd.spmd_run(lambda *a: fn(*a)[None], *args,
                                    in_specs=(P(),) * (len(args) - 1)
                                    + (P("hvd"),),
                                    out_specs=P("hvd")))


def _jvg(jhvd, fn, *args, **kw):
    from jax.sharding import PartitionSpec as P

    import jax

    return jax.tree_util.tree_map(np.asarray, jhvd.spmd_run(
        jhvd.value_and_grad(fn, **kw), *args,
        in_specs=(P(),) * (len(args) - 1) + (P("hvd"),), out_specs=P()))


def _close(got, want, rel=1e-5):
    """Every leaf of ``got`` (the port's) within ``rel`` of the largest
    entry of the matching leaf of ``want`` (the JAX package's)."""
    import jax

    g_leaves = jax.tree_util.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rel,
                                   atol=rel * float(np.abs(w).max()))


@pytest.fixture(scope="module")
def reference(jhvd, weights, started):
    import jax.numpy as jnp

    _, tree = weights
    toks = jnp.asarray(_tokens())
    p = tree["plm"]
    out = {"plm_vg": _jvg(jhvd, _jloss, p, toks),
           "plm_local": _per_rank(jhvd, _jloss, p, toks),
           "flm_vg": _jvg(jhvd, _jflm_loss, tree["flm"], toks),
           "flm_local": _per_rank(jhvd, _jflm_loss, tree["flm"], toks)}

    def loss_aux(p, t):
        from horovod_tpu.models import parallel_lm as jplm

        logits = jplm.lm_apply(p, t)
        return jplm.next_token_nll(logits, t), {"mean": logits.mean()}

    out["aux_vg"] = _jvg(jhvd, loss_aux, p, toks, has_aux=True)
    out["aux_local"] = _per_rank(jhvd, lambda p, t: loss_aux(p, t)[1]["mean"],
                                 p, toks)
    out["argnums_vg"] = _jvg(
        jhvd, lambda p, s, t: s * _jloss(p, t), p, jnp.float32(SCALE), toks,
        argnums=(0, 1))
    from jax.sharding import PartitionSpec as P

    out["grad"] = jhvd.spmd_run(jhvd.grad(_jloss), p, toks,
                                in_specs=(P(), P("hvd")), out_specs=P())
    return out


# ----------------------------------------------------------------- tests


def test_value_and_grad_outside_a_region(ranks, reference):
    for r, res in enumerate(ranks):
        value, grads = res["plm_out"]
        np.testing.assert_allclose(value, reference["plm_local"][r],
                                   rtol=1e-5)
        _close(grads, reference["plm_vg"][1])


def test_value_and_grad_inside_a_region_averages_the_value(ranks,
                                                           reference):
    want_value, want_grads = reference["plm_vg"]
    assert not np.allclose(reference["plm_local"], float(want_value))
    for res in ranks:
        value, grads = res["plm_in"]
        np.testing.assert_allclose(value, want_value, rtol=1e-5)
        _close(grads, want_grads)


def test_has_aux_averages_the_value_and_not_the_aux(ranks, reference):
    (want_value, _), want_grads = reference["aux_vg"]
    for r, res in enumerate(ranks):
        for key, value_want in (("aux_in", want_value),
                                ("aux_out", reference["plm_local"][r])):
            (value, aux), grads = res[key]
            np.testing.assert_allclose(value, value_want, rtol=1e-5)
            np.testing.assert_allclose(aux["mean"],
                                       reference["aux_local"][r],
                                       rtol=1e-5, atol=1e-6)
            _close(grads, want_grads)


def test_argnums_tuple_gives_a_tuple_of_gradients(ranks, reference):
    want_value, (want_p, want_s) = reference["argnums_vg"]
    for res in ranks:
        value, (gp, gs) = res["argnums_in"]
        np.testing.assert_allclose(value, want_value, rtol=1e-5)
        _close(gp, want_p)
        np.testing.assert_allclose(gs, want_s, rtol=1e-5)


def test_grad_equals_the_reference(ranks, reference):
    for res in ranks:
        _close(res["grad_out"], reference["grad"])
        grads, aux = res["grad_aux_out"]
        _close(grads, reference["grad"])
        assert set(aux) == {"mean"}


def test_flash_lm_through_flash_attention(ranks, reference, weights):
    """The flax LM on flash attention: the port's gradients, keyed by its
    parameter names, against the flax tree's (transposed where the
    layouts differ), with _FlashAttention's backward run for each
    layer of each differentiation."""
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      flax_parameter_map)

    model = TransformerLM(**FLM, dtype=torch.float32, device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    pairs = [(path, names[id(p)], t)
             for path, p, t in flax_parameter_map(model)]
    want_value, want_grads = reference["flm_vg"]

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return np.asarray(tree)

    for r, res in enumerate(ranks):
        assert res["flash_backwards"] == 2 * FLM["num_layers"]
        for key, value_want in (("flm_out", reference["flm_local"][r]),
                                ("flm_in", want_value)):
            value, grads = res[key]
            np.testing.assert_allclose(value, value_want, rtol=1e-5)
            assert set(grads) == {n for _, n, _ in pairs}
            for path, name, transposed in pairs:
                w = leaf(want_grads, path)
                g = grads[name].T if transposed else grads[name]
                np.testing.assert_allclose(
                    g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def test_transform_without_a_ladder_averages(ranks, reference):
    for res in ranks:
        grads, state = res["tx_none"]
        assert state.residuals == ()
        _close(grads, reference["plm_vg"][1])


def test_int8_transform_on_the_ladder_equals_the_reference(ranks, jhvd,
                                                           weights):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.common import state as jstate
    from horovod_tpu.jax.compression import Compression
    from horovod_tpu.jax.optimizer import (allreduce_gradients_transform,
                                           ef_state_partition_specs)
    from test_torch_hierarchical import _close_but_for_ties

    shapes = _path_shapes(weights[1]["plm"])
    tx = allreduce_gradients_transform(compression=Compression.int8,
                                       hierarchical="on",
                                       fusion_threshold=THRESHOLD)
    cfg = jstate.global_state().config
    saved, cfg.hierarchical_inner_size = cfg.hierarchical_inner_size, 2
    try:
        state = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
        spec = ef_state_partition_specs(state)
        fn = jhvd.spmd_fn(
            lambda st, g: tx.update(jax.tree_util.tree_map(
                lambda x: x[0], g), st)[::-1],
            in_specs=(spec, P("hvd")), out_specs=(spec, P()))
        steps = []
        for s in range(TX_STEPS):
            g = {k: jnp.stack([jnp.asarray(_tx_grads(shapes, r, s)[k])
                               for r in range(WORLD)]) for k in shapes}
            state, upd = fn(state, g)
            steps.append((jax.tree_util.tree_map(np.asarray, upd),
                          [np.asarray(x) for x in state.residuals]))
    finally:
        cfg.hierarchical_inner_size = saved
    assert len(state.residuals) > 0
    for rank, res in enumerate(ranks):
        assert [x.shape for x in res["tx_res0"]] == [
            (x.shape[0] // WORLD,) for x in steps[0][1]]
        assert all(float(np.abs(x).max()) == 0 for x in res["tx_res0"])
        for (upd, resid), (jupd, jresid) in zip(res["tx_int8"], steps):
            assert sorted(upd) == sorted(jupd)
            want = [jupd[k] for k in sorted(jupd)]
            mag = max(float(np.abs(w).max()) for w in want) * WORLD
            step = mag / 127
            _close_but_for_ties([upd[k] for k in sorted(upd)], want, mag,
                                step)
            n = [x.shape[0] // WORLD for x in jresid]
            _close_but_for_ties(
                resid, [x[rank * k:(rank + 1) * k]
                        for x, k in zip(jresid, n)], mag, step)
        assert any(float(np.abs(x).max()) > 0
                   for x in res["tx_int8"][-1][1])
        specs, rest = res["ef_specs"]
        assert tuple(specs.residuals) == (("hvd",),) * len(steps[0][1])
        assert rest == {"x": ()}


def test_the_functional_api_without_a_world():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        x = torch.tensor([1.0, 2.0])
        v, g = hvd.value_and_grad(lambda p: (p["w"] * p["w"]).sum())(
            {"w": x, "u": torch.zeros(3)})
        assert float(v) == 5.0
        np.testing.assert_array_equal(g["w"], [2.0, 4.0])
        np.testing.assert_array_equal(g["u"], [0.0, 0.0, 0.0])
        assert list(g) == ["u", "w"]          # JAX's sorted key order
        with pytest.raises(TypeError, match="floating-point"):
            hvd.grad(lambda t: t.float().sum())(torch.arange(3))
        with pytest.raises(TypeError, match="scalar"):
            hvd.grad(lambda t: t * 2)(x)
    finally:
        hvd.shutdown()
