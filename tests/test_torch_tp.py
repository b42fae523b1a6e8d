"""The port's tensor parallelism (``horovod_tpu_torch.parallel.tp``, the
vocab-parallel loss, the TP-sharded LM) in 2- and 4-rank gloo worlds,
against the JAX package under ``shard_map`` and against the port's dense
path.

One gloo world per size (2 and 4 processes, started once for the module
by the ``world`` fixture) runs every case over a ``tp=N`` mesh and saves
each rank's results; the JAX side runs in this process on
tests/conftest.py's 8-device virtual CPU mesh with the same numpy
inputs. Rank ``r`` holds the ``r``-th shard:

* ``column_parallel`` (``gather_output`` off: the rank's column slice of
  the JAX output; on: the whole of it), ``row_parallel``, ``tp_mlp``
  (behind ``tp_region_input``) and ``vocab_parallel_logits``: forward to
  rtol/atol 1e-5 against JAX, and every gradient (input, weight shard,
  bias) to rtol/atol 1e-5 against the dense autograd of the port;
* ``tp_vocab_cross_entropy``: loss 1e-6 relative, ``dh`` and the rank's
  ``dw_local`` rtol 1e-5 / atol 1e-6 against the JAX function's in-region
  gradients (tests/test_xent.py's tolerances), weighted too;
* ``lm_apply(tp)`` + ``next_token_nll_fused(vocab_parallel=True)`` +
  ``reduce_grads``: the loss to 1e-5 relative and every gradient shard to
  rtol/atol 1e-5 against the JAX step's (float32, summation order only),
  and the same over ``dp=2,tp=N/2`` with ``reduce_grads(dp="dp")``;
  ``lm_decode(tp)``'s tokens equal the JAX TP decode's and the port's
  dense decode's;
* ``lm_param_specs`` entry for entry against the JAX ``PartitionSpec``s
  and ``shard_lm_params`` against the JAX ``NamedSharding`` shards.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu.models import parallel_lm as jplm
from horovod_tpu.ops.xent import tp_vocab_cross_entropy as jvce
from horovod_tpu.parallel import tp as jtp
from horovod_tpu_torch.models import parallel_lm as tplm

import gloo_worlds

REPO = Path(__file__).resolve().parent.parent
WORLDS = [2, 4]
TOL = dict(rtol=1e-5, atol=1e-5)
XENT_TOL = dict(rtol=1e-5, atol=1e-6)
# The tiny LM: 2 layers, 4 heads of 4, MLP 32, vocab 64, 16 positions.
V, LMAX, LAYERS, H, DH, FFN = 64, 16, 2, 4, 4, 32
T_CHUNK = 8
DECODE_STEPS = 6


# ------------------------------------------------------------- inputs


def _blocks():
    """The layer cases' inputs: x [3, 5, 8], the MLP weights, a head
    [8, 24], row-parallel input [3, 5, 16], and output gradients."""
    rng = np.random.default_rng(11)

    def n(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"x": n(3, 5, 8), "w_up": n(8, 16), "b_up": n(16),
            "w_dn": n(16, 8), "b_dn": n(8), "head": n(8, 24),
            "xr": n(3, 5, 16), "g16": n(3, 5, 16), "g8": n(3, 5, 8),
            "g24": n(3, 5, 24)}


def _xent_inputs():
    rng = np.random.default_rng(12)
    t, e = 28, 16
    return {"h": rng.standard_normal((t, e)).astype(np.float32),
            "w": rng.standard_normal((e, V)).astype(np.float32),
            "targets": rng.integers(0, V, t).astype(np.int32),
            "weights": rng.uniform(0, 1, t).astype(np.float32)}


def _lm_params():
    """The LM's dense weights from a numpy seed, in the JAX pytree's
    layout (``normal / sqrt(fan_in)``, LayerNorm gains about one)."""
    rng = np.random.default_rng(13)
    e = H * DH

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def ln():
        return {"g": (1 + 0.1 * rng.standard_normal(e)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(e)).astype(np.float32)}

    return {
        "embed": dense((V, e), e), "pos": dense((LMAX, e), e),
        "layers": [{"ln1": ln(), "wqkv": dense((e, 3, H, DH), e),
                    "wo": dense((H, DH, e), e), "bo": dense((e,), e),
                    "ln2": ln(), "wup": dense((e, FFN), e),
                    "bup": dense((FFN,), e), "wdn": dense((FFN, e), FFN),
                    "bdn": dense((e,), FFN)} for _ in range(LAYERS)],
        "ln_f": ln(), "head": dense((e, V), e),
    }


def _tokens(batch=4, seed=14):
    return np.random.default_rng(seed).integers(
        0, V, (batch, LMAX)).astype(np.int32)


def _cols(a, n, r):
    c = a.shape[-1] // n
    return a[..., r * c:(r + 1) * c]


def _rows(a, n, r):
    c = a.shape[0] // n
    return a[r * c:(r + 1) * c]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(
        tree)


# ------------------------------------------------------------ the world


def _grads_of(fn, *inputs):
    """``fn`` on leaf copies of ``inputs`` (requires_grad), the sum of
    its output times a fixed cotangent taken by the caller; returns the
    output and each input's gradient as numpy."""
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out, cot = fn(*ts)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _layer_cases(n, rank):
    """The layer functions on this rank's shards."""
    from horovod_tpu_torch.parallel import tp

    b = _blocks()
    res = {}
    for gather in (False, True):
        cot = b["g16"] if gather else _cols(b["g16"], n, rank)
        res[("column", gather)] = _grads_of(
            lambda x, w, bb: (tp.column_parallel(
                tp.tp_region_input(x, "tp"), w, bb, "tp",
                gather_output=gather), cot),
            b["x"], _cols(b["w_up"], n, rank), _cols(b["b_up"], n, rank))
    res["row"] = _grads_of(
        lambda x, w, bb: (tp.row_parallel(x, w, bb, "tp"), b["g8"]),
        _cols(b["xr"], n, rank), _rows(b["w_dn"], n, rank), b["b_dn"])
    res["mlp"] = _grads_of(
        lambda x, wu, bu, wd, bd: (tp.tp_mlp(
            tp.tp_region_input(x, "tp"), wu, bu, wd, bd, "tp"), b["g8"]),
        b["x"], _cols(b["w_up"], n, rank), _cols(b["b_up"], n, rank),
        _rows(b["w_dn"], n, rank), b["b_dn"])
    res["vocab_logits"] = _grads_of(
        lambda x, hd: (tp.vocab_parallel_logits(
            tp.tp_region_input(x, "tp"), hd, "tp"), b["g24"]),
        b["x"], _cols(b["head"], n, rank))
    return res


def _xent_cases(n, rank):
    from horovod_tpu_torch.ops.xent import tp_vocab_cross_entropy

    d = _xent_inputs()
    res = {}
    for weighted in (False, True):
        h = torch.tensor(d["h"], requires_grad=True)
        w = torch.tensor(_cols(d["w"], n, rank).T.copy(),
                         requires_grad=True)
        kw = (dict(weights=torch.tensor(d["weights"]), denom=7.0)
              if weighted else {})
        loss = tp_vocab_cross_entropy(h, w, torch.tensor(d["targets"]),
                                      "tp", T_CHUNK, **kw)
        loss.backward()
        res[weighted] = (float(loss), h.grad.numpy(), w.grad.numpy())
    return res


def _lm_step(params, tokens, tp, fused=True):
    """One loss and its gradients: the fused (vocab-parallel under
    ``tp``) loss, or ``next_token_nll`` over ``lm_apply``'s logits (a
    replicated head)."""
    tree = tplm.params_from_numpy(params, device="cpu") \
        if not torch.is_tensor(params["embed"]) else params
    for x in _leaves(tree):
        x.requires_grad_(True)
    toks = torch.tensor(tokens, dtype=torch.long)
    if fused:
        hidden = tplm.lm_apply(tree, toks, tp=tp, return_hidden=True)
        loss = tplm.next_token_nll_fused(tree, hidden, toks, tp=tp,
                                         vocab_parallel=tp is not None,
                                         t_chunk=T_CHUNK)
    else:
        loss = tplm.next_token_nll(tplm.lm_apply(tree, toks, tp=tp), toks)
    loss.backward()

    def grads(t):
        if isinstance(t, dict):
            return {k: grads(v) for k, v in t.items()}
        if isinstance(t, list):
            return [grads(v) for v in t]
        return t.grad
    return loss, grads(tree)


def _lm_cases(n, rank):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    params = _lm_params()
    tokens = _tokens()
    res = {}
    specs = tplm.lm_param_specs(LAYERS, "tp", vocab_parallel=True)
    with bind(LogicalMesh.from_config(f"tp={n}")):
        loss, g = _lm_step(tplm.shard_lm_params(params, specs, n, rank),
                           tokens, "tp")
        res["lm"] = (float(loss), _np_tree(tplm.reduce_grads(g)))
        rep = tplm.shard_lm_params(
            params, tplm.lm_param_specs(LAYERS, "tp"), n, rank)
        res["decode"] = tplm.lm_decode(
            rep, tokens[:, :4], DECODE_STEPS, tp="tp",
            device="cpu").numpy()
    lm = LogicalMesh.from_config(f"dp=2,tp={n // 2}")
    dp_i, tp_i = (int(x) for x in np.argwhere(lm.ranks == rank)[0])
    with bind(lm):
        loss, g = _lm_step(tplm.shard_lm_params(
            params, tplm.lm_param_specs(LAYERS, "tp"), n // 2, tp_i),
            tokens[2 * dp_i:2 * dp_i + 2], "tp", fused=False)
        res["dp_tp"] = (float(loss), _np_tree(tplm.reduce_grads(g, dp="dp")),
                        dp_i, tp_i, dist.get_process_group_ranks(
                            lm.mesh.get_group("tp")))
    return res


def _worker(rank, n, init, out):
    """One rank of an ``n``-rank gloo world: every case, results saved."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    with bind(LogicalMesh.from_config(f"tp={n}")):
        res = {"layers": _layer_cases(n, rank),
               "xent": _xent_cases(n, rank)}
    res.update(_lm_cases(n, rank))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def start_world(n, out, module, timeout=180, env=None):
    """Run ``module._worker(rank, n, init, out)`` in ``n`` processes
    (``gloo_worlds.start_world``, with ``env`` their environment); fail,
    after killing them all, if any exits with an error or outlives
    ``timeout``. Returns each rank's saved results."""
    gloo_worlds.start_world(n, out, module, timeout=timeout, env=env)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"tp{n}")
def world(request, tmp_path_factory):
    n = request.param
    return n, start_world(n, str(tmp_path_factory.mktemp(f"tp{n}")),
                          "test_torch_tp")


# --------------------------------------------------------- the JAX side


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(axes, devices=jax.devices()[:n])


def _jrun(fn, axes, in_specs, out_specs, *args, check_vma=True):
    """``fn`` under ``shard_map`` over a mesh of ``axes``; the layer
    functions' forward passes run untyped (``check_vma=False``), as the
    JAX engine's step does, where an all-gather's replication cannot be
    inferred."""
    return jax.jit(jax.shard_map(fn, mesh=_jmesh(axes), in_specs=in_specs,
                                 out_specs=out_specs,
                                 check_vma=check_vma))(*args)


# ------------------------------------------------------------ the layers


@pytest.mark.parametrize("gather", [False, True])
def test_column_parallel_matches_jax_and_dense(world, gather):
    n, ranks = world
    b = _blocks()
    want = np.asarray(_jrun(
        lambda x, w, bb: jtp.column_parallel(x, w, bb, "tp",
                                             gather_output=gather),
        {"tp": n}, (P(), P(None, "tp"), P("tp")),
        P() if gather else P(None, None, "tp"),
        b["x"], b["w_up"], b["b_up"], check_vma=False))
    dense, (dx, dw, db) = _grads_of(
        lambda x, w, bb: (x @ w + bb, b["g16"]), b["x"], b["w_up"],
        b["b_up"])
    np.testing.assert_allclose(dense, want, **TOL)
    for r, res in enumerate(ranks):
        out, (gx, gw, gb) = res["layers"][("column", gather)]
        np.testing.assert_allclose(
            out, want if gather else _cols(want, n, r), **TOL)
        np.testing.assert_allclose(gx, dx, **TOL)
        np.testing.assert_allclose(gw, _cols(dw, n, r), **TOL)
        np.testing.assert_allclose(gb, _cols(db, n, r), **TOL)


def test_row_parallel_matches_jax_and_dense(world):
    n, ranks = world
    b = _blocks()
    want = np.asarray(_jrun(
        lambda x, w, bb: jtp.row_parallel(x, w, bb, "tp"), {"tp": n},
        (P(None, None, "tp"), P("tp", None), P()), P(),
        b["xr"], b["w_dn"], b["b_dn"]))
    dense, (dx, dw, db) = _grads_of(
        lambda x, w, bb: (x @ w + bb, b["g8"]), b["xr"], b["w_dn"],
        b["b_dn"])
    np.testing.assert_allclose(dense, want, **TOL)
    for r, res in enumerate(ranks):
        out, (gx, gw, gb) = res["layers"]["row"]
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(gx, _cols(dx, n, r), **TOL)
        np.testing.assert_allclose(gw, _rows(dw, n, r), **TOL)
        # The bias is added once after the sum: its gradient is whole.
        np.testing.assert_allclose(gb, db, **TOL)


def test_tp_mlp_matches_jax_and_dense(world):
    import torch.nn.functional as F

    n, ranks = world
    b = _blocks()
    args = (b["x"], b["w_up"], b["b_up"], b["w_dn"], b["b_dn"])
    want = np.asarray(_jrun(
        lambda x, wu, bu, wd, bd: jtp.tp_mlp(x, wu, bu, wd, bd, "tp"),
        {"tp": n}, (P(), P(None, "tp"), P("tp"), P("tp", None), P()), P(),
        *args))
    dense, (dx, dwu, dbu, dwd, dbd) = _grads_of(
        lambda x, wu, bu, wd, bd: (F.gelu(x @ wu + bu, approximate="tanh")
                                   @ wd + bd, b["g8"]), *args)
    np.testing.assert_allclose(dense, want, **TOL)
    for r, res in enumerate(ranks):
        out, (gx, gwu, gbu, gwd, gbd) = res["layers"]["mlp"]
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(gx, dx, **TOL)
        np.testing.assert_allclose(gwu, _cols(dwu, n, r), **TOL)
        np.testing.assert_allclose(gbu, _cols(dbu, n, r), **TOL)
        np.testing.assert_allclose(gwd, _rows(dwd, n, r), **TOL)
        np.testing.assert_allclose(gbd, dbd, **TOL)


def test_vocab_parallel_logits_match_jax_and_dense(world):
    n, ranks = world
    b = _blocks()
    want = np.asarray(_jrun(
        lambda x, hd: jtp.vocab_parallel_logits(x, hd, "tp"), {"tp": n},
        (P(), P(None, "tp")), P(), b["x"], b["head"], check_vma=False))
    dense, (dx, dh) = _grads_of(lambda x, hd: (x @ hd, b["g24"]),
                                   b["x"], b["head"])
    np.testing.assert_allclose(dense, want, **TOL)
    for r, res in enumerate(ranks):
        out, (gx, gh) = res["layers"]["vocab_logits"]
        # Every rank holds the same full-vocab rows.
        np.testing.assert_array_equal(out, ranks[0]["layers"][
            "vocab_logits"][0])
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(gx, dx, **TOL)
        np.testing.assert_allclose(gh, _cols(dh, n, r), **TOL)


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("weighted", [False, True])
def test_vocab_parallel_cross_entropy_matches_jax(world, weighted):
    """Loss, ``dh`` and each rank's ``dw_local`` against the JAX
    function's in-region gradients (tests/test_xent.py's convention)."""
    n, ranks = world
    d = _xent_inputs()
    targets = jnp.asarray(d["targets"])
    kw = (dict(weights=jnp.asarray(d["weights"]), denom=jnp.float32(7.0))
          if weighted else {})

    def region(hh, ww):
        def loss_fn(hh_, ww_):
            return jvce(hh_, ww_, targets, "tp", T_CHUNK, **kw)
        loss, (dh, dw) = jax.value_and_grad(loss_fn, argnums=(0, 1))(hh,
                                                                      ww)
        return loss, dh, dw

    loss, dh, dw = (np.asarray(a) for a in _jrun(
        region, {"tp": n}, (P(), P(None, "tp")),
        (P(), P(), P(None, "tp")), d["h"], d["w"]))
    for r, res in enumerate(ranks):
        got_loss, got_dh, got_dw = res["xent"][weighted]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
        np.testing.assert_allclose(got_dh, dh, **XENT_TOL)
        # The port's shard is nn.Linear's [V/P, E].
        np.testing.assert_allclose(got_dw, _cols(dw, n, r).T, **XENT_TOL)
    assert len({res["xent"][weighted][0] for res in ranks}) == 1


# -------------------------------------------------------------- the LM


def _jax_lm_step(axes, batch_spec, dp=None):
    """The JAX TP step in one region: loss (dp-mean) and the gradients
    after ``reduce_grads``, assembled to their dense shapes. Without
    ``dp`` the fused vocab-parallel loss; with it ``next_token_nll`` over
    the logits of a replicated head (the JAX vocab-parallel loss's
    custom VJP does not type-check under a second varying axis)."""
    specs = jplm.lm_param_specs(LAYERS, "tp", vocab_parallel=not dp)

    def region(p, t):
        def loss_fn(p):
            if dp:
                return jplm.next_token_nll(jplm.lm_apply(p, t, tp="tp"), t)
            h = jplm.lm_apply(p, t, tp="tp", return_hidden=True)
            return jplm.next_token_nll_fused(p, h, t, tp="tp",
                                             vocab_parallel=True,
                                             t_chunk=T_CHUNK)
        loss, g = jax.value_and_grad(loss_fn)(p)
        g = jplm.reduce_grads(g, dp=dp)
        return (jax.lax.pmean(loss, dp) if dp else loss), g

    params = jax.tree_util.tree_map(jnp.asarray, _lm_params())
    loss, g = _jrun(region, axes, (specs, batch_spec), (P(), specs),
                    params, jnp.asarray(_tokens()))
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def test_tp_lm_step_matches_jax_and_dense(world):
    n, ranks = world
    jloss, jgrads = _jax_lm_step({"tp": n}, P())
    dloss, dgrads = _lm_step(_lm_params(), _tokens(), None)
    np.testing.assert_allclose(dloss.item(), jloss, rtol=1e-5)
    specs = tplm.lm_param_specs(LAYERS, "tp", vocab_parallel=True)
    for r, res in enumerate(ranks):
        loss, grads = res["lm"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        want = tplm.shard_lm_params(jgrads, specs, n, r)
        dense = tplm.shard_lm_params(_np_tree(dgrads), specs, n, r)
        for got, w, d in zip(_leaves(grads), _leaves(want),
                             _leaves(dense)):
            np.testing.assert_allclose(got, w.numpy(), **TOL)
            np.testing.assert_allclose(got, d.numpy(), **TOL)


def test_dp_tp_lm_step_matches_jax(world):
    """``dp=2,tp=N/2`` (a tensor axis of one rank in the 2-rank world:
    the dense math) with ``next_token_nll`` over the logits of a
    replicated head: each data shard's tensor group takes its half of
    the batch, and ``reduce_grads(dp="dp")`` averages over the data
    axis's group."""
    n, ranks = world
    t = n // 2
    jloss, jgrads = _jax_lm_step({"dp": 2, "tp": t}, P("dp"), dp="dp")
    specs = tplm.lm_param_specs(LAYERS, "tp")
    losses = {}
    for r, res in enumerate(ranks):
        loss, grads, dp_i, tp_i, group = res["dp_tp"]
        assert (dp_i, tp_i) == (r // t, r % t)
        assert group == list(range(t * dp_i, t * dp_i + t))
        losses[dp_i] = loss
        want = tplm.shard_lm_params(jgrads, specs, t, tp_i)
        for got, w in zip(_leaves(grads), _leaves(want)):
            np.testing.assert_allclose(got, w.numpy(), **TOL)
    np.testing.assert_allclose((losses[0] + losses[1]) / 2, jloss,
                               rtol=1e-5)


def test_tp_decode_matches_jax_and_dense(world):
    n, ranks = world
    params = _lm_params()
    prompt = _tokens()[:, :4]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(_jrun(
        lambda p, t: jplm.lm_decode(p, t, DECODE_STEPS, tp="tp"),
        {"tp": n}, (jplm.lm_param_specs(LAYERS, "tp"), P()), P(),
        jparams, jnp.asarray(prompt)))
    dense = tplm.lm_decode(tplm.params_from_numpy(params, device="cpu"),
                           prompt, DECODE_STEPS, device="cpu").numpy()
    np.testing.assert_array_equal(dense, want)
    for res in ranks:
        np.testing.assert_array_equal(res["decode"], want)


# --------------------------------------------- specs and the carrier


@pytest.mark.parametrize("tp_axis", ["tp", None])
@pytest.mark.parametrize("vocab_parallel", [False, True])
def test_lm_param_specs_equal_the_jax_partition_specs(tp_axis,
                                                      vocab_parallel):
    want = jplm.lm_param_specs(LAYERS, tp_axis, vocab_parallel)
    got = tplm.lm_param_specs(LAYERS, tp_axis, vocab_parallel)
    flat_w, tree_w = jax.tree_util.tree_flatten(
        want, is_leaf=lambda x: isinstance(x, P))
    flat_g, tree_g = jax.tree_util.tree_flatten(
        got, is_leaf=lambda x: isinstance(x, tuple))
    assert tree_w.num_leaves == tree_g.num_leaves == len(flat_g)
    assert [tuple(s) for s in flat_w] == flat_g


@pytest.mark.parametrize("n", WORLDS)
def test_shard_lm_params_are_the_named_sharding_shards(n):
    """Rank ``r``'s shard equals what ``device_put(NamedSharding)`` puts
    on mesh position ``r``, leaf for leaf, each a tensor of its own."""
    params = _lm_params()
    mesh = _jmesh({"tp": n})
    specs = jplm.lm_param_specs(LAYERS, "tp", vocab_parallel=True)
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs)
    dense = tplm.params_from_numpy(params, device="cpu")
    tspecs = tplm.lm_param_specs(LAYERS, "tp", vocab_parallel=True)
    devices = list(mesh.devices.flat)
    for r in range(n):
        mine = tplm.shard_lm_params(dense, tspecs, n, r)
        for got, arr, full in zip(
                _leaves(mine),
                jax.tree_util.tree_leaves(placed),
                jax.tree_util.tree_leaves(dense)):
            (shard,) = [s for s in arr.addressable_shards
                        if s.device == devices[r]]
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                shard.data))
            assert got.is_contiguous()
            assert got.untyped_storage().data_ptr() != \
                full.untyped_storage().data_ptr()


def test_tp_functions_need_a_bound_mesh_and_divisible_shards():
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.parallel import tp

    x = torch.zeros(2, 4)
    for fn in (lambda: tp.tp_region_input(x, "tp"),
               lambda: tp.row_parallel(x, torch.zeros(4, 2), axis="tp"),
               lambda: tp.vocab_parallel_logits(x, torch.zeros(4, 6),
                                                "tp")):
        with pytest.raises(InvalidArgumentError, match="bound LogicalMesh"):
            fn()
    with pytest.raises(InvalidArgumentError, match="does not split"):
        tp.shard_columns(torch.zeros(4, 6), 4, 0)
    with pytest.raises(InvalidArgumentError, match="does not split"):
        tplm.shard_lm_params(_lm_params(), tplm.lm_param_specs(
            LAYERS, "tp"), 3, 0)
    # The sequence axis, like the tensor axis, is a bound mesh's.
    with pytest.raises(InvalidArgumentError, match="bound LogicalMesh"):
        tplm.reduce_grads({}, sp="sp")
    with pytest.raises(InvalidArgumentError, match="bound LogicalMesh"):
        tplm.lm_apply(tplm.params_from_numpy(_lm_params(), device="cpu"),
                      torch.zeros(1, 4, dtype=torch.long), sp="sp")


def test_world_of_one_axis_is_the_dense_math():
    """A ``tp=1`` mesh runs no collective: the functions are the dense
    ones (no process group needed)."""
    from horovod_tpu_torch.ops.xent import (fused_cross_entropy,
                                            tp_vocab_cross_entropy)
    from horovod_tpu_torch.parallel import tp
    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    b = _blocks()
    x, w = torch.tensor(b["x"]), torch.tensor(b["head"])
    d = _xent_inputs()
    h, hw = torch.tensor(d["h"]), torch.tensor(d["w"]).t()
    tg = torch.tensor(d["targets"])
    with bind(LogicalMesh.from_config("tp=1")):
        torch.testing.assert_close(tp.vocab_parallel_logits(x, w, "tp"),
                                   x @ w, rtol=0, atol=0)
        torch.testing.assert_close(tp.tp_region_output(x, "tp"), x)
        assert float(tp_vocab_cross_entropy(h, hw, tg, "tp", T_CHUNK)) \
            == float(fused_cross_entropy(h, hw, tg, T_CHUNK))
