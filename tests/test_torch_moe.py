"""The port's expert parallelism (``horovod_tpu_torch.parallel.moe`` and
the Switch-MoE LM of ``models.parallel_lm``) in a 4-rank gloo world,
against the JAX package under ``shard_map`` on 4 virtual CPU devices.

One gloo world (started once for the module by the ``world`` fixture,
on ``tests/test_torch_tp.py``'s ``start_world``) runs every case over an
``ep=4`` mesh and saves each rank's results; the JAX side runs in this
process once per module with the same numpy inputs. Rank ``r`` holds the
``r``-th token (or sequence) shard and experts ``[r * E / 4, (r + 1) * E
/ 4)``.

* ``top1_routing``: dispatch equal to the JAX function's, combine (the
  float32 softmax gates, an ulp apart between the libraries) and the
  auxiliary loss within 1e-6, on seeded inputs and on
  tests/test_parallel.py's eye gate;
* ``moe_layer`` (tests/test_parallel.py's two ``TestMoE`` cases: E = 4,
  and E = 8 with 2 experts a rank) at capacity factor E (no drops) and
  1.25 (drops): the routing equal to JAX's first, then the forward to
  atol 1e-5 and the input, gate and expert gradients against
  ``jax.grad`` of the same function (rtol/atol 1e-5);
* ``lm_apply_moe`` and ``moe_reduce_grads`` (tests/test_parallel_lm.py's
  drop-free pins): logits to rtol 3e-4 / atol 3e-5 against the JAX
  ``shard_map`` forward and the dense one, the reduced gradients to rtol
  5e-4 / atol 5e-5 against the dense autodiff; one dropping training
  step (nll + 0.01 x the ep-mean aux, SGD 0.05) through the port's
  ``spmd_run`` against the reference's ``step`` on the same weights;
* the all-to-all bytes of a forward against tests/test_wire_bytes.py's
  rule (two calls of ``E x C x D x 4`` bytes) and the JAX jaxpr's;
* ``init_moe_lm_params``' tree and shapes, and ``moe_lm_param_specs``,
  against JAX's.

Routing is compared before any number: a float32 softmax summed in
another order can flip an argmax whose top two gates lie within a
rounding error, and then a whole token moves. Each case prints the
smallest top-2 gap when it is under 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu.models import parallel_lm as jplm
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu_torch.models import parallel_lm as tplm
from test_torch_tp import _leaves, _np_tree, start_world

N = 4
TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=3e-4, atol=3e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
# tests/test_parallel.py's TestMoE cases: (T, D, E, seed).
LAYER_CASES = {"e4": (16, 8, 4, 21), "e8": (32, 4, 8, 22)}
# tests/test_parallel_lm.py's MoE LM: 2 layers, 4 heads of 8, MLP 32,
# vocab 64, 4 experts, a batch of 8 x 16 tokens (2 sequences a rank).
V, LMAX, LAYERS, H, DH, FFN, EXPERTS = 64, 64, 2, 4, 8, 32, 4
B, L = 8, 16
LR, AUX_W = 0.05, 0.01
# tests/test_wire_bytes.py:292's case: 16 tokens a rank, D 8, 4 experts.
WIRE_T, WIRE_D, WIRE_E = 16, 8, 4


# ------------------------------------------------------------- inputs


def _layer_inputs(T, D, E, seed):
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    return {"x": n(T, D), "gate": n(D, E), "ew": n(E, D, D, scale=0.3),
            "cot": n(T, D)}


def _moe_params():
    """The MoE LM's weights from a numpy seed, in the JAX tree's layout
    (``normal / sqrt(fan_in)``, LayerNorm gains about one)."""
    rng = np.random.default_rng(51)
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
                    "ln2": ln(), "gate": dense((e, EXPERTS), e),
                    "experts": {
                        "up": dense((EXPERTS, e, FFN), e),
                        "bup": dense((EXPERTS, FFN), e),
                        "dn": dense((EXPERTS, FFN, e), FFN),
                        "bdn": dense((EXPERTS, e), FFN)}}
                   for _ in range(LAYERS)],
        "ln_f": ln(), "head": dense((e, V), e),
    }


def _tokens():
    return np.random.default_rng(52).integers(0, V, (B, L)).astype(
        np.int32)


def _rows(a, n, r):
    c = a.shape[0] // n
    return a[r * c:(r + 1) * c]


def _capacity(t, cf, e):
    return max(1, math.ceil(t * cf / e))


def _top2_gap(x, gate):
    """The smallest gap between a token's two largest gates."""
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x, jnp.float32) @ jnp.asarray(gate, jnp.float32),
        axis=-1)), axis=-1)
    return float(np.min(probs[:, -1] - probs[:, -2]))


# ------------------------------------------------------------ the world


def _record_routing(log):
    """Wrap the port's ``top1_routing`` (``moe_layer`` and
    ``lm_apply_moe`` call it through the module) so that every call's
    dispatch lands in ``log``; returns the undo."""
    from horovod_tpu_torch.parallel import moe

    orig = moe.top1_routing

    def spy(x, gate_w, num_experts, capacity):
        out = orig(x, gate_w, num_experts, capacity)
        log.append(out[0].detach().numpy().copy())
        return out

    moe.top1_routing = spy
    return lambda: setattr(moe, "top1_routing", orig)


def _layer_cases(n, rank):
    from horovod_tpu_torch.parallel.moe import moe_layer

    res = {}
    for name, (T, D, E, seed) in LAYER_CASES.items():
        d = _layer_inputs(T, D, E, seed)
        for cf in (float(E), 1.25):
            x = torch.tensor(_rows(d["x"], n, rank), requires_grad=True)
            gw = torch.tensor(d["gate"], requires_grad=True)
            ew = torch.tensor(_rows(d["ew"], n, rank), requires_grad=True)
            routing = []
            undo = _record_routing(routing)
            try:
                y = moe_layer(x, gw, lambda w, t: t @ w, ew, axis="ep",
                              capacity_factor=cf)
            finally:
                undo()
            (y * torch.tensor(_rows(d["cot"], n, rank))).sum().backward()
            res[(name, cf)] = {"y": y.detach().numpy(), "routing": routing[0],
                               "gx": x.grad.numpy(), "ggate": gw.grad.numpy(),
                               "gew": ew.grad.numpy()}
    return res


def _wire_case():
    """The bytes each ``all_to_all_single`` of one forward sends."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.moe import moe_layer

    sent = []
    orig = dist.all_to_all_single

    def spy(output, input, *a, **kw):
        sent.append(input.numel() * input.element_size())
        return orig(output, input, *a, **kw)

    dist.all_to_all_single = spy
    try:
        moe_layer(torch.zeros(WIRE_T, WIRE_D), torch.zeros(WIRE_D, WIRE_E),
                  lambda p, t: t @ p["w"],
                  {"w": torch.zeros(WIRE_E // N, WIRE_D, WIRE_D)},
                  axis="ep", capacity_factor=1.0)
    finally:
        dist.all_to_all_single = orig
    return sent


def _leaf_shard(rank, n):
    tree = tplm.shard_lm_params(_moe_params(),
                                tplm.moe_lm_param_specs(LAYERS, "ep"), n,
                                rank)
    for x in _leaves(tree):
        x.requires_grad_(True)
    return tree


def _grads(t):
    if isinstance(t, dict):
        return {k: _grads(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_grads(v) for v in t]
    return t.grad


def _lm_cases(n, rank, lm):
    import horovod_tpu_torch.distributed as hvd

    toks = torch.tensor(_rows(_tokens(), n, rank), dtype=torch.long)
    res = {}
    # Drop-free: the forward and the reduced gradients of the nll.
    p = _leaf_shard(rank, n)
    routing = []
    undo = _record_routing(routing)
    try:
        logits, _ = tplm.lm_apply_moe(p, toks, ep="ep",
                                      capacity_factor=float(EXPERTS))
    finally:
        undo()
    tplm.next_token_nll(logits, toks).backward()
    res["logits"] = logits.detach().numpy()
    res["routing"] = routing
    res["grads"] = _np_tree(tplm.moe_reduce_grads(_grads(p), "ep"))

    # One dropping step of the reference's recipe, through spmd_run.
    def step(p, t):
        logits, aux = tplm.lm_apply_moe(p, t, ep="ep")
        loss = (tplm.next_token_nll(logits, t)
                + AUX_W * hvd.allreduce(aux, average=True))
        loss.backward()
        g = tplm.moe_reduce_grads(_grads(p), "ep")
        return _sgd(p, g), g, hvd.allreduce(loss.detach(), average=True)

    routing = []
    undo = _record_routing(routing)
    try:
        new, g, loss = hvd.spmd_run(step, _leaf_shard(rank, n), toks,
                                    mesh=lm, axis_name="ep")
    finally:
        undo()
    res["step"] = {"params": _np_tree(new), "grads": _np_tree(g),
                   "loss": float(loss), "routing": routing}
    return res


def _sgd(p, g):
    if isinstance(p, dict):
        return {k: _sgd(p[k], g[k]) for k in p}
    if isinstance(p, list):
        return [_sgd(a, b) for a, b in zip(p, g)]
    return p.detach() - LR * g


def _worker(rank, n, init, out):
    """One rank of the ``n``-rank gloo world: every case, results saved."""
    import os

    import torch.distributed as dist

    import horovod_tpu_torch.distributed as hvd
    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    hvd.init(device="cpu")
    lm = LogicalMesh.from_config(f"ep={n}")
    with bind(lm):
        res = {"layers": _layer_cases(n, rank), "wire": _wire_case(),
               "lm": _lm_cases(n, rank, lm)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    hvd.shutdown()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return start_world(N, str(tmp_path_factory.mktemp("ep4")),
                       "test_torch_moe")


# --------------------------------------------------------- the JAX side


def _jmesh():
    return jpar.make_mesh({"ep": N}, devices=jax.devices()[:N])


def _jax_layer(name, cf):
    T, D, E, seed = LAYER_CASES[name]
    d = _layer_inputs(T, D, E, seed)
    f = jax.shard_map(
        lambda x, gw, ew: jmoe.moe_layer(x, gw, lambda w, t: t @ w, ew,
                                         "ep", capacity_factor=cf),
        mesh=_jmesh(), in_specs=(P("ep"), P(), P("ep")),
        out_specs=P("ep"))
    y = jax.jit(f)(d["x"], d["gate"], d["ew"])
    grads = jax.jit(jax.grad(
        lambda x, gw, ew: jnp.sum(f(x, gw, ew) * d["cot"]),
        argnums=(0, 1, 2)))(d["x"], d["gate"], d["ew"])
    T_local = T // N
    routing = [np.asarray(jmoe.top1_routing(
        _rows(d["x"], N, r), d["gate"], E, _capacity(T_local, cf, E))[0])
        for r in range(N)]
    gap = min(_top2_gap(_rows(d["x"], N, r), d["gate"]) for r in range(N))
    return {"y": np.asarray(y), "grads": [np.asarray(g) for g in grads],
            "routing": routing, "gap": gap}


def _jax_routing(params, tokens, capacity_factor=1.25):
    """Every ``top1_routing`` dispatch of an eager dense
    ``lm_apply_moe`` over ``tokens`` (the JAX function calls it through
    the module) and the smallest top-2 gap of its inputs."""
    orig = jmoe.top1_routing
    log, gaps = [], []

    def spy(x, gate_w, num_experts, capacity):
        gaps.append(_top2_gap(np.asarray(x), np.asarray(gate_w)))
        out = orig(x, gate_w, num_experts, capacity)
        log.append(np.asarray(out[0]))
        return out

    jmoe.top1_routing = spy
    try:
        jplm.lm_apply_moe(params, tokens, capacity_factor=capacity_factor)
    finally:
        jmoe.top1_routing = orig
    return log, min(gaps)


@pytest.fixture(scope="module")
def jax_lm():
    params = jax.tree_util.tree_map(jnp.asarray, _moe_params())
    tokens = jnp.asarray(_tokens())
    cf = float(EXPERTS)
    specs = jplm.moe_lm_param_specs(LAYERS, "ep")
    mesh = _jmesh()
    dense_logits, _ = jplm.lm_apply_moe(params, tokens, capacity_factor=cf)
    sharded = jax.jit(jax.shard_map(
        lambda p, t: jplm.lm_apply_moe(p, t, ep="ep", capacity_factor=cf)[0],
        mesh=mesh, in_specs=(specs, P("ep")), out_specs=P("ep")))(
        params, tokens)
    dense_g = jax.grad(lambda p: jplm.next_token_nll(
        jplm.lm_apply_moe(p, tokens, capacity_factor=cf)[0], tokens))(params)

    # tests/test_parallel_lm.py's dropping step, returning its gradients.
    def step(p, t):
        def loss_fn(p):
            logits, aux = jplm.lm_apply_moe(p, t, ep="ep")
            return (jplm.next_token_nll(logits, t) +
                    AUX_W * jax.lax.pmean(aux, "ep"))

        loss, g = jax.value_and_grad(loss_fn)(p)
        g = jplm.moe_reduce_grads(g, "ep")
        new_p = jax.tree_util.tree_map(lambda a, b: a - LR * b, p, g)
        return new_p, g, jax.lax.pmean(loss, "ep")

    new_p, step_g, loss = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(specs, P("ep")),
        out_specs=(specs, specs, P())))(params, tokens)
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    routing = [_jax_routing(params, tokens[2 * r:2 * r + 2])
               for r in range(N)]
    free_routing = [_jax_routing(params, tokens[2 * r:2 * r + 2], cf)
                    for r in range(N)]
    return {"dense_logits": np.asarray(dense_logits),
            "sharded": np.asarray(sharded), "dense_g": tonp(dense_g),
            "step_params": tonp(new_p), "step_grads": tonp(step_g),
            "step_loss": float(loss), "routing": routing,
            "free_routing": free_routing}


def _rank_view(tree, rank):
    """The JAX tree as rank ``rank`` holds it: expert stacks cut to the
    rank's experts, everything else whole."""
    return tplm.shard_lm_params(tree, tplm.moe_lm_param_specs(LAYERS, "ep"),
                                N, rank)


def _assert_trees(got, want, tol, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=f"{what}: leaf {i}")


# ---------------------------------------------------------- the tests


@pytest.mark.parametrize("case", ["seeded", "eye"])
def test_top1_routing_matches_jax(case):
    from horovod_tpu_torch.parallel.moe import top1_routing

    if case == "eye":
        # tests/test_parallel.py:680: token i -> expert i, capacity 1.
        x, gate, e, cap = (np.eye(4, dtype=np.float32),
                           10 * np.eye(4, dtype=np.float32), 4, 1)
    else:
        rng = np.random.default_rng(61)
        x = rng.standard_normal((40, 8)).astype(np.float32)
        gate = rng.standard_normal((8, 4)).astype(np.float32)
        e, cap = 4, 7
    gap = _top2_gap(x, gate)
    if gap < 1e-6:
        print(f"top1_routing[{case}]: smallest top-2 gap {gap:.3e}")
    jd, jc, ja = jmoe.top1_routing(jnp.asarray(x), jnp.asarray(gate), e, cap)
    td, tc, ta = top1_routing(torch.tensor(x), torch.tensor(gate), e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # The gates are float32 softmaxes of two libraries: an ulp apart.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    if case == "eye":
        np.testing.assert_array_equal(td.sum(dim=(0, 2)).numpy(),
                                      np.ones(4))
        assert float(ta) > 0
    else:
        # Capacity 7 of 40 tokens over 4 experts drops some.
        assert float(td.sum()) < x.shape[0]


@pytest.mark.parametrize("cf", ["drop_free", "dropping"])
@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(world, name, cf):
    T, D, E, _ = LAYER_CASES[name]
    cf = float(E) if cf == "drop_free" else 1.25
    want = _jax_layer(name, cf)
    if want["gap"] < 1e-6:
        print(f"moe_layer[{name}, {cf}]: smallest top-2 gap "
              f"{want['gap']:.3e}")
    for r, res in enumerate(world):
        got = res["layers"][(name, cf)]
        np.testing.assert_array_equal(got["routing"], want["routing"][r])
    kept = sum(float(w.sum()) for w in want["routing"])
    assert (kept < T) == (cf == 1.25), (kept, T, cf)
    gx, ggate, gew = want["grads"]
    for r, res in enumerate(world):
        got = res["layers"][(name, cf)]
        np.testing.assert_allclose(got["y"], _rows(want["y"], N, r),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["gx"], _rows(gx, N, r), **TOL)
        np.testing.assert_allclose(got["gew"], _rows(gew, N, r), **TOL)
    # The gate is replicated: the global gradient is the ranks' sum.
    np.testing.assert_allclose(
        sum(res["layers"][(name, cf)]["ggate"] for res in world), ggate,
        **TOL)


def test_lm_apply_moe_matches_jax(world, jax_lm):
    for r, res in enumerate(world):
        # The routing first: the same capacity rule over the rank's own
        # tokens gives the dense function the ep layer's dispatch.
        want_routing, gap = jax_lm["free_routing"][r]
        if gap < 1e-6:
            print(f"rank {r}: smallest top-2 gap {gap:.3e}")
        assert len(res["lm"]["routing"]) == LAYERS
        for got, want in zip(res["lm"]["routing"], want_routing):
            np.testing.assert_array_equal(got, want)
        got = res["lm"]["logits"]
        np.testing.assert_allclose(got, _rows(jax_lm["sharded"], N, r),
                                   **LM_TOL)
        np.testing.assert_allclose(got, _rows(jax_lm["dense_logits"], N, r),
                                   **LM_TOL)


def test_moe_reduce_grads_matches_dense_autodiff(world, jax_lm):
    for r, res in enumerate(world):
        _assert_trees(res["lm"]["grads"], _rank_view(jax_lm["dense_g"], r),
                      GRAD_TOL, f"rank {r}")


def test_dropping_train_step_matches_jax(world, jax_lm):
    for r, res in enumerate(world):
        step = res["lm"]["step"]
        want_routing, gap = jax_lm["routing"][r]
        if gap < 1e-6:
            print(f"rank {r}: smallest top-2 gap {gap:.3e}")
        assert len(step["routing"]) == LAYERS
        for got, want in zip(step["routing"], want_routing):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(step["loss"], jax_lm["step_loss"],
                                   rtol=1e-5)
        _assert_trees(step["grads"], _rank_view(jax_lm["step_grads"], r),
                      GRAD_TOL, f"rank {r} gradients")
        _assert_trees(step["params"], _rank_view(jax_lm["step_params"], r),
                      GRAD_TOL, f"rank {r} parameters")
    kept = sum(float(d.sum()) for rt, _ in jax_lm["routing"] for d in rt)
    assert kept < LAYERS * B * L    # the step did drop tokens


def test_all_to_all_bytes_match_the_slot_rule(world):
    from test_wire_bytes import collect_collectives

    cap = _capacity(WIRE_T, 1.0, WIRE_E)
    slot_bytes = WIRE_E * cap * WIRE_D * 4
    jx = jax.make_jaxpr(jax.shard_map(
        lambda x, gw, ew: jmoe.moe_layer(
            x, gw, lambda p, t: t @ p["w"], ew, axis="ep",
            capacity_factor=1.0),
        mesh=_jmesh(), in_specs=(P("ep"), P(), {"w": P("ep")}),
        out_specs=P("ep"), check_vma=False))(
        jnp.zeros((N * WIRE_T, WIRE_D)), jnp.zeros((WIRE_D, WIRE_E)),
        {"w": jnp.zeros((WIRE_E, WIRE_D, WIRE_D))})
    assert collect_collectives(jx) == [("all_to_all", slot_bytes)] * 2
    for res in world:
        assert res["wire"] == [slot_bytes] * 2


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def test_init_moe_lm_params_tree_matches_jax():
    want = jplm.init_moe_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS,
                                   H, DH, FFN, EXPERTS)
    got = tplm.init_moe_lm_params(0, V, LMAX, LAYERS, H, DH, FFN, EXPERTS,
                                  device="cpu")
    assert [(p, tuple(x.shape)) for p, x in _paths(got)] == \
        [(p, tuple(x.shape)) for p, x in _paths(want)]
    assert [list(layer) for layer in got["layers"]] == \
        [list(layer) for layer in want["layers"]]
    jspecs = _paths(jplm.moe_lm_param_specs(LAYERS, "ep"))
    tspecs = _paths(tplm.moe_lm_param_specs(LAYERS, "ep"))
    assert [(p, tuple(s)) for p, s in jspecs] == tspecs
