"""The port's SPMD harness (``horovod_tpu_torch.parallel.spmd``) and the
Horovod collectives of ``horovod_tpu_torch.distributed`` in a 4-rank gloo
world and in a world of one, against the JAX package's ``spmd_run`` on a
mesh of as many virtual CPU devices and against the closed forms of
tests/test_collectives.py.

One gloo world per size (started once for the module by the ``world``
fixture, on ``tests/test_torch_tp.py``'s ``start_world``) runs every case
and saves each rank's results. Where an output is sharded (``P("hvd")``)
the case runs with ``host_local=False``, so every rank returns the whole
value, the JAX package's single-process result.

* every tests/test_collectives.py case: allreduce (sum in float32 and
  int32, average, min/max, fp16/bf16 compression), allgather, allgatherv,
  broadcast (roots 0 and n - 1, an out-of-range root, bools), alltoall
  (and its indivisible split), reducescatter, grouped_allreduce (100
  tensors; mixed dtypes), the bucket planner, size-one semantics outside
  a region, the eager (out-of-region) alltoall and reducescatter against
  their gather-and-select and reduce-and-slice forms, and the gradient of
  allreduce (``n * (r + 1)``);
* the gradients of average allreduce, allgather, broadcast, alltoall and
  reducescatter against ``jax.grad`` inside the JAX ``spmd_run``;
  allreduce_sparse (gathered and dense); the in-place forms;
* the handle: poll, synchronize, the duplicate in-flight name, an
  idempotent release, the context manager (tests/test_collectives.py:
  213-262);
* ``host_local`` both ways, the ``spmd_run`` cache, the decorator's
  keyword partials, ``rank()`` inside and outside a region and the
  lifecycle calls (tests/test_basics.py:33-44);
* the timeline's ``XLA_COMPILE``/``XLA_EXECUTE`` spans
  (tests/test_timeline_spmd.py); ``HOROVOD_AUTOTUNE`` through a handle
  is held in tests/test_torch_autotune.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from test_torch_tp import start_world

WORLDS = [1, 4]
FP16_TOL, BF16_TOL = 1e-2, 2e-2
GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


def _bases():
    rng = np.random.RandomState(42)
    return {"base60": np.arange(60).reshape(3, 4, 5),
            "fp16": np.random.RandomState(0).rand(17, 3).astype(np.float32),
            "bf16": np.random.RandomState(1).rand(8, 8).astype(np.float32),
            "grouped": [rng.rand(5, 5).astype(np.float32)
                        for _ in range(100)]}


# -------------------------------------------------------- the port side


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _collective_cases(hvd, n):
    """tests/test_collectives.py's cases through the port's spmd_run."""
    from horovod_tpu_torch.parallel import P

    b = _bases()
    whole = dict(out_specs=P("hvd"), host_local=False)
    res = {}
    for dt in (np.float32, np.int32):
        t = torch.tensor(b["base60"].astype(dt))
        res[f"sum_{dt.__name__}"] = hvd.spmd_run(
            lambda: hvd.allreduce(t * (hvd.rank() + 1), average=False))
    res["average"] = hvd.spmd_run(
        lambda: hvd.allreduce(torch.ones(4, 4) * hvd.rank(), average=True))
    res["min_max"] = hvd.spmd_run(
        lambda: tuple(hvd.allreduce(torch.ones(2, 2) * hvd.rank(), op=op)
                      for op in (hvd.Min, hvd.Max)))
    res["fp16"] = hvd.spmd_run(lambda: hvd.allreduce(
        b["fp16"], average=True, compression=hvd.Compression.fp16))
    res["bf16"] = hvd.spmd_run(lambda: hvd.allreduce(
        b["bf16"], average=True, compression=hvd.Compression.bf16))
    res["allgather"] = hvd.spmd_run(
        lambda: hvd.allgather(torch.ones(2, 3) * hvd.rank()))
    res["allgatherv"] = hvd.spmd_run(lambda: hvd.allgatherv(
        torch.ones(8, 2) * hvd.rank(), hvd.rank() + 1, 8))
    for root in (0, n - 1):
        res[f"broadcast_{root}"] = hvd.spmd_run(lambda: hvd.broadcast(
            torch.full((3, 3), 10.0) * (hvd.rank() + 1.0), root_rank=root))
    try:
        hvd.spmd_run(lambda: hvd.broadcast(torch.ones(2), root_rank=n))
        res["broadcast_bad_root"] = None
    except Exception as e:      # noqa: BLE001 - the class is the result
        res["broadcast_bad_root"] = type(e).__name__
    res["broadcast_bool"] = hvd.spmd_run(lambda: hvd.broadcast(
        torch.tensor([hvd.rank() % 2 == 0, False]) & torch.tensor(
            [True, False]), root_rank=min(1, n - 1)))
    res["alltoall"] = hvd.spmd_run(
        lambda: hvd.alltoall(torch.ones(n, 4) * hvd.rank()), **whole)
    try:
        hvd.spmd_run(lambda: hvd.alltoall(torch.ones(4 * n + 3, 2)))
        res["alltoall_bad"] = None
    except Exception as e:      # noqa: BLE001
        res["alltoall_bad"] = type(e).__name__
    res["reducescatter"] = hvd.spmd_run(lambda: hvd.reducescatter(
        torch.ones(2 * n, 2) * hvd.rank(), average=False), **whole)
    res["grouped"] = hvd.spmd_run(lambda: tuple(hvd.grouped_allreduce(
        [torch.tensor(x) * (hvd.rank() + 1) for x in b["grouped"]],
        average=False)))
    res["grouped_mixed"] = hvd.spmd_run(lambda: tuple(hvd.grouped_allreduce(
        [torch.ones(4), torch.ones(4, dtype=torch.int32), torch.ones(4)],
        average=False)))
    res["sparse"] = hvd.spmd_run(lambda: hvd.allreduce_sparse(
        torch.tensor([hvd.rank(), 0]), torch.ones(2, 3) * (hvd.rank() + 1),
        average=False))
    res["sparse_dense"] = hvd.spmd_run(lambda: hvd.allreduce_sparse(
        torch.tensor([hvd.rank(), 0]), torch.ones(2, 3) * (hvd.rank() + 1),
        dense_rows=n + 1, average=True))
    return {k: _np(v) for k, v in res.items()}


def _per_rank_grad(hvd, op):
    """``grad_x sum(op(x * (r + 1)) * c_r)`` in the region, gathered."""
    def fn(x):
        x = x.clone().requires_grad_(True)
        r = hvd.rank()
        y = op(x * (r + 1))
        c = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (g,) = torch.autograd.grad((y * (c + r)).sum(), x)
        return hvd.allgather(g[None])
    return fn


def _grad_cases(hvd, n):
    x = torch.ones(4 * n, 2)
    ops = {
        "allreduce_sum": lambda t: hvd.allreduce(t, average=False),
        "allreduce_average": lambda t: hvd.allreduce(t, average=True),
        "allgather": hvd.allgather,
        "broadcast": lambda t: hvd.broadcast(t, root_rank=n - 1),
        "alltoall": lambda t: hvd.alltoall(t, split_axis=0, concat_axis=1),
        "reducescatter": lambda t: hvd.reducescatter(t, average=True),
    }
    return {k: _np(hvd.spmd_run(_per_rank_grad(hvd, op), x))
            for k, op in ops.items()}


def _eager_cases(hvd, n, rank):
    """Outside any region: size-one identities, the eager alltoall and
    reducescatter, and the in-place forms."""
    res = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    res["identity"] = [_np(f(x)) for f in (
        hvd.allreduce, hvd.allgather, lambda t: hvd.broadcast(t, 0))]
    res["identity_is_input"] = hvd.allreduce(x) is x
    per = 3
    inputs = [np.concatenate([np.full((per, 2), 100.0 * r + s, np.float32)
                              for s in range(n)]) for r in range(n)]
    res["alltoall"] = _np(hvd.alltoall(torch.tensor(inputs[rank])))
    rng = np.random.RandomState(42 + n)
    rs_in = [np.asarray(rng.randint(-6, 7, (n * 2, 3)), np.float32)
             for _ in range(n)]
    res["reducescatter"] = _np(hvd.reducescatter(torch.tensor(rs_in[rank]),
                                                 average=False))
    t = torch.full((3,), float(rank + 1))
    out = hvd.allreduce_(t, average=False)
    res["allreduce_"] = (out is t, _np(t))
    t = torch.full((3,), float(rank + 1))
    res["broadcast_"] = (hvd.broadcast_(t, n - 1) is t, _np(t))
    h = hvd.allgather_async(torch.full((1, 2), float(rank)), name="ag")
    res["allgather_async"] = _np(hvd.synchronize(h))
    h = hvd.broadcast_async_(t, 0)
    res["broadcast_async_"] = (hvd.synchronize(h) is t, _np(t))
    return res


def _handle_cases(hvd):
    """tests/test_collectives.py:213-262."""
    from horovod_tpu_torch.common.exceptions import PreconditionError

    res = {}
    x = torch.ones(4)
    h = hvd.allreduce_async(x, name="h1")
    res["sync"] = _np(hvd.synchronize(h))
    res["poll_after"] = hvd.poll(h)
    h1 = hvd.allreduce_async(x, name="dup")
    try:
        hvd.allreduce_async(x, name="dup")
        res["dup"] = None
    except PreconditionError:
        res["dup"] = "PreconditionError"
    hvd.synchronize(h1)
    hvd.synchronize(hvd.allreduce_async(x, name="dup"))
    import gc

    h = hvd.allreduce_async(x, name="rel")
    gc.disable()
    try:
        h.release()
        h.release()
        hvd.synchronize(hvd.allreduce_async(x, name="rel"))
    finally:
        gc.enable()
    hvd.synchronize(h)
    with hvd.allreduce_async(x, name="ctx") as h:
        res["ctx"] = _np(hvd.synchronize(h))
    h2 = hvd.allreduce_async(x, name="ctx")
    hvd.synchronize(h2)
    res["names_freed"] = True
    return res


def _harness_cases(hvd, n, rank):
    from horovod_tpu_torch.parallel import P
    from horovod_tpu_torch.parallel.spmd import _spmd_cache

    res = {}
    seen = []

    def double(x):
        seen.append(tuple(x.shape))
        return x * 2

    whole = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2 * n, 3)
    mine = whole[2 * rank:2 * rank + 2]
    res["local"] = _np(hvd.spmd_run(double, mine, in_specs=P("hvd"),
                                    out_specs=P("hvd")))
    res["global"] = _np(hvd.spmd_run(double, whole, in_specs=P("hvd"),
                                     out_specs=P("hvd"), host_local=False))
    res["global_seen"] = seen[-1]
    before = len(_spmd_cache)

    def plus(x):
        return x + hvd.rank()

    a = hvd.spmd_run(plus, torch.zeros(2))
    b = hvd.spmd_run(plus, torch.zeros(2))
    res["cache_growth"] = len(_spmd_cache) - before
    res["cache_values"] = (_np(a), _np(b))

    @hvd.spmd
    def scaled(x, scale=1.0):
        return hvd.allreduce(x * scale, average=False)

    res["partial"] = [_np(scaled(torch.ones(2), scale=2.0)) for _ in range(2)]
    res["partials"] = len(scaled.partials)
    def unit(x):
        x = x.clone().requires_grad_(True)
        y = hvd.allreduce(x * (hvd.rank() + 1), average=False)
        (g,) = torch.autograd.grad(y.sum(), x)
        return hvd.allgather(g[None])

    res["unit_grad"] = _np(hvd.spmd_run(unit, torch.ones(3)))
    res["ranks"] = _np(hvd.spmd_run(
        lambda: hvd.allgather(torch.tensor([hvd.rank()], dtype=torch.int32))))
    res["local_ranks"] = _np(hvd.spmd_run(lambda: hvd.allgather(
        torch.tensor([hvd.local_rank()], dtype=torch.int32))))
    res["outside"] = (hvd.rank(), hvd.local_rank(), hvd.local_size(),
                      hvd.process_rank(), hvd.process_count(),
                      hvd.mpi_threads_supported(), hvd.size(),
                      hvd.mesh().shape)
    from horovod_tpu_torch.parallel.logical import LogicalMesh

    sub = LogicalMesh.from_config(f"a={max(n // 2, 1)},b={min(n, 2)}")
    res["sub_axis"] = _np(hvd.spmd_run(
        lambda: hvd.allreduce(torch.ones(1) * hvd.rank(), average=False),
        mesh=sub, axis_name="b"))
    return res


def _worker(rank, n, init, out):
    """One rank of an ``n``-rank gloo world: every case, results saved."""
    import os

    import torch.distributed as dist

    import horovod_tpu_torch.distributed as hvd

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    hvd.init(device="cpu")
    res = {"collectives": _collective_cases(hvd, n),
           "grads": _grad_cases(hvd, n),
           "eager": _eager_cases(hvd, n, rank),
           "handles": _handle_cases(hvd),
           "harness": _harness_cases(hvd, n, rank)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    hvd.shutdown()
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    n = request.param
    return n, start_world(n, str(tmp_path_factory.mktemp(f"spmd{n}")),
                          "test_torch_spmd")


# --------------------------------------------------------- the JAX side


_JAX = {}


def _jax_cases(n):
    """The JAX package's spmd_run on a mesh of ``n`` virtual devices,
    once per size."""
    if n in _JAX:
        return _JAX[n]
    import horovod_tpu.jax as jhvd
    from horovod_tpu import parallel as jpar

    jhvd.init()
    mesh = jpar.make_mesh({"hvd": n}, devices=jax.devices()[:n])

    def run(fn, *args, **kw):
        out = jhvd.spmd_run(fn, *args, mesh=mesh, **kw)
        return jax.tree_util.tree_map(np.asarray, out)

    b = _bases()
    f32 = jnp.float32
    res = {}
    for dt in (np.float32, np.int32):
        res[f"sum_{dt.__name__}"] = run(lambda dt=dt: jhvd.allreduce(
            (b["base60"].astype(dt) * (jhvd.rank() + 1).astype(dt))
            .astype(dt), average=False))
    res["average"] = run(lambda: jhvd.allreduce(
        np.ones((4, 4), np.float32) * jhvd.rank().astype(f32)))
    res["min_max"] = run(lambda: tuple(
        jhvd.allreduce(np.ones((2, 2), np.float32) * jhvd.rank().astype(f32),
                       op=op) for op in (jhvd.Min, jhvd.Max)))
    res["fp16"] = run(lambda: jhvd.allreduce(
        b["fp16"], average=True, compression=jhvd.Compression.fp16))
    res["bf16"] = run(lambda: jhvd.allreduce(
        b["bf16"], average=True, compression=jhvd.Compression.bf16))
    res["allgather"] = run(lambda: jhvd.allgather(
        np.ones((2, 3), np.float32) * jhvd.rank().astype(f32)))
    res["allgatherv"] = run(lambda: jhvd.allgatherv(
        np.ones((8, 2), np.float32) * jhvd.rank().astype(f32),
        jhvd.rank() + 1, 8))
    for root in (0, n - 1):
        res[f"broadcast_{root}"] = run(lambda root=root: jhvd.broadcast(
            np.full((3, 3), 10.0, np.float32)
            * (jhvd.rank().astype(f32) + 1.0), root_rank=root))
    res["broadcast_bool"] = run(lambda: jhvd.broadcast(
        (jhvd.rank() % 2 == 0) & np.array([True, False]),
        root_rank=min(1, n - 1)))
    res["alltoall"] = run(lambda: jhvd.alltoall(
        np.ones((n, 4), np.float32) * jhvd.rank().astype(f32)),
        out_specs=JP("hvd"))
    res["reducescatter"] = run(lambda: jhvd.reducescatter(
        np.ones((2 * n, 2), np.float32) * jhvd.rank().astype(f32),
        average=False), out_specs=JP("hvd"))
    res["grouped"] = run(lambda: tuple(jhvd.grouped_allreduce(
        [x * (jhvd.rank() + 1).astype(f32) for x in b["grouped"]],
        average=False)))
    res["grouped_mixed"] = run(lambda: tuple(jhvd.grouped_allreduce(
        [np.ones((4,), np.float32), np.ones((4,), np.int32),
         np.ones((4,), np.float32)], average=False)))
    res["sparse"] = run(lambda: jhvd.allreduce_sparse(
        jnp.stack([jhvd.rank(), 0]), jnp.ones((2, 3)) *
        (jhvd.rank() + 1).astype(f32), average=False))
    res["sparse_dense"] = run(lambda: jhvd.allreduce_sparse(
        jnp.stack([jhvd.rank(), 0]), jnp.ones((2, 3)) *
        (jhvd.rank() + 1).astype(f32), dense_rows=n + 1, average=True))

    def grad_of(op):
        def per_rank(x):
            r = jhvd.rank()
            y = op(x * (r + 1).astype(f32))
            c = jnp.arange(y.size, dtype=f32).reshape(y.shape)
            return jnp.sum(y * (c + r.astype(f32)))

        return lambda x: jhvd.allgather(jax.grad(per_rank)(x)[None])

    x = np.ones((4 * n, 2), np.float32)
    ops = {
        "allreduce_sum": lambda t: jhvd.allreduce(t, average=False),
        "allreduce_average": lambda t: jhvd.allreduce(t, average=True),
        "allgather": jhvd.allgather,
        "broadcast": lambda t: jhvd.broadcast(t, root_rank=n - 1),
        "alltoall": lambda t: jhvd.alltoall(t, split_axis=0, concat_axis=1),
        "reducescatter": lambda t: jhvd.reducescatter(t, average=True),
    }
    res["grads"] = {k: run(grad_of(op), x) for k, op in ops.items()}
    _JAX[n] = res
    return res


# ---------------------------------------------------------- the tests


def _close(got, want, **tol):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, **tol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


CLOSED = {
    "sum_float32": lambda n, b: b["base60"] * n * (n + 1) // 2,
    "sum_int32": lambda n, b: b["base60"] * n * (n + 1) // 2,
    "average": lambda n, b: np.full((4, 4), np.mean(np.arange(n))),
    "min_max": lambda n, b: [np.zeros((2, 2)), np.full((2, 2), n - 1.0)],
    "allgather": lambda n, b: np.repeat(np.arange(n), 2)[:, None]
    * np.ones((1, 3)),
    "broadcast_bool": lambda n, b: np.array([n == 1, False]),
    "alltoall": lambda n, b: np.tile(np.arange(n), n)[:, None]
    * np.ones((1, 4)),
    "reducescatter": lambda n, b: np.full((2 * n, 2), n * (n - 1) / 2),
    "grouped_mixed": lambda n, b: [np.full(4, n)] * 3,
    "sparse": lambda n, b: [
        np.stack([np.arange(n), np.zeros(n, int)], 1).reshape(-1),
        np.repeat(np.arange(1, n + 1), 2)[:, None] * np.ones((1, 3))],
}


@pytest.mark.parametrize("case", sorted(CLOSED) + [
    "fp16", "bf16", "broadcast_root0", "broadcast_rootlast", "grouped"])
def test_collective_matches_jax_and_closed_form(world, hvd, case):
    n, ranks = world
    jres = _jax_cases(n)
    b = _bases()
    key = {"broadcast_root0": "broadcast_0",
           "broadcast_rootlast": f"broadcast_{n - 1}"}.get(case, case)
    want = jres[key]
    tol = dict(rtol=1e-6, atol=0)
    if case in CLOSED:
        _close(want, CLOSED[case](n, b), **tol)
    elif case in ("fp16", "bf16"):
        tol = dict(rtol=FP16_TOL if case == "fp16" else BF16_TOL)
        _close(want, b[case], **tol)
    elif case == "grouped":
        _close(want, [x * n * (n + 1) / 2 for x in b["grouped"]], rtol=1e-5)
    else:
        root = int(key.rsplit("_", 1)[1])
        _close(want, np.full((3, 3), 10.0 * (root + 1)), **tol)
    for res in ranks:
        got = res["collectives"][key]
        _close(got, want, **tol)
        if case in ("sum_int32", "grouped_mixed"):
            dts = [np.asarray(g).dtype for g in (
                got if isinstance(got, list) else [got])]
            assert np.dtype(np.int32) in dts
        if case == "broadcast_bool":
            assert np.asarray(got).dtype == np.bool_
        if case in ("fp16", "bf16"):
            assert np.asarray(got).dtype == np.float32


def test_allgatherv_ragged(world, hvd):
    n, ranks = world
    want_g, want_c = _jax_cases(n)["allgatherv"]
    assert list(want_c) == [r + 1 for r in range(n)]
    for res in ranks:
        g, c = res["collectives"]["allgatherv"]
        assert g.shape == (8 * n, 2)
        assert list(c) == list(want_c)
        np.testing.assert_array_equal(g, want_g)
        for r in range(n):
            np.testing.assert_allclose(g[8 * r:8 * r + c[r]], r)


def test_sparse_dense_matches_jax(world, hvd):
    n, ranks = world
    want = _jax_cases(n)["sparse_dense"]
    dense = np.zeros((n + 1, 3))
    for r in range(n):
        dense[r] += (r + 1) / n
        dense[0] += (r + 1) / n
    _close(want, dense, rtol=1e-6)
    for res in ranks:
        _close(res["collectives"]["sparse_dense"], want, rtol=1e-6)


def test_bad_root_and_indivisible_alltoall_raise(world):
    n, ranks = world
    for res in ranks:
        assert res["collectives"]["broadcast_bad_root"] == \
            "InvalidArgumentError"
        # 4n + 3 rows split into n parts only when n is 1.
        assert res["collectives"]["alltoall_bad"] == (
            "InvalidArgumentError" if n > 1 else None)


@pytest.mark.parametrize("op", ["allreduce_sum", "allreduce_average",
                                "allgather", "broadcast", "alltoall",
                                "reducescatter"])
def test_gradient_matches_jax(world, hvd, op):
    n, ranks = world
    want = _jax_cases(n)["grads"][op]
    if op == "allreduce_sum":
        # tests/test_collectives.py:344: the psum transpose, n * (r + 1)
        # for a unit cotangent; here the cotangent varies with the rank.
        c = np.arange(8 * n, dtype=np.float32).reshape(4 * n, 2)
        closed = np.stack([(r + 1) * sum(c + s for s in range(n))
                           for r in range(n)])
        _close(want, closed, rtol=1e-6)
    for res in ranks:
        _close(res["grads"][op], want, **GRAD_TOL)


def test_unit_gradient_of_allreduce_closed_form(world):
    """tests/test_collectives.py:344 with the port's own unit cotangent:
    rank r's gradient of sum(allreduce(x * (r + 1))) is n * (r + 1)."""
    n, ranks = world
    want = np.stack([np.full(3, n * (r + 1.0)) for r in range(n)])
    for res in ranks:
        _close(res["harness"]["unit_grad"], want, rtol=0)


def test_eager_collectives(world):
    n, ranks = world
    per = 3
    inputs = [np.concatenate([np.full((per, 2), 100.0 * r + s, np.float32)
                              for s in range(n)]) for r in range(n)]
    rng = np.random.RandomState(42 + n)
    rs_in = [np.asarray(rng.randint(-6, 7, (n * 2, 3)), np.float32)
             for _ in range(n)]
    summed = np.sum(rs_in, axis=0)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for me, res in enumerate(ranks):
        e = res["eager"]
        if n == 1:
            for got in e["identity"]:
                np.testing.assert_array_equal(got, x)
            assert e["identity_is_input"]
        # The old shape: gather every tensor, keep the splits for me.
        splits = np.split(np.stack(inputs), n, axis=1)
        np.testing.assert_array_equal(
            e["alltoall"], np.concatenate([splits[me][s] for s in range(n)]))
        np.testing.assert_array_equal(e["reducescatter"],
                                      summed[me * 2:(me + 1) * 2])
        same, val = e["allreduce_"]
        assert same
        np.testing.assert_array_equal(val, np.full(3, n * (n + 1) / 2))
        same, val = e["broadcast_"]
        assert same
        np.testing.assert_array_equal(val, np.full(3, float(n)))
        np.testing.assert_array_equal(
            e["allgather_async"], np.repeat(np.arange(n), 2).reshape(n, 2))
        same, val = e["broadcast_async_"]
        assert same
        np.testing.assert_array_equal(val, np.full(3, float(n)))


def test_fusion_threshold_buckets_match_jax():
    from horovod_tpu.jax.fusion import _plan_buckets as jplan
    from horovod_tpu_torch.distributed.fusion import _plan_buckets as tplan

    for sizes, threshold in (([4, 4, 4, 4], 10), ([4, 100, 4], 10),
                             ([], 10)):
        assert tplan(sizes, threshold) == jplan(sizes, threshold)
    assert tplan([4, 4, 4, 4], 10) == [[0, 1], [2, 3]]


def test_handles(world):
    _, ranks = world
    for res in ranks:
        h = res["handles"]
        np.testing.assert_array_equal(h["sync"], np.ones(4))
        assert h["poll_after"] is True
        assert h["dup"] == "PreconditionError"
        np.testing.assert_array_equal(h["ctx"], np.ones(4))
        assert h["names_freed"]


def test_host_local_both_ways(world):
    n, ranks = world
    whole = np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3)
    for r, res in enumerate(ranks):
        h = res["harness"]
        np.testing.assert_array_equal(h["local"], 2 * whole[2 * r:2 * r + 2])
        np.testing.assert_array_equal(h["global"], 2 * whole)
        assert h["global_seen"] == (2, 3)


def test_spmd_run_cache_and_decorator_partials(world):
    n, ranks = world
    for r, res in enumerate(ranks):
        h = res["harness"]
        assert h["cache_growth"] == 1
        for v in h["cache_values"]:
            np.testing.assert_array_equal(v, np.full(2, float(r)))
        for v in h["partial"]:
            np.testing.assert_array_equal(v, np.full(2, 2.0 * n))
        assert h["partials"] == 1


def test_rank_inside_and_outside_a_region(world):
    n, ranks = world
    for r, res in enumerate(ranks):
        h = res["harness"]
        assert list(h["ranks"]) == list(range(n))
        assert list(h["local_ranks"]) == list(range(n))
        assert h["outside"] == (r, r, n, r, n, False, n, {"hvd": n})
        # A region over axis b of an a x b mesh: ranks along b only.
        b = min(n, 2)
        np.testing.assert_array_equal(h["sub_axis"], [b * (b - 1) / 2])


_TIMELINE_SCRIPT = r"""
import json, sys, torch
import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch.parallel import P
hvd.init(device="cpu")

def step(x):
    return hvd.allreduce(x, name="tl_grad")

run = hvd.spmd_fn(step, in_specs=P("hvd"), out_specs=P("hvd"))
for _ in range(3):
    out = run(torch.ones(8, 4))
hvd.shutdown()
print("DONE")
"""


def test_spmd_timeline_spans(tmp_path):
    """tests/test_timeline_spmd.py: the first call is XLA_COMPILE, the
    later ones XLA_EXECUTE, on the function's track."""
    import os
    import subprocess
    import sys

    from test_torch_tp import REPO

    trace = tmp_path / "timeline.json"
    env = dict(os.environ, HOROVOD_TIMELINE=str(trace),
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _TIMELINE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    events = json.loads(trace.read_text().rstrip().rstrip(",\n") + "]")
    spans = [(e["name"], e.get("args", {}).get("span")) for e in events
             if e.get("ph") == "B" and e["name"].startswith("XLA_")]
    assert spans == [("XLA_COMPILE", "first_call")] + \
        [("XLA_EXECUTE", "host_dispatch")] * 2
    tracks = [e["args"]["name"] for e in events
              if e.get("name") == "thread_name"]
    assert "step" in tracks


def test_exports_match_the_reference():
    """``horovod_tpu_torch.distributed`` carries the reference's
    collectives, lifecycle calls, harness and functional gradient API
    (``grad``, ``value_and_grad``, the gradient transform): every name of
    ``horovod_tpu.jax.__all__``."""
    import horovod_tpu.jax as jhvd
    import horovod_tpu_torch.distributed as hvd
    import horovod_tpu_torch.parallel as par
    from horovod_tpu_torch.models import parallel_lm as plm

    later = set()
    assert set(jhvd.__all__) - later <= set(dir(hvd))
    for name in ("allreduce", "allreduce_", "allreduce_async",
                 "allreduce_async_", "allreduce_sparse", "grouped_allreduce",
                 "allgather", "allgather_async", "allgatherv", "broadcast",
                 "broadcast_", "broadcast_async", "broadcast_async_",
                 "alltoall", "reducescatter", "poll", "synchronize", "spmd",
                 "spmd_fn", "spmd_run", "local_size", "process_rank",
                 "process_count", "mpi_threads_supported", "mesh"):
        assert name in hvd.__all__, name
    assert hvd.broadcast_variables is hvd.broadcast_parameters
    for name in ("top1_routing", "moe_layer", "spmd", "spmd_fn", "spmd_run"):
        assert callable(getattr(par, name)), name
    for name in ("init_moe_lm_params", "moe_lm_param_specs", "lm_apply_moe",
                 "moe_reduce_grads"):
        assert callable(getattr(plm, name)), name


def test_check_extension(monkeypatch):
    import horovod_tpu_torch.distributed as hvd

    hvd.check_extension("horovod_tpu_torch", "HOROVOD_WITH_PYTORCH")
    monkeypatch.setenv("HOROVOD_WITH_PYTORCH", "0")
    with pytest.raises(ImportError, match="disabled"):
        hvd.check_extension("horovod_tpu_torch", "HOROVOD_WITH_PYTORCH")
