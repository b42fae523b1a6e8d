"""``hvd.init(comm=[...])``: a job over a subset of the world's ranks.

One 4-rank gloo world for the module (``test_torch_tp.start_world``):
every rank calls ``init(comm=[0, 2])``. Ranks 0 and 2 form the job
(size 2, ranks 0 and 1) and run its collectives over the subset's group,
the fused buckets and ZeRO included; ranks 1 and 3 raise
``InvalidArgumentError`` after the collective ``new_group``. Then every
rank calls ``init(comm=[0, 99])``, which raises "out of range". The
results are held against the JAX package's ``init(comm=[0, 2])`` on a
4-device virtual mesh (the reference's subset semantics,
``tests/test_basics.py::test_comm_subset_builds_sub_mesh``), run once in
a subprocess because the JAX init is once a process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tp import start_world

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
COMM = [0, 2]
THRESHOLD = 64                    # bytes: two buckets over _LEAVES
_LEAVES = [(3, 5), (7,), (2, 2, 2)]


def _data(global_rank):
    """Each global rank's inputs: a vector for the collectives and the
    fused leaves, from the rank's seed."""
    rng = np.random.default_rng(100 + global_rank)
    return (rng.standard_normal(5).astype(np.float32),
            [rng.standard_normal(s).astype(np.float32) for s in _LEAVES])


def _worker(rank, n, init, out):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    res = {"global_rank": rank}
    try:
        hvd.init(comm=COMM, device="cpu")
    except InvalidArgumentError as e:
        res["excluded"] = str(e)
        res["initialized"] = hvd.is_initialized()
    else:
        from horovod_tpu_torch.distributed import fusion, zero
        from horovod_tpu_torch.parallel.spmd import P

        vec, leaves = _data(rank)
        res["size"] = hvd.size()
        res["rank"] = hvd.rank()
        res["process"] = (hvd.process_rank(), hvd.process_count())
        res["mesh"] = hvd.mesh().devices.tolist()
        res["sum"] = hvd.allreduce(torch.tensor(vec), average=False).numpy()
        res["avg"] = hvd.allreduce(torch.tensor(vec)).numpy()
        res["gather"] = hvd.allgather(torch.tensor(vec)[None]).numpy()
        res["bcast"] = hvd.broadcast(torch.tensor(vec), 1).numpy()
        res["object"] = hvd.broadcast_object({"from": rank}, 1)
        c0 = fusion.fused_reduce.collectives
        fused = hvd.fused_reduce([torch.tensor(x) for x in leaves],
                                 fusion_threshold=THRESHOLD)
        res["fused"] = [t.numpy() for t in fused]
        res["fused_collectives"] = fusion.fused_reduce.collectives - c0
        res["spmd_ranks"] = hvd.spmd_run(
            lambda: hvd.allgather(torch.tensor([hvd.rank()])),
            out_specs=P()).tolist()
        # ZeRO-1 over the subset: one SGD step of a 10-element parameter.
        p = torch.nn.Parameter(torch.arange(10.0))
        opt = zero.sharded_distributed_optimizer(
            torch.optim.SGD([p], lr=1.0))
        p.grad = torch.full((10,), float(rank + 1))
        opt.step()
        res["zero"] = p.detach().numpy()
        res["zero_shards"] = zero.shard_info(opt)
        from horovod_tpu_torch.parallel import mesh as pmesh

        res["refused"] = {}
        for what, call in (("ladder", lambda: pmesh.ladder_groups(2, 1)),
                           ("device_mesh", lambda: pmesh.make_mesh(
                               {"dp": 2}).device_mesh)):
            try:
                call()
            except NotImplementedError as e:
                res["refused"][what] = str(e)
        hvd.shutdown()
    try:
        hvd.init(comm=[0, 99], device="cpu")
    except InvalidArgumentError as e:
        res["range"] = str(e)
    dist.barrier()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
import horovod_tpu.jax as hvd
from horovod_tpu.jax.fusion import fused_reduce
sys.path.insert(0, sys.argv[1])
from test_torch_comm import COMM, THRESHOLD, _data

hvd.init(comm=COMM)
vecs = np.stack([_data(g)[0] for g in COMM])
leaves = [np.stack([_data(g)[1][i] for g in COMM]) for i in range(3)]
run = lambda f, *a: np.asarray(hvd.spmd_run(
    f, *a, in_specs=P("hvd"), out_specs=P("hvd")))
out = {
    "size": hvd.size(),
    "mesh": [int(d.id) for d in hvd.mesh().devices.ravel()],
    "sum": run(lambda x: hvd.allreduce(x, average=False), vecs).tolist(),
    "avg": run(lambda x: hvd.allreduce(x), vecs).tolist(),
    "bcast": run(lambda x: hvd.broadcast(x, 1), vecs).tolist(),
    "ranks": np.asarray(hvd.spmd_run(
        lambda: hvd.allgather(jnp.asarray(hvd.rank(), jnp.int32)[None])
    )).tolist(),
}
fused = hvd.spmd_run(
    lambda a, b, c: tuple(fused_reduce([a[0], b[0], c[0]],
                                       fusion_threshold=THRESHOLD)),
    *leaves, in_specs=P("hvd"), out_specs=P())
out["fused"] = [np.asarray(t).tolist() for t in fused]
import horovod_tpu.common.basics as b
b.shutdown()
try:
    hvd.init(comm=[0, 99])
except Exception as e:
    out["range"] = str(e)
print("JAX_RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start_world(WORLD, str(tmp_path_factory.mktemp("comm")),
                       "test_torch_comm")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(REPO / "tests")], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines()
            if l.startswith("JAX_RESULT ")][-1]
    return json.loads(line[len("JAX_RESULT "):])


def _members(ranks):
    return [ranks[g] for g in COMM]


def test_size_rank_and_mesh_match_the_reference(ranks, reference):
    for i, r in enumerate(_members(ranks)):
        assert r["size"] == reference["size"] == len(COMM)
        assert r["rank"] == i
        assert r["process"] == (i, len(COMM))
        assert r["mesh"] == reference["mesh"] == COMM
        assert r["spmd_ranks"] == reference["ranks"] == [0, 1]


def test_excluded_ranks_raise_after_new_group(ranks):
    for g in range(WORLD):
        if g in COMM:
            assert "excluded" not in ranks[g]
            continue
        assert "does not include this process" in ranks[g]["excluded"]
        assert f"rank {g} of {WORLD}" in ranks[g]["excluded"]
        assert ranks[g]["initialized"] is False


@pytest.mark.parametrize("key", ["sum", "avg", "bcast"])
def test_collectives_span_the_subset_only(ranks, reference, key):
    want = np.asarray(reference[key], np.float32)
    for i, r in enumerate(_members(ranks)):
        np.testing.assert_allclose(r[key], want[i], rtol=1e-6, atol=1e-6)
    vecs = [_data(g)[0] for g in COMM]
    plain = {"sum": vecs[0] + vecs[1], "avg": (vecs[0] + vecs[1]) / 2,
             "bcast": vecs[1]}[key]
    np.testing.assert_allclose(_members(ranks)[0][key], plain, rtol=1e-6)


def test_allgather_and_broadcast_object_over_the_subset(ranks):
    vecs = np.stack([_data(g)[0] for g in COMM])
    for r in _members(ranks):
        np.testing.assert_array_equal(r["gather"], vecs)
        assert r["object"] == {"from": COMM[1]}


def test_fused_buckets_run_over_the_subset(ranks, reference):
    from horovod_tpu_torch.distributed.fusion import plan_buckets

    plan = plan_buckets([torch.zeros(s) for s in _LEAVES], THRESHOLD)
    assert len(plan) == 2
    for r in _members(ranks):
        assert r["fused_collectives"] == len(plan)
        for got, want in zip(r["fused"], reference["fused"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-6)


def test_zero_shards_over_the_subset(ranks):
    # The subset's mean gradient is (1 + 3) / 2 = 2 at lr 1.
    for r in _members(ranks):
        np.testing.assert_array_equal(r["zero"], np.arange(10.0) - 2.0)
        assert r["zero_shards"] == {"float32": (10, 5)}


def test_world_wide_groups_over_a_subset_raise(ranks):
    for r in _members(ranks):
        assert "the hierarchical ladder over the hvd.init(comm=[0, 2]) " \
            "subset is not ported" in r["refused"]["ladder"]
        assert "a DeviceMesh over the hvd.init(comm=[0, 2]) subset" \
            in r["refused"]["device_mesh"]


def test_out_of_range_raises_as_the_reference(ranks, reference):
    assert "out of range" in reference["range"]
    for r in ranks:
        assert "comm ranks [99] out of range for 4 ranks" in r["range"]


def test_comm_argument_checks():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    for comm, msg in (([], "names no rank"), ([2, 0], "increasing order"),
                      ([0, 0], "increasing order")):
        with pytest.raises(InvalidArgumentError, match=msg):
            hvd.init(comm=comm, device="cpu")
        assert not hvd.is_initialized()
    hvd.init(comm=[0], device="cpu")          # the whole world of one
    try:
        assert hvd.size() == 1 and hvd.rank() == 0
        from horovod_tpu_torch.common import basics

        assert basics.job_group() is None
    finally:
        hvd.shutdown()


def test_launcher_rank_without_a_card_raises(monkeypatch):
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import PreconditionError

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(basics, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(PreconditionError, match="NCCL needs one card a rank"):
        basics.init()
    assert not basics.is_initialized()
