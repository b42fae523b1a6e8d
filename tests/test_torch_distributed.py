"""The port's data-parallel half against the JAX package and exact answers.

* ``plan_buckets``, ``plan_summary`` and ``resolve_overlap`` equal the
  JAX functions on the shapes and thresholds of tests/test_overlap.py.
* A 2-rank gloo world (two processes, started once for the module by the
  ``two_ranks`` fixture, which runs every case in them and returns the
  results) holds ``fused_reduce`` to the exact integer answer of integer
  inputs for Sum, Average, Min and Max and under the fp16/bf16 cast
  compressors, and overlap on, off and the scatter form to bit
  identity; a ``DistributedOptimizer`` step on half batches to the
  single-process full-batch step (1e-6: the mean of two half-batch
  means is the full mean, up to the order of float32 sums); the same for
  ``backward_passes_per_step=2`` on quarter batches; and
  ``broadcast_parameters`` / ``broadcast_optimizer_state`` to the root's
  values exactly.
* A second 2-rank world, with a time limit of its own, takes two
  ``DistributedOptimizer(Adam)`` steps on a model with a parameter that
  only rank 0 uses in the first step and no rank in the second: both
  ranks plan the same buckets over every parameter, and each rank's
  parameters equal ``optax.adam`` on the rank-averaged gradients with
  zeros for the unused parameter (what the JAX package's
  ``allreduce_gradients_transform`` feeds its chain). A frozen parameter
  (``requires_grad`` False) under weight decay stays out of the plan,
  gets no gradient and keeps its bits.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# tests/test_overlap.py's shapes: thresholds carve distinct plans
# (33*4=132 B, 7*5*4=140, 101*4=404, 64*4=256, 257*4=1028).
_SHAPES = [(33,), (7, 5), (101,), (4, 4, 4), (257,)]
THRESHOLDS = [10**9, 400, 64]
# (overlap, scatter_threshold): the sequential form, the overlapped
# allreduce form, and the reduce-scatter + all-gather form.
MODES = [("off", 10**9), ("on", 10**9), ("on", 0), ("auto", 0)]
OPS = ["sum", "average", "min", "max", "fp16_average", "bf16_sum"]
CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
           max_len=32, dtype=torch.float32)
LR = 0.5


def _bases():
    rng = np.random.RandomState(0)
    return [np.asarray(rng.randint(-8, 8, size=s), np.float32)
            for s in _SHAPES]


def _tokens():
    return torch.tensor(np.random.default_rng(7).integers(0, 32, (4, 16)))


def _reduce_kwargs(op):
    from horovod_tpu_torch import distributed as hvd

    return {
        "sum": dict(average=False),
        "average": dict(average=True),
        "min": dict(op=hvd.Min),
        "max": dict(op=hvd.Max),
        "fp16_average": dict(average=True,
                             compression=hvd.Compression.fp16),
        "bf16_sum": dict(average=False, compression=hvd.Compression.bf16),
    }[op]


def _model(seed=0):
    from horovod_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(**CFG, seed=seed, device="cpu")


def _sgd_steps(batches, k=1):
    """A fresh model under DistributedOptimizer(SGD) fed ``batches`` one
    ``make_train_step`` call each; returns (params, last loss)."""
    from horovod_tpu_torch.distributed import DistributedOptimizer
    from horovod_tpu_torch.models.train import make_train_step

    model = _model()
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR),
                               named_parameters=model.named_parameters(),
                               backward_passes_per_step=k)
    step = make_train_step(model, opt)
    for b in batches:
        loss = step(b)
    return [p.detach().clone().numpy() for p in model.parameters()], \
        float(loss)


def _worker(rank, port, out):
    """One rank of the 2-process gloo world: every case, results saved."""
    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.distributed.fusion import fused_reduce

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    res = {"size": hvd.size(), "rank": hvd.rank()}
    for threshold in THRESHOLDS:
        for op in OPS:
            for mode, scatter in MODES:
                ts = [torch.tensor(b) * (rank + 1) for b in _bases()]
                before = fused_reduce.collectives
                out_ts = hvd.fused_reduce(
                    ts, fusion_threshold=threshold, overlap=mode,
                    scatter_threshold=scatter, **_reduce_kwargs(op))
                res[(threshold, op, mode, scatter)] = (
                    [o.numpy() for o in out_ts],
                    fused_reduce.collectives - before)
    toks = _tokens()
    res["dp"] = _sgd_steps([toks[2 * rank:2 * rank + 2]])
    res["bpps"] = _sgd_steps([toks[2 * rank:2 * rank + 1],
                              toks[2 * rank + 1:2 * rank + 2]], k=2)
    model = _model(seed=rank)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    res["bcast_params"] = [p.detach().clone().numpy()
                           for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3 * (rank + 1))
    model(toks[rank:rank + 1]).sum().backward()
    opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=1)
    st = opt.state_dict()
    res["bcast_opt"] = (st["param_groups"][0]["lr"],
                        [s["exp_avg"].numpy() for s in st["state"].values()])
    x = torch.arange(6.0).reshape(2, 3) * (rank + 1)
    res["ops"] = {
        "average": hvd.allreduce(x).numpy(),
        "sum": hvd.allreduce(x, average=False).numpy(),
        "product": hvd.allreduce(x, op=hvd.Product).numpy(),
        "async": hvd.synchronize(hvd.allreduce_async(x, average=False))
        .numpy(),
        "broadcast": hvd.broadcast(x, 1).numpy(),
        "allgather": hvd.allgather(x).numpy(),
        "object": hvd.broadcast_object({"from": rank}, 1),
        "loss_avg": float(hvd.allreduce(torch.tensor(float(rank)))),
    }
    res["x_untouched"] = x.numpy()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(worker, out, timeout):
    """Runs ``worker(rank, port, out)`` of this module in two processes
    (a gloo world of two); fails, after killing both, if either exits
    with an error or outlives ``timeout`` seconds. Returns each rank's
    saved results."""
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_distributed as m; m.{}({}, {}, {!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(str(REPO / "tests"), str(REPO),
                                           worker, r, port, out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            logs.append(stdout + stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _run_two("_worker", str(tmp_path_factory.mktemp("two_ranks")),
                    180)


@pytest.fixture
def world():
    """A gloo world of one in this process."""
    from horovod_tpu_torch.common import basics

    basics.init(device="cpu")
    yield
    basics.shutdown()


# ------------------------------------------------------------ plans vs JAX


def _leaves(dtypes=None):
    dtypes = dtypes or [torch.float32] * len(_SHAPES)
    return [torch.zeros(s, dtype=d) for s, d in zip(_SHAPES, dtypes)]


@pytest.mark.parametrize("threshold", [10**9, 400, 140, 132, 64])
@pytest.mark.parametrize("mixed", [False, True])
def test_plan_buckets_and_summary_equal_jax(threshold, mixed):
    import jax.numpy as jnp

    from horovod_tpu.jax import fusion as jf
    from horovod_tpu_torch.distributed import fusion as tf

    tdt = ([torch.float32, torch.bfloat16, torch.float32, torch.float16,
            torch.bfloat16] if mixed else None)
    jdt = ([jnp.float32, jnp.bfloat16, jnp.float32, jnp.float16,
            jnp.bfloat16] if mixed else [jnp.float32] * len(_SHAPES))
    want = jf.plan_buckets([jnp.zeros(s, d) for s, d in zip(_SHAPES, jdt)],
                           threshold)
    got = tf.plan_buckets(_leaves(tdt), threshold)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    assert tf.plan_summary(got) == jf.plan_summary(want)


@pytest.mark.parametrize("mode", ["auto", "on", "off", True, False, None])
def test_resolve_overlap_equals_jax(hvd, world, mode):
    from horovod_tpu.jax import fusion as jf
    from horovod_tpu_torch.distributed import fusion as tf

    for n in (0, 1, 2, 5):
        assert tf.resolve_overlap(mode, n) == jf.resolve_overlap(mode, n)


def test_resolve_overlap_rejects_what_jax_rejects(hvd, world):
    from horovod_tpu.common.exceptions import InvalidArgumentError as JErr
    from horovod_tpu.jax import fusion as jf
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.distributed import fusion as tf

    with pytest.raises(JErr) as want:
        jf.resolve_overlap("sometimes", 2)
    with pytest.raises(InvalidArgumentError) as got:
        tf.resolve_overlap("sometimes", 2)
    assert str(got.value) == str(want.value)


def test_config_reads_the_reference_env_knobs(monkeypatch):
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu_torch.common.config import Config

    for env in ({}, {"HOROVOD_FUSION_THRESHOLD": "1024",
                     "HOROVOD_OVERLAP": "OFF",
                     "HOROVOD_OVERLAP_SCATTER_THRESHOLD": "77"}):
        for k in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_OVERLAP",
                  "HOROVOD_OVERLAP_SCATTER_THRESHOLD"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        want, got = JConfig.from_env(), Config.from_env()
        for f in ("fusion_threshold", "overlap",
                  "overlap_scatter_threshold"):
            assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------------- the 2-rank world


def _exact(op, b):
    return {"sum": 3 * b, "average": 1.5 * b, "min": np.minimum(b, 2 * b),
            "max": np.maximum(b, 2 * b), "fp16_average": 1.5 * b,
            "bf16_sum": 3 * b}[op]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_fused_reduce_exact_and_bitidentical_across_modes(two_ranks, op,
                                                          threshold):
    from horovod_tpu_torch.distributed.fusion import plan_buckets

    wire = {"fp16_average": torch.float16, "bf16_sum": torch.bfloat16}.get(
        op, torch.float32)
    n_plan = len(plan_buckets(_leaves([wire] * len(_SHAPES)), threshold))
    for res in two_ranks:
        ref = res[(threshold, op, "off", 10**9)][0]
        for mode, scatter in MODES:
            got, issued = res[(threshold, op, mode, scatter)]
            for g, r, b in zip(got, ref, _bases()):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, _exact(op, b))
                np.testing.assert_array_equal(g, r)
            scattered = (scatter == 0 and op in ("sum", "average",
                                                 "fp16_average", "bf16_sum")
                         and (mode == "on" or n_plan >= 2))
            assert issued == n_plan * (2 if scattered else 1), (mode,
                                                                scatter)
    for key in two_ranks[0]:
        if isinstance(key, tuple) and key[0] == threshold and key[1] == op:
            for a, b in zip(two_ranks[0][key][0], two_ranks[1][key][0]):
                np.testing.assert_array_equal(a, b)


def test_two_rank_step_equals_the_full_batch_step(two_ranks, world):
    want, want_loss = _sgd_steps([_tokens()])
    for res in two_ranks:
        got, loss = res["dp"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    for a, b in zip(two_ranks[0]["dp"][0], two_ranks[1]["dp"][0]):
        np.testing.assert_array_equal(a, b)


def test_backward_passes_per_step_equals_the_doubled_batch(two_ranks,
                                                           world):
    want, _ = _sgd_steps([_tokens()])
    start = [p.detach().numpy() for p in _model().parameters()]
    for res in two_ranks:
        got, _ = res["bpps"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert any(np.abs(w - s).max() > 1e-3 for w, s in zip(want, start))


def test_backward_passes_per_step_in_one_process(world):
    """k=2 on two halves in a world of one: the first step() neither
    reduces nor updates; the second equals one step on the whole."""
    from horovod_tpu_torch.distributed.fusion import fused_reduce

    toks = _tokens()
    want, _ = _sgd_steps([toks])
    before = fused_reduce.collectives
    got, _ = _sgd_steps([toks[:2], toks[2:]], k=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert fused_reduce.collectives - before == 1     # one step, one bucket


def test_broadcasts_give_the_roots_values(two_ranks):
    root = [p.detach().numpy() for p in _model(seed=0).parameters()]
    for res in two_ranks:
        for g, w in zip(res["bcast_params"], root):
            np.testing.assert_array_equal(g, w)
    lr0, m0 = two_ranks[0]["bcast_opt"]
    lr1, m1 = two_ranks[1]["bcast_opt"]
    assert lr0 == lr1 == 2e-3
    for a, b in zip(m0, m1):
        np.testing.assert_array_equal(a, b)


def test_collectives_of_the_mpi_ops(two_ranks):
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    for res in two_ranks:
        ops = res["ops"]
        assert (res["size"], res["rank"]) == (2, two_ranks.index(res))
        np.testing.assert_array_equal(ops["average"], 1.5 * x)
        np.testing.assert_array_equal(ops["sum"], 3 * x)
        np.testing.assert_array_equal(ops["product"], 2 * x * x)
        np.testing.assert_array_equal(ops["async"], 3 * x)
        np.testing.assert_array_equal(ops["broadcast"], 2 * x)
        np.testing.assert_array_equal(ops["allgather"],
                                      np.concatenate([x, 2 * x]))
        assert ops["object"] == {"from": 1}
        assert ops["loss_avg"] == 0.5
        np.testing.assert_array_equal(res["x_untouched"],
                                      x * (res["rank"] + 1))


# ------------------------------------- parameters without a gradient

ADAM_LR = 0.01
# Step 1: rank 0 uses every parameter, rank 1 leaves "b" out; step 2:
# neither rank uses "b". A fusion threshold of 24 bytes splits the three
# parameters (12, 16 and 8 bytes) into two buckets, [a] and [b, c], where
# dropping "b" on one rank would leave [a, c] in one bucket.
NONE_GRAD_SHAPES = {"a": (3,), "b": (4,), "c": (2,)}
NONE_GRAD_THRESHOLD = 24
NONE_GRAD_USES_B = {(0, 1): True, (1, 1): False, (0, 2): False,
                    (1, 2): False}
# A frozen parameter in a param group of its own with weight decay: a
# zero gradient given to it would let the decay move it.
FROZEN_DECAY = 0.5


def _none_grad_init():
    rng = np.random.default_rng(11)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in NONE_GRAD_SHAPES.items()}


def _frozen_init():
    return np.random.default_rng(12).standard_normal(5).astype(np.float32)


def _none_grad_data(rank, step):
    rng = np.random.default_rng(100 + 10 * rank + step)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in NONE_GRAD_SHAPES.items()}


def _none_grad_loss(p, x, uses_b, xp):
    """The loss of one rank and step, for torch (``xp=torch``) and
    jax.numpy alike. Each gradient element is a product of a few factors
    (no difference of large terms), so the two frameworks' float32
    gradients agree to a few ulp."""
    loss = xp.sum(x["a"] * p["a"] ** 2) + xp.sum(xp.tanh(p["c"]) * x["c"])
    if uses_b:
        loss = loss + xp.sum(x["b"] * p["b"] ** 2)
    return loss


def _none_grad_worker(rank, port, out):
    """One rank: two DistributedOptimizer(Adam) steps, recording the
    bucket plan each rank reduces over."""
    from datetime import timedelta

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.distributed import fusion
    from horovod_tpu_torch.distributed import optimizer as dopt

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=30))
    hvd.init(device="cpu")
    params = {n: torch.nn.Parameter(torch.tensor(v))
              for n, v in _none_grad_init().items()}
    frozen = torch.nn.Parameter(torch.tensor(_frozen_init()),
                                requires_grad=False)
    ids = {id(p): n for n, p in params.items()}
    ids[id(frozen)] = "frozen"
    plans = []
    reduce = dopt.fused_reduce

    def recording(tensors, **kw):
        plan = fusion.plan_buckets(tensors, kw["fusion_threshold"])
        plans.append([(b.members, b.nbytes) for b in plan])
        return reduce(tensors, **kw)

    dopt.fused_reduce = recording
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([{"params": list(params.values())},
                          {"params": [frozen],
                           "weight_decay": FROZEN_DECAY}], lr=ADAM_LR),
        named_parameters=[*params.items(), ("frozen", frozen)],
        fusion_threshold=NONE_GRAD_THRESHOLD)
    names = [ids[id(p)] for p in opt._hvd_params]
    for step in (1, 2):
        opt.zero_grad()
        x = {n: torch.tensor(v) for n, v in
             _none_grad_data(rank, step).items()}
        _none_grad_loss(params, x, NONE_GRAD_USES_B[(rank, step)],
                        torch).backward()
        opt.step()
    torch.save({"names": names, "plans": plans,
                "params": {n: p.detach().numpy() for n, p in
                           params.items()},
                "frozen": frozen.detach().numpy(),
                "frozen_grad": frozen.grad},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def none_grad_ranks(tmp_path_factory):
    """A 2-rank world of its own, so that a rank stuck in a collective
    that the other rank never issues fails these cases within a minute
    (the gloo timeout is 30 s) and leaves ``two_ranks`` alone."""
    return _run_two("_none_grad_worker",
                    str(tmp_path_factory.mktemp("none_grad")), 60)


def test_none_gradients_plan_the_same_buckets_on_every_rank(
        none_grad_ranks):
    from horovod_tpu_torch.distributed.fusion import plan_buckets

    names = [n for n in none_grad_ranks[0]["names"] if n != "frozen"]
    assert sorted(names) == sorted(NONE_GRAD_SHAPES)
    want = [(b.members, b.nbytes) for b in plan_buckets(
        [torch.zeros(NONE_GRAD_SHAPES[n]) for n in names],
        NONE_GRAD_THRESHOLD)]
    assert len(want) == 2
    for res in none_grad_ranks:
        assert res["names"] == none_grad_ranks[0]["names"]
        assert res["plans"] == [want, want]


def test_frozen_parameter_is_not_reduced_or_moved(none_grad_ranks):
    """A parameter with ``requires_grad`` False is left out of the bucket
    plan (the plans above cover the three trainable ones), is given no
    gradient, and so Adam's weight decay in its group never moves it:
    its bits are the initial ones on every rank."""
    for res in none_grad_ranks:
        assert "frozen" in res["names"]
        assert res["frozen_grad"] is None
        np.testing.assert_array_equal(res["frozen"], _frozen_init())


def test_none_gradients_update_as_optax_adam_on_zeros(none_grad_ranks):
    """Each rank's parameters after both steps equal optax.adam on the
    rank-averaged gradients, zeros standing for an unused parameter.
    atol 1e-6: both sides run Adam in float32 on gradients of the same
    float32 losses (torch autograd against jax.grad), which agree to a
    few ulp. optax takes Adam's bias correction 1 - b2^t in float32
    (1.3e-5 relative off at t = 1), torch in float64, which moves each
    update, of about the learning rate 0.01, by about 1e-7. An update
    that is dropped or skipped is off by more than 5e-3."""
    import jax
    import jax.numpy as jnp
    import optax

    params = {n: jnp.asarray(v) for n, v in _none_grad_init().items()}
    tx = optax.adam(ADAM_LR)
    state = tx.init(params)
    for step in (1, 2):
        grads = [jax.grad(_none_grad_loss)(
            params, {n: jnp.asarray(v) for n, v in
                     _none_grad_data(rank, step).items()},
            NONE_GRAD_USES_B[(rank, step)], jnp) for rank in (0, 1)]
        mean = jax.tree_util.tree_map(lambda g0, g1: (g0 + g1) / 2, *grads)
        updates, state = tx.update(mean, state, params)
        params = optax.apply_updates(params, updates)
    start = _none_grad_init()
    assert np.abs(np.asarray(params["b"]) - start["b"]).min() > 0.01
    for res in none_grad_ranks:
        for n, want in params.items():
            np.testing.assert_allclose(res["params"][n], np.asarray(want),
                                       rtol=0, atol=1e-6, err_msg=n)


# ------------------------------------------------------- a world of one


def test_world_of_one_runs_the_plan_and_is_identity(world):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.distributed.fusion import fused_reduce

    ts = [torch.tensor(b) for b in _bases()]
    for mode in ("on", "off"):
        before = fused_reduce.collectives
        out = hvd.fused_reduce(ts, fusion_threshold=400, overlap=mode)
        assert fused_reduce.collectives - before == len(
            hvd.plan_buckets(ts, 400))
        for o, t in zip(out, ts):
            assert torch.equal(o, t) and o.data_ptr() != t.data_ptr()
    assert hvd.allreduce(ts[0]) is ts[0]
    assert (hvd.size(), hvd.rank(), hvd.local_rank()) == (1, 0, 0)


def test_unported_paths_and_bad_arguments_raise(world):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    ts = [torch.ones(3)]
    for kw in (dict(hierarchical="on"), dict(hierarchical="auto"),
               dict(residuals=())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            hvd.fused_reduce(ts, **kw)
    for comp in (hvd.Compression.int8, hvd.Compression.fp8):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            hvd.fused_reduce(ts, compression=comp)
    with pytest.raises(InvalidArgumentError, match="Unsupported"):
        hvd.allreduce(ts[0], op=object)
    with pytest.raises(InvalidArgumentError, match="root_rank"):
        hvd.broadcast(ts[0], 1)
    model = _model()
    with pytest.raises(ValueError, match="not named"):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1),
                                 named_parameters=[])
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.25))
    assert isinstance(opt, torch.optim.SGD)
    assert opt.param_groups[0]["lr"] == 0.25


def test_init_defaults_to_the_card(monkeypatch):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common.exceptions import PreconditionError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(PreconditionError, match="hvd.init"):
        hvd.size()
