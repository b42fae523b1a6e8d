"""The port's elastic training (``horovod_tpu_torch.elastic`` and
``horovod_tpu_torch.checkpoint``) against the JAX package's, on the CPU.

Parity, case for case with ``tests/test_elastic.py``: the fault-plan
grammar (equal actions, the same error text), manifests and checkpoints
written by either package read in the other (the files byte for byte,
bfloat16 through ``ml_dtypes`` on the JAX side only), the supervisor's
relaunch policy and metrics line on scripted outcomes, and
``ShardedBatchSource``'s cursors over a grid of worlds. Within the port:
the snapshotter's cadence, double buffer and spill, a snapshot of a
state that the step then mutates in place, ``PreemptionHandler`` and
``run_elastic``'s bit-exact resume, plain and windowed.

Trajectories against the JAX package: the toy step's losses agree
within 1e-6 relative (observed: a few float32 ulps, ~3e-7, since XLA
fuses ``w - 0.1 * (x * w)`` and rounds it differently from torch's
eager ops); a 2-layer LM (d_model 64, vocab 128, length 32, SGD) is held
within 1e-5 relative. Inside the port every resume is bit for bit.
"""

import dataclasses
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import elastic as jel
from horovod_tpu.flax.checkpoint import CheckpointManager as JaxManager
from horovod_tpu.run import JobResult as JJobResult
from horovod_tpu.run import WorkerExit as JWorkerExit
from horovod_tpu_torch import elastic
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.elastic.faults import FaultPlanError
from horovod_tpu_torch.run import JobResult, WorkerExit
from horovod_tpu_torch.run.driver import EXIT_PREEMPTED, EXIT_USAGE


def _manager(path):
    return CheckpointManager(str(path), backend="numpy")


def _toy_step():
    def step_fn(state, batch):
        g = batch["x"] * state["w"]
        return ({"w": state["w"] - 0.1 * g, "step": state["step"] + 1},
                {"loss": state["w"].sum()})

    def batch_for(step):
        return {"x": torch.tensor(step % 5 + 1, dtype=torch.float32)}

    init = {"w": torch.tensor(2.0), "step": torch.tensor(0,
                                                         dtype=torch.int32)}
    return step_fn, batch_for, init


def _jax_toy_step():
    def step_fn(state, batch):
        g = batch["x"] * state["w"]
        return ({"w": state["w"] - 0.1 * g, "step": state["step"] + 1},
                {"loss": jnp.sum(state["w"])})

    def batch_for(step):
        return {"x": jnp.float32(step % 5 + 1)}

    return step_fn, batch_for, {"w": jnp.float32(2.0),
                                "step": jnp.int32(0)}


def _traj(metrics):
    return {s: float(m["loss"]) for s, m in metrics}


# ---------------------------------------------------------------- fault plan

GOOD_PLANS = [
    "kill:rank=1,step=7; stall:rank=2,step=12,secs=0.5;"
    "preempt:rank=0,step=3,attempt=1;exit:rank=0,step=2,code=9",
    "", "  ;  ",
    "resize:rank=0,step=7,n=1;resize:rank=0,step=3,n=4,attempt=1",
    "resize:step=5,n=2", "KILL:rank=0,step=1", "exit:rank=3,step=4",
    "stall:rank=0,step=1,secs=2",
]

BAD_PLANS = [
    "explode:rank=0,step=1", "kill:rank=0", "kill:step=3",
    "kill:rank=zero,step=1", "kill:rank=0,step=1,flavor=spicy",
    "kill rank=0 step=1", "resize:rank=0,step=7",
    "resize:rank=0,step=7,n=0", "kill:rank=0,step=7,n=2",
    "resize:rank=0,step=3,n=1;resize:rank=1,step=9,n=2",
]


@pytest.mark.parametrize("plan", GOOD_PLANS)
def test_fault_plan_parses_as_the_reference(plan):
    port = elastic.parse_fault_plan(plan)
    ref = jel.parse_fault_plan(plan)
    assert [dataclasses.asdict(a) for a in port] == \
        [dataclasses.asdict(a) for a in ref]
    assert [str(a) for a in port] == [str(a) for a in ref]
    assert elastic.resize_requests(port) == jel.resize_requests(ref)


@pytest.mark.parametrize("plan", BAD_PLANS)
def test_fault_plan_rejects_as_the_reference(plan):
    with pytest.raises(jel.FaultPlanError) as ref:
        jel.parse_fault_plan(plan)
    with pytest.raises(FaultPlanError) as port:
        elastic.parse_fault_plan(plan)
    assert str(port.value) == str(ref.value)


def test_one_error_class_for_both_dialects():
    from horovod_tpu_torch.elastic.faults import parse_serve_fault_plan

    with pytest.raises(FaultPlanError):
        parse_serve_fault_plan("explode:replica=0,at=1s")
    assert elastic.FaultPlanError is FaultPlanError


def test_injector_filters_rank_and_attempt():
    plan = elastic.parse_fault_plan(
        "exit:rank=0,step=5;exit:rank=1,step=5;"
        "exit:rank=0,step=9,attempt=1")
    assert [a.step for a in elastic.FaultInjector(
        plan, rank=0, attempt=1).pending] == [9]
    assert [a.step for a in elastic.FaultInjector(
        plan, rank=1, attempt=0).pending] == [5]


def test_exit_action_fires_once_at_boundary():
    inj = elastic.FaultInjector(
        elastic.parse_fault_plan("exit:rank=0,step=5,code=7"),
        rank=0, attempt=0)
    inj.maybe_inject(4)
    with pytest.raises(SystemExit) as ei:
        inj.maybe_inject(6)
    assert ei.value.code == 7
    inj.maybe_inject(7)
    assert inj.pending == []


def test_stall_action_sleeps_bounded():
    inj = elastic.FaultInjector(
        elastic.parse_fault_plan("stall:rank=0,step=1,secs=0.2"),
        rank=0, attempt=0)
    t0 = time.monotonic()
    inj.maybe_inject(1)
    assert 0.15 <= time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("plan,code", [
    ("preempt:rank=0,step=2", EXIT_PREEMPTED),
    ("resize:rank=0,step=2,n=1", elastic.EXIT_RESIZED)])
def test_preempt_and_resize_trigger_the_handler(plan, code):
    handler = elastic.PreemptionHandler(install=False)
    inj = elastic.FaultInjector(elastic.parse_fault_plan(plan), rank=0,
                                attempt=0)
    inj.maybe_inject(2, preemption=handler)
    assert handler.triggered and handler.exit_code == code


def test_resize_without_handler_exits_resized():
    inj = elastic.FaultInjector(
        elastic.parse_fault_plan("resize:rank=0,step=2,n=1"), rank=0,
        attempt=0)
    with pytest.raises(SystemExit) as ei:
        inj.maybe_inject(2)
    assert ei.value.code == elastic.EXIT_RESIZED == 76


def test_injector_from_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", "kill:rank=3,step=11")
    monkeypatch.setenv("HOROVOD_RANK", "3")
    monkeypatch.setenv("HOROVOD_ELASTIC_RESTART", "0")
    assert [a.kind for a in elastic.FaultInjector.from_env().pending] == \
        ["kill"]


# ------------------------------------------------------------------ manifests


def _manifests():
    return [elastic.ResumeManifest(step=3, world_size=2, rank=1, attempt=1,
                                   cursor={"epoch": 0, "offset": 12},
                                   rng_key=[1, 2], wall_time=12.5),
            elastic.ResumeManifest(step=6, world_size=2, rank=1,
                                   cursor={"epoch": 0, "offset": 24},
                                   wall_time=13.0)]


def test_manifest_files_equal_the_reference_byte_for_byte(tmp_path):
    for m in _manifests():
        elastic.write_manifest(str(tmp_path / "port"), m)
        jel.write_manifest(str(tmp_path / "jax"), jel.ResumeManifest(
            **dataclasses.asdict(m)))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == \
        ["MANIFEST", "manifest-3.json", "manifest-6.json"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_read_across_packages(tmp_path, writer):
    d = str(tmp_path)
    for m in _manifests():
        if writer == "port":
            elastic.write_manifest(d, m)
        else:
            jel.write_manifest(d, jel.ResumeManifest(
                **dataclasses.asdict(m)))
    for reader in (elastic, jel):
        assert reader.manifest_steps(d) == [3, 6]
        latest = reader.latest_manifest(d)
        assert latest.step == 6 and latest.cursor["offset"] == 24
        old = reader.read_manifest(d, 3)
        assert old.rng_key == [1, 2] and old.attempt == 1
        assert np.array_equal(old.rng(), np.asarray([1, 2], np.uint32))


def test_torn_pointer_falls_back(tmp_path):
    d = str(tmp_path)
    elastic.write_manifest(d, elastic.ResumeManifest(step=4))
    (tmp_path / "MANIFEST").write_text("manifest-999.json\n")
    assert elastic.latest_manifest(d).step == 4
    assert elastic.latest_manifest(str(tmp_path / "none")) is None
    assert elastic.manifest_steps(str(tmp_path / "none")) == []


# ---------------------------------------------------------------- checkpoints

DTYPES = [("float32", torch.float32, np.float32),
          ("int32", torch.int32, np.int32),
          ("uint32", torch.uint32, np.uint32),
          ("bool", torch.bool, np.bool_),
          ("bfloat16", torch.bfloat16, ml_dtypes.bfloat16)]


def _tree(name, tdtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 100
    if name == "bool":
        x = x > 0
    elif name == "uint32":
        x = np.abs(x)
    t = torch.tensor(np.asarray(x, np.float64)).to(tdtype) \
        if name == "bfloat16" else torch.from_numpy(
            np.asarray(x).astype({"float32": np.float32,
                                  "int32": np.int32, "uint32": np.uint32,
                                  "bool": np.bool_}[name]))
    return {"b": t, "a": {"s": torch.tensor(7, dtype=torch.int32),
                          "v": [t.flatten()[:3].clone()]}}


def _np_of(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _equal(a, b):
    from horovod_tpu_torch._pytree import flatten

    la, _ = flatten(a)
    lb, _ = flatten(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                        else x, y.view(torch.int16)
                        if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("name,tdtype,ndtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_checkpoint_round_trip(tmp_path, name, tdtype, ndtype, shape):
    state = _tree(name, tdtype, shape)
    m = _manager(tmp_path)
    m.save(5, state)
    template = torch.utils._pytree.tree_map(torch.zeros_like, state)
    out = m.restore(5, template)
    assert _equal(out, state)
    # New tensors: the template is never written.
    assert not any(torch.utils._pytree.tree_leaves(
        torch.utils._pytree.tree_map(lambda t: t.any(), template)))


@pytest.mark.parametrize("name,tdtype,ndtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path, name,
                                                        tdtype, ndtype):
    state = _tree(name, tdtype, (3, 4))
    jstate = torch.utils._pytree.tree_map(_np_of, state)
    JaxManager(str(tmp_path), backend="numpy").save(2, jstate)
    out = _manager(tmp_path).restore(2, torch.utils._pytree.tree_map(
        torch.zeros_like, state))
    assert _equal(out, state)


@pytest.mark.parametrize("name,tdtype,ndtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path, name,
                                                        tdtype, ndtype):
    state = _tree(name, tdtype, (4,))
    _manager(tmp_path / "port").save(2, state)
    jstate = torch.utils._pytree.tree_map(_np_of, state)
    JaxManager(str(tmp_path / "jax"), backend="numpy").save(2, jstate)
    for f in ("shard-0.bin", "shard-0.json", "COMMIT"):
        assert (tmp_path / "port" / "step_2" / f).read_bytes() == \
            (tmp_path / "jax" / "step_2" / f).read_bytes(), f
    out = JaxManager(str(tmp_path / "port"), backend="numpy").restore(
        2, template=jax.tree_util.tree_map(np.zeros_like, jstate))
    for x, y in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(jstate)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_uncommitted_step_is_invisible_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), max_to_keep=2, backend="numpy")
    for s in (1, 2, 3):
        m.save(s, {"w": torch.full((2,), float(s))})
    assert m.all_steps() == [2, 3] and m.latest_step() == 3
    os.makedirs(tmp_path / "step_9")
    (tmp_path / "step_9" / "shard-0.json").write_text("{}")
    assert m.all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        m.restore(9, {"w": torch.zeros(2)})
    assert m.restore(None, {"w": torch.zeros(2)})["w"].tolist() == [3., 3.]


def test_restore_needs_a_matching_template(tmp_path):
    m = _manager(tmp_path)
    m.save(1, {"w": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="template"):
        m.restore(1)
    with pytest.raises(ValueError, match="structure changed"):
        m.restore(1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        m.restore(1, {"w": torch.zeros(2), "b": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        _manager(tmp_path / "empty").restore(None, {"w": torch.zeros(2)})


def test_restore_takes_the_template_dtype_and_numpy_leaves(tmp_path):
    m = _manager(tmp_path)
    m.save(1, {"w": torch.arange(3, dtype=torch.float32),
               "n": np.arange(2, dtype=np.int64)})
    out = m.restore(1, {"w": torch.zeros(3, dtype=torch.float64),
                        "n": np.zeros(2, np.int64)})
    assert out["w"].dtype == torch.float64 and out["w"].tolist() == \
        [0., 1., 2.]
    assert isinstance(out["n"], np.ndarray) and out["n"].tolist() == [0, 1]


@pytest.mark.parametrize("backend,env,ok", [
    ("numpy", None, True), ("auto", None, True), (None, None, True),
    (None, "numpy", True), (None, "AUTO", True), ("orbax", None, False),
    (None, "orbax", False), ("zarr", None, False)])
def test_backend_resolution(tmp_path, monkeypatch, backend, env, ok):
    monkeypatch.delenv("HVD_CHECKPOINT_BACKEND", raising=False)
    if env is not None:
        monkeypatch.setenv("HVD_CHECKPOINT_BACKEND", env)
    if ok:
        assert CheckpointManager(str(tmp_path), backend=backend).backend \
            == "numpy"
    else:
        with pytest.raises(ValueError,
                           match="JAX library|expected one of"):
            CheckpointManager(str(tmp_path), backend=backend)


# ---------------------------------------------------------------- snapshotter


def test_snapshot_cadence_and_double_buffer():
    snap = elastic.Snapshotter(every=2)
    w = torch.arange(4.0)
    taken = [s for s in range(1, 7)
             if snap.maybe(s, {"w": w * s,
                               "s": torch.tensor(s, dtype=torch.int32)})]
    assert taken == [2, 4, 6]
    step, state = snap.latest
    assert step == 6 and torch.equal(state["w"], w * 6)
    assert snap.stats["snapshots"] == 3 and snap.stats["last_ms"] is not None


def test_snapshot_keeps_the_values_of_take_time():
    """A state the step then mutates in place (as a window does) leaves
    the snapshot as it was at take."""
    snap = elastic.Snapshotter(every=1)
    state = {"w": torch.arange(4.0), "m": [torch.ones(2)]}
    snap.take(1, state)
    state["w"].add_(10)
    state["m"][0].mul_(3)
    step, got = snap.latest
    assert step == 1 and got["w"].tolist() == [0., 1., 2., 3.]
    assert got["m"][0].tolist() == [1., 1.]


def test_window_alignment_enforced():
    snap = elastic.Snapshotter(every=10)
    snap.check_alignment(5)
    with pytest.raises(ValueError, match="window"):
        snap.check_alignment(3)


def test_spill_cadence_and_restore(tmp_path):
    with _manager(tmp_path) as mngr:
        snap = elastic.Snapshotter(mngr, every=1, spill_every=2)
        for s in range(1, 5):
            snap.maybe(s, {"w": torch.arange(3.0) + s},
                       cursor={"offset": s})
        assert mngr.all_steps() == [2, 4]
        state, manifest = snap.restore({"w": torch.zeros(3)})
        assert manifest.step == 4 and manifest.cursor["offset"] == 4
        assert torch.equal(state["w"], torch.arange(3.0) + 4)


def test_flush_is_a_synchronous_final_snapshot(tmp_path):
    gen = torch.Generator().manual_seed(5)
    with _manager(tmp_path) as mngr:
        snap = elastic.Snapshotter(mngr, every=100, spill_every=100)
        snap.flush(7, {"w": torch.tensor(3.0)}, cursor=7,
                   rng_key=np.asarray([5, 6], np.uint32))
        assert mngr.all_steps() == [7]
        m = elastic.latest_manifest(str(tmp_path))
        assert m.step == 7 and m.rng_key == [5, 6]
        snap.flush(8, {"w": torch.tensor(4.0)}, rng_key=gen)
        m = elastic.latest_manifest(str(tmp_path))
        assert m.rng_key == gen.get_state().tolist()
    with pytest.raises(ValueError, match="step"):
        elastic.Snapshotter(every=1).flush(state={"w": torch.tensor(1.0)})


def test_flush_without_state_spills_the_unspilled_latest(tmp_path):
    with _manager(tmp_path) as mngr:
        snap = elastic.Snapshotter(mngr, every=1, spill_every=10)
        snap.take(3, {"w": torch.tensor(1.0)})
        assert mngr.all_steps() == []
        snap.flush()
        assert mngr.all_steps() == [3]


def test_restore_walks_past_missing_checkpoint(tmp_path):
    with _manager(tmp_path) as mngr:
        snap = elastic.Snapshotter(mngr, every=1, spill_every=1)
        snap.take(3, {"w": torch.tensor(1.0)}, sync=True)
        elastic.write_manifest(str(tmp_path),
                               elastic.ResumeManifest(step=9))
        state, manifest = snap.restore({"w": torch.tensor(0.0)})
        assert manifest.step == 3 and float(state["w"]) == 1.0


def test_ram_only_without_manager():
    snap = elastic.Snapshotter(every=1)
    snap.take(1, {"w": torch.tensor(1.0)})
    assert snap.restore({"w": torch.tensor(0.0)}) is None
    assert snap.latest[0] == 1
    assert snap.staging_bytes == 0 and snap.pinned_bytes == 0


def test_snapshotter_world_defaults_from_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_RANK", "3")
    monkeypatch.setenv("HOROVOD_SIZE", "4")
    monkeypatch.setenv("HOROVOD_SNAPSHOT_EVERY", "7")
    snap = elastic.Snapshotter()
    assert (snap.rank, snap.world_size, snap.every) == (3, 4, 7)
    monkeypatch.setenv("HOROVOD_SNAPSHOT_EVERY", "x")
    assert elastic.Snapshotter().every == 100
    with pytest.raises(ValueError):
        elastic.Snapshotter(every=0)


# -------------------------------------------------------------------- signals


def test_real_sigterm_sets_the_flag_only():
    with elastic.PreemptionHandler() as handler:
        assert not handler.check()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not handler.triggered and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handler.triggered and handler.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) != handler._on_signal


def test_finalize_snapshots_and_exits_75(tmp_path):
    with _manager(tmp_path) as mngr:
        snap = elastic.Snapshotter(mngr, every=100)
        handler = elastic.PreemptionHandler(install=False)
        handler.trigger()
        codes = []
        handler.finalize(snap, 5, {"w": torch.tensor(2.0)},
                         _exit=codes.append, cursor={"offset": 20})
        assert codes == [EXIT_PREEMPTED] == [75]
        assert mngr.all_steps() == [5]
        assert elastic.latest_manifest(str(tmp_path)).step == 5


# ----------------------------------------------------------------- supervisor


def _results(outcomes, port=True):
    """Scripted launch outcomes: ``(codes, trigger (rank, code,
    stalled) or None, pre_kill or None)`` into either package's
    ``JobResult``."""
    jr, we = (JobResult, WorkerExit) if port else (JJobResult, JWorkerExit)
    out = []
    for codes, trig, pre in outcomes:
        trigger = None if trig is None else we(*trig)
        out.append(jr(exit_codes=codes, trigger=trigger,
                      pre_kill_codes=pre if pre is not None else (
                          {trigger.rank: trigger.code}
                          if trigger is not None else {})))
    return out


def _fake_launch(outcomes, seen_envs, seen_np):
    outcomes = list(outcomes)

    def launch(cmd, np, hosts=None, env=None, **kw):
        seen_envs.append(dict(env or {}))
        seen_np.append(np)
        return outcomes.pop(0)

    return launch


P, R = EXIT_PREEMPTED, elastic.EXIT_RESIZED
RESIZE_PLAN = {"HOROVOD_FAULT_PLAN": "resize:rank=0,step=7,n=1"}
# name: (supervise kwargs, outcomes, rc, nps)
POLICY = {
    "crash_then_clean": (dict(np=2, max_restarts=1), [
        ({0: -9, 1: -15}, (0, -9), None), ({0: 0, 1: 0}, None, None)],
        0, [2, 2]),
    "crash_budget_exhausted": (dict(np=2, max_restarts=1), [
        ({0: -9}, (0, -9), None), ({0: 1}, (0, 1), None)], 1, [2, 2]),
    "usage_never_relaunches": (dict(np=2, max_restarts=5), [
        ({0: 2}, (0, 2), None)], EXIT_USAGE, [2]),
    "preemptions_free": (dict(np=2, max_restarts=0), [
        ({0: P}, (0, P), None), ({0: -15}, (0, -15), None),
        ({0: 0}, None, None)], 0, [2, 2, 2]),
    "count_preemptions": (dict(np=2, max_restarts=1,
                               count_preemptions=True), [
        ({0: P}, (0, P), None), ({0: P}, (0, P), None)], P, [2, 2]),
    "resize_free_at_plan_size": (dict(np=2, max_restarts=0, min_np=1,
                                      env=RESIZE_PLAN), [
        ({0: R, 1: -15}, (0, R), None), ({0: 0}, None, None)], 0, [2, 1]),
    "preempt_shrinks_crash_holds": (dict(np=3, max_restarts=1, min_np=1), [
        ({1: P}, (1, P), None), ({0: -9}, (0, -9), None),
        ({0: 0}, None, None)], 0, [3, 2, 2]),
    "whole_host_loss": (dict(np=4, max_restarts=0, min_np=1), [
        ({2: P, 3: P}, (2, P), {2: P, 3: P}), ({0: 0}, None, None)],
        0, [4, 2]),
    "capacity_never_overrides_resize": (dict(
        np=2, max_restarts=0, min_np=1, max_np=4, env=RESIZE_PLAN,
        capacity_fn=lambda: 4), [
        ({0: R}, (0, R), None), ({0: 0}, None, None)], 0, [2, 1]),
    "fixed_world_never_shrinks": (dict(np=2, max_restarts=0), [
        ({0: P}, (0, P), None), ({0: 0}, None, None)], 0, [2, 2]),
    "stalled_consumes_budget": (dict(np=2, max_restarts=0), [
        ({1: -9}, (1, -9, True), None)], -9, [2]),
    "stalled_then_clean": (dict(np=2, max_restarts=1), [
        ({1: -9}, (1, -9, True), None), ({0: 0}, None, None)], 0, [2, 2]),
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_supervise_policy_and_metrics_equal_the_reference(tmp_path, name):
    kwargs, outcomes, rc, nps = POLICY[name]
    recs = {}
    for port in (True, False):
        sup = elastic.supervise if port else jel.supervise
        envs, seen = [], []
        path = tmp_path / f"{port}.tsv"
        got = sup(["prog"], metrics_path=str(path), watchdog_timeout=0.0,
                  _launch=_fake_launch(_results(outcomes, port), envs,
                                       seen), **kwargs)
        assert got == rc and seen == nps
        assert [e["HOROVOD_ELASTIC_RESTART"] for e in envs] == \
            [str(a) for a in range(len(nps))]
        assert all(e["HOROVOD_ELASTIC"] == "1" for e in envs)
        _, lane, payload = path.read_text().strip().split("\t", 2)
        assert lane == "elastic_supervise"
        recs[port] = json.loads(payload)
    for rec in recs.values():
        rec["elastic"].pop("wall_s")
        rec["elastic"].pop("relaunch_s")
    assert recs[True] == recs[False]


def test_supervise_capacity_grows_back():
    capacity = iter([1, 4])
    envs, nps = [], []
    rc = elastic.supervise(
        ["prog"], np=2, max_restarts=0, min_np=1, max_np=4,
        capacity_fn=lambda: next(capacity),
        _launch=_fake_launch(_results([
            ({0: P}, (0, P), None), ({0: P}, (0, P), None),
            ({0: 0}, None, None)]), envs, nps))
    assert rc == 0 and nps == [2, 1, 4]


def test_supervise_validates_bounds_and_plan():
    with pytest.raises(ValueError, match="min_np"):
        elastic.supervise(["prog"], np=2, min_np=3,
                          _launch=_fake_launch([], [], []))
    with pytest.raises(ValueError, match="bounds"):
        elastic.supervise(["prog"], np=2, max_restarts=0, min_np=1,
                          max_np=2, env={"HOROVOD_FAULT_PLAN":
                                         "resize:rank=0,step=7,n=5"},
                          _launch=_fake_launch([], [], []))
    with pytest.raises(ValueError, match="max_restarts"):
        elastic.supervise(["prog"], np=1, max_restarts=-1)


def test_supervise_metrics_exit_code_none_on_exception(tmp_path):
    path = tmp_path / "metrics.tsv"

    def boom(cmd, np, **kw):
        raise RuntimeError("launcher died")

    with pytest.raises(RuntimeError):
        elastic.supervise(["prog"], np=2, metrics_path=str(path),
                          _launch=boom)
    rec = json.loads(path.read_text().split("\t", 2)[2])
    assert rec["elastic"]["exit_code"] is None


def test_supervise_heartbeat_dir_namespaced_and_removed(tmp_path):
    base = str(tmp_path / "hb")
    exported = []
    for _ in range(2):
        envs, nps = [], []
        assert elastic.supervise(
            ["prog"], np=1, watchdog_timeout=30.0, heartbeat_dir=base,
            _launch=_fake_launch(_results([({0: 0}, None, None)]), envs,
                                 nps)) == 0
        exported.append(envs[0]["HOROVOD_HEARTBEAT_DIR"])
    assert exported[0] != exported[1]
    assert all(os.path.dirname(d) == base and not os.path.exists(d)
               for d in exported)
    assert os.listdir(base) == []
    envs = []
    elastic.supervise(["prog"], np=1, watchdog_timeout=0.0,
                      env={"HOROVOD_HEARTBEAT_DIR": "/nonexistent/outer"},
                      _launch=_fake_launch(_results([({0: 0}, None,
                                                      None)]), envs, []))
    assert "HOROVOD_HEARTBEAT_DIR" not in envs[0]


def test_watchdog_timeout_from_env(monkeypatch):
    from horovod_tpu_torch.elastic.supervisor import \
        _resolve_watchdog_timeout

    monkeypatch.delenv("HOROVOD_WATCHDOG_TIMEOUT", raising=False)
    assert _resolve_watchdog_timeout(None) == 300.0
    monkeypatch.setenv("HOROVOD_WATCHDOG_TIMEOUT", "2.5")
    assert _resolve_watchdog_timeout(None) == 2.5
    assert _resolve_watchdog_timeout(9) == 9.0


def test_slots_file_capacity(tmp_path):
    path = tmp_path / "slots"
    fn = elastic.slots_file_capacity(str(path))
    assert fn() is None
    path.write_text("3\n")
    assert fn() == 3
    path.write_text("soon\n")
    assert fn() is None


# ------------------------------------------------------------ batch source


def _sources(rank, size, n=64, batch=4, seed=0):
    arrays = {"x": np.arange(float(n), dtype=np.float32)}
    return (elastic.ShardedBatchSource(arrays, batch_size=batch, rank=rank,
                                       size=size, seed=seed),
            jel.ShardedBatchSource(arrays, batch_size=batch, rank=rank,
                                   size=size, seed=seed))


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_batch_source_equals_the_reference(size, seed):
    for rank in range(size):
        port, ref = _sources(rank, size, n=50, batch=3, seed=seed)
        assert port.steps_per_epoch == ref.steps_per_epoch
        for step in (0, 1, 7, 23):
            assert port.cursor(step) == ref.cursor(step)
            assert np.array_equal(port.indices_at(step),
                                  ref.indices_at(step))
            assert np.array_equal(port.global_positions(step),
                                  ref.global_positions(step))
            assert port.consumed_samples(step) == \
                ref.consumed_samples(step)
            batch = port.batch_at(step)
            assert torch.equal(batch["x"], torch.from_numpy(
                ref.batch_at(step)["x"]))
        for old in (1, 2, 4):
            src_old = _sources(0, old, n=50, batch=3, seed=seed)[0]
            for step in (2, 4, 8):
                cur = src_old.cursor(step)
                try:
                    want = ref.resume_step(cur)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        port.resume_step(cur)
                    assert str(got.value) == str(e)
                else:
                    assert port.resume_step(cur) == want


def test_batch_source_rejects_as_the_reference():
    port, ref = _sources(0, 1)
    for bad in (5, {"epoch": 0}, elastic.ResumeManifest(step=5, cursor=5)):
        with pytest.raises(ValueError, match="cursor") as got:
            port.resume_step(bad)
        with pytest.raises(ValueError) as want:
            ref.resume_step(bad if not isinstance(
                bad, elastic.ResumeManifest) else jel.ResumeManifest(
                    step=5, cursor=5))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="lengths differ"):
        elastic.ShardedBatchSource({"a": np.zeros(3), "b": np.zeros(4)}, 1)


# ----------------------------------------------------------------- the loop


@pytest.mark.parametrize("k", [1, 3])
def test_toy_trajectory_equals_the_reference(tmp_path, k):
    step_fn, batch_for, init = _toy_step()
    s, met, _ = elastic.run_elastic(step_fn, init, batch_for, 12,
                                    manager=_manager(tmp_path / "p"),
                                    snapshot_every=3,
                                    steps_per_dispatch=k)
    jstep, jbatch, jinit = _jax_toy_step()
    js, jmet, _ = jel.run_elastic(jstep, jinit, jbatch, 12,
                                  manager=JaxManager(str(tmp_path / "j"),
                                                     backend="numpy"),
                                  snapshot_every=3, steps_per_dispatch=k)
    got, want = _traj(met), _traj(jmet)
    assert sorted(got) == sorted(want) == list(range(k, 13, k))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-6)
    np.testing.assert_allclose(float(s["w"]), float(js["w"]), rtol=1e-6)
    assert int(s["step"]) == 12


@pytest.mark.parametrize("k", [1, 3])
def test_resume_is_bit_exact(tmp_path, k):
    step_fn, batch_for, init = _toy_step()
    s_full, met_full, r0 = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=_manager(tmp_path / "full"),
        snapshot_every=3, steps_per_dispatch=k)
    assert r0 == 0
    m = _manager(tmp_path / "ckpt")
    _, met_a, _ = elastic.run_elastic(step_fn, init, batch_for, 6,
                                      manager=m, snapshot_every=3,
                                      steps_per_dispatch=k)
    s_b, met_b, resumed = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=m, snapshot_every=3,
        steps_per_dispatch=k)
    assert resumed == 6
    assert torch.equal(s_b["w"], s_full["w"])
    assert _traj(met_a + met_b) == _traj(met_full)
    assert float(init["w"]) == 2.0     # the caller's state is untouched


def test_finished_run_reinvocation_is_a_noop_resume(tmp_path):
    step_fn, batch_for, init = _toy_step()
    m = _manager(tmp_path)
    s1, _, _ = elastic.run_elastic(step_fn, init, batch_for, 6, manager=m,
                                   snapshot_every=3)
    s2, met2, resumed = elastic.run_elastic(step_fn, init, batch_for, 6,
                                            manager=m, snapshot_every=3)
    assert resumed == 6 and met2 == [] and torch.equal(s2["w"], s1["w"])


@pytest.mark.parametrize("k", [1, 2])
def test_preemption_at_boundary_saves_and_exits_75(tmp_path, k):
    step_fn, batch_for, init = _toy_step()
    m = _manager(tmp_path / "a")
    handler = elastic.PreemptionHandler(install=False)
    inj = elastic.FaultInjector(
        elastic.parse_fault_plan("preempt:rank=0,step=4"), rank=0,
        attempt=0)
    with pytest.raises(SystemExit) as ei:
        elastic.run_elastic(step_fn, init, batch_for, 12, manager=m,
                            snapshot_every=2, injector=inj,
                            preemption=handler, steps_per_dispatch=k)
    assert ei.value.code == EXIT_PREEMPTED
    assert elastic.latest_manifest(str(tmp_path / "a")).step == 4
    s_resumed, _, resumed = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=m, snapshot_every=2,
        steps_per_dispatch=k)
    s_full, _, _ = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=_manager(tmp_path / "b"),
        snapshot_every=2, steps_per_dispatch=k)
    assert resumed == 4 and torch.equal(s_resumed["w"], s_full["w"])


def test_prebuilt_snapshotter_resumes_too(tmp_path):
    step_fn, batch_for, init = _toy_step()
    mngr = _manager(tmp_path)
    elastic.run_elastic(step_fn, init, batch_for, 6,
                        snapshotter=elastic.Snapshotter(mngr, every=3))
    assert elastic.latest_manifest(str(tmp_path)).step == 6
    s2, _, resumed = elastic.run_elastic(
        step_fn, init, batch_for, 12,
        snapshotter=elastic.Snapshotter(mngr, every=3))
    s_full, _, _ = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=_manager(tmp_path / "full"),
        snapshot_every=3)
    assert resumed == 6 and torch.equal(s2["w"], s_full["w"])


def test_misaligned_cadence_and_steps_rejected(tmp_path):
    step_fn, batch_for, init = _toy_step()
    with pytest.raises(ValueError, match="window"):
        elastic.run_elastic(step_fn, init, batch_for, 12,
                            manager=_manager(tmp_path), snapshot_every=4,
                            steps_per_dispatch=3)
    with pytest.raises(ValueError, match="multiple"):
        elastic.run_elastic(step_fn, init, batch_for, 10,
                            snapshot_every=3, steps_per_dispatch=3)


def test_window_needs_tensor_leaves():
    step_fn, batch_for, _ = _toy_step()
    with pytest.raises(ValueError, match="all tensors"):
        elastic.run_elastic(step_fn, {"w": torch.tensor(1.0), "step": 0},
                            batch_for, 6, snapshot_every=3,
                            steps_per_dispatch=3)


def test_rng_generator_is_recorded_and_restored(tmp_path):
    """A torch.Generator given as ``rng_key`` lands in the manifest as its
    state bytes and comes back in place on resume."""
    def step_fn(state, batch):
        return {"w": state["w"] + batch["x"]}, {"loss": state["w"]}

    gen = torch.Generator().manual_seed(11)
    m = _manager(tmp_path)
    elastic.run_elastic(step_fn, {"w": torch.tensor(0.0)},
                        lambda s: {"x": torch.tensor(float(s))}, 4,
                        manager=m, snapshot_every=2, rng_key=gen)
    saved = gen.get_state().clone()
    assert elastic.latest_manifest(str(tmp_path)).rng_key == \
        saved.tolist()
    fresh = torch.Generator().manual_seed(99)
    elastic.run_elastic(step_fn, {"w": torch.tensor(0.0)},
                        lambda s: {"x": torch.tensor(float(s))}, 4,
                        manager=m, snapshot_every=2, rng_key=fresh)
    assert torch.equal(fresh.get_state(), saved)


def _resize_train(tmp_path, src, steps, world_size, **kw):
    def step_fn(state, batch):
        g = batch["x"].mean()
        return ({"w": state["w"] - 0.01 * g, "step": state["step"] + 1},
                {"loss": state["w"]})

    init = {"w": torch.tensor(2.0), "step": torch.tensor(0,
                                                         dtype=torch.int32)}
    return elastic.run_elastic(
        step_fn, init, src.batch_at if src is not None
        else (lambda s: {"x": torch.tensor(float(s))}),
        steps, manager=_manager(tmp_path), snapshot_every=3,
        world_size=world_size, rank=0, **kw)


def test_reshard_resume_remaps_and_rescales(tmp_path):
    arrays = {"x": np.arange(64, dtype=np.float32)}
    src2 = elastic.ShardedBatchSource(arrays, batch_size=4, rank=0, size=2,
                                      seed=0)
    _resize_train(tmp_path, src2, 6, 2)
    m = elastic.latest_manifest(str(tmp_path))
    assert m.step == 6 and m.world_size == 2 and m.cursor["size"] == 2
    src1 = elastic.ShardedBatchSource(arrays, batch_size=4, rank=0, size=1,
                                      seed=0)
    resizes = []

    def on_resize(old, new, state):
        resizes.append((old, new))
        return dict(state, w=state["w"] * 2)

    _, _, resumed = _resize_train(tmp_path, src1, 24, 1,
                                  on_resize=on_resize)
    assert resumed == 12 and resizes == [(2, 1)]
    assert elastic.latest_manifest(str(tmp_path)).world_size == 1


def test_mismatch_without_remap_is_rejected(tmp_path):
    arrays = {"x": np.arange(64, dtype=np.float32)}
    src2 = elastic.ShardedBatchSource(arrays, batch_size=4, rank=0, size=2,
                                      seed=0)
    _resize_train(tmp_path, src2, 6, 2)
    with pytest.raises(ValueError, match="reshard"):
        _resize_train(tmp_path, None, 24, 1)


def test_resume_manager_is_the_restore_authority(tmp_path):
    step_fn, batch_for, init = _toy_step()
    elastic.run_elastic(step_fn, init, batch_for, 6,
                        manager=_manager(tmp_path / "rank0"),
                        snapshot_every=3, world_size=1, rank=0)
    _, _, resumed = elastic.run_elastic(
        step_fn, init, batch_for, 12, manager=_manager(tmp_path / "rank2"),
        snapshot_every=3, world_size=1, rank=2,
        resume_manager=_manager(tmp_path / "rank0"))
    assert resumed == 6
    assert elastic.latest_manifest(str(tmp_path / "rank2")).step == 12


def test_heartbeat_touched_at_boundaries(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_HEARTBEAT_DIR", str(tmp_path / "hb"))
    step_fn, batch_for, init = _toy_step()
    seen = []
    elastic.run_elastic(step_fn, init, batch_for, 4, snapshot_every=2,
                        on_step=lambda s, m: seen.append(
                            (tmp_path / "hb" / "hb-0").read_text()))
    assert [x.split()[1] for x in seen] == ["1", "2", "3", "4"]


# -------------------------------------------------------- a small LM, resumed

LM = dict(vocab=128, max_len=32, layers=2, heads=4, head_dim=16, ffn=128)
LM_LR = 0.5
LM_STEPS = 6


def _lm_tokens():
    return np.random.default_rng(3).integers(
        0, LM["vocab"], (16, LM["max_len"])).astype(np.int32)


def _lm_run(tmp_path, tag, steps, params):
    from torch.utils._pytree import tree_unflatten

    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.models import parallel_lm as tlm

    def step_fn(state, batch):
        leaves, spec = flatten(state["params"])
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        toks = batch["tokens"].long()
        loss = tlm.next_token_nll(
            tlm.lm_apply(tree_unflatten(leaves, spec), toks), toks)
        grads = torch.autograd.grad(loss, leaves)
        new = [x.detach() - LM_LR * g for x, g in zip(leaves, grads)]
        return ({"params": tree_unflatten(new, spec),
                 "step": state["step"] + 1}, {"loss": loss.detach()})

    src = elastic.ShardedBatchSource({"tokens": _lm_tokens()}, batch_size=2,
                                     rank=0, size=1, seed=1)
    return elastic.run_elastic(
        step_fn, {"params": params, "step": torch.tensor(0)}, src.batch_at,
        steps, manager=_manager(tmp_path / tag), snapshot_every=3,
        world_size=1, rank=0)


def test_small_lm_resume_bit_exact_and_equal_to_jax(tmp_path):
    from horovod_tpu.models import parallel_lm as jlm
    from horovod_tpu_torch.models import parallel_lm as tlm

    jparams = jlm.init_lm_params(jax.random.PRNGKey(0), **LM)
    params = tlm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
    s_full, met_full, _ = _lm_run(tmp_path, "full", LM_STEPS, params)
    _, met_a, _ = _lm_run(tmp_path, "stop", 3, params)
    s_b, met_b, resumed = _lm_run(tmp_path, "stop", LM_STEPS, params)
    assert resumed == 3
    la = torch.utils._pytree.tree_leaves(s_b)
    lb = torch.utils._pytree.tree_leaves(s_full)
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    assert _traj(met_a + met_b) == _traj(met_full)

    def jstep(state, batch):
        def loss_fn(p):
            return jlm.next_token_nll(jlm.lm_apply(p, batch["tokens"]),
                                      batch["tokens"])

        loss, g = jax.value_and_grad(loss_fn)(state["params"])
        return ({"params": jax.tree_util.tree_map(
            lambda x, y: x - LM_LR * y, state["params"], g),
            "step": state["step"] + 1}, {"loss": loss})

    src = jel.ShardedBatchSource({"tokens": _lm_tokens()}, batch_size=2,
                                 rank=0, size=1, seed=1)
    _, jmet, _ = jel.run_elastic(
        jstep, {"params": jparams, "step": jnp.int32(0)}, src.batch_at,
        LM_STEPS, manager=JaxManager(str(tmp_path / "jax"),
                                     backend="numpy"),
        snapshot_every=3, world_size=1, rank=0)
    want, got = _traj(jmet), _traj(met_full)
    assert sorted(want) == sorted(got) == list(range(1, LM_STEPS + 1))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-5)
    assert got[LM_STEPS] < got[1]
