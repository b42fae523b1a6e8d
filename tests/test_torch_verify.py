"""The port's collective-schedule verifier (``horovod_tpu_torch.verify``)
on the CPU.

The simulated worlds (torch's ``fake`` process-group backend, one
process group a simulated rank) run in processes of their own, so that
none meets this worker's groups: ``tests/torch_verify_cases.py`` verifies
a case that breaks each ported rule and one that keeps it, and
``python -m horovod_tpu_torch.verify --sweep`` runs the registry. Here:

* each rule fires on its breaking case and stays silent on the other;
  a suppressed finding is reported and does not fail, and the CLI exits
  0 / 1 / 2 as ``tools/hvdverify`` does;
* the registry's names are the JAX registry's where the port has the
  counterpart, with all six groups, and the sweep is clean;
* the cross-package pin: ``optimizer.fused``'s recorded count and bytes
  equal ``tools.hvdverify.audit_collectives`` of the JAX
  ``DistributedOptimizer`` step over the same parameter shapes, threshold
  and world;
* ``audit_collectives`` in this process's gloo world of one (and when
  the recorder fails), and the
  private import path of the fake backend's store, pinned.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from horovod_tpu_torch.verify import registry
from horovod_tpu_torch.verify.rules import RULES

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=240):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cases():
    proc = _run(str(REPO / "tests" / "torch_verify_cases.py"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rule,case", [
    ("HVV101", "hvv101"), ("HVV102", "hvv102"), ("HVV103", "hvv103"),
    ("HVV103", "hvv103_splits"), ("HVV105", "hvv105"),
    ("HVV105", "hvv105_ladder"), ("HVV201", "hvv201"),
    ("HVV202", "hvv202"), ("HVV203", "hvv203")])
def test_each_rule_fires_on_its_case(cases, rule, case):
    got = cases[case + ("_fire" if case.endswith("splits") else "_fires")]
    assert got["active"] and set(got["active"]) == {rule}, got["messages"]


@pytest.mark.parametrize("case", ["hvv101", "hvv102", "hvv103",
                                  "hvv103_splits", "hvv105", "hvv201",
                                  "hvv202", "hvv203"])
def test_each_rule_is_silent_on_a_clean_program(cases, case):
    got = cases[case + "_silent"]
    assert got["active"] == [] and got["suppressed"] == [], got["messages"]


def test_findings_name_the_fault(cases):
    msg = cases["hvv101_fires"]["messages"][0]
    assert "not by rank(s) [1]" in msg and "torch_verify_cases.py" in msg
    assert "ranks 0,1" in cases["hvv102_fires"]["messages"][0]
    assert "float32[8]" in cases["hvv103_fires"]["messages"][0]
    ladder = cases["hvv105_ladder_fires"]["messages"]
    assert len(ladder) == 3 and all("ladder did not engage" in m
                                    for m in ladder)
    bypass = cases["hvv105_fires"]["messages"]
    assert sum("OUTSIDE the fused exchange" in m for m in bypass) == 8
    assert sum("NO matching collective" in m for m in bypass) == 3
    assert "'hvd'" in cases["hvv202_fires"]["messages"][0]


def test_suppressions_are_reported_and_do_not_fail(cases):
    got = cases["suppressed"]
    assert got["active"] == [] and got["suppressed"] == ["HVV101"]
    assert "a case that skips on purpose" in got["messages"][0]
    assert cases["cli_suppressed_rc"] == 0
    assert cases["cli_failing_rc"] == 1


def test_the_rule_catalogue_has_no_donation_rule():
    assert sorted(RULES) == ["HVV101", "HVV102", "HVV103", "HVV105",
                             "HVV201", "HVV202", "HVV203"]


def test_registry_names_and_groups():
    names = [p.name for p in registry.REGISTRY]
    assert names == [
        "optimizer.fused", "optimizer.overlap", "optimizer.scatter",
        "dp.hier_overlap", "dp.hier_int8", "parallel.spmd", "parallel.tp",
        "parallel.pipeline", "parallel.ulysses", "parallel.ring_attention",
        "parallel.moe", "composed.dp_tp", "composed.dp_ulysses",
        "composed.tp_pp", "elastic.windowed_loop", "serve.step_tp",
        "serve.step_decode_pool_tp"]
    assert registry.FAST_GROUPS == ("optimizer", "dp", "parallel",
                                    "composed", "elastic", "serve")
    assert {p.group for p in registry.REGISTRY} == set(registry.FAST_GROUPS)
    assert registry.WORLD == 8
    for p in registry.REGISTRY:
        assert p.world == (4 if p.name.startswith("serve.") or p.name in (
            "parallel.tp", "parallel.pipeline", "parallel.ulysses",
            "parallel.ring_attention", "parallel.moe") else 8), p.name
        assert (p.reconcile is not None) == (p.group in ("optimizer",
                                                          "dp")), p.name
        composed = p.group == "composed"
        assert (p.shardings is not None, p.logical_mesh is not None,
                p.equivalence is not None) == (composed,) * 3, p.name
    # The JAX registry's names where the port has the counterpart.
    from tools.hvdverify.registry import REGISTRY as JAX_REGISTRY

    assert set(names) <= {p.name for p in JAX_REGISTRY}
    with pytest.raises(KeyError, match="nope"):
        registry.programs(names=["nope"])
    assert [p.name for p in registry.programs(groups=["serve"])] == \
        names[-2:]


def test_sweep_is_clean():
    proc = _run("-m", "horovod_tpu_torch.verify", "--sweep")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == \
        "verify: 17 program(s), 0 finding(s), 0 suppressed"


@pytest.mark.parametrize("args,rc,text", [
    (["--list"], 0, "serve.step_decode_pool_tp"),
    (["--list-rules"], 0, "HVV203"),
    ([], 2, "nothing to do"),
    (["--program", "nope"], 2, "nope"),
    (["--program", "parallel.tp", "--schedule"], 0,
     "1 program(s), 0 finding(s)"),
])
def test_cli_exit_codes(args, rc, text):
    proc = _run("-m", "horovod_tpu_torch.verify", *args)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert text in proc.stdout + proc.stderr


def test_optimizer_fused_equals_the_jax_audit(cases):
    """The same parameter shapes (the port's MNIST model, in its order),
    the same fusion threshold and an 8-rank world: the port's recorded
    buckets and the JAX step's traced psums agree in count and bytes."""
    import horovod_tpu.jax as jhvd
    from horovod_tpu.jax.optimizer import DistributedOptimizer
    from tools.hvdverify import audit_collectives

    port = cases["optimizer.fused"]
    assert port["active"] == [] and set(port["axes"]) == {"hvd"}
    jhvd.init()
    leaves = [jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
              for p in registry.mnist_param_leaves()]
    opt = DistributedOptimizer(optax.sgd(0.1),
                               fusion_threshold=registry.OPT_THRESHOLD,
                               overlap="off")

    def step(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    run = jhvd.spmd_fn(step, in_specs=(JP(), JP()), out_specs=JP())
    assert len(jax.devices()) == registry.WORLD
    want = audit_collectives(run, leaves, leaves)
    got = port["summary"]
    assert (got["count"], got["bytes"]) == (want["count"], want["bytes"])
    assert got["count"] == 3 and got["bytes"] == 87360


def test_audit_collectives_in_a_world_of_one():
    import horovod_tpu_torch.distributed as hvd
    from horovod_tpu_torch.distributed.fusion import (fused_reduce,
                                                      plan_buckets)
    from horovod_tpu_torch.verify import audit_collectives, summarize

    hvd.init(device="cpu")
    try:
        ts = [torch.ones(1000), torch.ones(3, 50), torch.ones(7)]
        plan = plan_buckets(ts, 4096)
        out, sched = audit_collectives(fused_reduce, ts, True,
                                       hvd.Compression.none, None, 4096)
        assert [tuple(o.shape) for o in out] == [(1000,), (3, 50), (7,)]
        assert summarize(sched) == {
            "count": len(plan), "bytes": sum(b.nbytes for b in plan),
            "mb": round(sum(b.nbytes for b in plan) / 2 ** 20, 2),
            "by_kind": {"allreduce": len(plan)}}
        # A per-tensor allreduce at size one issues nothing.
        assert audit_collectives(hvd.allreduce, ts[0])[1] == []
    finally:
        hvd.shutdown()


def test_audit_collectives_raises_or_logs_when_the_recorder_fails(
        monkeypatch):
    """A failure of the recorder's bookkeeping never stops the step: the
    audit raises after it, or, given a ``log``, logs the reason and
    returns no schedule (the bench then stamps null)."""
    import horovod_tpu_torch.distributed as hvd
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.verify import audit_collectives, schedule

    def broken(rank):
        raise LookupError("no group names")

    hvd.init(device="cpu")
    try:
        monkeypatch.setattr(schedule, "group_names", broken)
        args = ([torch.ones(4)], True, hvd.Compression.none, None, 4096)
        with pytest.raises(RuntimeError, match="no group names"):
            audit_collectives(fused_reduce, *args)
        said = []
        out, sched = audit_collectives(fused_reduce, *args,
                                       log=said.append)
        assert sched is None and torch.equal(out[0], torch.ones(4))
        assert said == ["the collective recorder failed: LookupError: "
                        "no group names"]
    finally:
        hvd.shutdown()


def test_the_fake_backend_store_is_wrapped_in_one_place():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from horovod_tpu_torch.verify.schedule import fake_store

    assert isinstance(fake_store(), FakeStore)
    wrapped = [f for f in (REPO / "horovod_tpu_torch").rglob("*.py")
               if "fake_pg" in f.read_text()]
    assert wrapped == [REPO / "horovod_tpu_torch" / "verify" /
                       "schedule.py"]
