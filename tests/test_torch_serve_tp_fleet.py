"""Tensor-parallel replicas in the port's serving fleet and its pools
(``ServeConfig(mesh="dp=1,tp=2")`` behind ``ServeFleet``), against the
JAX package's TP engine.

Each replica is one real worker (``python -m
horovod_tpu_torch.serve.worker --device cpu``), the controller of its
engine, and one follower it starts itself
(``horovod_tpu_torch.serve.tp_replica``), meeting over gloo. The model is
tests/test_torch_serve_tp.py's (2 layers, 4 heads of 4, vocab 64); the
JAX side is one ``mesh="dp=1,tp=2"`` engine on tests/conftest.py's
virtual CPU mesh serving the same prompts, greedy.

* Two tp=2 replicas over the ``process`` transport: the streams equal
  the JAX TP engine's; replica 1 killed by the fault plan mid-decode is
  relaunched with a new follower, and no follower of the dead
  incarnation outlives it (checked by pid); a rolling ``update_params``
  reaches every rank (the streams after it equal the JAX engine's under
  the new weights); a follower killed on its own under an idle
  controller takes its replica down to a relaunch at the controller's
  next keepalive (no replica serves on fewer heads).
* A tp=2 prefill pool feeding a tp=2 decode pool: every request decodes
  on the decode replica over the pages its controller imported, with
  the JAX TP engine's stream; only the decode replica's ranks run the
  decode lane.
* One tp=2 replica over the ``tcp`` transport.
* The ``inproc`` transport refuses TP replicas with its reason.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import pytest

from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import (FleetConfig, ProcessReplica,
                                     ServeConfig, ServeFleet)
from test_torch_serve_tp import _params, _prompt

MESH = "dp=1,tp=2"
CFG = dict(page_size=8, num_pages=40, decode_slots=2, prefill_chunk=4)
NEW_SEED = 23
MAX_NEW = 12
WAVE = [(90 + i, 5 + 2 * i) for i in range(4)]
WAVE2 = [(95 + i, 4 + 3 * i) for i in range(3)]


def _jax_streams(seed, wave):
    """The JAX TP engine's greedy streams of ``wave``."""
    params = jax.tree_util.tree_map(jnp.asarray, _params(seed))
    eng = JServeEngine(params, JServeConfig(mesh=MESH, **CFG))
    reqs = [eng.submit(_prompt(i, lp), MAX_NEW) for i, lp in wave]
    eng.run()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def ref():
    return {"old": _jax_streams(21, WAVE),
            "new": _jax_streams(NEW_SEED, WAVE2)}


def _fleet(fleet, **cfg):
    # One intra-op thread a rank: the four or more rank processes of a
    # fleet share the test machine's cores.
    return ServeFleet(
        tlm.params_from_numpy(_params(), device="cpu"),
        ServeConfig(mesh=MESH, attention="paged", **dict(CFG, **cfg)),
        fleet, device="cpu", worker_env={"OMP_NUM_THREADS": "1"})


def _run(fl, wave, timeout=90):
    reqs = [fl.submit(_prompt(i, lp), MAX_NEW) for i, lp in wave]
    _until(fl, lambda: fl.idle, timeout)
    assert all(r.state == "finished" for r in reqs), [r.state for r in reqs]
    return reqs


def _until(fl, done, timeout):
    t0 = time.monotonic()
    while not done():
        assert time.monotonic() - t0 < timeout, "the fleet did not settle"
        if not fl.step():
            time.sleep(0.002)


def _world(rep):
    """A replica's ``tp`` block from its worker's ping: the backend, the
    devices and the followers' pids."""
    return rep.engine.client.call("ping")["tp"]


def _dead(pid, timeout=10.0):
    """True once ``pid`` is gone or a zombie (killed, not yet reaped by
    whoever adopted it)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rpartition(")")[2].split()[0] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.1)
    return False


def _reaped(fl):
    for rep in fl.replicas:
        assert isinstance(rep, ProcessReplica)
        assert rep.proc.poll() is not None


def test_two_tp_replicas_killed_relaunched_and_rolled(ref):
    fl = _fleet(FleetConfig(replicas=2, transport="process",
                            backoff_base=0.01, rpc_deadline=30.0,
                            spawn_timeout=30.0))
    followers = []
    try:
        assert fl.chips_per_replica == 2 and fl.chips == 4
        reqs = [fl.submit(_prompt(i, lp), MAX_NEW) for i, lp in WAVE]
        _until(fl, lambda: all(r.output for r in reqs)
               and fl.replicas[1].assigned, 90)
        old = _world(fl.replicas[1])
        assert old["degree"] == 2 and old["backend"] == "gloo"
        assert old["devices"] == ["cpu", "cpu"]
        followers += old["followers"]
        fl.arm_fault_plan("kill:replica=1,at=0s")
        _until(fl, lambda: fl.idle, 90)
        assert [r.output for r in reqs] == ref["old"]
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}
        assert f["redispatched"] >= 1 and f["restarts_used"] == 1
        # The dead incarnation's follower went with it; the relaunched
        # controller started one of its own.
        assert all(_dead(pid) for pid in old["followers"])
        new = _world(fl.replicas[1])
        followers += new["followers"]
        assert len(new["followers"]) == 1
        assert set(new["followers"]).isdisjoint(old["followers"])
        fl.update_params(tlm.params_from_numpy(_params(NEW_SEED),
                                               device="cpu"))
        _until(fl, lambda: not fl.update_active, 90)
        assert [r.version for r in fl.replicas] == [2, 2]
        assert [r.output for r in _run(fl, WAVE2)] == ref["new"]
        # No fallback: a follower killed under an idle controller makes
        # the controller's next data-plane action (its keepalive, every
        # quarter of the group's 30 s timeout) raise, so the replica dies
        # and relaunches whole instead of serving on half its heads.
        lost = _world(fl.replicas[0])["followers"]
        followers += lost
        os.kill(lost[0], signal.SIGKILL)
        _until(fl, lambda: fl.stats()["fleet"]["incidents_by_class"]
               == {"crashed": 2} and fl.replicas[0].healthy, 60)
        assert fl.stats()["fleet"]["restarts_used"] == 2
        assert [r.output for r in _run(fl, WAVE2)] == ref["new"]
        followers += _world(fl.replicas[0])["followers"]
    finally:
        fl.close()
    _reaped(fl)
    assert all(_dead(pid) for pid in followers)


def test_tp_prefill_pool_feeds_a_tp_decode_pool(ref):
    fl = _fleet(FleetConfig(replicas=2, transport="process",
                            backoff_base=0.01, rpc_deadline=60.0,
                            pools={"prefill": 1, "decode": 1}))
    try:
        reqs = _run(fl, WAVE)
        assert [r.output for r in reqs] == ref["old"]
        assert all(r.replica == 1 for r in reqs)
        d = fl.stats()["fleet"]["disagg"]
        assert d["transfers"] == len(WAVE) and d["failures"] == {}
        assert d["parked"] == 0 and d["kv_bytes_shipped"] > 0
        counts = [rep.engine.client.call("rank_counters")["ranks"]
                  for rep in fl.replicas]
        pre, dec = counts
        assert [c["rank"] for c in pre + dec] == [0, 1, 0, 1]
        assert all(c["lane_ticks"] == 0 for c in pre)
        assert dec[0]["lane_ticks"] == dec[1]["lane_ticks"] > 0
        assert [c["pid"] for c in dec] == (
            [fl.replicas[1].proc.pid] + _world(fl.replicas[1])["followers"])
    finally:
        fl.close()
    _reaped(fl)


def test_tp_replica_over_tcp(ref):
    fl = _fleet(FleetConfig(replicas=1, transport="tcp",
                            backoff_base=0.01, rpc_deadline=60.0))
    try:
        assert [r.output for r in _run(fl, WAVE)] == ref["old"]
        assert fl.stats()["fleet"]["incidents_by_class"] == {}
    finally:
        fl.close()
    _reaped(fl)


def test_inproc_tp_replicas_are_refused():
    for pools in (None, {"prefill": 1, "decode": 1}):
        with pytest.raises(InvalidArgumentError,
                           match="mesh is its whole torch.distributed "
                                 "world"):
            _fleet(FleetConfig(replicas=2, pools=pools))
