"""The port's serving fleet against ``horovod_tpu.serve.fleet``.

Three lanes, as in tests/test_serve_fleet.py, tests/test_serve_worker.py
and tests/test_serve_fleet_tcp.py:

* **router** — ``replica_load``/``eligible``/``pick_replica``/
  ``retry_after_hint`` call for call against the reference on the same
  fake replicas (prefix keys, versions, draining, saturation);
* **in-process fleet on a fake clock** — the port's fleet and the JAX
  fleet take the same submissions (weights carried with
  ``params_from_numpy``): greedy streams equal each other and
  ``lm_decode``, clean and with a ``kill:`` redispatch (equal incident
  records), equal ``stats()`` keys, ``overloaded``/``infeasible``
  rejections with equal ``retry_after``, allocator conservation, the
  rolling update's single-version streams;
* **process and TCP fleets against tests/serve_stub_worker.py** (the
  reference's protocol stub, ``python -S``): the port's router recovers
  kill → ``crashed``, stall → ``stalled``, partition → ``host_down``,
  a torn reply, a startup crash and torn or corrupted pushes, and
  ``close()`` reaps every worker.

Every wait is bounded and every fleet closes in a ``finally``.
"""

import os
import signal
import sys
import time

import jax
import numpy as np
import pytest

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import FleetConfig as JFleetConfig
from horovod_tpu.serve import Request as JRequest
from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeFleet as JServeFleet
from horovod_tpu.serve import router as jrouter
from horovod_tpu_torch.elastic.faults import FaultPlanError
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import (FleetConfig, ProcessReplica, Request,
                                     ServeConfig, ServeFleet, TcpReplica)
from horovod_tpu_torch.serve import router as trouter
from tests.serve_stub_worker import expected_stream, params_salt

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 2, 8, 32
HERE = os.path.dirname(os.path.abspath(__file__))
STUB = os.path.join(HERE, "serve_stub_worker.py")
#: The stub decodes with the digest of whatever the fleet pushed: a
#: stream matching this salt proves the artifact crossed the wire.
STUB_PARAMS = {"pos": np.zeros((64, 4), np.float32)}
SALT = params_salt(STUB_PARAMS)
NEW_PARAMS = {"pos": np.ones((64, 4), np.float32) * 3.0}
NEW_SALT = params_salt(NEW_PARAMS)


def _map(fn, x):
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_map(fn, v) for v in x]
    return fn(x)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS, H,
                              DH, FFN)


@pytest.fixture(scope="module")
def tparams(jparams):
    # _map keeps the reference's key order, so both fleets ship one
    # artifact (equal sha256).
    return tlm.params_from_numpy(_map(np.asarray, jparams), device="cpu")


def _prompt(i, lp):
    return np.random.default_rng(300 + i).integers(0, V, lp).astype(
        np.int32)


def _ref(params, prompt, steps):
    return tlm.lm_decode(params, np.asarray(prompt)[None], steps,
                         device="cpu")[0].tolist()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


CFG = dict(page_size=8, num_pages=32, decode_slots=2, prefill_chunk=4)


def _fleets(jparams, tparams, cfg=None, **fleet_kw):
    """The JAX fleet and the port's, each on its own fake clock."""
    fleet_kw.setdefault("replicas", 2)
    fleet_kw.setdefault("backoff_base", 0.01)
    out = []
    for Fleet, Cfg, FCfg, params, kw in (
            (JServeFleet, JServeConfig, JFleetConfig, jparams, {}),
            (ServeFleet, ServeConfig, FleetConfig, tparams,
             {"device": "cpu"})):
        clk = FakeClock()
        out.append((Fleet(params, Cfg(**(cfg or CFG)), FCfg(**fleet_kw),
                          clock=clk, sleep=clk.sleep, **kw), clk))
    return out


def _drive(fl, clk, guard=5000):
    n = 0
    while not fl.idle or fl.update_active:
        if not fl.step():
            clk.sleep(0.02)
        clk.t += 0.001
        n += 1
        assert n < guard, "fleet failed to drain"


def _keys(x):
    """A stats block's key structure (values dropped)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_keys(x[0])]
    return None


# ------------------------------------------------------------- router


class _Cache:
    def __init__(self, occ, cap):
        self._occ, self._cap = occ, cap

    def occupancy(self):
        return self._occ

    def fits(self, lp, mn):
        return lp + mn <= self._cap


class _Engine:
    def __init__(self, Cfg, free, occ, cap, max_queue, queued):
        self._free = free
        self.cache = _Cache(occ, cap)
        self.config = Cfg(decode_slots=2, page_size=8, num_pages=32,
                          max_queue=max_queue)
        self.scheduler = type("S", (), {"queue": [None] * queued})()

    def _free_slots(self):
        return self._free


class _Rep:
    def __init__(self, Cfg, rid, st):
        self.id = rid
        self.state = st["state"]
        self.engine = None if st["no_engine"] else _Engine(
            Cfg, st["free"], st["occ"], st["cap"], st["max_queue"],
            st["queued"])
        self.assigned = [object()] * st["assigned"]
        self.version = st["version"]
        self.accepting = st["accepting"]

    @property
    def healthy(self):
        return self.state == "healthy"


def _random_states(rng, n):
    return [{
        "state": rng.choice(["healthy"] * 4 + ["dead", "failed"]),
        "no_engine": bool(rng.random() < 0.1),
        "free": int(rng.integers(0, 3)),
        "occ": float(rng.choice([0.0, 0.25, 0.5, 0.9])),
        "cap": int(rng.choice([16, 64])),
        "max_queue": int(rng.choice([0, 0, 1])),
        "queued": int(rng.integers(0, 2)),
        "assigned": int(rng.integers(0, 4)),
        "version": rng.choice([1, 1, 2, None]),
        "accepting": bool(rng.random() < 0.85),
    } for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_router_call_for_call(seed):
    rng = np.random.default_rng(seed)
    for trial in range(40):
        states = _random_states(rng, int(rng.integers(1, 5)))
        jreps = [_Rep(JServeConfig, i, s) for i, s in enumerate(states)]
        treps = [_Rep(ServeConfig, i, s) for i, s in enumerate(states)]
        lp, mn = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        version = rng.choice([None, 1, 2])
        jreq = JRequest(prompt=np.arange(lp, dtype=np.int32),
                        max_new_tokens=mn)
        treq = Request(prompt=np.arange(lp, dtype=np.int32),
                       max_new_tokens=mn)
        jreq.version = treq.version = version
        key = rng.choice([None, "k%d" % trial, "shared"])
        for jr, tr in zip(jreps, treps):
            assert trouter.eligible(tr, treq) == \
                jrouter.eligible(jr, jreq)
            assert trouter.replica_load(tr) == jrouter.replica_load(jr)
        jp = jrouter.pick_replica(jreps, jreq, key)
        tp = trouter.pick_replica(treps, treq, key)
        assert (tp and tp.id) == (jp and jp.id), (trial, states)


@pytest.mark.parametrize("args", [
    (5, 4, [], 0.05), (3, 2, [1.0, 3.0], 0.05), (0, 0, [1.0], 0.25),
    (10, 3, [0.1, 0.2, 0.7], 0.05), (1, 8, [0.001], 0.5)])
def test_retry_after_hint_matches(args):
    assert trouter.retry_after_hint(*args) == \
        jrouter.retry_after_hint(*args)


# --------------------------------------------- in-process fleet parity


SPEC = [(5, 8), (9, 6), (3, 10), (7, 7), (4, 9), (6, 5)]


def _submit_all(fl, spec=SPEC, base=10):
    return [fl.submit(_prompt(base + i, lp), n, seed=17 + i)
            for i, (lp, n) in enumerate(spec)]


def test_clean_streams_equal_the_reference_fleet(jparams, tparams):
    (jf, jc), (tf, tc) = _fleets(jparams, tparams)
    try:
        assert tf._artifact["sha256"] == jf._artifact["sha256"]
        jr, tr = _submit_all(jf), _submit_all(tf)
        _drive(jf, jc)
        _drive(tf, tc)
        for i, ((lp, n), a, b) in enumerate(zip(SPEC, jr, tr)):
            assert b.state == a.state == "finished"
            assert b.output == a.output == _ref(tparams,
                                                _prompt(10 + i, lp), n)
            assert b.replica == a.replica
        js, ts = jf.stats(), tf.stats()
        assert _keys(ts) == _keys(js)
        assert ts["by_state"] == js["by_state"] == {"finished": 6}
        f = ts["fleet"]
        assert f["replicas"] == 2 and f["healthy"] == 2
        assert f["incidents"] == [] and f["redispatched"] == 0
        assert all(c["steps"] > 0 for c in f["per_replica"])
        assert [c["steps"] for c in f["per_replica"]] == \
            [c["steps"] for c in js["fleet"]["per_replica"]]
        # both in-process replicas share the fleet's one weight copy
        a, b = (rep.engine.params["embed"] for rep in tf.replicas)
        assert a.data_ptr() == b.data_ptr() == \
            tf.params["embed"].data_ptr()
        assert [s["replica"] for s in tf.first_steps] == [0, 1]
    finally:
        jf.close()
        tf.close()


def test_kill_redispatch_equals_the_reference_fleet(jparams, tparams):
    runs = {}
    for faulted in (False, True):
        (jf, jc), (tf, tc) = _fleets(jparams, tparams, max_restarts=2)
        try:
            jr, tr = _submit_all(jf), _submit_all(tf)
            if faulted:
                for _ in range(6):
                    for fl, clk in ((jf, jc), (tf, tc)):
                        fl.step()
                        clk.t += 0.001
                victims = list(tf.replicas[1].assigned)
                assert any(len(r.generated) > 0 for r in victims), \
                    "kill must catch a request mid-DECODE"
                jf.arm_fault_plan("kill:replica=1,at=0s")
                tf.arm_fault_plan("kill:replica=1,at=0s")
            _drive(jf, jc)
            _drive(tf, tc)
            runs[faulted] = (jr, tr, jf.stats(), tf.stats())
        finally:
            jf.close()
            tf.close()
    cj, ct, _, _ = runs[False]
    fj, ft, js, ts = runs[True]
    for i, (a, b, c, d) in enumerate(zip(cj, ct, fj, ft)):
        assert d.state == "finished"
        assert d.output == b.output == c.output == a.output, i
        assert d.redispatches == c.redispatches
        if d.redispatches:
            assert d.pages == []
    f, g = ts["fleet"], js["fleet"]
    assert f["incidents_by_class"] == {"crashed": 1}
    assert f["incidents"] == g["incidents"]
    assert f["incidents"][0]["code"] == -signal.SIGKILL
    assert f["redispatched"] == g["redispatched"] >= 1
    assert f["tokens_recomputed"] == g["tokens_recomputed"] > 0
    assert f["restarts_used"] == 1
    assert _keys(ts) == _keys(js)


def test_shedding_equals_the_reference_fleet(jparams, tparams):
    (jf, jc), (tf, tc) = _fleets(
        jparams, tparams, cfg=dict(CFG, decode_slots=1), replicas=1,
        max_queue=2, max_restarts=0)
    try:
        out = []
        for fl, clk in ((jf, jc), (tf, tc)):
            warm = fl.submit(_prompt(0, 5), 3)      # a service sample
            _drive(fl, clk)
            assert warm.state == "finished"
            rs = [fl.submit(_prompt(0, 5), 4) for _ in range(8)]
            big = fl.submit(_prompt(1, LMAX), 10)
            out.append([(r.state, r.reject_reason, r.retry_after)
                        for r in rs + [big]])
            for rep in fl.replicas:
                assert rep.engine.cache.allocator.in_use == 0
        assert out[0] == out[1]
        states = out[1]
        assert [s for s, _, _ in states[:8]] == \
            ["queued"] * 2 + ["rejected"] * 6
        assert all(r == "overloaded" and h > 0
                   for _, r, h in states[2:8])
        assert states[8] == ("rejected", "infeasible", None)
        f, g = tf.stats()["fleet"], jf.stats()["fleet"]
        assert f["shed"] == g["shed"] == 6
        assert f["rejected_by_reason"] == g["rejected_by_reason"] == \
            {"overloaded": 6, "infeasible": 1}
    finally:
        jf.close()
        tf.close()


def test_budget_exhaustion_sheds_alike(jparams, tparams):
    (jf, jc), (tf, tc) = _fleets(jparams, tparams, replicas=1,
                                 max_restarts=0)
    try:
        out = []
        for fl, clk in ((jf, jc), (tf, tc)):
            rs = [fl.submit(_prompt(i, 5), 3) for i in range(3)]
            fl.step()
            clk.t += 0.001
            fl.arm_fault_plan("kill:replica=0,at=0s")
            fl.step()
            clk.t += 1.0
            fl.step()
            assert fl.replicas[0].state == "failed" and not fl.alive
            late = fl.submit(_prompt(9, 5), 3)
            out.append([(r.state, r.reject_reason, r.retry_after,
                         r.output) for r in rs + [late]])
            assert fl.idle
        assert out[0] == out[1]
        assert out[1][-1][:3] == ("rejected", "overloaded", None)
    finally:
        jf.close()
        tf.close()


@pytest.fixture(scope="module")
def params2():
    return tlm.init_lm_params(7, V, LMAX, LAYERS, H, DH, FFN,
                              device="cpu")


def _fleet(tparams, clk, cfg=None, **fleet_kw):
    fleet_kw.setdefault("replicas", 2)
    fleet_kw.setdefault("backoff_base", 0.01)
    return ServeFleet(tparams, ServeConfig(**(cfg or CFG)),
                      FleetConfig(**fleet_kw), clock=clk, sleep=clk.sleep,
                      device="cpu")


def test_rolling_update_streams_stay_single_version(tparams, params2):
    clk = FakeClock()
    fl = _fleet(tparams, clk)
    try:
        p0, p1 = _prompt(20, 6), _prompt(21, 6)
        r0 = fl.submit(p0, 8)
        for _ in range(3):
            fl.step()
        assert r0.version == 1 and r0.output
        assert fl.update_params(params2) == 2
        with pytest.raises(RuntimeError, match="in progress"):
            fl.update_params(params2)
        r1 = fl.submit(p1, 8)
        _drive(fl, clk)
        assert r0.output == _ref(tparams, p0, 8)
        assert r1.output in (_ref(tparams, p1, 8), _ref(params2, p1, 8))
        f = fl.stats()["fleet"]
        assert f["params_version"] == 2 and not f["update_active"]
        assert all(r["version"] == 2 for r in f["per_replica"])
        assert len({r["params_sha"] for r in f["per_replica"]}) == 1
        assert f["incidents_by_class"] == {}
        # every replica swapped onto ONE shared copy of the new weights
        ptrs = {rep.engine.params["embed"].data_ptr()
                for rep in fl.replicas}
        assert ptrs == {fl.params["embed"].data_ptr()}
        r2 = fl.submit(_prompt(22, 6), 8)
        _drive(fl, clk)
        assert r2.output == _ref(params2, _prompt(22, 6), 8)
    finally:
        fl.close()


def test_stranded_version_restarts_from_scratch(tparams, params2):
    clk = FakeClock()
    fl = _fleet(tparams, clk, replicas=1, max_restarts=2)
    try:
        p = _prompt(24, 6)
        r = fl.submit(p, 10)
        for _ in range(4):
            fl.step()
        assert r.version == 1 and r.output
        fl.update_params(params2)
        fl.arm_fault_plan("kill:replica=0,at=0s")
        _drive(fl, clk)
        assert r.state == "finished" and r.version_restarts == 1
        assert r.version == 2 and fl.version_recomputed == 1
        assert r.output == _ref(params2, p, 10)
    finally:
        fl.close()


def test_wrong_geometry_update_raises_before_any_mutation(tparams):
    clk = FakeClock()
    fl = _fleet(tparams, clk)
    try:
        bad = tlm.init_lm_params(5, V, LMAX // 2, LAYERS, H, DH, FFN,
                                 device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            fl.update_params(bad)
        renamed = dict(tparams)
        renamed["embedding"] = renamed.pop("embed")
        with pytest.raises(ValueError, match="geometry"):
            fl.update_params(renamed)
        assert not fl.update_active and fl.params_version == 1
        with pytest.raises(FaultPlanError, match="params-push"):
            fl.arm_fault_plan("transfer:replica=0,at=1s")
        with pytest.raises(FaultPlanError, match="outside this fleet"):
            fl.arm_fault_plan("kill:replica=7,at=1s")
        with pytest.raises(FaultPlanError, match="tcp transport"):
            fl.arm_fault_plan("kill:host=0,at=1s")
    finally:
        fl.close()


def test_engine_exception_is_a_classified_crash(tparams):
    clk = FakeClock()
    fl = _fleet(tparams, clk, max_restarts=2)
    try:
        reqs = _submit_all(fl, SPEC[:4])
        for _ in range(4):
            fl.step()
            clk.t += 0.001
        assert fl.replicas[1].assigned

        def boom():
            raise RuntimeError("device OOM")

        fl.replicas[1].engine.step = boom
        fl.step()
        assert fl.replicas[1].state == "dead"
        _drive(fl, clk)
        for i, ((lp, n), r) in enumerate(zip(SPEC, reqs)):
            assert r.output == _ref(tparams, _prompt(10 + i, lp), n)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}
        assert f["incidents"][0]["code"] == 1
    finally:
        fl.close()


@pytest.mark.parametrize("cfg", [dict(CFG, attention="paged"),
                                 dict(CFG, speculate_k=2, draft_layers=1),
                                 dict(CFG, prefix_caching=True)],
                         ids=["paged", "spec", "prefix"])
def test_kill_redispatch_exact_across_engine_modes(tparams, cfg):
    clk = FakeClock()
    fl = _fleet(tparams, clk, cfg=cfg, max_restarts=2)
    try:
        reqs = _submit_all(fl, SPEC[:4])
        for _ in range(4):
            fl.step()
            clk.t += 0.001
        assert fl.replicas[1].assigned
        fl.arm_fault_plan("kill:replica=1,at=0s")
        _drive(fl, clk)
        for i, ((lp, n), r) in enumerate(zip(SPEC, reqs)):
            assert r.state == "finished"
            assert r.output == _ref(tparams, _prompt(10 + i, lp), n), i
        f = fl.stats()["fleet"]
        assert f["redispatched"] >= 1
        assert (f["prefix"] is not None) == cfg.get("prefix_caching",
                                                    False)
    finally:
        fl.close()


def test_stall_and_slow_faults(tparams):
    clk = FakeClock()
    fl = _fleet(tparams, clk)
    try:
        reqs = [fl.submit(_prompt(i, 5), 4) for i in range(4)]
        for _ in range(3):
            fl.step()
            clk.t += 0.001
        fl.arm_fault_plan("stall:replica=0,at=0s,secs=0.05; "
                          "slow:replica=1,at=0s,factor=2")
        _drive(fl, clk)
        assert all(r.state == "finished" for r in reqs)
        assert fl.replicas[1].slow_factor == 2.0
        f = fl.stats()["fleet"]
        assert f["incidents"] == [] and f["restarts_used"] == 0
    finally:
        fl.close()


def test_stall_watchdog_classified_relaunch(tparams):
    """On the wall clock: the stalled replica's heartbeat goes stale, the
    watchdog kills it as ``stalled``, and every stream stays exact."""
    fl = ServeFleet(tparams, ServeConfig(**CFG), FleetConfig(
        replicas=2, max_restarts=2, backoff_base=0.01,
        watchdog_timeout=0.4), device="cpu")
    try:
        reqs = _submit_all(fl, SPEC[:4])
        for _ in range(5):
            fl.step()
        assert fl.replicas[0].assigned
        fl.arm_fault_plan("stall:replica=0,at=0s")
        t0 = time.monotonic()
        while not fl.idle and time.monotonic() - t0 < 30:
            fl.run(max_steps=fl.steps + 200)
        for i, ((lp, n), r) in enumerate(zip(SPEC, reqs)):
            assert r.output == _ref(tparams, _prompt(10 + i, lp), n)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"stalled": 1}
        assert f["detect_s"] >= 0.4 and f["restarts_used"] == 1
    finally:
        fl.close()
    assert not os.path.exists(fl.heartbeat_dir)


# ------------------------------------- process / tcp fleets on the stub


def _stub_cmd(tcp=False, extra_env=None, extra_args=(), per_rid_env=None):
    """worker_cmd hook launching the reference's protocol stub with
    ``python -S``; ``per_rid_env`` applies to a replica's FIRST
    incarnation only (fault hooks must not re-fire on the relaunch)."""
    seen = {}

    def cmd(rid, endpoint, default):
        dcmd, denv = default
        argv = [sys.executable, "-S", STUB,
                "--bind" if tcp else "--socket", endpoint,
                "--rank", str(rid), "--slots", "2"] + list(extra_args)
        if not tcp:
            argv += ["--heartbeat-dir",
                     dcmd[dcmd.index("--heartbeat-dir") + 1]]
        env = dict(denv)
        env.update(extra_env or {})
        if seen.setdefault(rid, 0) == 0:
            env.update((per_rid_env or {}).get(rid, {}))
        seen[rid] += 1
        return argv, env

    return cmd


def _stub_fleet(tcp=False, worker_cmd=None, **fleet_kw):
    fleet_kw.setdefault("replicas", 2)
    fleet_kw.setdefault("transport", "tcp" if tcp else "process")
    fleet_kw.setdefault("backoff_base", 0.01)
    fleet_kw.setdefault("rpc_deadline", 10.0)
    fleet_kw.setdefault("max_restarts", 4)
    return ServeFleet(STUB_PARAMS, ServeConfig(**CFG),
                      FleetConfig(**fleet_kw),
                      worker_cmd=worker_cmd or _stub_cmd(tcp),
                      device="cpu")


def _prompts(n, base=3):
    return [list(range(base + i, base + i + 4 + i % 3)) for i in range(n)]


def _run_until(fl, reqs, timeout=30.0):
    t0 = time.monotonic()
    while not fl.idle and time.monotonic() - t0 < timeout:
        fl.run(max_steps=fl.steps + 50)
        if not fl.idle:
            time.sleep(0.01)
    assert fl.idle, [r.state for r in reqs]


def _assert_reaped(fl):
    for rep in fl.replicas:
        assert isinstance(rep, ProcessReplica)
        assert rep.proc.poll() is not None, (
            f"replica {rep.id} pid {rep.proc.pid} not reaped (zombie)")


@pytest.mark.parametrize("tcp", [False, True], ids=["process", "tcp"])
def test_stub_clean_run_over_the_wire(tcp):
    fl = _stub_fleet(tcp)
    try:
        prompts = _prompts(5)
        reqs = [fl.submit(np.asarray(p, np.int32), 4 + i % 3)
                for i, p in enumerate(prompts)]
        _run_until(fl, reqs)
        for p, r in zip(prompts, reqs):
            assert r.state == "finished"
            assert r.output == expected_stream(p, r.orig_max_new, SALT)
        f = fl.stats()["fleet"]
        assert f["transport"] == ("tcp" if tcp else "process")
        assert f["rpc_ms"]["calls"] > 0 and f["rpc_ms"]["p50"] is not None
        assert f["transport_incidents"] == {}
        assert f["params_push"]["pushes"] == 2
        pong = fl.replicas[0].engine.client.call("ping")
        assert pong["params_sha256"] == fl._artifact["sha256"]
        if tcp:
            assert all(isinstance(r, TcpReplica) for r in fl.replicas)
            assert fl._workdir is None
    finally:
        fl.close()
    _assert_reaped(fl)
    fl.close()


@pytest.mark.parametrize("tcp", [False, True], ids=["process", "tcp"])
def test_stub_sigkill_is_crashed_and_redispatched_exact(tcp):
    fl = _stub_fleet(tcp, worker_cmd=_stub_cmd(
        tcp, extra_args=["--tick-s", "0.02"]))
    try:
        prompts = _prompts(6)
        reqs = [fl.submit(np.asarray(p, np.int32), 8) for p in prompts]
        for _ in range(4):
            fl.step()
        fl.arm_fault_plan("kill:replica=1,at=0s")
        _run_until(fl, reqs)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}
        assert f["incidents"][0]["code"] == -signal.SIGKILL
        assert f["redispatched"] >= 1
        for p, r in zip(prompts, reqs):
            assert r.state == "finished"
            assert r.output == expected_stream(p, 8, SALT)
    finally:
        fl.close()
    _assert_reaped(fl)


def test_stub_stall_caught_by_the_heartbeat_watchdog():
    fl = _stub_fleet(watchdog_timeout=0.6, worker_cmd=_stub_cmd(
        extra_args=["--tick-s", "0.01"]))
    try:
        prompts = _prompts(6)
        reqs = [fl.submit(np.asarray(p, np.int32), 12) for p in prompts]
        for _ in range(3):
            fl.step()
        fl.arm_fault_plan("stall:replica=0,at=0s")
        _run_until(fl, reqs)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"stalled": 1}, f
        assert f["detect_s"] >= 0.6
        for p, r in zip(prompts, reqs):
            assert r.output == expected_stream(p, 12, SALT)
    finally:
        fl.close()
    _assert_reaped(fl)


def test_stub_tcp_stall_caught_by_transport_liveness():
    fl = _stub_fleet(True, watchdog_timeout=0.6, worker_cmd=_stub_cmd(
        True, extra_args=["--tick-s", "0.01"]))
    try:
        prompts = _prompts(6)
        reqs = [fl.submit(np.asarray(p, np.int32), 12) for p in prompts]
        for _ in range(3):
            fl.step()
        fl.arm_fault_plan("stall:replica=0,at=0s")
        _run_until(fl, reqs)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"stalled": 1}, f
        assert f["host_incidents"] == 0
        for p, r in zip(prompts, reqs):
            assert r.output == expected_stream(p, 12, SALT)
    finally:
        fl.close()
    _assert_reaped(fl)


@pytest.mark.parametrize("plan, cause", [
    ("partition:host=0,at=0s,secs=0.5", "transport"),
    ("kill:host=0,at=0s", "kill")], ids=["partition", "kill_host"])
def test_stub_tcp_host_down_is_one_incident(plan, cause):
    fl = _stub_fleet(True, worker_cmd=_stub_cmd(
        True, extra_args=["--tick-s", "0.02"]))
    try:
        prompts = _prompts(6)
        reqs = [fl.submit(np.asarray(p, np.int32), 8) for p in prompts]
        for _ in range(4):
            fl.step()
        fl.arm_fault_plan(plan)
        _run_until(fl, reqs)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"host_down": 1}, f
        inc = [i for i in fl.incidents if i["category"] == "host_down"][0]
        assert inc["cause"] == cause and len(inc["replicas"]) == 2
        for p, r in zip(prompts, reqs):
            assert r.state == "finished"
            assert r.output == expected_stream(p, 8, SALT)
        assert any(r.redispatches for r in reqs)
    finally:
        fl.close()
    _assert_reaped(fl)


def test_stub_torn_reply_and_startup_crash():
    fl = _stub_fleet(worker_cmd=_stub_cmd(
        extra_args=["--tick-s", "0.01"],
        per_rid_env={1: {"HVD_SERVE_WORKER_TORN_COLLECT_AFTER": "3"}}))
    try:
        prompts = _prompts(6)
        reqs = [fl.submit(np.asarray(p, np.int32), 8) for p in prompts]
        _run_until(fl, reqs)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}, f
        assert f["transport_incidents"] == {"FrameError": 1}
        for p, r in zip(prompts, reqs):
            assert r.output == expected_stream(p, 8, SALT)
    finally:
        fl.close()
    _assert_reaped(fl)
    fl = _stub_fleet(max_restarts=1, replicas=1, worker_cmd=_stub_cmd(
        per_rid_env={0: {"HVD_SERVE_WORKER_FAIL_START": "3"}}))
    try:
        r = fl.submit(np.asarray([1, 2, 3], np.int32), 4)
        _run_until(fl, [r])
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}, f
        assert f["incidents"][0]["code"] == 3
        assert r.output == expected_stream([1, 2, 3], 4, SALT)
    finally:
        fl.close()
    _assert_reaped(fl)


@pytest.mark.parametrize("fault", ["transfer", "corrupt"])
def test_stub_rolling_update_survives_push_faults(fault):
    fl = _stub_fleet(push_chunk_bytes=64)
    try:
        fl.step()
        assert all(rep.version == 1 for rep in fl.replicas)
        r0 = fl.submit(np.asarray([5, 6, 7], np.int32), 30)
        for _ in range(3):
            fl.step()
        fl.arm_fault_plan(f"{fault}:replica=0,at=0s")
        fl.step()
        fl.update_params(NEW_PARAMS)
        t0 = time.monotonic()
        while (fl.update_active or not fl.idle) and \
                time.monotonic() - t0 < 30:
            if not fl.step():
                time.sleep(0.005)
        assert not fl.update_active
        f = fl.stats()["fleet"]
        assert f["params_push"]["retries"] >= 1, f["params_push"]
        assert sum(f["transfer_incidents"].values()) >= 1
        assert f["incidents_by_class"] == {}
        assert all(rep.version == 2 for rep in fl.replicas)
        assert r0.output == expected_stream([5, 6, 7], 30, SALT)
        r1 = fl.submit(np.asarray([1, 2, 3], np.int32), 4)
        _run_until(fl, [r1])
        assert r1.output == expected_stream([1, 2, 3], 4, NEW_SALT)
    finally:
        fl.close()
    _assert_reaped(fl)


def test_stub_close_reaps_a_wedged_worker():
    fl = _stub_fleet(replicas=1, shutdown_deadline=0.5)
    try:
        r = fl.submit(np.asarray([1, 2, 3], np.int32), 400)
        for _ in range(3):
            fl.step()
        fl.replicas[0].engine.client.call("fault", {"kind": "stall"})
        time.sleep(0.05)
    finally:
        t0 = time.monotonic()
        fl.close()
        assert time.monotonic() - t0 < 15
    _assert_reaped(fl)
    assert r.state != "finished"
