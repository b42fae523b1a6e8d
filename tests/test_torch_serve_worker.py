"""The port's replica worker (``python -m horovod_tpu_torch.serve.worker``).

* **the host in this process** — a :class:`WorkerHost` over a CPU
  engine served on a Unix socket, driven by the REFERENCE's
  ``RpcClient``: wire init (``put_config`` + chunked push + commit, the
  engine built only after the digest verifies), submit/step/collect
  giving ``lm_decode``'s stream, stats, reset, faults, a live weight
  swap through the push RPCs; the KV-handoff RPCs between two hosts (a
  prefill-only request parked on one, its pages exported, shipped chunk
  by chunk and committed on the other, which decodes ``lm_decode``'s
  stream) and their typed refusals;
* **file mode and the command line** — ``save_params``/``load_params``
  against the reference's artifact files, the argument and environment
  checks, and the worker module importing no torch before it binds;
* **the real worker end to end** (``--device cpu``) — a process fleet
  whose replica is SIGKILLed mid-decode, a TCP fleet rolled to new
  weights, and a process fleet split into a prefill and a decode pool,
  each with every greedy stream bit-identical to ``lm_decode``.
"""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import jax
import numpy as np
import pytest

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import kv_wire as jkv
from horovod_tpu.serve import params_wire as jpw
from horovod_tpu.serve import transport as jtr
from horovod_tpu.serve import worker as jworker
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import (FleetConfig, ProcessReplica,
                                     ServeConfig, ServeEngine, ServeFleet)
from horovod_tpu_torch.serve import params_wire as tpw
from horovod_tpu_torch.serve import worker as tworker

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 2, 8, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(page_size=8, num_pages=32, decode_slots=2, prefill_chunk=4)


def _map(fn, x):
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_map(fn, v) for v in x]
    return fn(x)


@pytest.fixture(scope="module")
def np_params():
    return _map(np.asarray, jlm.init_lm_params(
        jax.random.PRNGKey(0), V, LMAX, LAYERS, H, DH, FFN))


@pytest.fixture(scope="module")
def tparams(np_params):
    return tlm.params_from_numpy(np_params, device="cpu")


def _prompt(i, lp):
    return np.random.default_rng(400 + i).integers(0, V, lp).astype(
        np.int32)


def _ref(params, prompt, steps):
    return tlm.lm_decode(params, np.asarray(prompt)[None], steps,
                         device="cpu")[0].tolist()


class _Served:
    """A port WorkerHost on a Unix socket in this process: its RPC loop
    and (once the engine exists) its engine loop on threads."""

    def __init__(self, engine=None):
        self.dir = tempfile.mkdtemp(prefix="hvd-worker-test-")
        self.path = os.path.join(self.dir, "w.sock")
        self.srv = socket.socket(socket.AF_UNIX)
        self.srv.bind(self.path)
        self.srv.listen(2)
        self.host = tworker.WorkerHost(engine)
        self.rpc = threading.Thread(target=self.host.rpc_loop,
                                    args=(self.srv,), daemon=True)
        self.rpc.start()
        self.loop = None
        if engine is not None:
            self.start_loop()

    def start_loop(self):
        self.loop = threading.Thread(target=self.host.serve_loop,
                                     daemon=True)
        self.loop.start()

    def close(self):
        self.host._shutdown.set()
        for t in (self.rpc, self.loop):
            if t is not None:
                t.join(5)
        self.srv.close()
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)
        if self.host._artifact_dir:
            shutil.rmtree(self.host._artifact_dir, ignore_errors=True)


def _push(client, blob, version, chunk_bytes=4096):
    man = jpw.make_manifest(blob, version=version, chunk_bytes=chunk_bytes)
    have = client.call("push_begin", {"manifest": man})["have_bytes"]
    for i in range(have // chunk_bytes, man["num_chunks"]):
        client.call("push_chunk", jpw.make_chunk(blob, man, i))
    res = client.call("push_commit", {"version": version})
    assert res == {"version": version, "sha256": man["sha256"]}
    return man


def _collect_until_done(client, rid, timeout=30.0):
    out, t0 = [], time.monotonic()
    while time.monotonic() - t0 < timeout:
        c = client.call("collect", {"since": {str(rid): len(out)}})
        for pr in c["progress"]:
            out.extend(pr["tokens"])
        for ev in c["events"]:
            assert ev["rid"] == rid and ev["state"] == "finished"
            return out + ev["output"][len(out):]
        time.sleep(0.005)
    raise AssertionError("request never finished")


def test_wire_init_then_serving_through_the_reference_client(
        np_params, tparams):
    """The worker's whole RPC surface, driven by the REFERENCE's client:
    config and weights arrive over the wire, the engine is built from
    the digest-verified artifact, and the stream is lm_decode's."""
    srv = _Served()
    client = jtr.RpcClient(srv.path, default_timeout=20.0)
    try:
        pong = client.call("ping")
        assert pong["params_version"] is None
        assert pong["lane_captures"] is None and pong["lane_replays"] is None
        cfg = dict(CFG, attention="paged")
        payload = dataclasses.asdict(ServeConfig(**cfg))
        client.call("put_config", {"config": payload})
        blob = jpw.params_to_blob(np_params)
        man = _push(client, blob, version=1)
        assert srv.host.wait_init(5.0)
        assert tpw.params_to_blob(tworker.load_params(
            srv.host.init_params_path)) == blob
        engine = ServeEngine(tworker.load_params(
            srv.host.init_params_path),
            ServeConfig(**srv.host.init_config), device="cpu")
        srv.host.attach_engine(engine)
        srv.start_loop()
        # the same config again is an idempotent no-op; another is not
        client.call("put_config", {"config": payload})
        with pytest.raises(jtr.RemoteCallError, match="geometry"):
            client.call("put_config", {"config": dict(payload,
                                                      decode_slots=3)})
        pong = client.call("ping")
        assert pong["params_version"] == 1
        assert pong["params_sha256"] == man["sha256"]
        p = _prompt(0, 7)
        r = client.call("submit", {"rid": 41, "prompt": p.tolist(),
                                   "max_new_tokens": 9, "seed": 0})
        assert r == {"accepted": True}
        step = client.call("step")
        assert {"ticks", "hb", "free_slots", "occupancy", "queue_len",
                "in_flight", "idle"} <= set(step)
        assert _collect_until_done(client, 41) == _ref(tparams, p, 9)
        # the decode evidence: on the CPU the paged-attention wrapper
        # runs its plain version (no launch) and nothing is captured
        pong = client.call("ping")
        assert pong["decode_launches"] == 0
        assert pong["lane_captures"] is None and pong["lane_replays"] is None
        big = client.call("submit", {"rid": 42, "prompt": [1] * LMAX,
                                     "max_new_tokens": 9})
        assert big == {"accepted": False, "reject_reason": "infeasible",
                       "retry_after": None}
        st = client.call("stats")      # harvested requests left it
        assert st["attention"]["mode"] == "paged"
        assert st["attention"]["decode_steps"] > 0
        assert client.call("drain", {"timeout": 2.0}) == {"idle": True}
        assert client.call("reset_metrics") == {"ticks": 0}
        assert client.call("fault", {"kind": "slow", "factor": 1.0}) == {}
        with pytest.raises(jtr.RemoteCallError, match="unknown fault"):
            client.call("fault", {"kind": "kill"})
        # a live weight swap through the push RPCs (the rolling update)
        new = tlm.init_lm_params(9, V, LMAX, LAYERS, H, DH, FFN,
                                 device="cpu")
        _push(client, tpw.params_to_blob(new), version=2)
        assert len(os.listdir(srv.host._artifact_dir)) == 1   # pruned
        p2 = _prompt(1, 5)
        client.call("submit", {"rid": 43, "prompt": p2.tolist(),
                               "max_new_tokens": 6})
        assert _collect_until_done(client, 43) == _ref(new, p2, 6)
        assert client.call("ping")["params_version"] == 2
    finally:
        client.close()
        srv.close()


@pytest.mark.parametrize("method", ["nonsense", ""])
def test_unported_and_unknown_rpcs_are_typed(method):
    srv = _Served()
    client = jtr.RpcClient(srv.path, default_timeout=5.0)
    try:
        with pytest.raises(jtr.RemoteCallError) as e:
            client.call(method, {"rid": 1})
        assert jtr.remote_error_kind(e.value) == "ValueError"
        assert client.call("ping")["pid"] == os.getpid()
    finally:
        client.close()
        srv.close()


def _wait_handoff(client, rid, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if rid in client.call("step").get("handoff", []):
            return
        time.sleep(0.005)
    raise AssertionError(f"rid {rid} never parked")


def test_kv_rpcs_hand_a_request_between_two_hosts(tparams):
    """The KV verbs through the reference's client: a prefill-only
    request parks on one host, its pages ship chunk by chunk to the
    other, which decodes lm_decode's stream from them."""
    cfg = ServeConfig(**dict(CFG, attention="paged"))
    pre = _Served(ServeEngine(tparams, cfg, device="cpu"))
    dec = _Served(ServeEngine(tparams, cfg, device="cpu"))
    pcli = jtr.RpcClient(pre.path, default_timeout=20.0)
    dcli = jtr.RpcClient(dec.path, default_timeout=20.0)
    try:
        p, n = _prompt(5, 13), 9
        assert pcli.call("submit", {
            "rid": 7, "prompt": p.tolist(), "max_new_tokens": n,
            "prefill_only": True}) == {"accepted": True}
        _wait_handoff(pcli, 7)
        first = pcli.call("collect", {"since": {"7": 0}})["progress"]
        generated = first[0]["tokens"]
        assert len(generated) == 1
        m = pcli.call("kv_export_begin", {"rid": 7, "chunk_bytes": 512})[
            "manifest"]
        with pre.host._lock:
            blob = pre.host.engine.export_handoff(
                pre.host._requests[7].rid)
        assert m == jkv.make_kv_manifest(blob, rid=7, chunk_bytes=512)
        payload = {"prompt": p.tolist(), "max_new_tokens": n,
                   "temperature": 0.0, "top_k": 0, "eos_token": None,
                   "seed": 0, "age": 0.0, "ttl": None,
                   "generated": generated}
        # a chunk with no open import, a foreign rid's manifest: typed
        with pytest.raises(jtr.RemoteCallError) as e:
            dcli.call("kv_import_chunk", {"rid": 7, "chunk": {}})
        assert jtr.remote_error_kind(e.value) == "ValueError"
        with pytest.raises(jtr.RemoteCallError) as e:
            dcli.call("kv_import_begin", {"rid": 8, "manifest": m,
                                          "req": payload})
        assert jtr.remote_error_kind(e.value) == "FrameError"
        dcli.call("kv_import_abort", {"rid": 8})
        assert dcli.call("kv_import_begin", {
            "rid": 7, "manifest": m, "req": payload})["have_bytes"] == 0
        for i in range(m["num_chunks"] // 2):
            c = pcli.call("kv_export_chunk", {"rid": 7, "index": i})
            dcli.call("kv_import_chunk", {"rid": 7, "chunk": c["chunk"]})
        # a torn transfer resumes from the verified prefix
        have = dcli.call("kv_import_begin", {
            "rid": 7, "manifest": m, "req": payload})["have_bytes"]
        assert have == (m["num_chunks"] // 2) * 512
        for i in range(have // 512, m["num_chunks"]):
            c = pcli.call("kv_export_chunk", {"rid": 7, "index": i})
            dcli.call("kv_import_chunk", {"rid": 7, "chunk": c["chunk"]})
        # the sender closed without commit: the request stays parked
        pcli.call("kv_export_end", {"rid": 7, "commit": False})
        assert 7 in pcli.call("step")["handoff"]
        assert dcli.call("kv_import_commit", {"rid": 7}) == \
            {"accepted": True}
        pcli.call("kv_export_end", {"rid": 7, "commit": True})
        assert pcli.call("step")["handoff"] == []
        assert pcli.call("drain", {"timeout": 5.0}) == {"idle": True}
        with pytest.raises(jtr.RemoteCallError) as e:
            pcli.call("kv_export_begin", {"rid": 7})
        assert jtr.remote_error_kind(e.value) == "ValueError"
        assert _collect_until_done(dcli, 7) == _ref(tparams, p, n)
    finally:
        pcli.close()
        dcli.close()
        pre.close()
        dec.close()


def test_file_mode_artifacts_cross_packages(tmp_path, np_params, tparams):
    jpath, tpath = str(tmp_path / "j.hvpw"), str(tmp_path / "t.hvpw")
    jworker.save_params(np_params, jpath)
    tworker.save_params(tparams, tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = tworker.load_params(jpath)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.device.type == "cpu" and bool((a == b).all())
    jback = jworker.load_params(tpath, as_jax=False)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("argv, env, code", [
    ([], {}, 2),
    (["--socket", "s", "--bind", "127.0.0.1:0"], {}, 2),
    (["--socket", "s", "--params", "p"], {}, 2),
    (["--bind", "127.0.0.1:0"], {"HOROVOD_SECRET": ""}, 2),
    (["--bind", "127.0.0.1:notaport"], {"HOROVOD_SECRET": "k"}, 2),
    (["--socket", "s"], {"HVD_SERVE_WORKER_FAIL_START": "7"}, 7),
], ids=["none", "both", "params_alone", "no_secret", "bad_port",
        "fail_start"])
def test_command_line_checks(monkeypatch, argv, env, code):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        rc = tworker.main(argv)
    except SystemExit as e:
        rc = e.code
    assert rc == code


def test_worker_module_binds_before_importing_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import horovod_tpu_torch.serve.worker; "
         "print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    # The image may preload packages at startup; the worker itself must
    # add no torch import on the way to its bind.
    pre = subprocess.run(
        [sys.executable, "-c", "import sys; print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == pre.stdout.strip()


def _assert_reaped(fl):
    for rep in fl.replicas:
        assert isinstance(rep, ProcessReplica)
        assert rep.proc.poll() is not None


def _fleet_run_until(fl, reqs, timeout):
    t0 = time.monotonic()
    while not fl.idle and time.monotonic() - t0 < timeout:
        if not fl.step():
            time.sleep(0.002)
    assert fl.idle, [r.state for r in reqs]


def test_real_worker_kill_redispatch_bit_exact(tparams):
    fl = ServeFleet(tparams, ServeConfig(**CFG), FleetConfig(
        replicas=2, transport="process", backoff_base=0.01,
        rpc_deadline=60.0), device="cpu")
    try:
        prompts = [_prompt(10 + i, 4 + i) for i in range(4)]
        reqs = [fl.submit(p, 30) for p in prompts]
        t0 = time.monotonic()
        while not all(r.output for r in reqs) and \
                time.monotonic() - t0 < 60:
            fl.step()
        assert fl.replicas[1].assigned
        fl.arm_fault_plan("kill:replica=1,at=0s")
        _fleet_run_until(fl, reqs, 60)
        f = fl.stats()["fleet"]
        assert f["incidents_by_class"] == {"crashed": 1}
        assert f["incidents"][0]["code"] == -signal.SIGKILL
        assert f["redispatched"] >= 1 and f["restarts_used"] == 1
        assert f["params_push"]["pushes"] == 3      # spawn x2 + relaunch
        for p, r in zip(prompts, reqs):
            assert r.state == "finished"
            assert r.output == _ref(tparams, p, 30)
        assert [s["incarnation"] for s in fl.first_steps
                if s["replica"] == 1] == [1, 2]
    finally:
        fl.close()
    _assert_reaped(fl)


def test_real_worker_tcp_rolling_update_bit_exact(tparams):
    new = tlm.init_lm_params(11, V, LMAX, LAYERS, H, DH, FFN,
                             device="cpu")
    fl = ServeFleet(tparams, ServeConfig(**CFG), FleetConfig(
        replicas=1, transport="tcp", backoff_base=0.01, rpc_deadline=60.0,
        push_chunk_bytes=4096), device="cpu")
    try:
        p0 = _prompt(20, 6)
        r0 = fl.submit(p0, 12)
        _fleet_run_until(fl, [r0], 60)
        assert r0.output == _ref(tparams, p0, 12)
        fl._hosts[0]["faults"].tear_send_frame = 2   # torn mid-push
        fl.update_params(new)
        t0 = time.monotonic()
        while fl.update_active and time.monotonic() - t0 < 60:
            if not fl.step():
                time.sleep(0.002)
        assert not fl.update_active
        f = fl.stats()["fleet"]
        assert f["params_push"]["retries"] >= 1
        assert f["incidents_by_class"] == {}
        assert fl.replicas[0].version == 2
        p1 = _prompt(21, 6)
        r1 = fl.submit(p1, 12)
        _fleet_run_until(fl, [r1], 60)
        assert r1.output == _ref(new, p1, 12)
    finally:
        fl.close()
    _assert_reaped(fl)


def test_real_worker_pools_fleet_bit_exact(tparams):
    """One prefill worker and one decode worker (``--device cpu``): every
    request prefills on worker 0, ships its pages over the KV RPCs and
    decodes on worker 1 with lm_decode's stream."""
    fl = ServeFleet(tparams, ServeConfig(**dict(CFG, attention="paged")),
                    FleetConfig(replicas=2, transport="process",
                                backoff_base=0.01, rpc_deadline=60.0,
                                pools={"prefill": 1, "decode": 1}),
                    device="cpu")
    try:
        prompts = [_prompt(30 + i, 5 + 2 * i) for i in range(4)]
        reqs = [fl.submit(p, 10) for p in prompts]
        _fleet_run_until(fl, reqs, 90)
        for p, r in zip(prompts, reqs):
            assert r.state == "finished" and r.replica == 1
            assert r.output == _ref(tparams, p, 10)
        f = fl.stats()["fleet"]
        d = f["disagg"]
        assert d["transfers"] == 4 and d["failures"] == {}
        assert d["parked"] == 0 and d["kv_bytes_shipped"] > 0
        assert [c["role"] for c in f["per_replica"]] == ["prefill",
                                                          "decode"]
        assert f["incidents_by_class"] == {}
    finally:
        fl.close()
    _assert_reaped(fl)
