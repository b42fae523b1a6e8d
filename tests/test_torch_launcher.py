"""The port's launcher (``horovod_tpu_torch.run``) against the JAX
package's ``tests/test_launcher.py``, case for case, on the CPU: the
HMAC wire (and frames crossing between the two packages), ``run(fn)``
(identity, a gloo collective through ``hvd.init()``, args, kwargs and
closures, fast failure, a module-level task without ``cloudpickle``),
interface discovery, the ``hvdrun-torch`` CLI (success, failure code,
restarts, no relaunch on exit 2, the ``-H`` slot check, the elastic
flags refused), and ``launch_job``'s fail-fast supervision with the
health watchdog.

Every address used is local: the route probe of ``candidate_addresses``
is stubbed, and the black-hole endpoint of the probing cases is a local
socket that listens and never answers. The tasks are module-level
functions of this module, which the ranks import by reference
(``tests/`` on their ``PYTHONPATH``); they import no torch unless the
case needs it.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *args],
        env=_clean_env(), cwd=str(REPO), timeout=timeout,
        capture_output=True, text=True)


@pytest.fixture(autouse=True)
def _no_route_probe(monkeypatch):
    from horovod_tpu_torch.run import network

    monkeypatch.setattr(network, "_route_probe_ip", lambda: None)
    monkeypatch.setattr(network, "_hostname_ips", lambda: ["127.0.0.1"])


@pytest.fixture
def black_hole():
    """A local endpoint that accepts connections into its backlog and
    never answers: a probe of it times out."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(8)
    yield f"127.0.0.1:{s.getsockname()[1]}"
    s.close()


# Module-level tasks: the ranks import them by reference.

def _task_allreduce():
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    out = hvd.allreduce(torch.ones(8) * (hvd.rank() + 1), average=False)
    hvd.shutdown()
    return float(out[0])


def _task_identity():
    return (int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"]),
            int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ["LOCAL_RANK"]),
            int(os.environ["LOCAL_WORLD_SIZE"]),
            os.environ["MASTER_ADDR"],
            os.environ["HOROVOD_CONTROLLER"].endswith(
                ":" + os.environ["MASTER_PORT"]),
            "torch" in sys.modules)


def _task_fail_on_rank1():
    if os.environ["HOROVOD_RANK"] == "1":
        raise RuntimeError("boom on rank 1")
    return "ok"


def _task_rank():
    return int(os.environ["HOROVOD_RANK"])


class TestWire:
    def test_roundtrip(self):
        from horovod_tpu_torch.run.network import (BasicClient, BasicService,
                                                   make_secret_key)

        key = make_secret_key()
        svc = BasicService("t", key, lambda req: {"echo": req})
        try:
            out = BasicClient(("127.0.0.1", svc.port), key).request([1, "a"])
            assert out == {"echo": [1, "a"]}
        finally:
            svc.close()

    def test_bad_secret_rejected(self):
        from horovod_tpu_torch.run.network import (BasicClient, BasicService,
                                                   make_secret_key)

        svc = BasicService("t", make_secret_key(), lambda req: req)
        try:
            client = BasicClient(("127.0.0.1", svc.port), make_secret_key(),
                                 timeout=5.0)
            # The server drops unauthenticated connections unanswered.
            with pytest.raises((ConnectionError, socket.timeout, OSError)):
                client.request("sneaky")
        finally:
            svc.close()

    def test_tampered_payload_rejected(self):
        import hashlib
        import hmac as hmac_mod
        import struct

        from horovod_tpu_torch.run.network import (IntegrityError, Wire,
                                                   make_secret_key)

        key = make_secret_key()
        wire = Wire(key)
        payload = pickle.dumps({"x": 1})
        digest = hmac_mod.new(key, payload, hashlib.sha256).digest()
        tampered = payload[:-1] + bytes([payload[-1] ^ 0xFF])

        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<Q", len(tampered)) + digest + tampered)
            with pytest.raises(IntegrityError, match="integrity"):
                wire.read(b)
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_frames_cross_between_the_packages(self, direction):
        from horovod_tpu.run import network as jnet
        from horovod_tpu_torch.run import network as tnet

        key = tnet.make_secret_key()
        writer, reader = ((jnet, tnet) if direction == "jax_to_port"
                          else (tnet, jnet))
        obj = {"rank": 3, "payload": [1.5, "x", (None, b"\x00")]}
        a, b = socket.socketpair()
        try:
            writer.Wire(key).write(a, obj)
            assert reader.Wire(key).read(b, timeout=5.0) == obj
            writer.Wire(key).write(a, obj)
            with pytest.raises(reader.IntegrityError, match="integrity"):
                reader.Wire(tnet.make_secret_key()).read(b, timeout=5.0)
        finally:
            a.close()
            b.close()

    def test_by_value_objects_need_cloudpickle(self, monkeypatch):
        from horovod_tpu_torch.run import network

        offset = 3
        frame = network.dumps(lambda x: x + offset)   # cloudpickle here
        assert pickle.loads(frame)(1) == 4
        assert pickle.loads(network.dumps(_task_rank)) is _task_rank
        monkeypatch.setitem(sys.modules, "cloudpickle", None)
        assert pickle.loads(network.dumps(_task_rank)) is _task_rank
        with pytest.raises(pickle.PicklingError,
                           match="cloudpickle is not installed.*module-level"):
            network.dumps(lambda x: x + offset)


class TestRunFn:
    def test_identity_env(self):
        from horovod_tpu_torch.run import run

        results = run(_task_identity, np=3, env=_clean_env())
        assert [r[:6] for r in results] == [(r, 3, r, 3, r, 3)
                                            for r in range(3)]
        assert all(r[6] == "127.0.0.1" and r[7] for r in results)
        assert not any(r[8] for r in results)      # no torch was loaded

    def test_collectives_through_launcher(self):
        from horovod_tpu_torch.run import run

        results = run(_task_allreduce, np=2, env=_clean_env(),
                      run_timeout=180.0)
        assert results == [3.0, 3.0]  # 1 + 2 on both ranks

    def test_args_kwargs_and_closures(self):
        from horovod_tpu_torch.run import run

        offset = 5
        results = run(lambda x, y=0: x * 2 + y + offset, args=(10,),
                      kwargs={"y": 1}, np=2, env=_clean_env())
        assert results == [26, 26]

    def test_failure_propagates_fast(self):
        from horovod_tpu_torch.run import LaunchError, run

        t0 = time.monotonic()
        with pytest.raises(LaunchError, match="boom on rank 1") as ei:
            run(_task_fail_on_rank1, np=2, env=_clean_env(),
                run_timeout=300.0)
        assert time.monotonic() - t0 < 60  # far below run_timeout
        assert 1 in ei.value.failures

    def test_module_level_task_runs_without_cloudpickle(self, monkeypatch):
        from horovod_tpu_torch.run import run

        monkeypatch.setitem(sys.modules, "cloudpickle", None)
        assert run(_task_rank, np=2, env=_clean_env()) == [0, 1]
        with pytest.raises(pickle.PicklingError, match="module-level"):
            run(lambda: 1, np=2, env=_clean_env())


class TestInterfaceDiscovery:
    def test_candidate_addresses_include_loopback(self, monkeypatch):
        from horovod_tpu_torch.run import network

        monkeypatch.setattr(network, "_hostname_ips",
                            lambda: ["127.0.0.1", "10.1.2.3"])
        addrs = network.candidate_addresses(1234)
        assert addrs == ["127.0.0.1:1234", "10.1.2.3:1234"]
        assert len(addrs) == len(set(addrs))

    def test_probe_skips_unroutable_first_candidate(self, black_hole):
        from horovod_tpu_torch.run.driver import Driver, probe_service
        from horovod_tpu_torch.run.network import make_secret_key

        key = make_secret_key()
        driver = Driver(1, key)
        try:
            addr = probe_service([black_hole, f"127.0.0.1:{driver.port}"],
                                 key, timeout=1.0)
            assert addr == ("127.0.0.1", driver.port)
        finally:
            driver.close()

    def test_probe_rejects_wrong_secret(self):
        from horovod_tpu_torch.run.driver import Driver, probe_service
        from horovod_tpu_torch.run.network import make_secret_key

        driver = Driver(1, make_secret_key())
        try:
            with pytest.raises(ConnectionError, match="no driver"):
                probe_service([f"127.0.0.1:{driver.port}"],
                              make_secret_key(), timeout=1.0)
        finally:
            driver.close()

    def test_run_fn_with_unroutable_first_candidate(self, monkeypatch,
                                                    black_hole):
        import horovod_tpu_torch.run as hr

        real = hr._driver_addresses
        monkeypatch.setattr(hr, "_driver_addresses",
                            lambda port: [black_hole] + real(port))
        out = hr.run(_task_rank, np=2, env=_clean_env(), start_timeout=90.0)
        assert out == [0, 1]


class TestCLI:
    def test_launch_command_success(self):
        proc = _cli(
            "-np", "2", sys.executable, "-c",
            "import torch, horovod_tpu_torch as hvd; hvd.init(device='cpu');"
            " out = hvd.allreduce(torch.ones(4), average=False);"
            " assert float(out[0]) == 2.0, out; hvd.shutdown()", timeout=180)
        assert proc.returncode == 0, proc.stderr[-2000:]

    def test_launch_command_failure_code(self):
        proc = _cli("-np", "2", sys.executable, "-c",
                    "import os, sys; sys.exit(3 if os.environ['HOROVOD_RANK']"
                    " == '0' else 0)")
        assert proc.returncode == 3

    def test_restarts_relaunches_until_success(self, tmp_path):
        marker = tmp_path / "attempted"
        script = (
            "import os, sys; m = sys.argv[1]\n"
            "if os.environ['HOROVOD_RANK'] == '0' and not os.path.exists(m):\n"
            "    open(m, 'w').close(); sys.exit(7)\n"
        )
        proc = _cli("-np", "2", "--restarts", "1", sys.executable, "-c",
                    script, str(marker))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stderr.count("relaunching") == 1
        assert marker.exists()

    def test_restarts_exhausted_returns_failure(self):
        proc = _cli("-np", "1", "--restarts", "2", sys.executable, "-c",
                    "raise SystemExit(5)")
        assert proc.returncode == 5
        assert proc.stderr.count("relaunching") == 2

    def test_restarts_skip_usage_errors(self):
        proc = _cli("-np", "1", "--restarts", "3", sys.executable, "-c",
                    "raise SystemExit(2)")
        assert proc.returncode == 2
        assert "; relaunching" not in proc.stderr
        assert "usage error" in proc.stderr

    def test_hosts_slot_mismatch(self):
        from horovod_tpu_torch.run import LaunchError, launch_command

        with pytest.raises(LaunchError, match="slots"):
            launch_command(["true"], np=3, hosts="localhost:2")

    @pytest.mark.parametrize("flags", [
        ["--elastic"], ["--max-restarts", "2"], ["--min-np", "1"],
        ["--max-np", "4"], ["--slots-file", "s"],
        ["--watchdog-timeout", "9"], ["--metrics-file", "m"],
        ["--fault-plan", "kill:rank=1,step=2"]])
    def test_elastic_flags_exit_2(self, flags):
        proc = _cli("-np", "2", *flags, "true")
        assert proc.returncode == 2
        assert f"{flags[0]}: elastic training is not ported" in proc.stderr
        assert "ROADMAP.md Queue 1 item 5.3" in proc.stderr

    @pytest.mark.parametrize("args", [["-np", "2"], ["-np", "0", "true"],
                                      ["-np", "1", "--restarts", "-1",
                                       "true"]])
    def test_usage_checks_exit_2(self, args):
        proc = _cli(*args)
        assert proc.returncode == 2
        assert "error:" in proc.stderr

    def test_hvdrun_torch_console_entry_resolves(self):
        import importlib
        import tomllib

        pyproject = tomllib.loads((REPO / "pyproject.toml").read_text())
        scripts = pyproject["project"]["scripts"]
        assert scripts["hvdrun"] == "horovod_tpu.run.launcher:main"
        target = scripts["hvdrun-torch"]
        mod_name, _, fn_name = target.partition(":")
        assert callable(getattr(importlib.import_module(mod_name), fn_name))
        code = subprocess.run(
            [sys.executable, "-c",
             f"import sys; from {mod_name} import {fn_name}; "
             f"sys.exit({fn_name}(['-np', '1', '--', "
             f"{sys.executable!r}, '-c', 'print(42)']))"],
            env=_clean_env(), cwd=str(REPO), timeout=120,
            capture_output=True, text=True)
        assert code.returncode == 0 and code.stdout.strip() == "42"


class TestLaunchJob:
    def test_fail_fast_classifies_the_trigger(self):
        from horovod_tpu_torch.run import launch_job

        t0 = time.monotonic()
        res = launch_job(
            [sys.executable, "-c",
             "import os, sys, time\n"
             "if os.environ['HOROVOD_RANK'] == '1': sys.exit(1)\n"
             "time.sleep(60)"], np=2, env=_clean_env())
        assert time.monotonic() - t0 < 30
        assert res.trigger.rank == 1 and res.category == "crashed"
        assert res.code == 1 and res.pre_kill_codes == {1: 1}
        assert res.exit_codes[0] is not None and res.exit_codes[0] != 0
        assert 0 < res.teardown_s < 10
        assert "rank 1 crashed (exit 1)" in res.describe()

    def test_clean_job(self):
        from horovod_tpu_torch.run import launch_job

        res = launch_job([sys.executable, "-c", "pass"], np=2,
                         env=_clean_env())
        assert res.trigger is None and res.code == 0
        assert res.category == "clean" and res.exit_codes == {0: 0, 1: 0}
        assert res.describe() == "all ranks exited cleanly"

    def test_watchdog_kills_and_classifies_a_stalled_rank(self, tmp_path):
        from horovod_tpu_torch.elastic.supervisor import HealthWatchdog
        from horovod_tpu_torch.run import launch_job

        hb = tmp_path / "hb"
        hb.mkdir()
        script = (
            "import os, pathlib, sys, time\n"
            "r = os.environ['HOROVOD_RANK']; d = pathlib.Path(sys.argv[1])\n"
            "for i in range(600):\n"
            "    if r == '1' or i == 0: (d / f'hb-{r}').touch()\n"
            "    time.sleep(0.1)\n")
        wd = HealthWatchdog(str(hb), timeout=1.0, interval=0.1)
        t0 = time.monotonic()
        res = launch_job([sys.executable, "-c", script, str(hb)], np=2,
                         env=_clean_env(), watchdog=wd)
        assert time.monotonic() - t0 < 30
        assert res.trigger.rank == 0 and res.trigger.stalled
        assert res.category == "stalled"
        assert set(res.stalled_ranks) == {0} and res.stalled_ranks[0] > 1.0
        assert 0 in wd.kills
