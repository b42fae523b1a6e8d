"""horovod_tpu_torch.run — the job launcher, the port of
``horovod_tpu.run``.

Two ways to start an N-rank job, as Horovod's ``horovodrun`` and
``horovod.spark.run`` offer:

* the CLI, ``hvdrun-torch -np N [-H host:slots,...] -- python train.py``
  (or ``python -m horovod_tpu_torch.run``; :mod:`.launcher`):
  :func:`launch_job` starts the command once per rank and supervises
  the ranks, failing fast;
* :func:`run` (``hvd.run(fn, np=N)``): ships a pickled function to N
  local ranks (:mod:`.task_exec` over the driver's authenticated RPC,
  :mod:`.driver`), runs it and returns the ranks' results in rank order.

Each rank gets Horovod's environment (``HOROVOD_RANK``, ``HOROVOD_SIZE``,
``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE``, ``HOROVOD_CONTROLLER``,
``HOROVOD_DRIVER``, ``HOROVOD_SECRET``) and what ``torch.distributed``'s
``env://`` reads (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so
``hvd.init()`` in the rank joins the job's world with no arguments.
Ranks that share one card start a gloo group themselves first
(``dist.init_process_group("gloo", init_method="env://")``) and pass
``device="cuda:0"``: NCCL takes one card a rank. Remote hosts
(``-H``) run their ranks over ssh with the same environment.

The single-worker lanes (:func:`spawn_worker`, :func:`spawn_worker_ssh`,
:func:`kill_worker`, :func:`terminate_worker`) run the serving fleet's
``process`` and ``tcp`` placements.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from horovod_tpu_torch.run.driver import (EXIT_CLEAN, EXIT_PREEMPTED,
                                          EXIT_RESIZED, EXIT_USAGE, Driver,
                                          WorkerExit, classify_exit)
from horovod_tpu_torch.run.network import make_secret_key


class LaunchError(RuntimeError):
    def __init__(self, message: str, failures: Optional[dict] = None):
        super().__init__(message)
        self.failures = failures or {}


@dataclasses.dataclass
class JobResult:
    """Outcome of one :func:`launch_job` attempt, with every worker's exit
    code. ``trigger`` is the failure that caused the kill-all (the lowest
    failing rank at the poll that saw it, a watchdog kill first); the
    other ranks' codes then reflect the launcher's SIGTERM.
    ``stalled_ranks`` maps each rank the health watchdog killed for a
    stale heartbeat to the heartbeat age it saw. ``pre_kill_codes``
    holds every failing exit seen before the kill-all: those ranks died
    on their own. ``teardown_s`` is the time from the trigger's
    detection to every rank reaped (0.0 when all exited cleanly)."""

    exit_codes: Dict[int, Optional[int]]
    trigger: Optional[WorkerExit] = None
    stalled_ranks: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    pre_kill_codes: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    teardown_s: float = 0.0

    @property
    def code(self) -> int:
        return self.trigger.code if self.trigger is not None else EXIT_CLEAN

    @property
    def category(self) -> str:
        """clean | usage | preempted | resized | stalled | crashed: the
        trigger's classification."""
        if self.trigger is not None:
            return self.trigger.category
        return classify_exit(self.code)

    def describe(self) -> str:
        if self.trigger is None:
            return "all ranks exited cleanly"
        return (f"rank {self.trigger.rank} "
                f"{self.trigger.category} (exit {self.trigger.code}); "
                "per-rank codes "
                + str({r: c for r, c in sorted(self.exit_codes.items())}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        return s.getsockname()[1]


def _worker_env(base: Dict[str, str], rank: int, size: int, local_rank: int,
                local_size: int, controller: str, driver: str,
                secret_hex: str) -> Dict[str, str]:
    host, _, port = controller.rpartition(":")
    env = dict(base)
    env.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(local_size),
        "HOROVOD_CONTROLLER": controller,
        "HOROVOD_DRIVER": driver,
        "HOROVOD_SECRET": secret_hex,
        # torch.distributed's env:// rendezvous: rank 0 hosts the store.
        "RANK": str(rank),
        "WORLD_SIZE": str(size),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(local_size),
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
    })
    return env


def _parse_hosts(hosts: str) -> List[tuple]:
    """Parse ``host1:4,host2:4`` into [(host, slots), ...] (the
    ``horovodrun -H`` syntax)."""
    out = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        out.append((host, int(slots) if slots else 1))
    return out


def _spawn_local(cmd: Sequence[str], env: Dict[str, str]) -> subprocess.Popen:
    # New process group so one kill() reaps the whole worker's tree.
    return subprocess.Popen(list(cmd), env=env, start_new_session=True)


# Machine-local variables never forwarded to remote ranks; everything else
# in the job env goes over so all ranks of one job see one environment.
_SSH_ENV_DENY = ("SSH_", "DISPLAY", "HOSTNAME", "PWD", "OLDPWD", "SHLVL",
                 "TMPDIR", "XDG_", "DBUS_", "HOME", "LOGNAME", "USER", "_")


_SSH_READY_MARKER = b"__HVD_ECHO_OFF__"


def _spawn_ssh(host: str, cmd: Sequence[str],
               env: Dict[str, str]) -> subprocess.Popen:
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if not k.startswith(_SSH_ENV_DENY) and k != "HOROVOD_SECRET"
        and "\n" not in v)
    # The HMAC secret must never appear on a command line (argv is world-
    # readable via /proc on the remote host); ship it over stdin instead.
    # The -tt pty would echo that stdin line back into the launcher's
    # stdout (and thus scrollback/job logs), so the remote disables echo
    # and prints a marker; the launcher only writes the secret AFTER the
    # marker arrives (writing earlier would race the stty and be echoed
    # by the default line discipline).
    marker = _SSH_READY_MARKER.decode()
    remote = (f"stty -echo 2>/dev/null; printf '{marker}\\n'; "
              "IFS= read -r HOROVOD_SECRET && export HOROVOD_SECRET && "
              f"cd {shlex.quote(os.getcwd())} && env {exports} "
              + " ".join(shlex.quote(c) for c in cmd))
    # -tt forces a pty so killing the local ssh client HUPs the remote
    # process tree — the fail-fast kill works across hosts.
    proc = subprocess.Popen(["ssh", "-tt", "-o", "BatchMode=yes", host,
                             remote], start_new_session=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def feed_secret_then_pump():
        out = proc.stdout
        line = b""
        while True:  # wait for the echo-off marker (or early EOF)
            ch = out.read(1)
            if not ch:
                return  # ssh died before the marker; supervisor reaps it
            if ch == b"\n":
                if _SSH_READY_MARKER in line:
                    break
                sys.stdout.buffer.write(line + b"\n")
                sys.stdout.buffer.flush()
                line = b""
            else:
                line += ch
        try:
            proc.stdin.write((env.get("HOROVOD_SECRET", "") + "\n").encode())
            proc.stdin.flush()
        except (BrokenPipeError, OSError):
            return
        while True:  # stream the worker's output to the launcher's stdout
            chunk = out.read(4096)
            if not chunk:
                return
            sys.stdout.buffer.write(chunk)
            sys.stdout.buffer.flush()

    pump = threading.Thread(target=feed_secret_then_pump, daemon=True)
    pump.start()
    proc._hvd_pump_thread = pump  # joined by _drain_output at job end
    return proc


def spawn_worker(cmd: Sequence[str],
                 env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Spawn ONE supervised worker process in its own session/process
    group, so one ``killpg`` reaps the worker's whole tree. The caller
    owns supervision and classification; the serving fleet
    (:mod:`horovod_tpu_torch.serve.fleet`, ``transport="process"``) pairs
    this with :class:`~horovod_tpu_torch.run.driver.WorkerExit` /
    :func:`~horovod_tpu_torch.run.driver.classify_exit` so replica and
    training incidents speak one taxonomy."""
    return _spawn_local(cmd, dict(env if env is not None
                                  else os.environ))


def spawn_worker_ssh(host: str, cmd: Sequence[str],
                     env: Optional[Dict[str, str]] = None
                     ) -> subprocess.Popen:
    """Spawn ONE supervised worker on a REMOTE host over ssh — the
    multi-host lane of :func:`spawn_worker`, used by the serving
    fleet's ``transport="tcp"`` placement. Reuses the launcher's ssh
    discipline (:func:`_spawn_ssh`): ``-tt`` forces a pty so killing
    the returned LOCAL ssh client's process group
    (:func:`kill_worker` / :func:`terminate_worker`) HUPs the remote
    process tree — the fail-fast kill works across hosts — and the
    ``HOROVOD_SECRET`` entry of ``env`` ships over stdin after an
    echo-off marker, never on the remote argv (world-readable via
    /proc). Caveat the caller owns: the returned Popen is the ssh
    CLIENT, so its exit code is the remote command's only when the
    remote exits normally — a signal-killed remote (or a dead ssh
    session) reports 255/-signum, and the fleet classifies those from
    its own evidence instead."""
    return _spawn_ssh(host, list(cmd),
                      dict(env if env is not None else os.environ))


def kill_worker(proc: subprocess.Popen,
                timeout: float = 5.0) -> Optional[int]:
    """SIGKILL one worker's process group and reap it (bounded — a
    D-state wait must not hang the caller).
    Returns the observed exit code, or None when the process could not
    be reaped within ``timeout``."""
    if proc.poll() is None:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
    return proc.returncode


def terminate_worker(proc: subprocess.Popen,
                     term_timeout: float = 2.0,
                     kill_timeout: float = 5.0) -> Optional[int]:
    """Graceful-teardown escalation for one worker: SIGTERM the process
    group, wait ``term_timeout``, SIGKILL stragglers, reap — the
    launcher's kill ladder, single-process edition (the fleet's
    ``close()`` uses it after the shutdown RPC so a wedged replica can
    never zombie). Returns the exit code, or None if unreapable."""
    if proc.poll() is None:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(term_timeout)
        except subprocess.TimeoutExpired:
            return kill_worker(proc, kill_timeout)
    return proc.returncode


def _drain_output(procs: List[subprocess.Popen], timeout: float = 5.0) -> None:
    """Join the ssh output pumps, so the tail of remote ranks' output
    reaches the launcher's stdout before the job returns."""
    deadline = time.monotonic() + timeout
    for p in procs:
        t = getattr(p, "_hvd_pump_thread", None)
        if t is not None:
            t.join(max(0.1, deadline - time.monotonic()))


def _kill_all(procs: List[subprocess.Popen]) -> None:
    """SIGTERM every live rank's process group, SIGKILL what is left
    after 5 s, and reap (bounded: an uninterruptible wait is reported,
    not waited out), so a relaunch never races an old rank."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
    deadline = time.monotonic() + 5
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    reap_deadline = time.monotonic() + 10
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(max(0.1, reap_deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"hvdrun-torch: worker pid {p.pid} did not exit "
                      "after SIGKILL (uninterruptible I/O?); proceeding",
                      file=sys.stderr, flush=True)


def launch_command(cmd: Sequence[str], np: int,
                   hosts: Optional[str] = None,
                   env: Optional[Dict[str, str]] = None) -> int:
    """Run ``cmd`` as an N-rank job; returns the job's exit code
    (:func:`launch_job`'s ``code``)."""
    return launch_job(cmd, np, hosts=hosts, env=env).code


def launch_job(cmd: Sequence[str], np: int,
               hosts: Optional[str] = None,
               env: Optional[Dict[str, str]] = None,
               watchdog=None) -> JobResult:
    """Run ``cmd`` as an N-rank job; returns a :class:`JobResult` with
    every worker's exit code and the classified failure that ended it.

    Fails fast: the first failing rank kills the rest, and the result
    says which rank failed and how (clean, usage, preempted, resized,
    stalled or crashed). ``watchdog`` (a
    :class:`~horovod_tpu_torch.elastic.supervisor.HealthWatchdog`, or
    anything with its ``check(ranks) -> {rank: age}``, ``timeout`` and
    ``kills``) rides the supervision poll: a rank it reports stale is
    SIGKILLed and its exit marked *stalled*."""
    base_env = dict(env if env is not None else os.environ)
    secret_hex = make_secret_key().hex()

    placements: List[tuple] = []  # (host or None, local_rank, local_size)
    if hosts:
        parsed = _parse_hosts(hosts)
        total = sum(s for _, s in parsed)
        if total != np:
            raise LaunchError(f"-H slots ({total}) != -np ({np})")
        for host, slots in parsed:
            for lr in range(slots):
                placements.append((host, lr, slots))
    else:
        placements = [(None, r, np) for r in range(np)]

    first_host = placements[0][0]
    if first_host is None or first_host in ("localhost", "127.0.0.1"):
        controller = f"127.0.0.1:{_free_port()}"
    else:
        # Rank 0 binds on a remote host this launcher cannot probe: pick
        # from the high ephemeral range and let its init report a clash.
        controller = f"{first_host}:{random.randint(20000, 59999)}"

    procs: List[subprocess.Popen] = []
    try:
        for rank, (host, local_rank, local_size) in enumerate(placements):
            wenv = _worker_env(base_env, rank, np, local_rank, local_size,
                               controller, "", secret_hex)
            if host is None or host in ("localhost", "127.0.0.1"):
                procs.append(_spawn_local(cmd, wenv))
            else:
                procs.append(_spawn_ssh(host, cmd, wenv))
        stalled: Dict[int, float] = {}
        while True:
            codes = [p.poll() for p in procs]
            if watchdog is not None:
                live = [r for r, c in enumerate(codes) if c is None]
                for rank, age in watchdog.check(live).items():
                    # A stale heartbeat means a silently wedged worker,
                    # possibly mid-collective, where SIGTERM's drain
                    # would hang too: SIGKILL makes it an incident.
                    print(f"hvdrun-torch: health watchdog: rank {rank} "
                          f"heartbeat stale for {age:.1f}s (timeout "
                          f"{watchdog.timeout:g}s); killing the stalled "
                          "worker", file=sys.stderr, flush=True)
                    stalled[rank] = age
                    watchdog.kills[rank] = age
                    try:
                        os.killpg(os.getpgid(procs[rank].pid),
                                  signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                if stalled:
                    codes = [p.poll() for p in procs]
            bad_ranks = [r for r, c in enumerate(codes)
                         if c not in (None, 0)]
            if bad_ranks:
                # The lowest failing rank at this poll is the trigger; a
                # watchdog kill wins the tie, so the incident is classed
                # stalled and not by whatever its SIGKILL raced.
                t0 = time.monotonic()
                first = min((r for r in bad_ranks if r in stalled),
                            default=bad_ranks[0])
                trigger = WorkerExit(first, codes[first],
                                     stalled=first in stalled)
                pre_kill = {r: c for r, c in enumerate(codes)
                            if c not in (None, 0)}
                _kill_all(procs)
                _drain_output(procs)
                return JobResult(
                    exit_codes={r: p.poll() for r, p in enumerate(procs)},
                    trigger=trigger, stalled_ranks=dict(stalled),
                    pre_kill_codes=pre_kill,
                    teardown_s=time.monotonic() - t0)
            if all(c == 0 for c in codes):
                _drain_output(procs)
                return JobResult(exit_codes=dict(enumerate(codes)))
            time.sleep(0.05)
    except KeyboardInterrupt:
        _kill_all(procs)
        raise
    finally:
        if any(p.poll() is None for p in procs):
            _kill_all(procs)


def _package_root() -> str:
    """The directory holding this package, put first on the workers'
    ``PYTHONPATH`` so ``python -m horovod_tpu_torch.run.task_exec``
    resolves from any working directory."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _driver_addresses(port: int) -> List[str]:
    """The driver endpoints :func:`run` publishes to its ranks. They are
    local processes, so loopback reaches the driver: no interface is
    probed (the JAX package publishes ``candidate_addresses``, whose
    default-route probe a host without a network has no use for)."""
    return [f"127.0.0.1:{port}"]


def run(fn, args: tuple = (), kwargs: Optional[dict] = None, np: int = 1,
        env: Optional[Dict[str, str]] = None,
        start_timeout: float = 120.0,
        run_timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` local ranks; returns their
    return values in rank order (``horovod.spark.run``'s semantics).
    The first rank that raises fails the job with a :class:`LaunchError`
    carrying its traceback (``failures``: rank -> traceback).

    ``fn`` crosses to the ranks pickled (:mod:`.network`): by reference
    when it is a module-level function of a module the ranks import,
    else by value through ``cloudpickle``, which must then be
    installed. A function of a script run as ``__main__`` pickles by
    value: import the script as a module instead, where cloudpickle is
    missing."""
    from horovod_tpu_torch.run.network import dumps

    dumps((fn, args, kwargs))        # refuse an unshippable task up front
    key = make_secret_key()
    driver = Driver(np, key, fn=fn, args=args, kwargs=kwargs)
    base_env = dict(env if env is not None else os.environ)
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_package_root(), base_env.get("PYTHONPATH", "")) if p)
    secret_hex = key.hex()
    controller = f"127.0.0.1:{_free_port()}"
    # Each worker probes the published endpoints for the first that
    # answers an authenticated Ping before registering.
    driver_addr = ",".join(_driver_addresses(driver.port))

    procs: List[subprocess.Popen] = []
    try:
        for rank in range(np):
            wenv = _worker_env(base_env, rank, np, rank, np, controller,
                               driver_addr, secret_hex)
            procs.append(_spawn_local(
                [sys.executable, "-m", "horovod_tpu_torch.run.task_exec"],
                wenv))
        if not driver.wait_registered(start_timeout):
            raise LaunchError(
                f"timed out after {start_timeout}s waiting for "
                f"{np} workers to register")

        def worker_died():
            return any(p.poll() not in (None, 0) for p in procs)

        results = driver.wait_results(run_timeout, should_abort=worker_died)
        failures = {r: res.payload for r, res in results.items()
                    if not res.success}
        if failures:
            first = min(failures)
            raise LaunchError(
                f"rank {first} failed:\n{failures[first]}", failures)
        if len(results) < np:
            dead = [r for r, p in enumerate(procs)
                    if p.poll() not in (None, 0)]
            if dead:
                raise LaunchError(
                    f"rank(s) {dead} exited without reporting "
                    f"(exit codes {[procs[r].poll() for r in dead]})")
            raise LaunchError(
                f"timed out after {run_timeout}s: only {len(results)}/{np} "
                "ranks reported")
        return [results[r].payload for r in range(np)]
    finally:
        _kill_all(procs)
        driver.close()


__all__ = ["run", "launch_command", "launch_job", "JobResult",
           "WorkerExit", "classify_exit", "LaunchError",
           "spawn_worker", "spawn_worker_ssh", "kill_worker",
           "terminate_worker",
           "EXIT_CLEAN", "EXIT_PREEMPTED", "EXIT_RESIZED", "EXIT_USAGE"]
