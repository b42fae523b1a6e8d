"""Worker spawning for the port (`horovod_tpu_torch.run`).

The port of the single-worker lanes of ``horovod_tpu.run``: spawn one
supervised worker locally (:func:`spawn_worker`, its own session and
process group) or on a remote host over ssh (:func:`spawn_worker_ssh`,
a ``-tt`` pty so killing the local ssh client HUPs the remote tree, and
``HOROVOD_SECRET`` shipped over stdin after an echo-off marker, never on
the remote argv), and kill or terminate it with a bounded reap
(:func:`kill_worker`, :func:`terminate_worker`). The serving fleet's
``process`` and ``tcp`` placements run on these. The job launcher
(``launch_job``, ``run``, the ``hvdrun`` CLI) comes with ROADMAP.md
Queue 1 item 5.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
from typing import Dict, Optional, Sequence


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
