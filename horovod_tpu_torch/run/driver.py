"""Launch driver: rendezvous, function distribution, result collection,
and the per-worker exit taxonomy.

The port of ``horovod_tpu.run.driver``. :class:`Driver` runs in the
launcher's process: each worker of :func:`horovod_tpu_torch.run.run`
probes its published addresses (:func:`probe_service`), registers,
fetches the task (function, args, kwargs), runs it and reports the
result or the traceback over the authenticated RPC
(:mod:`horovod_tpu_torch.run.network`), through :class:`WorkerClient`.
The exit codes, :func:`classify_exit` and :class:`WorkerExit` are the
contract between a worker, whoever supervises it (the launcher, the
serving fleet) and the recovery metrics.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict

from horovod_tpu_torch.run.network import BasicClient, BasicService


@dataclasses.dataclass
class RegisterRequest:
    rank: int
    host: str


@dataclasses.dataclass
class RegisterResponse:
    ok: bool


@dataclasses.dataclass
class FetchTaskRequest:
    rank: int


@dataclasses.dataclass
class FetchTaskResponse:
    fn: Any          # pickled by the wire
    args: tuple
    kwargs: dict


@dataclasses.dataclass
class ResultRequest:
    rank: int
    success: bool
    payload: Any     # return value or formatted traceback


@dataclasses.dataclass
class Ack:
    pass


@dataclasses.dataclass
class Ping:
    """Reachability probe: any authenticated endpoint of the driver
    answers, proving that the address routes and that the peer holds the
    job's secret (an open port alone is not enough)."""


def probe_service(addrs, key: bytes, timeout: float = 1.5):
    """The first address in ``addrs`` (each ``"host:port"``) that answers
    an authenticated :class:`Ping`, as a ``(host, port)`` tuple; raises
    ``ConnectionError`` listing the candidates when none answers."""
    tried = []
    for addr in addrs:
        host, _, port = addr.rpartition(":")
        try:
            BasicClient((host, int(port)), key, timeout=timeout).request(
                Ping())
            return host, int(port)
        except Exception as e:  # unroutable, refused, timeout, bad auth
            tried.append(f"{addr} ({type(e).__name__})")
    raise ConnectionError(
        "no driver endpoint reachable; tried: " + ", ".join(tried))


# --------------------------------------------------------------- exit codes
# Propagating the class (instead of one opaque kill-all code) lets a
# supervisor decide relaunch-vs-fail-fast per incident.

#: Clean completion.
EXIT_CLEAN = 0
#: argparse/usage convention: deterministic, reruns identically — a
#: restart budget must never be burned on these.
EXIT_USAGE = 2
#: Preempted: the worker received SIGTERM (a maintenance event, spot
#: reclaim), drained, wrote its final snapshot and exited on purpose.
#: 75 = EX_TEMPFAIL from sysexits.h — "transient, retry later".
EXIT_PREEMPTED = 75
#: Resized: the worker drained, wrote its final snapshot and exited on
#: purpose to request a world resize (the ``resize:`` fault action, or
#: an external scheduler asking the job to change shape). The elastic
#: supervisor relaunches at the requested world size without consuming
#: the restart budget — an orchestrated resize is not a failure.
EXIT_RESIZED = 76


def classify_exit(code) -> str:
    """Map a worker exit code to ``clean|usage|preempted|resized|crashed``.

    Negative codes are subprocess ``-signum`` deaths: ``-SIGTERM`` is
    classed *preempted* (the cluster reclaimed the worker before the
    in-process handler could convert it to :data:`EXIT_PREEMPTED` — same
    recovery either way), every other signal (SIGKILL = OOM-kill or
    fault-injected crash, SIGSEGV, ...) is *crashed*. A sixth category,
    *stalled*, cannot be derived from the code alone — the health
    watchdog marks it on the :class:`WorkerExit` when IT was the one
    that killed the silent worker.
    """
    import signal as _signal

    if code == EXIT_CLEAN:
        return "clean"
    if code == EXIT_USAGE:
        return "usage"
    if code == EXIT_PREEMPTED or code == -_signal.SIGTERM:
        return "preempted"
    if code == EXIT_RESIZED:
        return "resized"
    return "crashed"


@dataclasses.dataclass
class WorkerExit:
    """One worker's observed exit: rank, raw code, classified category.

    ``stalled`` is set by the launcher when the supervisor's health
    watchdog killed this worker for a stale heartbeat — the raw code is
    then the watchdog's SIGKILL, and the *category* reports ``stalled``
    so the relaunch policy and recovery metrics see the real incident
    class, not a generic crash.

    The taxonomy is deliberately process-agnostic: the serving fleet
    (:mod:`horovod_tpu_torch.serve.fleet`) classifies replica incidents with
    the same class — ``rank`` is then the replica id — so training and
    serving recovery metrics speak one vocabulary."""

    rank: int
    code: int
    stalled: bool = False

    @property
    def category(self) -> str:
        if self.stalled:
            return "stalled"
        return classify_exit(self.code)

    def describe(self, role: str = "rank") -> str:
        """One-line incident description for supervisor/fleet logs,
        e.g. ``"replica 1 exited -9 (crashed)"``."""
        return f"{role} {self.rank} exited {self.code} ({self.category})"


class Driver:
    """Runs in the launcher's process; workers talk to it over the
    authenticated RPC."""

    def __init__(self, world_size: int, key: bytes, fn=None, args=(),
                 kwargs=None):
        self._world_size = world_size
        self._fn = fn
        self._args = args
        self._kwargs = kwargs or {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._registered: Dict[int, str] = {}
        self._results: Dict[int, ResultRequest] = {}
        self._service = BasicService("driver", key, self._handle)

    @property
    def port(self) -> int:
        return self._service.port

    def _handle(self, req):
        if isinstance(req, Ping):
            return Ack()
        if isinstance(req, RegisterRequest):
            with self._cond:
                self._registered[req.rank] = req.host
                self._cond.notify_all()
            return RegisterResponse(ok=True)
        if isinstance(req, FetchTaskRequest):
            return FetchTaskResponse(fn=self._fn, args=self._args,
                                     kwargs=self._kwargs)
        if isinstance(req, ResultRequest):
            with self._cond:
                self._results[req.rank] = req
                self._cond.notify_all()
            return Ack()
        raise ValueError(f"unknown request {type(req).__name__}")

    def wait_registered(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self._registered) < self._world_size:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._cond.wait(remain)
        return True

    def wait_results(self, timeout: float,
                     should_abort=None) -> Dict[int, ResultRequest]:
        """Wait for every rank's result; returns early when one rank
        reports a failure (fail fast) or ``should_abort()`` is true (a
        worker process died without reporting)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self._results) < self._world_size:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                if any(not r.success for r in self._results.values()):
                    break
                if should_abort is not None and should_abort():
                    break
                self._cond.wait(min(remain, 0.25))
            return dict(self._results)

    def close(self) -> None:
        self._service.close()


class WorkerClient:
    """The worker's side of the driver's RPC."""

    def __init__(self, driver_addr, key: bytes):
        self._client = BasicClient(driver_addr, key)

    def register(self, rank: int, host: str) -> None:
        self._client.request(RegisterRequest(rank=rank, host=host))

    def fetch_task(self, rank: int) -> FetchTaskResponse:
        return self._client.request(FetchTaskRequest(rank=rank))

    def report(self, rank: int, success: bool, payload: Any) -> None:
        self._client.request(ResultRequest(rank=rank, success=success,
                                           payload=payload))
