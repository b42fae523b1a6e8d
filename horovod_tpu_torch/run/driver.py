"""The per-worker exit taxonomy.

The port of the exit codes, :func:`classify_exit` and :class:`WorkerExit`
of ``horovod_tpu.run.driver``: the contract between a worker, whoever
supervises it, and the recovery metrics. The serving fleet classifies
replica incidents with it. The launch driver itself (rendezvous,
function distribution) comes with ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses


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
