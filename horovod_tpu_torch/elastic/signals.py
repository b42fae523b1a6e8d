"""Preemption signal handling and liveness beacons: the port of
``horovod_tpu.elastic.signals``.

Preemptions (maintenance events, spot reclaim) arrive as SIGTERM with a
short grace window. The WRONG response is doing real work inside the
signal handler — a handler interrupts arbitrary code (possibly
mid-collective, mid-malloc, holding locks), so blocking collectives or
filesystem writes there deadlock or corrupt exactly when recovery
matters most. The discipline of :class:`PreemptionHandler`:

1. the handler ONLY sets a flag;
2. the training loop checks the flag at each step/window boundary —
   where the train state is consistent and no collective is mid-flight
   (a rank blocked inside a gloo or NCCL collective runs no Python
   handler until the call returns, so the boundary is the first place
   it can act);
3. at the boundary, :meth:`PreemptionHandler.finalize` drains the
   card's queued work (``torch.cuda.synchronize`` on each card the
   state lives on), writes one final SYNCHRONOUS snapshot through the
   :class:`~horovod_tpu_torch.elastic.snapshot.Snapshotter`, and exits
   with the distinct :data:`EXIT_PREEMPTED` status (75, EX_TEMPFAIL) so
   the supervisor classifies the exit as *preempted* and relaunches.

:class:`Heartbeat` is the worker's liveness beacon: a training rank (at
every window boundary) or a fleet replica (every tick) touches its
per-rank file, and a
:class:`~horovod_tpu_torch.elastic.supervisor.HealthWatchdog` stats the
mtimes.
"""

from __future__ import annotations

import os
import signal
import sys
from typing import Iterable, Optional

from horovod_tpu_torch.run.driver import (EXIT_PREEMPTED,  # canonical home
                                          EXIT_RESIZED)

__all__ = ["PreemptionHandler", "Heartbeat", "EXIT_PREEMPTED",
           "namespaced_heartbeat_dir", "drain"]


def drain(state) -> None:
    """Wait for the work queued on every card ``state``'s tensor leaves
    live on (the counterpart of ``jax.block_until_ready``); CPU leaves
    need nothing."""
    import torch
    from torch.utils._pytree import tree_leaves

    devices = {leaf.device for leaf in tree_leaves(state)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)


def namespaced_heartbeat_dir(base: Optional[str] = None) -> str:
    """A heartbeat directory unique to ONE supervisor/fleet instance.

    ``HOROVOD_HEARTBEAT_DIR`` is exported to workers, so two watchdog
    owners sharing a directory on one host would watch each other's
    ``hb-<rank>`` files: supervisor A's rank 0 touching ``hb-0`` keeps
    supervisor B's stalled rank 0 alive forever (and vice versa), which
    silently defeats stall detection exactly when two jobs — or a
    training job and a serving fleet — colocate. Every watchdog owner
    therefore namespaces its directory per INSTANCE: a fresh unique
    subdirectory under ``base`` (or the system tempdir), never the
    shared path itself.
    """
    import tempfile
    import uuid

    if base:
        os.makedirs(base, exist_ok=True)
        path = os.path.join(
            base, f"hvd-hb-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(path)
        return path
    return tempfile.mkdtemp(prefix="hvd-heartbeat-")


class PreemptionHandler:
    """Deferred SIGTERM/preemption hook for elastic training loops.

    Usage::

        handler = PreemptionHandler()          # installs on SIGTERM
        for step in ...:
            if handler.triggered:              # boundary check
                handler.finalize(snapshotter, step, state)  # no return
            state, metrics = train_step(state, batch)

    ``install=False`` builds an uninstalled handler (driven purely by
    :meth:`trigger`, e.g. from the fault injector's deterministic
    ``preempt`` action). Context-manager form restores the previous
    handlers on exit.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 install: bool = True):
        self.triggered = False
        self.signum: Optional[int] = None
        #: exit status finalize() uses; a resize trigger overrides it
        #: with EXIT_RESIZED so the supervisor sees the incident class.
        self.exit_code: int = EXIT_PREEMPTED
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._installed = False
        if install:
            self.install()

    def install(self) -> None:
        if self._installed:
            return
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._on_signal)
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        # Flag-set ONLY: no collectives, no filesystem, no allocation —
        # the loop does the real work at its next step boundary.
        self.triggered = True
        self.signum = signum

    def trigger(self, exit_code: Optional[int] = None) -> None:
        """Programmatic preemption request (same deferred semantics).
        ``exit_code`` overrides the finalize status — the resize fault
        action passes EXIT_RESIZED so the drain + final snapshot run
        exactly like a preemption but the supervisor relaunches at the
        requested world size."""
        self.triggered = True
        if exit_code is not None:
            self.exit_code = exit_code

    def check(self) -> bool:
        return self.triggered

    def finalize(self, snapshotter, step: int, state,
                 exit_code: Optional[int] = None, _exit=sys.exit,
                 **aux) -> None:
        """Boundary-time preemption epilogue; does not return.

        Drains in-flight device work (``torch.cuda.synchronize`` on
        every card the state's leaves live on — every issued kernel and
        collective completes or the runtime raises), takes one final
        SYNCHRONOUS snapshot spilled straight to disk with its resume
        manifest, and exits with ``exit_code`` so the supervisor sees a
        *preempted* worker, not a crash. ``aux`` is forwarded into the
        manifest (cursor, rng).
        """
        if exit_code is None:
            exit_code = self.exit_code
        drain(state)
        if snapshotter is not None:
            snapshotter.flush(step, state, **aux)
        kind = {EXIT_PREEMPTED: "preemption",
                EXIT_RESIZED: "resize"}.get(exit_code, f"exit {exit_code}")
        print(f"[hvd elastic] {kind} (signal {self.signum}): drained "
              f"and snapshotted at step {step}; exiting "
              f"{exit_code}", file=sys.stderr, flush=True)
        self.uninstall()
        _exit(exit_code)

    def __enter__(self) -> "PreemptionHandler":
        self.install()
        return self

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


class Heartbeat:
    """Worker-side liveness beacon for the health watchdog.

    Each replica (rank) touches its file ``hb-<rank>`` in the watched
    directory at the end of every served tick; a
    :class:`~horovod_tpu_torch.elastic.supervisor.HealthWatchdog` stats
    the mtimes, and a replica whose file goes stale past the timeout is
    killed, classified *stalled* and relaunched — a silent hang becomes
    one bounded incident. A replica is only *watched* once its file
    exists, so a process still importing torch or capturing its first
    graph is never killed for silence. The touch is one tiny write — no
    device sync — cheap enough for every tick.
    """

    FILE_FMT = "hb-{rank}"

    def __init__(self, directory: str, rank: Optional[int] = None):
        if rank is None:
            rank = int(os.environ.get("HOROVOD_RANK", "0"))
        self.rank = rank
        self.directory = directory
        self.path = os.path.join(directory, self.FILE_FMT.format(rank=rank))
        os.makedirs(directory, exist_ok=True)

    @classmethod
    def from_env(cls) -> Optional["Heartbeat"]:
        """A heartbeat bound to ``HOROVOD_HEARTBEAT_DIR``, or None when
        the job runs unsupervised (no watchdog, nothing to feed)."""
        directory = os.environ.get("HOROVOD_HEARTBEAT_DIR", "")
        return cls(directory) if directory else None

    def touch(self, step: Optional[int] = None) -> None:
        """Stamp liveness (mtime is the signal; the step content is for
        humans debugging a stale file)."""
        with open(self.path, "w") as f:
            f.write(f"{self.rank} {step if step is not None else ''}\n")
