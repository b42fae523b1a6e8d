"""Supervision: the stale-heartbeat watchdog.

The port of :class:`HealthWatchdog` from ``horovod_tpu.elastic.supervisor``:
the serving fleet (:mod:`~horovod_tpu_torch.serve.fleet`) kills any
replica whose heartbeat file goes stale past the timeout and classifies
it ``stalled``. The elastic relaunch loop (``supervise``) comes with
ROADMAP.md Queue 1 item 5.3 (elastic training).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Sequence


class HealthWatchdog:
    """Supervisor-side stale-heartbeat detector.

    :meth:`check` stats the per-rank heartbeat files (throttled to
    ``interval`` so the caller's poll loop stays cheap) and returns the
    ranks whose last beat is older than ``timeout``; the caller SIGKILLs
    them — the only safe recovery for a silently-stalled worker — and
    marks their :class:`~horovod_tpu_torch.run.driver.WorkerExit`
    *stalled* so policy and metrics see the real class. A rank is only
    watched once its heartbeat file exists. ``timeout`` must exceed the
    slowest interval between two beats (for a fleet: a whole tick,
    relaunch captures included). ``kills`` records the age observed at
    each kill decision; the owner clears a rank's entry when it
    relaunches it.
    """

    def __init__(self, directory: str, timeout: float,
                 interval: float = 0.5, _now=time.monotonic):
        from horovod_tpu_torch.elastic.signals import Heartbeat

        self.directory = directory
        self.timeout = float(timeout)
        self.interval = float(interval)
        self._now = _now
        self._fmt = Heartbeat.FILE_FMT
        self._last_check = -float("inf")
        #: rank -> observed heartbeat age (secs) at the kill decision.
        self.kills: Dict[int, float] = {}

    def reset(self) -> None:
        """Per-attempt reset (the supervisor also clears the heartbeat
        files themselves so attempt N's silence is never judged by
        attempt N-1's mtimes)."""
        self.kills.clear()
        self._last_check = -float("inf")

    def check(self, ranks: Sequence[int]) -> Dict[int, float]:
        """Stale ranks among ``ranks`` -> heartbeat age. Throttled:
        returns {} between ``interval`` ticks."""
        now = self._now()
        if now - self._last_check < self.interval:
            return {}
        self._last_check = now
        wall = time.time()
        stale = {}
        for rank in ranks:
            if rank in self.kills:
                continue
            path = os.path.join(self.directory,
                                self._fmt.format(rank=rank))
            try:
                age = wall - os.stat(path).st_mtime
            except OSError:
                continue  # no beat yet: not watched
            if age > self.timeout:
                stale[rank] = age
        return stale
