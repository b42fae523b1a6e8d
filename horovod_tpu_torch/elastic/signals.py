"""Liveness beacons for the health watchdog.

The port of :class:`Heartbeat` and :func:`namespaced_heartbeat_dir` from
``horovod_tpu.elastic.signals``: a fleet replica (or, later, a training
rank) touches its per-rank file, and a
:class:`~horovod_tpu_torch.elastic.supervisor.HealthWatchdog` stats the
mtimes. ``PreemptionHandler`` (the deferred-SIGTERM drain + snapshot)
comes with ROADMAP.md Queue 1 item 5.3 (elastic training).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["Heartbeat", "namespaced_heartbeat_dir"]


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
