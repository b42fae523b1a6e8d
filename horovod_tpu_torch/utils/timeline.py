"""Chrome-tracing timeline profiler: the port's own copy of
``horovod_tpu.utils.timeline`` (which imports no JAX; the port imports
nothing of the JAX package, so it carries this copy, unchanged below the
docstring).

The rebuild of the reference Horovod Timeline
(horovod/common/timeline.{h,cc}; semantics documented in the reference's
docs/timeline.md:17-62):

* activated by ``HOROVOD_TIMELINE=/path/trace.json``; rank 0 writes
  (reference operations.cc:1824-1829);
* per-tensor state machine NEGOTIATING -> TOP_LEVEL -> ACTIVITY
  (reference timeline.h:75-121);
* records never block the hot path: they are pushed onto a queue drained by
  a background writer thread (reference timeline.h:45-73 used a boost
  lock-free SPSC queue + writer thread; Python's ``SimpleQueue`` is the
  equivalent primitive here);
* activity taxonomy kept from reference operations.h:29-50, with the JAX
  package's additions (the XLA and window names are unused by the port).

In the port, ``horovod_tpu_torch.distributed.fusion`` writes one track
per gradient bucket: an ALLREDUCE span from the bucket's issue to its
unpack, with MEMCPY_IN_FUSION_BUFFER, REDUCESCATTER/ALLGATHER (the
scatter form) and MEMCPY_OUT_FUSION_BUFFER inside it.

The Chrome trace format is the "JSON Array Format": one event object per
line, comma-separated, '[' prologue — loadable in chrome://tracing and
Perfetto even when truncated mid-run (same property the reference relied on).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

# Activity names (reference horovod/common/operations.h:29-50).
QUEUE = "QUEUE"
INIT_FUSION_BUFFER = "INIT_FUSION_BUFFER"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
ALLTOALL = "ALLTOALL"
# Overlap-shaped bucket reductions (horovod_tpu/jax/fusion.py): buckets
# above the scatter threshold split the allreduce into its ring halves —
# REDUCESCATTER then (after the sharded update) ALLGATHER — each its own
# activity under the bucket's ALLREDUCE span, which under overlap opens
# at collective ISSUE and closes at fusion-buffer UNPACK so the trace
# shows every in-flight bucket.
REDUCESCATTER = "REDUCESCATTER"
# XLA-path additions.
XLA_TRACE = "XLA_TRACE"
XLA_COMPILE = "XLA_COMPILE"
XLA_EXECUTE = "XLA_EXECUTE"
# Multi-step window activities (horovod_tpu/jax/window.py): WINDOW spans
# the ONE host dispatch of a K-step scanned window; WINDOW_SYNC spans the
# boundary block_until_ready + d2h pull, so a trace attributes host time
# to dispatch vs sync even when K steps share one program.
WINDOW = "WINDOW"
WINDOW_SYNC = "WINDOW_SYNC"

_NEGOTIATING = "NEGOTIATING"
_TOP_LEVEL = "TOP_LEVEL"


class Timeline:
    """Thread-safe, non-blocking chrome-trace writer.

    API mirrors the reference (timeline.h:83-93): ``negotiate_start/
    negotiate_rank_ready/negotiate_end``, ``start/activity_start/
    activity_end/end``, ``mark_cycle_start``.
    """

    def __init__(
        self,
        path: Optional[str],
        mark_cycles: bool = False,
        enabled_rank: bool = True,
    ) -> None:
        self._enabled = bool(path) and enabled_rank
        self._mark_cycles = mark_cycles
        self._path = path
        self._queue: "queue.SimpleQueue[Optional[dict]]" = queue.SimpleQueue()
        self._tensor_tracks: dict = {}
        self._next_tid = 1
        self._lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._t0 = time.monotonic_ns()
        if self._enabled:
            self._writer = threading.Thread(
                target=self._drain, name="hvd-timeline-writer", daemon=True
            )
            self._writer.start()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- infrastructure ----------------------------------------------------

    # Cap on named tracks so auto-named ops in long training loops cannot
    # grow the map unboundedly; overflow names share hashed tracks.
    _MAX_TRACKS = 4096

    def _now_us(self) -> float:
        return (time.monotonic_ns() - self._t0) / 1e3

    def _tid(self, tensor_name: str) -> int:
        with self._lock:
            tid = self._tensor_tracks.get(tensor_name)
            if tid is None:
                if self._next_tid > self._MAX_TRACKS:
                    return (hash(tensor_name) % self._MAX_TRACKS) + 1
                tid = self._next_tid
                self._next_tid += 1
                self._tensor_tracks[tensor_name] = tid
                self._queue.put(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": 0,
                        "tid": tid,
                        "args": {"name": tensor_name},
                    }
                )
            return tid

    def _emit(self, ev: dict) -> None:
        self._queue.put(ev)

    def _drain(self) -> None:
        assert self._path is not None
        with open(self._path, "w") as f:
            f.write("[\n")
            while True:
                ev = self._queue.get()
                if ev is None:
                    break
                f.write(json.dumps(ev))
                f.write(",\n")
                # Writer thread owns the file; flush per event batch is
                # acceptable off the hot path.
                if self._queue.empty():
                    f.flush()

    # -- reference API -----------------------------------------------------

    def negotiate_start(self, tensor_name: str, op: str) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": _NEGOTIATING,
                "ph": "B",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
                "args": {"op": op},
            }
        )

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": f"{rank}",
                "ph": "i",
                "s": "t",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
            }
        )

    def negotiate_end(self, tensor_name: str) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": _NEGOTIATING,
                "ph": "E",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
            }
        )

    def start(self, tensor_name: str, op: str,
              args: Optional[dict] = None) -> None:
        if not self._enabled:
            return
        ev = {
            "name": op,
            "ph": "B",
            "pid": 0,
            "tid": self._tid(tensor_name),
            "ts": self._now_us(),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def activity_start(self, tensor_name: str, activity: str) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": activity,
                "ph": "B",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
            }
        )

    def activity_end(self, tensor_name: str) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": "",
                "ph": "E",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
            }
        )

    def end(self, tensor_name: str, op: Optional[str] = None) -> None:
        if not self._enabled:
            return
        self._emit(
            {
                "name": op or "",
                "ph": "E",
                "pid": 0,
                "tid": self._tid(tensor_name),
                "ts": self._now_us(),
            }
        )

    def mark_window(self, index: int, steps: int) -> None:
        """Instant global marker at a multi-step window boundary
        (horovod_tpu/jax/window.py): the window-loop analogue of
        ``mark_cycle_start``, carrying the window index and the number
        of steps its single dispatch covers."""
        if not self._enabled:
            return
        self._emit(
            {
                "name": "WINDOW_START",
                "ph": "i",
                "s": "g",
                "pid": 0,
                "tid": 0,
                "ts": self._now_us(),
                "args": {"window": index, "steps": steps},
            }
        )

    def mark_cycle_start(self) -> None:
        # Reference: HOROVOD_TIMELINE_MARK_CYCLES (operations.cc:2042-2045).
        if self._enabled and self._mark_cycles:
            self._emit(
                {
                    "name": "CYCLE_START",
                    "ph": "i",
                    "s": "g",
                    "pid": 0,
                    "tid": 0,
                    "ts": self._now_us(),
                }
            )

    def close(self) -> None:
        if self._enabled and self._writer is not None:
            self._queue.put(None)
            self._writer.join(timeout=5.0)
            self._writer = None
            self._enabled = False


class _Activity:
    """Context manager sugar: ``with timeline.activity(name, ALLREDUCE): ...``"""

    def __init__(self, timeline: Timeline, tensor_name: str, activity: str):
        self._t = timeline
        self._name = tensor_name
        self._activity = activity

    def __enter__(self):
        self._t.activity_start(self._name, self._activity)
        return self

    def __exit__(self, *exc):
        self._t.activity_end(self._name)
        return False


def activity(timeline: Timeline, tensor_name: str, act: str) -> _Activity:
    return _Activity(timeline, tensor_name, act)
