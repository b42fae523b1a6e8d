"""Preemption-tolerant training for the port (`horovod_tpu_torch.elastic`):
the port of ``horovod_tpu.elastic``, the subsystem upstream Horovod grew
as Elastic Horovod. A preempted or crashed rank costs at most one
snapshot cadence of recomputation, never the run.

Pieces (each its own module, composable a la carte):

* :mod:`~horovod_tpu_torch.elastic.snapshot` — double-buffered host-RAM
  snapshots every K steps (an async device-to-host copy through a
  staging buffer on the card), spilled through the
  :class:`~horovod_tpu_torch.checkpoint.CheckpointManager` on a slower
  cadence with an atomic **resume manifest** (step, RNG state,
  data-shard cursor);
* :mod:`~horovod_tpu_torch.elastic.signals` — the SIGTERM/preemption
  hook (flag-only handler, drain + final sync snapshot at the next step
  boundary, exit ``EXIT_PREEMPTED`` (75)) and the per-rank
  :class:`Heartbeat`;
* :mod:`~horovod_tpu_torch.elastic.supervisor` — the
  ``hvdrun-torch --elastic --max-restarts N`` relaunch policy over the
  launcher's per-rank exit classification, and the
  :class:`HealthWatchdog`;
* :mod:`~horovod_tpu_torch.elastic.faults` — ``HOROVOD_FAULT_PLAN``
  deterministic fault injection (kill/preempt/stall/exit/resize per rank
  per step), so every recovery path runs in CI on the CPU, and the
  serving fleet's wall-clock dialect;
* :mod:`~horovod_tpu_torch.elastic.loop` — :func:`run_elastic`, the
  loop that wires all of it around any ``(state, batch) -> (state,
  metrics)`` step function over a pytree of tensors (plain, or K steps a
  window replayed from one captured step).

Quick start::

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.checkpoint import CheckpointManager

    ckpt = CheckpointManager("/ckpts")
    state, metrics, resumed = elastic.run_elastic(
        train_step, state, source.batch_at, num_steps=10_000,
        manager=ckpt, snapshot_every=100, spill_every=5)

launched as::

    hvdrun-torch --elastic --max-restarts 3 -np 8 python train.py

The manifests and checkpoints on disk are the JAX package's, byte for
byte (docs/elastic.md has the cadence math, manifest format and
fault-plan grammar).
"""

from horovod_tpu_torch.elastic.faults import (FaultAction, FaultInjector,
                                              FaultPlanError,
                                              parse_fault_plan,
                                              resize_requests)
from horovod_tpu_torch.elastic.loop import ShardedBatchSource, run_elastic
from horovod_tpu_torch.elastic.signals import (EXIT_PREEMPTED, Heartbeat,
                                               PreemptionHandler)
from horovod_tpu_torch.elastic.snapshot import (ResumeManifest, Snapshotter,
                                                latest_manifest,
                                                manifest_steps,
                                                read_manifest,
                                                write_manifest)
from horovod_tpu_torch.elastic.supervisor import (HealthWatchdog,
                                                  slots_file_capacity,
                                                  supervise)
from horovod_tpu_torch.run.driver import (EXIT_CLEAN, EXIT_RESIZED,
                                          EXIT_USAGE, WorkerExit,
                                          classify_exit)

__all__ = [
    "run_elastic",
    "ShardedBatchSource",
    "Snapshotter",
    "ResumeManifest",
    "write_manifest",
    "read_manifest",
    "latest_manifest",
    "manifest_steps",
    "PreemptionHandler",
    "Heartbeat",
    "HealthWatchdog",
    "FaultInjector",
    "FaultAction",
    "FaultPlanError",
    "parse_fault_plan",
    "resize_requests",
    "supervise",
    "slots_file_capacity",
    "classify_exit",
    "WorkerExit",
    "EXIT_CLEAN",
    "EXIT_PREEMPTED",
    "EXIT_RESIZED",
    "EXIT_USAGE",
]
