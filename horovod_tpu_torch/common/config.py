"""The environment knobs of the data-parallel path, read at ``init()``:
the subset of ``horovod_tpu.common.config`` that training uses, with the
same names and defaults (the reference's env-var names). The two elastic
knobs are read where they are used, as in the reference: the snapshot
cadence by :class:`~horovod_tpu_torch.elastic.snapshot.Snapshotter`, the
watchdog deadline by :func:`~horovod_tpu_torch.elastic.supervisor.
supervise`."""

from __future__ import annotations

import dataclasses
import os

# Reference default: a 64 MB fusion buffer.
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Buckets at or above this size take the reduce-scatter + all-gather form
# under overlap (horovod_tpu_torch.distributed.fusion).
DEFAULT_OVERLAP_SCATTER_THRESHOLD = 4 * 1024 * 1024
# HOROVOD_OVERLAP values (fusion.resolve_overlap).
OVERLAP_MODES = ("auto", "on", "off")
# HOROVOD_HIERARCHICAL values (fusion.resolve_hierarchical): run each
# fused bucket as the two-level intra-host reduce-scatter -> inter-host
# exchange -> intra-host all-gather ladder instead of one flat
# collective. "auto" (default) engages only when the ranks span more
# than one host (parallel.mesh.dcn_present); "on" forces the ladder with
# HOROVOD_HIERARCHICAL_INNER_SIZE (or the ranks per host) as the inner
# size; "off" is the flat collective.
HIERARCHICAL_MODES = ("auto", "on", "off")
# Elastic snapshot cadence (HOROVOD_SNAPSHOT_EVERY): steps between
# host-RAM snapshots of the train state.
DEFAULT_SNAPSHOT_EVERY = 100
# Supervisor health-watchdog deadline (HOROVOD_WATCHDOG_TIMEOUT, seconds):
# a rank whose per-boundary heartbeat goes stale past it is killed,
# classified "stalled" and the job relaunched from the last snapshot.
# Finite by default, so a silent stall under --elastic ends; it must
# exceed the slowest interval between two boundaries. 0 disables it.
DEFAULT_WATCHDOG_TIMEOUT_SECS = 300.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_bool(name: str) -> bool:
    v = os.environ.get(name, "")
    return v not in ("", "0", "false", "False", "FALSE")


def _env_choice(name: str, default: str, choices) -> str:
    v = os.environ.get(name, "").strip().lower()
    return v if v in choices else default


@dataclasses.dataclass
class Config:
    """Snapshot of the knobs, read once at init."""

    # Gradient-bucket fusion threshold in bytes (HOROVOD_FUSION_THRESHOLD).
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD
    # Reverse-order, start-all/unpack-later bucket collectives
    # (HOROVOD_OVERLAP=auto|on|off); never changes the numbers.
    overlap: str = "auto"
    # Bucket-size floor of the reduce-scatter + all-gather form
    # (HOROVOD_OVERLAP_SCATTER_THRESHOLD, bytes).
    overlap_scatter_threshold: int = DEFAULT_OVERLAP_SCATTER_THRESHOLD
    # Chrome-trace timeline output path (HOROVOD_TIMELINE; rank 0 writes,
    # empty = off) and its cycle markers (HOROVOD_TIMELINE_MARK_CYCLES).
    timeline_path: str = ""
    timeline_mark_cycles: bool = False
    # Hierarchical bucket collectives (HOROVOD_HIERARCHICAL=auto|on|off;
    # HIERARCHICAL_MODES above).
    hierarchical: str = "auto"
    # The legacy boolean spelling (HOROVOD_HIERARCHICAL_ALLREDUCE=1 is
    # read as HOROVOD_HIERARCHICAL=on) and the two-phase allgather
    # (HOROVOD_HIERARCHICAL_ALLGATHER).
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # Inner (one host's) size of the ladder; 0 = the ranks per host
    # (HOROVOD_HIERARCHICAL_INNER_SIZE), so that one host's ranks can
    # stand for several.
    hierarchical_inner_size: int = 0
    # The step autotuner (HOROVOD_AUTOTUNE) and its TSV log
    # (HOROVOD_AUTOTUNE_LOG; rank 0 writes, empty = none).
    autotune: bool = False
    autotune_log: str = ""

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold=_env_int("HOROVOD_FUSION_THRESHOLD",
                                      DEFAULT_FUSION_THRESHOLD),
            overlap=_env_choice("HOROVOD_OVERLAP", "auto", OVERLAP_MODES),
            overlap_scatter_threshold=_env_int(
                "HOROVOD_OVERLAP_SCATTER_THRESHOLD",
                DEFAULT_OVERLAP_SCATTER_THRESHOLD),
            timeline_path=os.environ.get("HOROVOD_TIMELINE", ""),
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
            hierarchical=_env_choice("HOROVOD_HIERARCHICAL", "auto",
                                     HIERARCHICAL_MODES),
            hierarchical_allreduce=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLREDUCE"),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER"),
            hierarchical_inner_size=_env_int(
                "HOROVOD_HIERARCHICAL_INNER_SIZE", 0),
            autotune=_env_bool("HOROVOD_AUTOTUNE"),
            autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG", ""),
        )
