"""The environment knobs of the data-parallel path, read at ``init()``:
the subset of ``horovod_tpu.common.config`` that training uses, with the
same names and defaults (the reference's env-var names)."""

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


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
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
        )
