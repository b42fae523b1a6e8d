"""Serving engine configuration: page math + scheduler SLO knobs.

The port of ``horovod_tpu.serve.config.ServeConfig``, with the same
fields, defaults and validation. The page math contract:

* the model's position table length ``Lmax`` must divide into
  ``page_size`` pages — each request's logical cache is ``Lmax //
  page_size`` page slots, mapped to physical pages by its page table;
* physical page 0 is RESERVED as the null sink: short page tables pad
  with it, and reads beyond a request's length are masked, so its
  contents are never observed — ``num_pages - 1`` pages are allocatable.

One knob of the JAX engine has no port yet and must keep its default:
``mesh`` (tensor-parallel serving). Any other value raises
:class:`NotImplementedError` naming the ROADMAP.md queue item that ports
it. ``FleetConfig`` comes with the fleet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Scheduler admission policies.
POLICIES = ("fcfs", "sjf")
#: The latency-vs-throughput SLO knob positions.
SLO_MODES = ("latency", "balanced", "throughput")
#: Page-allocation disciplines.
ADMISSIONS = ("reserve", "lazy")
#: Decode-attention implementations: ``gather`` reconstructs the dense
#: ``[S, Lmax, H, D]`` logical cache per layer per step (the exactness
#: reference); ``paged`` reads only each slot's live pages through the
#: paged-attention kernel (:mod:`horovod_tpu_torch.ops.paged_attention`).
ATTENTIONS = ("gather", "paged")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for :class:`horovod_tpu_torch.serve.ServeEngine`.

    ``page_size``/``num_pages`` size the paged KV cache (page 0
    reserved). ``decode_slots`` fixes the decode batch; ``prefill_chunk``
    the tokens per step the prefill lane processes.

    ``policy`` picks the queue order (``fcfs`` / ``sjf``); ``slo`` gates
    when NEW prefills start (``latency`` / ``balanced`` /
    ``throughput``); ``admission`` picks the page discipline (``reserve``
    worst case up front, or ``lazy`` with eviction-recompute).

    ``attention`` picks the decode-attention path: ``gather`` (the
    default and the exactness reference) reconstructs each slot's dense
    ``[Lmax, H, D]`` cache per layer per step, while ``paged`` reads only
    the ``ceil((t+1)/page_size)`` live pages through the paged-attention
    kernel. Greedy token streams are identical either way; the prefill
    lane gathers the full cache in both modes.

    ``prefix_caching`` maps a prompt's already-filled whole pages into
    the new request read-only (:mod:`~horovod_tpu_torch.serve.prefix`),
    so prefill starts at the first miss. ``speculate_k`` > 0 turns on
    speculative decoding: a draft made of the target's first
    ``draft_layers`` layers (0 = half the depth) proposes up to
    ``speculate_k`` tokens a slot a step, and the target verifies them
    in one pass; greedy streams stay those of the plain engine.
    """

    page_size: int = 16
    num_pages: int = 64
    decode_slots: int = 4
    prefill_chunk: int = 32
    max_in_flight: int = 0      # 0 = decode_slots + the prefill lane
    policy: str = "fcfs"
    slo: str = "balanced"
    admission: str = "reserve"
    attention: str = "gather"
    prefix_caching: bool = False
    speculate_k: int = 0
    draft_layers: int = 0
    eos_token: Optional[int] = None
    max_queue: int = 0          # 0 = unbounded
    requeue_evicted: bool = True
    mesh: Optional[str] = None
    #: Default per-request deadline in seconds from arrival (None = no
    #: deadline; a per-request ``ttl=`` overrides).
    default_ttl: Optional[float] = None

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null "
                f"sink), got {self.num_pages}")
        if self.decode_slots < 1:
            raise ValueError(
                f"decode_slots must be >= 1, got {self.decode_slots}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.slo not in SLO_MODES:
            raise ValueError(f"slo {self.slo!r} not in {SLO_MODES}")
        if self.admission not in ADMISSIONS:
            raise ValueError(
                f"admission {self.admission!r} not in {ADMISSIONS}")
        if self.attention not in ATTENTIONS:
            raise ValueError(
                f"attention {self.attention!r} not in {ATTENTIONS}")
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k must be >= 0 (0 = speculation off), got "
                f"{self.speculate_k}")
        if self.draft_layers < 0:
            raise ValueError(
                f"draft_layers must be >= 0 (0 = auto: half the "
                f"target's depth), got {self.draft_layers}")
        if self.draft_layers > 0 and self.speculate_k == 0:
            raise ValueError(
                f"draft_layers={self.draft_layers} without "
                "speculate_k — the draft only exists to propose "
                "speculative tokens (set speculate_k >= 1)")
        if self.default_ttl is not None and self.default_ttl <= 0:
            raise ValueError(
                f"default_ttl must be > 0 seconds (or None), got "
                f"{self.default_ttl}")
        if self.mesh is not None:
            raise NotImplementedError(
                f"ServeConfig.mesh={self.mesh!r} is not ported yet; it "
                "comes with ROADMAP.md Queue 1, parallelism (TP-sharded "
                "paged decode)")

    @property
    def in_flight_limit(self) -> int:
        """Admitted-requests cap: ``decode_slots`` + the one prefill
        lane by default, so a prefill can always start while every slot
        decodes."""
        return self.max_in_flight if self.max_in_flight > 0 \
            else self.decode_slots + 1
