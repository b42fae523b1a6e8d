"""Request lifecycle + the SLO-knobbed scheduler.

A host-only copy of ``horovod_tpu.serve.scheduler`` (the prefix-cache
hooks wait for the prefix-caching slice). The scheduler is pure host
bookkeeping between engine steps — it never touches device tensors. It
owns three decisions per step, each behind one
:class:`~horovod_tpu_torch.serve.config.ServeConfig` knob:

* **queue order** (``policy``): ``fcfs`` arrival order, or ``sjf``
  shortest-prompt-first;
* **prefill gate** (``slo``): when a NEW prefill may start —
  ``latency`` whenever the lane is idle, ``throughput`` only once a
  decode slot is free, ``balanced`` when a slot is free OR a backlog is
  building;
* **admission** (``admission``): ``reserve`` grants a request its
  worst-case pages up front, ``lazy`` grants pages as positions cross
  page boundaries and evicts (newest-admitted-first) on exhaustion.

Lifecycle (:class:`RequestState`)::

    QUEUED -> PREFILL -> DECODE -> FINISHED
        \\-> REJECTED      \\-> EVICTED (-> QUEUED again when
                                         ``requeue_evicted``)

A request that is evicted and requeued carries its generated tokens as
prompt extension (the recompute path); greedy decoding makes the
recomputation bit-identical, and the position-seeded sampling
(:mod:`~horovod_tpu_torch.serve.sampling`) makes temperature>0 requests
resume their exact token stream too.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.kvcache import OutOfPages, PagedKVCache


class RequestState:
    """Lifecycle states (plain str constants — they stamp into JSON)."""

    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    EVICTED = "evicted"
    REJECTED = "rejected"
    #: Deadline exceeded: finished early with whatever was generated,
    #: pages freed. Terminal, like FINISHED.
    TIMEOUT = "timeout"


_rid_counter = itertools.count()


@dataclasses.dataclass(eq=False)   # identity semantics: requests are
class Request:                     # tracked by `is` in slot lists
    """One in-flight generation request + its measurement trail.

    ``prompt`` is the CURRENT prompt (original prompt plus any
    pre-eviction generated tokens on a requeue); ``output`` accumulates
    every generated token across evictions."""

    prompt: np.ndarray                   # int32 [Lp]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_token: Optional[int] = None
    seed: int = 0
    arrival: float = 0.0
    #: Deadline in seconds from arrival (None = none).
    ttl: Optional[float] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    #: why a REJECTED request was rejected: ``"infeasible"`` or
    #: ``"overloaded"``.
    reject_reason: Optional[str] = None
    #: params version this request's decode is pinned to (None = any).
    version: Optional[int] = None
    #: times this request restarted from its original prompt.
    version_restarts: int = 0

    state: str = RequestState.QUEUED
    #: prompt tokens already prefilled (chunk progress).
    prefill_pos: int = 0
    #: tokens generated since the last (re)admission.
    generated: List[int] = dataclasses.field(default_factory=list)
    #: all tokens generated across evictions — the user-visible output.
    output: List[int] = dataclasses.field(default_factory=list)
    #: logical->physical page table, length cache.pages_per_seq,
    #: 0 (the null page) = unmapped.
    page_table: Optional[np.ndarray] = None
    #: physical pages held (the allocator's grant).
    pages: List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0
    #: set by Scheduler.requeue — keeps the head-of-queue priority of
    #: an evicted request visible to the sjf sort.
    requeued: bool = False
    #: original request sizes (requeues mutate prompt/max_new_tokens).
    orig_prompt_len: int = 0
    orig_max_new: int = 0

    # -- measurement trail (clock() stamps, engine-filled) ------------
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.ttl is not None and self.ttl <= 0:
            raise ValueError(f"ttl must be > 0 seconds (or None), got "
                             f"{self.ttl}")
        if not self.orig_prompt_len:
            self.orig_prompt_len = int(self.prompt.size)
        if not self.orig_max_new:
            self.orig_max_new = int(self.max_new_tokens)

    # ------------------------------------------------------ positions

    @property
    def deadline(self) -> Optional[float]:
        """Absolute clock time past which the request times out."""
        return None if self.ttl is None else self.arrival + self.ttl

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def next_pos(self) -> int:
        """Absolute cache position the next decode step writes (the
        position of the token being fed back)."""
        return self.prompt_len + len(self.generated) - 1

    @property
    def sample_index(self) -> int:
        """0-based index (within the FULL generation) of the token the
        next sample produces — the sampling seed's position, stable
        across evictions/recomputes."""
        return self.orig_prompt_len + len(self.output)

    @property
    def done_generating(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def hit_eos(self, default_eos: Optional[int]) -> bool:
        eos = self.eos_token if self.eos_token is not None else default_eos
        return bool(self.generated) and eos is not None \
            and self.generated[-1] == eos


class Scheduler:
    """Queue + admission + the prefill gate over one
    :class:`~horovod_tpu_torch.serve.kvcache.PagedKVCache`."""

    def __init__(self, cache: PagedKVCache, config: ServeConfig):
        self.cache = cache
        self.config = config
        self.queue: List[Request] = []
        self.rejected: List[Request] = []

    # ------------------------------------------------------ submission

    def submit(self, req: Request) -> bool:
        """Queue a request; False = hard-rejected (can never run, or
        the bounded queue is full). Rejection is terminal."""
        c = self.config
        if not self.cache.fits(req.prompt_len, req.max_new_tokens):
            req.state = RequestState.REJECTED
            req.reject_reason = "infeasible"
            self.rejected.append(req)
            return False
        if c.max_queue and len(self.queue) >= c.max_queue:
            req.state = RequestState.REJECTED
            req.reject_reason = "overloaded"
            self.rejected.append(req)
            return False
        req.state = RequestState.QUEUED
        self.queue.append(req)
        return True

    def requeue(self, req: Request) -> bool:
        """Re-admit an evicted request: its generated tokens extend the
        prompt (recompute path) and its budget shrinks accordingly."""
        if not rebase_for_recompute(req):
            req.state = RequestState.FINISHED
            return False
        # Head of the queue: an evicted request already consumed
        # service and holds its requester's latency budget.
        req.state = RequestState.QUEUED
        req.requeued = True
        self.queue.insert(0, req)
        return True

    # ------------------------------------------------------- ordering

    def _order(self):
        if self.config.policy == "sjf":
            # Stable sort; evicted requeues rank first regardless of
            # their (grown) prompt length.
            self.queue.sort(
                key=lambda r: (0 if r.requeued else 1, r.prompt_len))

    # --------------------------------------------------------- gating

    def prefill_gate(self, free_slots: int) -> bool:
        """May a NEW prefill start this step? (The SLO knob.)"""
        slo = self.config.slo
        if slo == "latency":
            return True
        if slo == "throughput":
            return free_slots > 0
        return free_slots > 0 or len(self.queue) >= 2   # balanced

    def pick_prefill(self, free_slots: int, in_flight: int) -> \
            Optional[Request]:
        """Pop the next request to start prefilling, or None. Applies
        the in-flight limit, the SLO gate, queue policy, and admission
        control (reserve: the worst case must be allocatable NOW — the
        queue head WAITS; lazy: one page is enough to start)."""
        if not self.queue or in_flight >= self.config.in_flight_limit \
                or not self.prefill_gate(free_slots):
            return None
        self._order()
        req = self.queue[0]
        if not self._admit(req):
            return None
        self.queue.pop(0)
        req.state = RequestState.PREFILL
        return req

    # ------------------------------------------------------ admission

    def _admit(self, req: Request) -> bool:
        if req.page_table is None:
            req.page_table = np.zeros(self.cache.pages_per_seq, np.int32)
        alloc = self.cache.allocator
        if self.config.admission == "reserve":
            need = self.cache.pages_needed(req.prompt_len,
                                           req.max_new_tokens)
            if need > alloc.available:
                return False
            grant = alloc.alloc(need)
        else:
            # lazy: map the first page only; grow via ensure_pages.
            if alloc.available < 1:
                return False
            grant = alloc.alloc(1)
        req.pages.extend(grant)
        req.page_table[:len(grant)] = np.asarray(grant, np.int32)
        return True

    def ensure_pages(self, req: Request, last_pos: int,
                     evict: Callable[[Request], bool]) -> bool:
        """Lazy-mode growth: map every page slot up to ``last_pos``.
        On exhaustion, calls ``evict(requester)`` until satisfied or
        evict() gives up. Returns False when the REQUESTER itself must be
        evicted. Reserve mode: no-op by construction."""
        need_slot = last_pos // self.cache.config.page_size
        for slot in range(need_slot + 1):
            if req.page_table[slot] != 0:
                continue
            while True:
                try:
                    req.page_table[slot] = page = \
                        self.cache.allocator.alloc(1)[0]
                    req.pages.append(page)
                    break
                except OutOfPages:
                    if not evict(req):
                        return False
        return True

    # -------------------------------------------------------- release

    def release(self, req: Request) -> None:
        """Drop the request's hold on every page it maps (finish OR
        evict) through the refcounted path."""
        if req.pages:
            self.cache.allocator.release(req.pages)
            req.pages = []
        if req.page_table is not None:
            req.page_table[:] = 0

    def drop(self, req: Request) -> None:
        """Remove a request from the queue (deadline timeout while
        waiting)."""
        self.queue = [r for r in self.queue if r is not req]


def make_request(config, clock, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_token=None, seed: int = 0, arrival=None,
                 ttl=None) -> Request:
    """Build one :class:`Request` with the config/clock defaulting:
    ``eos_token`` falls back to the config's, ``arrival`` to now,
    ``ttl`` to ``config.default_ttl``."""
    return Request(
        prompt=prompt, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k,
        eos_token=eos_token if eos_token is not None
        else config.eos_token,
        seed=seed,
        arrival=arrival if arrival is not None else clock(),
        ttl=ttl if ttl is not None else config.default_ttl)


def rebase_for_recompute(req: Request) -> bool:
    """Fold the generated-so-far tokens into the prompt — the recompute
    arithmetic of eviction-requeue: the prompt grows by the generated
    prefix, the budget shrinks by it, and prefill restarts from 0.
    ``output`` is untouched (tokens already emitted are never
    re-emitted) and ``sample_index`` stays position-stable. Returns
    False when nothing is left to generate."""
    if req.generated:
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        req.max_new_tokens -= len(req.generated)
        req.generated = []
    req.prefill_pos = 0
    return req.max_new_tokens >= 1


def restart_from_scratch(req: Request) -> None:
    """Restart a request from its original prompt with its full budget,
    its stream and measurement trail reset (the cross-version policy of
    the fleet)."""
    req.prompt = req.prompt[:req.orig_prompt_len]
    req.max_new_tokens = req.orig_max_new
    req.generated = []
    req.output = []
    req.prefill_pos = 0
    req.version = None
    req.version_restarts += 1
    req.t_first_token = None
    req.token_times = []


def pick_victim(candidates: Sequence[Request],
                requester: Request) -> Optional[Request]:
    """Lazy-mode eviction policy: newest-admitted-first (LIFO over
    ``t_admit``), never the requester if any other candidate exists.
    Returns None when the requester is the only candidate."""
    others = [r for r in candidates if r is not requester]
    if not others:
        return None
    return max(others, key=lambda r: (r.t_admit or 0.0, r.rid))
