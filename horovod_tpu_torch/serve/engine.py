"""Continuous-batching serving engine: one fixed-shape step per iteration.

The port of ``horovod_tpu.serve.engine`` (Orca's iteration-level
batching over a paged KV cache). Every engine step runs
``decode_slots`` single-token decode lanes plus one ``prefill_chunk``-
token chunked-prefill lane, so requests join and leave the running batch
between steps:

* each decode slot attends its single query against its paged cache.
  ``ServeConfig.attention="gather"`` (the default and exactness
  reference) reconstructs the logical cache ``[Lmax, H, D]`` out of the
  page tensors through the request's page table, inserts the step's new
  K/V row, attends with ``q_offset = t`` (the cache mask, exactly
  :func:`models.parallel_lm.lm_decode_step`'s spelling), and then writes
  the new row into its page; ``"paged"`` writes the row FIRST and reads
  only the slot's ``ceil((t+1)/page_size)`` live pages through the
  paged-attention kernel (:func:`~horovod_tpu_torch.ops.paged_attention.
  paged_attention_decode`), so the dense intermediate never exists;
* the prefill lane runs one chunk of the current prompt through the
  rectangular-causal path — queries at global positions
  ``start..start+C-1`` over the full gathered cache with
  ``q_offset=start, k_offset=0`` — writing its K/V rows through the
  page table. It runs before the decode lane, so its pages are written
  before the decode lane reads them.

Both lanes use ``parallel_lm``'s layer functions and masked softmax
terms are exactly zero, so the greedy token stream equals ``lm_decode``'s
per request, and the JAX engine's (tests/test_torch_serve_engine.py).

**Pages are updated in place.** The JAX engine threads the page arrays
through its compiled step functionally and never donates them. The port
writes new rows straight into the page tensors on one CUDA stream:
nothing else reads a page while the step runs, and
:meth:`ServeEngine._cow_guard` copies any shared page a step would
write before the step starts. Unmapped table entries gather the null
page 0, which the masks hide downstream: its rows are finite (zeros, or
idle slots' rows, below) and a masked softmax weight is exactly 0.

**The decode lane has one shape.** Every step with a live decode slot
runs all ``decode_slots`` slots (:func:`decode_lane`), as the JAX step
does: an idle slot computes a row that the host discards and writes its
K/V row into page 0, the reserved null sink (the port's form of the JAX
lane's out-of-bounds ``mode="drop"`` write: torch indexing has no drop
mode, and page 0 is never allocated, so no idle write lands on a live
row). Its host inputs travel as one packed int32 index
(:func:`pack_decode`) in one host-to-device copy a step into a fixed
device buffer, so on the card the engine captures the lane once into a
CUDA graph (``capture=True``, the default: the counterpart of the JAX
engine's jitted ``_step_decode``) and replays it every step; the
sampler's device-to-host copy stays outside the graph. The prefill lane
stays eager: its chunk start is a host integer and the rows it writes
are chosen on the host (ROADMAP.md Queue 1 lists its capture). Rows
that the JAX prefill lane drops (padded rows) are never written: the
host selects the rows to write.

A step with no live decode slot skips the decode lane (the JAX step
computes it anyway on fixed shapes and discards it), so the kernel runs
once per layer per step that has a live slot.

Tensor-parallel serving, speculative decoding, the disaggregated
handoff bay and prefix caching come with later slices (ROADMAP.md,
Queue 1, what is left, items 2-3).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch._graphs import CapturedStep
from horovod_tpu_torch.models.parallel_lm import (
    _attn_out_residual,
    _ffn_residual,
    _logits,
    _project_qkv,
    params_to,
)
from horovod_tpu_torch.ops.attention import dot_product_attention
from horovod_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_grid_info,
)
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.kvcache import PagedKVCache, append_rows
from horovod_tpu_torch.serve.metrics import summarize
from horovod_tpu_torch.serve.sampling import sample_tokens
from horovod_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    Scheduler,
    make_request,
    pick_victim,
)

# --------------------------------------------------------------------------
# The step (functions of tensors; host index data arrives as numpy).


def _gather_cache_kv(pk, pv, table):
    """The K and V gathers of one lane through one shared row index:
    pages ``[P, ps, H, D]`` x table ``[..., pps]`` -> ``(k, v)`` of shape
    ``[..., Lmax, H, D]`` (copies; unmapped entries read the null page
    0's zeros, always masked downstream)."""
    P, ps, H, D = pk.shape
    rows = (table.long()[..., :, None] * ps
            + torch.arange(ps, device=table.device)).reshape(
                *table.shape[:-1], -1)
    return pk.reshape(P * ps, H, D)[rows], pv.reshape(P * ps, H, D)[rows]


def _prefill_lane(params: Dict, pages, pre, *, page_size: int):
    """The chunked-prefill pass of one step: one rectangular-causal chunk
    (queries at ``start..start+C-1`` over the full gathered cache,
    ``q_offset=start, k_offset=0``) whose valid K/V rows are written in
    place through the page table. ``pre`` holds host arrays:
    ``tokens`` [C], ``start``, ``length`` and ``table`` [pps]. Returns
    the logits ``[V]`` of the chunk's last valid row."""
    dev = params["pos"].device
    ps = page_size
    num_pages = pages[0]["k"].shape[0]
    tokens = np.asarray(pre["tokens"])
    C = tokens.shape[0]
    start, length = int(pre["start"]), int(pre["length"])
    table = np.asarray(pre["table"], np.int32)
    write_page, write_off, safe_pos = append_rows(
        table, start, C, page_size=ps, num_pages=num_pages,
        valid=np.arange(C) < length)
    ok = np.nonzero(write_page < num_pages)[0]      # rows to write

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    ok_t, ins_t = on_dev(ok), on_dev(safe_pos[ok])
    wp_t, wo_t = on_dev(write_page[ok]), on_dev(write_off[ok])
    table_t = on_dev(table)
    xp = (params["embed"][on_dev(tokens)][None]
          + params["pos"][on_dev(safe_pos)][None])  # [1, C, E]
    for layer, page in zip(params["layers"], pages):
        pk, pv = page["k"], page["v"]
        qp, kp, vp = _project_qkv(layer, xp)         # [1, C, H, D]
        scale = 1.0 / math.sqrt(qp.shape[-1])
        # The chunk's own rows enter the gathered copy, then queries at
        # start+i attend keys 0..start+i.
        ck, cv = _gather_cache_kv(pk, pv, table_t)
        ck[ins_t] = kp[0, ok_t]
        cv[ins_t] = vp[0, ok_t]
        attn = dot_product_attention(qp, ck[None], cv[None], causal=True,
                                     scale=scale, q_offset=start,
                                     k_offset=0)
        xp = _attn_out_residual(layer, attn, xp)
        xp = _ffn_residual(layer, xp)
        pk[wp_t, wo_t] = kp[0, ok_t]
        pv[wp_t, wo_t] = vp[0, ok_t]
    last = min(max(length - 1, 0), C - 1)
    return _logits(params, xp[:, last:last + 1])[0, 0]


#: Rows of the packed decode index after the ``[S, pps]`` page tables:
#: token, position, live keys (t + 1; 0 = idle), write page, write offset.
_DEC_ROWS = 5


def pack_decode(dec, page_size: int) -> np.ndarray:
    """The decode lane's host inputs as one flat int32 array, the layout
    :func:`decode_lane` reads: the page tables ``[S, pps]``, then rows of
    ``S`` for the token, the position, the live keys and the page and
    offset the new K/V row is written to. An idle slot (``active``
    False) writes page 0, offset 0: the reserved null sink that is never
    allocated, read only through masked or empty table entries, so the
    duplicate writes of idle slots change no live row (the port's form of
    the JAX lane's out-of-bounds ``mode="drop"`` write)."""
    active = np.asarray(dec["active"], bool)
    pos = np.asarray(dec["pos"], np.int64)
    tables = np.asarray(dec["tables"], np.int32)
    S, pps = tables.shape
    slots = np.arange(S)
    rows = np.stack([
        np.asarray(dec["tok"], np.int64), pos,
        np.where(active, pos + 1, 0),
        np.where(active, tables[slots, np.minimum(pos // page_size,
                                                  pps - 1)], 0),
        np.where(active, pos % page_size, 0)])
    return np.concatenate([tables.reshape(-1),
                           rows.astype(np.int32).reshape(-1)])


def decode_lane(params: Dict, pages, index, *, slots: int, page_size: int,
                attention: str = "gather"):
    """The decode lane of one step at a fixed shape: all ``slots`` slots
    run and write their new K/V row (idle ones into the null page), from
    the packed device index of :func:`pack_decode`; returns the logits
    ``[S, V]``. Nothing in it reads a value on the host, so on the card
    the engine captures it into a CUDA graph once and replays it.

    ``attention`` picks the cache path: ``gather`` reconstructs the dense
    per-slot cache and inserts the new row into the gathered copy;
    ``paged`` writes the new row into its page first and reads only the
    live pages through
    :func:`~horovod_tpu_torch.ops.paged_attention.paged_attention_decode`.
    """
    S = slots
    pps = index.numel() // S - _DEC_ROWS
    tables = index[:S * pps].view(S, pps)
    cols = index[S * pps:].view(_DEC_ROWS, S)
    lens = cols[2]                                    # int32 [S]
    tok, t, _, wp, wo = cols.long()
    slot_ids = torch.arange(S, device=index.device)
    xd = params["embed"][tok][:, None] + params["pos"][t][:, None]

    for layer, page in zip(params["layers"], pages):
        pk, pv = page["k"], page["v"]
        qd, kd, vd = _project_qkv(layer, xd)          # [S, 1, H, D]
        scale = 1.0 / math.sqrt(qd.shape[-1])
        if attention == "paged":
            # Write the new row first; the kernel reads position t back
            # from its page and is read-only over the pages.
            pk[wp, wo] = kd[:, 0]
            pv[wp, wo] = vd[:, 0]
            attn = paged_attention_decode(
                qd[:, 0].contiguous(), pk, pv, tables, lens,
                scale=scale)[:, None]                 # [S, 1, H, D]
        else:
            ck, cv = _gather_cache_kv(pk, pv, tables)  # [S, Lmax, H, D]
            ck[slot_ids, t] = kd[:, 0]
            cv[slot_ids, t] = vd[:, 0]
            attn = dot_product_attention(qd, ck, cv, causal=True,
                                         scale=scale, q_offset=t)
        xd = _attn_out_residual(layer, attn, xd)
        xd = _ffn_residual(layer, xd)
        if attention != "paged":
            pk[wp, wo] = kd[:, 0]
            pv[wp, wo] = vd[:, 0]
    return _logits(params, xd)[:, 0]


# --------------------------------------------------------------------------
# The host-side engine.


class ServeEngine:
    """Continuous-batching LM serving over a paged KV cache.

    ``params`` is :func:`models.parallel_lm.init_lm_params`' dict; it is
    moved to ``device`` (``None`` = the card; without a CUDA device that
    raises, pass ``device="cpu"`` for the CPU). The engine owns the page
    tensors, the scheduler, and the request lifecycle: :meth:`submit`
    queues work, :meth:`step` runs one step (False when fully idle),
    :meth:`run` drains to idle. ``clock`` is injectable for
    deterministic tests. With ``capture`` (the default) the decode lane
    runs on the card as a CUDA graph replay (:attr:`decode_graph`);
    ``capture=False`` runs it eagerly, for an A/B against the replay.
    """

    def __init__(self, params: Dict, config: ServeConfig, *,
                 chips: int = 1, clock=time.perf_counter,
                 device: DeviceLike = None, capture: bool = True):
        self.device = resolve_device(device)
        self.config = config
        self.chips = chips
        self.clock = clock
        self._set_params(params)
        self.cache = PagedKVCache(self.params, config)
        self.scheduler = Scheduler(self.cache, config)
        # The decode lane's inputs: one packed int32 index (pack_decode),
        # filled on the host (pinned memory on the card) and moved by one
        # copy a step into a fixed device buffer that the lane reads.
        S, pps = config.decode_slots, self.cache.pages_per_seq
        n = S * (pps + _DEC_ROWS)
        self._index_host = torch.zeros(
            n, dtype=torch.int32, pin_memory=self.device.type == "cuda")
        self._index = (self._index_host if self.device.type == "cpu"
                       else torch.zeros(n, dtype=torch.int32,
                                        device=self.device))
        #: The decode lane as a CUDA graph captured once per shape and
        #: weights (``capture=True`` on the card: the counterpart of the
        #: JAX engine's jitted decode step), else None: the lane runs
        #: eagerly (the CPU, or ``capture=False``, the counterpart of
        #: running the JAX engine under ``jax.disable_jit()``).
        self.decode_graph = (CapturedStep(
            self._decode_lane, device=self.device, key=self._decode_key,
            name="decode lane")
            if capture and self.device.type == "cuda" else None)
        #: Copy-on-write page copies performed (the backstop — 0 in
        #: normal operation; see :meth:`_cow_guard`).
        self.cow_copies = 0
        self.slots: List[Optional[Request]] = [None] * config.decode_slots
        self.ready: List[Request] = []      # prefilled, awaiting a slot
        self.prefilling: Optional[Request] = None
        self.finished: List[Request] = []
        self.evicted: List[Request] = []    # terminal (requeue off)
        self.timed_out: List[Request] = []  # terminal (deadline passed)
        self.occupancy_samples: List[float] = []
        #: Per-step decode-lane live-key counts (t+1 per slot, 0 = idle
        #: lane), the input of :meth:`attention_stats`.
        self.attn_len_samples: List[List[int]] = []
        self.steps = 0
        self._t_start = clock()

    # ------------------------------------------------------ submission

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_token: Optional[int] = None, seed: int = 0,
               arrival: Optional[float] = None,
               ttl: Optional[float] = None) -> Request:
        """Queue one generation request; returns it (check ``state`` —
        ``rejected`` means it can never run or the queue is full)."""
        req = make_request(self.config, self.clock, prompt,
                           max_new_tokens, temperature=temperature,
                           top_k=top_k, eos_token=eos_token, seed=seed,
                           arrival=arrival, ttl=ttl)
        self.scheduler.submit(req)
        return req

    # ------------------------------------------------------- lifecycle

    @property
    def in_flight(self) -> int:
        return (sum(1 for s in self.slots if s is not None)
                + len(self.ready) + (1 if self.prefilling else 0))

    @property
    def idle(self) -> bool:
        return self.in_flight == 0 and not self.scheduler.queue

    def _free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def _finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.t_finish = self.clock()
        self.scheduler.release(req)
        self.finished.append(req)

    def _do_evict(self, victim: Request) -> None:
        """Release a victim's pages and remove it from service; requeue
        (recompute path) or terminate per config."""
        self._remove_from_service(victim)
        victim.evictions += 1
        victim.state = RequestState.EVICTED
        if self.config.requeue_evicted:
            if not self.scheduler.requeue(victim):
                self._finish(victim)
        else:
            self.evicted.append(victim)

    def _remove_from_service(self, req: Request) -> None:
        """Release the request's pages and detach it from slots, ready
        and the prefill lane."""
        self.scheduler.release(req)
        for i, s in enumerate(self.slots):
            if s is req:
                self.slots[i] = None
        self.ready = [r for r in self.ready if r is not req]
        if self.prefilling is req:
            self.prefilling = None

    def _time_out(self, req: Request, now: float) -> None:
        """Deadline epilogue: remove from service, mark terminal (no
        requeue — the client's latency budget is already blown)."""
        self._remove_from_service(req)
        self.scheduler.drop(req)
        req.state = RequestState.TIMEOUT
        req.t_finish = now
        self.timed_out.append(req)

    def _expire_deadlines(self) -> None:
        """Sweep every live request (queued included) at the top of each
        step."""
        now = self.clock()
        live = ([s for s in self.slots if s is not None]
                + list(self.ready)
                + ([self.prefilling] if self.prefilling else [])
                + list(self.scheduler.queue))
        for req in live:
            if req.expired(now):
                self._time_out(req, now)

    def _evict_for(self, requester: Request) -> bool:
        """Lazy-mode page pressure: evict the newest-admitted request
        that is not the requester. False = nothing else to evict."""
        candidates = [s for s in self.slots if s is not None] + \
            list(self.ready)
        victim = pick_victim(candidates, requester)
        if victim is None:
            return False
        self._do_evict(victim)
        return True

    # ------------------------------------------------------------ step

    def _promote_ready(self) -> None:
        for i in range(len(self.slots)):
            if self.slots[i] is None and self.ready:
                req = self.ready.pop(0)
                req.state = RequestState.DECODE
                self.slots[i] = req

    def _ensure_capacity(self) -> None:
        """Lazy admission: map pages for every position this step
        writes, evicting under pressure (reserve mode pre-granted the
        worst case)."""
        if self.config.admission != "lazy":
            return
        for req in list(self.slots):
            if req is None or req not in self.slots:
                continue
            if not self.scheduler.ensure_pages(req, req.next_pos,
                                               self._evict_for):
                self._do_evict(req)
        if self.prefilling is not None:
            req = self.prefilling
            chunk = min(self.config.prefill_chunk,
                        req.prompt_len - req.prefill_pos)
            last = req.prefill_pos + chunk - 1
            if not self.scheduler.ensure_pages(req, last,
                                               self._evict_for):
                self._do_evict(req)

    def _cow_guard(self) -> None:
        """Copy-on-write backstop for the in-place step: no page this
        step WRITES may be shared. Without prefix caching no page ever
        is, so this finds nothing; any slip becomes one counted page copy
        (``cow_copies``) instead of a corrupted stream of another
        holder."""
        for req in self.slots:
            if req is not None and req.generated:
                self._cow_range(req, req.next_pos, req.next_pos)
        if self.prefilling is not None:
            req = self.prefilling
            chunk = min(self.config.prefill_chunk,
                        req.prompt_len - req.prefill_pos)
            self._cow_range(req, req.prefill_pos,
                            req.prefill_pos + chunk - 1)

    def _cow_range(self, req: Request, first_pos: int, last_pos: int
                   ) -> None:
        ps = self.config.page_size
        for slot in range(first_pos // ps, last_pos // ps + 1):
            page = int(req.page_table[slot])
            if page and self.cache.allocator.is_shared(page):
                new = self.cache.cow_page(page)
                req.page_table[slot] = new
                req.pages[req.pages.index(page)] = new
                self.cow_copies += 1

    def _build_dec(self):
        S = self.config.decode_slots
        pps = self.cache.pages_per_seq
        tok = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        tables = np.zeros((S, pps), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok[i] = req.generated[-1]
            pos[i] = req.next_pos
            active[i] = True
            tables[i] = req.page_table
        return {"tok": tok, "pos": pos, "active": active,
                "tables": tables}

    def _build_pre(self):
        if self.prefilling is None:
            return None, 0
        req = self.prefilling
        C = self.config.prefill_chunk
        chunk = min(C, req.prompt_len - req.prefill_pos)
        tokens = np.zeros((C,), np.int32)
        tokens[:chunk] = req.prompt[req.prefill_pos:
                                    req.prefill_pos + chunk]
        return {
            "tokens": tokens,
            "start": req.prefill_pos,
            "length": chunk,
            "table": np.asarray(req.page_table, np.int32),
        }, chunk

    def step(self) -> bool:
        """Run one step; False when there was nothing to do (no active
        requests and nothing admissible in the queue)."""
        self._expire_deadlines()
        self._promote_ready()
        if self.prefilling is None:
            self.prefilling = self.scheduler.pick_prefill(
                self._free_slots(), self.in_flight)
            if self.prefilling is not None:
                # (Re-)admission stamp — pick_victim keys on it.
                self.prefilling.t_admit = self.clock()
        self._ensure_capacity()
        # Eviction may have freed slots: promote, then re-map pages for
        # the newly promoted rows (a promoted request must never reach
        # the step with an unmapped table entry where it writes).
        while self.ready and any(s is None for s in self.slots):
            self._promote_ready()
            self._ensure_capacity()
        if self.prefilling is None and \
                all(s is None for s in self.slots):
            return False

        self._cow_guard()
        dec = self._build_dec()
        pre, chunk = self._build_pre()
        self.attn_len_samples.append(
            [0 if r is None else r.next_pos + 1 for r in self.slots])

        S = self.config.decode_slots
        pre_done = (self.prefilling is not None and
                    self.prefilling.prefill_pos + chunk
                    >= self.prefilling.prompt_len)
        with torch.no_grad():
            # The prefill lane first: its pages are written before the
            # decode lane reads them.
            pre_logits = (None if pre is None else _prefill_lane(
                self.params, self.cache.pages, pre,
                page_size=self.config.page_size))
            dec_logits = None
            if dec["active"].any():
                self._index_host.numpy()[:] = pack_decode(
                    dec, self.config.page_size)
                if self._index is not self._index_host:
                    # The previous step's copy is done: its tokens came
                    # back to the host after it.
                    self._index.copy_(self._index_host, non_blocking=True)
                dec_logits = (self.decode_graph() if self.decode_graph
                              else self._decode_lane())

        # One sampler call covers the live decode slots + the prefill
        # lane.
        rows: List[Optional[Request]] = []
        parts = []
        if dec_logits is not None:
            rows += self.slots
            parts.append(dec_logits)
        if pre_logits is not None:
            rows.append(self.prefilling if pre_done else None)
            parts.append(pre_logits[None])
        n = len(rows)
        temp = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        seeds = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int64)
        for i, req in enumerate(rows):
            if req is None:
                continue
            temp[i] = req.temperature
            topk[i] = req.top_k
            seeds[i] = req.seed
            positions[i] = req.sample_index
        tokens = sample_tokens(torch.cat(parts) if len(parts) > 1
                               else parts[0], temp, topk, seeds, positions)
        now = self.clock()      # after the device-to-host copy: a sync
        pre_token = (int(tokens[-1]) if pre_logits is not None and pre_done
                     else None)

        if dec_logits is not None:
            for i in range(S):
                req = self.slots[i]
                if req is None:
                    continue
                self._accept_token(req, int(tokens[i]), now)
                if req.state == RequestState.FINISHED:
                    self.slots[i] = None

        # Prefill lane: advance; on completion emit the FIRST token.
        if self.prefilling is not None and pre is not None:
            req = self.prefilling
            req.prefill_pos += chunk
            if pre_done:
                self._accept_token(req, pre_token, now)
                self.prefilling = None
                if req.state != RequestState.FINISHED:
                    req.state = RequestState.DECODE
                    self.ready.append(req)

        self.occupancy_samples.append(self.cache.occupancy())
        self.steps += 1
        return True

    def _accept_token(self, req: Request, token: int, now: float
                      ) -> None:
        req.generated.append(token)
        req.output.append(token)
        if req.t_first_token is None:
            req.t_first_token = now
        req.token_times.append(now)
        if req.done_generating or req.hit_eos(self.config.eos_token):
            self._finish(req)

    def _decode_lane(self):
        return decode_lane(self.params, self.cache.pages, self._index,
                           slots=self.config.decode_slots,
                           page_size=self.config.page_size,
                           attention=self.config.attention)

    def _decode_key(self):
        """The captured decode lane's signature beyond its (argument-free)
        call: the attention mode and the weights it reads (a swap by
        :meth:`update_params` captures again)."""
        return self.config.attention, self._weights

    def _set_params(self, params: Dict) -> None:
        self.params = params_to(params, self.device)
        self._weights = tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                              for p in tree_leaves(self.params))

    def update_params(self, params: Dict) -> None:
        """Swap the model weights. Only valid when IDLE (a live
        request's decode must never mix weights mid-stream); the
        geometry must match. A captured decode lane is captured again
        over the new weights at its next step."""
        if not self.idle:
            raise RuntimeError(
                "update_params with requests in flight — drain the "
                "engine first")
        old, new = self.params["pos"].shape, params["pos"].shape
        if tuple(old) != tuple(new):
            raise ValueError(
                f"update_params geometry mismatch: position table "
                f"{tuple(new)} vs the engine's {tuple(old)} — a "
                "geometry change needs a fresh engine, not a weight "
                "swap")
        self._set_params(params)

    # ------------------------------------------------------------- run

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain to idle (or ``max_steps``); returns requests finished
        so far."""
        while not self.idle:
            if max_steps is not None and self.steps >= max_steps:
                break
            if not self.step():
                break   # queue non-empty but nothing admissible
        return self.finished

    def reset_metrics(self) -> None:
        """Drop completed-work bookkeeping (warm up, then measure from a
        clean slate). Only valid when idle."""
        if not self.idle:
            raise RuntimeError("reset_metrics with requests in flight")
        self.finished = []
        self.evicted = []
        self.timed_out = []
        self.scheduler.rejected = []
        self.occupancy_samples = []
        self.attn_len_samples = []
        self.steps = 0
        self.cow_copies = 0
        self._t_start = self.clock()

    def stats(self) -> Dict:
        """Aggregate SLO metrics over every request seen so far."""
        everything = (self.finished + self.evicted + self.timed_out
                      + self.ready
                      + [s for s in self.slots if s is not None]
                      + ([self.prefilling] if self.prefilling else [])
                      + self.scheduler.queue + self.scheduler.rejected)
        out = summarize(everything, self.clock() - self._t_start,
                        self.chips, self.occupancy_samples)
        out["attention"] = self.attention_stats()
        return out

    def step_grid_info(self, lengths: List[int]) -> Dict:
        """One step's static decode-traffic accounting —
        :func:`ops.paged_attention.paged_grid_info` over this engine's
        cache geometry."""
        c = self.cache
        return paged_grid_info(
            lengths, page_size=self.config.page_size,
            pages_per_seq=c.pages_per_seq, num_heads=c.num_heads,
            head_dim=c.head_dim, dtype_bytes=c.dtype_bytes,
            num_layers=c.num_layers)

    def attention_stats(self) -> Dict:
        """Decode-lane K/V traffic accounting over the run: what the
        paged kernel reads (live pages per slot) vs what the gather path
        reconstructs (``Lmax/page_size`` pages per slot, every slot every
        step). Stamped on both modes; the prefill lane is excluded."""
        infos = [self.step_grid_info(s) for s in self.attn_len_samples]
        n = len(infos)
        total_live = sum(i["pages_live_total"] for i in infos)
        total_paged = sum(i["kv_bytes"] for i in infos)
        total_gather = sum(i["kv_bytes_gather"] for i in infos)
        # One card holds every head: per-chip bytes are this mode's total.
        total_chip = (total_paged if self.config.attention == "paged"
                      else total_gather)
        return {
            "mode": self.config.attention,
            "decode_steps": n,
            "page_size": self.config.page_size,
            "pages_per_seq": self.cache.pages_per_seq,
            "pages_live_per_step_mean":
                round(total_live / n, 2) if n else None,
            "pages_full_per_step":
                self.config.decode_slots * self.cache.pages_per_seq,
            "kv_bytes_per_step_paged":
                round(total_paged / n, 1) if n else None,
            "kv_bytes_per_step_gather":
                total_gather // n if n else None,
            "kv_fetch_frac":
                round(total_paged / total_gather, 4) if n else None,
            "tp": 1,
            "kv_bytes_per_chip":
                round(total_chip / n, 1) if n else None,
        }
