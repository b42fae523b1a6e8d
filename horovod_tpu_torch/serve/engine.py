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

**Speculative decoding** (``ServeConfig.speculate_k`` = k > 0) replaces
the decode lane with :func:`spec_lane`, the counterpart of the JAX
``serve_step_spec`` without its prefill lane (which stays eager and runs
first, as above): a draft made of the target's first ``draft_layers``
layers proposes k tokens a slot in k single-token steps (in ``paged``
mode each step writes its row and reads the live pages through the
paged-attention kernel, ``draft_layers`` launches a step; in ``gather``
mode it runs over dense per-slot copies gathered once), then the target
verifies each slot's ``[last token, proposals]`` window of up to k+1
rows in one rectangular-causal pass over the gathered cache and writes
the window's K/V rows through the page table. The lane reads nothing on
the host, so the engine captures it exactly as it does the decode lane;
the draft's sampled proposals are drawn on the device
(:func:`~horovod_tpu_torch.serve.sampling.draft_sample_tokens`), and a
tick whose live slots are all greedy replays a second graph of the lane
that skips that draw (``spec_lane(sampled=False)``). The
host applies :func:`~horovod_tpu_torch.serve.sampling.
speculative_accept` per slot; greedy rows copy only the lane's argmaxes
to the host, never their logits. Rejected rows need no rollback: a stale
position is overwritten by a later window or hidden by the causal mask,
and :meth:`ServeEngine._cow_guard` copies any shared page under the
whole window first.

**Prefix caching** (``ServeConfig.prefix_caching``) puts a
:class:`~horovod_tpu_torch.serve.prefix.PrefixIndex` behind the
scheduler's admission: a prompt's already-filled whole pages are mapped
read-only and prefill starts at the first miss.

**The disaggregated handoff bay** (``FleetConfig.pools``): a request
admitted with ``prefill_only`` parks in :attr:`ServeEngine.handoff` when
its prefill completes (first token emitted, pages held) instead of
going to ``ready``. :meth:`ServeEngine.export_handoff` writes its pages
into an ``HVKV`` blob and :meth:`ServeEngine.release_handoff` drops them
once the decode side has committed; on the decode replica
:meth:`ServeEngine.admit_prefilled` imports the blob in place into the
page tensors and queues the request on ``ready`` in state DECODE. The
next step's slot promotion packs its table into the lane's index buffer
as it does for a locally prefilled request, so a captured decode lane
replays over the imported pages without a new capture.

**Tensor-parallel serving** (``ServeConfig.mesh``, e.g. ``"dp=1,tp=4"``,
over a ``torch.distributed`` world of that many ranks): heads, MLP
features and the vocab projection shard Megatron-style
(:func:`~horovod_tpu_torch.models.parallel_lm.lm_param_specs` with
``vocab_parallel``), each rank's page tensors hold its head shard
``[num_pages, page_size, H/tp, D]`` and its paged-attention kernel runs
over those ``H/tp`` heads, and every lane ends with the vocab all-gather
(:func:`~horovod_tpu_torch.parallel.tp.vocab_parallel_logits`), so every
rank holds the same full-vocab float32 rows. The JAX engine drives its
chips from one process; here each rank is a process, so the engine is a
controller and followers. Rank 0 of the tensor axis (the controller)
owns the control plane: the scheduler, the allocator, the prefix index,
sampling and stats (:meth:`ServeEngine.submit`, :meth:`~ServeEngine.step`,
:meth:`~ServeEngine.run`, :meth:`~ServeEngine.stats`). Every rank owns
its slice of the data plane. Each data-plane action is broadcast over
the tensor group first: a fixed int32 header (op and two arguments),
then the action's inputs. The actions are a step (the prefill chunk
packed as int32, the lane's packed index and the draft's temperatures),
a copy-on-write page copy, a weight swap (the dense weights, which every
rank cuts as at construction: :meth:`ServeEngine.update_params`), a page
export (the page ids; every rank returns its head shard of the pages'
tiles to the controller, which writes the blob in the full-head layout:
:meth:`ServeEngine.export_handoff`) and a page import (the ids the
controller's allocator granted and the blob's tiles; every rank writes
its own heads: :meth:`ServeEngine.admit_prefilled`). Page ids and the
allocator live on the controller only; a follower's cache is data only.
A follower (:meth:`ServeEngine.follow`) runs the same lane functions on
its shards until the controller's :meth:`ServeEngine.close`, so no rank
reads a page another rank's allocator placed differently.

Over an NCCL tensor group (one card a rank) ``capture=True`` captures
the lane on every rank: the ranks warm up and capture at the same step,
so the graphs hold the lane's collectives in one order, and a weight
swap captures again everywhere at the next step. gloo collectives cannot
be captured, so over a gloo group (ranks sharing a card, or the CPU) the
engine refuses ``capture=True``.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch._graphs import CapturedStep
from horovod_tpu_torch.common.exceptions import (InvalidArgumentError,
                                                 PreconditionError)
from horovod_tpu_torch.models.parallel_lm import (
    _attn_out_residual,
    _ffn_residual,
    _logits,
    _project_qkv,
    draft_params,
    lm_param_specs,
    params_to,
    shard_lm_params,
)
from horovod_tpu_torch.ops.attention import dot_product_attention
from horovod_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_grid_info,
)
from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.kvcache import PagedKVCache, append_rows
from horovod_tpu_torch.serve.metrics import summarize
from horovod_tpu_torch.serve.prefix import PrefixIndex
from horovod_tpu_torch.serve.sampling import (draft_sample_tokens,
                                              sample_tokens,
                                              speculative_accept)
from horovod_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    Scheduler,
    make_request,
    pick_victim,
)
from horovod_tpu_torch.serve.transport import FrameError

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


def _prefill_lane(params: Dict, pages, pre, *, page_size: int, tp=None,
                  vocab_parallel: bool = False):
    """The chunked-prefill pass of one step: one rectangular-causal chunk
    (queries at ``start..start+C-1`` over the full gathered cache,
    ``q_offset=start, k_offset=0``) whose valid K/V rows are written in
    place through the page table. ``pre`` holds host arrays:
    ``tokens`` [C], ``start``, ``length`` and ``table`` [pps]. Returns
    the logits ``[V]`` of the chunk's last valid row. ``tp`` names the
    tensor axis over head-sharded params and pages, and
    ``vocab_parallel`` gathers the full-vocab row from a column-sharded
    head, as in the JAX ``serve_step``."""
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
        qp, kp, vp = _project_qkv(layer, xp, tp)     # [1, C, H, D]
        scale = 1.0 / math.sqrt(qp.shape[-1])
        # The chunk's own rows enter the gathered copy, then queries at
        # start+i attend keys 0..start+i.
        ck, cv = _gather_cache_kv(pk, pv, table_t)
        ck[ins_t] = kp[0, ok_t]
        cv[ins_t] = vp[0, ok_t]
        attn = dot_product_attention(qp, ck[None], cv[None], causal=True,
                                     scale=scale, q_offset=start,
                                     k_offset=0)
        xp = _attn_out_residual(layer, attn, xp, tp)
        xp = _ffn_residual(layer, xp, tp)
        pk[wp_t, wo_t] = kp[0, ok_t]
        pv[wp_t, wo_t] = vp[0, ok_t]
    last = min(max(length - 1, 0), C - 1)
    return _logits(params, xp[:, last:last + 1], tp, vocab_parallel)[0, 0]


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
                attention: str = "gather", tp=None,
                vocab_parallel: bool = False):
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
    ``tp`` / ``vocab_parallel``: as in :func:`_prefill_lane` (the kernel
    then runs over the rank's ``H/tp`` heads).
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
        qd, kd, vd = _project_qkv(layer, xd, tp)      # [S, 1, H, D]
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
        xd = _attn_out_residual(layer, attn, xd, tp)
        xd = _ffn_residual(layer, xd, tp)
        if attention != "paged":
            pk[wp, wo] = kd[:, 0]
            pv[wp, wo] = vd[:, 0]
    return _logits(params, xd, tp, vocab_parallel)[:, 0]


#: Rows of the packed speculative index after :func:`pack_decode`'s: the
#: verify width (k_eff + 1; 0 = idle), and the draft's top-k, seed (its
#: low 32 bits) and output position of the first proposal.
_SPEC_ROWS = 4


def pack_spec(dec, page_size: int):
    """The speculative lane's host inputs: :func:`pack_decode`'s index
    extended by rows of ``S`` for ``width``, ``topk``, ``seed`` and
    ``sidx``, and the draft's float temperatures ``[S]`` as a second
    buffer. Returns ``(index int32, temps float32)``."""
    rows = np.stack([np.asarray(dec["width"], np.int64),
                     np.asarray(dec["topk"], np.int64),
                     np.asarray(dec["seed"], np.int64) & 0xFFFFFFFF,
                     np.asarray(dec["sidx"], np.int64)])
    index = np.concatenate([pack_decode(dec, page_size),
                            rows.astype(np.int32).reshape(-1)])
    return index, np.asarray(dec["temp"], np.float32)


def spec_lane(params: Dict, pages, index, temps, *, slots: int, k: int,
              draft_layers: int, page_size: int, attention: str = "gather",
              sampled: bool = True, tp=None, vocab_parallel: bool = False):
    """The speculative lane of one step at a fixed shape, from
    :func:`pack_spec`'s device buffers: a ``k``-step draft scan over the
    first ``draft_layers`` layers, then the target's verify pass over
    every slot's ``k+1``-row window. Returns ``(tokens [S, 2k+1] int32,
    ver_logits [S, k+1, V], draft_logits [S, k, V])``: ``tokens`` holds
    the verify rows' argmaxes, then the draft's proposals. Rows past a
    slot's width, and idle slots, compute values the host discards and
    write their K/V rows into the null page 0 only.

    ``attention`` shapes the draft scan: ``paged`` writes each draft row
    into its page (a masked row into page 0) and reads the live pages
    through :func:`~horovod_tpu_torch.ops.paged_attention.
    paged_attention_decode`, ``draft_layers x k`` launches; ``gather``
    gathers the dense per-slot caches once and inserts each step's row
    into those copies, which are discarded. The verify pass gathers in
    both modes, as the prefill lane does, and writes the rows that
    persist (every draft row included).

    ``sampled=False`` says that no live slot samples: the draft then
    takes its argmaxes and skips the sampled draw, whose masking and
    noise cover the whole vocabulary (the same proposals, since greedy
    rows take the argmax either way). ``tp`` / ``vocab_parallel``: as in
    :func:`_prefill_lane`; every rank then draws its proposals from the
    same full-vocab rows, so the ranks' caches stay in step."""
    S, ps = slots, page_size
    pps = index.numel() // S - _DEC_ROWS - _SPEC_ROWS
    lmax = pps * ps
    tables = index[:S * pps].view(S, pps)
    cols = index[S * pps:].view(_DEC_ROWS + _SPEC_ROWS, S)
    tok, t = cols[0].long(), cols[1].long()
    width, topk, seed, sidx = cols[_DEC_ROWS:]
    slot_ids = torch.arange(S, device=index.device)
    dlayers = draft_params(params, draft_layers)["layers"]
    if attention != "paged":
        copies = [_gather_cache_kv(p["k"], p["v"], tables)
                  for p in pages[:draft_layers]]

    # The draft scan: step i feeds c_i (c_0 = the last emitted token) at
    # position t+i and proposes c_{i+1}. A row is written only while a
    # later proposal of the window still attends it (i < k_eff).
    cur, draft_toks, draft_logits = tok, [], []
    for i in range(k):
        pos = t + i
        safe = pos.clamp(0, lmax - 1)
        x = params["embed"][cur][:, None] + params["pos"][safe][:, None]
        ok = (i + 1) < width
        wp = torch.where(ok, tables[slot_ids, safe // ps], 0).long()
        wo = torch.where(ok, safe % ps, 0)
        lens = torch.where(ok, pos + 1, 0).int()
        for j, layer in enumerate(dlayers):
            q, kk, vv = _project_qkv(layer, x, tp)      # [S, 1, H, D]
            scale = 1.0 / math.sqrt(q.shape[-1])
            if attention == "paged":
                pk, pv = pages[j]["k"], pages[j]["v"]
                pk[wp, wo] = kk[:, 0]
                pv[wp, wo] = vv[:, 0]
                attn = paged_attention_decode(
                    q[:, 0].contiguous(), pk, pv, tables, lens,
                    scale=scale)[:, None]
            else:
                ck, cv = copies[j]
                ck[slot_ids, safe] = kk[:, 0]
                cv[slot_ids, safe] = vv[:, 0]
                attn = dot_product_attention(q, ck, cv, causal=True,
                                             scale=scale, q_offset=safe)
            x = _attn_out_residual(layer, attn, x, tp)
            x = _ffn_residual(layer, x, tp)
        lg = _logits(params, x, tp, vocab_parallel)[:, 0]   # [S, V]
        cur = (draft_sample_tokens(lg, temps, topk, seed, sidx + i)
               if sampled else torch.argmax(lg.float(), dim=-1))
        draft_toks.append(cur)
        draft_logits.append(lg)
    draft_toks = torch.stack(draft_toks, 1)             # [S, k]

    # The verify pass: [last token, proposals] at t..t+k per slot, one
    # rectangular-causal pass. Rows past the width enter only the
    # gathered copy, at positions no valid query reaches (the causal
    # mask hides them), and write into the null page.
    rows = torch.arange(k + 1, device=index.device)
    pos_w = t[:, None] + rows                           # [S, w]
    safe_w = pos_w.clamp(0, lmax - 1)
    valid = (rows[None] < width[:, None]) & (pos_w < lmax)
    wp_w = torch.where(valid, tables.gather(1, safe_w // ps), 0).long()
    wo_w = torch.where(valid, safe_w % ps, 0)
    xw = (params["embed"][torch.cat([tok[:, None], draft_toks], 1)]
          + params["pos"][safe_w])                      # [S, w, E]
    for layer, page in zip(params["layers"], pages):
        pk, pv = page["k"], page["v"]
        qw, kw, vw = _project_qkv(layer, xw, tp)        # [S, w, H, D]
        scale = 1.0 / math.sqrt(qw.shape[-1])
        ck, cv = _gather_cache_kv(pk, pv, tables)       # [S, Lmax, H, D]
        ck[slot_ids[:, None], safe_w] = kw
        cv[slot_ids[:, None], safe_w] = vw
        attn = dot_product_attention(qw, ck, cv, causal=True, scale=scale,
                                     q_offset=t, k_offset=0)
        xw = _attn_out_residual(layer, attn, xw, tp)
        xw = _ffn_residual(layer, xw, tp)
        pk[wp_w, wo_w] = kw
        pv[wp_w, wo_w] = vw
    ver_logits = _logits(params, xw, tp, vocab_parallel)   # [S, w, V]
    tokens = torch.cat([torch.argmax(ver_logits.float(), dim=-1),
                        draft_toks], 1).int()
    return tokens, ver_logits, torch.stack(draft_logits, 1)


# --------------------------------------------------------------------------
# The host-side engine.


def resolve_tp_mesh(params: Dict, config: ServeConfig):
    """Bind ``config.mesh`` to the ranks of the ``torch.distributed``
    world; returns ``(logical_mesh, tp_axis, tp_degree)``, or ``(None,
    None, 1)`` when the engine runs unsharded (``mesh=None`` or a mesh of
    one rank).

    Raises :class:`~horovod_tpu_torch.common.exceptions.
    InvalidArgumentError` at engine construction when the mesh's rank
    product is not the world size (the engine's tensor group is the
    world: every rank runs one shard), or when heads, MLP features or
    the vocab do not divide by the tensor degree, with the reference's
    messages."""
    axes = config.mesh_axes()
    if not axes:
        return None, None, 1
    from horovod_tpu_torch.parallel.logical import LogicalMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    want = math.prod(axes.values())
    if want != world:
        raise InvalidArgumentError(
            f"ServeConfig.mesh {config.mesh!r} spans {want} rank(s) but "
            f"the torch.distributed world has {world}: one engine's "
            "tensor group is the whole world (start one rank per shard, "
            "e.g. torchrun --nproc-per-node "
            f"{want})")
    lm = LogicalMesh.from_config(config.mesh)
    tp_axis = lm.role_axis("tensor")
    tp = lm.axes.get(tp_axis, 1)
    if tp == 1:
        return None, None, 1
    layer0 = params["layers"][0]
    dims = (("num_heads", int(layer0["wqkv"].shape[2])),
            ("mlp", int(layer0["wup"].shape[1])),
            ("vocab", int(params["head"].shape[1])))
    for what, n in dims:
        if n % tp:
            raise InvalidArgumentError(
                f"ServeConfig.mesh {config.mesh!r}: {what}={n} is not "
                f"divisible by tp={tp} — the head/feature/vocab shards "
                "must split exactly (pad the model or pick a tp that "
                "divides)")
    return lm, tp_axis, tp


#: Data-plane ops the controller broadcasts to its followers, as the
#: first entry of a ``[3]`` int32 header (op, then two op arguments):
#: close, a copy-on-write page copy (src, dst), a step (flags), a weight
#: swap, a page export and a page import (the page count), a keepalive
#: of an idle controller, and a read of every rank's counters.
(_OP_CLOSE, _OP_COW, _OP_STEP, _OP_PARAMS, _OP_EXPORT, _OP_IMPORT,
 _OP_NOP, _OP_COUNT) = range(8)
#: A step header's flags: a prefill chunk follows, the decode (or
#: speculative) lane runs, and it takes the draft's sampled draw.
_STEP_PRE, _STEP_LANE, _STEP_SAMPLED = 1, 2, 4
#: The counters :meth:`ServeEngine.rank_counters` reads on every rank.
_COUNTERS = ("pid", "lane_ticks", "decode_launches", "lane_captures",
             "lane_replays")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a uint8 view (what the collectives
    below carry, whatever the dtype)."""
    return t.reshape(-1).view(torch.uint8)


def broadcast_params(params: Optional[Dict], *, src: int, group=None,
                     device: torch.device) -> Dict:
    """The dense weights of rank ``src`` on every rank of ``group``: the
    tree's layout (shapes and dtypes, one object broadcast), then each
    leaf. ``params`` is the tree on ``src`` and None elsewhere; returns
    the tree on ``device`` on every rank."""
    skeleton = [None if params is None else _tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).rpartition(".")[2]),
        params)]
    dist.broadcast_object_list(
        skeleton, src=src, group=group,
        device=device if device.type == "cuda" else None)
    if params is None:
        params = _tree_map(lambda sd: torch.empty(
            sd[0], dtype=getattr(torch, sd[1]), device=device), skeleton[0])
    else:
        params = _tree_map(lambda x: x.to(device).contiguous(), params)
    for leaf in tree_leaves(params):
        dist.broadcast(_raw(leaf), src=src, group=group)
    return params


class ServeEngine:
    """Continuous-batching LM serving over a paged KV cache.

    ``params`` is :func:`models.parallel_lm.init_lm_params`' dict; it is
    moved to ``device`` (``None`` = the card; without a CUDA device that
    raises, pass ``device="cpu"`` for the CPU). The engine owns the page
    tensors, the scheduler, and the request lifecycle: :meth:`submit`
    queues work, :meth:`step` runs one step (False when fully idle),
    :meth:`run` drains to idle. ``clock`` is injectable for
    deterministic tests. With ``capture`` (the default) the step's lane
    (the decode lane, or the speculative lane when ``speculate_k`` > 0)
    runs on the card as a CUDA graph replay (:attr:`lane_graphs`);
    ``capture=False`` runs it eagerly, for an A/B against the replay.

    With ``config.mesh`` sharding over ``tp`` > 1 ranks, every rank of
    the world builds the engine from the same dense ``params`` (each
    keeps its shard, :func:`~horovod_tpu_torch.models.parallel_lm.
    shard_lm_params`); rank 0 (:attr:`is_controller`) serves and the
    others call :meth:`follow`, until the controller's :meth:`close`.
    ``capture`` needs an NCCL tensor group there: over gloo it raises
    (gloo collectives cannot be captured), so pass ``capture=False``.
    """

    def __init__(self, params: Dict, config: ServeConfig, *,
                 chips: int = 1, clock=time.perf_counter,
                 device: DeviceLike = None, capture: bool = True):
        self.device = resolve_device(device)
        self.config = config
        self.chips = chips
        self.clock = clock
        #: The bound mesh, its tensor axis and degree (``mesh=None`` ->
        #: ``(None, None, 1)``), and this rank's place on the axis.
        self.logical_mesh, self._tp_axis, self.tp = \
            resolve_tp_mesh(params, config)
        self.tp_rank = 0
        self.tp_backend = None
        self._closed = False
        if self.tp > 1:
            from horovod_tpu_torch.parallel._collectives import axis_group

            with self._bound():
                self._tp_group, _, self.tp_rank = axis_group(self._tp_axis)
            self._tp_src = dist.get_global_rank(self._tp_group, 0)
            #: The tensor group's backend (``nccl``: one card a rank).
            self.tp_backend = dist.get_backend(self._tp_group)
            if capture and self.tp_backend != "nccl":
                raise InvalidArgumentError(
                    f"ServeEngine(capture=True) with ServeConfig.mesh="
                    f"{config.mesh!r} over a {self.tp_backend} tensor "
                    f"group: {self.tp_backend} collectives cannot be "
                    "captured into a CUDA graph; pass capture=False, or "
                    "serve over an NCCL group (one card a rank)")
            params = self._shard(params)
        self._set_params(params)
        #: Speculative decoding (``speculate_k`` > 0): the window k and
        #: the layer-skip draft's depth, resolved against this model at
        #: construction (0 = auto: half the depth, at least 1).
        self.spec_k = int(config.speculate_k)
        self.draft_layers = 0
        if self.spec_k:
            n_layers = len(self.params["layers"])
            dl = config.draft_layers or max(1, n_layers // 2)
            try:
                draft_params(self.params, dl)
            except ValueError as e:
                raise InvalidArgumentError(
                    f"ServeConfig.draft_layers={config.draft_layers}: "
                    f"the layer-skip draft is a prefix of the target's "
                    f"{n_layers} layers — need 1..{n_layers}") from e
            self.draft_layers = dl
        self.cache = PagedKVCache(self.params, config, tp=self.tp,
                                  tp_rank=self.tp_rank)
        #: The radix prefix index (``prefix_caching``), else None.
        self.prefix = (PrefixIndex(self.cache.allocator, config.page_size)
                       if config.prefix_caching else None)
        self.scheduler = Scheduler(self.cache, config, prefix=self.prefix)
        # The lane's inputs: one packed int32 index (pack_decode, or
        # pack_spec and the draft's temperatures), filled on the host
        # (pinned memory on the card) and moved by one copy a step into
        # fixed device buffers that the lane reads.
        S, pps = config.decode_slots, self.cache.pages_per_seq
        n = S * (pps + _DEC_ROWS + (_SPEC_ROWS if self.spec_k else 0))
        self._index_host, self._index = self._buffers(n, torch.int32)
        self._temps_host, self._temps = (
            self._buffers(S, torch.float32) if self.spec_k else (None, None))
        #: The step's lane (the decode lane, or the speculative lane when
        #: ``speculate_k`` > 0) as CUDA graphs captured once per shape and
        #: weights (``capture=True`` on the card: the counterpart of the
        #: JAX engine's jitted step), one for each value of the lane's
        #: ``sampled`` flag: ``lane_graphs[sampled]``, made at its first
        #: use (the decode lane has only ``False``). None: the lane runs
        #: eagerly (the CPU, or ``capture=False`` — the counterpart of
        #: running the JAX engine under ``jax.disable_jit()``).
        self.lane_graphs: Optional[Dict[bool, CapturedStep]] = (
            {} if capture and self.device.type == "cuda" else None)
        #: Copy-on-write page copies performed (the backstop — 0 in
        #: normal operation; see :meth:`_cow_guard`).
        self.cow_copies = 0
        self.slots: List[Optional[Request]] = [None] * config.decode_slots
        self.ready: List[Request] = []      # prefilled, awaiting a slot
        self.prefilling: Optional[Request] = None
        #: Disaggregated-serving handoff bay: ``prefill_only`` requests
        #: parked fully prefilled (first token emitted, pages held) until
        #: the fleet ships their K/V pages to a decode replica —
        #: :meth:`export_handoff` / :meth:`release_handoff` on this side,
        #: :meth:`admit_prefilled` on the receiving one. Parked requests
        #: never decode here, but they count in_flight and their
        #: deadlines still sweep.
        self.handoff: List[Request] = []
        self.finished: List[Request] = []
        self.evicted: List[Request] = []    # terminal (requeue off)
        self.timed_out: List[Request] = []  # terminal (deadline passed)
        self.occupancy_samples: List[float] = []
        #: Per-step decode-lane live-key counts (t+1 per slot, 0 = idle
        #: lane), the input of :meth:`attention_stats`.
        self.attn_len_samples: List[List[int]] = []
        self.steps = 0
        #: Speculation accounting, per slot per tick: proposals made and
        #: accepted, tokens emitted (stats()["spec"]).
        self.spec_ticks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        #: Steps whose decode (or speculative) lane this rank ran, since
        #: construction (a follower's too; ``reset_metrics`` keeps it).
        self.lane_ticks = 0
        self._t_start = clock()

    def _buffers(self, n: int, dtype):
        """A host buffer (pinned on the card) and the device buffer a
        lane reads (the same tensor on the CPU)."""
        host = torch.zeros(n, dtype=dtype,
                           pin_memory=self.device.type == "cuda")
        return host, (host if self.device.type == "cpu" else
                      torch.zeros(n, dtype=dtype, device=self.device))

    # --------------------------------------------- the tensor-parallel plane

    @property
    def is_controller(self) -> bool:
        """True on the rank that owns the control plane (rank 0 of the
        tensor axis; every unsharded engine)."""
        return self.tp_rank == 0

    def _controller_only(self, what: str) -> None:
        if not self.is_controller:
            raise PreconditionError(
                f"ServeEngine.{what} on tensor-parallel rank "
                f"{self.tp_rank}: the control plane is rank 0's; a "
                "follower calls follow()")
        if self._closed:
            raise PreconditionError(f"ServeEngine.{what} after close()")

    def _bound(self):
        """The engine's mesh bound for the lanes' collectives (nothing
        to bind unsharded)."""
        if self.logical_mesh is None:
            return contextlib.nullcontext()
        from horovod_tpu_torch.parallel.logical import bind

        return bind(self.logical_mesh)

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from the controller to every rank of the tensor group,
        in place."""
        dist.broadcast(t, src=self._tp_src, group=self._tp_group)
        return t

    def _header(self, op: int = 0, a: int = 0, b: int = 0) -> List[int]:
        """The controller sends ``[op, a, b]``; a follower receives it
        (its arguments are ignored)."""
        hdr = torch.tensor([op, a, b], dtype=torch.int32,
                           device=self.device)
        return self._bcast(hdr).tolist()

    def _pre_payload(self, pre):
        """A prefill chunk as one int32 tensor ``[start, length, tokens
        [C], table [pps]]`` broadcast from the controller; returns the
        chunk's host dict (a follower's, decoded)."""
        C, pps = self.config.prefill_chunk, self.cache.pages_per_seq
        buf = torch.zeros(2 + C + pps, dtype=torch.int32)
        if pre is not None:
            buf[0], buf[1] = int(pre["start"]), int(pre["length"])
            buf[2:2 + C] = torch.from_numpy(np.asarray(pre["tokens"],
                                                       np.int32))
            buf[2 + C:] = torch.from_numpy(np.asarray(pre["table"],
                                                      np.int32))
        got = self._bcast(buf.to(self.device)).cpu().numpy()
        return {"start": int(got[0]), "length": int(got[1]),
                "tokens": got[2:2 + C], "table": got[2 + C:]}

    def _plane_step(self, flags: int, pre):
        """The data plane of one step on every rank: the step's inputs
        broadcast over the tensor group (when sharded), then the prefill
        lane and the decode (or speculative) lane. The controller has
        filled the host index buffers. Returns ``(pre_logits,
        lane_out)``."""
        if self.tp > 1 and flags & _STEP_PRE:
            pre = self._pre_payload(pre)
        lane = bool(flags & _STEP_LANE)
        if lane and self._index is not self._index_host \
                and self.is_controller:
            # The previous step's copy is done: its tokens came back to
            # the host after it.
            self._index.copy_(self._index_host, non_blocking=True)
            if self.spec_k:
                self._temps.copy_(self._temps_host, non_blocking=True)
        if lane and self.tp > 1:
            self._bcast(self._index)
            if self.spec_k:
                self._bcast(self._temps)
        cfg = self.config
        with torch.no_grad(), self._bound():
            # The prefill lane first: its pages are written before the
            # decode (or speculative) lane reads them.
            pre_logits = (None if pre is None else _prefill_lane(
                self.params, self.cache.pages, pre,
                page_size=cfg.page_size, tp=self._tp_axis,
                vocab_parallel=self.tp > 1))
            lane_out = (self._run_lane(bool(flags & _STEP_SAMPLED))
                        if lane else None)
        self.lane_ticks += lane
        return pre_logits, lane_out

    def _shard(self, dense: Dict) -> Dict:
        """This rank's cut of the dense weights (the tensor axis's
        Megatron cut, :func:`~horovod_tpu_torch.models.parallel_lm.
        shard_lm_params`)."""
        return shard_lm_params(
            dense, lm_param_specs(len(dense["layers"]), self._tp_axis,
                                  vocab_parallel=True),
            self.tp, self.tp_rank)

    def _plane_params(self, dense: Optional[Dict]) -> Dict:
        """Every rank: the controller's dense weights (None on a
        follower) over the tensor group, cut to this rank's shard."""
        return self._shard(broadcast_params(
            dense, src=self._tp_src, group=self._tp_group,
            device=self.device))

    def _plane_export(self, ids: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank: the page ids from the controller, then this rank's
        tiles of those pages gathered at the controller, which gets the
        full-head tiles (the shards concatenated in rank order: rank
        ``r`` holds heads ``r*H/tp`` onward); None on a follower."""
        ids = self._bcast(ids)
        mine = self.cache.read_tiles(ids).contiguous()
        parts = ([torch.empty_like(mine) for _ in range(self.tp)]
                 if self.is_controller else None)
        dist.gather(mine.view(torch.uint8), None if parts is None else
                    [p.view(torch.uint8) for p in parts],
                    dst=self._tp_src, group=self._tp_group)
        return None if parts is None else torch.cat(parts, dim=-2)

    def _plane_import(self, ids: torch.Tensor, tiles: torch.Tensor) -> None:
        """Every rank: the granted page ids and the blob's full-head tiles
        from the controller; each rank writes its own heads."""
        ids = self._bcast(ids)
        dist.broadcast(_raw(tiles), src=self._tp_src, group=self._tp_group)
        self.cache.write_tiles(ids, tiles)

    def _plane_counters(self) -> List[Dict]:
        """Every rank's :data:`_COUNTERS`, gathered at the controller (an
        empty list on a follower)."""
        graphs = list((self.lane_graphs or {}).values())
        mine = torch.tensor(
            [os.getpid(), self.lane_ticks, paged_attention_decode.launches,
             sum(g.captures for g in graphs),
             sum(g.replays for g in graphs)],
            dtype=torch.int64, device=self.device)
        rows = [mine]
        if self.tp > 1:
            rows = ([torch.empty_like(mine) for _ in range(self.tp)]
                    if self.is_controller else None)
            dist.gather(mine, rows, dst=self._tp_src, group=self._tp_group)
        return [dict(zip(_COUNTERS, r.tolist()), rank=i)
                for i, r in enumerate(rows or [])]

    def follow(self) -> int:
        """A follower's serving loop: run every data-plane action the
        controller broadcasts (steps, page copies, weight swaps, page
        exports and imports) on this rank's shards until the
        controller's :meth:`close`. Returns the steps run."""
        if self.tp == 1:
            raise PreconditionError(
                "ServeEngine.follow: this engine is not tensor-parallel "
                "(ServeConfig.mesh shards over one rank); nothing to "
                "follow")
        if self.is_controller:
            raise PreconditionError(
                "ServeEngine.follow on the controller (tensor-parallel "
                "rank 0): it serves with submit/step/run and ends its "
                "followers with close()")
        c = self.cache
        steps = 0
        while True:
            op, a, b = self._header()
            if op == _OP_CLOSE:
                self._close_graphs()
                return steps
            if op == _OP_COW:
                c.copy_page(a, b)
            elif op == _OP_STEP:
                self._plane_step(a, None)
                steps += 1
            elif op == _OP_PARAMS:
                self._set_params(self._plane_params(None))
            elif op == _OP_EXPORT:
                self._plane_export(torch.zeros(a, dtype=torch.int32,
                                               device=self.device))
            elif op == _OP_IMPORT:
                self._plane_import(
                    torch.zeros(a, dtype=torch.int32, device=self.device),
                    torch.empty((c.num_layers, 2, a, self.config.page_size,
                                 c.blob_heads, c.head_dim),
                                dtype=c.dtype, device=self.device))
            elif op == _OP_COUNT:
                self._plane_counters()
            elif op != _OP_NOP:
                raise RuntimeError(f"ServeEngine.follow: unknown data-"
                                   f"plane op {op}")

    def close(self) -> None:
        """End the followers' :meth:`follow` loops (the controller of a
        tensor-parallel engine; idempotent, and nothing to do
        unsharded). Every rank then drops its captured lane graphs,
        which hold the tensor group's collectives."""
        if self.tp > 1 and self.is_controller and not self._closed:
            self._header(_OP_CLOSE)
            self._close_graphs()

    def _close_graphs(self) -> None:
        """A closed tensor-parallel engine's end on this rank: release
        the lane graphs (their counters stay), so the process group can
        be destroyed."""
        self._closed = True
        for graph in (self.lane_graphs or {}).values():
            graph.release()

    def keepalive(self) -> None:
        """An idle controller's no-op for its followers, whose wait for
        the next action would otherwise run into the tensor group's
        timeout (nothing to do unsharded)."""
        self._controller_only("keepalive")
        if self.tp > 1:
            self._header(_OP_NOP)

    def rank_counters(self) -> List[Dict]:
        """Every rank's counters, rank by rank: ``pid``, ``lane_ticks``,
        the paged-attention wrapper's ``decode_launches`` and the lane's
        graph ``lane_captures`` and ``lane_replays`` (one entry
        unsharded). On a tensor-parallel engine the followers take part,
        as in any data-plane action."""
        self._controller_only("rank_counters")
        if self.tp > 1:
            self._header(_OP_COUNT)
        return self._plane_counters()

    # ------------------------------------------------------ submission

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_token: Optional[int] = None, seed: int = 0,
               arrival: Optional[float] = None,
               ttl: Optional[float] = None) -> Request:
        """Queue one generation request; returns it (check ``state`` —
        ``rejected`` means it can never run or the queue is full)."""
        self._controller_only("submit")
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
                + len(self.ready) + (1 if self.prefilling else 0)
                + len(self.handoff))

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
        """Release the request's pages and detach it from slots, ready,
        the handoff bay and the prefill lane."""
        self.scheduler.release(req)
        for i, s in enumerate(self.slots):
            if s is req:
                self.slots[i] = None
        self.ready = [r for r in self.ready if r is not req]
        self.handoff = [r for r in self.handoff if r is not req]
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
                + list(self.ready) + list(self.handoff)
                + ([self.prefilling] if self.prefilling else [])
                + list(self.scheduler.queue))
        for req in live:
            if req.expired(now):
                self._time_out(req, now)

    def _evict_for(self, requester: Request) -> bool:
        """Lazy-mode page pressure: reclaim a page only the prefix index
        holds first (a cold cached prefix costs a future re-prefill, a
        victim a certain recompute), else evict the newest-admitted
        request that is not the requester. False = nothing else to
        evict."""
        if self.prefix is not None and self.prefix.reclaim(1):
            return True
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
            if not self.scheduler.ensure_pages(req, self._last_write(req),
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

    def _last_write(self, req: Request) -> int:
        """The last position a decode slot's step writes: its next
        position, or the end of its verify window under speculation."""
        return req.next_pos + (req.spec_window(self.spec_k)
                               if self.spec_k else 0)

    def _cow_guard(self) -> None:
        """Copy-on-write backstop for the in-place step: no page this
        step WRITES may be shared. By construction none is (only full
        prompt pages are indexed, a match never covers the whole prompt,
        and prefill and decode write past every shared slot), so this
        finds nothing in normal operation; any slip becomes one counted
        page copy (``cow_copies``) instead of a corrupted stream of
        another holder. A speculative window is covered whole: a
        rejected row must never have landed on a shared page either."""
        for req in self.slots:
            if req is not None and req.generated:
                self._cow_range(req, req.next_pos, self._last_write(req))
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
                if self.tp > 1:
                    # Every rank copies its head shard of the page.
                    self._header(_OP_COW, page, new)
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
        dec = {"tok": tok, "pos": pos, "active": active, "tables": tables}
        if self.spec_k:
            # The speculation plane: the verify width per slot (0 = idle
            # lane) and the draft's sampling knobs.
            width = np.zeros((S,), np.int32)
            temp = np.zeros((S,), np.float32)
            topk = np.zeros((S,), np.int32)
            seed = np.zeros((S,), np.int64)
            sidx = np.zeros((S,), np.int64)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                width[i] = req.spec_window(self.spec_k) + 1
                temp[i] = req.temperature
                topk[i] = req.top_k
                seed[i] = req.seed
                sidx[i] = req.sample_index
            dec.update(width=width, temp=temp, topk=topk, seed=seed,
                       sidx=sidx)
        return dec

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
        self._controller_only("step")
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
        # Live keys per slot (the verify window's under speculation).
        self.attn_len_samples.append(
            [0 if r is None else self._last_write(r) + 1
             for r in self.slots])

        pre_done = (self.prefilling is not None and
                    self.prefilling.prefill_pos + chunk
                    >= self.prefilling.prompt_len)
        flags = 0 if pre is None else _STEP_PRE
        if dec["active"].any():
            if self.spec_k:
                index, temps = pack_spec(dec, self.config.page_size)
                self._temps_host.numpy()[:] = temps
            else:
                index = pack_decode(dec, self.config.page_size)
            self._index_host.numpy()[:] = index
            flags |= _STEP_LANE
            # A speculative tick whose live slots are all greedy skips
            # the draft's sampled draw.
            if self.spec_k and (dec["temp"][dec["active"]] > 0).any():
                flags |= _STEP_SAMPLED
        if self.tp > 1:
            self._header(_OP_STEP, flags)
        pre_logits, lane_out = self._plane_step(flags, pre)

        if self.spec_k:
            pre_token = None
            if pre_logits is not None and pre_done:
                # The prefill lane's first token is a plain draw.
                preq = self.prefilling
                pre_token = int(sample_tokens(
                    pre_logits[None], [preq.temperature], [preq.top_k],
                    [preq.seed], [preq.sample_index])[0])
            now = (self._accept_spec(dec, *lane_out)
                   if lane_out is not None else self.clock())
        else:
            pre_token, now = self._accept_decode(lane_out, pre_logits,
                                                 pre_done)

        # Prefill lane: advance; on completion emit the FIRST token.
        if self.prefilling is not None and pre is not None:
            req = self.prefilling
            req.prefill_pos += chunk
            if pre_done:
                if self.prefix is not None:
                    # Index the filled prompt pages BEFORE the first token
                    # can finish the request (max_new=1: _finish releases
                    # its pages; the index's retain must land first).
                    self.prefix.insert(req.prompt, req.page_table)
                self._accept_token(req, pre_token, now)
                self.prefilling = None
                if req.state != RequestState.FINISHED:
                    req.state = RequestState.DECODE
                    if req.prefill_only:
                        # Disaggregated handoff: park fully prefilled
                        # (pages held, first token emitted) until the
                        # fleet ships the pages to a decode replica. A
                        # request that finished on its first token never
                        # gets here.
                        self.handoff.append(req)
                    else:
                        self.ready.append(req)

        self.occupancy_samples.append(self.cache.occupancy())
        self.steps += 1
        return True

    def _accept_decode(self, dec_logits, pre_logits, pre_done: bool):
        """The plain decode step's host side: one sampler call covers the
        live decode slots + the prefill lane; each live slot takes its
        token. Returns the prefill lane's first token (or None) and the
        clock after the device-to-host copy."""
        S = self.config.decode_slots
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
        return pre_token, now

    def _accept_spec(self, dec, tokens, ver_logits, draft_logits) -> float:
        """The speculative tick's host side: the lane's argmaxes and
        proposals come back in one copy; each live slot keeps what
        :func:`~horovod_tpu_torch.serve.sampling.speculative_accept`
        emits (sampled slots read their logits rows on the device). A
        request that finishes mid-window drops the rest of it. Returns
        the clock after the copy."""
        k = self.spec_k
        tokens = tokens.to("cpu").numpy()
        now = self.clock()      # after the device-to-host copy: a sync
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            wd = int(dec["width"][i])
            emitted = speculative_accept(
                ver_logits[i, :wd], tokens[i, k + 1:k + wd],
                draft_logits[i, :wd - 1],
                temperature=float(req.temperature), top_k=int(req.top_k),
                seed=int(req.seed), position0=int(req.sample_index),
                target_tokens=tokens[i, :wd])
            self.spec_ticks += 1
            self.spec_proposed += wd - 1
            self.spec_accepted += len(emitted) - 1
            for tok in emitted:
                self.spec_emitted += 1
                self._accept_token(req, int(tok), now)
                if req.state == RequestState.FINISHED:
                    # The stale K/V rows past the cut go with its pages.
                    break
            if req.state == RequestState.FINISHED:
                self.slots[i] = None
        return now

    def _accept_token(self, req: Request, token: int, now: float
                      ) -> None:
        req.generated.append(token)
        req.output.append(token)
        if req.t_first_token is None:
            req.t_first_token = now
        req.token_times.append(now)
        if req.done_generating or req.hit_eos(self.config.eos_token):
            self._finish(req)

    # ------------------------------------- disaggregated prefill/decode

    def _handoff_req(self, rid) -> Request:
        for r in self.handoff:
            if r.rid == rid:
                return r
        raise KeyError(f"no parked handoff request {rid!r} — expired, "
                       "already released, or never parked here")

    def handoff_ready(self) -> List:
        """rids parked in the handoff bay (prefill finished, K/V pages
        ready to ship)."""
        return [r.rid for r in self.handoff]

    def export_handoff(self, rid) -> bytes:
        """The parked request's finished K/V pages as one deterministic
        blob (:meth:`PagedKVCache.export_pages
        <horovod_tpu_torch.serve.kvcache.PagedKVCache.export_pages>` over
        the page-table prefix covering the prompt). READ-ONLY and
        repeatable — a torn transfer re-exports identical bytes. A
        tensor-parallel engine gathers the ranks' head shards, so its
        blob is the one a tp=1 engine with the same pages writes."""
        self._controller_only("export_handoff")
        req = self._handoff_req(rid)
        n_exp = self.cache.pages_needed(req.prompt_len, 1)
        return self.export_pages(
            [int(req.page_table[j]) for j in range(n_exp)], req.prompt_len)

    def export_pages(self, pages, num_positions: int) -> bytes:
        """The HVKV blob of any ``pages`` covering ``num_positions``
        positions (:meth:`PagedKVCache.export_pages
        <horovod_tpu_torch.serve.kvcache.PagedKVCache.export_pages>`),
        the ranks' head shards gathered on a tensor-parallel engine."""
        self._controller_only("export_pages")
        return self.cache.export_pages(
            pages, num_positions,
            gather=self._gather_tiles if self.tp > 1 else None)

    def _gather_tiles(self, ids: torch.Tensor) -> torch.Tensor:
        self._header(_OP_EXPORT, ids.numel())
        return self._plane_export(ids)

    def _share_tiles(self, ids: torch.Tensor, tiles: torch.Tensor) -> None:
        self._header(_OP_IMPORT, ids.numel())
        self._plane_import(ids, tiles.to(self.device))

    def release_handoff(self, rid) -> Request:
        """Drop the prefill side's hold once the decode replica has
        COMMITTED the import: pages release through the refcounted path
        (prefix-shared pages stay alive under the index) and the request
        leaves the bay WITHOUT a terminal event — ownership moved, the
        stream did not end. Returns the request (the in-process fleet
        re-uses the very same object on the decode side)."""
        self._controller_only("release_handoff")
        req = self._handoff_req(rid)
        self.scheduler.release(req)
        self.handoff = [r for r in self.handoff if r is not req]
        return req

    def admit_prefilled(self, req: Request, blob: bytes) -> None:
        """Decode-side handoff admission: import the shipped K/V pages
        into THIS cache (in place), grant the rest of the request's
        worst-case budget (reserve discipline), map the page table, and
        queue the request at its handoff position (``ready``, state
        DECODE — the next step promotes it into a slot and decodes token
        2 onward; token 1 was emitted prefill-side). All-or-nothing:
        :class:`~horovod_tpu_torch.serve.kvcache.OutOfPages` or a typed
        :class:`~horovod_tpu_torch.serve.transport.FrameError` leaves
        this engine unchanged. A tensor-parallel engine checks the blob
        on the controller, then every rank writes its own heads."""
        self._controller_only("admit_prefilled")
        imported, positions = self.cache.import_pages(
            blob, write=self._share_tiles if self.tp > 1 else None)
        try:
            if positions != req.prompt_len:
                raise FrameError(
                    f"handoff blob covers {positions} positions, "
                    f"request prompt is {req.prompt_len} — wrong blob "
                    "for this request")
            total = self.cache.pages_needed(req.prompt_len,
                                            req.max_new_tokens)
            extra = self.cache.allocator.alloc(total - len(imported))
        except BaseException:
            self.cache.allocator.release(imported)
            raise
        req.pages = list(imported) + list(extra)
        req.page_table = np.zeros(self.cache.pages_per_seq, np.int32)
        req.page_table[:total] = np.asarray(req.pages, np.int32)
        req.prefill_pos = req.prompt_len
        req.state = RequestState.DECODE
        req.t_admit = self.clock()
        self.ready.append(req)

    def _lane(self, sampled: bool):
        """One run of the step's lane over the packed device buffers."""
        cfg = self.config
        shard = dict(tp=self._tp_axis, vocab_parallel=self.tp > 1)
        if not self.spec_k:
            return decode_lane(self.params, self.cache.pages, self._index,
                               slots=cfg.decode_slots,
                               page_size=cfg.page_size,
                               attention=cfg.attention, **shard)
        return spec_lane(self.params, self.cache.pages, self._index,
                         self._temps, slots=cfg.decode_slots,
                         k=self.spec_k, draft_layers=self.draft_layers,
                         page_size=cfg.page_size, attention=cfg.attention,
                         sampled=sampled, **shard)

    def _run_lane(self, sampled: bool):
        """The lane eagerly, or as the replay of its graph for
        ``sampled`` (captured at its first use)."""
        if self.lane_graphs is None:
            return self._lane(sampled)
        graph = self.lane_graphs.get(sampled)
        if graph is None:
            graph = self.lane_graphs[sampled] = CapturedStep(
                lambda: self._lane(sampled), device=self.device,
                key=self._lane_key,
                name="speculative lane" if self.spec_k else "decode lane")
        return graph()

    def _lane_key(self):
        """The captured lane's signature beyond its (argument-free) call:
        the attention mode and the weights it reads (a swap by
        :meth:`update_params` captures again)."""
        return (self.config.attention, self._weights)

    def _set_params(self, params: Dict) -> None:
        self.params = params_to(params, self.device)
        self._weights = tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                              for p in tree_leaves(self.params))

    def update_params(self, params: Dict) -> None:
        """Swap the model weights. Only valid when IDLE (a live
        request's decode must never mix weights mid-stream); the
        geometry must match. A captured decode lane is captured again
        over the new weights at its next step, and the prefix index is
        flushed: K/V rows are a function of the weights. On a
        tensor-parallel engine the controller checks, then broadcasts
        the dense weights over the tensor group and every rank cuts its
        shard as at construction."""
        self._controller_only("update_params")
        if not self.idle:
            raise RuntimeError(
                "update_params with requests in flight — drain the "
                "engine first (the fleet's rolling update does)")
        old, new = self.params["pos"].shape, params["pos"].shape
        if tuple(old) != tuple(new):
            raise ValueError(
                f"update_params geometry mismatch: position table "
                f"{tuple(new)} vs the engine's {tuple(old)} — a "
                "geometry change needs a fresh engine, not a weight "
                "swap")
        if self.tp > 1:
            self._header(_OP_PARAMS)
            params = self._plane_params(params)
        self._set_params(params)
        if self.prefix is not None:
            self.prefix.flush()

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
        self.spec_ticks = self.spec_proposed = 0
        self.spec_accepted = self.spec_emitted = 0
        if self.prefix is not None:
            self.prefix.reset_metrics()
        self._t_start = self.clock()

    def stats(self) -> Dict:
        """Aggregate SLO metrics over every request seen so far."""
        everything = (self.finished + self.evicted + self.timed_out
                      + self.ready + self.handoff
                      + [s for s in self.slots if s is not None]
                      + ([self.prefilling] if self.prefilling else [])
                      + self.scheduler.queue + self.scheduler.rejected)
        out = summarize(everything, self.clock() - self._t_start,
                        self.chips, self.occupancy_samples)
        out["attention"] = self.attention_stats()
        ps = self.prefix_stats()
        if ps is not None:
            out["prefix"] = ps
        sp = self.spec_stats()
        if sp is not None:
            out["spec"] = sp
        return out

    def spec_stats(self) -> Optional[Dict]:
        """Speculation accounting over the run (None when speculation is
        off): ``accept_rate`` = accepted over proposed proposals,
        ``tokens_per_step`` = tokens emitted per slot tick (k+1 at a
        perfect draft, 1 at a useless one)."""
        if not self.spec_k:
            return None
        return {
            "k": self.spec_k,
            "draft_layers": self.draft_layers,
            "ticks": self.spec_ticks,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "accept_rate":
                (round(self.spec_accepted / self.spec_proposed, 4)
                 if self.spec_proposed else None),
            "tokens_per_step":
                (round(self.spec_emitted / self.spec_ticks, 4)
                 if self.spec_ticks else None),
        }

    def prefix_stats(self) -> Optional[Dict]:
        """Prefix-cache accounting over the run (None when the cache is
        off): ``hit_rate`` is hits over admitted requests,
        ``prefill_tokens_saved`` the prompt tokens whose prefill a hit
        skipped."""
        if self.prefix is None:
            return None
        s = self.prefix.stats()
        s["hit_rate"] = (round(s["hits"] / s["lookups"], 4)
                         if s["lookups"] else None)
        s["prefill_tokens_saved"] = s["tokens_hit"]
        s["cow_copies"] = self.cow_copies
        s["pages_shared_now"] = self.cache.allocator.shared
        return s

    def step_grid_info(self, lengths: List[int]) -> Dict:
        """One step's static decode-traffic accounting —
        :func:`ops.paged_attention.paged_grid_info` over this engine's
        cache geometry."""
        c = self.cache
        return paged_grid_info(
            lengths, page_size=self.config.page_size,
            pages_per_seq=c.pages_per_seq, num_heads=c.num_heads * self.tp,
            head_dim=c.head_dim, dtype_bytes=c.dtype_bytes,
            num_layers=c.num_layers, tp=self.tp)

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
        # Heads shard exactly: per-chip bytes are 1/tp of this mode's
        # total (``serve_bench --ab-tp`` pins it).
        total_chip = (total_paged if self.config.attention == "paged"
                      else total_gather) // self.tp
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
            "tp": self.tp,
            "kv_bytes_per_chip":
                round(total_chip / n, 1) if n else None,
        }
