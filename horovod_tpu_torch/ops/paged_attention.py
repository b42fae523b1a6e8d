"""Paged-attention decode: stream each slot's live KV pages, no gather.

The port of ``horovod_tpu.ops.paged_attention``. The serving engine
keeps each request's KV cache as fixed-size pages (``[num_pages,
page_size, H, D]`` per layer per K/V) indexed by a per-request page
table; :func:`paged_attention_decode` attends one query token per decode
slot over only that slot's ``ceil(len/page_size)`` live pages.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/paged_attention.cu`` (built by ``nvcc`` for ``sm_90a`` at first
  use, bound through a plain C interface and ``ctypes``), or raises.
* On a CPU tensor it runs :func:`paged_attention_decode_reference`, the
  kernel's plain PyTorch version, which the CPU parity tests hold
  against the JAX kernel in interpret mode.

:func:`paged_grid_info` is the static page/byte accounting, a copy of
the JAX function.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from horovod_tpu_torch.ops.attention import NEG_INF

#: dtypes the kernel takes, with the code its C interface expects.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def _check_shapes(q, k_pages, v_pages, tables, lengths):
    S, H, D = q.shape
    _, _, Hk, Dk = k_pages.shape
    if (Hk, Dk) != (H, D) or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(
            f"page/query shape mismatch: q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    if tables.shape[0] != S or tuple(lengths.shape) != (S,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match {S} slots")


def paged_attention_decode_reference(q, k_pages, v_pages, tables, lengths,
                                     scale: Optional[float] = None):
    """The plain PyTorch version of the kernel, on any device.

    Gathers each slot's logical cache ``[Lmax, H, D]`` through its page
    table, masks positions ``>= lengths[s]`` (scores to ``NEG_INF``
    before the max; K and V rows to zero, so the NaN of an unmapped
    null page or the stale rows of a reused page never enter a sum),
    and takes the softmax as the kernel does: float32 statistics,
    ``p`` cast to the value dtype before ``p @ V``, and
    ``acc / max(l, 1e-30)``. Idle lanes (length 0) give a zero row."""
    _check_shapes(q, k_pages, v_pages, tables, lengths)
    S, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    tables = tables.to(device=q.device, dtype=torch.long)
    lengths = lengths.to(device=q.device, dtype=torch.long)
    lmax = tables.shape[1] * ps
    rows = (tables[:, :, None] * ps
            + torch.arange(ps, device=q.device)).reshape(S, lmax)
    live = torch.arange(lmax, device=q.device)[None, :] < lengths[:, None]
    keep = live[:, :, None, None]
    zero = torch.zeros((), dtype=k_pages.dtype, device=q.device)
    k = torch.where(keep, k_pages.reshape(P * ps, H, D)[rows], zero)
    v = torch.where(keep, v_pages.reshape(P * ps, H, D)[rows], zero)
    sc = torch.einsum("shd,slhd->shl", q.float(), k.float()) * scale
    sc = torch.where(live[:, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(live[:, None, :], p, torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("shl,slhd->shd", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def paged_attention_decode(q, k_pages, v_pages, tables, lengths,
                           scale: Optional[float] = None):
    """Decode attention for S single-token queries straight from pages.

    Shapes (the contract of the JAX function)::

        q        [S, H, D]        one query token per decode slot
        k_pages  [P, ps, H, D]    the physical page pool (page 0 = the
        v_pages  [P, ps, H, D]    reserved null sink, never read)
        tables   [S, pps] int32   per-slot logical->physical page table
        lengths  [S]      int32   live keys per slot (t+1; the row at t
                                  is already in its page); 0 marks an
                                  idle lane, whose output row is zeros

    Returns ``[S, H, D]`` in ``q.dtype``. A CPU ``q`` runs the plain
    version; a CUDA ``q`` launches the kernel (float32 or bfloat16,
    ``D <= 256``, contiguous inputs on one device) or raises. Each
    launch adds one to ``paged_attention_decode.launches``.

    ``lengths`` and ``tables`` are trusted, as the kernel reads them on
    the device: the caller keeps ``lengths[s] <= pps * ps`` and every
    live table entry below ``P`` (the engine's page allocator does;
    :func:`paged_grid_info` checks a host copy). A length past the table
    reads out of bounds without an error.
    """
    _check_shapes(q, k_pages, v_pages, tables, lengths)
    S, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_attention_decode_reference(q, k_pages, v_pages,
                                                tables, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device "
                         f"{q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_attention_decode: {name} on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_decode: {name} must be "
                             "contiguous")
    if not q.is_contiguous():
        raise ValueError("paged_attention_decode: q must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged_attention_decode: dtype {q.dtype} not in "
                         f"{list(_KERNEL_DTYPES)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_attention_decode: q {q.dtype}, k_pages "
            f"{k_pages.dtype}, v_pages {v_pages.dtype} must match")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_decode: tables and lengths must "
                         "be int32")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"paged_attention_decode: head dim {D} > "
                         f"{_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), S, H, D, k_pages.shape[1], tables.shape[1],
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode: kernel launch failed "
                           f"(cuda error {rc})")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _kernel():
    from horovod_tpu_torch import _build

    lib = _build.load("paged_attention")
    fn = lib.hvd_paged_attention_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp]
        fn.restype = ci
    return fn


# --------------------------------------------------------------------------
# Static accounting (a copy of the JAX function)


def paged_grid_info(lengths: Sequence[int], *, page_size: int,
                    pages_per_seq: int, num_heads: int, head_dim: int,
                    dtype_bytes: int = 4, num_layers: int = 1,
                    tables=None, tp: int = 1):
    """Static page/byte accounting for one decode step.

    ``lengths`` are the per-slot live-key counts (``t+1``; 0 = idle
    lane). Returns a dict:

    * ``pages_live`` — per-slot pages read, ``ceil((t+1)/ps)``;
    * ``pages_full`` — the gather path's per-slot page count,
      ``pages_per_seq`` for every slot, idle included;
    * ``kv_bytes`` / ``kv_bytes_gather`` — K+V bytes per decode step
      under the two policies (x ``num_layers``);
    * ``kv_fetch_frac`` — the read/gathered byte ratio;
    * ``pages_visited`` (only when ``tables`` is given) — the per-slot
      physical page ids the kernel reads; never the null page 0;
    * ``tp`` / ``kv_bytes_per_chip`` / ``kv_bytes_gather_per_chip`` —
      per-chip bytes under a head-sharded tensor-parallel degree.
    """
    lens = [int(x) for x in lengths]
    if any(x < 0 for x in lens):
        raise ValueError(f"negative length in {lens}")
    if tp < 1 or num_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must be >= 1 and divide num_heads={num_heads} "
            "(the head-sharded page arrays split exactly)")
    pages_live = [-(-x // page_size) for x in lens]
    if any(p > pages_per_seq for p in pages_live):
        raise ValueError(
            f"length exceeds the page table: lengths {lens}, "
            f"pages_per_seq {pages_per_seq}, page_size {page_size}")
    S = len(lens)
    tile = 2 * page_size * num_heads * head_dim * dtype_bytes * num_layers
    info = {
        "page_size": page_size,
        "pages_per_seq": pages_per_seq,
        "slots": S,
        "pages_live": pages_live,
        "pages_live_total": sum(pages_live),
        "pages_full_total": S * pages_per_seq,
        "kv_bytes": sum(pages_live) * tile,
        "kv_bytes_gather": S * pages_per_seq * tile,
        "kv_fetch_frac": (round(sum(pages_live) / (S * pages_per_seq), 4)
                          if S else None),
        "tp": tp,
        "kv_bytes_per_chip": sum(pages_live) * tile // tp,
        "kv_bytes_gather_per_chip": S * pages_per_seq * tile // tp,
    }
    if tables is not None:
        import numpy as np

        tab = np.asarray(tables)
        if tab.shape != (S, pages_per_seq):
            raise ValueError(
                f"tables {tab.shape} does not match ({S}, "
                f"{pages_per_seq})")
        info["pages_visited"] = [
            [int(p) for p in tab[s, :pages_live[s]]] for s in range(S)]
    return info
