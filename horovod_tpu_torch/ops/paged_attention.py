"""Paged-attention decode: stream each slot's live KV pages, no gather.

The port of ``horovod_tpu.ops.paged_attention``. The serving engine
keeps each request's KV cache as fixed-size pages (``[num_pages,
page_size, H, D]`` per layer per K/V) indexed by a per-request page
table; :func:`paged_attention_decode` attends one query token per decode
slot over only that slot's ``ceil(len/page_size)`` live pages.

* On a CUDA tensor it launches the hand-written Hopper kernels in
  ``csrc/paged_attention.cu`` (built by ``nvcc`` for ``sm_90a`` at first
  use, bound through a plain C interface and ``ctypes``), or raises: a
  split-K kernel that cuts each slot's key axis into chunks of ``R``
  rows (:func:`paged_split_plan`) and writes one float32 partial per
  chunk, then a kernel that merges each (slot, head)'s chunks in chunk
  order (:func:`merge_partials_reference` is its plain version).
* On a CPU tensor it runs :func:`paged_attention_decode_reference`, the
  plain PyTorch version of the whole function, which the CPU parity
  tests hold against the JAX kernel in interpret mode.

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
#: Key rows a chunk of the split kernel: ``kChunkRows`` of
#: ``csrc/paged_attention.cu``, where the reasons for it stand. The entry
#: point rejects a split plan made for another chunk size.
CHUNK_ROWS = 64
#: The CUDA kernels of one call, by the names the profiler gives them.
KERNEL_NAMES = ("paged_split_kernel", "paged_merge_kernel")


def paged_split_plan(pps: int, ps: int):
    """The host's split of the key axis: ``(R, splits)``, ``R =``
    :data:`CHUNK_ROWS` rows a chunk and ``splits = ceil(pps * ps / R)``
    chunks a slot. It depends on the table's width ``pps * ps`` only,
    never on the lengths (reading them would wait for the device); a
    table narrower than a chunk is one chunk."""
    if pps <= 0 or ps <= 0:
        raise ValueError(f"pps {pps} and ps {ps} must be positive")
    return CHUNK_ROWS, -(-pps * ps // CHUNK_ROWS)


def merge_partials_reference(partials, lengths, rows: int,
                             dtype=torch.float32):
    """The plain version of the merge kernel: ``partials [S, H, splits,
    D + 2]`` float32, each chunk's ``(m, l, acc[D])`` (``m`` the chunk's
    largest score in log2 units, ``scale * log2(e) * q.k``; ``l`` the sum
    of ``2^(score - m)``; ``acc`` those weights times the V rows), merged
    over each slot's live chunks ``c < ceil(lengths[s] / rows)``:
    ``sum_c acc_c w_c / max(sum_c l_c w_c, 1e-30)``, ``w_c = 2^(m_c -
    max m)``. A chunk past the length holds ``m = -1e30, l = 0, acc = 0``
    whatever its scratch held, and weighs 0; an idle lane gives a zero
    row. Returns ``[S, H, D]`` in ``dtype``."""
    partials = partials.float()
    S, H, splits, _ = partials.shape
    lengths = lengths.to(device=partials.device, dtype=torch.long)
    live = (torch.arange(splits, device=partials.device)[None, :] * rows
            < lengths[:, None])[:, None, :]                  # [S, 1, splits]
    m = torch.where(live, partials[..., 0],
                    torch.full((), NEG_INF, device=partials.device))
    l = torch.where(live, partials[..., 1],
                    torch.zeros((), device=partials.device))
    acc = torch.where(live[..., None], partials[..., 2:],
                      torch.zeros((), device=partials.device))
    w = torch.where(live, torch.exp2(m - m.amax(dim=-1, keepdim=True)),
                    torch.zeros((), device=partials.device))
    L = (l * w).sum(dim=-1)
    out = (acc * w[..., None]).sum(dim=-2)
    return (out / torch.clamp(L, min=1e-30)[..., None]).to(dtype)


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
    version; a CUDA ``q`` launches the kernels (float32 or bfloat16,
    ``D <= 256``, contiguous inputs on one device) or raises. Each call
    that launches adds one to ``paged_attention_decode.launches``, for
    its two CUDA kernels together.

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
    out = _launch(_kernel(), q, k_pages, v_pages, tables, lengths, scale)
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _launch(fn, q, k_pages, v_pages, tables, lengths, scale):
    """One call of the C entry point ``fn`` on checked CUDA tensors: the
    split plan, the output and the partials' scratch allocated, both
    kernels launched on the current stream. Raises if a launch failed."""
    S, H, D = q.shape
    ps, pps = k_pages.shape[1], tables.shape[1]
    _, splits = paged_split_plan(pps, ps)
    out = torch.empty_like(q)
    scratch = torch.empty((S, H, splits, D + 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), S, H, D, ps, pps,
                splits, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode: kernel launch failed "
                           f"(cuda error {rc})")
    return out


def _kernel():
    from horovod_tpu_torch import _build

    return bind(_build.load("paged_attention"))


def bind(lib):
    """``lib``'s ``hvd_paged_attention_decode`` with its argument types
    set (a library of ``csrc/paged_attention.cu``, or a tune variant)."""
    fn = lib.hvd_paged_attention_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, vp]
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


# --------------------------------------------------------------------------
# Timing geometries (``chip_smoke.py`` and ``tune_paged.py``)

#: The serving shapes: ``tools/serve_bench.py``'s defaults at GPT-2-small
#: width (Lmax 384, page 16, 8 decode slots, ``num_pages = (8 + 1) * 24 +
#: 1``).
SERVING_GEOMETRY = dict(H=12, D=64, ps=16, pps=24, num_pages=217,
                        lengths=[0, 1, 16, 17, 384, 100, 250, 383])
#: A long-context geometry, where the K/V bytes dwarf a launch: 32 slots
#: of up to 2048 keys at the same width, lengths from a numpy seed.
LONG_GEOMETRY = dict(H=12, D=64, ps=16, pps=128, slots=32, seed=2048)


def long_context_lengths():
    """The long-context geometry's slot lengths: 0, 1, 16, 17 and 2048,
    then draws from a numpy seed in 1..2048."""
    import numpy as np

    rng = np.random.default_rng(LONG_GEOMETRY["seed"])
    fixed = [0, 1, 16, 17, 2048]
    return fixed + rng.integers(
        1, 2049, LONG_GEOMETRY["slots"] - len(fixed)).tolist()


def geometry(name: str):
    """``"serving"`` or ``"long"`` as keyword arguments of
    :func:`decode_inputs` (``lengths``, ``H``, ``D``, ``ps``, ``pps``,
    ``num_pages``)."""
    if name == "serving":
        return dict(SERVING_GEOMETRY)
    if name != "long":
        raise ValueError(f"unknown geometry {name!r}")
    g = {k: LONG_GEOMETRY[k] for k in ("H", "D", "ps", "pps")}
    g["lengths"] = long_context_lengths()
    g["num_pages"] = None
    return g


def decode_inputs(lengths, H, D, ps, pps, dtype, seed, num_pages=None,
                  device="cuda"):
    """``(q, k_pages, v_pages, tables, lengths)`` for the given slot
    lengths: standard normal values from ``seed``, physical pages
    shuffled, the null page 0 NaN, the stale rows past each length 1e30.
    ``num_pages`` defaults to the live pages plus the null page."""
    import numpy as np

    rng = np.random.default_rng(seed)
    S = len(lengths)
    need = [-(-int(n) // ps) for n in lengths]
    P = num_pages or 1 + sum(need)
    k = rng.standard_normal((P, ps, H, D), dtype=np.float32)
    v = rng.standard_normal((P, ps, H, D), dtype=np.float32)
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    k[0] = np.nan
    v[0] = np.nan
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((S, pps), np.int32)
    nxt = 0
    for s, (n, pages) in enumerate(zip(lengths, need)):
        tables[s, :pages] = ids[nxt:nxt + pages]
        nxt += pages
        if n % ps:
            k[tables[s, n // ps], n % ps:] = 1e30
            v[tables[s, n // ps], n % ps:] = 1e30
    return (torch.tensor(q, device=device, dtype=dtype),
            torch.tensor(k, device=device, dtype=dtype),
            torch.tensor(v, device=device, dtype=dtype),
            torch.tensor(tables, device=device),
            torch.tensor(np.asarray(lengths, np.int32), device=device))


def decode_work(lengths, H, D, ps, elt):
    """The least ``(bytes, flops)`` of one call: the K/V rows below each
    slot's length read once, q read and out written once, the live table
    entries and the lengths read once; 4 flops per live K/V element (the
    q.k and p.v multiply-adds). ``elt`` is the bytes of one element."""
    live_pages = sum(-(-int(n) // ps) for n in lengths)
    rows = sum(int(n) for n in lengths)
    nbytes = (rows * H * D * 2 * elt + 2 * len(lengths) * H * D * elt
              + live_pages * 4 + len(lengths) * 4)
    return nbytes, 4 * H * D * rows
