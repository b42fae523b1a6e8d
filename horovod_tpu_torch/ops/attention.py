"""Attention of the port (``horovod_tpu.ops.attention``).

* :func:`dot_product_attention` — the plain reference attention; the
  serving path's prefill lane, ``lm_prefill`` and the engine's gather
  decode path use it, and so does ``TransformerLM`` with ``attn_fn=None``.
* :func:`flash_attention` — streamed online-softmax attention with a
  custom backward, as a ``torch.autograd.Function``. Its three kernels are
  hand-written for Hopper in ``csrc/flash_attention.cu`` (built by
  ``nvcc`` for ``sm_90a`` at first use, bound through a plain C interface
  and ``ctypes``):

  - K1 :func:`flash_forward` — ``out`` and the per-row logsumexp ``lse``;
  - K2 :func:`flash_bwd_dq` — dQ against ``lse`` and ``D = rowsum(dO*O)``;
  - K3 :func:`flash_bwd_dkv` — dK and dV, written once each, no atomics.

  On a CPU tensor each wrapper runs its plain PyTorch version
  (:func:`flash_forward_reference`, :func:`flash_bwd_dq_reference`,
  :func:`flash_bwd_dkv_reference`), which the CPU parity tests hold
  against the JAX kernels in interpret mode; on a CUDA tensor it launches
  the kernel or raises. Each launch adds one to the wrapper's
  ``launches``.

The host math of the JAX module is copied as it is: ``_grid_truncates``,
``_causal_step_tables``, ``_pick_block``, ``_default_blocks`` and
``flash_grid_info``. It is accounting and argument validation only (the
"pad upstream" contract of ``_pick_block`` included): the CUDA kernels
pick their own tiles and mask a ragged last tile themselves.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import numpy as np
import torch

NEG_INF = -1e30  # finite stand-in for -inf: exp() of it is exactly 0



def dot_product_attention(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          q_offset: Union[int, torch.Tensor] = 0,
                          k_offset: int = 0):
    """Reference attention. Shapes: q [..., Lq, H, D], k/v [..., Lk, H, D].

    ``q_offset``/``k_offset`` are the global positions of the first
    query/key token. ``q_offset`` may also be an integer tensor of the
    batch shape ``q.shape[:-3]``: one offset per batch row, which is how
    the engine's gather path runs every decode slot at its own position
    in one call (the JAX engine ``vmap``s the scalar form).

    The numerics follow the JAX function: scores in the input dtype, the
    softmax in float32, the weights cast back to ``q.dtype`` before the
    second product.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if causal:
        lq, lk = q.shape[-3], k.shape[-3]
        ar_q = torch.arange(lq, device=q.device)
        ki = k_offset + torch.arange(lk, device=q.device)[None, :]
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() > 0:
            off = q_offset.to(q.device).reshape(
                q_offset.shape + (1, 1, 1))             # [..., 1, 1, 1]
            qi = off + ar_q[:, None]                    # [..., 1, Lq, 1]
        else:
            qi = int(q_offset) + ar_q[:, None]
        logits = torch.where(qi >= ki, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    weights = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", weights.to(q.dtype), v)


# --------------------------------------------------------------------------
# Host math, copied from the JAX module (accounting and validation only)


def _grid_truncates(causal: bool, seq_q: int, seq_k: int, q_offset: int,
                    k_offset: int, truncate: Optional[bool]) -> bool:
    """Static policy for the packed at-or-below-diagonal grid: it applies
    exactly when the mask is the standard square lower triangle (causal,
    Lq == Lk, equal offsets). ``truncate=None`` is the auto policy;
    ``False`` forces the full grid; ``True`` asserts eligibility."""
    eligible = causal and seq_q == seq_k and q_offset == k_offset
    if truncate is None:
        return eligible
    if truncate and not eligible:
        raise ValueError(
            "truncate=True requires plain causal square attention "
            f"(causal={causal}, Lq={seq_q}, Lk={seq_k}, "
            f"q_offset={q_offset}, k_offset={k_offset}): cross-attention "
            "and offset-causal grids stay full (compute-skip only)")
    return bool(truncate)


@functools.lru_cache(maxsize=None)
def _causal_step_tables(n_qblocks: int, n_kblocks: int, block_q: int,
                        block_k: int, k_major: bool = False):
    """The (q-block, k-block) pairs of the packed causal grid that
    intersect the at-or-below-diagonal region, q-major (forward, dQ) or
    k-major (dK/dV). The CUDA kernels walk the same pairs as a loop bound
    inside each block."""
    pairs = []
    if k_major:
        for kb in range(n_kblocks):
            pairs.extend((qi, kb)
                         for qi in range((kb * block_k) // block_q,
                                         n_qblocks))
    else:
        for qi in range(n_qblocks):
            last = min(n_kblocks - 1,
                       (qi * block_q + block_q - 1) // block_k)
            pairs.extend((qi, kb) for kb in range(last + 1))
    qi_tab = np.asarray([p[0] for p in pairs], np.int32)
    kb_tab = np.asarray([p[1] for p in pairs], np.int32)
    return qi_tab, kb_tab


def flash_grid_info(seq_q: int, seq_k: int, *, causal: bool,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    q_offset: int = 0, k_offset: int = 0,
                    truncate: Optional[bool] = None,
                    head_dim: Optional[int] = None,
                    batch_heads: int = 1, dtype_bytes: int = 2):
    """Static grid + K/V-DMA accounting of the JAX kernels' tiling for a
    ``flash_attention`` call (the dict of the JAX function, equal to it)."""
    dq, dk = _default_blocks(seq_q, seq_k)
    bq = min(block_q if block_q is not None else dq, seq_q)
    bk = min(block_k if block_k is not None else dk, seq_k)
    nqb, nkb = seq_q // bq, seq_k // bk
    truncated = _grid_truncates(causal, seq_q, seq_k, q_offset, k_offset,
                                truncate)
    steps_full = nqb * nkb
    if truncated:
        qi_tab, _ = _causal_step_tables(nqb, nkb, bq, bk)
        steps = int(qi_tab.size)
    else:
        steps = steps_full
    info = {
        "block_q": bq, "block_k": bk,
        "n_qblocks": nqb, "n_kblocks": nkb,
        "truncated": truncated,
        "grid": ([batch_heads, steps] if truncated
                 else [batch_heads, nqb, nkb]),
        "steps": steps, "steps_full": steps_full,
        "kv_fetch_frac": round(steps / steps_full, 4),
        "kv_bytes": None, "kv_bytes_full": None,
    }
    if head_dim is not None:
        tile = 2 * bk * head_dim * dtype_bytes * batch_heads
        info["kv_bytes"] = steps * tile
        info["kv_bytes_full"] = steps_full * tile
    return info


_MIN_BLOCK = 8


def _pick_block(cap: int, seq_len: int) -> int:
    """Largest ladder block <= cap that divides ``seq_len``, floored at 8;
    a length with no such divisor is the caller's to pad."""
    for b in (cap, 256, 128, 64, 32, 16, _MIN_BLOCK):
        if _MIN_BLOCK <= b <= cap and b <= seq_len and seq_len % b == 0:
            return b
    raise ValueError(
        f"flash_attention has no legal default block tile for sequence "
        f"length {seq_len}: no divisor >= the native {_MIN_BLOCK}-sublane "
        f"TPU tile. Pad the sequence length upstream to a multiple of "
        f"{_MIN_BLOCK} (ideally 128), or pass explicit block_q/block_k.")


def _default_blocks(seq_q: int, seq_k: int):
    """The JAX kernels' block policy (a TPU VMEM policy, kept for the
    accounting and the error contract; the CUDA kernels tile by 64)."""
    return (_pick_block(256, seq_q),
            _pick_block(512 if seq_k <= 2048 else 256, seq_k))


_BWD_IMPLS = ("auto", "scan", "kernel")


def resolve_bwd_impl(bwd_impl: Optional[str], seq_k: int) -> str:
    """The backward a ``flash_attention`` call runs: ``"kernel"`` (K2 +
    K3; the port's name for the JAX package's ``"pallas"``) or
    ``"scan"`` (the port of the XLA scan backward, plain torch).

    ``None`` and ``"auto"`` resolve to ``"kernel"`` at every key length:
    on the H100 (NVIDIA H100 80GB HBM3, 700 W) K2 + K3 beat the scan
    backward at every key length measured, 256 to 16384, by 9x at 256
    (``python -m horovod_tpu_torch.tune_flash --crossover``; PERF.md,
    PR 7, c1c). The JAX package's crossover, the scan below Lk 8192, was
    measured on a TPU and does not carry over; ``seq_k`` stays for the
    JAX signature."""
    impl = "auto" if bwd_impl is None else bwd_impl
    if impl not in _BWD_IMPLS:
        raise ValueError(f"bwd_impl must be auto|scan|kernel, "
                         f"got {bwd_impl!r}")
    return "kernel" if impl == "auto" else impl


# --------------------------------------------------------------------------
# Plain versions of K1-K3 (the CPU path, and the card-side yardstick)


def _masked_scores(q, k, causal, scale, delta):
    """float32 ``q.k * scale`` as ``[B, H, Lq, Lk]``, causal positions
    shifted by ``delta = q_offset - k_offset``, masked to ``NEG_INF``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = delta + torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s,
                        torch.full((), NEG_INF, device=q.device))
    return s


def flash_forward_reference(q, k, v, causal: bool = False,
                            scale: Optional[float] = None,
                            q_offset: int = 0, k_offset: int = 0):
    """K1's plain version: ``(out [B, Lq, H, D] in q.dtype, lse [B, H, Lq]
    float32)``, with the kernel's rounding points: float32 scores and
    statistics, ``p`` cast to v's dtype before ``p.V``, ``out = acc /
    max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, causal, scale, q_offset - k_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.squeeze(-1).transpose(1, 2)[..., None]
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, d, causal, scale, delta):
    s = _masked_scores(q, k, causal, scale, delta)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - d[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, d, causal: bool = False,
                           scale: Optional[float] = None,
                           q_offset: int = 0, k_offset: int = 0):
    """K2's plain version: ``P = exp(S - lse)``, ``dS = P * (dO V^T -
    D)``, ``dQ = (dS cast to k's dtype) K * scale``, in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _probs_and_ds(q, k, v, do, lse, d, causal, scale,
                          q_offset - k_offset)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, d, causal: bool = False,
                            scale: Optional[float] = None,
                            q_offset: int = 0, k_offset: int = 0):
    """K3's plain version: ``dV = (P^T cast to dO's dtype) dO`` and
    ``dK = (dS^T cast to q's dtype) Q * scale``, in k's and v's dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _probs_and_ds(q, k, v, do, lse, d, causal, scale,
                          q_offset - k_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_scan(q, k, v, o, lse, do, causal, scale, block_k,
                    q_offset, k_offset):
    """The port of the JAX package's XLA scan backward: one pass per key
    block computing dq/dk/dv together; causal walks only the key blocks
    at or below the last query row's diagonal (the rest stay zero)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    bk = min(block_k, Lk)
    nkb = Lk // bk
    delta = q_offset - k_offset
    if causal:
        nkb_live = max(1, min(nkb, max(0, delta + Lq - 1) // bk + 1))
    else:
        nkb_live = nkb
    f32 = torch.float32
    d_row = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, H, Lq]
    q_pos = delta + torch.arange(Lq, device=q.device)[:, None]
    qf, dof = q.float(), do.float()
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dks, dvs = [], []
    for jb in range(nkb_live):
        kb = k[:, jb * bk:(jb + 1) * bk]
        vb = v[:, jb * bk:(jb + 1) * bk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            k_pos = jb * bk + torch.arange(bk, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s,
                            torch.full((), NEG_INF, device=q.device))
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb.float())
        ds = p * (dp - d_row[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                               kb.float()) * scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                                qf) * scale)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                                dof))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    if nkb_live < nkb:
        pad = (0, 0, 0, 0, 0, Lk - nkb_live * bk)
        dk = torch.nn.functional.pad(dk, pad)
        dv = torch.nn.functional.pad(dv, pad)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (K1-K3)

#: dtypes the kernels take, with the code their C interface expects.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_BATCH_HEADS = 65535          # the grid's y dimension


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} must be [B, L, H, D] with k and v alike")
    B, _, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "differ in batch, heads or head dim")


def _on_kernel_path(name, q, tensors):
    """True for a CUDA ``q`` whose inputs the kernel takes; False for a
    CPU ``q`` (the plain version); raises for anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in "
                         f"{list(_KERNEL_DTYPES)}")
    for tname, t, dtype in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype}, expected "
                             f"{dtype}")
    B, _, H, D = q.shape
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {_MAX_HEAD_DIM}")
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"{name}: batch x heads {B * H} > "
                         f"{_MAX_BATCH_HEADS}")
    return True


def _strides(name, tname, t):
    """(batch, seq, head) strides in elements of a [B, L, H, D] tensor
    whose head dim is contiguous: the kernels read views in place."""
    if t.stride(3) != 1:
        raise ValueError(f"{name}: {tname} must have a contiguous last "
                         "(head) dimension")
    return (t.stride(0), t.stride(1), t.stride(2))


def _stats(name, tname, t, B, H, L):
    if tuple(t.shape) != (B, H, L) or not t.is_contiguous():
        raise ValueError(f"{name}: {tname} must be a contiguous float32 "
                         f"[B, H, Lq] = {(B, H, L)}, got {tuple(t.shape)}")


def _launch(name, symbol, args, q):
    fn = _kernel(symbol)
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cuda error "
                           f"{rc})")


def flash_forward(q, k, v, causal: bool = False,
                  scale: Optional[float] = None, q_offset: int = 0,
                  k_offset: int = 0):
    """K1: attention forward, ``(out [B, Lq, H, D] in q.dtype, lse [B, H,
    Lq] float32)``. q ``[B, Lq, H, D]``, k/v ``[B, Lk, H, D]`` may be
    views with any (batch, seq, head) strides and a contiguous head dim.
    A CPU ``q`` runs :func:`flash_forward_reference`; a CUDA ``q``
    launches the kernel (float32 or bfloat16, ``D <= 128``) or raises.
    Each launch adds one to ``flash_forward.launches``."""
    _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    name = "flash_forward"
    if not _on_kernel_path(name, q, (("k", k, q.dtype), ("v", v, q.dtype))):
        return flash_forward_reference(q, k, v, causal, scale, q_offset,
                                       k_offset)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _launch(name, "hvd_flash_fwd", (
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D,
        *_strides(name, "q", q), *_strides(name, "k", k),
        *_strides(name, "v", v), float(scale), int(bool(causal)),
        int(q_offset - k_offset)), q)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def _bwd_inputs(k, v, do, lse, d, dtype):
    f32 = torch.float32
    return (("k", k, dtype), ("v", v, dtype), ("dO", do, dtype),
            ("lse", lse, f32), ("D", d, f32))


def _bwd_args(name, q, k, v, do, lse, d):
    B, Lq, H, D = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    _stats(name, "lse", lse, B, H, Lq)
    _stats(name, "D", d, B, H, Lq)
    return (_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), d.data_ptr())


def _bwd_geometry(name, q, k, v, do, scale, causal, q_offset, k_offset):
    B, Lq, H, D = q.shape
    return (B, H, Lq, k.shape[1], D, *_strides(name, "q", q),
            *_strides(name, "k", k), *_strides(name, "v", v),
            *_strides(name, "dO", do), float(scale), int(bool(causal)),
            int(q_offset - k_offset))


def flash_bwd_dq(q, k, v, do, lse, d, causal: bool = False,
                 scale: Optional[float] = None, q_offset: int = 0,
                 k_offset: int = 0):
    """K2: dQ ``[B, Lq, H, D]`` in q's dtype from the forward's ``lse``
    and ``d = rowsum(dO * O)`` (both float32 ``[B, H, Lq]``, contiguous).
    A CPU ``q`` runs :func:`flash_bwd_dq_reference`; a CUDA ``q``
    launches the kernel or raises. Each launch adds one to
    ``flash_bwd_dq.launches``."""
    _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    name = "flash_bwd_dq"
    if not _on_kernel_path(name, q, _bwd_inputs(k, v, do, lse, d, q.dtype)):
        return flash_bwd_dq_reference(q, k, v, do, lse, d, causal, scale,
                                      q_offset, k_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(name, "hvd_flash_bwd_dq", (
        *_bwd_args(name, q, k, v, do, lse, d), dq.data_ptr(),
        *_bwd_geometry(name, q, k, v, do, scale, causal, q_offset,
                       k_offset)), q)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, d, causal: bool = False,
                  scale: Optional[float] = None, q_offset: int = 0,
                  k_offset: int = 0):
    """K3: ``(dK, dV)`` ``[B, Lk, H, D]`` in k's and v's dtypes, each
    written once (no atomics: deterministic). Inputs as
    :func:`flash_bwd_dq`. A CPU ``q`` runs
    :func:`flash_bwd_dkv_reference`; a CUDA ``q`` launches the kernel or
    raises. Each launch adds one to ``flash_bwd_dkv.launches``."""
    _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    name = "flash_bwd_dkv"
    if not _on_kernel_path(name, q, _bwd_inputs(k, v, do, lse, d, q.dtype)):
        return flash_bwd_dkv_reference(q, k, v, do, lse, d, causal, scale,
                                       q_offset, k_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(name, "hvd_flash_bwd_dkv", (
        *_bwd_args(name, q, k, v, do, lse, d), dk.data_ptr(),
        dv.data_ptr(),
        *_bwd_geometry(name, q, k, v, do, scale, causal, q_offset,
                       k_offset)), q)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


#: argtypes of the three C entry points (c_void_p for every pointer and
#: the stream, c_longlong for strides, c_int for ints).
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEOM = [_CI] * 5 + [_CL] * 9
_TAIL = [ctypes.c_float, _CI, _CI, _VP]
_ARGTYPES = {
    "hvd_flash_fwd": [_CI] + [_VP] * 5 + _GEOM + _TAIL,
    "hvd_flash_bwd_dq": [_CI] + [_VP] * 7 + _GEOM + [_CL] * 3 + _TAIL,
    "hvd_flash_bwd_dkv": [_CI] + [_VP] * 8 + _GEOM + [_CL] * 3 + _TAIL,
}


def _kernel(symbol):
    from horovod_tpu_torch import _build

    fn = getattr(_build.load("flash_attention"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = _CI
    return fn


# --------------------------------------------------------------------------
# The public function


class _FlashAttention(torch.autograd.Function):
    """Forward through K1; backward through K2 + K3 (``"kernel"``) or the
    scan port (``"scan"``). ``D = rowsum(dO * O)`` is plain torch, as the
    JAX wrapper computes it outside its kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset, impl,
                block_k):
        out, lse = flash_forward(q, k, v, causal, scale, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, q_offset, k_offset, impl, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset, k_offset, impl, block_k = ctx.cfg
        if do.stride(-1) != 1:
            do = do.contiguous()
        if impl == "scan":
            dq, dk, dv = _flash_bwd_scan(q, k, v, out, lse, do, causal,
                                         scale, block_k, q_offset, k_offset)
        else:
            d = (do.float() * out.float()).sum(-1).transpose(1, 2)
            d = d.contiguous()
            dq = flash_bwd_dq(q, k, v, do, lse, d, causal, scale, q_offset,
                              k_offset)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, d, causal, scale,
                                   q_offset, k_offset)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    bwd_impl: Optional[str] = None,
                    q_offset: int = 0, k_offset: int = 0,
                    truncate: Optional[bool] = None):
    """Flash attention, ``[B, L, H, D] -> [B, L, H, D]``, differentiable.

    The signature and the errors of the JAX function (without its
    ``interpret``): causal calls need ``q_offset >= k_offset`` (every
    query row must see a key); ``bwd_impl`` is ``auto|scan|kernel``
    (:func:`resolve_bwd_impl`); ``truncate=True`` asserts the square
    causal geometry; a length with no legal block raises the "pad
    upstream" error, and explicit ``block_q``/``block_k`` must divide the
    lengths. Blocks are accounting here (and the scan backward's key
    block): the CUDA kernels tile by 64 and mask a ragged last tile, and
    on a causal call each query tile loops only over the key tiles at or
    below its diagonal, the GPU form of the packed grid.

    The forward runs K1; the ``"kernel"`` backward K2 and K3, the
    ``"scan"`` backward the plain-torch scan port."""
    Lq, Lk = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq, dk = _default_blocks(Lq, Lk)
    block_q = dq if block_q is None else block_q
    block_k = dk if block_k is None else block_k
    impl = resolve_bwd_impl(bwd_impl, Lk)
    if causal and q_offset < k_offset:
        raise ValueError(
            f"causal flash_attention requires q_offset >= k_offset "
            f"(got {q_offset} < {k_offset}): rows with no visible key "
            f"have no defined softmax")
    _grid_truncates(causal, Lq, Lk, q_offset, k_offset, truncate)
    if Lq % min(block_q, Lq) or Lk % min(block_k, Lk):
        raise ValueError(
            f"flash_attention: sequence lengths ({Lq}, {Lk}) must be "
            f"multiples of the blocks ({block_q}, {block_k}); pad upstream")
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                 int(q_offset), int(k_offset), impl,
                                 int(block_k))
