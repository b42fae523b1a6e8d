"""Ring attention: exact attention over a sequence sharded across ranks,
the port of ``horovod_tpu.parallel.ring_attention``.

Each rank holds a sequence shard of Q, K and V. The K/V blocks rotate
around the sequence axis (:func:`~horovod_tpu_torch.parallel.
_collectives.send_shifted`, the ``ppermute`` primitive) while every rank
accumulates its queries' attention over each visiting block with the
online-softmax recurrence in float32, so a rank holds ``O(L_local^2)``
scores at a time instead of ``O(L^2)``. The causal mask compares global
positions (``rank * Lq + i >= src * Lk + j``), so the result is
single-rank attention over the gathered sequence.

The products are ``torch.einsum`` s, as the JAX function's are XLA
einsums outside any Pallas kernel.

**The backward is written by hand.** Autograd through the loop would
keep each step's probabilities, and, with the causal skip, a rank whose
later visitors are all above its diagonal would never reach their
rotations in its backward while the other ranks wait on them. The
:class:`_Ring` function keeps ``q, k, v``, the output and the
log-sum-exp, and its backward walks the ring again in the forward's
order: each rank recomputes a visiting block's probabilities, adds its
``dQ`` term, and adds the block's ``dK``/``dV`` terms to accumulators
that travel with the block; after ``size`` rotations every block is home
with its gradients. Every rotation, forward and backward, runs on every
rank (the collectives stay rank-uniform); only compute is skipped.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from horovod_tpu_torch.ops.attention import NEG_INF
from horovod_tpu_torch.parallel._collectives import axis_group, send_shifted
from horovod_tpu_torch.parallel.logical import module_axis


def _scores(qf, kb, causal, rank, src, Lq, Lk):
    """``[B, H, Lq, Lk]`` float32 scores of the local (scaled) queries
    against one visiting block, masked at global positions."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
    if causal:
        q_pos = rank * Lq + torch.arange(Lq, device=qf.device)[:, None]
        k_pos = src * Lk + torch.arange(Lk, device=qf.device)[None, :]
        s = torch.where(q_pos >= k_pos, s,
                        torch.full((), NEG_INF, device=qf.device))
    return s


def _live(causal, rank, src, Lq, Lk):
    """False for a visiting block wholly above this rank's diagonal: its
    first global key position is past this shard's last query row."""
    return not causal or rank * Lq + Lq - 1 >= src * Lk


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, size, rank, causal, scale, skip):
        B, Lq, H, D = q.shape
        Lk = k.shape[1]
        qf = q.float() * scale
        kv = torch.stack([k, v])
        m = torch.full((B, H, Lq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, Lq), device=q.device)
        acc = torch.zeros((B, H, Lq, D), device=q.device)
        for p in range(size):
            src = (rank - p) % size       # owner of the block held now
            if skip and not _live(causal, rank, src, Lq, Lk):
                ring_attention.skipped += 1
            else:
                s = _scores(qf, kv[0].float(), causal, rank, src, Lq, Lk)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p_exp = torch.exp(s - m_new[..., None])
                l = l * alpha + p_exp.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p_exp, kv[1].float())
                m = m_new
            # The last rotation brings the blocks home, as in the JAX
            # loop: every rank feeds the collective on every step.
            kv = send_shifted(kv, group, size, rank, 1)
        out = acc / l.clamp_min(1e-30)[..., None]        # [B, H, Lq, D]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.cfg = (group, size, rank, causal, scale, skip)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, size, rank, causal, scale, skip = ctx.cfg
        Lq, Lk = q.shape[1], k.shape[1]
        qf = q.float() * scale
        dof = do.float().transpose(1, 2)                 # [B, H, Lq, D]
        delta = (dof * out).sum(-1)                      # [B, H, Lq]
        dq = torch.zeros_like(qf)                        # [B, Lq, H, D]
        # The visiting block and its gradient accumulators travel
        # together: [k, v, dk, dv], float32.
        kf = k.float()
        blk = torch.stack([kf, v.float(), torch.zeros_like(kf),
                           torch.zeros_like(kf)])
        for p in range(size):
            src = (rank - p) % size
            if not (skip and not _live(causal, rank, src, Lq, Lk)):
                kb, vb = blk[0], blk[1]
                s = _scores(qf, kb, causal, rank, src, Lq, Lk)
                prob = torch.exp(s - lse[..., None])     # [B, H, Lq, Lk]
                blk[3] += torch.einsum("bhqk,bhqd->bkhd", prob, dof)
                dp = torch.einsum("bhqd,bkhd->bhqk", dof, vb)
                ds = prob * (dp - delta[..., None])
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
                blk[2] += torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            blk = send_shifted(blk, group, size, rank, 1)
        return ((dq * scale).to(q.dtype), blk[2].to(k.dtype),
                blk[3].to(v.dtype), None, None, None, None, None, None)


def ring_attention(q, k, v, axis: Optional[str] = None, causal: bool = False,
                   scale: Optional[float] = None,
                   skip_dead_blocks: Optional[bool] = None):
    """Exact multi-head attention over a sequence-sharded mesh axis.

    Per-rank shapes: q, k, v ``[B, L_local, H, D]`` -> ``[B, L_local, H,
    D]`` in ``q.dtype``; every rank of ``axis`` (the bound mesh's
    sequence axis by default) calls it with its shard, rank ``r``
    holding global positions ``r * L_local ...``.

    ``skip_dead_blocks`` (causal only) skips the products of a visiting
    block wholly above this rank's diagonal (at 4 ranks, 6 of the 16
    block-steps); the rotation runs all the same. The JAX default turns
    it on only where its runtime can transpose the rank-divergent branch;
    a rank here is a process with its own graph, so ``None`` takes the
    skip for every causal call, and ``False`` runs the masked products,
    numerically the same. Each skipped block-step of a forward adds one
    to ``ring_attention.skipped``."""
    axis = module_axis("seq", axis)
    group, size, rank = axis_group(axis, role="seq")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    skip = bool(causal) and skip_dead_blocks is not False
    return _Ring.apply(q, k, v, group, size, rank, bool(causal),
                       float(scale), skip)


ring_attention.skipped = 0
