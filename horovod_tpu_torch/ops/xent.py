"""Chunked fused softmax-cross-entropy: the port of
``horovod_tpu.ops.xent``. The LM's ``[T, V]`` logits never materialize.

:func:`fused_cross_entropy` computes

    sum over tokens of  weight_i * -log softmax(h @ w.T)[target_i] / denom

chunk by chunk over the token axis (the JAX function's ``lax.scan``): each
chunk forms one ``[t_chunk, V]`` float32 logits block, reduces it at once
to the per-token logsumexp and target logit, and drops it. The backward
recomputes each chunk's logits, forms ``(softmax - onehot) * weight * g /
denom``, writes that chunk's rows of ``dh`` and accumulates ``dw`` in a
float32 buffer.

``w`` is ``[V, E]``, the layout of ``nn.Linear.weight`` (the JAX function
takes ``[E, V]``), so ``dw`` accumulates as ``dl^T @ h_chunk`` in the
weight's own layout and no chunk transposes a copy. The chunk products are
``torch.matmul`` in float32, as the JAX function's ``jnp.dot`` runs outside
any Pallas kernel; the port's no-TF32 policy (``_device.py``) keeps them
full float32 on the card.

:func:`tp_vocab_cross_entropy` is the Megatron-style vocab-parallel
head: each rank holds ``w_local [V/P, E]``, the normaliser is assembled
chunk by chunk with an all-reduce MAX and an all-reduce SUM over the
tensor axis (two values a token on the wire instead of a ``V``-wide
all-gather) and the target logit with a masked SUM. It is plain PyTorch
and collectives, as the JAX function is plain ``jnp`` and ``psum``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _pad_all(h, targets, weights, t_chunk: int):
    """Pad the token axis to a multiple of ``t_chunk``; padded rows carry
    weight 0 and target 0 (any valid index)."""
    pad = (-h.shape[0]) % t_chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        weights = F.pad(weights, (0, pad))
    return h, targets, weights


def _fill_defaults(h, weights, denom):
    """Weights 1 and ``denom = sum(weights)`` by default, both float32 and
    detached: they are bookkeeping, never differentiated (the JAX
    function's ``stop_gradient``)."""
    if weights is None:
        weights = torch.ones(h.shape[0], dtype=torch.float32,
                             device=h.device)
    else:
        weights = weights.detach().to(torch.float32)
    if denom is None:
        denom = weights.sum()
    else:
        denom = torch.as_tensor(denom, dtype=torch.float32,
                                device=h.device).detach()
    return weights, denom


def _chunk_logits(hc, w32):
    """One chunk's float32 logits ``[t_chunk, V]``."""
    return torch.matmul(hc.to(torch.float32), w32.t())


class _FusedCrossEntropy(torch.autograd.Function):
    """The JAX ``_fce`` custom VJP. Saves ``h``, ``w``, ``targets``,
    ``weights`` and ``denom`` only; the chunks are formed again in the
    backward."""

    @staticmethod
    def forward(ctx, h, w, targets, weights, denom, t_chunk):
        w32 = w.to(torch.float32)
        hp, tp, wp = _pad_all(h, targets, weights, t_chunk)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, hp.shape[0], t_chunk):
            logits = _chunk_logits(hp[s:s + t_chunk], w32)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, tp[s:s + t_chunk, None])[:, 0]
            total = total + ((lse - tgt) * wp[s:s + t_chunk]).sum()
        ctx.save_for_backward(h, w, targets, weights, denom)
        ctx.t_chunk = t_chunk
        return total / denom

    @staticmethod
    def backward(ctx, g):
        h, w, targets, weights, denom = ctx.saved_tensors
        t_chunk = ctx.t_chunk
        w32 = w.to(torch.float32)
        hp, tp, wp = _pad_all(h, targets, weights, t_chunk)
        scale = g / denom
        T = h.shape[0]
        dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for s in range(0, hp.shape[0], t_chunk):
            hc = hp[s:s + t_chunk].to(torch.float32)
            dl = torch.softmax(_chunk_logits(hc, w32), dim=-1)
            rows = torch.arange(dl.shape[0], device=dl.device)
            # softmax - onehot: only the target column moves.
            dl[rows, tp[s:s + t_chunk]] -= 1.0
            dl *= (wp[s:s + t_chunk] * scale)[:, None]
            n = min(t_chunk, T - s)
            dh[s:s + n] = torch.matmul(dl[:n], w32).to(h.dtype)
            dw.addmm_(dl.t(), hc)
        return dh, dw.to(w.dtype), None, None, None, None


def fused_cross_entropy(h, w, targets, t_chunk: int = 512, weights=None,
                        denom=None):
    """Weighted NLL without materializing the ``[T, V]`` logits.

    ``h [T, E]`` (any float dtype; the products accumulate in float32),
    ``w [V, E]`` (``nn.Linear.weight``'s layout), ``targets [T]`` integer
    ids -> a float32 scalar. The defaults (weights 1, ``denom = T``) give
    the mean NLL; a sharded caller passes validity weights and a global
    ``denom``. ``weights`` and ``denom`` are non-differentiable
    bookkeeping: no gradient flows to them."""
    if t_chunk < 1:
        raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"fused_cross_entropy takes h [T, E] and w [V, E]; "
                         f"got {tuple(h.shape)} and {tuple(w.shape)}")
    weights, denom = _fill_defaults(h, weights, denom)
    return _FusedCrossEntropy.apply(h, w, targets.long(), weights, denom,
                                    int(t_chunk))


def _vp_chunk_stats(hc, w32, tc, group, index, v_local):
    """One chunk's float32 local logits ``[t, V/P]`` and its per-token
    global ``lse`` and target logit, assembled over ``group``."""
    logits = _chunk_logits(hc, w32)
    gmax = logits.amax(dim=-1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    sums = torch.exp(logits - gmax[:, None]).sum(dim=-1)
    dist.all_reduce(sums, group=group)
    lse = gmax + torch.log(sums)
    local_t = tc - index * v_local
    in_range = (local_t >= 0) & (local_t < v_local)
    picked = logits.gather(1, local_t.clamp(0, v_local - 1)[:, None])[:, 0]
    tgt = torch.where(in_range, picked, torch.zeros((), device=hc.device))
    dist.all_reduce(tgt, group=group)
    return logits, lse, local_t, in_range, tgt


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """The JAX ``_vp`` custom VJP: saves only the inputs and recomputes
    each chunk's logits in the backward; ``dw`` stays rank-local (the
    dense ``dw``'s vocab slice) and ``dh`` is summed over the shards."""

    @staticmethod
    def forward(ctx, h, w_local, targets, weights, denom, t_chunk, group,
                index):
        w32 = w_local.to(torch.float32)
        v_local = w_local.shape[0]
        hp, tp, wp = _pad_all(h, targets, weights, t_chunk)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, hp.shape[0], t_chunk):
            _, lse, _, _, tgt = _vp_chunk_stats(
                hp[s:s + t_chunk], w32, tp[s:s + t_chunk], group, index,
                v_local)
            total = total + ((lse - tgt) * wp[s:s + t_chunk]).sum()
        ctx.save_for_backward(h, w_local, targets, weights, denom)
        ctx.t_chunk, ctx.group, ctx.index = t_chunk, group, index
        return total / denom

    @staticmethod
    def backward(ctx, g):
        h, w_local, targets, weights, denom = ctx.saved_tensors
        t_chunk, group, index = ctx.t_chunk, ctx.group, ctx.index
        w32 = w_local.to(torch.float32)
        v_local = w_local.shape[0]
        hp, tp, wp = _pad_all(h, targets, weights, t_chunk)
        scale = g / denom
        T = h.shape[0]
        dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
        dw = torch.zeros(w_local.shape, dtype=torch.float32,
                         device=w_local.device)
        for s in range(0, hp.shape[0], t_chunk):
            hc = hp[s:s + t_chunk].to(torch.float32)
            logits, lse, local_t, in_range, _ = _vp_chunk_stats(
                hc, w32, tp[s:s + t_chunk], group, index, v_local)
            dl = torch.exp(logits - lse[:, None])   # local softmax slice
            rows = torch.nonzero(in_range)[:, 0]
            # softmax - onehot: only a target column this rank holds.
            dl[rows, local_t[rows]] -= 1.0
            dl *= (wp[s:s + t_chunk] * scale)[:, None]
            dh_c = torch.matmul(dl, w32)
            # h is replicated over the axis, its logits split: dh sums
            # the shards' terms.
            dist.all_reduce(dh_c, group=group)
            n = min(t_chunk, T - s)
            dh[s:s + n] = dh_c[:n].to(h.dtype)
            dw.addmm_(dl.t(), hc)
        return (dh, dw.to(w_local.dtype), None, None, None, None, None,
                None)


def tp_vocab_cross_entropy(h, w_local, targets, axis=None,
                           t_chunk: int = 512, weights=None, denom=None):
    """Megatron-style vocab-parallel cross-entropy, chunked: each rank of
    the tensor axis holds ``w_local [V/P, E]`` (its vocab rows, rank
    order, ``nn.Linear.weight``'s layout; the JAX function takes ``[E,
    V/P]``) and the same ``h [T, E]`` and ``targets [T]``. Returns the
    global weighted NLL, the same on every rank and equal to
    :func:`fused_cross_entropy` over the whole head.

    ``axis`` resolves through the bound
    :class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`
    (:func:`~horovod_tpu_torch.parallel._collectives.axis_group`); an
    axis of size one is :func:`fused_cross_entropy`. ``weights`` and
    ``denom`` are non-differentiable bookkeeping, as there."""
    from horovod_tpu_torch.parallel._collectives import axis_group

    if t_chunk < 1:
        raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
    if h.dim() != 2 or w_local.dim() != 2 or h.shape[1] != w_local.shape[1]:
        raise ValueError(
            f"tp_vocab_cross_entropy takes h [T, E] and w_local [V/P, E]; "
            f"got {tuple(h.shape)} and {tuple(w_local.shape)}")
    group, _, index = axis_group(axis)
    if group is None:
        return fused_cross_entropy(h, w_local, targets, t_chunk,
                                   weights=weights, denom=denom)
    weights, denom = _fill_defaults(h, weights, denom)
    return _VocabParallelCrossEntropy.apply(
        h, w_local, targets.long(), weights, denom, int(t_chunk), group,
        index)
