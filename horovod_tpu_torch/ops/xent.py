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

``tp_vocab_cross_entropy`` (the Megatron-style vocab-parallel head) waits
for the parallelism item of the roadmap and raises.
"""

from __future__ import annotations

import torch
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


def tp_vocab_cross_entropy(*args, **kwargs):
    """The vocab-parallel head of the JAX package: not ported yet."""
    raise NotImplementedError(
        "tp_vocab_cross_entropy shards the head over a tensor-parallel "
        "axis, which the port does not have yet (ROADMAP.md Queue 1, "
        "parallelism)")
