"""Reference attention of the port (``horovod_tpu.ops.attention``).

Only the plain ``dot_product_attention`` and ``NEG_INF`` are here: the
serving path's prefill lane, ``lm_prefill`` and the engine's gather
decode path use it. The flash-attention kernels of the JAX module are
training-path kernels and are ported with the training slice
(ROADMAP.md, Queue 2: K1-K3).
"""

from __future__ import annotations

import math
from typing import Optional, Union

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
