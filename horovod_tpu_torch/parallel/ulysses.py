"""Ulysses sequence parallelism: all-to-all head/sequence resharding, the
port of ``horovod_tpu.parallel.ulysses``.

Instead of rotating K/V, one all-to-all reshards ``[B, L/P, H, D]``
(sequence-sharded) into ``[B, L, H/P, D]`` (head-sharded), full
attention runs locally over each rank's head group, and a second
all-to-all reshards back. The communication is two all-to-alls of the
activations whatever the sequence length: cheaper than ring attention
where ``H >= P`` and the whole sequence fits one card, where ring
attention wins when ``L_local^2`` dominates.

With ``use_flash=True`` the local attention is the port's
:func:`~horovod_tpu_torch.ops.attention.flash_attention`: K1 forward and
K2/K3 backward on CUDA tensors, over the full sequence at offset 0 (the
causal at-or-below-diagonal grid), and the plain versions on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

from horovod_tpu_torch.ops.attention import dot_product_attention
from horovod_tpu_torch.parallel._collectives import all_to_all, axis_group
from horovod_tpu_torch.parallel.logical import module_axis


def _seq_to_heads(x, axis: str):
    # [B, L/P, H, D] -> [B, L, H/P, D]
    return all_to_all(x, axis, split_dim=2, concat_dim=1)


def _heads_to_seq(x, axis: str):
    # [B, L, H/P, D] -> [B, L/P, H, D]
    return all_to_all(x, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, axis: Optional[str] = None,
                      causal: bool = False,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None,
                      use_flash: bool = False):
    """All-to-all sequence-parallel attention.

    Per-rank shapes ``[B, L_local, H, D] -> [B, L_local, H, D]``; the
    head count must divide by the axis size (else ``ValueError``, before
    any collective). ``attn_fn(q, k, v, causal=, scale=)`` defaults to
    :func:`~horovod_tpu_torch.ops.attention.dot_product_attention`;
    ``use_flash=True`` is the shorthand for the flash kernels. Every rank
    of ``axis`` (the bound mesh's sequence axis by default) calls it."""
    axis = module_axis("seq", axis)
    _, size, _ = axis_group(axis, role="seq")
    H = q.shape[2]
    if H % size != 0:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by axis size ({size}); "
            "use ring_attention for head counts below the mesh size")
    if use_flash and attn_fn is None:
        from horovod_tpu_torch.ops.attention import flash_attention

        attn_fn = flash_attention
    qh = _seq_to_heads(q, axis)
    kh = _seq_to_heads(k, axis)
    vh = _seq_to_heads(v, axis)
    if attn_fn is None:
        out = dot_product_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        out = attn_fn(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(out, axis)
