"""Expert parallelism: Switch-style top-1 MoE with all-to-all dispatch,
the port of ``horovod_tpu.parallel.moe``.

Experts shard over an expert axis of the bound
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh` (``"ep"``;
``E_local = E / P`` experts a rank). Routing builds dispatch/combine
tensors from a top-1 softmax gate with capacity dropping (Switch
Transformer), then two all-to-alls move token slots: tokens to their
expert's rank, expert outputs back. The einsum formulation keeps
everything dense: every rank sends ``[P, E_local, C, D]`` slots, zeros
where it routed nothing, so every rank runs both all-to-alls forward and
backward. Dropped tokens pass through the caller's residual (their
combine weights are zero).

Call it on each rank of the axis with that rank's tokens ``[T, D]``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves

from horovod_tpu_torch.parallel._collectives import all_to_all, axis_group


def top1_routing(x, gate_w, num_experts: int, capacity: int):
    """Switch top-1 routing. ``x [T, D] -> (dispatch [T, E, C] one-hot,
    combine [T, E, C] gate-weighted, aux_loss scalar)``, all float32.

    Token ``t`` goes to ``argmax`` of its softmax (the first maximum) at
    its place in that expert's queue (tokens in order), unless the queue
    already holds ``capacity`` tokens. The dispatch tensor carries no
    gradient; ``combine`` and the auxiliary load-balancing loss (Switch
    eq. 4) carry the gate's."""
    logits = x.float() @ gate_w.float()                         # [T, E]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                        # [T]
    gate = probs.amax(dim=-1)                                   # [T]
    onehot = F.one_hot(expert, num_experts).float()
    # Each token's place in its expert's queue.
    position = (torch.cumsum(onehot, dim=0) * onehot).sum(-1).long() - 1
    keep = position < capacity
    T = x.shape[0]
    dispatch = torch.zeros((T, num_experts, capacity), dtype=torch.float32,
                           device=x.device)
    rows = torch.arange(T, device=x.device)[keep]
    dispatch[rows, expert[keep], position[keep]] = 1.0
    combine = dispatch * gate[:, None, None]
    density = onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * num_experts
    return dispatch, combine, aux


def moe_layer(x, gate_w, expert_fn: Callable, expert_params,
              axis: Optional[str] = None, capacity_factor: float = 1.25,
              return_aux: bool = False):
    """Expert-parallel MoE layer on this rank's tokens.

    Args:
      x: this rank's tokens ``[T, D]``.
      gate_w: router weights ``[D, E]`` (replicated).
      expert_fn: ``(params_one_expert, tokens [N, D]) -> [N, D]``; it
        runs once per local expert over every source rank's slots, under
        ``torch.func.vmap`` (the counterpart of ``jax.vmap``).
      expert_params: this rank's experts' params, leading dim
        ``E_local`` (rank ``r`` holds experts ``[r * E_local, (r + 1) *
        E_local)``: :func:`~horovod_tpu_torch.models.parallel_lm.
        shard_lm_params` with ``moe_lm_param_specs``).
      axis: the expert axis (``None``: the bound mesh's ``expert`` role).

    Returns ``y [T, D]`` (and the auxiliary loss with ``return_aux``)."""
    _, size, _ = axis_group(axis, role="expert")
    T, D = x.shape
    e_local = tree_leaves(expert_params)[0].shape[0]
    num_experts = e_local * size
    capacity = max(1, math.ceil(T * capacity_factor / num_experts))

    dispatch, combine, aux = top1_routing(x, gate_w, num_experts, capacity)

    # [T, E, C] x [T, D] -> [E, C, D]: expert slots filled with tokens.
    slots = torch.einsum("tec,td->ecd", dispatch, x.float())
    # Reshard tokens to the expert ranks. The all-to-all over dim 0 in
    # chunks of one is a rank transpose: recv[s] = what rank s sent to
    # this rank. Rank r owns global experts [r*e_local, (r+1)*e_local),
    # so recv[s, le] holds rank s's slots for local expert le.
    slots = slots.reshape(size, e_local, capacity, D)
    recv = all_to_all(slots, axis, 0, 0, role="expert")  # [P, e_local, C, D]
    # Each local expert takes every source's slots in one product.
    tokens = recv.transpose(0, 1).reshape(e_local, size * capacity, D)
    out = torch.func.vmap(expert_fn)(expert_params, tokens.to(x.dtype))
    out = out.float().reshape(e_local, size, capacity, D).transpose(0, 1)

    # Route back: the same transpose returns the processed slots to the
    # rank that dispatched them; the leading dims read as (owner rank,
    # local expert) give the global expert g = r * e_local + le.
    back = all_to_all(out.contiguous(), axis, 0, 0, role="expert")
    back = back.reshape(num_experts, capacity, D)
    y = torch.einsum("tec,ecd->td", combine, back).to(x.dtype)
    if return_aux:
        return y, aux
    return y
