"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis,
the port of ``horovod_tpu.parallel.pipeline``.

The JAX function's SPMD schedule: every rank runs the same ticks; rank
``r`` of the stage axis applies stage ``r``, and activations hop to the
next stage with a ``ppermute`` each tick. With ``M`` microbatches and
``P`` stages the schedule runs ``M + P - 1`` ticks (the GPipe bubble of
``(P - 1) / (M + P - 1)``).

Autograd runs each rank's backward collectives in the reverse order of
its forward's, which matches across ranks only when every rank builds
the same graph. So every rank computes every tick, bubble ticks too, as
the JAX loop does; the choices between the injected microbatch and the
received activation, and the last stage's outputs, are ``torch.where``
and a mask (graph edges on every rank, zero gradients where unselected)
rather than Python branches; and every tick's ``ppermute`` runs on every
rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_leaves, tree_map

from horovod_tpu_torch.parallel._collectives import axis_group, ppermute
from horovod_tpu_torch.parallel.logical import module_axis
from horovod_tpu_torch.parallel.tp import sum_across


def pipeline_apply(stage_fn: Callable, stage_params: Any, x,
                   axis: Optional[str] = None, remat: bool = False):
    """Run a ``P``-stage pipeline over microbatches on every rank of the
    stage axis.

    ``stage_fn(params, activation) -> activation`` is the same callable
    for every stage, with a stage-invariant activation shape.
    ``stage_params`` is this rank's stage (a pytree of tensors; a leading
    singleton stage dim on every leaf, as ``shard_lm_params`` cuts it
    from a ``[P, ...]`` stack, is squeezed). ``x`` is the microbatch
    stack ``[M, ...]``, the same on every rank. ``remat`` recomputes each
    stage application in the backward (``torch.utils.checkpoint``,
    non-reentrant). Returns ``[M, ...]``, the last stage's outputs on
    every rank (a masked cross-rank sum with an identity backward)."""
    axis = module_axis("stage", axis)
    _, size, rank = axis_group(axis, role="stage")
    fn = stage_fn
    if remat:
        def fn(p, a):
            return checkpoint(stage_fn, p, a, use_reentrant=False)
    M = x.shape[0]
    params = stage_params
    leaves = tree_leaves(params)
    if leaves and all(tuple(l.shape[:1]) == (1,) for l in leaves):
        params = tree_map(lambda l: l[0], params)

    first = torch.tensor(rank == 0, device=x.device)
    current = torch.zeros_like(x[0])
    outputs = []
    for t in range(M + size - 1):
        # Stage 0 injects microbatch t (the last one again past M);
        # the others take the activation the previous stage sent.
        current = torch.where(first, x[min(t, M - 1)], current)
        result = fn(params, current)
        # The last stage emits microbatch t - (P - 1) at tick t.
        if t >= size - 1:
            outputs.append(result)
        current = ppermute(result, axis, 1)
    out = torch.stack(outputs)
    return sum_across(out * float(rank == size - 1), axis)
