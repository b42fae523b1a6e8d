"""Tensor parallelism: Megatron-style column/row-parallel layers over
``torch.distributed``, the port of ``horovod_tpu.parallel.tp``.

Weight matrices shard over the tensor axis of the bound
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`; only
activations cross ranks. The MLP pattern, a column-parallel
up-projection (no communication) and a row-parallel down-projection
(one all-reduce), costs one all-reduce a block.

The JAX functions run inside ``shard_map``; here each rank is a process
holding its own shard (:func:`shard_columns` / :func:`shard_rows`, or
``models.parallel_lm.shard_lm_params`` for a whole LM), and ``axis``
names a physical axis of the bound mesh. The axis resolves through
:func:`~horovod_tpu_torch.parallel.logical.module_axis` and its group is
``current_logical_mesh().mesh.get_group(axis)``; with no mesh bound the
functions raise, as there is no group to fall back to. An axis of size
one is the dense math (no collective).

The collectives are ``torch.autograd.Function`` s with Megatron's
conjugate backward rules, so a loss taken on every rank differentiates
exactly: :func:`tp_region_input` (``f``: identity forward, all-reduce
backward), :func:`tp_region_output` / :func:`sum_across` (``g``:
all-reduce forward, identity backward) and the all-gather of
``gather_output`` (backward: this rank's slice of the gradient).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.parallel._collectives import axis_group


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather_last(x, group, size):
    """Slices of every rank concatenated on the last dim in rank order."""
    x = x.contiguous()
    out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    out = out.view((size,) + tuple(x.shape))
    return torch.movedim(out, 0, -2).reshape(*x.shape[:-1],
                                             size * x.shape[-1])


class _RegionInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _RegionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.width, ctx.index = x.shape[-1], index
        return _all_gather_last(x, group, size)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w:(ctx.index + 1) * w], None, None, None


def tp_region_input(x, axis: Optional[str] = None):
    """Megatron's ``f``: identity forward, all-reduce (sum) backward.

    Place on the replicated activation entering a column-parallel
    region: each rank's backward carries only its own shard's
    cotangent, and the upstream parameters need their sum."""
    group, _, _ = axis_group(axis)
    return x if group is None else _RegionInput.apply(x, group)


def tp_region_output(x, axis: Optional[str] = None):
    """Megatron's ``g``: all-reduce (sum) forward, identity backward —
    the exact gradient of a cross-rank sum consumed as a replicated
    value (differentiating a raw all-reduce would sum the cotangent a
    second time)."""
    group, _, _ = axis_group(axis)
    return x if group is None else _RegionOutput.apply(x, group)


#: A differentiable cross-rank sum (e.g. loss terms summed over ranks).
sum_across = tp_region_output


def column_parallel(x, w, b=None, axis: Optional[str] = None,
                    gather_output: bool = False):
    """``y_local = x @ W_local`` with ``W`` column-sharded ``[Din,
    Dout/P]``: no communication, each rank makes its slice of the output
    features. ``gather_output`` all-gathers the slices on the last dim
    in rank order (when the next layer is not row-parallel)."""
    y = x @ w
    if b is not None:
        y = y + b
    if gather_output:
        group, size, index = axis_group(axis)
        if group is not None:
            y = _GatherLast.apply(y, group, size, index)
    return y


def row_parallel(x, w, b=None, axis: Optional[str] = None):
    """``y = sum_p(x_local @ W_local)`` with ``W`` row-sharded ``[Din/P,
    Dout]`` and ``x`` feature-sharded to match a preceding
    column-parallel layer: one all-reduce gives the full output on every
    rank; the bias is added once after the sum."""
    y = tp_region_output(x @ w, axis)
    if b is not None:
        y = y + b
    return y


def _gelu(x):
    # jax.nn.gelu's default, the tanh approximation (the dense LM's).
    return F.gelu(x, approximate="tanh")


def tp_mlp(x, w_up, b_up, w_down, b_down, axis: Optional[str] = None,
           activation: Callable = _gelu):
    """The 2-layer TP block: column-parallel up (no communication),
    local activation, row-parallel down (one all-reduce)."""
    h = activation(column_parallel(x, w_up, b_up, axis))
    return row_parallel(h, w_down, b_down, axis)


def vocab_parallel_logits(x, head, axis: Optional[str] = None):
    """Full-vocab logits from a column-sharded head: ``x @ W_local``
    (``[..., E] x [E, V/P]``) then one all-gather over the vocab axis —
    :func:`column_parallel` with ``gather_output``. Each rank's columns
    are the dense product's column slices, so every rank holds the same
    full-vocab row and a greedy argmax over it is the dense one."""
    return column_parallel(x, head, axis=axis, gather_output=True)


def _split(n: int, axis_size: int, what: str) -> int:
    if axis_size < 1 or n % axis_size:
        raise InvalidArgumentError(
            f"{what} of size {n} does not split into {axis_size} shards")
    return n // axis_size


def shard_columns(w, axis_size: int, index: int):
    """The column shard (last dim) of mesh position ``index``."""
    cols = _split(w.shape[-1], axis_size, "last dim")
    return w[..., index * cols:(index + 1) * cols]


def shard_rows(w, axis_size: int, index: int):
    """The row shard (first dim) of mesh position ``index``."""
    rows = _split(w.shape[0], axis_size, "first dim")
    return w[index * rows:(index + 1) * rows]
