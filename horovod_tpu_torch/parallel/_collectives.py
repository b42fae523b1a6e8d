"""Differentiable collectives over one axis of the bound mesh: the
port's counterparts of ``lax.ppermute`` and ``lax.all_to_all`` (tiled),
which sequence and pipeline parallelism stand on, and of ``lax.psum`` /
``lax.pmean`` over a named axis, which cross-replica BatchNorm stands on.

The JAX collectives run inside ``shard_map`` over a named axis; here
each rank is a process and ``axis`` names a physical axis of the bound
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`, whose process
group is ``current_logical_mesh().mesh.get_group(axis)``
(:func:`axis_group`). An axis of size one needs no communication.

Both ride ``dist.all_to_all_single``: ``ppermute`` as an all-to-all
whose split sizes send the whole tensor to one peer and take the whole
tensor from another. NCCL and gloo take it on CUDA tensors (gloo's
point-to-point ``send``/``recv`` does not), so ranks that share one card
over gloo run the same code as ranks with a card each over NCCL.

Like their JAX counterparts these are collectives: every rank of the
axis calls them, in the same order, forward and backward. Their
backwards are collectives too (the inverse shift; the all-to-all with
the two dims swapped), so a caller keeps every rank's autograd graph the
same shape: an output one rank drops while another uses it would leave
the two backwards out of step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.parallel.logical import (current_logical_mesh,
                                                module_axis)

_ROLE_NAMES = {"tensor": "tensor parallelism",
               "seq": "sequence parallelism",
               "stage": "pipeline parallelism",
               "expert": "expert parallelism",
               "data": "a data-axis collective"}


def axis_group(axis: Optional[str] = None, role: str = "tensor"):
    """``(group, size, index)`` of a mesh axis: its process group in the
    bound mesh (``None`` when the axis has size one), the axis size and
    this rank's position along it. ``axis=None`` takes the bound mesh's
    axis for ``role``. Raises without a bound mesh or when the mesh lacks
    the axis."""
    lm = current_logical_mesh()
    if lm is None:
        raise InvalidArgumentError(
            f"{_ROLE_NAMES.get(role, role)} needs a bound LogicalMesh "
            "(wrap the call in horovod_tpu_torch.parallel.bind("
            "LogicalMesh(...))): its axis names the process group the "
            "collectives run over")
    axis = module_axis(role, axis)
    if not lm.defines(axis):
        raise InvalidArgumentError(
            f"bound LogicalMesh {lm.config!r} has no axis {axis!r}")
    size = lm.axes[axis]
    if size == 1:
        return None, 1, 0
    group = lm.mesh.get_group(axis)
    return group, size, dist.get_rank(group)


def send_shifted(x, group, size: int, index: int, shift: int):
    """Send ``x`` to position ``(index + shift) % size`` of the group and
    return what position ``(index - shift) % size`` sent: one
    ``all_to_all_single`` whose split sizes are the whole tensor for one
    peer and zero for the others. Not differentiable (the building block
    of :func:`ppermute` and of the ring's hand-written backward)."""
    if group is None or shift % size == 0:
        return x
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    sends = [0] * size
    recvs = [0] * size
    sends[(index + shift) % size] = flat.numel()
    recvs[(index - shift) % size] = flat.numel()
    dist.all_to_all_single(out, flat, recvs, sends, group=group)
    return out.view(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, shift):
        ctx.cfg = (group, size, index, shift)
        return send_shifted(x, group, size, index, shift)

    @staticmethod
    def backward(ctx, g):
        group, size, index, shift = ctx.cfg
        return send_shifted(g, group, size, index, -shift), None, None, \
            None, None


def ppermute(x, axis: str, shift: int):
    """``lax.ppermute`` over ``axis`` with the ring permutation ``i -> (i
    + shift) % n``: each rank's ``x`` goes to the rank ``shift`` places
    on, and each rank returns what the rank ``shift`` places back sent
    (every rank's ``x`` has the same shape and dtype). The backward sends
    the cotangent the inverse way."""
    group, size, index = axis_group(axis, role="seq")
    if group is None:
        return x
    return _PPermute.apply(x, group, size, index, int(shift))


def _all_to_all(x, group, size: int, split_dim: int, concat_dim: int):
    chunks = x.chunk(size, dim=split_dim)
    if len(chunks) != size or x.shape[split_dim] % size:
        raise InvalidArgumentError(
            f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} "
            f"does not split into {size} chunks")
    send = torch.stack(chunks)                       # [size, ...chunk]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, split_dim, concat_dim):
        ctx.cfg = (group, size, split_dim, concat_dim)
        return _all_to_all(x, group, size, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, size, split_dim, concat_dim = ctx.cfg
        return _all_to_all(g, group, size, concat_dim, split_dim), None, \
            None, None, None


def all_to_all(x, axis: Optional[str], split_dim: int, concat_dim: int,
               role: str = "seq"):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` splits into ``n`` chunks along ``split_dim``, chunk ``j`` goes
    to position ``j`` of the axis, and the chunks received are
    concatenated along ``concat_dim`` in the senders' order. The backward
    is the all-to-all with the two dims swapped. ``role`` is the
    parallelism the caller serves: it resolves ``axis=None`` and names
    the caller in the error raised without a bound mesh."""
    group, size, _ = axis_group(axis, role=role)
    if group is None:
        return x
    split_dim %= x.dim()
    concat_dim %= x.dim()
    return _AllToAll.apply(x, group, size, split_dim, concat_dim)


def named_axis(axis_name: str):
    """``(group, size)`` of the axis a JAX module names (``lax.psum(x,
    axis_name)``): the enclosing SPMD region's axis when it has that name,
    else that axis of the bound :class:`LogicalMesh`, else, for the data
    axis ``"hvd"``, the job's group. Raises for any other name."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel.logical import DATA_AXIS

    region = basics.current_spmd_axis()
    if region is not None and region.name == axis_name:
        return region.group, region.size
    lm = current_logical_mesh()
    if lm is not None and lm.defines(axis_name):
        group, size, _ = axis_group(axis_name, role="data")
        return group, size
    if axis_name == DATA_AXIS:
        return basics.job_group(), basics.size()
    raise InvalidArgumentError(
        f"axis {axis_name!r} is neither the SPMD region's axis, an axis of "
        f"the bound LogicalMesh, nor the job's data axis {DATA_AXIS!r}")


def psum(x, axis_name: str):
    """``lax.psum(x, axis_name)`` (axis resolved by :func:`named_axis`):
    the sum over the axis, whose backward sums the cotangents over it, so
    every rank's gradient takes the other ranks' uses of its ``x``."""
    from horovod_tpu_torch.distributed.mpi_ops import _AllReduce

    group, size = named_axis(axis_name)
    return x if size == 1 else _AllReduce.apply(x, group)


def pmean(x, axis_name: str):
    """``lax.pmean(x, axis_name)``: :func:`psum` over the axis size."""
    _, size = named_axis(axis_name)
    return psum(x, axis_name) / size
