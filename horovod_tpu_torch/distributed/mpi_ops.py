"""Collective operations over ``torch.distributed``: the port of
``horovod_tpu.jax.mpi_ops``.

Each op runs on the process group that ``hvd.init()`` joined (NCCL on
the card, gloo on the CPU), or, inside an SPMD region
(:mod:`horovod_tpu_torch.parallel.spmd`), on the group of the region's
axis. With one rank (or an axis of one) every op returns its input, the
reference's ``size() == 1`` semantics (the tensor itself, not a copy).
``Average`` sums in the wire dtype and divides after decompression, as
the JAX function does. ``allreduce(hierarchical=...)`` runs one tensor
through the fused buckets' two-level ladder, and ``allgather`` under
``HOROVOD_HIERARCHICAL_ALLGATHER`` gathers inside each host first, then
across hosts (:mod:`horovod_tpu_torch.parallel.mesh`); both outside a
region.

Gradients: ``allreduce`` (Sum/Average), ``allgather``, ``broadcast``,
``alltoall`` and ``reducescatter`` carry the gradients of their ``lax``
counterparts' transposes, which are the reference's registered
gradients: allreduce -> allreduce of the cotangent; allgather -> the
reduce-scatter of the cotangent; broadcast -> the summed cotangent on
the root, zeros elsewhere; alltoall -> the all-to-all with the two dims
swapped; reducescatter -> the all-gather. The asynchronous and in-place
forms carry none.

Async API: ``*_async`` returns a :class:`Handle` at once;
:func:`synchronize` waits for it and returns the result, :func:`poll`
checks without blocking. Two ops may not be in flight under one name
(the reference's negotiation rejected it).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (InvalidArgumentError,
                                                 PreconditionError)
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.parallel._collectives import _AllToAll


class Sum:
    pass


class Average:
    pass


class Min:
    pass


class Max:
    pass


class Product:
    pass


#: The torch reduction each op runs on the wire (Average sums, then
#: divides).
REDUCE_OPS = {
    Sum: dist.ReduceOp.SUM,
    Average: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


def resolve_op(op, average: bool = True):
    """``op`` (``average`` picks Average or Sum when it is None); raises
    for an op that has no reduction."""
    if op is None:
        op = Average if average else Sum
    if op not in REDUCE_OPS:
        raise InvalidArgumentError(f"Unsupported reduction op: {op}")
    return op


# ------------------------------------------------------------ names

_name_regex = re.compile(r"[^a-zA-Z0-9_.]")
_auto_name_lock = threading.Lock()
_auto_name_counter = 0
# In-flight async op names (the reference rejected a duplicate in-flight
# name during negotiation, operations.cc:2497-2506).
_in_flight: set = set()
_in_flight_lock = threading.Lock()


def _normalize_name(name: str) -> str:
    return _name_regex.sub("_", name)


def _register(name: Optional[str], op: str):
    """Normalise (or make up) an async op's name and hold it in flight;
    returns the name and the callback that frees it."""
    global _auto_name_counter
    if name:
        name = _normalize_name(name)
    else:
        with _auto_name_lock:
            _auto_name_counter += 1
            name = f"{op}.noname.{_auto_name_counter}"
    with _in_flight_lock:
        if name in _in_flight:
            raise PreconditionError(
                f"Duplicate in-flight tensor name {name!r}: a collective "
                "with this name has been submitted and not yet completed")
        _in_flight.add(name)

    def release():
        with _in_flight_lock:
            _in_flight.discard(name)

    return name, release


class Handle:
    """An asynchronous op. :meth:`wait` (or :func:`synchronize`) blocks
    for its result; :meth:`poll` checks without blocking.

    :meth:`release` frees the op's in-flight name at once (idempotent;
    implied by :meth:`wait` and by a :meth:`poll` that finds the op done),
    and the handle is a context manager whose exit releases. ``__del__``
    releases too, only as a backstop."""

    def __init__(self, work, finish: Callable[[], Any],
                 name: Optional[str] = None,
                 done_cb: Optional[Callable[[], None]] = None):
        self._work = work
        self._finish = finish
        self._name = name
        self._done_cb = done_cb
        self._done = False
        self._value = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    @property
    def name(self) -> Optional[str]:
        return self._name

    def poll(self) -> bool:
        ready = self._done or self._work is None or self._work.is_completed()
        if ready:
            self.release()
        return ready

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            self._value = self._finish()
            self._done, self._work, self._finish = True, None, None
        self.release()
        return self._value

    def release(self) -> None:
        """Free the op's in-flight name without waiting for it."""
        if self._done_cb is not None:
            cb, self._done_cb = self._done_cb, None
            cb()


def poll(handle: Handle) -> bool:
    """Non-blocking readiness check."""
    return handle.poll()


def synchronize(handle: Handle):
    """Block until the async op completes and return its result."""
    return handle.wait()


# ------------------------------------------------------------ helpers


def _tensor(x):
    """Tensors pass as they are; anything else (numpy arrays, numbers)
    becomes a tensor on the initialised device."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=basics.device())


def _axis():
    """``(group, size, index)`` the collectives run over: the SPMD
    region's axis, else the job's group (``None``: the default group,
    when the job is the whole world)."""
    ax = basics.current_spmd_axis()
    if ax is not None:
        return ax.group, ax.size, ax.index
    return basics.job_group(), basics.size(), basics.rank()


def _global_rank(group, index: int) -> int:
    return index if group is None else dist.get_global_rank(group, index)


def _in_place(handle: Handle, tensor) -> Handle:
    """``handle``, with its result written into ``tensor`` on wait."""
    finish = handle._finish

    def into():
        out = finish()
        if out is not tensor:
            with torch.no_grad():
                tensor.copy_(out)
        return tensor

    handle._finish = into
    return handle


def _gather0(x, group, n: int):
    src = x.contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def _scatter0(x, group, n: int):
    src = x.contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """psum: sum forward, sum of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather on dim 0; backward: psum_scatter."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.cfg = (group, n)
        return _gather0(x.detach(), group, n)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.cfg
        return _scatter0(g, group, n), None, None


class _ReduceScatter(torch.autograd.Function):
    """Tiled psum_scatter on dim 0; backward: all_gather."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.cfg = (group, n)
        return _scatter0(x.detach(), group, n)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.cfg
        return _gather0(g, group, n), None, None


#: Unsigned integer dtypes the process groups refuse (gloo raises
#: "Invalid scalar type"), and the signed dtype of their width whose bits
#: cross the wire in their place.
_SIGNED_WIRE = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _start_broadcast(x, src: int, group, async_op: bool = False):
    """Start broadcasting a copy of ``x`` from rank ``src`` of the world
    (bools cross the wire as uint8, the wider unsigned integers as the
    signed integers of their width); returns the work and the function
    that gives the result."""
    wire = x.detach().clone().contiguous()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    elif wire.dtype in _SIGNED_WIRE:
        wire = wire.view(_SIGNED_WIRE[wire.dtype])
    work = dist.broadcast(wire, src, group=group, async_op=async_op)
    if x.dtype in _SIGNED_WIRE:
        return work, lambda: wire.view(x.dtype)
    return work, lambda: wire.to(x.dtype)


def _broadcast_value(x, src: int, group):
    return _start_broadcast(x, src, group)[1]()


class _Broadcast(torch.autograd.Function):
    """Masked psum: the root's value forward; backward, the summed
    cotangent on the root and zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, group, root, index):
        ctx.cfg = (group, root == index)
        return _broadcast_value(x, _global_rank(group, root), group)

    @staticmethod
    def backward(ctx, g):
        group, is_root = ctx.cfg
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return (g if is_root else torch.zeros_like(g)), None, None, None


# ------------------------------------------------------------ allreduce


def allreduce_async(tensor, average: bool = True, name: Optional[str] = None,
                    compression=Compression.none, op=None,
                    hierarchical: Optional[str] = None) -> Handle:
    """Start reducing ``tensor`` across ranks; :func:`synchronize` the
    handle for the result. ``name`` (normalised; made up when absent)
    must not be in flight already.

    ``hierarchical`` (auto|on|off, as ``fused_reduce`` resolves it;
    ``None`` is the flat collective; outside a region only) runs a
    Sum/Average through the ladder as a one-tensor bucket, with the
    bucket's semantics (int8/fp8 quantize its inter-host leg, without
    feedback)."""
    op = resolve_op(op, average)
    tensor = _tensor(tensor)
    name, release = _register(name, "allreduce")
    try:
        group, n, _ = _axis()
        if n == 1:
            return Handle(None, lambda: tensor, name, release)
        if hierarchical is not None and op in (Sum, Average) \
                and basics.current_spmd_axis() is None:
            from horovod_tpu_torch.distributed.fusion import BucketExchange

            ex = BucketExchange([tensor], average=op is Average,
                                compression=compression, op=op, name=name,
                                overlap="on", hierarchical=hierarchical)
            if ex.hier:
                fetch = [tensor].__getitem__
                ex.ready(0, fetch)
                return Handle(None, lambda: ex.finish(fetch)[0], name,
                              release)
        buf, ctx = compression.compress(tensor.detach())
        buf = buf.clone()
        work = dist.all_reduce(buf, op=REDUCE_OPS[op], group=group,
                               async_op=True)
    except BaseException:
        release()
        raise

    def finish():
        out = compression.decompress(buf, ctx)
        return out / n if op is Average else out

    return Handle(work, finish, name, release)


def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              compression=Compression.none, op=None,
              hierarchical: Optional[str] = None):
    """Sum (or average, min, max, product) ``tensor`` across ranks;
    ``hierarchical`` as in :func:`allreduce_async`. Sum and Average carry
    a gradient (the allreduce of the cotangent)."""
    op = resolve_op(op, average)
    tensor = _tensor(tensor)
    group, n, _ = _axis()
    if n == 1:
        return tensor
    if op not in (Sum, Average) or (
            hierarchical is not None
            and basics.current_spmd_axis() is None):
        h = allreduce_async(tensor, average, None, compression, op,
                            hierarchical)
        return h.wait()
    buf, ctx = compression.compress(tensor)
    out = compression.decompress(_AllReduce.apply(buf, group), ctx)
    return out / n if op is Average else out


def allreduce_(tensor, average: bool = True, name: Optional[str] = None,
               compression=Compression.none, op=None):
    """:func:`allreduce` written into ``tensor``; returns ``tensor``."""
    return allreduce_async_(tensor, average, name, compression, op).wait()


def allreduce_async_(tensor, average: bool = True,
                     name: Optional[str] = None,
                     compression=Compression.none, op=None) -> Handle:
    """:func:`allreduce_async` whose result is written into ``tensor``."""
    return _in_place(allreduce_async(tensor, average, name, compression, op),
                     tensor)


def grouped_allreduce(tensors, average: bool = True,
                      name: Optional[str] = None,
                      compression=Compression.none, op=None,
                      fusion_threshold: Optional[int] = None,
                      overlap: Optional[str] = None,
                      hierarchical: Optional[str] = None):
    """Allreduce a list of tensors as fused flat buckets (grouped by
    dtype, at most the fusion threshold each) through
    :func:`~horovod_tpu_torch.distributed.fusion.fused_reduce`; returns
    new tensors in input order. Inside a region over an axis that is not
    the whole world, each tensor is reduced on its own over the axis."""
    from horovod_tpu_torch.distributed.fusion import fused_reduce

    tensors = [_tensor(t) for t in tensors]
    ax = basics.current_spmd_axis()
    if ax is not None and ax.size != basics.size():
        # hvdlint: disable=HVD006 (a sub-axis region reduces tensor by tensor: its fused path is not ported, ROADMAP Queue 3)
        return [allreduce(t, average, None, compression, op)
                for t in tensors]
    return fused_reduce(tensors, average=average, compression=compression,
                        op=op, fusion_threshold=fusion_threshold,
                        name=_normalize_name(name) if name else None,
                        overlap=overlap, hierarchical=hierarchical)


# ------------------------------------------------------------ allgather


def allgather(tensor, name: Optional[str] = None):
    """Concatenate ``tensor`` from all ranks along dimension 0 (equal
    shapes on every rank; :func:`allgatherv` pads ragged ones). Its
    gradient is the reduce-scatter of the cotangent. Outside a region,
    under ``HOROVOD_HIERARCHICAL_ALLGATHER`` the gather runs in two
    phases, inside each host and then across hosts (inner size
    ``HOROVOD_HIERARCHICAL_INNER_SIZE``, else the ranks per host), with
    the same rank-major result."""
    del name
    tensor = _tensor(tensor)
    group, n, _ = _axis()
    if n == 1:
        return tensor
    if basics.config().hierarchical_allgather \
            and basics.current_spmd_axis() is None:
        from horovod_tpu_torch.distributed.fusion import _hierarchical_inner
        from horovod_tpu_torch.parallel.mesh import (
            hierarchical_allgather_in_axis)

        inner = _hierarchical_inner(n)
        if inner:
            return hierarchical_allgather_in_axis(tensor, inner)
    return _AllGather.apply(tensor, group, n)


def allgather_async(tensor, name: Optional[str] = None) -> Handle:
    """Start :func:`allgather` (the flat gather); synchronize for the
    result."""
    tensor = _tensor(tensor)
    name, release = _register(name, "allgather")
    try:
        group, n, _ = _axis()
        if n == 1:
            return Handle(None, lambda: tensor, name, release)
        src = tensor.detach().contiguous()
        out = torch.empty((n * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        work = dist.all_gather_into_tensor(out, src, group=group,
                                           async_op=True)
    except BaseException:
        release()
        raise
    return Handle(work, lambda: out, name, release)


def allgatherv(tensor, valid_rows, max_rows: int,
               name: Optional[str] = None):
    """Ragged allgather under equal shapes: pad ``tensor``'s rows to
    ``max_rows``, gather, and return ``(gathered, row_counts)`` where
    ``row_counts[r]`` rows of block ``r`` are valid. Only inside an SPMD
    region, as in the JAX package."""
    del name
    if basics.current_spmd_axis() is None:
        raise PreconditionError("allgatherv is only available inside "
                                "spmd_run")
    tensor = _tensor(tensor)
    pad = max_rows - tensor.shape[0]
    if pad < 0:
        raise InvalidArgumentError(
            f"allgatherv: {tensor.shape[0]} rows exceed max_rows "
            f"{max_rows}")
    if pad:
        tensor = torch.cat([tensor, tensor.new_zeros(
            (pad, *tensor.shape[1:]))])
    counts = torch.as_tensor(valid_rows, dtype=torch.int32,
                             device=tensor.device).reshape(1)
    return allgather(tensor), allgather(counts)


# ------------------------------------------------------------ broadcast


def _check_root(root_rank: int, n: int) -> None:
    if not 0 <= root_rank < n:
        raise InvalidArgumentError(
            f"broadcast root_rank {root_rank} out of range for size {n}")


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """``tensor`` as ``root_rank`` holds it, on every rank (a new
    tensor). Its gradient is the summed cotangent on the root and zeros
    elsewhere."""
    del name
    tensor = _tensor(tensor)
    group, n, index = _axis()
    _check_root(root_rank, n)
    if n == 1:
        return tensor
    if tensor.dtype.is_floating_point or tensor.dtype.is_complex:
        return _Broadcast.apply(tensor, group, root_rank, index)
    return _broadcast_value(tensor, _global_rank(group, root_rank), group)


def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`broadcast`; synchronize for the result."""
    tensor = _tensor(tensor)
    name, release = _register(name, "broadcast")
    try:
        group, n, _ = _axis()
        _check_root(root_rank, n)
        if n == 1:
            return Handle(None, lambda: tensor, name, release)
        work, finish = _start_broadcast(
            tensor, _global_rank(group, root_rank), group, async_op=True)
    except BaseException:
        release()
        raise
    return Handle(work, finish, name, release)


def broadcast_(tensor, root_rank: int, name: Optional[str] = None):
    """:func:`broadcast` written into ``tensor``; returns ``tensor``."""
    return broadcast_async_(tensor, root_rank, name).wait()


def broadcast_async_(tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """:func:`broadcast_async` whose result is written into ``tensor``."""
    return _in_place(broadcast_async(tensor, root_rank, name), tensor)


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Broadcast a picklable Python object from ``root_rank``."""
    n = basics.size()
    _check_root(root_rank, n)
    if n == 1:
        return obj
    group = basics.job_group()
    box = [obj]
    dist.broadcast_object_list(box, src=_global_rank(group, root_rank),
                               group=group, device=basics.device())
    return box[0]


# ------------------------------------------------ alltoall, reducescatter


def alltoall(tensor, name: Optional[str] = None, split_axis: int = 0,
             concat_axis: int = 0):
    """Scatter equal splits of dim ``split_axis`` to the ranks in order
    and concatenate the splits received along ``concat_axis`` in the
    senders' order (``lax.all_to_all(tiled=True)``); raises when the dim
    does not divide by the number of ranks. Its gradient is the
    all-to-all with the two dims swapped."""
    del name
    tensor = _tensor(tensor)
    group, n, _ = _axis()
    split_axis %= tensor.dim()
    concat_axis %= tensor.dim()
    if tensor.shape[split_axis] % n:
        raise InvalidArgumentError(
            f"alltoall split dim {tensor.shape[split_axis]} not divisible "
            f"by world size {n}")
    if n == 1:
        return tensor
    return _AllToAll.apply(tensor, group, n, split_axis, concat_axis)


def reducescatter(tensor, average: bool = True, name: Optional[str] = None):
    """Sum (or average) ``tensor`` across ranks and keep this rank's
    dim-0 shard (``lax.psum_scatter(tiled=True)``); raises when dim 0
    does not divide by the number of ranks. Its gradient is the
    all-gather of the cotangent."""
    del name
    tensor = _tensor(tensor)
    group, n, _ = _axis()
    if n == 1:
        return tensor
    if tensor.shape[0] % n:
        raise InvalidArgumentError(
            f"reducescatter dim 0 ({tensor.shape[0]}) not divisible by "
            f"world size {n}")
    out = _ReduceScatter.apply(tensor, group, n)
    return out / n if average else out


# ------------------------------------------------------------ sparse


def allreduce_sparse(indices, values, dense_rows: Optional[int] = None,
                     average: bool = True, name: Optional[str] = None):
    """Cross-rank reduction of a sparse row update set: ``indices [k]``
    are row ids into a ``[dense_rows, ...]`` tensor and ``values [k,
    ...]`` their rows (the same ``k`` on every rank). Returns, with
    ``dense_rows``, the dense summed (or averaged) tensor, duplicate
    rows accumulating; without, ``(gathered_indices, gathered_values)``
    (duplicates left to the consumer)."""
    del name
    indices, values = _tensor(indices), _tensor(values)
    _, n, _ = _axis()
    all_indices, all_values = allgather(indices), allgather(values)
    if average:
        all_values = all_values / n
    if dense_rows is None:
        return all_indices, all_values
    dense = torch.zeros((dense_rows, *all_values.shape[1:]),
                        dtype=all_values.dtype, device=all_values.device)
    return dense.index_add(0, all_indices.long(), all_values)
