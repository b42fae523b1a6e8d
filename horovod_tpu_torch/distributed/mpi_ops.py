"""Collective operations over ``torch.distributed``: the subset of
``horovod_tpu.jax.mpi_ops`` that the optimizer and the training step use.

Each op runs on the process group that ``hvd.init()`` joined: NCCL on the
card, gloo on the CPU. With one process every op returns its input, the
reference's ``size() == 1`` semantics (the tensor itself, not a copy).
``Average`` sums in the wire dtype and divides after decompression, as
the JAX function does.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed.compression import Compression


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


class Handle:
    """An asynchronous op: :func:`synchronize` waits for it and returns
    its result."""

    def __init__(self, work, finish: Callable[[], Any]):
        self._work = work
        self._finish = finish

    def poll(self) -> bool:
        return self._work is None or self._work.is_completed()

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return self._finish()


def synchronize(handle: Handle):
    """Block until the async op completes and return its result."""
    return handle.wait()


def allreduce_async(tensor, average: bool = True, name: Optional[str] = None,
                    compression=Compression.none, op=None) -> Handle:
    """Start reducing ``tensor`` across ranks; :func:`synchronize` the
    handle for the result. ``name`` is accepted for parity."""
    del name
    op = resolve_op(op, average)
    n = basics.size()
    if n == 1:
        return Handle(None, lambda: tensor)
    buf, ctx = compression.compress(tensor)
    buf = buf.clone()
    work = dist.all_reduce(buf, op=REDUCE_OPS[op], async_op=True)

    def finish():
        out = compression.decompress(buf, ctx)
        return out / n if op is Average else out

    return Handle(work, finish)


def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              compression=Compression.none, op=None):
    """Sum (or average, min, max, product) ``tensor`` across all ranks."""
    return allreduce_async(tensor, average, name, compression, op).wait()


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """``tensor`` as ``root_rank`` holds it, on every rank."""
    del name
    n = basics.size()
    if not 0 <= root_rank < n:
        raise InvalidArgumentError(
            f"broadcast root_rank {root_rank} out of range for size {n}")
    if n == 1:
        return tensor
    out = tensor.detach().clone()
    dist.broadcast(out, root_rank)
    return out


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Broadcast a picklable Python object from ``root_rank``."""
    n = basics.size()
    if not 0 <= root_rank < n:
        raise InvalidArgumentError(
            f"broadcast root_rank {root_rank} out of range for size {n}")
    if n == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank, device=basics.device())
    return box[0]


def allgather(tensor, name: Optional[str] = None):
    """Concatenate ``tensor`` from all ranks along dimension 0 (equal
    shapes on every rank)."""
    del name
    n = basics.size()
    if n == 1:
        return tensor
    src = tensor.contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src)
    return out
