"""Tensor fusion: bucketed flat-buffer collectives over ``torch.distributed``.

The port of ``horovod_tpu.jax.fusion``'s flat path. Tensors are grouped
by dtype and packed greedily, in input order, into buckets of at most
``HOROVOD_FUSION_THRESHOLD`` bytes (:func:`plan_buckets`, a copy of the
JAX plan); each bucket is flattened and concatenated into one buffer,
reduced with one collective, and unpacked.

``HOROVOD_OVERLAP`` (:func:`resolve_overlap`): with overlap on, the
buckets are issued in reverse order (the order a backward pass produces
gradients) as asynchronous collectives, then waited for and unpacked in
forward order; buckets at or above ``HOROVOD_OVERLAP_SCATTER_THRESHOLD``
take the reduce-scatter + all-gather form. The division points of the
JAX function are kept, so overlap on, off and the scatter form give
bit-identical results: under ``Compression.none`` an Average divides the
scattered shard (or, on the allreduce form, the tail); under the cast
compressors it divides the decompressed tail.

Unlike the JAX package's eager lane, which returns its input at world
size 1, the bucket collectives run at every world size, a world of one
included (where they return the buffer unchanged): the collectives of a
step are the plan's at any size, and ``fused_reduce.collectives`` counts
them.

The hierarchical ladder and the error-feedback residuals of the low-bit
codecs are not ported yet (ROADMAP.md Queue 1 item 3): ``hierarchical``
other than ``None``/``"off"`` and ``residuals`` raise.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import OVERLAP_MODES
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression


def _plan_buckets(sizes_bytes: Sequence[int], threshold: int) -> List[List[int]]:
    """Greedy contiguous bucketing: consecutive tensors pack into a bucket
    until adding the next would exceed ``threshold`` (an oversize tensor
    gets its own bucket, like an oversize response in the reference)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nb in enumerate(sizes_bytes):
        if cur and cur_bytes + nb > threshold:
            buckets.append(cur)
            cur = []
            cur_bytes = 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


class Bucket(NamedTuple):
    """One fused-collective bucket of the plan."""

    dtype: str        # wire dtype name, e.g. "float32"
    index: int        # position within this dtype's bucket sequence
    members: tuple    # indices into the input tensor list, input order
    nbytes: int       # payload bytes (sum of member bytes, unpadded)
    oversize: bool    # single tensor alone exceeding the fusion threshold


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX/numpy name of a torch dtype (``torch.float32`` ->
    ``"float32"``)."""
    return str(dtype).split(".")[-1]


def _leaf_size(leaf) -> int:
    numel = getattr(leaf, "numel", None)
    if callable(numel):
        return int(numel())
    return int(math.prod(leaf.shape))


def plan_buckets(leaves, threshold: int) -> List[Bucket]:
    """The full bucket plan for ``leaves`` (tensors, or anything with a
    ``shape`` and a torch ``dtype``): grouped by dtype (first-appearance
    order), greedily packed to ``threshold`` bytes within each group,
    forward (input) order. Exactly the plan :func:`fused_reduce`
    executes."""
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    plan: List[Bucket] = []
    for dtype, idxs in by_dtype.items():
        sizes = [_leaf_size(leaves[i]) * dtype.itemsize for i in idxs]
        for b, bucket in enumerate(_plan_buckets(sizes, threshold)):
            nbytes = sum(sizes[j] for j in bucket)
            plan.append(Bucket(
                dtype=_dtype_name(dtype),
                index=b,
                members=tuple(idxs[j] for j in bucket),
                nbytes=nbytes,
                oversize=len(bucket) == 1 and nbytes > threshold,
            ))
    return plan


def plan_summary(plan: Sequence[Bucket]) -> dict:
    """Compact accounting of a bucket plan."""
    total = sum(b.nbytes for b in plan)
    return {
        "count": len(plan),
        "total_bytes": total,
        "total_mb": round(total / (1024 * 1024), 2),
        "oversize_singletons": sum(1 for b in plan if b.oversize),
        "largest_bytes": max((b.nbytes for b in plan), default=0),
    }


def resolve_overlap(mode: Optional[str], n_buckets: int) -> bool:
    """Resolve the overlap knob for one plan: ``auto`` engages with >= 2
    buckets, ``on``/``off`` force it; ``None`` reads HOROVOD_OVERLAP."""
    if mode is None:
        mode = basics.config().overlap
    if mode is True:
        mode = "on"
    elif mode is False:
        mode = "off"
    if mode not in OVERLAP_MODES:
        raise InvalidArgumentError(
            f"overlap must be one of {OVERLAP_MODES} (got {mode!r})")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return n_buckets >= 2


def fused_reduce(tensors, average: bool = True,
                 compression=Compression.none, op=None,
                 fusion_threshold: Optional[int] = None,
                 name: Optional[str] = None, overlap: Optional[str] = None,
                 scatter_threshold: Optional[int] = None,
                 hierarchical: Optional[str] = None, residuals=None):
    """Allreduce ``tensors`` through fused flat buckets; returns new
    tensors in input order (the inputs are not modified). ``name`` is
    accepted for parity. Each collective issued adds one to
    ``fused_reduce.collectives``."""
    del name
    if hierarchical not in (None, "off"):
        raise NotImplementedError(
            f"hierarchical={hierarchical!r}: the two-level ladder is not "
            "ported yet (ROADMAP.md Queue 1 item 3)")
    if residuals is not None:
        raise NotImplementedError(
            "error-feedback residuals belong to the hierarchical ladder's "
            "low-bit codecs, not ported yet (ROADMAP.md Queue 1 item 3)")
    op = mpi_ops.resolve_op(op, average)
    cfg = basics.config()
    if fusion_threshold is None:
        fusion_threshold = cfg.fusion_threshold
    if scatter_threshold is None:
        scatter_threshold = cfg.overlap_scatter_threshold
    n = basics.size()
    plain_sum = op is mpi_ops.Average or op is mpi_ops.Sum
    torch_op = mpi_ops.REDUCE_OPS[op]
    divide_shard = op is mpi_ops.Average and compression is Compression.none

    compressed, ctxs = [], []
    for t in tensors:
        c, ctx = compression.compress(t)
        compressed.append(c)
        ctxs.append(ctx)
    plan = plan_buckets(compressed, fusion_threshold)
    use_overlap = resolve_overlap(overlap, len(plan))
    # Min/Max/Product have no scatter form; one rank has nothing to
    # scatter.
    can_scatter = use_overlap and plain_sum and n > 1

    results: List = [None] * len(tensors)
    averaged = [False] * len(tensors)

    def _issue(bucket: Bucket):
        """Start the bucket's collective; returns its unpack closure."""
        members = list(bucket.members)
        flat = torch.cat([compressed[i].reshape(-1) for i in members])
        size = flat.numel()
        if can_scatter and bucket.nbytes >= scatter_threshold:
            pad = (-size) % n
            if pad:
                flat = F.pad(flat, (0, pad))
            shard = torch.empty(flat.numel() // n, dtype=flat.dtype,
                                device=flat.device)
            dist.reduce_scatter_tensor(shard, flat, op=torch_op)
            if divide_shard:
                # The sharded update: 1/n of the division work, and
                # bit-identical to dividing the gathered whole.
                shard = shard / n
                for i in members:
                    averaged[i] = True
            work = dist.all_gather_into_tensor(flat, shard, async_op=True)
            fused_reduce.collectives += 2
        else:
            work = dist.all_reduce(flat, op=torch_op, async_op=True)
            fused_reduce.collectives += 1

        def _unpack():
            work.wait()
            offset = 0
            for i in members:
                sz = compressed[i].numel()
                results[i] = flat[offset:offset + sz].view(
                    compressed[i].shape)
                offset += sz

        return _unpack

    if use_overlap:
        # Reverse bucket order = backward availability order; start every
        # collective, then wait and unpack in forward order.
        unpacks = [None] * len(plan)
        for bi in reversed(range(len(plan))):
            unpacks[bi] = _issue(plan[bi])
        for unpack in unpacks:
            unpack()
    else:
        for bucket in plan:
            _issue(bucket)()

    out = []
    for i, t in enumerate(tensors):
        r = compression.decompress(results[i], ctxs[i])
        if op is mpi_ops.Average and not averaged[i]:
            r = r / n
        out.append(r.to(t.dtype) if r.dtype != t.dtype else r)
    return out


fused_reduce.collectives = 0
