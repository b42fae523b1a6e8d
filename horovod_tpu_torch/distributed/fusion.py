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

:class:`BucketExchange` holds the steps of one reduction: the plan (its
constructor), issuing one bucket, and unpacking it. :func:`fused_reduce`
runs them back to back; ``DistributedOptimizer`` issues buckets from
gradient hooks during the backward pass (:meth:`BucketExchange.ready`)
and finishes the rest after it, with the same issue order on every rank;
each parameter holds the hook of one optimizer at a time
(:func:`release_grad_hooks`). With ``HOROVOD_TIMELINE`` set, rank 0
writes one track per bucket: an ALLREDUCE span from its issue to its
unpack, with MEMCPY_IN_FUSION_BUFFER, REDUCESCATTER and ALLGATHER (the
scatter form) and MEMCPY_OUT_FUSION_BUFFER inside it.

Unlike the JAX package's eager lane, which returns its input at world
size 1, the bucket collectives run at every world size, a world of one
included (where they return the buffer unchanged): the collectives of a
step are the plan's at any size, and ``fused_reduce.collectives`` counts
them.

The hierarchical ladder and the error-feedback residuals of the low-bit
codecs are not ported yet (ROADMAP.md Queue 1, parallelism): ``hierarchical``
other than ``None``/``"off"`` and ``residuals`` raise.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import OVERLAP_MODES
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.utils import timeline as tl_names


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


class BucketExchange:
    """One fused reduction of a fixed list of tensors, bucket by bucket.

    ``like`` gives the tensors' shapes and dtypes (the tensors themselves,
    or anything with ``shape`` and a torch ``dtype``); the other arguments
    are :func:`fused_reduce`'s. The constructor plans the buckets over the
    wire dtypes (``compression.plan_dtype``). Tensors are read only when
    their bucket is issued, through ``fetch(i)``, the i-th tensor of the
    list. Under overlap the buckets are issued in reverse plan order:
    :meth:`ready` marks one tensor final and issues each bucket whose
    members are all final once every bucket after it has been issued, so
    every rank issues the same sequence whatever order its tensors become
    final in. :meth:`finish` issues what is left, waits for and unpacks
    every bucket in forward order, and returns the results; the exchange
    can then run again over new tensors of the same shapes."""

    def __init__(self, like, average: bool = True,
                 compression=Compression.none, op=None,
                 fusion_threshold: Optional[int] = None,
                 name: Optional[str] = None, overlap: Optional[str] = None,
                 scatter_threshold: Optional[int] = None):
        self._op = mpi_ops.resolve_op(op, average)
        cfg = basics.config()
        if fusion_threshold is None:
            fusion_threshold = cfg.fusion_threshold
        if scatter_threshold is None:
            scatter_threshold = cfg.overlap_scatter_threshold
        self._scatter_threshold = scatter_threshold
        self._compression = compression
        self._name = name or "fused"
        self._n = basics.size()
        self._like = [(tuple(t.shape), t.dtype) for t in like]
        self.plan = plan_buckets(
            [torch.empty(s, dtype=compression.plan_dtype(d), device="meta")
             for s, d in self._like], fusion_threshold)
        self.overlap = resolve_overlap(overlap, len(self.plan))
        plain_sum = self._op is mpi_ops.Average or self._op is mpi_ops.Sum
        # Min/Max/Product have no scatter form; one rank has nothing to
        # scatter.
        self._can_scatter = self.overlap and plain_sum and self._n > 1
        self._divide_shard = (self._op is mpi_ops.Average
                              and compression is Compression.none)
        self._bucket_of = {i: bi for bi, b in enumerate(self.plan)
                           for i in b.members}
        self._timeline = basics.timeline()
        self._reset()

    def _reset(self) -> None:
        self._missing = [len(b.members) for b in self.plan]
        self._next = len(self.plan) - 1      # next bucket in reverse order
        self._inflight: dict = {}
        self._ctxs: List = [None] * len(self._like)
        self._results: List = [None] * len(self._like)
        self._averaged = [False] * len(self._like)
        self._issued = 0

    def issued(self, i: int) -> bool:
        """Whether tensor ``i``'s bucket has been issued."""
        return self._bucket_of[i] > self._next

    def ready(self, i: int, fetch: Callable[[int], torch.Tensor]) -> None:
        """Tensor ``i`` is final: issue every bucket the reverse order now
        allows (overlap only)."""
        if not self.overlap:
            raise InvalidArgumentError(
                "BucketExchange.ready issues buckets early, which needs "
                "overlap on")
        self._missing[self._bucket_of[i]] -= 1
        while self._next >= 0 and self._missing[self._next] == 0:
            self._issue(self._next, fetch)
            self._next -= 1

    def finish(self, fetch: Callable[[int], torch.Tensor]) -> list:
        """Issue the buckets not yet issued, wait for and unpack them all;
        returns the reduced tensors in input order."""
        if self.overlap:
            # Reverse bucket order = backward availability order; start
            # every collective, then wait and unpack in forward order.
            while self._next >= 0:
                self._issue(self._next, fetch)
                self._next -= 1
            for bi in range(len(self.plan)):
                self._unpack(bi)
        else:
            for bi in range(len(self.plan)):
                self._issue(bi, fetch)
                self._unpack(bi)
        out = []
        for i, (_, dtype) in enumerate(self._like):
            r = self._compression.decompress(self._results[i], self._ctxs[i])
            if self._op is mpi_ops.Average and not self._averaged[i]:
                r = r / self._n
            out.append(r.to(dtype) if r.dtype != dtype else r)
        self._reset()
        return out

    def _span(self, track: str, activity: str):
        if self._timeline.enabled:
            return tl_names.activity(self._timeline, track, activity)
        return contextlib.nullcontext()

    def _track(self, bucket: Bucket) -> str:
        return f"{self._name}.{bucket.dtype}.b{bucket.index}"

    def _issue(self, bi: int, fetch) -> None:
        """Flatten bucket ``bi``'s members and start its collective.

        From a gradient hook this runs on autograd's device thread with
        the gradient's stream current, so the flatten copy is queued on
        the stream that produced the gradient, and the process group
        orders its collective after that stream's work; :meth:`_unpack`
        makes the caller's stream wait for the collective."""
        bucket = self.plan[bi]
        track = self._track(bucket)
        scatter = (self._can_scatter
                   and bucket.nbytes >= self._scatter_threshold)
        if self._timeline.enabled:
            self._timeline.start(track, tl_names.ALLREDUCE, args={
                "tensors": len(bucket.members), "bytes": int(bucket.nbytes),
                "overlap": self.overlap, "issue": self._issued,
                "path": "rs_ag" if scatter else "allreduce"})
        self._issued += 1
        torch_op = mpi_ops.REDUCE_OPS[self._op]
        with self._span(track, tl_names.MEMCPY_IN_FUSION_BUFFER):
            parts = []
            for i in bucket.members:
                t = fetch(i)
                if (tuple(t.shape), t.dtype) != self._like[i]:
                    raise InvalidArgumentError(
                        f"tensor {i} is {tuple(t.shape)} {t.dtype}; the "
                        f"plan was made for {self._like[i]}")
                c, self._ctxs[i] = self._compression.compress(t)
                parts.append(c.reshape(-1))
            flat = torch.cat(parts)
        if scatter:
            n = self._n
            pad = (-flat.numel()) % n
            if pad:
                flat = F.pad(flat, (0, pad))
            shard = torch.empty(flat.numel() // n, dtype=flat.dtype,
                                device=flat.device)
            with self._span(track, tl_names.REDUCESCATTER):
                dist.reduce_scatter_tensor(shard, flat, op=torch_op)
            if self._divide_shard:
                # The sharded update: 1/n of the division work, and
                # bit-identical to dividing the gathered whole.
                shard = shard / n
                for i in bucket.members:
                    self._averaged[i] = True
            with self._span(track, tl_names.ALLGATHER):
                work = dist.all_gather_into_tensor(flat, shard,
                                                   async_op=True)
            fused_reduce.collectives += 2
        else:
            work = dist.all_reduce(flat, op=torch_op, async_op=True)
            fused_reduce.collectives += 1
        self._inflight[bi] = (flat, work)

    def _unpack(self, bi: int) -> None:
        """Wait for bucket ``bi``'s collective and split it out."""
        bucket = self.plan[bi]
        track = self._track(bucket)
        flat, work = self._inflight.pop(bi)
        work.wait()
        with self._span(track, tl_names.MEMCPY_OUT_FUSION_BUFFER):
            offset = 0
            for i in bucket.members:
                shape = self._like[i][0]
                sz = math.prod(shape)
                self._results[i] = flat[offset:offset + sz].view(shape)
                offset += sz
        if self._timeline.enabled:
            self._timeline.end(track, tl_names.ALLREDUCE)


# The gradient hook each parameter holds: id(parameter) -> (a weak
# reference to the DistributedOptimizer that placed it, its handle, a weak
# reference to the parameter that drops the entry with it). A parameter
# holds one wrapper's hook at a time.
_GRAD_HOOKS: dict = {}


def hook_grad(p: torch.Tensor, owner, hook: Callable) -> None:
    """Register ``hook`` as ``p``'s post-accumulate-grad hook on behalf
    of ``owner``, which the registry holds only weakly."""
    pid = id(p)
    _GRAD_HOOKS[pid] = (weakref.ref(owner),
                        p.register_post_accumulate_grad_hook(hook),
                        weakref.ref(p, lambda _: _GRAD_HOOKS.pop(pid, None)))


def unhook_grad(p: torch.Tensor) -> None:
    """Remove the hook :func:`hook_grad` placed on ``p``, if any."""
    entry = _GRAD_HOOKS.pop(id(p), None)
    if entry is not None:
        entry[1].remove()


def release_grad_hooks(params) -> None:
    """Take the gradient hooks off ``params``: a live owner removes all
    of its hooks (its later steps issue every bucket from ``step()``), a
    collected one's hook goes alone. A new wrapper of the parameters
    calls it first, so that no older wrapper reduces their gradients."""
    for p in params:
        entry = _GRAD_HOOKS.get(id(p))
        if entry is None:
            continue
        owner = entry[0]()
        if owner is not None:
            owner.remove_hooks()
        else:
            unhook_grad(p)


def fused_reduce(tensors, average: bool = True,
                 compression=Compression.none, op=None,
                 fusion_threshold: Optional[int] = None,
                 name: Optional[str] = None, overlap: Optional[str] = None,
                 scatter_threshold: Optional[int] = None,
                 hierarchical: Optional[str] = None, residuals=None):
    """Allreduce ``tensors`` through fused flat buckets; returns new
    tensors in input order (the inputs are not modified). ``name`` names
    the buckets' timeline tracks. Each collective issued adds one to
    ``fused_reduce.collectives``."""
    if hierarchical not in (None, "off"):
        raise NotImplementedError(
            f"hierarchical={hierarchical!r}: the two-level ladder is not "
            "ported yet (ROADMAP.md Queue 1, parallelism)")
    if residuals is not None:
        raise NotImplementedError(
            "error-feedback residuals belong to the hierarchical ladder's "
            "low-bit codecs, not ported yet (ROADMAP.md Queue 1, "
            "parallelism)")
    return BucketExchange(tensors, average, compression, op,
                          fusion_threshold, name, overlap,
                          scatter_threshold).finish(tensors.__getitem__)


fused_reduce.collectives = 0
