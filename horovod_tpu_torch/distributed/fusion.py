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

Hierarchical buckets (``HOROVOD_HIERARCHICAL=auto|on|off``,
:func:`resolve_hierarchical`): with the ladder engaged each Sum/Average
bucket runs an intra-host reduce-scatter, an inter-host exchange of the
1/``inner`` shard and an intra-host all-gather
(:func:`horovod_tpu_torch.parallel.mesh.hierarchical_ladder`), the
reference's NCCL-inside / MPI-across allreduce (operations.cc:1284-1436).
``auto`` engages only when the ranks span more than one host. Min/Max/
Product buckets stay flat, and ladder buckets never take the scatter
form (the ladder already decomposes). Under hooks a ladder bucket is
issued when its gradients are ready, as a flat one is; its legs are
chained by their work handles.

Low-bit inter-host wire (``Compression.int8`` / ``.fp8``): the shard is
quantized with one absmax scale before it crosses hosts, with an
optional error-feedback residual (:func:`ef_residual_specs`) that
re-injects the last step's quantization error. At 2 hosts the exchange
all-gathers the quantized shards with their scales and sums them
dequantized; at more, it all-to-alls quantized sub-shards, sums them
dequantized, re-quantizes (a second residual) and all-gathers. The
dequantized sums run in float32, row by row in host order, so every
rank computes the same bits; the final intra-host all-gather carries
float32 and a bfloat16 bucket is cast back at unpack. Where the 1/n of
an Average happens (the JAX package's table):

    compression   intra-host    inter-host      accumulate  1/n divide
    none          input dtype   input dtype     input       shard
    fp16 / bf16   wire dtype    wire dtype      wire        tail
    int8 / fp8    input dtype   int8/fp8+scale  float32     shard

The residuals live in the pre-divide sum domain, so feedback composes
with Average without scaling twice. Layouts (padding, shard and
sub-shard sizes) all come from :func:`hier_bucket_layout`: the executing
path, :func:`ef_residual_specs` and :func:`hier_wire_summary` read it.
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
from horovod_tpu_torch.common.config import (HIERARCHICAL_MODES,
                                              OVERLAP_MODES)
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import (Compression,
                                                       is_dcn_wire)
from horovod_tpu_torch.parallel import mesh as _mesh
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


def _hierarchical_inner(axis_size: int, domains=None) -> int:
    """Inner size of the two-phase allgather, or 0 for the flat one:
    ``HOROVOD_HIERARCHICAL_INNER_SIZE``, else the ranks per host, when it
    strictly divides the world."""
    inner = (basics.config().hierarchical_inner_size
             or _mesh.ranks_per_host(domains))
    if 1 < inner < axis_size and axis_size % inner == 0:
        return inner
    return 0


def resolve_hierarchical(mode: Optional[str], axis_size: int,
                         domains=None) -> int:
    """Resolve the ``HOROVOD_HIERARCHICAL`` knob to the inner (one
    host's) size of the ladder over ``axis_size`` ranks, or 0 for the
    flat collective. ``domains`` are the ranks' host keys (default: the
    gathered hostnames, :func:`~horovod_tpu_torch.parallel.mesh.
    rank_domains`).

    ``auto`` engages only when the ranks span more than one host, with
    the ranks per host as the inner size; ``on`` forces the ladder with
    ``HOROVOD_HIERARCHICAL_INNER_SIZE``, else the ranks per host; ``off``
    is flat. ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` reads as ``on``. An
    inner size that does not strictly divide the ranks (1 < inner <
    axis_size) gives the flat collective, the reference's
    ``is_homogeneous`` rule (operations.cc:1303-1315)."""
    cfg = basics.config()
    if mode is None:
        mode = cfg.hierarchical
        if cfg.hierarchical_allreduce:
            mode = "on"
    if mode is True:
        mode = "on"
    elif mode is False:
        mode = "off"
    if mode not in HIERARCHICAL_MODES:
        raise InvalidArgumentError(
            f"hierarchical must be one of {HIERARCHICAL_MODES} "
            f"(got {mode!r})")
    if mode == "off":
        return 0
    if domains is None:
        domains = _mesh.rank_domains()
    inner = cfg.hierarchical_inner_size
    if mode == "auto":
        if not _mesh.dcn_present(domains):
            return 0
        if not inner:
            try:
                _, inner = _mesh.slice_topology(domains)
            except InvalidArgumentError:
                # Ragged hosts and no explicit inner size: no ladder
                # tiles them.
                return 0
    elif not inner:
        try:
            n_domains, per = _mesh.slice_topology(domains)
            inner = per if n_domains > 1 else _mesh.ranks_per_host(domains)
        except InvalidArgumentError:
            inner = _mesh.ranks_per_host(domains)
    if inner and 1 < inner < axis_size and axis_size % inner == 0:
        return inner
    return 0


def _pad_up_elems(elems: int, quantum: int) -> int:
    return (elems + quantum - 1) // quantum * quantum


def hier_bucket_layout(elems: int, axis_size: int, inner: int,
                       quantized: bool) -> dict:
    """Element layout of one hierarchical bucket: ``m`` is the host
    (outer) count; a quantized bucket at m > 2 takes the two-stage
    exchange, whose all-to-all needs the shard divisible by m too."""
    m = axis_size // inner
    two_stage = quantized and m > 2
    quantum = inner * m if two_stage else inner
    padded = _pad_up_elems(elems, quantum)
    shard = padded // inner
    return {
        "m": m,
        "two_stage": two_stage,
        "padded_elems": padded,
        "shard_elems": shard,
        "sub_elems": shard // m if two_stage else 0,
    }


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _ef_eligible(bucket: Bucket) -> bool:
    """Buckets the low-bit codec (and so a residual) applies to: floating
    dtypes; integer buckets take the plain inter-host all-reduce."""
    return _torch_dtype(bucket.dtype).is_floating_point


def _ef_stages(plan: Sequence[Bucket], axis_size: int, inner: int):
    """``(plan index, [residual lengths])`` of each floating bucket of a
    quantized ladder, in plan order: the shard, and the sub-shard after
    it at m > 2 hosts."""
    out = []
    for bi, bucket in enumerate(plan):
        if _ef_eligible(bucket):
            layout = hier_bucket_layout(
                bucket.nbytes // _torch_dtype(bucket.dtype).itemsize,
                axis_size, inner, quantized=True)
            out.append((bi, [layout["shard_elems"]] + (
                [layout["sub_elems"]] if layout["two_stage"] else [])))
    return out


def _specs(stages) -> list:
    return [torch.empty((n,), dtype=torch.float32, device="meta")
            for _, lengths in stages for n in lengths]


def ef_residual_specs(leaves, threshold: int, axis_size: int, inner: int):
    """This rank's error-feedback residuals for a quantized hierarchical
    exchange over ``leaves``, as float32 ``meta`` tensors: one vector per
    quantized stage per floating bucket, in plan order (``shard_elems``,
    and ``sub_elems`` after it at m > 2 hosts). Each is this rank's
    slice of the JAX package's global vector of ``axis_size`` times that
    length; make them with ``torch.zeros_like(spec, device=...)``."""
    return _specs(_ef_stages(plan_buckets(leaves, threshold), axis_size,
                             inner))


def hier_wire_summary(plan: Sequence[Bucket], axis_size: int, inner: int,
                      compression=Compression.none) -> dict:
    """Per-leg operand bytes of a hierarchical bucket plan, from
    :func:`hier_bucket_layout`: ``ici_bytes`` the intra-host
    reduce-scatter and all-gather, ``dcn_bytes`` the inter-host exchange
    (quantized payloads and their scales under int8/fp8), ``dtype`` the
    inter-host wire dtype and ``ratio`` what that leg would carry at the
    input dtype over what it carries (1.0 uncompressed)."""
    quantizer = compression if is_dcn_wire(compression) else None
    ici = dcn = flat_dcn = 0
    dcn_dtype = None
    for b in plan:
        dt = _torch_dtype(b.dtype)
        elems = b.nbytes // dt.itemsize
        q = quantizer is not None and _ef_eligible(b)
        layout = hier_bucket_layout(elems, axis_size, inner, quantized=q)
        shard = layout["shard_elems"]
        # A quantized bucket's sum is float32, and so is its all-gather.
        ag_itemsize = 4 if q else dt.itemsize
        ici += layout["padded_elems"] * dt.itemsize + shard * ag_itemsize
        if q:
            wire = quantizer.wire_dtype
            dcn_dtype = _dtype_name(wire)
            if layout["two_stage"]:
                dcn += (shard + layout["sub_elems"]) * wire.itemsize + 8
            else:
                dcn += shard * wire.itemsize + 4
        else:
            dcn += shard * dt.itemsize
            if dcn_dtype is None:
                dcn_dtype = _dtype_name(dt)
        flat_dcn += shard * dt.itemsize
    return {
        "ici_bytes": int(ici),
        "dcn_bytes": int(dcn),
        "ici_mb": round(ici / (1024 * 1024), 3),
        "dcn_mb": round(dcn / (1024 * 1024), 3),
        "dtype": dcn_dtype,
        "ratio": round(flat_dcn / dcn, 2) if dcn else None,
    }


def _dequant_sum(rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``sum_j rows[j] * scales[j]`` in float32, added row by row in host
    order (the JAX package's order), so every rank gets the same bits."""
    out = rows[0].float() * scales[0]
    for j in range(1, rows.shape[0]):
        out = out + rows[j].float() * scales[j]
    return out


def _gather_quantized(q: torch.Tensor, scale: torch.Tensor, m: int, og,
                      quantizer):
    """All-gather ``q`` and its scale across the outer group in one
    message of bytes (the payload's one-byte view, then the scale's four
    bytes); returns ``(payloads [m, S], scales [m])``."""
    nb = q.numel()
    msg = torch.cat([quantizer.wire_view(q.reshape(-1)),
                     scale.reshape(1).view(torch.uint8)])
    out = torch.empty(m * msg.numel(), dtype=torch.uint8, device=q.device)
    dist.all_gather_into_tensor(out, msg, group=og, async_op=True).wait()
    out = out.view(m, -1)
    return (out[:, :nb].view(q.dtype),
            out[:, nb:].contiguous().view(torch.float32).reshape(m))


def _quantized_outer_exchange(shard_v, og, quantizer, layout, r_in,
                              span=_mesh._nospan):
    """The quantized inter-host leg of one bucket's ladder. ``shard_v``
    is this rank's intra-host-reduced 1/inner shard and ``r_in`` its
    residuals (or None: no feedback). Returns ``(float32 summed shard,
    [new residuals], collectives issued)``, the residuals in the
    pre-divide sum domain."""
    new_res = []
    m = layout["m"]
    v = shard_v.float()
    if r_in is not None:
        v = v + r_in[0]
    q, scale = quantizer.quantize(v)
    if r_in is not None:
        new_res.append(v - quantizer.dequantize(q, scale))
    if not layout["two_stage"]:
        with span(tl_names.ALLGATHER):
            qs, ss = _gather_quantized(q, scale, m, og, quantizer)
        return _dequant_sum(qs, ss), new_res, 1
    wire = quantizer.wire_view(q)
    recv = torch.empty_like(wire)
    ss = torch.empty(m, dtype=torch.float32, device=q.device)
    with span(tl_names.ALLTOALL):
        dist.all_to_all_single(recv, wire, group=og, async_op=True).wait()
        dist.all_gather_into_tensor(ss, scale.reshape(1), group=og,
                                    async_op=True).wait()
    u = _dequant_sum(recv.view(q.dtype).reshape(m, -1), ss)
    if r_in is not None:
        u = u + r_in[1]
    q2, scale2 = quantizer.quantize(u)
    if r_in is not None:
        new_res.append(u - quantizer.dequantize(q2, scale2))
    with span(tl_names.ALLGATHER):
        qg, sg = _gather_quantized(q2, scale2, m, og, quantizer)
    return (qg.float() * sg[:, None]).reshape(-1), new_res, 3


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
    can then run again over new tensors of the same shapes.

    ``hier`` is the resolved inner size of the ladder (0: flat). Under
    int8/fp8 on an engaged ladder, :attr:`residuals` holds the
    error-feedback residuals (:meth:`set_residuals`; ``n_residuals`` of
    them, in plan order); each issued bucket replaces its own."""

    def __init__(self, like, average: bool = True,
                 compression=Compression.none, op=None,
                 fusion_threshold: Optional[int] = None,
                 name: Optional[str] = None, overlap: Optional[str] = None,
                 scatter_threshold: Optional[int] = None,
                 hierarchical: Optional[str] = None):
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
        self._group = basics.job_group()
        self._like = [(tuple(t.shape), t.dtype) for t in like]
        self.plan = plan_buckets(
            [torch.empty(s, dtype=compression.plan_dtype(d), device="meta")
             for s, d in self._like], fusion_threshold)
        self.overlap = resolve_overlap(overlap, len(self.plan))
        plain_sum = self._op is mpi_ops.Average or self._op is mpi_ops.Sum
        # Min/Max/Product have neither a scatter form nor a ladder; one
        # rank has nothing to scatter; ladder buckets never scatter.
        self.hier = (resolve_hierarchical(hierarchical, self._n)
                     if plain_sum else 0)
        self._quantizer = (compression if self.hier
                           and is_dcn_wire(compression) else None)
        self._can_scatter = (self.overlap and plain_sum and not self.hier
                             and self._n > 1)
        self._divide_shard = (self._op is mpi_ops.Average
                              and compression is Compression.none)
        self._bucket_of = {i: bi for bi, b in enumerate(self.plan)
                           for i in b.members}
        # Error-feedback slots: bucket -> (offset, count) into residuals.
        self._ef = (_ef_stages(self.plan, self._n, self.hier)
                    if self._quantizer is not None else [])
        self._ef_slots: dict = {}
        off = 0
        for bi, lengths in self._ef:
            self._ef_slots[bi] = (off, len(lengths))
            off += len(lengths)
        self.n_residuals = off
        self.residuals: Optional[list] = None
        if self.hier:
            _mesh.ladder_groups(self._n, self.hier)
        self._timeline = basics.timeline()
        self._reset()

    def _layout(self, bucket: Bucket, quantized: bool) -> dict:
        elems = bucket.nbytes // _torch_dtype(bucket.dtype).itemsize
        return hier_bucket_layout(elems, self._n, self.hier, quantized)

    def residual_specs(self) -> list:
        """This rank's residual shapes (float32 ``meta`` tensors, plan
        order) for the plan: what :func:`ef_residual_specs` gives."""
        return _specs(self._ef)

    def set_residuals(self, residuals) -> None:
        """Check ``residuals`` against the plan and hold them for the
        next exchange (``None``: quantize without feedback). Raises when
        they exist but the ladder resolves flat (the wire would carry
        full precision while the state says int8/fp8), and when their
        number or shapes are not the plan's."""
        if residuals and is_dcn_wire(self._compression) \
                and self._quantizer is None:
            raise InvalidArgumentError(
                "error-feedback residuals are present but the hierarchical "
                f"ladder resolves to FLAT on this {self._n}-rank world "
                "(HOROVOD_HIERARCHICAL_INNER_SIZE must satisfy 1 < inner "
                f"< {self._n} and divide it): the optimizer state was "
                "made for another world or inner size; make it again "
                "(fusion.ef_residual_specs) for this one")
        if self._quantizer is None or residuals is None:
            self.residuals = None
            return
        residuals = list(residuals)
        if len(residuals) != self.n_residuals:
            raise InvalidArgumentError(
                f"error-feedback residuals carry {len(residuals)} leaves "
                f"but this plan needs {self.n_residuals} (one per "
                "quantized stage per floating bucket, plan order; make "
                "them again with fusion.ef_residual_specs after changing "
                "the fusion threshold, world size or inner size)")
        for i, (r, spec) in enumerate(zip(residuals,
                                          self.residual_specs())):
            if tuple(r.shape) != tuple(spec.shape) \
                    or r.dtype != torch.float32:
                raise InvalidArgumentError(
                    f"error-feedback residual {i} is {tuple(r.shape)} "
                    f"{r.dtype}; this rank's shard needs "
                    f"{tuple(spec.shape)} float32: residuals are "
                    "rank-local state (fusion.ef_residual_specs gives "
                    "each rank's shapes)")
        self.residuals = residuals

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
        hier_q = self._quantizer is not None and _ef_eligible(bucket)
        if self.hier:
            path = (f"hier_{_dtype_name(self._quantizer.wire_dtype)}"
                    if hier_q else "hier")
        else:
            path = "rs_ag" if scatter else "allreduce"
        if self._timeline.enabled:
            self._timeline.start(track, tl_names.ALLREDUCE, args={
                "tensors": len(bucket.members), "bytes": int(bucket.nbytes),
                "overlap": self.overlap, "issue": self._issued,
                "path": path,
                **({"inner": self.hier} if self.hier else {})})
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
        if self.hier:
            self._inflight[bi] = self._issue_ladder(bi, flat, hier_q, track)
            return
        if scatter:
            n = self._n
            pad = (-flat.numel()) % n
            if pad:
                flat = F.pad(flat, (0, pad))
            shard = torch.empty(flat.numel() // n, dtype=flat.dtype,
                                device=flat.device)
            with self._span(track, tl_names.REDUCESCATTER):
                dist.reduce_scatter_tensor(shard, flat, op=torch_op,
                                           group=self._group)
            if self._divide_shard:
                # The sharded update: 1/n of the division work, and
                # bit-identical to dividing the gathered whole.
                shard = shard / n
                for i in bucket.members:
                    self._averaged[i] = True
            with self._span(track, tl_names.ALLGATHER):
                work = dist.all_gather_into_tensor(flat, shard,
                                                   group=self._group,
                                                   async_op=True)
            fused_reduce.collectives += 2
        else:
            work = dist.all_reduce(flat, op=torch_op, group=self._group,
                                   async_op=True)
            fused_reduce.collectives += 1
        self._inflight[bi] = (flat, work)

    def _issue_ladder(self, bi: int, flat: torch.Tensor, hier_q: bool,
                      track: str):
        """Start bucket ``bi``'s ladder over its flat buffer; returns the
        reduced buffer (padded) and the work of its final all-gather."""
        n = self._n
        bucket = self.plan[bi]
        size = flat.numel()
        layout = self._layout(bucket, hier_q)
        pad = layout["padded_elems"] - size
        if pad:
            flat = F.pad(flat, (0, pad))
        # Average divides the summed 1/inner shard before the all-gather
        # (bit-identical to a tail divide); the cast compressors keep the
        # tail divide of the flat path.
        divide = self._op is mpi_ops.Average and (
            hier_q or self._compression is Compression.none)
        slot = (self._ef_slots[bi] if hier_q and self.residuals is not None
                else None)

        def span(activity):
            return self._span(track, activity)

        def outer(shard, og):
            if hier_q:
                r_in = (None if slot is None else
                        tuple(self.residuals[slot[0]:slot[0] + slot[1]]))
                shard, new_res, issued = _quantized_outer_exchange(
                    shard, og, self._quantizer, layout, r_in, span)
                if slot is not None:
                    self.residuals[slot[0]:slot[0] + slot[1]] = new_res
                fused_reduce.collectives += issued
            else:
                with span(tl_names.ALLREDUCE):
                    dist.all_reduce(shard, group=og, async_op=True).wait()
                fused_reduce.collectives += 1
            return shard / n if divide else shard

        reduced, work = _mesh.hierarchical_ladder(
            flat, self.hier, outer_exchange=outer, async_op=True, span=span)
        fused_reduce.collectives += 2
        if divide:
            for i in bucket.members:
                self._averaged[i] = True
        return reduced, work

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
    ``fused_reduce.collectives``.

    ``hierarchical`` (auto|on|off, default ``HOROVOD_HIERARCHICAL``) runs
    each Sum/Average bucket as the intra-host / inter-host ladder; under
    ``Compression.int8``/``.fp8`` its inter-host leg is quantized, with
    error feedback from ``residuals`` (this rank's vectors, shaped as
    :func:`ef_residual_specs` gives them). Given ``residuals``, returns
    ``(tensors, new_residuals)``; they pass through untouched where no
    quantized leg runs."""
    ex = BucketExchange(tensors, average, compression, op,
                        fusion_threshold, name, overlap, scatter_threshold,
                        hierarchical)
    ex.set_residuals(residuals)
    out = ex.finish(tensors.__getitem__)
    if residuals is None:
        return out
    return out, tuple(ex.residuals if ex.residuals is not None
                      else residuals)


fused_reduce.collectives = 0
