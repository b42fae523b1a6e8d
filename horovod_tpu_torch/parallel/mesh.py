"""Mesh construction and the hierarchical collectives over
``torch.distributed``: the port of ``horovod_tpu.parallel.mesh``.

The reference Horovod split ``MPI_COMM_WORLD`` into node-local and
cross-node communicators to run its hierarchical allreduce (NCCL inside
a node, MPI across it: operations.cc:1284-1436, 1760-1797). The JAX
package lays the same split out as a 2-D mesh, ICI inside a slice and
DCN across slices. Here a **domain is a host**: the fast inner axis is a
host's NVLink, the slow outer axis the network between hosts. Ranks are
numbered host-major (as ``torchrun`` numbers them), so the ranks of one
host are consecutive.

* :class:`Mesh` is a rank grid with axis names; it builds its
  ``DeviceMesh`` only when asked (``.device_mesh``), so the layout
  functions (:func:`make_mesh`, :func:`hybrid_mesh`,
  :func:`hierarchical_mesh`) need no process group;
* :func:`slice_topology` / :func:`dcn_present` read a list of per-rank
  domain keys, by default the hostnames (:func:`rank_domains`, gathered
  once and cached);
* the ranks are the job's (:func:`world_ranks`): the world's, or those
  of ``hvd.init(comm=)``, whose collectives run over its group; a mesh's
  ``DeviceMesh`` and the ladder's groups over such a subset are not
  ported and raise ``NotImplementedError`` (every rank of the world
  would have to create them, and the ranks outside the job have left);
* :func:`inner_groups` / :func:`outer_groups` are the ladder's groups of
  a flat world, and :func:`ladder_groups` creates them as process groups
  (every rank creates every group, in one order, cached per world and
  inner size);
* :func:`hierarchical_ladder` is the rung that every hierarchical
  consumer runs: reduce-scatter inside the inner group, an exchange of
  the 1/inner shard across the outer group, all-gather inside the inner
  group.
"""

from __future__ import annotations

import contextlib
import math
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.parallel.logical import DCN_AXIS, ICI_AXIS


class Mesh:
    """A named grid of ranks. ``devices`` is the integer rank array (the
    counterpart of a JAX mesh's device array), ``axis_names`` its axes
    and ``shape`` the ``{axis: size}`` dict; :attr:`device_mesh` is the
    ``torch.distributed`` ``DeviceMesh`` over it, built on first use (a
    collective: every rank of the world asks, in the same order)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise InvalidArgumentError(
                f"rank grid of shape {self.devices.shape} has "
                f"{len(self.axis_names)} axis names")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self._device_mesh = None

    @property
    def device_mesh(self):
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            from horovod_tpu_torch.common import basics

            _whole_world("a DeviceMesh")
            dev = basics.device().type if basics.is_initialized() else "cpu"
            self._device_mesh = DeviceMesh(
                dev, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _job():
    """``(group, global ranks)`` of the job: ``hvd.init``'s (its
    ``comm`` subset, or the world with group ``None``), else the
    process group's world (``[0]`` without one)."""
    from horovod_tpu_torch.common import basics

    if basics.is_initialized():
        return basics.job_group(), basics.job_ranks()
    return None, list(range(dist.get_world_size() if dist.is_initialized()
                            else 1))


def _whole_world(what: str) -> None:
    """Raise when the job is an ``init(comm=)`` subset: ``what`` needs
    every rank of the world to create its process groups."""
    group, ranks = _job()
    if group is not None:
        raise NotImplementedError(
            f"{what} over the hvd.init(comm={ranks}) subset is not ported: "
            "its process groups are created by every rank of the world, "
            "and the ranks outside comm have left the job; run the job "
            "as a world of its own (launch only those ranks)")


def world_ranks() -> List[int]:
    """Every rank of the job: the process group's (``[0]`` without one),
    or those of ``hvd.init(comm=)``."""
    return _job()[1]


# (the job's process group, the world's, {global rank: hostname}):
# gathered once per group.
_HOSTS: list = [None, None, None]


def rank_domains(ranks: Optional[Sequence[int]] = None) -> list:
    """Each rank's domain key: its hostname, gathered once from every
    rank of the job (``all_gather_object`` over its group, a collective
    on first use) and cached; without a process group (or in a job of
    one), this host's name for every rank asked about. ``ranks`` selects
    global ranks (default: the job's, in order)."""
    group, job = _job()
    if not dist.is_initialized() or len(job) == 1:
        host = socket.gethostname()
        return [host] * (1 if ranks is None else len(ranks))
    world = dist.distributed_c10d._get_default_group()
    if _HOSTS[0] is not group or _HOSTS[1] is not world:
        hosts = [None] * len(job)
        dist.all_gather_object(hosts, socket.gethostname(), group=group)
        _HOSTS[:] = [group, world, dict(zip(job, hosts))]
    by_rank = _HOSTS[2]
    return [by_rank[r] for r in (job if ranks is None else ranks)]


def make_mesh(axes: Dict[str, int], ranks=None) -> Mesh:
    """A named mesh with the given axis sizes (major to minor) over
    ``ranks`` (default: the world); their product must equal the rank
    count, and at most one axis may be -1 to absorb the remainder."""
    ranks = list(ranks) if ranks is not None else world_ranks()
    n = len(ranks)
    names = list(axes)
    sizes = list(axes.values())
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise InvalidArgumentError("at most one axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if wild:
        if n % fixed != 0:
            raise InvalidArgumentError(
                f"{n} devices not divisible by {fixed}")
        sizes[wild[0]] = n // fixed
    if math.prod(sizes) != n:
        raise InvalidArgumentError(
            f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
            f"devices, have {n}")
    return Mesh(np.asarray(ranks, dtype=np.int64).reshape(sizes), names)


def _counts(domains) -> Dict:
    counts: Dict = {}
    for key in domains:
        counts[key] = counts.get(key, 0) + 1
    return counts


def slice_topology(domains: Optional[Sequence] = None) -> Tuple[int, int]:
    """``(num_domains, ranks_per_domain)`` of a list of per-rank domain
    keys (default: :func:`rank_domains`, the hostnames). Heterogeneous
    domain sizes raise, as the reference's ``is_homogeneous`` rule
    degrades (operations.cc:1303-1315)."""
    domains = list(domains) if domains is not None else rank_domains()
    counts = _counts(domains)
    sizes = set(counts.values())
    if len(sizes) > 1:
        raise InvalidArgumentError(
            "heterogeneous chips-per-domain layout; pass inner= "
            f"explicitly (saw {sorted(sizes)})")
    per = next(iter(sizes)) if sizes else 1
    return len(counts), per


def dcn_present(domains: Optional[Sequence] = None) -> bool:
    """True when the ranks span more than one host: what
    ``HOROVOD_HIERARCHICAL=auto`` keys off."""
    try:
        n_domains, _ = slice_topology(domains)
    except InvalidArgumentError:
        return True  # heterogeneous = definitely multi-domain
    return n_domains > 1


def ranks_per_host(domains: Optional[Sequence] = None,
                   rank: Optional[int] = None) -> int:
    """How many ranks share this rank's host: the port's counterpart of
    the JAX package's chips per process (one port rank owns one card)."""
    domains = list(domains) if domains is not None else rank_domains()
    if rank is None:
        group, _ = _job()
        rank = dist.get_rank(group) if dist.is_initialized() else 0
    return domains.count(domains[rank])


def hybrid_mesh(ici_axes: Optional[Dict[str, int]] = None,
                dcn_axes: Optional[Dict[str, int]] = None,
                domains: Optional[Sequence] = None,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Two-level mesh: inter-host (``dcn``) axes major, intra-host
    (``ici``) axes minor, so a collective over the intra-host axes never
    leaves the host. ``domains`` are the host keys of ``ranks`` (default:
    the world's ranks and their hostnames). The ici product must equal
    the ranks per host and the dcn product the host count (both default
    to the detected :func:`slice_topology`, axes named "ici"/"dcn"); on
    one host the axes may factor freely. Ranks are ordered host-major."""
    if ranks is None:
        ranks = (list(range(len(domains))) if domains is not None
                 else world_ranks())
    ranks = list(ranks)
    domains = (list(domains) if domains is not None
               else rank_domains(ranks))
    n_domains, per = slice_topology(domains)
    if ici_axes is None:
        ici_axes = {ICI_AXIS: per}
    if dcn_axes is None:
        dcn_axes = {DCN_AXIS: n_domains}
    ici_n = math.prod(ici_axes.values())
    dcn_n = math.prod(dcn_axes.values())
    if ici_n * dcn_n != len(ranks):
        raise InvalidArgumentError(
            f"hybrid mesh {dict(dcn_axes)} x {dict(ici_axes)} needs "
            f"{ici_n * dcn_n} devices, have {len(ranks)}")
    if n_domains > 1 and (ici_n != per or dcn_n != n_domains):
        raise InvalidArgumentError(
            f"hybrid mesh ICI axes {dict(ici_axes)} x DCN axes "
            f"{dict(dcn_axes)} do not tile the detected topology of "
            f"{n_domains} domain(s) x {per} chip(s): ICI product must be "
            f"{per} and DCN product {n_domains}, or an ICI axis would "
            "cross a DCN boundary")
    keyed = [r for _, r in sorted(zip(domains, ranks))]
    sizes = list(dcn_axes.values()) + list(ici_axes.values())
    names = tuple(dcn_axes) + tuple(ici_axes)
    return Mesh(np.asarray(keyed, dtype=np.int64).reshape(sizes), names)


def hierarchical_mesh(ranks: Optional[Sequence[int]] = None,
                      inner: Optional[int] = None,
                      outer_axis: str = DCN_AXIS,
                      inner_axis: str = ICI_AXIS,
                      domains: Optional[Sequence] = None) -> Mesh:
    """Two-level ``(outer, inner)`` mesh for hierarchical collectives.
    ``inner`` defaults to the ranks per host (heterogeneous hosts raise),
    so the inner axis stays inside one host."""
    ranks = list(ranks) if ranks is not None else world_ranks()
    if inner is None:
        domains = (list(domains) if domains is not None
                   else rank_domains(ranks))
        sizes = set(_counts(domains).values())
        if len(sizes) > 1:
            raise InvalidArgumentError(
                "heterogeneous chips-per-process layout; pass inner= "
                f"explicitly (saw {sorted(sizes)})")
        inner = next(iter(sizes)) if sizes else 1
    if inner <= 0 or len(ranks) % inner != 0:
        raise InvalidArgumentError(
            f"inner size {inner} does not divide {len(ranks)} devices")
    return make_mesh({outer_axis: len(ranks) // inner, inner_axis: inner},
                     ranks)


def inner_groups(size: int, inner: int):
    """Fast-domain groups of a flat world of ``size``: consecutive ranks
    share a group (the reference's node-local communicator)."""
    return [[o * inner + i for i in range(inner)]
            for o in range(size // inner)]


def outer_groups(size: int, inner: int):
    """Slow-domain groups: one per inner index, striding across the fast
    domains (the reference's per-local-rank cross communicator)."""
    return [[o * inner + i for o in range(size // inner)]
            for i in range(inner)]


# (default process group, size, inner) -> (my inner group, my outer group)
_GROUPS: dict = {}


def ladder_groups(size: int, inner: int):
    """This rank's ``(inner group, outer group)`` of the ladder over a
    world of ``size``: every rank creates every group, in the same order,
    once per world and inner size; each new group runs one tiny
    all-reduce, so that a lazily built communicator (NCCL's) is ready
    before anything is timed."""
    _whole_world("the hierarchical ladder")
    world = dist.distributed_c10d._get_default_group()
    key = (world, size, inner)
    if key not in _GROUPS:
        for k in [k for k in _GROUPS if k[0] is not world]:
            del _GROUPS[k]
        ig, _ = dist.new_subgroups_by_enumeration(inner_groups(size, inner))
        og, _ = dist.new_subgroups_by_enumeration(outer_groups(size, inner))
        from horovod_tpu_torch.common import basics

        dev = basics.device() if basics.is_initialized() else "cpu"
        for g in (ig, og):
            dist.all_reduce(torch.zeros(1, device=dev), group=g)
        _GROUPS[key] = (ig, og)
    return _GROUPS[key]


def _nospan(_activity):
    return contextlib.nullcontext()


def hierarchical_ladder(flat: torch.Tensor, inner: int,
                        outer_exchange=None, async_op: bool = False,
                        span=_nospan):
    """The two-level ladder over the flat world: reduce-scatter ``flat``
    inside the inner group, exchange this rank's 1/``inner`` shard across
    the outer group, all-gather inside the inner group. The inter-host
    leg moves size/inner bytes a rank, the bandwidth the reference's
    hierarchical design bought (operations.cc:1284-1436).

    ``flat`` is 1-D with ``flat.numel() % inner == 0``.
    ``outer_exchange(shard, outer_group)`` replaces the default
    cross-group all-reduce and returns the reduced shard (the fused
    buckets pass the quantized int8/fp8 exchange here); it may return
    another dtype, which the all-gather then carries. The legs are
    chained by their work handles: on NCCL a wait orders the card's
    streams and does not block the host. With ``async_op`` returns
    ``(reduced, work)`` with the all-gather in flight, else the reduced
    flat tensor. ``span(activity)`` wraps each leg (the timeline)."""
    from horovod_tpu_torch.utils import timeline as tl_names

    ig, og = ladder_groups(len(world_ranks()), inner)
    shard = torch.empty(flat.numel() // inner, dtype=flat.dtype,
                        device=flat.device)
    with span(tl_names.REDUCESCATTER):
        dist.reduce_scatter_tensor(shard, flat, group=ig,
                                   async_op=True).wait()
    if outer_exchange is None:
        with span(tl_names.ALLREDUCE):
            dist.all_reduce(shard, group=og, async_op=True).wait()
    else:
        shard = outer_exchange(shard, og)
    out = torch.empty(shard.numel() * inner, dtype=shard.dtype,
                      device=shard.device)
    with span(tl_names.ALLGATHER):
        work = dist.all_gather_into_tensor(out, shard, group=ig,
                                           async_op=True)
    if async_op:
        return out, work
    work.wait()
    return out


def _flat_ladder(x: torch.Tensor, inner: int, ladder) -> torch.Tensor:
    n = x.numel()
    pad = (-n) % inner
    flat = x.reshape(-1)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    full = ladder(flat)
    return full[:n].reshape(x.shape)


def hierarchical_allreduce_in_axis(x: torch.Tensor, inner: int,
                                   average: bool = False) -> torch.Tensor:
    """Two-level allreduce of one tensor over the flat world: a pad and
    reshape around :func:`hierarchical_ladder`. An ``inner`` that does
    not strictly divide the world (1 < inner < size) takes the flat
    all-reduce."""
    group, ranks = _job()
    size = len(ranks)
    if inner <= 1 or inner >= size or size % inner != 0:
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
    else:
        out = _flat_ladder(x, inner,
                           lambda f: hierarchical_ladder(f, inner))
    return out / size if average else out


def hierarchical_allgather_in_axis(x: torch.Tensor,
                                   inner: int) -> torch.Tensor:
    """Two-phase allgather over the flat world (reference
    operations.cc:929-1032): gather inside the inner group, then
    exchange whole inner-group blocks across the outer group; the result
    is the rank-major concatenation along dimension 0 that a flat gather
    gives."""
    job, ranks = _job()
    size = len(ranks)
    src = x.contiguous()

    def gather(t, n, group=None):
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    if inner <= 1 or inner >= size or size % inner != 0:
        return gather(src, size, job)
    ig, og = ladder_groups(size, inner)
    return gather(gather(src, inner, ig), size // inner, og)


def hierarchical_allreduce(x: torch.Tensor, mesh,
                           outer_axis: str = DCN_AXIS,
                           inner_axis: str = ICI_AXIS,
                           average: bool = False) -> torch.Tensor:
    """Two-phase allreduce over a 2-D mesh (a :class:`Mesh`, a
    ``LogicalMesh`` or a ``DeviceMesh`` naming both axes): reduce-scatter
    along ``inner_axis``, all-reduce the 1/inner shard along
    ``outer_axis``, all-gather along ``inner_axis``."""
    dm = getattr(mesh, "mesh", mesh)
    dm = getattr(dm, "device_mesh", dm)
    ig, og = dm.get_group(inner_axis), dm.get_group(outer_axis)
    inner = dist.get_world_size(ig)

    def ladder(flat):
        shard = torch.empty(flat.numel() // inner, dtype=flat.dtype,
                            device=flat.device)
        dist.reduce_scatter_tensor(shard, flat, group=ig)
        dist.all_reduce(shard, group=og)
        out = torch.empty_like(flat)
        dist.all_gather_into_tensor(out, shard, group=ig)
        return out

    out = _flat_ladder(x, inner, ladder)
    if average:
        out = out / (inner * dist.get_world_size(og))
    return out
