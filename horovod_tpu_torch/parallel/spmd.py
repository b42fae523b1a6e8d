"""The SPMD rank harness: the port of ``horovod_tpu.parallel.spmd``.

The JAX package traces ``fn`` once under ``shard_map`` over a mesh axis:
every chip runs the same program, ``hvd.rank()`` is the chip's index
along the axis and ``hvd.allreduce`` lowers to ``lax.psum``. Here a
process is one card, so the harness is the JAX package's multi-process
form: every rank calls the handle with its own arguments, ``fn`` runs
once on each rank inside a region over the axis (the context variable of
:func:`~horovod_tpu_torch.common.basics.current_spmd_axis`), and inside
the region

* :func:`~horovod_tpu_torch.common.basics.rank` and ``local_rank`` are
  this rank's index along the axis;
* every collective of :mod:`horovod_tpu_torch.distributed.mpi_ops` runs
  over the axis's process group, and ``allreduce``, ``allgather``,
  ``broadcast``, ``alltoall`` and ``reducescatter`` carry the gradients
  of their ``lax`` counterparts' transposes.

The axis is ``axis_name`` of the given mesh (a
:class:`~horovod_tpu_torch.parallel.mesh.Mesh` or a
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`, which is also
bound for the region), else of the bound mesh when it defines the axis,
else of the default 1-D mesh over the world (``hvd.mesh()``, axis
``"hvd"``).

Specs are :class:`PartitionSpec` (``P``) trees, one entry per argument
(or one spec for all), with one axis name (or ``None``) per dimension,
as in the JAX package. ``host_local=True`` (the default, the Horovod
programming model): each rank passes its own shard and gets its own
outputs; in a world of one that is the whole value. ``host_local=False``:
every rank passes whole tensors, the harness takes this rank's block
along every dimension that an in-spec shards, and all-gathers every
sharded output, so every rank returns the whole value.

Under ``HOROVOD_AUTOTUNE`` each call of an :func:`spmd_fn` handle is one
dispatch of the step tuner (:mod:`horovod_tpu_torch.distributed.
autotune`: ``claim``, ``step_done``, then ``end_window`` on the output),
as in the JAX package. Nothing is traced, so nothing is built again when
the tuner moves: the bucket collectives read the threshold at each call,
and the plans held across calls key on the tuner's generation.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.parallel.logical import (DATA_AXIS, LogicalMesh,
                                                bind, current_logical_mesh)
from horovod_tpu_torch.utils import timeline as tl_names


class PartitionSpec(tuple):
    """One tensor's sharding: per dimension an axis name, a tuple of
    axis names (major to minor) or ``None`` (``P()``: replicated), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # Pickle rebuilds through __new__(cls, *entries), not the one
        # tuple a plain tuple subclass would pass.
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def _grid(mesh):
    """The rank grid (:class:`~horovod_tpu_torch.parallel.mesh.Mesh`) of
    a Mesh or a LogicalMesh."""
    return getattr(mesh, "grid", mesh)


def _resolve_mesh(mesh, axis_name: str):
    if mesh is not None:
        return mesh
    lm = current_logical_mesh()
    if lm is not None and lm.defines(axis_name):
        return lm
    return basics.mesh()


def axis_size(mesh=None, axis: str = DATA_AXIS) -> int:
    """Size of ``axis`` of ``mesh`` (default: the default mesh)."""
    return _grid(mesh if mesh is not None else basics.mesh()).shape[axis]


class _Layout:
    """This rank's place in a mesh: its coordinate along every axis and,
    on demand, each axis's process group."""

    def __init__(self, mesh, axis_name: str):
        grid = _grid(mesh)
        if axis_name not in grid.shape:
            raise InvalidArgumentError(
                f"mesh {grid.shape} has no axis {axis_name!r}")
        me = np.argwhere(grid.devices == dist.get_rank())
        if len(me) == 0:
            raise InvalidArgumentError(
                f"rank {dist.get_rank()} is not in the mesh {grid.shape}")
        self.grid = grid
        self.coords = dict(zip(grid.axis_names, (int(c) for c in me[0])))
        self.axis = basics.SpmdAxis(axis_name, self.group(axis_name),
                                    grid.shape[axis_name],
                                    self.coords[axis_name])

    def group(self, axis: str):
        if axis not in self.grid.shape:
            raise InvalidArgumentError(
                f"spec names axis {axis!r}, which the mesh "
                f"{self.grid.shape} lacks")
        if self.grid.shape[axis] == 1:
            return None
        job = basics.job_group()
        if job is not None and self.grid.devices.ndim == 1 \
                and self.grid.devices.tolist() == basics.job_ranks():
            # The default mesh of an init(comm=) job: the job's group.
            return job
        return self.grid.device_mesh.get_group(axis)

    def block(self, entry):
        """``(blocks, index)`` of one spec entry: how many blocks the
        dimension splits into and which of them is this rank's."""
        axes = entry if isinstance(entry, tuple) else (entry,)
        blocks, index = 1, 0
        for a in axes:
            if a not in self.grid.shape:
                raise InvalidArgumentError(
                    f"spec names axis {a!r}, which the mesh "
                    f"{self.grid.shape} lacks")
            n = self.grid.shape[a]
            blocks, index = blocks * n, index * n + self.coords[a]
        return blocks, index

    def take(self, x, spec):
        """This rank's block of the whole tensor ``x`` along ``spec``."""
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            blocks, index = self.block(entry)
            if x.shape[dim] % blocks:
                raise InvalidArgumentError(
                    f"dim {dim} of size {x.shape[dim]} does not split "
                    f"into {blocks} blocks along {entry!r}")
            x = x.chunk(blocks, dim=dim)[index]
        return x.contiguous()

    def gather(self, x, spec):
        """The whole tensor from every rank's block ``x`` along ``spec``:
        one all-gather per named axis, the minor axis first."""
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for a in reversed(entry if isinstance(entry, tuple)
                              else (entry,)):
                group, n = self.group(a), self.grid.shape[a]
                if group is None:
                    continue
                src = x.movedim(dim, 0).contiguous()
                out = torch.empty((n * src.shape[0], *src.shape[1:]),
                                  dtype=src.dtype, device=src.device)
                dist.all_gather_into_tensor(out, src, group=group)
                x = out.movedim(0, dim)
        return x


def _is_spec(s) -> bool:
    return s is None or isinstance(s, PartitionSpec)


def _map_specs(specs, tree, fn):
    """Apply ``fn(leaf, spec)`` over ``tree`` with ``specs`` a prefix of
    it: a spec applies to every tensor below it."""
    if _is_spec(specs):
        spec = specs if specs is not None else P()

        def leaf(x):
            if isinstance(x, dict):
                return {k: leaf(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(leaf(v) for v in x)
            return fn(x, spec) if torch.is_tensor(x) else x
        return leaf(tree)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise InvalidArgumentError(
                f"spec keys {sorted(specs)} do not match the value's")
        return {k: _map_specs(specs[k], v, fn) for k, v in tree.items()}
    if not isinstance(tree, (list, tuple)) or len(tree) != len(specs):
        raise InvalidArgumentError(
            f"{len(specs)} specs for a value of "
            f"{len(tree) if isinstance(tree, (list, tuple)) else 1} "
            "entries")
    return type(tree)(_map_specs(s, v, fn) for s, v in zip(specs, tree))


def _as_tensor(x):
    """numpy arrays become tensors on the initialised device; everything
    else passes as it is."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=basics.device())
    return x


def spmd_fn(fn, *, mesh=None, axis_name: str = DATA_AXIS,
            in_specs: Any = P(), out_specs: Any = P(),
            check_vma: bool = False, jit: bool = True, donate_argnums=(),
            host_local: bool = True):
    """Build the SPMD form of ``fn``: a handle that every rank of the
    mesh calls with its arguments (module docstring for the axis, the
    specs and ``host_local``).

    ``check_vma``, ``jit`` and ``donate_argnums`` have no meaning in
    eager torch and are accepted as no-ops (there is no trace to check,
    nothing to compile, and no buffer to donate).

    When ``HOROVOD_TIMELINE`` is active (rank 0 writes), each handle
    emits ``XLA_COMPILE`` around its first call and ``XLA_EXECUTE``
    around every later one, on a track named after ``fn``, the JAX
    package's taxonomy. Nothing is compiled here: the first span
    (``args.span = "first_call"``) times the first eager run, which also
    makes the axis's process group and builds any kernel the run
    launches first; the later ones (``"host_dispatch"``) time the host's
    part of a call, kernel launches being asynchronous (collectives over
    gloo block)."""
    del check_vma, jit, donate_argnums
    mesh = _resolve_mesh(mesh, axis_name)
    track = getattr(fn, "__name__", "spmd_fn")
    state = {"layout": None}

    def run(args, kwargs):
        if state["layout"] is None:
            state["layout"] = _Layout(mesh, axis_name)
        layout = state["layout"]
        args = tuple(_as_tensor(a) for a in args)
        if not host_local:
            args = _map_specs(in_specs, args, layout.take)
        token = basics.set_spmd_axis(layout.axis)
        try:
            if isinstance(mesh, LogicalMesh) \
                    and current_logical_mesh() is not mesh:
                with bind(mesh):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
        finally:
            basics.reset_spmd_axis(token)
        if not host_local:
            out = _map_specs(out_specs, out, layout.gather)
        return out

    called = [False]

    def timed(args, kwargs):
        tl = basics.timeline()
        if not tl.enabled:
            called[0] = True
            return run(args, kwargs)
        first = not called[0]
        act = tl_names.XLA_COMPILE if first else tl_names.XLA_EXECUTE
        tl.start(track, act,
                 args={"span": "first_call" if first else "host_dispatch"})
        try:
            return run(args, kwargs)
        finally:
            tl.end(track, act)
            called[0] = True

    @functools.wraps(fn)
    def dispatch(*args, **kwargs):
        from horovod_tpu_torch.distributed.autotune import tuned_call

        return tuned_call(dispatch, lambda: timed(args, kwargs))

    return dispatch


# (fn, mesh, axis, specs, host_local) -> handle, a bounded LRU. A handle
# closes over fn, so weak keying could never evict; the cap keeps
# per-call lambdas from piling up handles. Pass a stable fn object for
# hits.
_SPMD_CACHE_MAX = 128
_spmd_cache: dict = {}


def _hashable_specs(specs):
    if isinstance(specs, PartitionSpec):
        return specs
    if isinstance(specs, (list, tuple)):
        return tuple(_hashable_specs(s) for s in specs)
    if isinstance(specs, dict):
        return tuple(sorted((k, _hashable_specs(v))
                            for k, v in specs.items()))
    return specs


def spmd_run(fn, *args, mesh=None, axis_name: str = DATA_AXIS,
             in_specs: Any = P(), out_specs: Any = P(),
             check_vma: bool = False, host_local: bool = True):
    """Run ``fn(*args)`` as a per-rank SPMD program (:func:`spmd_fn`);
    every rank of the mesh calls it.

    The handle is cached per ``(fn, mesh, axis, specs)``: repeated calls
    with the same ``fn`` object reuse it (and its axis's process
    group)."""
    mesh = _resolve_mesh(mesh, axis_name)
    try:
        key = (fn, mesh, axis_name, _hashable_specs(in_specs),
               _hashable_specs(out_specs), host_local)
        handle = _spmd_cache.pop(key, None)   # pop + reinsert = LRU touch
    except TypeError:                        # unhashable: build uncached
        key, handle = None, None
    if handle is None:
        handle = spmd_fn(fn, mesh=mesh, axis_name=axis_name,
                         in_specs=in_specs, out_specs=out_specs,
                         check_vma=check_vma, host_local=host_local)
    if key is not None:
        _spmd_cache[key] = handle
        while len(_spmd_cache) > _SPMD_CACHE_MAX:
            _spmd_cache.pop(next(iter(_spmd_cache)))
    return handle(*args)


def spmd(fn=None, *, mesh=None, axis_name: str = DATA_AXIS,
         in_specs: Any = P(), out_specs: Any = P(),
         check_vma: bool = False, host_local: bool = True):
    """Decorator form of :func:`spmd_run`. The mesh resolves at call
    time, so the decorator can be applied before ``hvd.init()``. Keyword
    arguments are bound as partials (replicated constants), one partial
    per combination, so repeated calls hit the :func:`spmd_run` cache."""

    def deco(f):
        partials: dict = {}

        @functools.wraps(f)
        def caller(*args, **kwargs):
            if kwargs:
                try:
                    pkey = tuple(sorted(kwargs.items()))
                    g = partials.get(pkey)
                    if g is None:
                        g = partials[pkey] = functools.partial(f, **kwargs)
                except TypeError:   # unhashable kwarg: no caching
                    g = functools.partial(f, **kwargs)
            else:
                g = f
            return spmd_run(g, *args, mesh=mesh, axis_name=axis_name,
                            in_specs=in_specs, out_specs=out_specs,
                            check_vma=check_vma, host_local=host_local)

        caller.partials = partials
        return caller

    if fn is None:
        return deco
    return deco(fn)
