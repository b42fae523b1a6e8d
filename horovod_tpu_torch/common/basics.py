"""Lifecycle and topology over ``torch.distributed``: the port of
``horovod_tpu.common.basics``, with the SPMD region's axis (the JAX
package keeps it in ``common/state.py``).

One process per card. :func:`init` joins a process group: the caller's,
when one is already initialised; the launcher's, when the environment
names one (``RANK`` and ``WORLD_SIZE``, with ``MASTER_ADDR`` and
``MASTER_PORT``, as ``torchrun`` sets them); otherwise a world of one
(``store=HashStore(), rank=0, world_size=1``). A world that ``init``
makes runs NCCL on the card and gloo on the CPU. A caller's gloo group
is taken on the card too, with the tensors staying on the card: ranks
that share one card cannot form an NCCL world (NCCL refuses two ranks
on one device), and gloo carries every collective of the port on CUDA
tensors (PERF.md). The state is the process's own, as the process
group is.

Inside an SPMD region (:func:`~horovod_tpu_torch.parallel.spmd.spmd_run`)
:func:`rank` and :func:`local_rank` are this rank's index along the
region's axis, and every collective of
:mod:`horovod_tpu_torch.distributed.mpi_ops` runs over the axis's
process group (:func:`current_spmd_axis`).

``init(comm=[...])`` restricts the job to a subset of the world's ranks,
as Horovod's ``horovod_init(ranks, nranks)`` and the JAX package's
``init(comm=)`` do: every rank of the world joins ``dist.new_group(comm)``
(a collective), the new group becomes the job's group
(:func:`job_group`), :func:`size` is ``len(comm)`` and :func:`rank` the
index within ``comm``, and every collective of the port runs over it. A
rank outside ``comm`` raises ``InvalidArgumentError`` after the
collective ``new_group``; it takes no part in the job.
"""

from __future__ import annotations

import contextvars
import os
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.exceptions import (InvalidArgumentError,
                                                 NotInitializedError,
                                                 PreconditionError)
from horovod_tpu_torch.utils.timeline import Timeline


class _State:
    def __init__(self):
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.config: Optional[Config] = None
        self.timeline: Optional[Timeline] = None
        self.owns_group = False
        self.backend: Optional[str] = None
        self.mesh = None
        # The job's process group (None: the world) and its global ranks.
        self.group = None
        self.ranks: List[int] = []
        # HOROVOD_AUTOTUNE's StepAutotuner (distributed/autotune.py).
        self.autotuner = None


_state = _State()


class SpmdAxis(NamedTuple):
    """The axis of an SPMD region: its name, its process group (``None``
    for an axis of one), its size and this rank's index along it."""

    name: str
    group: object
    size: int
    index: int


# The axis of the enclosing SPMD region, set by
# horovod_tpu_torch.parallel.spmd while the region's function runs.
_spmd_axis: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_spmd_axis", default=None)


def current_spmd_axis() -> Optional[SpmdAxis]:
    """The enclosing SPMD region's :class:`SpmdAxis`, or ``None``."""
    return _spmd_axis.get()


def set_spmd_axis(axis: Optional[SpmdAxis]):
    """Enter a region over ``axis``; returns the token that
    :func:`reset_spmd_axis` takes to leave it."""
    return _spmd_axis.set(axis)


def reset_spmd_axis(token) -> None:
    _spmd_axis.reset(token)


def init(comm: Optional[Sequence[int]] = None,
         device: DeviceLike = None) -> None:
    """Initialise the framework on ``device`` (``None`` = the card; raises
    without one). ``comm`` restricts the job to those global ranks, in
    increasing order (the module docstring). Safe to call more than
    once."""
    if _state.initialized:
        return
    if comm is not None:
        comm = [int(r) for r in comm]
        if not comm:
            raise InvalidArgumentError("hvd.init(comm=[]) names no rank")
        if comm != sorted(set(comm)):
            raise InvalidArgumentError(
                f"comm {comm} must list distinct ranks in increasing "
                "order: a torch.distributed group numbers its ranks in "
                "the order of their global ranks")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", 0))
            if not dist.is_initialized() \
                    and local >= torch.cuda.device_count():
                raise PreconditionError(
                    f"LOCAL_RANK {local} has no card of its own (this "
                    f"host has {torch.cuda.device_count()}): NCCL needs "
                    "one card a rank. Ranks that share a card must start "
                    "a gloo group first (dist.init_process_group("
                    "'gloo', ...)) and pass device='cuda:0' to init()")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        # gloo carries CUDA tensors as well; NCCL carries no CPU tensor.
        takes = (backend, "gloo") if dev.type == "cuda" else (backend,)
        if dist.get_backend() not in takes:
            raise PreconditionError(
                f"the process group runs {dist.get_backend()}, but device "
                f"{dev} needs {' or '.join(takes)}")
        backend = dist.get_backend()
        owns = False
    else:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        owns = True
    world = dist.get_world_size()
    group, ranks = None, list(range(world))
    if comm is not None:
        bad = [r for r in comm if not 0 <= r < world]
        if bad:
            if owns:
                dist.destroy_process_group()
            raise InvalidArgumentError(
                f"comm ranks {bad} out of range for {world} ranks")
        if comm != ranks:
            # Collective: every rank of the world creates the group, in
            # this order, whether or not it belongs to it.
            group, ranks = dist.new_group(comm), comm
        if dist.get_rank() not in comm:
            raise InvalidArgumentError(
                f"hvd.init(comm={comm}) does not include this process "
                f"(rank {dist.get_rank()} of {world}): it has no rank in "
                "the job; leave it out at the launcher, or let it exit")
    _state.owns_group = owns
    _state.group = group
    _state.ranks = ranks
    _state.device = dev
    _state.backend = backend
    _state.config = Config.from_env()
    _state.timeline = Timeline(_state.config.timeline_path or None,
                               mark_cycles=_state.config.timeline_mark_cycles,
                               enabled_rank=dist.get_rank(group) == 0)
    _state.initialized = True
    if _state.config.autotune:
        # Every rank runs the tuner, so that generations move in
        # lockstep; rank 0 alone writes the log.
        from horovod_tpu_torch.distributed.autotune import StepAutotuner

        try:
            _state.autotuner = StepAutotuner(
                _state.config,
                log_path=(_state.config.autotune_log
                          if dist.get_rank(group) == 0 else ""))
        except BaseException:
            shutdown()
            raise


def shutdown() -> None:
    """Leave the process group if :func:`init` created it."""
    if not _state.initialized:
        return
    _state.timeline.close()
    if _state.autotuner is not None:
        _state.autotuner.close()
        _state.autotuner = None
    if _state.group is not None and dist.is_initialized():
        dist.destroy_process_group(_state.group)
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.initialized = False
    _state.owns_group = False
    _state.device = None
    _state.backend = None
    _state.config = None
    _state.timeline = None
    _state.mesh = None
    _state.group = None
    _state.ranks = []


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _State:
    if not _state.initialized:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _state


def job_group():
    """The process group the job's collectives run over: ``None`` (the
    default group) for the whole world, else ``init(comm=)``'s group."""
    return _require_init().group


def job_ranks() -> List[int]:
    """The job's global ranks in job order (``comm``, else the world)."""
    return list(_require_init().ranks)


def size() -> int:
    """Number of processes in the job (one card each)."""
    return len(_require_init().ranks)


def local_size() -> int:
    """Number of processes (cards) on this host: ``LOCAL_WORLD_SIZE`` as
    the launcher sets it, else the job's size (the ranks of a world
    started without a launcher share one host)."""
    _require_init()
    return int(os.environ.get("LOCAL_WORLD_SIZE", size()))


def rank() -> int:
    """Rank within the job (the global rank unless ``init(comm=)``
    narrowed it); inside an SPMD region, this rank's index along the
    region's axis."""
    st = _require_init()
    axis = current_spmd_axis()
    if axis is not None:
        return axis.index
    return dist.get_rank(st.group)


def local_rank() -> int:
    """Rank within this host (``LOCAL_RANK``; the job's rank when the
    launcher does not set it). Inside an SPMD region, the index along the
    region's axis modulo :func:`local_size`."""
    st = _require_init()
    axis = current_spmd_axis()
    if axis is not None:
        return axis.index % max(local_size(), 1)
    return int(os.environ.get("LOCAL_RANK", dist.get_rank(st.group)))


def process_rank() -> int:
    """Index of this process in the job: one card a process, so the
    job's rank (outside any region)."""
    return dist.get_rank(_require_init().group)


def process_count() -> int:
    """Number of processes in the job."""
    return size()


def mpi_threads_supported() -> bool:
    """Parity with ``horovod_mpi_threads_supported``: there is no MPI
    here, so always False."""
    _require_init()
    return False


def check_extension(ext_name: str, ext_env_var: str, path=None) -> None:
    """Parity with ``HorovodBasics.check_extension``: raise when the
    binding was disabled through ``ext_env_var`` (nothing here is built
    per binding, so that is the only way to fail)."""
    del path
    if os.environ.get(ext_env_var, "") in ("0", "false", "False"):
        raise ImportError(
            f"Extension {ext_name} has been disabled via {ext_env_var}")


def mesh():
    """The default 1-D mesh over the job's ranks, axis ``"hvd"``
    (:class:`~horovod_tpu_torch.parallel.mesh.Mesh`), made once per
    :func:`init`."""
    st = _require_init()
    if st.mesh is None:
        from horovod_tpu_torch.parallel.logical import DATA_AXIS
        from horovod_tpu_torch.parallel.mesh import make_mesh

        st.mesh = make_mesh({DATA_AXIS: len(st.ranks)}, st.ranks)
    return st.mesh


def device() -> torch.device:
    """The device :func:`init` resolved."""
    return _require_init().device


def backend() -> str:
    """The process group's backend (``"nccl"`` or ``"gloo"``)."""
    return _require_init().backend


def config() -> Config:
    """The knobs read at :func:`init`."""
    return _require_init().config


def timeline() -> Timeline:
    """The timeline :func:`init` opened (``HOROVOD_TIMELINE``; disabled
    when the knob is unset and on every rank but 0)."""
    return _require_init().timeline
