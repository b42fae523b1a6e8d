"""Lifecycle and topology over ``torch.distributed``: the subset of
``horovod_tpu.common.basics`` that training uses.

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
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.exceptions import PreconditionError
from horovod_tpu_torch.utils.timeline import Timeline


class _State:
    def __init__(self):
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.config: Optional[Config] = None
        self.timeline: Optional[Timeline] = None
        self.owns_group = False
        self.backend: Optional[str] = None


_state = _State()


def init(device: DeviceLike = None) -> None:
    """Initialise the framework on ``device`` (``None`` = the card; raises
    without one). Safe to call more than once."""
    if _state.initialized:
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        # gloo carries CUDA tensors as well; NCCL carries no CPU tensor.
        takes = (backend, "gloo") if dev.type == "cuda" else (backend,)
        if dist.get_backend() not in takes:
            raise PreconditionError(
                f"the process group runs {dist.get_backend()}, but device "
                f"{dev} needs {' or '.join(takes)}")
        backend = dist.get_backend()
        _state.owns_group = False
    else:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        _state.owns_group = True
    _state.device = dev
    _state.backend = backend
    _state.config = Config.from_env()
    _state.timeline = Timeline(_state.config.timeline_path or None,
                               mark_cycles=_state.config.timeline_mark_cycles,
                               enabled_rank=dist.get_rank() == 0)
    _state.initialized = True


def shutdown() -> None:
    """Leave the process group if :func:`init` created it."""
    if not _state.initialized:
        return
    _state.timeline.close()
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.initialized = False
    _state.owns_group = False
    _state.device = None
    _state.backend = None
    _state.config = None
    _state.timeline = None


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _State:
    if not _state.initialized:
        raise PreconditionError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _state


def size() -> int:
    """Number of processes (one card each)."""
    _require_init()
    return dist.get_world_size()


def rank() -> int:
    _require_init()
    return dist.get_rank()


def local_rank() -> int:
    """Rank within this host (``LOCAL_RANK``; the global rank when the
    launcher does not set it)."""
    _require_init()
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


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
