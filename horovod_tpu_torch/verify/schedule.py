"""The collective-schedule recorder: what the port's programs issue.

The JAX package's verifier (``tools/hvdverify``) traces a program to a
jaxpr and walks it. The port runs eagerly and has no program to trace,
so its verifier records instead: :class:`Recorder` is a
``TorchDispatchMode`` that sees every collective issued through
``torch.distributed`` as an op of the ``c10d`` namespace
(``c10d.allreduce_``, ``c10d.broadcast_``, ``c10d._allgather_base_``,
...) and turns each into a :class:`CollectiveOp`: its kind, its group
(the global ranks and, where the context names the group, an axis), the
shapes and dtypes of what it sends, its root, its issue order, its
payload bytes and the first frame outside ``torch`` that issued it.

An op is named by the first of: the enclosing SPMD region's axis
(``parallel.spmd``), an axis of the bound
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh` whose ranks
through this rank are the group's, the hierarchical ladder's inner and
outer groups (``ici`` and ``dcn``, ``parallel/mesh.py::ladder_groups``),
and the job's group (the data axis ``hvd``). A group none of them names
has ``axis=None`` (HVV102).

:func:`simulate` runs a program once per rank of a simulated world,
each rank in a fresh process group of torch's ``fake`` backend, whose
collectives move nothing. So that control flow which reads a broadcast
(a serving follower's header, an object broadcast's size) follows the
root as it would in a real world, the recorder of a simulation replays
each broadcast: ranks run in order, the root's payload is kept, and a
later rank's matching broadcast on the same group receives it.

The recorder counts what runs: a collective that a world of one skips
(``mpi_ops.allreduce`` at size one returns its input) is not there, and
ops issued while a CUDA graph is being captured (recorded for replay,
not run) are left out. Every op sees the dispatcher on the thread that
issues it, autograd's device threads included (they run under the
caller's dispatch modes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: c10d op name -> the kind it records as.
KINDS: Dict[str, str] = {
    "allreduce_": "allreduce",
    "allreduce_coalesced_": "allreduce",
    "broadcast_": "broadcast",
    "allgather_": "allgather",
    "_allgather_base_": "allgather",
    "allgather_coalesced_": "allgather",
    "allgather_into_tensor_coalesced_": "allgather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "alltoall",
    "alltoall_base_": "alltoall",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
    "send": "send",
    "recv_": "recv",
    "recv_any_source_": "recv",
    "barrier": "barrier",
    "monitored_barrier_": "barrier",
}

#: The schema argument that holds what an op sends, by preference.
_INPUT_ARGS = ("input_tensor", "input", "input_tensors", "inputs",
               "input_list", "tensors")
#: The schema arguments that name a root or a peer (group ranks).
_ROOT_ARGS = ("root_rank", "dst", "src")

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_THIS = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_THIS)))
_STACK_DEPTH = 12


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective a rank issued."""

    kind: str                          # "allreduce", "broadcast", ...
    op: str                            # the c10d op, e.g. "allreduce_"
    ranks: Tuple[int, ...]             # the group's global ranks
    axis: Optional[str]                # the axis naming the group
    shapes: Tuple[Tuple[int, ...], ...]  # what it sends, tensor by tensor
    dtypes: Tuple[str, ...]
    payload_bytes: int                 # bytes sent (one execution)
    index: int                         # issue order on this rank
    rank: int                          # the issuing rank (global)
    root: Optional[int] = None         # global root / peer, where given
    params: Tuple = ()                 # split sizes and the like
    source: str = ""                   # first frame outside torch
    stack: Tuple[str, ...] = ()        # frames outside torch, innermost
                                       # first, as "path:function"

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.shapes[0] if self.shapes else ()

    @property
    def dtype(self) -> str:
        return self.dtypes[0] if self.dtypes else ""

    def signature(self) -> tuple:
        """What ranks issuing the same position must agree on (HVV103):
        kind, group, shapes, dtypes and root. An all-to-all's split sizes
        differ by rank by design; they must pair instead
        (:func:`~horovod_tpu_torch.verify.rules.check_ranks`)."""
        return (self.kind, self.ranks, self.shapes, self.dtypes, self.root)

    def describe(self) -> str:
        where = self.axis if self.axis is not None else \
            "ranks " + ",".join(map(str, self.ranks))
        shapes = ",".join(str(list(s)) for s in self.shapes)
        root = f" root {self.root}" if self.root is not None else ""
        return (f"#{self.index} {self.kind}[{where}] {self.dtype}{shapes}"
                f" ({self.payload_bytes} B){root} @ {self.source}")


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _flat_tensors(item)]
    return []


def _frames() -> Tuple[str, Tuple[str, ...]]:
    """``(source, stack)`` of the calling Python frames outside torch and
    outside this module: the first as ``path:line function``, up to
    :data:`_STACK_DEPTH` of them as ``path:function``."""
    stack: List[str] = []
    source = ""
    f = sys._getframe(2)
    while f is not None and len(stack) < _STACK_DEPTH:
        path = os.path.abspath(f.f_code.co_filename)
        if not path.startswith(_TORCH_DIR) and path != _THIS \
                and "contextlib" not in path:
            rel = (os.path.relpath(path, _REPO)
                   if path.startswith(_REPO + os.sep) else path)
            if not source:
                source = f"{rel}:{f.f_lineno} {f.f_code.co_name}"
            stack.append(f"{rel}:{f.f_code.co_name}")
        f = f.f_back
    return source, tuple(stack)


def _grid_groups(grid: np.ndarray, names: Sequence[str],
                 rank: int) -> Dict[Tuple[int, ...], str]:
    """``{ranks: axis}`` of each axis of a rank grid through ``rank``."""
    where = np.argwhere(grid == rank)
    if not len(where):
        return {}
    coord = tuple(where[0])
    out = {}
    for i, name in enumerate(names):
        idx = list(coord)
        idx[i] = slice(None)
        out.setdefault(tuple(int(r) for r in grid[tuple(idx)].reshape(-1)),
                       name)
    return out


def group_names(rank: int) -> List[Tuple[Tuple[int, ...], str]]:
    """The ``(ranks, axis)`` pairs the current context names, in
    precedence order (the module docstring)."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel import mesh as _mesh
    from horovod_tpu_torch.parallel.logical import (DATA_AXIS, DCN_AXIS,
                                                    ICI_AXIS,
                                                    current_logical_mesh)

    out: List[Tuple[Tuple[int, ...], str]] = []
    region = basics.current_spmd_axis()
    if region is not None and region.group is not None:
        out.append((tuple(dist.get_process_group_ranks(region.group)),
                    region.name))
    lm = current_logical_mesh()
    if lm is not None:
        out.extend(_grid_groups(np.asarray(lm.ranks), lm.axis_names,
                                rank).items())
    world = (dist.distributed_c10d._get_default_group()
             if dist.is_initialized() else None)
    for key, (ig, og) in list(_mesh._GROUPS.items()):
        if key[0] is world:
            out.append((tuple(dist.get_process_group_ranks(ig)), ICI_AXIS))
            out.append((tuple(dist.get_process_group_ranks(og)), DCN_AXIS))
    if basics.is_initialized():
        out.append((tuple(basics.job_ranks()), DATA_AXIS))
    return out


class Recorder(TorchDispatchMode):
    """Records every ``c10d`` collective into :attr:`schedule` while
    :attr:`recording` is on; with ``replay`` (a dict shared by the ranks
    of a :func:`simulate` call) it also carries broadcast payloads from
    the root to the ranks that run after it. A failure of the recorder's
    own bookkeeping never stops the op: it is kept in :attr:`error`."""

    def __init__(self, replay: Optional[dict] = None,
                 recording: bool = True):
        super().__init__()
        self.schedule: List[CollectiveOp] = []
        self.recording = recording
        self.replay = replay
        self.error: Optional[str] = None
        self._seq: Dict[Tuple[int, ...], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            try:
                self._note(func, args, kwargs)
            except Exception as e:   # the op ran; report, do not raise
                if self.error is None:
                    self.error = f"{type(e).__name__}: {e}"
        return out

    def _note(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        kind = KINDS.get(name)
        if kind is None:
            return
        bound = {a.name: (args[i] if i < len(args) else
                          kwargs.get(a.name, a.default_value))
                 for i, a in enumerate(func._schema.arguments)}
        pg = torch._C._distributed_c10d.ProcessGroup.unbox(
            bound["process_group"])
        ranks = tuple(dist.get_process_group_ranks(pg))
        if kind == "broadcast" and self.replay is not None:
            self._replay(ranks, pg, bound)
        if not self.recording or (torch.cuda.is_available() and
                                  torch.cuda.is_current_stream_capturing()):
            return
        sent = next((_flat_tensors(bound[a]) for a in _INPUT_ARGS
                     if a in bound), [])
        root = next((bound[a] for a in _ROOT_ARGS if a in bound), None)
        if root is not None:
            root = dist.get_global_rank(pg, int(root))
        params = tuple(tuple(bound[a]) for a in ("output_split_sizes",
                                                 "input_split_sizes")
                       if bound.get(a))
        me = dist.get_rank()
        axis = next((n for r, n in group_names(me) if r == ranks), None)
        source, stack = _frames()
        self.schedule.append(CollectiveOp(
            kind=kind, op=name, ranks=ranks, axis=axis,
            shapes=tuple(tuple(t.shape) for t in sent),
            dtypes=tuple(str(t.dtype).rpartition(".")[2] for t in sent),
            payload_bytes=int(sum(t.numel() * t.element_size()
                                  for t in sent)),
            index=len(self.schedule), rank=me, root=root, params=params,
            source=source, stack=stack))

    def _replay(self, ranks, pg, bound) -> None:
        n = self._seq.get(ranks, 0)
        self._seq[ranks] = n + 1
        key = (ranks, n)
        tensors = _flat_tensors(bound["tensors"])
        root = dist.get_global_rank(pg, int(bound["root_rank"]))
        if dist.get_rank() == root:
            self.replay[key] = [t.detach().clone() for t in tensors]
            return
        kept = self.replay.get(key)
        if kept is not None and [tuple(k.shape) for k in kept] == \
                [tuple(t.shape) for t in tensors]:
            with torch.no_grad():
                for t, k in zip(tensors, kept):
                    t.copy_(k)


@contextlib.contextmanager
def record():
    """``with record() as rec:`` records what the block issues into
    ``rec.schedule`` (:class:`Recorder`)."""
    rec = Recorder()
    with rec:
        yield rec


def summarize(schedule: Sequence[CollectiveOp]) -> Dict[str, Any]:
    """Audit numbers of one schedule: collective count, payload bytes,
    the bytes in MiB to two decimals and the count by kind (the JAX
    verifier's ``summarize``; ``bench.py`` stamps it as
    ``"collectives"``)."""
    by_kind: Dict[str, int] = {}
    total = 0
    for op in schedule:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + 1
        total += op.payload_bytes
    return {"count": len(schedule), "bytes": int(total),
            "mb": round(total / (1024 * 1024), 2),
            "by_kind": dict(sorted(by_kind.items()))}


def fake_store():
    """A store for torch's ``fake`` process-group backend. Its import
    path is private to torch; this is the one place that names it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def simulate(build: Callable[[], Callable[[], Any]],
             world: int) -> List[List[CollectiveOp]]:
    """Run a program once per rank ``r`` of a simulated ``world``: a
    fresh ``init_process_group("fake", rank=r)`` and ``hvd.init(device=
    "cpu")``; ``build()`` sets the program up (its collectives are not
    recorded) and returns a zero-argument callable, which runs once
    under the recorder; then ``hvd.shutdown()`` and
    ``destroy_process_group()``. Ranks run in order, so each broadcast's
    root runs before the ranks that receive it (the module docstring).
    Returns each rank's schedule. Raises when a process group is already
    initialised in this process."""
    from horovod_tpu_torch.common import basics

    if dist.is_initialized() or basics.is_initialized():
        raise RuntimeError(
            "simulate needs a process without a process group: each "
            "simulated rank makes its own fake world")
    replay: dict = {}
    schedules = []
    for r in range(world):
        dist.init_process_group("fake", store=fake_store(), rank=r,
                                world_size=world)
        try:
            basics.init(device="cpu")
            rec = Recorder(replay=replay, recording=False)
            with rec:
                fn = build()
                rec.recording = True
                fn()
                rec.recording = False
            if rec.error is not None:
                raise RuntimeError(f"the recorder failed on rank {r}: "
                                   f"{rec.error}")
            schedules.append(rec.schedule)
        finally:
            basics.shutdown()
            if dist.is_initialized():
                dist.destroy_process_group()
    return schedules
