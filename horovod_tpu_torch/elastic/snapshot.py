"""Double-buffered host-RAM train-state snapshots + manifested disk spill:
the port of ``horovod_tpu.elastic.snapshot``.

CheckFreq's observation (Mohan et al., FAST 2021): checkpointing is two
separable costs — getting a consistent copy OUT of the accelerator
(cheap, bounded by the device-to-host rate) and getting it onto durable
storage (slow). So snapshot often, spill rarely:

* every ``every`` steps (window-aligned) the :class:`Snapshotter` starts
  an ASYNC device-to-host copy of the train state into one of two host
  buffers — the *pending* snapshot; the previous pending snapshot is
  committed (its copy waited for) at the NEXT boundary, so the copy
  overlaps the compute between two snapshots;
* on the ``spill_every``-th snapshot the copy is taken synchronously and
  written through a :class:`horovod_tpu_torch.checkpoint.
  CheckpointManager`, together with a **resume manifest** — step, RNG
  state, data-shard cursor, world size — committed by atomic rename, so
  a relaunch restores bit-exactly;
* a preemption (:mod:`horovod_tpu_torch.elastic.signals`) calls
  :meth:`Snapshotter.flush`: one final synchronous snapshot + spill
  inside the SIGTERM grace window.

The manifest files are the reference's, field for field (``sort_keys``
JSON): a manifest directory written by either package reads in the
other.

**The async copy.** A JAX array is immutable, so the JAX snapshot may
read the state's own buffers while the next window runs (the loop
donates nothing). Torch state is not: a windowed step (a CUDA graph
replay) and an in-place optimizer overwrite the state's buffers, and a
functional step's old state is freed and its memory reused by the
caching allocator at once. So a CUDA leaf takes two copies:

1. ``take()`` copies it, device to device, into a staging buffer the
   snapshotter owns, on the current stream — ordered before anything
   the next step writes;
2. a side stream, waiting on the current one, copies the staging buffer
   into a pinned host buffer (``non_blocking=True``) and records an
   event; the commit at the next boundary waits on that event.

Each leaf has one staging buffer and two pinned host buffers, so the
committed :attr:`Snapshotter.latest` stays intact while the next copy
fills the other; all are allocated once per state signature (leaf
shapes, dtypes and devices), never once a snapshot. The host tensors
``latest`` returns are those buffers: they hold their values until the
second snapshot after. The synchronous path (``sync=True``, every spill,
:meth:`Snapshotter.flush`) copies straight into the free pinned buffer
and waits. CPU leaves are cloned at ``take()``.

Cadence math: overhead fraction = snapshot_ms / (every * step_ms); the
reference's budget is <= 2% at the default ``every`` = 100.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

MANIFEST_POINTER = "MANIFEST"          # atomic latest-manifest pointer
_MANIFEST_FMT = "manifest-{step}.json"


@dataclasses.dataclass
class ResumeManifest:
    """Everything beyond the weights needed for a bit-exact resume.

    ``step``: completed training steps at the snapshot — the relaunch
    runs steps ``[step, total)``. ``rng_key``: the loop's random state
    as a list of ints (a ``torch.Generator``'s ``get_state()`` bytes,
    or any integer words; loops that derive per-step randomness from the
    carried ``state["step"]`` need nothing here). ``cursor``: the
    per-rank data-shard position (:mod:`horovod_tpu_torch.data.sharding` is
    deterministic in ``(seed, epoch, rank, size)``, so
    ``{"epoch": e, "offset": o}`` pins every rank's stream). ``rank``
    records the writer; ``world_size`` records the world the shards
    were cut for — a resume into a DIFFERENT world size remaps the
    cursor through :meth:`~horovod_tpu_torch.elastic.loop.ShardedBatchSource.
    resume_step` (the reshard path; docs/elastic.md "Resizing the
    world") instead of rejecting the manifest.
    """

    step: int
    world_size: int = 1
    rank: int = 0
    attempt: int = 0
    cursor: Any = None
    rng_key: Optional[List[int]] = None
    wall_time: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ResumeManifest":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def rng(self, dtype=np.uint32) -> Optional[np.ndarray]:
        if self.rng_key is None:
            return None
        return np.asarray(self.rng_key, dtype=dtype)


def write_manifest(directory: str, manifest: ResumeManifest) -> str:
    """Commit ``manifest`` under ``directory`` with atomic renames.

    Two-phase: the per-step file lands first (tmp + ``os.replace``),
    then the ``MANIFEST`` pointer flips to it — a crash between the two
    leaves the previous pointer intact, never a torn manifest.
    """
    os.makedirs(directory, exist_ok=True)
    name = _MANIFEST_FMT.format(step=int(manifest.step))
    path = os.path.join(directory, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(manifest.to_json() + "\n")
    os.replace(tmp, path)
    pointer = os.path.join(directory, MANIFEST_POINTER)
    tmp = f"{pointer}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(name + "\n")
    os.replace(tmp, pointer)
    return path


def manifest_steps(directory: str) -> List[int]:
    """Steps with a committed manifest file, ascending."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith("manifest-") and n.endswith(".json"):
            try:
                steps.append(int(n[len("manifest-"):-len(".json")]))
            except ValueError:
                continue
    return sorted(steps)


def read_manifest(directory: str, step: int) -> Optional[ResumeManifest]:
    path = os.path.join(directory, _MANIFEST_FMT.format(step=int(step)))
    try:
        with open(path) as f:
            return ResumeManifest.from_json(f.read())
    except (OSError, ValueError):
        return None


def latest_manifest(directory: str) -> Optional[ResumeManifest]:
    """Newest committed manifest (the ``MANIFEST`` pointer; falls back
    to scanning per-step files if the pointer is missing/torn)."""
    pointer = os.path.join(directory, MANIFEST_POINTER)
    try:
        with open(pointer) as f:
            name = f.read().strip()
        with open(os.path.join(directory, name)) as f:
            return ResumeManifest.from_json(f.read())
    except (OSError, ValueError):
        pass
    steps = manifest_steps(directory)
    return read_manifest(directory, steps[-1]) if steps else None


def _freeze_aux(aux: dict) -> dict:
    """``aux`` with ``rng_key`` read now: a ``torch.Generator``'s state
    bytes (or any array's words) as a list of ints, so a later spill of
    this snapshot records the state it had at ``take()``."""
    aux = dict(aux)
    key = aux.get("rng_key")
    if key is not None:
        import torch

        if isinstance(key, torch.Generator):
            key = key.get_state()
        if isinstance(key, torch.Tensor):
            key = key.detach().cpu().numpy()
        aux["rng_key"] = [int(w) for w in np.ravel(np.asarray(key))]
    return aux


class _HostBuffers:
    """The staging and pinned host buffers of one state signature, with
    one side stream per card."""

    def __init__(self, leaves):
        import torch

        self.signature = _signature(leaves)
        self.staging: Dict[int, Any] = {}
        self.pinned: Dict[int, list] = {}
        self.streams: Dict[Any, Any] = {}
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                self.staging[i] = torch.empty_like(
                    leaf, memory_format=torch.contiguous_format)
                self.pinned[i] = [
                    torch.empty(leaf.shape, dtype=leaf.dtype,
                                pin_memory=True) for _ in range(2)]
                if leaf.device not in self.streams:
                    self.streams[leaf.device] = torch.cuda.Stream(
                        leaf.device)
        self.staging_bytes = sum(t.nbytes for t in self.staging.values())
        self.pinned_bytes = sum(t.nbytes for pair in self.pinned.values()
                                for t in pair)


def _signature(leaves) -> tuple:
    import torch

    return tuple((tuple(l.shape), l.dtype, l.device)
                 if isinstance(l, torch.Tensor) else type(l)
                 for l in leaves)


class Snapshotter:
    """Periodic train-state snapshots: async to host RAM, manifested to
    disk on a slower cadence.

    ``manager``: a :class:`horovod_tpu_torch.checkpoint.CheckpointManager`
    (or any object with ``save(step, state)`` / ``directory``); ``None``
    keeps snapshots in RAM only (bench overhead probes). ``every``:
    snapshot cadence in steps (default: ``HOROVOD_SNAPSHOT_EVERY``);
    ``spill_every``: every how-many-th snapshot also spills to disk
    (1 = all). Window loops must keep ``every`` a multiple of
    ``steps_per_dispatch`` — :meth:`check_alignment` enforces it, since
    a snapshot can only be taken where the host holds a consistent
    state, i.e. at window boundaries. The state is a pytree of tensors
    (numpy arrays and numbers are copied as they are), flattened in the
    JAX package's leaf order.

    ``staging_bytes`` and ``pinned_bytes`` report the card and host
    memory the async copy holds for the current state signature.
    """

    def __init__(self, manager=None, every: Optional[int] = None,
                 spill_every: int = 1, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 attempt: Optional[int] = None):
        from horovod_tpu_torch.common.config import DEFAULT_SNAPSHOT_EVERY

        if every is None:
            try:
                every = int(os.environ.get("HOROVOD_SNAPSHOT_EVERY", "")
                            or DEFAULT_SNAPSHOT_EVERY)
            except ValueError:
                every = DEFAULT_SNAPSHOT_EVERY
        if every < 1:
            raise ValueError(f"snapshot cadence must be >= 1, got {every}")
        if spill_every < 1:
            raise ValueError(
                f"spill_every must be >= 1, got {spill_every}")
        if attempt is None:
            attempt = int(os.environ.get("HOROVOD_ELASTIC_RESTART", "0"))
        # Manifests must record the TRUE world shape (the reshard-resume
        # remap runs off it), so default from the launcher environment,
        # not a hardcoded single-rank world.
        if rank is None:
            rank = int(os.environ.get("HOROVOD_RANK", "0"))
        if world_size is None:
            world_size = int(os.environ.get("HOROVOD_SIZE", "1"))
        self.manager = manager
        self.every = int(every)
        self.spill_every = int(spill_every)
        self.rank = rank
        self.world_size = world_size
        self.attempt = attempt
        # Double buffer: _pending holds a snapshot whose copy is in
        # flight; _latest holds the last COMMITTED (host) snapshot.
        self._pending: Optional[Dict[str, Any]] = None
        self._latest: Optional[Dict[str, Any]] = None
        self._buffers: Optional[_HostBuffers] = None
        self._count = 0
        self.stats = {"snapshots": 0, "spills": 0,
                      "last_ms": None, "total_ms": 0.0}

    @property
    def staging_bytes(self) -> int:
        return self._buffers.staging_bytes if self._buffers else 0

    @property
    def pinned_bytes(self) -> int:
        return self._buffers.pinned_bytes if self._buffers else 0

    # ------------------------------------------------------------- cadence

    def check_alignment(self, steps_per_dispatch: int) -> None:
        if self.every % max(1, steps_per_dispatch):
            raise ValueError(
                f"snapshot cadence {self.every} is not a multiple of "
                f"steps_per_dispatch {steps_per_dispatch}: snapshots "
                "align to window boundaries (the host only holds a "
                "consistent state between dispatches) — round the "
                "cadence to a window multiple")

    def due(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def maybe(self, step: int, state, **aux) -> bool:
        """Snapshot iff ``step`` is on the cadence. Returns whether one
        was taken. ``aux`` (``cursor=``, ``rng_key=``) flows into the
        resume manifest on spilling snapshots."""
        if not self.due(step):
            return False
        self.take(step, state, **aux)
        return True

    # ------------------------------------------------------------ snapshot

    def take(self, step: int, state, sync: bool = False, **aux) -> None:
        """Take one snapshot of ``state`` labelled ``step``.

        Async by default: commits the previous pending snapshot, then
        stages the state on the card and starts the host copy without
        blocking on it (module docstring). ``sync=True`` (and every
        spill) completes the copy immediately.
        """
        t0 = time.perf_counter()
        self._commit_pending()
        spill = (self.manager is not None
                 and (self._count + 1) % self.spill_every == 0)
        record = {"step": int(step), "aux": _freeze_aux(aux)}
        if sync or spill:
            record["tree"] = self._to_host(state, sync=True)
            self._latest = record
            self._pending = None
            if spill:
                self._spill(record)
        else:
            record["tree"] = self._to_host(state, sync=False)
            self._pending = record
        self._count += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["snapshots"] += 1
        self.stats["last_ms"] = ms
        self.stats["total_ms"] += ms

    def _free_slot(self) -> int:
        """The pinned slot the committed snapshot does not hold (the
        pending one was committed before any new copy starts)."""
        held = None if self._latest is None \
            else self._latest["tree"].get("slot")
        return 1 if held == 0 else 0

    def _to_host(self, state, sync: bool):
        import torch

        from horovod_tpu_torch._pytree import flatten

        leaves, spec = flatten(state)
        cuda = [i for i, l in enumerate(leaves)
                if isinstance(l, torch.Tensor) and l.is_cuda]
        if cuda and (self._buffers is None
                     or self._buffers.signature != _signature(leaves)):
            self._buffers = _HostBuffers(leaves)
        slot = self._free_slot() if cuda else None
        host = []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                host.append(self._buffers.pinned[i][slot] if leaf.is_cuda
                            else leaf.detach().clone())
            elif isinstance(leaf, np.ndarray):
                host.append(leaf.copy())
            else:
                host.append(leaf)
        events = []
        if cuda and sync:
            for i in cuda:
                host[i].copy_(leaves[i].detach())
        elif cuda:
            bufs = self._buffers
            for i in cuda:
                bufs.staging[i].copy_(leaves[i].detach())
            for dev, side in bufs.streams.items():
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for i in cuda:
                        if leaves[i].device == dev:
                            host[i].copy_(bufs.staging[i],
                                          non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
                events.append(event)
        return {"leaves": host, "spec": spec, "slot": slot,
                "events": events}

    def _commit_pending(self) -> None:
        if self._pending is None:
            return
        for event in self._pending["tree"]["events"]:
            event.synchronize()
        self._pending["tree"]["events"] = []
        self._latest = self._pending
        self._pending = None

    def _spill(self, record) -> None:
        from torch.utils._pytree import tree_unflatten

        state = tree_unflatten(record["tree"]["leaves"],
                               record["tree"]["spec"])
        step = record["step"]
        self.manager.save(step, state)
        aux = record["aux"]
        write_manifest(self.directory, ResumeManifest(
            step=step, world_size=self.world_size, rank=self.rank,
            attempt=self.attempt, cursor=aux.get("cursor"),
            rng_key=aux.get("rng_key"), wall_time=time.time()))
        self.stats["spills"] += 1

    # ------------------------------------------------------------ flush/IO

    @property
    def directory(self) -> Optional[str]:
        return getattr(self.manager, "directory", None)

    @property
    def latest(self):
        """(step, host-state) of the newest COMMITTED in-RAM snapshot,
        or None. Commits any pending transfer first."""
        from torch.utils._pytree import tree_unflatten

        self._commit_pending()
        if self._latest is None:
            return None
        t = self._latest["tree"]
        return (self._latest["step"],
                tree_unflatten(t["leaves"], t["spec"]))

    def flush(self, step: Optional[int] = None, state=None, **aux) -> None:
        """Final synchronous snapshot + spill (preemption epilogue and
        end-of-run). With ``state`` given, snapshots it at ``step`` and
        spills regardless of cadence; otherwise spills the newest in-RAM
        snapshot if it never reached disk. Blocks until the manager
        commits."""
        if state is not None:
            if step is None:
                raise ValueError(
                    "flush(state=...) needs the step label too: "
                    "flush(step, state) — the manifest records which "
                    "training step this final snapshot represents")
            self._commit_pending()
            record = {"step": int(step), "aux": _freeze_aux(aux),
                      "tree": self._to_host(state, sync=True)}
            self._latest = record
            self._pending = None
            self._count += 1
            self.stats["snapshots"] += 1
            if self.manager is not None:
                self._spill(record)
        else:
            self._commit_pending()
            if self._latest is not None and self.manager is not None:
                steps = getattr(self.manager, "all_steps", lambda: [])()
                if self._latest["step"] not in steps:
                    self._spill(self._latest)
        if self.manager is not None:
            self.manager.wait_until_finished()

    def restore(self, template):
        """(state, manifest) from the newest committed manifest whose
        checkpoint exists, or None when there is nothing to resume.
        Walks older manifests if the newest points at a torn/missing
        checkpoint (crash between spill phases)."""
        if self.manager is None or self.directory is None:
            return None
        available = set(self.manager.all_steps())
        newest = latest_manifest(self.directory)
        candidates = []
        if newest is not None:
            candidates.append(newest)
        for step in reversed(manifest_steps(self.directory)):
            if newest is None or step != newest.step:
                m = read_manifest(self.directory, step)
                if m is not None:
                    candidates.append(m)
        for manifest in candidates:
            if manifest.step in available:
                state = self.manager.restore(manifest.step,
                                             template=template)
                return state, manifest
        return None


__all__ = ["ResumeManifest", "Snapshotter", "write_manifest",
           "read_manifest", "latest_manifest", "manifest_steps",
           "MANIFEST_POINTER"]
