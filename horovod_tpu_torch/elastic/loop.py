"""The elastic training loop: resume, snapshot, inject, survive — the
port of ``horovod_tpu.elastic.loop``.

:func:`run_elastic` wraps any ``(state, batch) -> (state, metrics)``
step function, ``state`` a pytree of tensors, with the full
preemption-tolerance stack:

* **resume** — restore the newest manifested snapshot from the
  :class:`~horovod_tpu_torch.checkpoint.CheckpointManager` before the
  first step (bit-exact: weights + optimizer state + step counter come
  back as written; the data stream re-derives from the step because
  :mod:`horovod_tpu_torch.data.sharding` is deterministic in
  ``(seed, epoch, rank, size)``);
* **snapshot** — a :class:`~horovod_tpu_torch.elastic.snapshot.
  Snapshotter` on a window-aligned cadence (async device-to-host copy
  through a staging buffer, disk spill + manifest on the slower
  ``spill_every`` cadence);
* **preemption** — a deferred SIGTERM flag checked at every window
  boundary; on trigger: drain, final sync snapshot, exit
  ``EXIT_PREEMPTED`` (:mod:`horovod_tpu_torch.elastic.signals`);
* **fault injection** — ``HOROVOD_FAULT_PLAN`` actions fire at their
  step boundaries (:mod:`horovod_tpu_torch.elastic.faults`);
* **resizing** — a manifest written at a different world size resumes
  through the watermark remap (:meth:`ShardedBatchSource.resume_step`)
  with an ``on_resize`` rescale hook;
* **liveness** — a per-rank heartbeat touched at every boundary feeds
  the supervisor's health watchdog.

Windows: ``steps_per_dispatch=K`` runs K steps a window on
:func:`horovod_tpu_torch.distributed.window.windowed`, which replays ONE
captured in-place step ``step(batch) -> metrics`` on the card (eagerly on
the CPU), where the JAX loop scans the functional step. The loop bridges
the two: it copies the (restored) state once into buffers it owns, and
the window's step is ``new, m = step_fn(buffers, batch)`` followed by
``torch._foreach_copy_`` of ``new`` into the buffers. Boundaries —
snapshot points, preemption checks, injection points — then fall every
K steps. A step whose collectives run over gloo cannot be captured: the
window raises its own error there (no fallback to eager).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.elastic.faults import FaultInjector
from horovod_tpu_torch.elastic.signals import (Heartbeat, PreemptionHandler,
                                               drain)
from horovod_tpu_torch.elastic.snapshot import Snapshotter


class ShardedBatchSource:
    """Deterministic, cursor-addressable per-rank batch stream.

    Wraps :func:`horovod_tpu_torch.data.sharding.shard_indices` so that the
    batch for global step ``s`` is a pure function of
    ``(seed, rank, size, s)`` — which is what makes the resume manifest
    one integer instead of an iterator pickle. ``cursor(step)`` reports
    the classic ``{"epoch": e, "offset": o}`` per-rank shard position
    for the manifest.

    **The coverage contract.** Within an epoch, rank ``r``'s step ``s``
    batch occupies positions ``{r + size*(o + j) : j < B}`` of the
    seeded epoch permutation (``o`` = per-rank offset, ``B`` =
    ``batch_size``) — so the union over ranks of one global step is the
    CONTIGUOUS permutation block ``[size*o, size*(o + B))``, and the
    global stream is a prefix of the permutation consumed ``size*B``
    samples per step regardless of how it is cut into ranks. That is
    what makes world resizing well-defined: a resume at a different
    world size continues the same prefix from the same watermark
    (:meth:`resume_step`), dropping nothing and repeating nothing.
    """

    def __init__(self, arrays: dict, batch_size: int,
                 rank: Optional[int] = None, size: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0):
        from horovod_tpu_torch.data.sharding import _resolve

        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"array lengths differ: {lengths}")
        self.arrays = arrays
        self.n = next(iter(lengths.values()))
        self.batch_size = int(batch_size)
        self.rank, self.size = _resolve(rank, size)
        self.shuffle = shuffle
        self.seed = seed
        self.steps_per_epoch = self._steps_per_epoch(self.size)

    def _steps_per_epoch(self, size: int) -> int:
        per_rank = -(-self.n // size)  # ceil: padded shard length
        return max(1, per_rank // self.batch_size)

    @property
    def global_batch_size(self) -> int:
        """Samples the whole world consumes per step (``size * B``)."""
        return self.size * self.batch_size

    def cursor(self, step: int) -> dict:
        return {"epoch": step // self.steps_per_epoch,
                "offset": (step % self.steps_per_epoch) * self.batch_size,
                "rank": self.rank, "size": self.size}

    def indices_at(self, step: int) -> np.ndarray:
        """The dataset indices this rank's ``step`` batch selects."""
        from horovod_tpu_torch.data.sharding import shard_indices

        cur = self.cursor(step)
        idx = shard_indices(self.n, cur["epoch"], self.rank, self.size,
                            self.shuffle, self.seed)
        return idx[cur["offset"]:cur["offset"] + self.batch_size]

    def batch_at(self, step: int) -> dict:
        """This rank's ``step`` batch: each array's rows at
        :meth:`indices_at`, as host tensors (numpy arrays are converted;
        tensors stay on their device)."""
        import torch

        sel = self.indices_at(step)
        out = {}
        for k, v in self.arrays.items():
            if isinstance(v, torch.Tensor):
                out[k] = v[torch.as_tensor(sel, device=v.device)]
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(v[sel]))
        return out

    __call__ = batch_at

    # --------------------------------------------------- resize support

    def consumed_samples(self, step: int) -> int:
        """Global-stream watermark: samples the WORLD has consumed after
        ``step`` completed steps (``step * size * B`` — each epoch
        consumes ``steps_per_epoch`` such blocks). Invariant under
        resizing: :meth:`resume_step` maps a manifest written at another
        world size to the step with the identical watermark."""
        return step * self.global_batch_size

    def global_positions(self, step: int) -> np.ndarray:
        """Absolute global-stream positions this rank's ``step`` batch
        consumes: ``epoch_base + r + size*(o + j)``. The union over
        ranks of one step is a contiguous watermark interval — the
        resize e2e tests assert exactly-once coverage over these."""
        cur = self.cursor(step)
        epoch_base = cur["epoch"] * self.steps_per_epoch \
            * self.global_batch_size
        off = cur["offset"]
        return (epoch_base + self.rank
                + self.size * (off + np.arange(self.batch_size)))

    def resume_step(self, manifest_or_cursor) -> int:
        """Map a cursor written at ANOTHER world size onto this source's
        step counter — the reshard-resume remap.

        The mapping preserves the global-stream watermark: the old
        world consumed ``g = offset * size_old`` samples into epoch
        ``e``; the new world resumes at the step whose watermark is the
        same point. Exactness requires the watermark to sit on a
        new-world global-batch boundary (``size_new * B`` must divide
        ``g``): snapshots land on multiples of the cadence, so choosing
        ``snapshot_every`` such that ``size_new | cadence * size_old``
        (e.g. any cadence for a 2→1 shrink; an even cadence for a 2→4
        grow) makes every snapshot a legal resize point. Off-boundary
        manifests raise rather than silently dropping or repeating the
        fractional batch — the no-drop/no-duplicate contract is strict.
        """
        cur = getattr(manifest_or_cursor, "cursor", manifest_or_cursor)
        if not isinstance(cur, dict) or "offset" not in cur:
            raise ValueError(
                "resume_step needs the manifest's {epoch, offset, size} "
                f"cursor (got {cur!r}); write manifests through a "
                "ShardedBatchSource cursor_fn so resized resumes can "
                "remap the data stream")
        epoch, offset = int(cur["epoch"]), int(cur["offset"])
        old_size = int(cur["size"])
        B = self.batch_size
        g = offset * old_size                  # within-epoch watermark
        if g % self.global_batch_size:
            raise ValueError(
                f"cannot reshard-resume: the manifest's within-epoch "
                f"watermark ({g} samples = offset {offset} x world "
                f"{old_size}) is not a multiple of the new global batch "
                f"({self.size} x {B} = {self.global_batch_size}); "
                "resizing only at snapshot steps where "
                "new_world*batch divides consumed samples keeps the "
                "stream exactly-once (docs/elastic.md)")
        step_in_epoch = g // self.global_batch_size
        # Any cursor past epoch 0 (or landing exactly on an epoch
        # boundary) relies on whole past epochs lining up between the
        # two worlds — if per-epoch sample counts differ, the epochs
        # before this one consumed different prefixes and NO within-
        # epoch offset can make the streams agree.
        epochs_must_match = (epoch > 0
                             or step_in_epoch == self.steps_per_epoch)
        if step_in_epoch > self.steps_per_epoch or (
                epochs_must_match
                and self._epoch_samples(old_size)
                != self._epoch_samples(self.size)):
            raise ValueError(
                f"cannot reshard-resume: epoch {epoch} consumed {g} "
                f"samples at world {old_size} but holds only "
                f"{self._epoch_samples(self.size)} at world {self.size} "
                f"({self.steps_per_epoch} steps x "
                f"{self.global_batch_size}); pad the dataset to a "
                "multiple of lcm(world sizes) x batch so epochs consume "
                "the same sample count at every size (docs/elastic.md)")
        if step_in_epoch == self.steps_per_epoch:
            epoch, step_in_epoch = epoch + 1, 0
        return epoch * self.steps_per_epoch + step_in_epoch

    def _epoch_samples(self, size: int) -> int:
        return self._steps_per_epoch(size) * size * self.batch_size


def _source_of(batch_for_step) -> Optional[ShardedBatchSource]:
    """Recover the ShardedBatchSource behind ``batch_for_step`` when the
    caller passed the source itself or its bound ``batch_at`` — the
    default provider of manifest cursors and the resize remap."""
    if isinstance(batch_for_step, ShardedBatchSource):
        return batch_for_step
    owner = getattr(batch_for_step, "__self__", None)
    return owner if isinstance(owner, ShardedBatchSource) else None


def _source_of(batch_for_step) -> Optional[ShardedBatchSource]:
    """Recover the ShardedBatchSource behind ``batch_for_step`` when the
    caller passed the source itself or its bound ``batch_at`` — the
    default provider of manifest cursors and the resize remap."""
    if isinstance(batch_for_step, ShardedBatchSource):
        return batch_for_step
    owner = getattr(batch_for_step, "__self__", None)
    return owner if isinstance(owner, ShardedBatchSource) else None


def _restore_rng(rng_key, words):
    """``rng_key`` set to the manifest's ``words``: a ``torch.Generator``
    in place (its state bytes), a tensor or array as a new one of the
    same dtype."""
    import torch

    if isinstance(rng_key, torch.Generator):
        rng_key.set_state(torch.tensor(words, dtype=torch.uint8))
        return rng_key
    if isinstance(rng_key, torch.Tensor):
        return torch.tensor(words, dtype=rng_key.dtype,
                            device=rng_key.device)
    return np.asarray(words, dtype=np.asarray(rng_key).dtype)


def _in_place_window(step_fn, state, k: int):
    """``(buffers, window_fn)``: the state copied once into buffers the
    loop owns, and ``window_fn(stacked) -> metric means`` running ``k``
    steps of ``step_fn`` over them in place (module docstring)."""
    import torch
    from torch.utils._pytree import tree_unflatten

    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.distributed.window import windowed

    leaves, spec = flatten(state)
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        raise ValueError(
            "steps_per_dispatch > 1 needs a state whose leaves are all "
            "tensors: the window updates them in place")
    owned = [x.detach().clone() for x in leaves]
    buffers = tree_unflatten(owned, spec)

    def step(batch):
        new, metrics = step_fn(buffers, batch)
        new_leaves, new_spec = flatten(new)
        if new_spec != spec:
            raise ValueError(
                "step_fn returned a state of another structure than it "
                f"was given ({new_spec} vs {spec})")
        torch._foreach_copy_(owned, [x.detach() for x in new_leaves])
        return metrics

    return buffers, windowed(step, k)


def _window_device(state):
    """Where a window's stacked batch goes: the first card a state leaf
    lives on, else the CPU."""
    import torch
    from torch.utils._pytree import tree_leaves

    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return torch.device("cpu")


def run_elastic(
    step_fn: Callable,
    state: Any,
    batch_for_step: Callable[[int], Any],
    num_steps: int,
    *,
    manager=None,
    snapshot_every: Optional[int] = None,
    spill_every: int = 1,
    steps_per_dispatch: int = 1,
    rng_key=None,
    snapshotter: Optional[Snapshotter] = None,
    injector: Optional[FaultInjector] = None,
    preemption: Optional[PreemptionHandler] = None,
    cursor_fn: Optional[Callable[[int], Any]] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
    final_snapshot: bool = True,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    resume_manager=None,
    remap_step: Optional[Callable[[Any], int]] = None,
    on_resize: Optional[Callable[[int, int, Any], Any]] = None,
    heartbeat: Optional[Heartbeat] = None,
) -> Tuple[Any, List[Tuple[int, Any]], int]:
    """Run ``num_steps`` of ``step_fn`` with snapshots and auto-resume.

    ``batch_for_step(step) -> batch`` must be deterministic in the step
    (use :class:`ShardedBatchSource` for real datasets) — that, plus
    the restored state, is the whole bit-exactness argument: replayed
    steps see identical inputs and identical carried state, so the loss
    trajectory after a kill/restore is the fault-free trajectory.

    Returns ``(state, metrics, resumed_from)`` where ``metrics`` is a
    list of ``(completed_steps, window_metrics)`` for the windows this
    invocation actually ran, and ``resumed_from`` the snapshot step the
    run restored (0 = fresh start). ``on_step`` is called with the same
    pair after each window (streaming logs that survive a kill). With
    ``steps_per_dispatch`` K > 1 the window metrics are the means over
    the window, and the returned state is the loop's own buffers.

    ``rng_key`` (a ``torch.Generator``, or integer words) is recorded in
    every manifest and restored from it: a generator's state in place.

    **Resizing.** A manifest written at a different world size is a
    first-class resume, not an error: ``resume_manager`` names the
    authority checkpoint directory every rank restores from (rank 0's —
    new ranks of a grown world have no history of their own);
    ``remap_step`` maps the manifest onto this world's step counter
    (defaults to the batch source's :meth:`ShardedBatchSource.
    resume_step` watermark remap); ``on_resize(old_world, new_world,
    state) -> state`` is the per-world-change hook (rescale the learning
    rate / effective batch there).

    ``world_size``/``rank`` default from ``HOROVOD_SIZE``/
    ``HOROVOD_RANK`` and stamp the manifests this loop writes.
    ``heartbeat`` (default: from ``HOROVOD_HEARTBEAT_DIR`` when the
    elastic supervisor set it) is touched at every window boundary so
    the supervisor's health watchdog can tell a slow window from a
    silent stall.
    """
    import os as _os

    from horovod_tpu_torch.distributed.window import stack_batches

    if world_size is None:
        world_size = int(_os.environ.get("HOROVOD_SIZE", "1"))
    if rank is None:
        rank = int(_os.environ.get("HOROVOD_RANK", "0"))
    k = max(1, int(steps_per_dispatch))
    if num_steps % k:
        raise ValueError(
            f"num_steps {num_steps} must be a multiple of "
            f"steps_per_dispatch {k}")
    if snapshotter is None:
        snapshotter = Snapshotter(manager, every=snapshot_every,
                                  spill_every=spill_every, rank=rank,
                                  world_size=world_size)
    snapshotter.check_alignment(k)
    if injector is None:
        injector = FaultInjector.from_env()
    own_handler = preemption is None
    if own_handler:
        preemption = PreemptionHandler()
    if heartbeat is None:
        heartbeat = Heartbeat.from_env()
    source = _source_of(batch_for_step)
    if cursor_fn is None:
        cursor_fn = (source.cursor if source is not None
                     else getattr(batch_for_step, "cursor", lambda s: s))
    if remap_step is None and source is not None:
        remap_step = source.resume_step

    # ---- resume -----------------------------------------------------
    # Gate on the SNAPSHOTTER's manager: a caller passing a pre-built
    # Snapshotter(manager=...) must resume too, not just spill. With
    # resume_manager given, restore goes through THAT directory — the
    # world's authority snapshot — while spills keep landing in this
    # rank's own manager.
    resumed_from = 0
    restore_snap = snapshotter
    if resume_manager is not None:
        restore_snap = Snapshotter(resume_manager, every=snapshotter.every,
                                   spill_every=snapshotter.spill_every,
                                   rank=rank, world_size=world_size)
    restored = restore_snap.restore(state)
    if restored is not None:
        state, manifest = restored
        if manifest.world_size != world_size:
            if remap_step is None:
                raise ValueError(
                    f"manifest was written at world size "
                    f"{manifest.world_size} but this run has "
                    f"{world_size} ranks; a reshard resume needs a "
                    "remap_step (use a ShardedBatchSource — its "
                    "resume_step remaps the data cursor — or pass "
                    "remap_step= explicitly; docs/elastic.md "
                    "\"Resizing the world\")")
            resumed_from = int(remap_step(manifest))
            print(f"[hvd elastic] reshard resume: manifest step "
                  f"{manifest.step} @ world {manifest.world_size} -> "
                  f"step {resumed_from} @ world {world_size}",
                  file=sys.stderr, flush=True)
            if on_resize is not None:
                resized = on_resize(manifest.world_size, world_size,
                                    state)
                if resized is not None:
                    state = resized
        else:
            resumed_from = manifest.step
        if manifest.rng_key is not None and rng_key is not None:
            rng_key = _restore_rng(rng_key, manifest.rng_key)
        if resumed_from % k:
            raise ValueError(
                f"resume step {resumed_from} is not a window "
                f"boundary for steps_per_dispatch {k} — the manifest "
                "was written by a loop with a different window size "
                "(or a resize remap landed off-window); rerun with a "
                "compatible steps_per_dispatch")

    if k == 1:
        window_fn = step_fn
    else:
        state, window = _in_place_window(step_fn, state, k)
        device = _window_device(state)

        def window_fn(buffers, stacked):
            return buffers, window(stacked)

    def _aux(step):
        aux = {"cursor": cursor_fn(step)}
        if rng_key is not None:
            aux["rng_key"] = rng_key
        return aux

    metrics_out: List[Tuple[int, Any]] = []
    step = resumed_from
    # NOTE: deliberately no heartbeat touch before the first window —
    # on the card the first window includes the warm-up and the capture,
    # which can dwarf any sane watchdog timeout; a rank becomes
    # *watched* only once its first window completes, so capturing is
    # never mistaken for stalling.
    try:
        while step < num_steps:
            injector.maybe_inject(step, preemption=preemption)
            if preemption.check():
                preemption.finalize(snapshotter, step, state,
                                    **_aux(step))
            if k == 1:
                batch = batch_for_step(step)
            else:
                batch = stack_batches(
                    [batch_for_step(s) for s in range(step, step + k)])
                batch = _to_device(batch, device)
            state, metrics = window_fn(state, batch)
            step += k
            snapshotter.maybe(step, state, **_aux(step))
            metrics_out.append((step, metrics))
            if heartbeat is not None:
                heartbeat.touch(step)
            if on_step is not None:
                on_step(step, metrics)
        # One final boundary: a preemption that arrived during the last
        # window still exits preempted, and the finished run leaves a
        # complete manifest behind so re-invocation is a no-op resume.
        injector.maybe_inject(step, preemption=preemption)
        if preemption.check():
            preemption.finalize(snapshotter, step, state, **_aux(step))
        if final_snapshot and snapshotter.manager is not None:
            drain(state)
            snapshotter.flush(step, state, **_aux(step))
    finally:
        # A handler this loop installed must not outlive it (finalize's
        # exit path uninstalls on its own before exiting).
        if own_handler:
            preemption.uninstall()
    return state, metrics_out, resumed_from


def _to_device(batch, device):
    import torch
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.to(device, non_blocking=True)
                    if isinstance(x, torch.Tensor) else x, batch)


__all__ = ["ShardedBatchSource", "run_elastic"]
