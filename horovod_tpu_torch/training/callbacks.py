"""Training-loop callbacks: the port of ``horovod_tpu.flax.callbacks``
(the reference's keras callbacks, ``horovod/_keras/callbacks.py``), bound
to a torch optimizer through the live :class:`~horovod_tpu_torch.models.
train.TrainState`:

* :class:`BroadcastGlobalVariablesCallback` — every replicated tensor of
  the state (weights and optimizer state) from the root, in place;
* :class:`MetricAverageCallback` — epoch metrics averaged over the ranks,
  one named allreduce a metric;
* :class:`LearningRateScheduleCallback` and
  :class:`LearningRateWarmupCallback` — the LR as ``initial_lr *
  multiplier(epoch)``, and Goyal et al.'s "lr x size" warmup;
* :class:`CheckpointCallback` and :class:`ElasticSnapshotCallback` — the
  state through a :class:`~horovod_tpu_torch.checkpoint.CheckpointManager`
  and a :class:`~horovod_tpu_torch.elastic.Snapshotter`.

**The LR is a tensor.** The JAX package needs ``optax.inject_hyperparams``
so that the LR lives in the optimizer state as an array; here it is a 0-d
tensor ``lr`` in each param group (``torch.optim.Adam(params,
lr=torch.tensor(1e-4, device="cuda"), capturable=True)``), which
:func:`set_hyperparam` writes in place (``fill_``). A captured window
reads that tensor at every replay, where a float ``lr`` is a constant of
the graph. SGD reads a tensor ``lr`` on the host (``alpha=-lr``), which a
CUDA graph cannot capture, so an LR schedule under a captured window
runs Adam or AdamW with ``capturable=True``; a window over SGD with a
tensor ``lr`` raises (:mod:`horovod_tpu_torch.distributed.window`). Eager
steps, and every step on the CPU, take any of them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

#: The JAX package's hyperparameter names that torch spells otherwise.
_TORCH_NAMES = {"learning_rate": "lr"}


class Callback:
    """Hook points mirror keras.callbacks.Callback; each receives the
    :class:`horovod_tpu_torch.training.TrainLoop` driving training."""

    def set_loop(self, loop) -> None:
        self.loop = loop

    def on_train_begin(self, logs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_epoch_begin(self, epoch: int,
                       logs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_batch_begin(self, batch: int,
                       logs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_batch_end(self, batch: int,
                     logs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_epoch_end(self, epoch: int,
                     logs: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_train_end(self, logs: Optional[Dict[str, Any]] = None) -> None:
        pass


# ---------------------------------------------------------------- opt-state
# surgery on a TrainState's opt_state: its "hyperparams" (one dict of
# tensor hyperparameters a param group) and SGD's momentum buffers.


def _hyper_tensors(opt_state, name: str):
    key = _TORCH_NAMES.get(name, name)
    found = [g[key] for g in opt_state.get("hyperparams", ())
             if isinstance(g.get(key), torch.Tensor)]
    if not found:
        raise KeyError(
            f"hyperparameter {name!r} not found as a tensor — build the "
            f"optimizer with a tensor {key!r} (e.g. torch.optim.Adam("
            f"params, {key}=torch.tensor(...))) so it is mutable state")
    return found


def get_hyperparam(opt_state, name: str):
    """The tensor hyperparameter ``name`` of the first param group
    (``learning_rate`` is torch's ``lr``); raises ``KeyError`` when no
    group holds it as a tensor."""
    return _hyper_tensors(opt_state, name)[0]


def set_hyperparam(opt_state, name: str, value):
    """Write ``value`` into the tensor hyperparameter ``name`` of every
    param group, in place (``fill_``); returns ``opt_state``."""
    with torch.no_grad():
        for t in _hyper_tensors(opt_state, name):
            t.fill_(value)
    return opt_state


def scale_momentum(opt_state, factor: float):
    """Multiply SGD's momentum buffers by ``factor``, in place (the
    reference's momentum correction: when the LR jumps by k, the old
    momentum is worth k times in the new step size's units). Adam's
    moments are left alone, as the JAX package leaves ``ScaleByAdamState``
    alone. Returns ``opt_state``."""
    bufs = [s["momentum_buffer"] for s in opt_state.values()
            if isinstance(s, dict) and "momentum_buffer" in s]
    bufs += [s["momentum_buffer"]
             for s in opt_state.get("zero", {}).values()
             if "momentum_buffer" in s]
    if bufs:
        with torch.no_grad():
            torch._foreach_mul_(bufs, factor)
    return opt_state


# ----------------------------------------------------------------- callbacks


def _replicated_tensors(state):
    """The tensor leaves every rank holds alike: all of them, less a
    ``TrainState``'s rank-local ones (ZeRO shards, error-feedback
    residuals: those ``state_partition_specs`` gives an axis)."""
    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.models.train import (TrainState,
                                                state_partition_specs)

    local = set()
    if isinstance(state, TrainState):
        specs = flatten(state_partition_specs(state)["opt_state"])[0]
        local = {id(t) for t, spec in zip(flatten(state["opt_state"])[0],
                                          specs) if len(spec)}
    return [t for t in flatten(state)[0]
            if isinstance(t, torch.Tensor) and id(t) not in local]


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the train state from ``root_rank`` at train start
    (reference ``_keras/callbacks.py:20-30``), in place: every rank
    starts from the root's weights and optimizer state. A ZeRO shard or
    an error-feedback residual is each rank's own and is kept."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        from horovod_tpu_torch.distributed.optimizer import \
            broadcast_parameters

        broadcast_parameters(_replicated_tensors(self.loop.state),
                             self.root_rank)


class CheckpointCallback(Callback):
    """Save the train state every ``every_epochs`` epochs (and at train
    end) through a :class:`~horovod_tpu_torch.checkpoint.
    CheckpointManager`. ``step_counter`` maps the loop state to the
    checkpoint's step id (default: the epoch number)."""

    def __init__(self, manager, every_epochs: int = 1, step_counter=None):
        self.manager = manager
        self.every_epochs = max(1, int(every_epochs))
        self.step_counter = step_counter
        self._last_saved: int = -1
        self._last_epoch: int = -1

    def _step_id(self, epoch: int) -> int:
        if self.step_counter is not None:
            return int(self.step_counter(self.loop.state))
        return epoch

    def on_epoch_end(self, epoch, logs=None):
        self._last_epoch = epoch
        if (epoch + 1) % self.every_epochs == 0:
            self._last_saved = self._step_id(epoch)
            self.manager.save(self._last_saved, self.loop.state)

    def on_train_end(self, logs=None):
        # Final state always lands on disk, even when the epoch count is
        # not a multiple of every_epochs.
        if self._last_epoch >= 0:
            final = self._step_id(self._last_epoch)
            if final != self._last_saved:
                self.manager.save(final, self.loop.state)
        self.manager.wait_until_finished()


class ElasticSnapshotCallback(Callback):
    """The elastic subsystem's face in a :class:`TrainLoop`: cadence
    snapshots of ``loop.state`` and the deferred-preemption epilogue at
    batch boundaries (:func:`horovod_tpu_torch.elastic.run_elastic`'s
    keras-lane counterpart).

    ``snapshotter``: a :class:`horovod_tpu_torch.elastic.Snapshotter`.
    ``preemption``: a :class:`horovod_tpu_torch.elastic.PreemptionHandler`
    (default: one installed on SIGTERM at train begin); its ``finalize``
    snapshots, spills and exits 75. ``step_counter`` maps the loop state
    to the global step id (default: ``int(state["step"])``, the
    :class:`~horovod_tpu_torch.models.train.TrainState` layout);
    snapshots and manifests are labelled with it, so a relaunched loop
    restores with ``snapshotter.restore(state)`` before ``fit``.
    ``heartbeat`` (default: ``Heartbeat.from_env()``) is touched at every
    boundary."""

    def __init__(self, snapshotter, preemption=None, step_counter=None,
                 heartbeat=None):
        self.snapshotter = snapshotter
        self.preemption = preemption
        self.step_counter = (step_counter
                             or (lambda state: int(state["step"])))
        self.heartbeat = heartbeat

    def on_train_begin(self, logs=None):
        from horovod_tpu_torch.elastic.signals import (Heartbeat,
                                                       PreemptionHandler)

        if self.preemption is None:
            self.preemption = PreemptionHandler()
        if self.heartbeat is None:
            # Feeds the supervisor's watchdog under hvdrun-torch
            # --elastic (HOROVOD_HEARTBEAT_DIR); None when unsupervised.
            self.heartbeat = Heartbeat.from_env()
        # No touch here: a rank is watched once a real boundary passes.

    def on_batch_end(self, batch, logs=None):
        step = self.step_counter(self.loop.state)
        if self.preemption.check():
            self.preemption.finalize(self.snapshotter, step,
                                     self.loop.state)
        self.snapshotter.maybe(step, self.loop.state)
        if self.heartbeat is not None:
            self.heartbeat.touch(step)

    def on_train_end(self, logs=None):
        self.snapshotter.flush(self.step_counter(self.loop.state),
                               self.loop.state)
        if self.preemption is not None:
            self.preemption.uninstall()


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over the ranks (reference
    ``_keras/callbacks.py:33-67``): each number or tensor becomes a
    float32 tensor on the job's device, averaged by one allreduce named
    ``metric.<key>``; other values pass through."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.distributed import mpi_ops

        for key in list(logs):
            val = logs[key]
            if isinstance(val, (int, float, torch.Tensor)):
                # One reduction a metric, a handful of scalars an epoch,
                # each under its own name (timeline identity).
                logs[key] = mpi_ops.allreduce(
                    torch.as_tensor(val, dtype=torch.float32,
                                    device=basics.device()),
                    average=True, name=f"metric.{key}")


class LearningRateScheduleCallback(Callback):
    """Schedule the LR as ``initial_lr * multiplier(epoch)`` (reference
    ``_keras/callbacks.py:70-147``).

    ``multiplier`` is a float or a callable of the (possibly fractional)
    epoch. ``staircase=True`` updates on epoch boundaries; otherwise
    every batch with ``epoch + batch / steps_per_epoch``. ``initial_lr``
    defaults to the optimizer's LR at the first application. When the
    applied LR changes and ``momentum_correction`` is set, SGD's momentum
    buffers are rescaled by new / old. The LR must be a tensor
    (the module docstring)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 initial_lr: Optional[float] = None,
                 steps_per_epoch: Optional[int] = None):
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda epoch: multiplier))
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = initial_lr
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self._last_lr: Optional[float] = None

    def _in_window(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _apply(self, epoch_f) -> None:
        if not self._in_window(epoch_f):
            return
        opt_state = self.loop.state["opt_state"]
        if self.initial_lr is None:
            # First application: adopt the optimizer's current LR.
            self.initial_lr = float(get_hyperparam(opt_state,
                                                   "learning_rate"))
        new_lr = self.initial_lr * float(self.multiplier(epoch_f))
        if self._last_lr is not None and math.isclose(self._last_lr, new_lr):
            return
        set_hyperparam(opt_state, "learning_rate", new_lr)
        if self.momentum_correction and self._last_lr not in (None, 0.0):
            scale_momentum(opt_state, new_lr / self._last_lr)
        self._last_lr = new_lr

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase:
            self._apply(float(epoch))

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase:
            if self.steps_per_epoch is None:
                raise ValueError(
                    "staircase=False requires steps_per_epoch")
            self._apply(self.current_epoch + batch / self.steps_per_epoch)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual "lr x size" warmup over the first epochs (reference
    ``_keras/callbacks.py:149-168``, after Goyal et al. 2017): with the
    base LR already scaled by ``size``, the multiplier ramps from 1/size
    to 1 as ``(1 + progress (size - 1)) / size``, so training starts at
    the single-rank LR, and snaps to the full LR when the warmup ends."""

    def __init__(self, warmup_epochs: float = 5.0,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        from horovod_tpu_torch.common import basics

        self.verbose = verbose
        size = basics.size() if basics.is_initialized() else 1

        def multiplier(epoch):
            if warmup_epochs <= 0:
                return 1.0
            progress = min(epoch / warmup_epochs, 1.0)
            return (1.0 + progress * (size - 1)) / size

        super().__init__(multiplier, start_epoch=0,
                         end_epoch=None, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.warmup_epochs = warmup_epochs

    def on_batch_begin(self, batch, logs=None):
        if self.current_epoch < self.warmup_epochs:
            super().on_batch_begin(batch, logs)

    def on_epoch_begin(self, epoch, logs=None):
        super().on_epoch_begin(epoch, logs)
        if epoch >= self.warmup_epochs:
            # Warmup over: snap to the full (clamped multiplier = 1) LR so
            # the ramp ends exactly at the scaled rate.
            self._apply(float(epoch))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose and epoch < self.warmup_epochs and self._last_lr:
            print(f"Epoch {epoch + 1}: warmup lr = {self._last_lr:.6f}")
