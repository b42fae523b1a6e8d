"""The training loop and its callbacks: the port of ``horovod_tpu.flax``
(the reference's keras binding). A package named ``flax`` that imports no
flax would mislead, so the port's is ``training``; its names are the JAX
package's, one for one.

* :func:`create_distributed_optimizer` — wrap a torch optimizer so its
  gradients are averaged over the ranks (``DistributedOptimizer``);
* :class:`TrainLoop` — keras's ``model.fit``: epochs of batches around a
  step function, with the callbacks' hooks;
* the callbacks (:mod:`.callbacks`), ``get_hyperparam`` and
  ``set_hyperparam``;
* :func:`save_model` / :func:`load_model` — the train state in the flax
  msgpack format (:mod:`._msgpack`), byte for byte the JAX package's, so
  a file saved by either package loads in the other;
* :class:`CheckpointManager` (:mod:`horovod_tpu_torch.checkpoint`).

Quick start, on the card (the CPU: ``device="cpu"`` to ``hvd.init``)::

    import horovod_tpu_torch.distributed as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.train import TrainState, apply_gradients

    hvd.init()
    opt = training.create_distributed_optimizer(torch.optim.Adam(
        model.parameters(), lr=torch.tensor(1e-4, device="cuda"),
        capturable=True), named_parameters=model.named_parameters())
    state = TrainState.from_model(model, opt)

    def step(state, batch):
        opt.zero_grad()
        loss = loss_fn(model(batch), batch)
        loss.backward()       # the hooks issue the buckets as grads land
        apply_gradients(opt, state)
        return state, {"loss": loss.detach()}

    loop = training.TrainLoop(state, step, lambda epoch: batches, [
        training.BroadcastGlobalVariablesCallback(0),
        training.MetricAverageCallback(),
        training.LearningRateWarmupCallback(warmup_epochs=2,
                                            steps_per_epoch=100)])
    history = loop.fit(epochs=10)
    training.save_model("model.msgpack", loop.state)

The state is live (:class:`~horovod_tpu_torch.models.train.TrainState`):
the step updates the model and optimizer in place, and every callback
reads and writes their tensors. A step may run a captured window
(:func:`horovod_tpu_torch.distributed.window.windowed`); an LR schedule
then needs a capturable Adam or AdamW (:mod:`.callbacks`).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import torch

from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.distributed.optimizer import (DistributedOptimizer,
                                                     broadcast_parameters)
from horovod_tpu_torch.training.callbacks import (
    BroadcastGlobalVariablesCallback,
    Callback,
    CheckpointCallback,
    ElasticSnapshotCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    get_hyperparam,
    set_hyperparam,
)


def create_distributed_optimizer(optimizer, name=None, **kwargs):
    """Wrap ``optimizer`` so its gradients are averaged over the ranks
    (reference ``_keras/__init__.py:20-70``): ``DistributedOptimizer(
    optimizer, **kwargs)``. ``name`` is accepted for the reference's
    signature (keras needed it for the dynamic subclass)."""
    del name
    return DistributedOptimizer(optimizer, **kwargs)


class TrainLoop:
    """A callback-driven epoch and batch loop over a training step.

    ``step_fn(state, batch) -> (state, metrics)`` is a black box: one
    eager step, or a window of steps replayed from one capture.
    ``data_fn(epoch)`` yields the epoch's batches. ``history`` holds each
    epoch's metric means; a callback may set ``stop_training``."""

    def __init__(self, state, step_fn: Callable, data_fn: Callable,
                 callbacks: Optional[List[Callback]] = None):
        self.state = state
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            cb.set_loop(self)
        self.history: List[Dict[str, float]] = []
        self.stop_training = False

    def _dispatch(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(*args)

    def fit(self, epochs: int) -> List[Dict[str, float]]:
        self._dispatch("on_train_begin", None)
        for epoch in range(epochs):
            if self.stop_training:
                break
            self._dispatch("on_epoch_begin", epoch, None)
            logs: Dict[str, Any] = {}
            count = 0
            for batch_idx, batch in enumerate(self.data_fn(epoch)):
                self._dispatch("on_batch_begin", batch_idx, None)
                self.state, metrics = self.step_fn(self.state, batch)
                batch_logs = {k: v for k, v in (metrics or {}).items()}
                self._dispatch("on_batch_end", batch_idx, batch_logs)
                # Device values are summed as they are: float() here
                # would wait for the card every batch.
                for k, v in batch_logs.items():
                    logs[k] = logs.get(k, 0.0) + v
                count += 1
            epoch_logs = {k: float(v) / max(count, 1)
                          for k, v in logs.items()}
            self._dispatch("on_epoch_end", epoch, epoch_logs)
            self.history.append(epoch_logs)
        self._dispatch("on_train_end", None)
        return self.history


# ------------------------------------------------------------- checkpointing
# Save on rank 0 only, restore on the root, broadcast from it.


def save_model(path: str, state, only_rank0: bool = True) -> None:
    """Write the train state (any tree of dicts, lists, tuples, tensors,
    numpy values and numbers) to ``path`` in the flax msgpack format,
    through a tmp file and ``os.replace``. With ``only_rank0`` the other
    ranks write nothing (reference ``README.md:113-115``)."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.training import _msgpack

    if only_rank0 and basics.is_initialized() and basics.rank() != 0:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            _msgpack.dump(state, f.write)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_model(path: str, template, root_rank: int = 0,
               broadcast: bool = True):
    """Restore a state :func:`save_model` (or the JAX package's) wrote.

    ``template`` gives the structure. Unlike the JAX package, which
    returns a new tree, the values are written into the template's own
    tensors (``torch._foreach_copy_``; a shape or dtype that differs from
    the file's raises), as ``load_state_dict`` does, so a live
    ``TrainState``'s model sees them; a leaf that is not a tensor is
    replaced in its dict or list. Returns the template (a tuple root
    rebuilt around the same tensors). With ``broadcast`` only
    ``root_rank`` reads the file, and every rank then takes the root's
    values (tensors in place, other leaves as objects)."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed import mpi_ops
    from horovod_tpu_torch.training import _msgpack

    spread = broadcast and basics.is_initialized() and basics.size() > 1
    values = None
    if not spread or basics.rank() == root_rank:
        with open(path, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            view, got = memoryview(buf), 0
            while got < len(buf):
                n = f.readinto(view[got:])
                if not n:
                    break
                got += n
            del view
        template, tensors, files, values = _msgpack.restore_into(
            template, _msgpack.restore(buf))
        if tensors:
            with torch.no_grad():
                torch._foreach_copy_(tensors, files)
        del buf, files
    if spread:
        values = mpi_ops.broadcast_object(values, root_rank)
        if basics.rank() != root_rank:
            template, tensors, _, _ = _msgpack.restore_into(
                template, None, values=values)
        broadcast_parameters(tensors, root_rank)
    return template


__all__ = [
    "Callback",
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "LearningRateScheduleCallback",
    "LearningRateWarmupCallback",
    "TrainLoop",
    "create_distributed_optimizer",
    "DistributedOptimizer",
    "save_model",
    "load_model",
    "CheckpointManager",
    "CheckpointCallback",
    "ElasticSnapshotCallback",
    "get_hyperparam",
    "set_hyperparam",
]
