"""Multi-step training windows: the port of ``horovod_tpu.jax.window``.

The JAX module compiles K training steps into one ``lax.scan`` program,
so the host dispatches once and syncs at most once per window instead of
once per step. Here a window replays one captured step K times
(:class:`~horovod_tpu_torch._graphs.CapturedStep`): the host issues one
graph launch a step in place of the step's thousands of kernel launches,
and syncs at most once a window. One step is captured, not K: the
launch saving is the same, the capture's time and the graph's size do
not grow with K, and a trailing window shorter than K needs no capture
of its own.

Two layers, as in the JAX module:

* :func:`windowed` turns a step into a window step. PyTorch keeps the
  train state in the modules and the optimizer and updates it in place,
  so the window step takes only the stacked batches (every leaf with a
  leading window axis of length K) and returns the metrics' means over
  the window, accumulated on the device: the host sees one small result
  per window;
* :func:`run_steps` is the loop: it stages K-batch windows onto the
  device double-buffered (:func:`horovod_tpu_torch.data.prefetch_windows`)
  and marks each window on the Horovod timeline.

Numerical contract: a K-step window runs the same kernels in the same
order as K eager calls of the step, so the losses and parameters are
bit-identical (held on the card by ``chip_smoke.py``; the CPU, where the
window runs the step eagerly, is held against the JAX window by
``tests/test_torch_window.py``). The first window of a signature is one
eager warm-up step plus K - 1 replays; later windows are K replays.

What a captured step needs (checked here before the first capture, or
raised with its cause by the capture):

* its optimizer capturable: ``torch.optim.Adam(..., capturable=True)``
  (and the other optimizers that have the flag); SGD needs nothing;
* no host sync inside the step (no ``.item()``, no branch on a tensor's
  value);
* random draws from the default generator or from a generator that the
  step's ``model`` holds (the zoo's ``Dropout``): the capture registers
  those with the graph, so each replay draws fresh masks, as K eager
  steps would; a draw from another generator raises at the capture;
* ``backward_passes_per_step == 1``: ``DistributedOptimizer`` counts the
  passes of an update in Python, which a replay does not run, so a window
  over an accumulating optimizer raises ``NotImplementedError`` (the JAX
  window scans ``optax.MultiSteps``, whose counter is device state);
* no error-feedback residuals: a window over an optimizer on the
  int8/fp8 hierarchical ladder raises ``NotImplementedError``, since a
  captured ladder needs NCCL sub-communicators inside the graph, which no
  one-card run can show (the JAX window carries the residuals as scan
  state);
* a learning rate a schedule can change between replays: a tensor
  ``lr`` on the parameters' device, read by a capturable Adam or AdamW
  (``torch.optim.Adam(..., lr=torch.tensor(1e-4, device="cuda"),
  capturable=True)``). A float ``lr`` is a constant of the graph (a new
  float changes the signature and captures again), and SGD reads a
  tensor ``lr`` on the host (``alpha=-lr`` is a ``.item()``), so a window
  over SGD with a tensor ``lr``, or over a tensor ``lr`` on another
  device, raises before it captures anything.

Under ``HOROVOD_AUTOTUNE`` a window call is one dispatch of the step
tuner (:mod:`horovod_tpu_torch.distributed.autotune`; the optimizer's
steps inside it are not counted), and the tuner's generation is part of
the signature: each move of the tuner captures the step again under the
new bucket plan, releasing the graph it replaces.

A step built by :func:`~horovod_tpu_torch.models.train.make_train_step`
or ``make_image_train_step`` carries its ``model`` and ``optimizer`` as
attributes, and the window reads them for those checks and for the
capture's signature (parameters frozen or replaced, hyperparameters
changed: the step is captured again). A step of your own can set the
same two attributes.

``stacked_specs`` is not ported: the data-parallel window's batch is
each rank's own, with no partition spec to shift under the window axis.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch
from torch.utils._pytree import tree_leaves, tree_map

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch._graphs import CapturedStep, module_generators
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed import autotune


def _check_k(steps_per_dispatch) -> int:
    k = int(steps_per_dispatch)
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    return k


def _check_optimizer(optimizer, device: torch.device) -> None:
    """Raise for an optimizer a window cannot replay (module docstring)."""
    k = getattr(optimizer, "backward_passes_per_step", 1)
    if k != 1:
        raise NotImplementedError(
            f"backward_passes_per_step={k} under a window: "
            "DistributedOptimizer counts the passes of an update in "
            "Python, which a CUDA graph replay does not run (ROADMAP.md "
            "Queue 3, deliberate differences)")
    if getattr(optimizer, "residuals", None) is not None:
        raise NotImplementedError(
            "a window over DistributedOptimizer's quantized hierarchical "
            "ladder: a captured ladder needs NCCL sub-communicators inside "
            "the graph, which no one-card run can show (ROADMAP.md Queue "
            "3, deliberate differences)")
    if device.type != "cuda":
        return
    off = [i for i, g in enumerate(optimizer.param_groups)
           if g.get("capturable") is False]
    if off:
        raise ValueError(
            f"{type(optimizer).__name__} has capturable=False (param "
            f"groups {off}), and a window captures its step into a CUDA "
            "graph: construct it with capturable=True")
    for i, g in enumerate(optimizer.param_groups):
        lr = g.get("lr")
        if not isinstance(lr, torch.Tensor):
            continue
        if isinstance(optimizer, torch.optim.SGD):
            raise ValueError(
                f"SGD with a tensor lr (param group {i}) under a window: "
                "SGD reads it on the host (alpha=-lr, an .item()), which a "
                "CUDA graph cannot capture, and a float lr is a constant "
                "of the graph; an LR schedule under a captured window "
                "needs Adam or AdamW with capturable=True and a tensor lr "
                "on the card")
        if lr.device.type != device.type:
            raise ValueError(
                f"the tensor lr of param group {i} lies on {lr.device}, "
                f"and the window runs on {device}: a captured step reads "
                "a host scalar once, at capture; put the lr on the card "
                "(torch.tensor(lr, device=...))")


def _signature_key(step_fn) -> Callable[[], tuple]:
    model = getattr(step_fn, "model", None)
    optimizer = getattr(step_fn, "optimizer", None)

    def key():
        params = () if model is None else tuple(
            (p.data_ptr(), p.requires_grad) for p in model.parameters())
        hyper = () if optimizer is None else tuple(
            tuple(sorted((k, v) for k, v in g.items()
                         if k != "params" and not isinstance(v, torch.Tensor)))
            for g in optimizer.param_groups)
        return params, hyper, autotune.generation()

    return key


class _Window:
    """The window step :func:`windowed` returns; ``step`` is its
    :class:`CapturedStep` (captures, replays, capture time)."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        model = getattr(step_fn, "model", None)
        self.step = CapturedStep(
            step_fn, key=_signature_key(step_fn), name="window step",
            generators=None if model is None else module_generators(model))

    def __call__(self, stacked_batches):
        return autotune.tuned_call(self, lambda: self._run(stacked_batches))

    def _run(self, stacked_batches):
        leaves = [x for x in tree_leaves(stacked_batches)
                  if isinstance(x, torch.Tensor)]
        if not leaves:
            raise ValueError("a window takes stacked batches of tensors")
        length = leaves[0].shape[0]
        optimizer = getattr(self.step_fn, "optimizer", None)
        if optimizer is not None:
            _check_optimizer(optimizer, leaves[0].device)
        total = None
        for i in range(length):
            out = self.step(tree_map(lambda x: x[i], stacked_batches))
            total = (tree_map(lambda o: o.detach().clone(), out)
                     if total is None else tree_map(torch.add, total, out))
        return tree_map(lambda t: t / length, total)


def windowed(step_fn, steps_per_dispatch: int):
    """A window step of ``steps_per_dispatch`` applications of ``step_fn``.

    ``step_fn(batch) -> metrics`` (a tensor or a dict of them) runs one
    training step and updates the train state in place. The returned
    ``window_step(stacked_batches) -> metric means`` runs one step for
    each index of the batches' leading window axis (any length, so a
    trailing window shorter than K takes the same window step), captured
    once and replayed on the card, and returns the metrics averaged over
    the window on the device.

    ``steps_per_dispatch == 1`` returns ``step_fn`` unchanged: the identity
    path, eager, no window axis."""
    k = _check_k(steps_per_dispatch)
    if k == 1:
        return step_fn
    optimizer = getattr(step_fn, "optimizer", None)
    if optimizer is not None:
        _check_optimizer(optimizer, torch.device("cpu"))
    return _Window(step_fn)


def stack_batches(batches: Iterable):
    """Stack a list of batches (tensors, or dicts/lists/tuples of them)
    along a new leading window axis (``torch.stack`` per leaf; for the
    host-side double-buffered stager use
    :func:`horovod_tpu_torch.data.prefetch_windows`)."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    return tree_map(lambda *leaves: torch.stack(leaves), *batches)


def repeat_batch(batch, steps_per_dispatch: int):
    """One batch under a K-long window axis without K copies (an
    ``expand`` view): the synthetic bench reuses one batch every step."""
    k = _check_k(steps_per_dispatch)
    return tree_map(lambda x: x[None].expand(k, *x.shape), batch)


def stage_synthetic_window(step_fn, batch, steps_per_dispatch: int):
    """Synthetic-benchmark window staging in one place: the window step
    and the batch repeated under the window axis, ``(step_fn, batch)``.
    K = 1 is the identity pair: the per-step dispatch, untouched."""
    k = _check_k(steps_per_dispatch)
    if k == 1:
        return step_fn, batch
    return windowed(step_fn, k), repeat_batch(batch, k)


def run_steps(step_fn, batches: Iterable, steps_per_dispatch: int = 1, *,
              prefetch: int = 2, sync_each_window: bool = False,
              device: DeviceLike = None) -> List:
    """Run ``step_fn`` over ``batches`` in K-step windows on ``device``
    (``None`` = the card; raises without one)::

        metrics = hvd.run_steps(train_step, batch_iter,
                                steps_per_dispatch=30)

    Per window of K consecutive host batches: the batches are stacked on
    the host and staged to the device double-buffered (``prefetch``
    windows in flight, so window N+1's copy runs while window N
    computes), then run by :func:`windowed`'s window step; with a
    timeline on, each window is marked (``WINDOW_START``) and its host
    dispatch spans ``WINDOW`` on the ``hvd.window`` track.

    Returns one entry per window: the metric means over its steps (with
    ``steps_per_dispatch == 1`` the raw per-step metrics). A trailing
    window shorter than K runs as a shorter window; every batch trains.

    ``sync_each_window`` waits for the card at every window boundary (a
    ``WINDOW_SYNC`` span on the timeline), for timing; training loops
    leave it False so the host runs ahead."""
    from horovod_tpu_torch.data.prefetch import prefetch_windows
    from horovod_tpu_torch.utils import timeline as tl_names
    from horovod_tpu_torch.utils.devsync import window_sync

    k = _check_k(steps_per_dispatch)
    dev = resolve_device(device)
    run = windowed(step_fn, k)
    tl = basics.timeline() if basics.is_initialized() else None
    tl_on = tl is not None and tl.enabled
    metrics_out = []
    for index, window in enumerate(prefetch_windows(batches, k,
                                                    size=prefetch,
                                                    device=dev)):
        length = 1 if k == 1 else tree_leaves(window)[0].shape[0]
        if tl_on:
            tl.mark_window(index, length)
            tl.start("hvd.window", tl_names.WINDOW,
                     args={"window": index, "steps": length,
                           "span": "host_dispatch"})
        try:
            metrics = run(window)
        finally:
            if tl_on:
                tl.end("hvd.window", tl_names.WINDOW)
        if sync_each_window:
            window_sync(metrics, timeline=tl, steps=length)
        metrics_out.append(metrics)
    return metrics_out
