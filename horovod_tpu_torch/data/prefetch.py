"""Device prefetch: overlap host-to-device copies with compute.

The port of ``horovod_tpu.data.prefetch``. ``jax.device_put`` is
asynchronous, so the JAX module keeps a small queue of issued copies; in
PyTorch a copy overlaps the step only from pinned host memory, with
``non_blocking=True``, on a stream other than the step's. So
:func:`prefetch_to_device` pins each host batch, copies it on a side
stream, and records an event there; the batch it yields has made the
consumer's current stream wait for that event, so the copy of batch N+1
runs while step N computes and no step reads a batch before it has
arrived. A batch is a tensor or numpy array, or a dict, list or tuple of
them, nested.

:func:`window_batches` and :func:`prefetch_windows` group K consecutive
batches into one stacked window, as the JAX functions do (the trailing
window may be shorter; K = 1 adds no window axis).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.utils._pytree import tree_map

from horovod_tpu_torch._device import DeviceLike, resolve_device


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _pinned(x) -> torch.Tensor:
    """``x`` in pinned host memory (a tensor already on the card as it
    is)."""
    t = _host_tensor(x)
    return t if t.is_cuda else t.pin_memory()


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Yield the items of ``iterator`` on ``device`` (``None`` = the card;
    raises without one), with ``size`` copies in flight: ``size=2``
    double-buffers, one batch computing while the next one is copied.

    On the card each leaf is pinned and copied with ``non_blocking=True``
    on a side stream; the consumer's current stream (at the time the item
    is yielded) waits for the copy, and the copy's memory is recorded as
    used by that stream. On the CPU the leaves are yielded as tensors."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item):
        if stream is None:
            return tree_map(_host_tensor, item), None
        with torch.cuda.stream(stream):
            moved = tree_map(lambda x: _pinned(x).to(dev, non_blocking=True),
                             item)
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done

    def take(entry):
        item, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            tree_map(lambda t: t.record_stream(consumer), item)
        return item

    for item in itertools.islice(it, size):
        queue.append(put(item))
    while queue:
        yield take(queue.popleft())
        for item in itertools.islice(it, 1):
            queue.append(put(item))


def window_batches(iterator: Iterable, steps_per_dispatch: int) -> Iterator:
    """Group consecutive batches into stacked K-step windows on the host
    (``np.stack`` per leaf): every leaf carries a leading window axis of
    length ``steps_per_dispatch``, except that the trailing window may be
    shorter when the iterator does not divide evenly (no batch is
    dropped). Window ``i`` holds batches ``[i*K, (i+1)*K)`` in order."""
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    it = iter(iterator)
    while True:
        group = list(itertools.islice(it, steps_per_dispatch))
        if not group:
            return
        yield tree_map(lambda *leaves: np.stack([np.asarray(x)
                                                 for x in leaves]), *group)


def prefetch_windows(iterator: Iterable, steps_per_dispatch: int,
                     size: int = 2, device: DeviceLike = None) -> Iterator:
    """Double-buffered K-batch stager for multi-step windows: K
    consecutive batches stacked on the host (:func:`window_batches`), each
    window moved by :func:`prefetch_to_device`, so window N+1's copy runs
    while window N computes. ``steps_per_dispatch == 1`` is exactly
    :func:`prefetch_to_device`, with no window axis."""
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    source = (iterator if steps_per_dispatch == 1
              else window_batches(iterator, steps_per_dispatch))
    yield from prefetch_to_device(source, size=size, device=device)
