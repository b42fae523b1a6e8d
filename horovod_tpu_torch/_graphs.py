"""CUDA-graph capture of a step: what ``jax.jit`` is to the JAX package.

The JAX package compiles a training window (``jax/window.py``) and the
serving engine's decode step (``serve/engine.py``) into XLA programs, so
the host dispatches once per program. PyTorch runs eagerly, one host call
per kernel; its counterpart of a compiled step is a CUDA graph, recorded
once and replayed as one launch. :class:`CapturedStep` is the one place
in the port that captures.

``CapturedStep(fn)`` called on CUDA tensors:

1. the first call (or the first after the signature changed) runs
   ``fn`` eagerly on a side stream: a real step, whose result it returns.
   This warm-up builds the kernel libraries and raises their shared
   memory limits (``set_smem_once``) outside capture, creates an
   optimizer's state lazily, and lets cuBLAS and NCCL set up their
   per-stream state;
2. it then captures ``fn`` once into a graph with a private memory pool,
   reading static copies of the inputs. Capturing runs no kernel, so the
   warm-up stays the only step of that call;
3. every later call with the same signature copies its inputs into the
   static tensors and replays the graph, and returns the graph's static
   outputs, which the next replay overwrites.

The signature is the inputs' structure, shapes, dtypes and devices (and
the values of non-tensor inputs, which the graph holds as constants),
plus what ``key()`` returns: a training window passes the model's
parameters (address and ``requires_grad``) and the optimizer's
hyperparameters, the engine its parameter tensors. A changed signature
releases the old graph and warms up and captures again. There is no
path back to eager on the card: a capture that fails raises
:class:`CaptureError` with the cause (a host sync inside the step, an
optimizer that is not capturable, a collective the process group
refuses to capture).

Python runs only during the warm-up and the capture: a replay adds
nothing to a kernel wrapper's ``launches`` counter, to
``fused_reduce.collectives`` or to the timeline, and a parameter frozen
between calls does not leave a frozen gradient hook plan behind, since
it changes the signature. On a CPU device ``fn`` simply runs: the
caller asked for the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from horovod_tpu_torch._device import DeviceLike


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph; ``__cause__`` is
    what CUDA or PyTorch raised."""


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return ("value", x)


def _device_of(flat) -> torch.device:
    devices = {x.device for x in flat if isinstance(x, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"a captured step takes tensors on one device, got "
                         f"{sorted(map(str, devices)) or 'none'}")
    return devices.pop()


class CapturedStep:
    """``fn`` as a CUDA graph replay (the module docstring).

    ``device`` is where ``fn`` runs (``None``: the device of the call's
    tensor arguments, which must share one). ``key`` returns the part of
    the signature that the arguments do not show. ``name`` labels errors.

    Counters for the caller: ``captures`` and ``replays``; ``warmup_s`` and
    ``capture_s``, the host seconds of the last warm-up step (synchronised)
    and of the last capture."""

    def __init__(self, fn: Callable, device: DeviceLike = None,
                 key: Optional[Callable[[], object]] = None,
                 name: str = "step"):
        self.fn = fn
        self.device = None if device is None else torch.device(device)
        self.key = key
        self.name = name
        self.captures = 0
        self.replays = 0
        self.warmup_s: Optional[float] = None
        self.capture_s: Optional[float] = None
        self._signature = None
        self._graph = None
        self._static_in: list = []
        self._static_out = None

    def __call__(self, *args):
        flat, spec = tree_flatten(args)
        dev = self.device if self.device is not None else _device_of(flat)
        if dev.type != "cuda":
            return self.fn(*args)
        signature = (spec, [_describe(x) for x in flat],
                     None if self.key is None else self.key())
        if self._graph is None or signature != self._signature:
            return self._warm_up_and_capture(dev, signature, flat, spec, args)
        for static, x in zip(self._static_in, flat):
            if isinstance(x, torch.Tensor):
                static.copy_(x)
        self._graph.replay()
        self.replays += 1
        return self._static_out

    def _release(self) -> None:
        """Drop the graph and its memory pool."""
        self._graph = None
        self._signature = None
        self._static_in = []
        self._static_out = None

    def _warm_up_and_capture(self, dev, signature, flat, spec, args):
        self._release()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(current)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

        static_in = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                     else x for x in flat]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
                static_out = self.fn(*tree_unflatten(static_in, spec))
        except Exception as e:
            raise CaptureError(
                f"{self.name}: CUDA graph capture failed ({type(e).__name__}"
                f": {e}); the step must run without host syncs and with "
                "capturable optimizers and process groups") from e
        self.capture_s = time.perf_counter() - t0
        self._graph, self._signature = graph, signature
        self._static_in, self._static_out = static_in, static_out
        self.captures += 1
        return out
