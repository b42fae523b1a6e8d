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

A step that draws random numbers from a ``torch.Generator`` of its own
(the zoo's :class:`~horovod_tpu_torch.models.resnet.Dropout`) needs that
generator registered with the graph, or a replay would reuse the masks
of the capture: ``generators`` names the modules to look in, and every
generator they hold after the warm-up is registered before the capture
(``CUDAGraph.register_generator_state``), so each replay draws from the
generator's current state and advances it, as an eager step would. A
module that draws from a generator that was not registered raises
:class:`CaptureError` naming it (:func:`check_registered`); the default
generator is torch's, registered by every capture.

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

import gc
import time
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from horovod_tpu_torch._device import DeviceLike


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph; ``__cause__`` is
    what CUDA or PyTorch raised."""


#: While a capture runs: ``id(generator)`` of each generator registered
#: with its graph, and ``id(module)`` -> name of each module the step's
#: ``generators`` named.
_capture: Optional[dict] = None


def check_registered(generator: torch.Generator, owner) -> None:
    """Raise :class:`CaptureError` when a CUDA graph capture is running
    and ``generator``, which ``owner`` (a module) is about to draw from,
    was not registered with it: the graph would replay one frozen draw.
    Outside a capture, and on the CPU, it does nothing."""
    if generator.device.type != "cuda" or \
            not torch.cuda.is_current_stream_capturing():
        return
    cap = _capture or {"generators": set(), "names": {}}
    if id(generator) in cap["generators"]:
        return
    name = cap["names"].get(id(owner))
    where = (f"module {name!r} ({type(owner).__name__})" if name else
             f"{type(owner).__name__} {owner!r}, which the captured "
             "step's generators do not name,")
    raise CaptureError(
        f"{where} draws from a torch.Generator that is not registered "
        "with the CUDA graph being captured, so every replay would draw "
        "the capture's numbers again; a window registers the generators "
        "that the step's model holds after its warm-up step")


def register_generators(graph, named, device: torch.device) -> dict:
    """Register with ``graph`` the generator on ``device`` of each
    ``(name, module)`` in ``named`` that holds one (``module.generator``
    returns it, or ``None`` before its first draw there). Returns the
    capture record :func:`check_registered` reads: the registered
    generators' ids and every named module's name."""
    gens, names = set(), {}
    for name, module in named:
        names[id(module)] = name
        gen = module.generator(device)
        if gen is not None and id(gen) not in gens:
            graph.register_generator_state(gen)
            gens.add(id(gen))
    return {"generators": gens, "names": names}


def module_generators(model: torch.nn.Module):
    """``generators`` for a step over ``model``: each ``(name, module)``
    of its modules that draws from a generator of its own (has a
    ``generator(device)`` method)."""

    def named():
        return [(n, m) for n, m in model.named_modules()
                if callable(getattr(m, "generator", None))]

    return named


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
    ``generators`` returns the ``(name, module)`` pairs whose generators
    the graph registers (:func:`module_generators`).

    Counters for the caller: ``captures`` and ``replays``; ``warmup_s`` and
    ``capture_s``, the host seconds of the last warm-up step (synchronised)
    and of the last capture."""

    def __init__(self, fn: Callable, device: DeviceLike = None,
                 key: Optional[Callable[[], object]] = None,
                 name: str = "step",
                 generators: Optional[Callable[[], list]] = None):
        self.fn = fn
        self.generators = generators
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

    def release(self) -> None:
        """Drop the graph and its memory pool now (the next call warms up
        and captures again); the counters stay. A graph that holds NCCL
        collectives must go before its process group is destroyed: the
        communicator's teardown waits for the graphs that use it."""
        self._release()

    def _release(self) -> None:
        """Drop the graph and its memory pool. The pool also holds the
        cuBLAS workspace the capture's matmuls took, which cuBLAS keeps
        cached after the graph is gone, so the pool would stay reserved
        (one dead pool per recapture, e.g. each weight roll of the
        engine): dropping cuBLAS's cached workspaces lets it go. A live
        graph keeps its own pool's blocks, its workspace included. The
        cache is the process's, so other engines' eager products allocate
        a workspace again at their next call."""
        had_graph = self._graph is not None
        self._graph = None
        self._signature = None
        self._static_in = []
        self._static_out = None
        if had_graph:
            torch._C._cuda_clearCublasWorkspaces()

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
        global _capture
        _capture = register_generators(
            graph, self.generators() if self.generators else [], dev)
        t0 = time.perf_counter()
        # A graph destroyed while this stream captures (another engine's,
        # freed by the cycle collector) invalidates the capture: the
        # collector stays off until it ends (torch.cuda.graph collects
        # once just before the capture begins).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
                static_out = self.fn(*tree_unflatten(static_in, spec))
        except Exception as e:
            raise CaptureError(
                f"{self.name}: CUDA graph capture failed ({type(e).__name__}"
                f": {e}); the step must run without host syncs and with "
                "capturable optimizers and process groups") from e
        finally:
            _capture = None
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self._graph, self._signature = graph, signature
        self._static_in, self._static_out = static_in, static_out
        self.captures += 1
        return out
