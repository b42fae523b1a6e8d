"""Checkpoints of a pytree of tensors: the port of
``horovod_tpu.flax.checkpoint``'s manager and its numpy backend.

The JAX package's :class:`CheckpointManager` writes through orbax where
it is installed and through a dependency-free per-process shard writer
otherwise. Orbax is a JAX library, so the port keeps the shard writer
alone: it serves every state whose leaves the writing process holds
(single-host jobs, a rank's own ZeRO shard included), which is what the
elastic disk spill (:mod:`horovod_tpu_torch.elastic.snapshot`) needs.

The on-disk layout is the reference's, byte for byte, so a checkpoint
written by either package restores in the other::

    <root>/step_<n>/shard-<proc>.bin    the leaves' raw bytes, in leaf order
    <root>/step_<n>/shard-<proc>.json   {"leaves": [{"dtype", "shape",
                                         "offset", "nbytes"}], "proc",
                                         "nproc"}
    <root>/step_<n>/COMMIT              written last, by process 0, once
                                        every process's json has landed

Every file lands through a tmp file and ``os.replace``; readers ignore a
step without ``COMMIT``; the oldest steps past ``max_to_keep`` are
removed. The leaf order is the JAX package's (a dict's keys sorted,
:mod:`horovod_tpu_torch._pytree`). A bfloat16 leaf is written as its
``int16`` view's bytes under the dtype name ``"bfloat16"`` (the name
``ml_dtypes`` gives it on the JAX side) and read back with
``torch.frombuffer(..., dtype=torch.bfloat16)``; every other dtype goes
through numpy's name for it.

Usage::

    ckpt = CheckpointManager("/ckpts", max_to_keep=3)
    ckpt.save(step, state)                 # state: a pytree of tensors
    step = ckpt.latest_step()
    if step is not None:
        state = ckpt.restore(step, template=state)
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_unflatten

from horovod_tpu_torch._pytree import flatten

BACKENDS = ("auto", "orbax", "numpy")

_BF16 = "bfloat16"


def _resolve_backend(backend: Optional[str]) -> str:
    """``numpy`` for ``auto`` and ``numpy`` (``backend`` or
    ``HVD_CHECKPOINT_BACKEND``); ``orbax`` raises."""
    choice = (backend
              or os.environ.get("HVD_CHECKPOINT_BACKEND", "").strip().lower()
              or "auto")
    if choice not in BACKENDS:
        raise ValueError(
            f"checkpoint backend {choice!r}: expected one of {BACKENDS}")
    if choice == "orbax":
        raise ValueError(
            "checkpoint backend 'orbax': orbax is a JAX library, which "
            "horovod_tpu_torch does not use; the numpy backend "
            "(backend='numpy' or 'auto') serves every state a process "
            "holds")
    return "numpy"


class CheckpointManager:
    """Atomic, garbage-collected checkpoints of a pytree of tensors.
    Every process of the job saves its own shard; ``backend`` pins the
    implementation (``auto`` | ``numpy``; env ``HVD_CHECKPOINT_BACKEND``;
    ``orbax`` raises), and :attr:`backend` reports what was resolved."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, backend: Optional[str] = None):
        self.backend = _resolve_backend(backend)
        self._impl = _NumpyManager(os.path.abspath(directory),
                                   max_to_keep=max_to_keep,
                                   async_save=async_save)

    @property
    def directory(self) -> str:
        return self._impl.directory

    def save(self, step: int, state: Any) -> bool:
        """Save ``state`` (a pytree of tensors, numpy arrays or numbers)
        under ``step``. Returns whether a save was performed."""
        return self._impl.save(int(step), state)

    def restore(self, step: Optional[int] = None, template: Any = None):
        """Restore ``step`` (default: latest) into new leaves shaped by
        ``template``, which is required: a tensor leaf of the template
        gives a new tensor with its dtype and device (a CUDA template
        gets CUDA leaves), any other leaf a numpy array. The template is
        never written."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}")
        return self._impl.restore(int(step), template)

    def latest_step(self) -> Optional[int]:
        return self._impl.latest_step()

    def all_steps(self) -> List[int]:
        return self._impl.all_steps()

    def wait_until_finished(self) -> None:
        """Block until outstanding saves are committed (the numpy
        backend writes synchronously: nothing is outstanding)."""
        self._impl.wait_until_finished()

    def close(self) -> None:
        self._impl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_COMMIT = "COMMIT"


def _proc_info():
    from horovod_tpu_torch.common import basics

    if basics.is_initialized():
        return basics.process_rank(), basics.process_count()
    return 0, 1


def _leaf_bytes(leaf):
    """``(dtype name, shape, bytes)`` of one leaf, C order."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            data = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            return _BF16, list(t.shape), data
        try:
            arr = t.cpu().numpy()
        except TypeError as e:
            raise ValueError(
                f"checkpoint: a {t.dtype} leaf has no numpy counterpart "
                f"to write ({e})") from None
    else:
        # np.asarray keeps 0-d shape (ascontiguousarray would promote
        # scalars to (1,)); tobytes C-order-copies any strided input.
        arr = np.asarray(leaf)
        if arr.dtype == object:
            raise ValueError(
                f"checkpoint: a leaf of type {type(leaf).__name__} is not "
                "an array")
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _leaf_from_bytes(entry, blob: bytes, tmpl):
    """One restored leaf: a tensor like ``tmpl`` when it is one (its
    dtype and device), else a numpy array."""
    name, shape = entry["dtype"], list(entry["shape"])
    start = int(entry["offset"])
    data = bytearray(blob[start:start + int(entry["nbytes"])])
    if name == _BF16:
        t = torch.frombuffer(data, dtype=torch.bfloat16) if data else \
            torch.empty(0, dtype=torch.bfloat16)
        t = t.reshape(shape)
        if not isinstance(tmpl, torch.Tensor):
            raise ValueError(
                "checkpoint: a bfloat16 leaf restores into a tensor "
                f"template leaf only, got {type(tmpl).__name__}")
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(
                f"checkpoint: dtype {name!r} has no numpy counterpart")
        arr = np.frombuffer(data, dtype=dtype).reshape(shape)
        if not isinstance(tmpl, torch.Tensor):
            return arr.copy()
        try:
            t = torch.from_numpy(arr)
        except TypeError:
            raise ValueError(
                f"checkpoint: dtype {name!r} has no torch counterpart")
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"checkpoint: a leaf of shape {tuple(t.shape)} does not fit "
            f"the template's {tuple(tmpl.shape)}")
    return t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)


class _NumpyManager:
    """Per-process shard writer with atomic rename-commit."""

    def __init__(self, directory: str, max_to_keep: int,
                 async_save: bool):
        # async_save accepted for API parity; writes are synchronous
        # (the elastic Snapshotter provides the async layer above).
        del async_save
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _committed(self, path: str) -> bool:
        return os.path.exists(os.path.join(path, _COMMIT))

    def save(self, step: int, state: Any) -> bool:
        proc, nproc = _proc_info()
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        leaves, _ = flatten(state)
        meta = []
        offset = 0
        bin_tmp = os.path.join(step_dir, f".shard-{proc}.bin.tmp")
        with open(bin_tmp, "wb") as f:
            for leaf in leaves:
                name, shape, data = _leaf_bytes(leaf)
                f.write(data)
                meta.append({"dtype": name, "shape": shape,
                             "offset": offset, "nbytes": len(data)})
                offset += len(data)
        os.replace(bin_tmp, os.path.join(step_dir, f"shard-{proc}.bin"))
        json_tmp = os.path.join(step_dir, f".shard-{proc}.json.tmp")
        with open(json_tmp, "w") as f:
            json.dump({"leaves": meta, "proc": proc, "nproc": nproc}, f)
        # The json landing second marks THIS shard complete (its .bin is
        # already in place); the dir-level COMMIT lands after all shards.
        os.replace(json_tmp, os.path.join(step_dir, f"shard-{proc}.json"))
        if proc == 0:
            self._wait_for_shards(step_dir, nproc)
            tmp = os.path.join(step_dir, f".{_COMMIT}.tmp")
            with open(tmp, "w") as f:
                f.write(f"{nproc}\n")
            os.replace(tmp, os.path.join(step_dir, _COMMIT))
            self._gc()
        return True

    def _wait_for_shards(self, step_dir: str, nproc: int,
                         timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            present = [p for p in range(nproc) if os.path.exists(
                os.path.join(step_dir, f"shard-{p}.json"))]
            if len(present) == nproc:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"checkpoint commit: only {len(present)}/{nproc} "
                    f"process shards landed in {step_dir} within "
                    f"{timeout:.0f}s — a peer died mid-save; the step "
                    "stays uncommitted (readers will use the previous "
                    "one)")
            time.sleep(0.05)

    def _gc(self) -> None:
        steps = self.all_steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, step: int, template: Any):
        if template is None:
            raise ValueError(
                "the numpy checkpoint backend needs a template pytree "
                "to restore into (structure/dtype/device donor); pass "
                "restore(step, template=state)")
        step_dir = self._step_dir(step)
        if not self._committed(step_dir):
            raise FileNotFoundError(
                f"no committed checkpoint for step {step} under "
                f"{self.directory}")
        proc, _ = _proc_info()
        with open(os.path.join(step_dir, f"shard-{proc}.json")) as f:
            meta = json.load(f)["leaves"]
        t_leaves, spec = flatten(template)
        if len(meta) != len(t_leaves):
            raise ValueError(
                f"checkpoint step {step} holds {len(meta)} leaves but "
                f"the template has {len(t_leaves)} — structure changed "
                "since the save")
        with open(os.path.join(step_dir, f"shard-{proc}.bin"), "rb") as f:
            blob = f.read()
        out = [_leaf_from_bytes(entry, blob, tmpl)
               for entry, tmpl in zip(meta, t_leaves)]
        return tree_unflatten(out, spec)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        steps = []
        for n in names:
            if not n.startswith("step_"):
                continue
            try:
                step = int(n[len("step_"):])
            except ValueError:
                continue
            if self._committed(os.path.join(self.directory, n)):
                steps.append(step)
        return sorted(steps)

    def wait_until_finished(self) -> None:
        pass  # synchronous writes: nothing outstanding

    def close(self) -> None:
        pass


__all__ = ["BACKENDS", "CheckpointManager"]
