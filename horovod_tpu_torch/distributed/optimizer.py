"""DistributedOptimizer and parameter/optimizer-state broadcast: the port of
``horovod_tpu.jax.optimizer`` in the reference's PyTorch shape
(horovod/torch/__init__.py:42-348).

``DistributedOptimizer(optimizer)`` returns an optimizer of the same
class whose ``step()`` first replaces every parameter's ``.grad`` with
its cross-rank reduction through the fused buckets
(:func:`horovod_tpu_torch.distributed.fusion.fused_reduce`), then runs
the wrapped update. The JAX package reduces inside ``optax.chain``; the
numbers are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import fused_reduce


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixed into the wrapped optimizer's class by
    :func:`DistributedOptimizer` (the reference's construction)."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, op, average, fusion_threshold,
                 overlap, hierarchical):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        own = [p for g in self.param_groups for p in g["params"]]
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(set(names)) != len(names):
                raise ValueError("named_parameters holds duplicate names")
            named_ids = {id(p) for _, p in named}
            if any(id(p) not in named_ids for p in own):
                raise ValueError("named_parameters was given, but one or "
                                 "more of the optimizer's parameters are "
                                 "not named in it")
        self._hvd_params = own
        self._hvd_passes = 0
        self._hvd_k = backward_passes_per_step
        self._hvd_reduce = dict(average=average, compression=compression,
                                op=op, fusion_threshold=fusion_threshold,
                                overlap=overlap, hierarchical=hierarchical,
                                name="grads")

    def synchronize(self) -> None:
        """Replace each ``.grad`` with its fused cross-rank reduction
        (divided by ``backward_passes_per_step`` first: ``.grad`` sums
        the passes, ``optax.MultiSteps`` averages them).

        Every parameter that requires a gradient is reduced, as
        ``allreduce_gradients_transform`` reduces every leaf: one whose
        ``.grad`` is None (it took no part in this rank's backward) gets
        zeros first. So every rank plans the same buckets over the same
        tensors, and the wrapped optimizer updates that parameter by its
        moments, as optax does. A frozen parameter (``requires_grad``
        False, the same on every rank) is neither given a gradient nor
        reduced, so the wrapped optimizer skips it, as Horovod's does."""
        params = [p for p in self._hvd_params if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self._hvd_k > 1:
            grads = [g / self._hvd_k for g in grads]
        reduced = fused_reduce(grads, **self._hvd_reduce)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    def step(self, closure=None):
        """Count one backward pass; on every ``backward_passes_per_step``-th
        call, reduce the accumulated gradients and update. Other calls
        return ``None`` and leave ``.grad`` accumulating."""
        self._hvd_passes += 1
        if self._hvd_passes % self._hvd_k:
            return None
        self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, set_to_none: bool = True):
        """Zero the gradients only at an update boundary, so that
        ``zero_grad(); backward(); step()`` accumulates across the passes
        of one update."""
        if self._hvd_passes % self._hvd_k == 0:
            super(self.__class__, self).zero_grad(set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1, op=None,
                         average: bool = True,
                         fusion_threshold: Optional[int] = None,
                         overlap: Optional[str] = None,
                         hierarchical: Optional[str] = None):
    """Wrap ``optimizer`` so its updates see cross-rank-averaged
    gradients, as an instance of a subclass of the optimizer's own class
    built on its ``param_groups`` (the reference's construction: the
    hyperparameters carry over, per-parameter state starts empty).

    ``named_parameters`` is checked to name every parameter (as in the
    reference); bucket fusion needs no names. With
    ``backward_passes_per_step = k`` the reduction and the update run on
    every k-th ``step()`` over the gradient summed by k backward passes
    and divided by k. ``op``/``average``/``compression``/
    ``fusion_threshold``/``overlap``/``hierarchical`` are
    :func:`~horovod_tpu_torch.distributed.fusion.fused_reduce`'s."""
    basics.config()                       # raises before hvd.init()
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, average, fusion_threshold,
               overlap, hierarchical)


def _tensors(params):
    if isinstance(params, dict):
        return list(params.values())
    out = []
    for p in params:
        out.append(p[1] if isinstance(p, tuple) else p)
    return out


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite, in place, every tensor of ``params`` (a ``state_dict``,
    ``named_parameters()`` or a list of tensors) with ``root_rank``'s."""
    n = basics.size()
    if not 0 <= root_rank < n:
        raise InvalidArgumentError(
            f"broadcast root_rank {root_rank} out of range for size {n}")
    if n == 1:
        return
    with torch.no_grad():
        for t in _tensors(params):
            t.copy_(mpi_ops.broadcast(t, root_rank))


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Replace ``optimizer``'s state and hyperparameters with
    ``root_rank``'s (its ``state_dict``, pickled and broadcast)."""
    state = mpi_ops.broadcast_object(optimizer.state_dict(), root_rank)
    if basics.size() > 1:
        optimizer.load_state_dict(state)
