"""DistributedOptimizer and parameter/optimizer-state broadcast: the port of
``horovod_tpu.jax.optimizer`` in the reference's PyTorch shape
(horovod/torch/__init__.py:42-348).

``DistributedOptimizer(optimizer)`` returns an optimizer of the same
class whose ``step()`` first replaces every parameter's ``.grad`` with
its cross-rank reduction through the fused buckets
(:func:`horovod_tpu_torch.distributed.fusion.fused_reduce`), then runs
the wrapped update. The JAX package reduces inside ``optax.chain``; the
numbers are the same.

When overlap resolves on for the optimizer's bucket plan (two buckets or
more under ``auto``), each bucket's collective starts from the backward
pass: a ``register_post_accumulate_grad_hook`` on every trainable
parameter marks its gradient final, and a bucket is issued once it and
every bucket after it in the plan are final (the JAX package's reverse
order, which is also PyTorch DDP's rule: collectives match across ranks
by issue order, so readiness alone never decides it). ``step()`` issues
what the hooks left (a parameter that took no part in the backward pass
gets zeros first), then waits for every bucket and unpacks it. The
numbers are those of overlap off, bit for bit. A parameter holds the
hook of one wrapper at a time: a new wrapper of the same parameters
removes the old one's hooks.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (InvalidArgumentError,
                                                 PreconditionError)
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import (BucketExchange,
                                                  fused_reduce, hook_grad,
                                                  release_grad_hooks,
                                                  unhook_grad)
from horovod_tpu_torch.distributed.zero import ZeroOptimizer


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
        # The hierarchical ladder is not ported: fused_reduce raises.
        self._hvd_hooks_on = hierarchical in (None, "off")
        self._hvd_exchange = None
        self._hvd_trainable: list = []
        self._hvd_planned = None
        self._hvd_hooked: dict = {}       # id -> each parameter hooked
        self._hvd_fired = 0
        release_grad_hooks(own)
        self._hvd_plan()

    @property
    def backward_passes_per_step(self) -> int:
        """The backward passes summed into each update."""
        return self._hvd_k

    def _hvd_plan(self) -> None:
        """Plan the hook exchange over the parameters that require a
        gradient now, and hook the ones that entered the set; nothing
        changes while the set is the planned one. Runs at construction,
        at the first hook of each update and at a ``step()`` that no hook
        preceded, so a parameter frozen between updates leaves the plan
        as it does under overlap off."""
        if not self._hvd_hooks_on:
            return
        trainable = [p for p in self._hvd_params if p.requires_grad]
        ids = [id(p) for p in trainable]
        if ids == self._hvd_planned:
            return
        self._hvd_planned = ids
        kw = {k: v for k, v in self._hvd_reduce.items()
              if k != "hierarchical"}
        exchange = BucketExchange(trainable, **kw)
        if not (exchange.overlap and trainable):
            exchange, trainable = None, []
        self._hvd_exchange = exchange
        self._hvd_trainable = trainable
        self._hvd_counts = [0] * len(trainable)
        self._hvd_index = {id(p): i for i, p in enumerate(trainable)}
        for pid in [q for q in self._hvd_hooked if q not in self._hvd_index]:
            unhook_grad(self._hvd_hooked.pop(pid))
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is not None:
                opt._hvd_hook(p)

        for p in trainable:
            if id(p) not in self._hvd_hooked:
                release_grad_hooks([p])
                hook_grad(p, self, hook)
                self._hvd_hooked[id(p)] = p

    def remove_hooks(self) -> None:
        """Remove this optimizer's gradient hooks; its later steps issue
        every bucket from ``step()``, with the same results. A new
        ``DistributedOptimizer`` or ZeRO optimizer over any of the same
        parameters calls it, so that the old wrapper reduces nothing on
        its own."""
        if self._hvd_fired:
            raise PreconditionError(
                "remove_hooks() was called after backward() and before "
                "step(): the gradients' collectives are in flight")
        for p in self._hvd_hooked.values():
            unhook_grad(p)
        self._hvd_hooked = {}
        self._hvd_hooks_on = False
        self._hvd_exchange = None
        self._hvd_trainable = []

    def _hvd_wire(self, i: int):
        """The i-th trainable parameter's gradient as it enters the
        reduction: the sum of the passes divided by their count."""
        g = self._hvd_trainable[i].grad
        return g / self._hvd_k if self._hvd_k > 1 else g

    def _hvd_hook(self, p) -> None:
        """Count one backward pass of parameter ``p``; on the
        ``backward_passes_per_step``-th its gradient is final."""
        if not self._hvd_fired:
            self._hvd_plan()
            if self._hvd_exchange is None:
                return
        self._hvd_fired += 1
        i = self._hvd_index[id(p)]
        c = self._hvd_counts[i] + 1
        if c > self._hvd_k:
            raise PreconditionError(
                "gradients were computed more than backward_passes_per_step "
                f"({self._hvd_k}) times before step(); raise "
                "backward_passes_per_step to accumulate more passes")
        self._hvd_counts[i] = c
        if c == self._hvd_k:
            self._hvd_exchange.ready(i, self._hvd_wire)

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
        reduced, so the wrapped optimizer skips it, as Horovod's does.

        Under gradient hooks, the buckets they issued are not issued
        again, and the rest follow in the same reverse order on every
        rank."""
        if not self._hvd_fired:
            self._hvd_plan()
        self._hvd_fired = 0
        ex = self._hvd_exchange
        if ex is None:
            params = [p for p in self._hvd_params if p.requires_grad]
        else:
            params = self._hvd_trainable
            self._hvd_counts = [0] * len(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        k = self._hvd_k
        grads = [p.grad if k == 1 or (ex is not None and ex.issued(i))
                 else p.grad / k for i, p in enumerate(params)]
        basics.timeline().mark_cycle_start()
        if ex is None:
            reduced = fused_reduce(grads, **self._hvd_reduce)
        else:
            reduced = ex.finish(grads.__getitem__)
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
            if self._hvd_fired:
                raise PreconditionError(
                    "zero_grad() was called after backward() and before "
                    "step(): the gradients' collectives are in flight")
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
    :func:`~horovod_tpu_torch.distributed.fusion.fused_reduce`'s.

    When ``overlap`` resolves on for the plan over the trainable
    parameters, the buckets start from gradient hooks during the backward
    pass (the module docstring), and a backward pass beyond
    ``backward_passes_per_step`` before ``step()`` raises. The wrapper
    takes the hooks of any earlier wrapper of the same parameters
    (``remove_hooks``); its hooks hold it only weakly."""
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
    ``root_rank``'s (its ``state_dict``, pickled and broadcast). A ZeRO
    optimizer's state is rank-local, and raises."""
    if isinstance(optimizer, ZeroOptimizer):
        raise InvalidArgumentError(
            "a ZeRO optimizer holds each rank's own slice of the state; "
            "broadcasting one rank's would overwrite the others' slices")
    state = mpi_ops.broadcast_object(optimizer.state_dict(), root_rank)
    if basics.size() > 1:
        optimizer.load_state_dict(state)
