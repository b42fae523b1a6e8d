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

``hierarchical`` (auto|on|off) runs each bucket as the intra-host /
inter-host ladder (:mod:`horovod_tpu_torch.distributed.fusion`), from
the hooks as well. Under ``Compression.int8``/``.fp8`` with the ladder
engaged, the wrapper holds error-feedback residuals (:attr:`residuals`):
zeros at construction, one float32 vector per quantized stage per
floating bucket, each this rank's own shard, on the parameters' device;
every update feeds them through the exchange and keeps the new ones.
They travel in ``state_dict()`` under ``"hvd_residuals"``, and
:func:`broadcast_optimizer_state` leaves each rank its own.

The functional gradient API of the JAX package
(``horovod_tpu/jax/optimizer.py``) over pytrees of tensors (dicts,
lists, tuples): :func:`grad` and :func:`value_and_grad` differentiate a
pure function and reduce its gradients through the fused buckets, and
:func:`allreduce_gradients_transform` is the optax transform's port form,
a :class:`GradientTransformation` of ``init(params) -> state`` and
``update(grads, state, params=None) -> (grads, state)`` whose state
carries the error-feedback residuals of a quantized ladder.

They differentiate with ``torch.autograd.grad`` over detached copies of
the differentiated leaves marked ``requires_grad``, not with
``torch.func``: the port's autograd Functions (the flash kernels', the
fused loss's, the collectives') are of the ``forward(ctx, ...)`` form,
which ``torch.func`` transforms refuse. A leaf the value does not depend
on gets a zero gradient, as under ``jax.grad``.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from horovod_tpu_torch._pytree import flatten as _flatten
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (InvalidArgumentError,
                                                 PreconditionError)
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import (Compression,
                                                       is_dcn_wire)
from horovod_tpu_torch.distributed.fusion import (BucketExchange,
                                                  ef_residual_specs,
                                                  fused_reduce, hook_grad,
                                                  release_grad_hooks,
                                                  resolve_hierarchical,
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
        self._hvd_hooks_on = True
        self._hvd_exchange = None
        self._hvd_trainable: list = []
        self._hvd_planned = None
        self._hvd_hooked: dict = {}       # id -> each parameter hooked
        self._hvd_fired = 0
        release_grad_hooks(own)
        self._hvd_plan()
        self._hvd_residuals = None
        if is_dcn_wire(compression):
            trainable = [p for p in own if p.requires_grad]
            ex = self._hvd_exchange or BucketExchange(trainable,
                                                      **self._hvd_reduce)
            if ex.hier:
                dev = trainable[0].device if trainable else basics.device()
                self._hvd_residuals = [torch.zeros_like(spec, device=dev)
                                       for spec in ex.residual_specs()]
                self._hvd_res_ids = [id(p) for p in trainable]

    @property
    def residuals(self):
        """The error-feedback residuals (a list of this rank's float32
        vectors), or ``None`` when no quantized ladder runs."""
        return self._hvd_residuals

    @property
    def hierarchical_inner(self) -> int:
        """The ladder's inner size for the current plan (0: flat)."""
        trainable = [p for p in self._hvd_params if p.requires_grad]
        return (self._hvd_exchange or BucketExchange(
            trainable, **self._hvd_reduce)).hier

    def _hvd_ef(self):
        """The residuals to feed the next exchange; raises when the
        trainable parameters are no longer those they were made for."""
        res = self._hvd_residuals
        if res is not None and [id(p) for p in self._hvd_params
                                if p.requires_grad] != self._hvd_res_ids:
            raise InvalidArgumentError(
                "the trainable parameters changed since the "
                "error-feedback residuals were made for them; build a new "
                "DistributedOptimizer for the new set")
        return res

    def state_dict(self):
        state = super(self.__class__, self).state_dict()
        if self._hvd_residuals is not None:
            state["hvd_residuals"] = [r.detach().clone()
                                      for r in self._hvd_residuals]
        return state

    def load_state_dict(self, state_dict):
        state = dict(state_dict)
        res = state.pop("hvd_residuals", None)
        super(self.__class__, self).load_state_dict(state)
        if res is None:
            return
        own = self._hvd_residuals
        if own is None or [tuple(r.shape) for r in res] != [
                tuple(r.shape) for r in own]:
            raise InvalidArgumentError(
                "the state's error-feedback residuals "
                f"{[tuple(r.shape) for r in res]} are not this "
                "optimizer's "
                f"{None if own is None else [tuple(r.shape) for r in own]}")
        with torch.no_grad():
            for r, x in zip(own, res):
                r.copy_(x)

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
        exchange = BucketExchange(trainable, **self._hvd_reduce)
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
            self._hvd_exchange.set_residuals(self._hvd_ef())
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
            if self._hvd_exchange is not None:
                self._hvd_exchange.set_residuals(self._hvd_ef())
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
            res = self._hvd_ef()
            if res is None:
                reduced = fused_reduce(grads, **self._hvd_reduce)
            else:
                reduced, res = fused_reduce(grads, residuals=res,
                                            **self._hvd_reduce)
                self._hvd_residuals = list(res)
        else:
            reduced = ex.finish(grads.__getitem__)
            if self._hvd_residuals is not None:
                self._hvd_residuals = ex.residuals
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
    own = optimizer.state_dict()
    residuals = own.pop("hvd_residuals", None)
    state = mpi_ops.broadcast_object(own, root_rank)
    if basics.size() > 1:
        # Error-feedback residuals are each rank's own shard: kept.
        if residuals is not None:
            state["hvd_residuals"] = residuals
        optimizer.load_state_dict(state)


# ------------------------------------------------ functional gradient API


class GradientTransformation(NamedTuple):
    """The port form of ``optax.GradientTransformation``: ``init(params)
    -> state`` and ``update(grads, state, params=None) -> (grads,
    state)``, over pytrees of tensors."""

    init: Callable[[Any], Any]
    update: Callable[..., Any]


class _AllreduceState(NamedTuple):
    """State of :func:`allreduce_gradients_transform`. ``residuals`` is
    empty except under a low-bit inter-host codec
    (``Compression.int8``/``.fp8``) on an engaged hierarchical ladder,
    where it carries this rank's error-feedback vectors
    (:func:`~horovod_tpu_torch.distributed.fusion.ef_residual_specs`):
    rank-local state, which :func:`ef_state_partition_specs` marks as
    sharded over the data axis."""

    residuals: tuple = ()


def allreduce_gradients_transform(compression=Compression.none, op=None,
                                  average: bool = True,
                                  fusion_threshold: Optional[int] = None,
                                  overlap: Optional[str] = None,
                                  hierarchical: Optional[str] = None
                                  ) -> GradientTransformation:
    """A :class:`GradientTransformation` that replaces a pytree of
    gradients with their cross-rank reduction through the fused buckets
    (:func:`~horovod_tpu_torch.distributed.fusion.fused_reduce`, named
    ``"grads"``). The arguments are ``fused_reduce``'s. With
    ``Compression.int8``/``.fp8`` on a ladder that ``hierarchical``
    engages, ``init`` gives zero residuals on the parameters' device and
    every ``update`` feeds them through the exchange and returns the new
    ones in its state."""

    def _ef_engaged() -> int:
        if not is_dcn_wire(compression):
            return 0
        return resolve_hierarchical(hierarchical, basics.size())

    def init_fn(params):
        inner = _ef_engaged()
        if not inner:
            return _AllreduceState()
        threshold = (fusion_threshold if fusion_threshold is not None
                     else basics.config().fusion_threshold)
        leaves = _flatten(params)[0]
        dev = leaves[0].device if leaves else basics.device()
        specs = ef_residual_specs(leaves, threshold, basics.size(), inner)
        return _AllreduceState(residuals=tuple(
            torch.zeros_like(spec, device=dev) for spec in specs))

    def update_fn(updates, state, params=None):
        del params
        leaves, spec = _flatten(updates)
        kwargs = dict(average=average, compression=compression, op=op,
                      fusion_threshold=fusion_threshold, overlap=overlap,
                      hierarchical=hierarchical, name="grads")
        if state.residuals:
            reduced, res = fused_reduce(leaves, residuals=state.residuals,
                                        **kwargs)
            state = _AllreduceState(residuals=tuple(res))
        else:
            reduced = fused_reduce(leaves, **kwargs)
        return tree_unflatten(reduced, spec), state

    return GradientTransformation(init_fn, update_fn)


def ef_state_partition_specs(opt_state, axis_name: Optional[str] = None):
    """Partition specs (:class:`~horovod_tpu_torch.parallel.spmd.P`) for
    an optimizer state that may hold :class:`_AllreduceState`
    residuals: each residual gets ``P(axis)`` (rank-local shards),
    every other leaf ``P()``. ``axis_name=None`` takes the bound
    ``LogicalMesh``'s data axis (``"hvd"`` with none bound)."""
    from horovod_tpu_torch.parallel.logical import module_axis
    from horovod_tpu_torch.parallel.spmd import P

    axis_name = module_axis("data", axis_name)

    def spec_for(node):
        if isinstance(node, _AllreduceState):
            return _AllreduceState(residuals=tuple(
                P(axis_name) for _ in node.residuals))
        return P()

    return tree_map(spec_for, opt_state,
                    is_leaf=lambda n: isinstance(n, _AllreduceState))


def _differentiate(loss_fn, argnums, has_aux: bool, args, kwargs):
    """``(value, aux, grads)`` of ``loss_fn(*args, **kwargs)`` with
    respect to the arguments ``argnums`` names (an int, or a tuple of
    them for a tuple of gradient trees)."""
    nums = tuple(argnums) if isinstance(argnums, (tuple, list)) \
        else (argnums,)
    args = list(args)
    inputs, specs = [], []
    for i in nums:
        leaves, spec = tree_flatten(args[i])
        for x in leaves:
            if not (torch.is_tensor(x) and x.is_floating_point()):
                raise TypeError(
                    f"grad requires floating-point tensor inputs; argument "
                    f"{i} holds a {type(x).__name__}"
                    + (f" of {x.dtype}" if torch.is_tensor(x) else ""))
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        args[i] = tree_unflatten(leaves, spec)
        inputs.append(leaves)
        specs.append(spec)
    with torch.enable_grad():
        out = loss_fn(*args, **kwargs)
        value, aux = (out[0], out[1]) if has_aux else (out, None)
        if not (torch.is_tensor(value) and value.numel() == 1):
            raise TypeError(
                "grad requires a function with a scalar tensor output, "
                f"got {type(value).__name__}"
                + (f" of shape {tuple(value.shape)}"
                   if torch.is_tensor(value) else ""))
        flat = [x for leaves in inputs for x in leaves]
        got = torch.autograd.grad(value, flat, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(flat, got)]
    trees, at = [], 0
    for leaves, spec in zip(inputs, specs):
        trees.append(tree_unflatten(got[at:at + len(leaves)], spec))
        at += len(leaves)
    grads = tuple(trees) if isinstance(argnums, (tuple, list)) else trees[0]
    if aux is not None:
        aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a,
                       aux)
    return value.detach(), aux, grads


def _reduce_tree(grads):
    leaves, spec = _flatten(grads)
    return tree_unflatten(fused_reduce(leaves, average=True, name="grads"),
                          spec)


def grad(loss_fn, argnums=0, has_aux: bool = False):
    """``jax.grad`` with cross-rank gradient averaging: the returned
    function differentiates ``loss_fn`` (a pure function of pytrees of
    tensors with a scalar result) with respect to ``argnums`` and
    averages the gradient leaves across ranks through the fused buckets
    (Horovod's ``DistributedGradientTape``). With ``has_aux`` it
    returns ``(grads, aux)``."""

    def wrapped(*args, **kwargs):
        _, aux, grads = _differentiate(loss_fn, argnums, has_aux, args,
                                       kwargs)
        grads = _reduce_tree(grads)
        return (grads, aux) if has_aux else grads

    return wrapped


def value_and_grad(loss_fn, argnums=0, has_aux: bool = False):
    """``jax.value_and_grad`` with cross-rank-averaged gradients: returns
    ``(value, grads)`` (``((value, aux), grads)`` with ``has_aux``).
    Inside an SPMD region the value (not the aux) is averaged over the
    region's axis too; outside one it is this rank's own, as in the JAX
    package."""

    def wrapped(*args, **kwargs):
        value, aux, grads = _differentiate(loss_fn, argnums, has_aux, args,
                                           kwargs)
        grads = _reduce_tree(grads)
        if basics.current_spmd_axis() is not None:
            value = mpi_ops.allreduce(value)
        return ((value, aux) if has_aux else value), grads

    return wrapped
