"""Optimizers whose state is kept in a narrower dtype than the parameters:
the port's counterparts of ``optax.sgd(lr, momentum,
accumulator_dtype=...)`` (``optax.trace``) and ``optax.adam(lr,
mu_dtype=...)`` (``optax.scale_by_adam``), which the JAX bench's
``--bf16-momentum`` asks for.

optax forms the new trace (SGD) or first moment (Adam) in float32 from
the stored state and the float32 gradient, takes this step's update from
that unrounded value, and rounds only what it stores. In ``decay *
state`` the weakly typed Python float takes the state's dtype (0.9
becomes 0.8984375 in bfloat16); the JAX lanes' compiled update keeps
the product unrounded (XLA's excess precision), so here it is formed in
float32 from the rounded scalar. ``torch.optim.SGD``
and ``Adam`` with a bfloat16 buffer would round before the update, so
these are subclasses with their own ``step()`` in plain torch ops::

    opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
              momentum_dtype=torch.bfloat16)
    opt = Adam(model.parameters(), lr=1e-4, mu_dtype=torch.bfloat16,
               capturable=True)          # on the card, under a window

The parameters stay in their own dtype (float32), and so does Adam's
second moment. With no state dtype given the state takes the parameter's
dtype and the arithmetic is still optax's, which differs from torch's
by rounding (optax scales the update by ``-lr`` and adds it; Adam forms
``(1 - b1) g + b1 m`` where torch lerps).

Adam with ``capturable=True`` keeps each step count as a float32 tensor
on the parameter's device and computes the bias corrections there, so a
CUDA graph replays the update (:mod:`horovod_tpu_torch.distributed.
window`); otherwise the step count is a CPU tensor, as torch keeps it,
and a capture raises. A tensor ``lr`` is read on the device by both
classes. Both subclass their torch class, so ``DistributedOptimizer``,
``sharded_distributed_optimizer``, ``TrainState.from_model`` and the LR
callbacks take them as they take torch's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

def _params_with_grad(group):
    return [p for p in group["params"] if p.grad is not None]


def _grads(params, group) -> List[torch.Tensor]:
    grads = [p.grad for p in params]
    if group.get("maximize"):
        grads = torch._foreach_neg(grads)
    if group["weight_decay"] != 0:
        grads = torch._foreach_add(grads, params,
                                   alpha=group["weight_decay"])
    return grads


def _apply_lr(params, updates, lr) -> None:
    """``p += -lr * u``, as optax's ``scale(-lr)`` then
    ``apply_updates``; a tensor ``lr`` stays on the device."""
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(params, updates)


def _decayed(states, decay: float) -> List[torch.Tensor]:
    """``decay * state`` in float32 as the JAX lanes' compiled optax
    update forms it: the scalar rounded to the state's dtype (JAX's
    weakly typed Python float), the product unrounded. New tensors: the
    state is not written."""
    scalars = {}
    for s in states:
        if s.dtype not in scalars:
            scalars[s.dtype] = float(torch.tensor(decay, dtype=s.dtype))
    return torch._foreach_mul(
        [s if s.dtype == torch.float32 else s.float() for s in states],
        [scalars[s.dtype] for s in states])


def _f32_bias(beta: float, step: float) -> float:
    """``1 - beta ** step`` in float32."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))


class _NarrowState:
    """What both classes share: the state dtype in every param group
    (``state_dtype``), state made in it, and a ``load_state_dict`` that
    keeps it."""

    #: The per-parameter state key kept in ``state_dtype``.
    _key: str

    def _init_dtype(self, state_dtype) -> None:
        self.defaults["state_dtype"] = state_dtype
        for group in self.param_groups:
            group.setdefault("state_dtype", state_dtype)
            if group.get("fused") or group.get("differentiable"):
                raise ValueError(f"{type(self).__name__} runs its own "
                                 "update: fused and differentiable are "
                                 "not supported")

    @staticmethod
    def narrow_dtype(group, p) -> torch.dtype:
        """The dtype of the narrow state of ``p`` in ``group``."""
        return group.get("state_dtype") or p.dtype

    def init_param_state(self, p, group) -> None:
        """Create ``p``'s state at its zero value (the optimizer's state
        before a first step; :class:`TrainState` calls this)."""
        raise NotImplementedError

    def load_state_dict(self, state_dict):
        """torch's ``load_state_dict``, which casts every floating state
        tensor to its parameter's dtype, then the narrow state cast back
        to the group's state dtype."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st and self._key in st:
                    st[self._key] = st[self._key].to(
                        self.narrow_dtype(group, p))


class SGD(_NarrowState, torch.optim.SGD):
    """``torch.optim.SGD`` with its momentum buffer in ``momentum_dtype``
    (optax ``sgd(lr, momentum, nesterov, accumulator_dtype)``): the new
    buffer ``g + momentum * buf`` is formed in float32 (the momentum
    rounded to the buffer's dtype, as optax's scalar is), the update
    reads it unrounded, and the buffer stores it rounded to its dtype.
    ``dampening`` must be 0 (optax's trace has none)."""

    _key = "momentum_buffer"

    def __init__(self, params, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, *, maximize=False,
                 momentum_dtype: Optional[torch.dtype] = None):
        super().__init__(params, lr=lr, momentum=momentum,
                         dampening=dampening, weight_decay=weight_decay,
                         nesterov=nesterov, maximize=maximize, foreach=False)
        self._init_dtype(momentum_dtype)
        if any(g["dampening"] != 0 for g in self.param_groups):
            raise ValueError("SGD with a state dtype takes dampening=0 "
                             "(optax.trace has none)")

    def init_param_state(self, p, group) -> None:
        if group["momentum"] != 0:
            self.state[p]["momentum_buffer"] = torch.zeros_like(
                p, dtype=self.narrow_dtype(group, p),
                memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = _params_with_grad(group)
            if not params:
                continue
            grads = _grads(params, group)
            mom = group["momentum"]
            if mom == 0:
                _apply_lr(params, [g.clone() for g in grads], group["lr"])
                continue
            for p in params:
                if "momentum_buffer" not in self.state[p]:
                    self.init_param_state(p, group)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            new = _decayed(bufs, mom)
            torch._foreach_add_(new, grads)
            # Stored rounded first, so the update can scale ``new`` in
            # place.
            torch._foreach_copy_(bufs, new)
            updates = (torch._foreach_add(grads, torch._foreach_mul(
                new, mom)) if group["nesterov"] else new)
            _apply_lr(params, updates, group["lr"])
        return loss


class Adam(_NarrowState, torch.optim.Adam):
    """``torch.optim.Adam`` with its first moment in ``mu_dtype``
    (optax ``adam(lr, b1, b2, eps, mu_dtype=...)``, optax's arithmetic):
    ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu`` in
    float32, the update ``-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)``
    from the unrounded ``mu``, and ``mu`` stored rounded to its dtype;
    ``nu`` stays float32. ``weight_decay`` is torch's (added to the
    gradient); ``amsgrad`` is not supported."""

    _key = "exp_avg"

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, *, maximize=False, capturable=False,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, maximize=maximize,
                         capturable=capturable, foreach=False)
        self._init_dtype(mu_dtype)
        if any(g["amsgrad"] for g in self.param_groups):
            raise ValueError("Adam with a state dtype has no amsgrad")

    def init_param_state(self, p, group) -> None:
        st = self.state[p]
        st["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                      if group["capturable"] else torch.tensor(0.0))
        st["exp_avg"] = torch.zeros_like(
            p, dtype=self.narrow_dtype(group, p),
            memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(
            p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = _params_with_grad(group)
            if not params:
                continue
            capturable = group["capturable"]
            if (not capturable and params[0].is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "Adam with capturable=False inside a CUDA graph "
                    "capture: its step count is a host value, which the "
                    "graph would freeze; construct it with "
                    "capturable=True")
            grads = _grads(params, group)
            b1, b2 = group["betas"]
            for p in params:
                if "exp_avg" not in self.state[p]:
                    self.init_param_state(p, group)
            states = [self.state[p] for p in params]
            steps = [s["step"] for s in states]
            mus = [s["exp_avg"] for s in states]
            nus = [s["exp_avg_sq"] for s in states]
            torch._foreach_add_(steps, 1)
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, _decayed(mus, b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_copy_(nus, torch._foreach_add(sq,
                                                         _decayed(nus, b2)))
            if capturable:
                bc1 = torch._foreach_pow(b1, steps)
                bc2 = torch._foreach_pow(b2, steps)
                for bc in (bc1, bc2):
                    torch._foreach_neg_(bc)
                    torch._foreach_add_(bc, 1)
            else:
                # float32, as optax's bias corrections (and the device
                # form above) compute them.
                bc1 = [_f32_bias(b1, s.item()) for s in steps]
                bc2 = [_f32_bias(b2, s.item()) for s in steps]
            mu_hat = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu_hat, denom)
            torch._foreach_copy_(mus, mu)
            _apply_lr(params, mu_hat, group["lr"])
        return loss


def state_bytes(optimizer) -> dict:
    """``{state key: bytes}`` over the tensors of ``optimizer.state``
    (a ZeRO optimizer's: its shards' state), with the dtype of each key
    as ``{key: dtype name}`` under ``"dtypes"``."""
    out: dict = {}
    dtypes: dict = {}
    for st in optimizer.state.values():
        for k, t in st.items():
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                out[k] = out.get(k, 0) + t.numel() * t.element_size()
                dtypes[k] = str(t.dtype).replace("torch.", "")
    return {**out, "dtypes": dtypes}


__all__ = ["SGD", "Adam", "state_bytes"]
