"""Data-parallel training steps: the transformer_lm and image lanes of
the JAX package's ``bench.py`` with the parts of
``horovod_tpu.models.train`` they use.

Usage (LM)::

    import horovod_tpu_torch.distributed as hvd
    hvd.init()                                        # NCCL on the card
    model = TransformerLM(..., attn_fn=partial(flash_attention, causal=True))
    opt = create_train_state(model, torch.optim.Adam(model.parameters(),
                                                     lr=1e-4))
    step = make_train_step(model, opt)
    loss = step(tokens)                               # [B, L] per rank

``make_train_step(..., fused_ce=True)`` scores the tokens with the chunked
fused cross-entropy (no ``[B, L, V]`` logits), and
``create_train_state(..., zero=True)`` shards the optimizer state over the
ranks (``distributed.zero``) in place of ``DistributedOptimizer``.

Usage (images)::

    model = resnet.build("resnet50", fused_bn=True)
    opt = create_train_state(model, torch.optim.SGD(model.parameters(),
                                                    lr=0.01, momentum=0.9))
    step = make_image_train_step(model, opt, average_loss=False)
    metrics = step({"image": images, "label": labels})  # NHWC, per rank
    ev = make_eval_step(model)(TrainState.from_model(model, opt), batch)
    # {"loss", "correct", "count"}: allreduce the sums for totals

Any zoo model works here (``models.build("inception_v3",
fused_bn=True)``, ``"vgg16"``, ``"vit_b16"``, ...).

Windows (``make_windowed_train_step`` / ``make_windowed_image_train_step``,
or ``hvd.run_steps``) run K steps as CUDA graph replays of one captured
step (:mod:`horovod_tpu_torch.distributed.window`).

The train state (the JAX package's ``TrainState``, ``apply_gradients``
and ``state_partition_specs``)::

    opt = create_train_state(model, torch.optim.Adam(
        model.parameters(), lr=torch.tensor(1e-4, device="cuda"),
        capturable=True))
    state = TrainState.from_model(model, opt)     # a live view, no copy
    opt.zero_grad()
    loss = ...
    loss.backward()                               # the hooks' buckets go
    state = apply_gradients(opt, state)           # .grad, reduced

A :class:`TrainState` is a dict whose leaves are the model's and the
optimizer's own tensors, so an update in place (``optimizer.step()``, a
replayed CUDA graph) is what a snapshot, a checkpoint or ``save_model``
of it reads next.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

import torch.nn.functional as F

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch._pytree import register_sorted_dict
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.optimizer import (
    DistributedOptimizer, _AllreduceState, broadcast_parameters,
    ef_state_partition_specs)
from horovod_tpu_torch.distributed.zero import (ZeroOptimizer,
                                                sharded_distributed_optimizer)
from horovod_tpu_torch.ops.xent import fused_cross_entropy


def next_token_loss(logits, tokens):
    """Mean next-token NLL in float32: ``log_softmax(logits[:, :-1])``
    scored against ``tokens[:, 1:]``."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())
    return nll.mean()


# Tokens a chunk of the lane's fused loss, chosen on the card
# (``python -m horovod_tpu_torch.tune_xent``; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md): at the GPT-2-small head (16,376 tokens, vocab 32000)
# the loss takes 80.7-80.9 ms at the JAX default of 512, 74.9-75.3 at
# 2048 and 72.1-74.1 at 4096, and holds 0.40, 0.99 and 1.77 GB beyond its
# inputs (the unfused loss 52.3-52.7 ms and 6.29 GB): 2048 is the largest
# chunk under 1 GB.
FUSED_CE_CHUNK = 2048


def fused_next_token_loss(model, tokens, t_chunk: Optional[int] = None):
    """:func:`next_token_loss` without the ``[B, L, V]`` logits, as the
    JAX lane's ``--fused-ce`` builds it (``bench.py:449-462``): the model's
    float32 final hidden states ``hidden[:, :-1]`` as ``[B (L - 1), E]``,
    the float32 head ``lm_head.weight [V, E]`` and the targets
    ``tokens[:, 1:]``, through the chunked
    :func:`~horovod_tpu_torch.ops.xent.fused_cross_entropy`, in chunks of
    ``t_chunk`` tokens (``FUSED_CE_CHUNK`` by default)."""
    if t_chunk is None:
        t_chunk = FUSED_CE_CHUNK
    hidden = model(tokens, return_hidden=True)
    e = hidden.shape[-1]
    h = hidden[:, :-1].reshape(-1, e).float()
    return fused_cross_entropy(h, model.lm_head.weight.float(),
                               tokens[:, 1:].reshape(-1), t_chunk)


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy against integer labels, in float32: a
    log-softmax scored against one-hot labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    return -(onehot * logp).sum(-1).mean()


class TrainState(Dict[str, object]):
    """The train state as a dict of the live tensors: ``params``
    (``{name: parameter}``), ``batch_stats`` (``{name: buffer}``, e.g.
    BatchNorm's running statistics), ``opt_state`` and ``step`` (a 0-d
    int32 tensor on the parameters' device). Registered as a pytree with
    sorted keys, as the JAX package's ``TrainState`` is. Build it with
    :meth:`from_model`.

    ``opt_state`` holds the optimizer's per-parameter state tensors by
    parameter name (a ZeRO optimizer's, over its shards, under ``"zero"``
    by dtype), the tensor-valued hyperparameters of each param group
    (a list under ``"hyperparams"``, where any group has one) and a
    quantized ladder's error-feedback residuals (``"hvd_residuals"``, an
    ``_AllreduceState``)."""

    @classmethod
    def from_model(cls, model: torch.nn.Module, optimizer, step: int = 0
                   ) -> "TrainState":
        """The live state of ``model`` and ``optimizer`` (plain, wrapped
        by ``DistributedOptimizer`` or a ZeRO optimizer). Torch creates
        an optimizer's state at its first ``step()``; this creates it now,
        as that step would (Adam/AdamW, and SGD with momentum and no
        dampening; another class raises ``NotImplementedError``), so the
        state's structure is fixed from step 0. The optimizers of
        :mod:`horovod_tpu_torch.training.optim` make theirs in its own
        dtype (a bfloat16 momentum or first moment)."""
        params = dict(model.named_parameters())
        names = {id(p): n for n, p in params.items()}
        zero = isinstance(optimizer, ZeroOptimizer)
        inner = optimizer.inner if zero else optimizer
        # A ZeRO shard takes no gradient from autograd: all of them step.
        _materialise(inner, every=zero)
        opt_state: dict = {}
        if zero:
            opt_state["zero"] = {key: dict(inner.state[leaf])
                                 for key, leaf in optimizer._leaves.items()
                                 if inner.state.get(leaf)}
        else:
            for group in inner.param_groups:
                for p in group["params"]:
                    if id(p) not in names:
                        raise ValueError(
                            "the optimizer holds a parameter the model "
                            "does not name")
                    if inner.state.get(p):
                        opt_state[names[id(p)]] = dict(inner.state[p])
        hyper = [{k: v for k, v in g.items() if isinstance(v, torch.Tensor)}
                 for g in inner.param_groups]
        for key, value in (("hyperparams", hyper if any(hyper) else None),
                           ("hvd_residuals", _residual_state(optimizer))):
            if value is None:
                continue
            if key in opt_state:
                raise ValueError(f"a parameter is named {key!r}, the "
                                 "optimizer state's own key")
            opt_state[key] = value
        dev = (next(iter(params.values())).device if params
               else torch.device("cpu"))
        return cls(params=params, batch_stats=dict(model.named_buffers()),
                   opt_state=opt_state,
                   step=torch.tensor(step, dtype=torch.int32, device=dev))


register_sorted_dict(TrainState)


def _residual_state(optimizer):
    res = getattr(optimizer, "residuals", None)
    return None if res is None else _AllreduceState(residuals=tuple(res))


def _materialise(optimizer: torch.optim.Optimizer,
                 every: bool = False) -> None:
    """Create ``optimizer``'s per-parameter state for every parameter
    that requires a gradient (``every``: for every parameter), as its
    ``_init_group`` would at the first step; a parameter that has state
    keeps it."""
    from torch.optim.optimizer import _get_scalar_dtype

    adam = isinstance(optimizer, torch.optim.Adam)
    if not adam and not isinstance(optimizer, torch.optim.SGD):
        raise NotImplementedError(
            f"TrainState.from_model creates the optimizer's state before "
            f"its first step for SGD, Adam and AdamW only, not "
            f"{type(optimizer).__name__} (ROADMAP.md Queue 3, deliberate "
            "differences)")
    for group in optimizer.param_groups:
        if not adam and group["momentum"] != 0 and group["dampening"] != 0:
            raise ValueError(
                "SGD with momentum and dampening != 0 starts its buffer as "
                "the first gradient, which no zero state equals; "
                "TrainState.from_model needs dampening=0")
        for p in group["params"]:
            if optimizer.state.get(p) or not (every or p.requires_grad):
                continue
            if hasattr(optimizer, "init_param_state"):
                # training.optim's classes: state in its own dtype.
                optimizer.init_param_state(p, group)
                continue
            state = optimizer.state[p]
            if not adam:
                if group["momentum"] != 0:
                    state["momentum_buffer"] = torch.zeros_like(p)
                continue
            if group["capturable"] or group["fused"]:
                state["step"] = torch.zeros(
                    (), dtype=_get_scalar_dtype(is_fused=group["fused"]),
                    device=p.device)
            else:
                state["step"] = torch.tensor(0.0, dtype=_get_scalar_dtype())
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def apply_gradients(optimizer, state: TrainState, grads=None,
                    batch_stats=None) -> TrainState:
    """The update tail of a training step, in place: ``grads`` (by
    parameter name, from ``torch.autograd.grad``) become the parameters'
    ``.grad`` (a parameter absent from them gets None); ``None`` takes
    the ``.grad`` that ``loss.backward()`` left, whose gradient hooks
    (``DistributedOptimizer(named_parameters=...)``) have issued the
    exchange's buckets during the backward pass. Then ``optimizer``
    steps (a ``DistributedOptimizer`` or ZeRO wrapper reduces the
    gradients there, as the JAX package's wrapped optax chain does),
    ``batch_stats`` (by buffer name) are copied in, and ``state["step"]``
    advances by a device op (a replayed window advances it). Returns
    ``state``."""
    if grads is not None:
        for name, p in state["params"].items():
            p.grad = grads.get(name)
    optimizer.step()
    if batch_stats is not None:
        own = state["batch_stats"]
        with torch.no_grad():
            torch._foreach_copy_([own[k] for k in batch_stats],
                                 list(batch_stats.values()))
    state["step"].add_(1)
    return state


def state_partition_specs(state: TrainState) -> TrainState:
    """Partition specs (:class:`~horovod_tpu_torch.parallel.spmd.P`) for
    a :class:`TrainState`: ``P()`` for the params, batch statistics and
    step, and for each optimizer-state leaf, except the rank-local ones:
    a ZeRO optimizer's shards (its 1-D state vectors) and a quantized
    ladder's error-feedback residuals get ``P(data axis)``, the data axis
    resolved through the bound ``LogicalMesh`` (``"hvd"`` with none
    bound)."""
    from torch.utils._pytree import tree_map

    from horovod_tpu_torch.parallel.logical import module_axis
    from horovod_tpu_torch.parallel.spmd import P

    axis = module_axis("data")
    opt_spec = {k: v for k, v in ef_state_partition_specs(
        state["opt_state"], axis_name=axis).items() if k != "zero"}
    if "zero" in state["opt_state"]:
        opt_spec["zero"] = tree_map(
            lambda t: P(axis) if t.dim() == 1 else P(),
            state["opt_state"]["zero"])
    return TrainState(params=P(), batch_stats=P(), opt_state=opt_spec,
                      step=P())


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       distributed: bool = True,
                       compression=Compression.none,
                       backward_passes_per_step: int = 1,
                       overlap: Optional[str] = None,
                       hierarchical: Optional[str] = None,
                       root_rank: int = 0, device: DeviceLike = None,
                       zero: bool = False):
    """Ready ``model`` and ``optimizer`` for data-parallel training on
    ``device`` (``None`` = the card; raises without one): the model's
    parameters must lie there; with ``distributed`` the optimizer is
    wrapped in :func:`DistributedOptimizer` and ``root_rank``'s
    parameters are broadcast to every rank. With ``zero`` it is wrapped in
    the ZeRO-1 :func:`sharded_distributed_optimizer` instead, after the
    broadcast; ``overlap`` and ``hierarchical`` do not apply there (as in
    the JAX package). Returns the optimizer to step with (the model holds
    the parameters).

    ``hierarchical`` (auto|on|off) runs each gradient bucket as the
    intra-host / inter-host ladder; with ``compression=Compression.int8``
    or ``.fp8`` on an engaged ladder the returned optimizer holds this
    rank's error-feedback residuals (``optimizer.residuals``), which every
    step of :func:`make_train_step` feeds through the exchange and
    ``state_dict()`` carries."""
    dev = resolve_device(device)
    basics.config()                       # raises before hvd.init()
    wrong = [n for n, p in model.named_parameters()
             if p.device.type != dev.type]
    if wrong:
        raise ValueError(f"parameters {wrong[:3]} are not on {dev}")
    if not distributed:
        return optimizer
    if zero:
        if backward_passes_per_step != 1:
            raise ValueError("zero=True takes one backward pass a step")
        broadcast_parameters(model.state_dict(), root_rank)
        return sharded_distributed_optimizer(optimizer,
                                             compression=compression)
    optimizer = DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, overlap=overlap,
        hierarchical=hierarchical)
    broadcast_parameters(model.state_dict(), root_rank)
    return optimizer


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    average_loss: bool = True, fused_ce: bool = False):
    """The per-rank step: ``step(tokens [B, L]) -> loss``: forward, the
    next-token loss (:func:`fused_next_token_loss` with ``fused_ce``,
    else :func:`next_token_loss` over the logits), backward, the
    optimizer's (distributed) step, and the loss averaged across ranks."""

    def train_step(tokens):
        optimizer.zero_grad()
        if fused_ce:
            loss = fused_next_token_loss(model, tokens)
        else:
            loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        if average_loss:
            loss = mpi_ops.allreduce(loss, average=True, name="train.loss")
        return loss

    train_step.model, train_step.optimizer = model, optimizer
    return train_step


def make_image_train_step(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer,
                          average_loss: bool = True):
    """The per-rank image step: ``step({"image": [B, H, W, 3], "label":
    [B]}) -> {"loss", "accuracy"}``: a training-mode forward (which
    updates the BatchNorm running statistics, per rank), the
    cross-entropy loss, backward, the optimizer's (distributed) step; with
    ``average_loss`` the loss and accuracy averaged across ranks."""

    def train_step(batch):
        model.train()
        optimizer.zero_grad()
        logits = model(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"])
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            accuracy = (logits.argmax(-1) == batch["label"]).float().mean()
        loss = loss.detach()
        if average_loss:
            loss = mpi_ops.allreduce(loss, average=True, name="train.loss")
            accuracy = mpi_ops.allreduce(accuracy, average=True,
                                         name="train.accuracy")
        return {"loss": loss, "accuracy": accuracy}

    train_step.model, train_step.optimizer = model, optimizer
    return train_step


def make_eval_step(model: torch.nn.Module):
    """The per-rank evaluation step: ``eval_step(state, batch) ->
    {"loss", "correct", "count"}``, float32 tensors: the eval-mode
    forward (running statistics, no dropout) over ``state``'s parameters
    and batch statistics (a :class:`TrainState`; the live one holds the
    model's own tensors), the mean cross-entropy and the summed correct
    predictions and images of ``batch`` (``{"image", "label"}``), for
    the caller to allreduce (the reference's metric average,
    examples/pytorch_mnist.py:120-133). The model's train/eval mode is
    left as it was."""

    def eval_step(state, batch):
        was = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = torch.func.functional_call(
                    model, (state["params"], state["batch_stats"]),
                    (batch["image"],))
        finally:
            model.train(was)
        labels = batch["label"]
        loss = cross_entropy_loss(logits, labels)
        correct = (logits.argmax(-1) == labels).float().sum()
        count = torch.tensor(float(labels.shape[0]), device=logits.device)
        return {"loss": loss, "correct": correct, "count": count}

    eval_step.model = model
    return eval_step


def make_windowed_train_step(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             steps_per_dispatch: int,
                             average_loss: bool = True,
                             fused_ce: bool = False):
    """Window form of :func:`make_train_step`
    (:func:`horovod_tpu_torch.distributed.window.windowed`): the returned
    function takes tokens ``[K, B, L]`` (stage them with
    :func:`horovod_tpu_torch.data.prefetch_windows`) and returns the mean
    loss over the K steps, each step a CUDA graph replay on the card
    (Adam with ``capturable=True`` there). ``steps_per_dispatch=1`` is
    exactly :func:`make_train_step`'s step. For the whole stage-and-run
    loop use ``hvd.run_steps`` directly::

        step = make_train_step(model, optimizer)
        losses = hvd.run_steps(step, batch_iter, steps_per_dispatch=30)
    """
    from horovod_tpu_torch.distributed.window import windowed

    return windowed(make_train_step(model, optimizer, average_loss,
                                    fused_ce), steps_per_dispatch)


def make_windowed_image_train_step(model: torch.nn.Module,
                                   optimizer: torch.optim.Optimizer,
                                   steps_per_dispatch: int,
                                   average_loss: bool = True):
    """Window form of :func:`make_image_train_step`: takes ``{"image":
    [K, B, H, W, 3], "label": [K, B]}`` and returns the loss and accuracy
    means over the K steps."""
    from horovod_tpu_torch.distributed.window import windowed

    return windowed(make_image_train_step(model, optimizer, average_loss),
                    steps_per_dispatch)
