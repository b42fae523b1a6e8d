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

Windows (``make_windowed_train_step`` / ``make_windowed_image_train_step``,
or ``hvd.run_steps``) run K steps as CUDA graph replays of one captured
step (:mod:`horovod_tpu_torch.distributed.window`).
"""

from __future__ import annotations

from typing import Optional

import torch

import torch.nn.functional as F

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed import mpi_ops
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.optimizer import (DistributedOptimizer,
                                                     broadcast_parameters)
from horovod_tpu_torch.distributed.zero import sharded_distributed_optimizer
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
