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

Usage (images)::

    model = resnet.build("resnet50", fused_bn=True)
    opt = create_train_state(model, torch.optim.SGD(model.parameters(),
                                                    lr=0.01, momentum=0.9))
    step = make_image_train_step(model, opt, average_loss=False)
    metrics = step({"image": images, "label": labels})  # NHWC, per rank
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


def next_token_loss(logits, tokens):
    """Mean next-token NLL in float32: ``log_softmax(logits[:, :-1])``
    scored against ``tokens[:, 1:]``."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())
    return nll.mean()


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
                       root_rank: int = 0, device: DeviceLike = None):
    """Ready ``model`` and ``optimizer`` for data-parallel training on
    ``device`` (``None`` = the card; raises without one): the model's
    parameters must lie there; with ``distributed`` the optimizer is
    wrapped in :func:`DistributedOptimizer` and ``root_rank``'s
    parameters are broadcast to every rank. Returns the optimizer to
    step with (the model holds the parameters)."""
    dev = resolve_device(device)
    basics.config()                       # raises before hvd.init()
    wrong = [n for n, p in model.named_parameters()
             if p.device.type != dev.type]
    if wrong:
        raise ValueError(f"parameters {wrong[:3]} are not on {dev}")
    if not distributed:
        return optimizer
    optimizer = DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, overlap=overlap,
        hierarchical=hierarchical)
    broadcast_parameters(model.state_dict(), root_rank)
    return optimizer


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    average_loss: bool = True):
    """The per-rank step: ``step(tokens [B, L]) -> loss``: forward, the
    next-token loss, backward, the optimizer's (distributed) step, and
    the loss averaged across ranks."""

    def train_step(tokens):
        optimizer.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        if average_loss:
            loss = mpi_ops.allreduce(loss, average=True, name="train.loss")
        return loss

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

    return train_step
