"""ResNet-50 "ImageNet" training with the full callback stack (reference
examples/keras_imagenet_resnet50.py), the port of
``examples/flax_imagenet_resnet50.py``.

The keras-binding analogue end to end: BroadcastGlobalVariables at train
start, gradual LR warm-up to lr x size, staircase decay, epoch-end metric
averaging, rank-0 checkpointing with the resume epoch broadcast
(reference :66-103). The data is synthetic; swap ``data_fn`` for a real
input pipeline.

Run:  python -m horovod_tpu_torch.examples.imagenet_resnet50 --smoke
      (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch import training
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.train import (TrainState, apply_gradients,
                                            create_train_state,
                                            cross_entropy_loss)
from horovod_tpu_torch.training import callbacks as cb


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-card batch size")
    parser.add_argument("--base-lr", type=float, default=0.0125,
                        help="per-card lr (reference :33)")
    parser.add_argument("--warmup-epochs", type=float, default=1.0)
    parser.add_argument("--steps-per-epoch", type=int, default=8)
    # Under the temporary directory (which follows TMPDIR), so that two
    # checkouts with TMPDIRs of their own never resume from each other.
    parser.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_resnet50.msgpack"))
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes for CI")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    examples.init(args.device)
    n, dev = hvd.size(), basics.device()
    log = print if hvd.rank() == 0 else (lambda *a, **k: None)

    size = 32 if args.smoke else 224
    classes = 10 if args.smoke else 1000
    model = (resnet.build("resnet18", num_classes=classes,
                          dtype=torch.float32, seed=0, device=dev)
             if args.smoke else
             resnet.build("resnet50", num_classes=classes,
                          dtype=torch.bfloat16, seed=0, device=dev))
    # A tensor lr, so the LR callbacks can steer it (the JAX example's
    # optax.inject_hyperparams); it is scaled by size, and the warm-up
    # ramps up to it (reference :97,136-153). SGD reads it on the host.
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(),
                               lr=torch.tensor(args.base_lr * n),
                               momentum=0.9), device=dev)
    state = TrainState.from_model(model, opt)

    def train_step(state, batch):
        model.train()
        opt.zero_grad()
        logits = model(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"])
        loss.backward()
        apply_gradients(opt, state)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["label"]).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    data_rng = np.random.RandomState(hvd.rank())

    def data_fn(epoch):
        for _ in range(args.steps_per_epoch):
            yield {
                "image": torch.tensor(data_rng.randn(
                    args.batch_size, size, size, 3).astype(np.float32),
                    device=dev),
                "label": torch.tensor(data_rng.randint(
                    0, classes, size=args.batch_size), device=dev),
            }

    # Resume: restore, broadcast, skip the completed epochs (reference
    # :66-103, resume_from_epoch).
    start_epoch = 0
    if os.path.exists(args.checkpoint):
        state = training.load_model(args.checkpoint, state)
        start_epoch = int(hvd.broadcast_object(
            int(state["step"]) // args.steps_per_epoch, root_rank=0))
        log(f"Resuming from epoch {start_epoch}")

    class CheckpointCallback(cb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            training.save_model(args.checkpoint, self.loop.state)

    loop = training.TrainLoop(
        state, train_step, data_fn,
        callbacks=[
            cb.BroadcastGlobalVariablesCallback(0),
            cb.LearningRateWarmupCallback(
                warmup_epochs=args.warmup_epochs,
                steps_per_epoch=args.steps_per_epoch, verbose=1),
            cb.LearningRateScheduleCallback(
                multiplier=lambda e: 0.1 ** (e // 30),
                start_epoch=args.warmup_epochs),
            cb.MetricAverageCallback(),
            CheckpointCallback(),
        ])
    history = loop.fit(args.epochs - start_epoch)
    log("history:", [{k: round(float(v), 4) for k, v in h.items()}
                     for h in history])
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
