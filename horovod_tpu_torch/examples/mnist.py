"""MNIST-style data-parallel training (reference
examples/pytorch_mnist.py), the port of ``examples/jax_mnist.py``.

The "single-card script + 4 lines = distributed" demo: init, wrap the
optimizer, broadcast the initial state, shard the batch. The dataset is
the JAX example's synthetic MNIST stand-in (class templates + noise,
:func:`make_dataset`, the same numpy draws).

Run:  python -m horovod_tpu_torch.examples.mnist [--epochs 3]
      hvdrun-torch -np 2 python -m horovod_tpu_torch.examples.mnist
      (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch import data as hvd_data
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.mnist import MNISTNet
from horovod_tpu_torch.models.train import (TrainState, create_train_state,
                                            make_eval_step,
                                            make_image_train_step)
from horovod_tpu_torch.parallel.logical import DATA_AXIS
from horovod_tpu_torch.parallel.spmd import P


def make_dataset(n: int, num_classes: int = 10, seed: int = 0):
    """Learnable synthetic digits: one fixed random template per class
    (shared by train and test) + per-sample gaussian noise."""
    templates = np.random.RandomState(0).randn(
        num_classes, 28, 28, 1).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n)
    images = templates[labels] + 0.3 * rng.randn(n, 28, 28, 1).astype(
        np.float32)
    return images, labels.astype(np.int32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-card batch size")
    parser.add_argument("--lr", type=float, default=0.005)
    parser.add_argument("--momentum", type=float, default=0.5)
    parser.add_argument("--train-size", type=int, default=4096)
    parser.add_argument("--test-size", type=int, default=1024)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    examples.init(args.device)                         # Horovod step 1
    n, dev = hvd.size(), basics.device()
    log = print if hvd.rank() == 0 else (lambda *a, **k: None)

    model = MNISTNet(seed=42, device=dev)
    # Horovod step 2: DistributedOptimizer wrap, with the reference's
    # lr x size scaling (pytorch_mnist.py:106); step 3, the broadcast of
    # rank 0's initial weights, happens inside create_train_state.
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=args.lr * n,
                               momentum=args.momentum), device=dev)
    train_step = make_image_train_step(model, opt)
    eval_step = make_eval_step(model)

    def run_eval(state, batch):
        # Per-rank sums, then the cross-rank total: the reference's
        # metric averaging pattern (pytorch_mnist.py:120-133).
        def step(state, batch):
            m = eval_step(state, batch)
            # hvdlint: disable=HVD006 (two named scalar sums an eval)
            return {k: hvd.allreduce(v, op=hvd.Sum, name=f"eval.{k}")
                    for k, v in m.items()}

        return hvd.spmd_run(step, state, batch,
                            in_specs=(P(), P(DATA_AXIS)),
                            out_specs=P())

    images, labels = make_dataset(args.train_size)
    test_images, test_labels = make_dataset(args.test_size, seed=1)
    global_batch = args.batch_size * n
    if args.train_size // global_batch == 0:
        raise SystemExit(
            f"global batch {global_batch} ({args.batch_size}/card x {n} "
            f"cards) exceeds --train-size {args.train_size}; lower the "
            "batch size or enlarge the dataset")
    # This rank's share of the test set (the JAX example shards it
    # P("hvd") over the chips).
    per = args.test_size // n
    rows = slice(hvd.rank() * per, (hvd.rank() + 1) * per)
    test = {"image": torch.tensor(test_images[rows], device=dev),
            "label": torch.tensor(test_labels[rows], device=dev)}
    state = TrainState.from_model(model, opt)
    acc = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        # Each rank iterates its own slice of every global batch, with
        # one host-to-device copy in flight while the step computes.
        batches = hvd_data.iterate_sharded(
            {"image": images, "label": labels}, args.batch_size,
            epoch=epoch)
        for batch in hvd_data.prefetch_to_device(batches, size=2,
                                                 device=dev):
            metrics = hvd.spmd_run(train_step, batch, in_specs=P(DATA_AXIS),
                                   out_specs=P())
        m = run_eval(state, test)
        acc = float(m["correct"]) / float(m["count"])
        log(f"Epoch {epoch + 1}: loss={float(metrics['loss']):.4f} "
            f"test_acc={acc:.4f} ({time.time() - t0:.1f}s)")

    hvd.shutdown()
    if acc < 0.9:
        log("WARNING: final accuracy below 0.9", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
