"""Language-model training with ZeRO-1 sharded optimizer state and
checkpoint/resume, the port of ``examples/jax_transformer_zero.py``.

The full modern data-parallel recipe on one page: every card is a rank,
gradients reduce-scatter instead of allreduce, each rank keeps 1/N of
the AdamW moments, the parameters all-gather after the shard update
(:mod:`horovod_tpu_torch.distributed.zero`), and every rank saves its
shard of the state through the numpy
:class:`~horovod_tpu_torch.checkpoint.CheckpointManager` (in place of the
JAX example's orbax); a second run resumes at the saved step.

Run:    hvdrun-torch -np 2 python -m \\
            horovod_tpu_torch.examples.transformer_zero
Smoke:  ... --smoke (``--device cpu`` on the CPU; the card by default)
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import horovod_tpu_torch.distributed as hvd
from horovod_tpu_torch import examples
from horovod_tpu_torch._pytree import flatten
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.train import (TrainState, apply_gradients,
                                            next_token_loss)
from horovod_tpu_torch.models.transformer import TransformerLM


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-per-chip", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--vocab", type=int, default=1024)
    # Under the temporary directory (which follows TMPDIR), so that two
    # checkouts with TMPDIRs of their own never resume from each other.
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_zero_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--smoke", action="store_true", help="tiny shapes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.smoke:
        args.steps, args.seq_len, args.vocab = 6, 32, 128

    examples.init(args.device)
    n, r, dev = hvd.size(), hvd.rank(), basics.device()

    model = TransformerLM(
        vocab_size=args.vocab, num_layers=2, num_heads=4,
        embed_dim=128 if args.smoke else 512, max_len=args.seq_len,
        dtype=torch.float32, seed=0, device=dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # ZeRO-wrapped AdamW: the reference's one-line DistributedOptimizer
    # swap.
    opt = hvd.sharded_distributed_optimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=0.01))
    state = TrainState.from_model(model, opt)

    def train_step(state, tokens):
        opt.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        apply_gradients(opt, state)
        return state, hvd.allreduce(loss.detach(), name="lm.loss")

    def synth_batch(seed):
        g = np.random.RandomState(seed)
        toks = g.randint(0, args.vocab,
                         (args.batch_per_chip * n, args.seq_len))
        rows = slice(r * args.batch_per_chip, (r + 1) * args.batch_per_chip)
        return torch.tensor(toks[rows], dtype=torch.long, device=dev)

    ckpt = CheckpointManager(args.ckpt_dir, max_to_keep=2,
                             async_save=not args.smoke, backend="numpy")
    start = ckpt.latest_step() or 0
    if start:
        print(f"resuming from step {start}", file=sys.stderr)
        restored = ckpt.restore(start, template=state)
        # Into the live tensors: the model and the optimizer hold them.
        with torch.no_grad():
            torch._foreach_copy_(flatten(state)[0], flatten(restored)[0])

    first = last = None
    for i in range(start, args.steps):
        state, loss = train_step(state, synth_batch(i))
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            ckpt.save(i + 1, state)
        if i % 10 == 0 or i + 1 == args.steps:
            last = float(loss)
            first = first if first is not None else last
            if r == 0:
                print(f"step {i}: loss {last:.4f}", file=sys.stderr)
    ckpt.close()

    if first is not None and last is not None and start < args.steps:
        assert last <= first + 1e-3, (first, last)
        print(f"{last:.4f}")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
