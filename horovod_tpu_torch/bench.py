"""Training benchmark of the port: the transformer_lm lane of the JAX
package's ``bench.py``, on the card.

    python -m horovod_tpu_torch.bench --model transformer_lm \\
        [--attention dense|flash] [--seq-len 2048] [--batch-size 8] ...

One process per card (``torchrun`` sets the world; alone it is a world of
one). The model is ``TransformerLM`` at the JAX lane's defaults
(GPT-2-small width: 12 layers, d_model 768, 12 heads, vocab 32000, seq
2048, 8 sequences per card, bfloat16 compute, float32 parameters),
``torch.optim.Adam(lr=1e-4)`` under ``DistributedOptimizer``, the mean
next-token loss, on one fixed batch of random tokens from a numpy seed.
The reference's timing discipline: ``--num-warmup-batches`` steps, then
``--num-iters`` windows of ``--num-batches-per-iter`` steps with one
``torch.cuda.synchronize()`` per window. Prints one JSON line: tokens/s
per card (the mean over the windows, with the 1.96-sigma spread and the
best window), the step time, the peak memory, the bucket plan, the
resolved attention, whether every rank ends with the same parameters,
and the card's name and power limit.

``--attention auto`` (the JAX lane's dense/flash crossover, measured on a
TPU) waits for the H100 crossover and raises; the ResNet lane waits for
kernel K5 (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import plan_buckets, plan_summary
from horovod_tpu_torch.distributed.mpi_ops import allgather
from horovod_tpu_torch.models.train import create_train_state, make_train_step
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops.attention import flash_attention


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="transformer_lm",
                   choices=["transformer_lm"])
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=8,
                   help="sequences per card")
    p.add_argument("--lm-layers", type=int, default=12)
    p.add_argument("--lm-dim", type=int, default=768)
    p.add_argument("--lm-heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--attention", default="dense",
                   choices=["dense", "flash", "auto"])
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute (default bfloat16)")
    p.add_argument("--overlap", default=None, choices=["auto", "on", "off"],
                   help="HOROVOD_OVERLAP for the gradient buckets")
    p.add_argument("--compression", default="none",
                   choices=["none", "fp16", "bf16"])
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    return p


def card_description(dev: torch.device) -> str:
    """``name, power limit`` as ``nvidia-smi`` reports them (the card's
    name alone when nvidia-smi is missing); ``"cpu"`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return torch.cuda.get_device_name(dev)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        torch.cuda.get_device_name(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, device: DeviceLike = None) -> dict:
    """The lane; returns the record. ``device=None`` is the card."""
    if args.attention == "auto":
        raise NotImplementedError(
            "--attention auto needs the H100 dense/flash crossover, not "
            "measured yet (ROADMAP.md); pass dense or flash")
    dev = resolve_device(device)
    basics.init(device=dev)
    dev = basics.device()
    L, B = args.seq_len, args.batch_size
    attn_fn = None
    if args.attention == "flash":
        attn_fn = functools.partial(flash_attention, causal=True)
    model = TransformerLM(
        vocab_size=args.vocab, num_layers=args.lm_layers,
        num_heads=args.lm_heads, embed_dim=args.lm_dim,
        max_len=max(L, 2048),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        attn_fn=attn_fn, seed=42, device=dev)
    opt = create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-4),
        compression=getattr(Compression, args.compression),
        overlap=args.overlap, device=dev)
    step = make_train_step(model, opt)
    # One global batch of B sequences per rank, each rank its own rows
    # (the JAX lane's sharded [B * n, L] batch).
    n, r = basics.size(), basics.rank()
    tokens = torch.tensor(np.random.default_rng(42).integers(
        0, args.vocab, (B * n, L))[r * B:(r + 1) * B], device=dev)
    wire = getattr(Compression, args.compression)
    plan = plan_summary(plan_buckets(
        [torch.empty(p.shape, dtype=wire.plan_dtype(p.dtype), device="meta")
         for p in model.parameters()],
        basics.config().fusion_threshold))

    for _ in range(args.num_warmup_batches):
        loss = step(tokens)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step(tokens)
        _sync(dev)
        rates.append(B * L * args.num_batches_per_iter
                     / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    # Data-parallel replicas must hold identical parameters after the
    # same reduced updates: every rank's checksum equals rank 0's.
    checksum = torch.stack([p.detach().double().sum()
                            for p in model.parameters()]).sum()
    sums = allgather(checksum.reshape(1)).tolist()
    return {
        "metric": "tokens/sec",
        "value": mean,
        "unit": "tokens/sec/card",
        "conf": float(1.96 * np.std(rates)),
        "peak": float(np.max(rates)),
        "step_ms": B * L / mean * 1e3,
        "loss": float(loss),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "model": args.model, "seq_len": L, "batch_size": B,
        "layers": args.lm_layers, "d_model": args.lm_dim,
        "heads": args.lm_heads, "vocab": args.vocab,
        "dtype": "float32" if args.fp32 else "bfloat16",
        "attention": args.attention, "compression": args.compression,
        "buckets": plan, "world_size": n,
        "replicas_in_sync": all(x == sums[0] for x in sums),
        "device": dev.type, "card": card_description(dev),
        "torch": torch.__version__,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    record = run(args)
    if basics.rank() == 0:
        print(json.dumps(record), flush=True)
    basics.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
