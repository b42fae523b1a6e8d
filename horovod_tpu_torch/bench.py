"""Training benchmark of the port: the transformer_lm and image lanes of
the JAX package's ``bench.py``, on the card.

    python -m horovod_tpu_torch.bench --model transformer_lm \\
        [--attention dense|flash] [--seq-len 2048] [--batch-size 8] ...
    python -m horovod_tpu_torch.bench --model resnet50 [--fused-bn] \\
        [--image-size 224] [--batch-size 64] ...

One process per card (``torchrun`` sets the world; alone it is a world of
one). The reference's timing discipline: ``--num-warmup-batches`` steps,
then ``--num-iters`` windows of ``--num-batches-per-iter`` steps with one
``torch.cuda.synchronize()`` per window. Prints one JSON line: the rate
per card (the mean over the windows, with the 1.96-sigma spread and the
best window), the step time, the peak memory, the bucket plan, whether
every rank ends with the same parameters, and the card's name and power
limit.

* ``transformer_lm`` (the default): ``TransformerLM`` at the JAX lane's
  defaults (GPT-2-small width: 12 layers, d_model 768, 12 heads, vocab
  32000, seq 2048, 8 sequences per card, bfloat16 compute, float32
  parameters), ``torch.optim.Adam(lr=1e-4)`` under
  ``DistributedOptimizer``, the mean next-token loss, on one fixed batch
  of random tokens from a numpy seed; tokens/s per card.
  ``--attention auto`` (the JAX lane's dense/flash crossover, measured
  on a TPU) waits for the H100 crossover and raises.
* ``resnet18|34|50|101|152``: the JAX lane's image defaults (224x224x3
  synthetic images and 1000 classes from a numpy seed, 64 images per
  card, bfloat16 compute with float32 parameters and BatchNorm
  statistics, ``torch.optim.SGD(lr=0.01, momentum=0.9)`` under
  ``DistributedOptimizer``, the per-rank loss as with the JAX lane's
  ``average_loss=False``); images/s per card. ``--fused-bn`` runs every
  training-mode 1x1 ConvBN through kernel K5.

Flags of one lane given to the other raise, as in the JAX ``bench.py``.
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
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.train import (create_train_state,
                                            make_image_train_step,
                                            make_train_step)
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops.attention import flash_attention


LM = "transformer_lm"
IMAGE_MODELS = sorted(resnet._FAMILY)


class _Parser(argparse.ArgumentParser):
    """Fills the lane-dependent defaults: 8 sequences or 64 images per
    card, and dense attention for the LM."""

    def parse_known_args(self, args=None, namespace=None):
        ns, rest = super().parse_known_args(args, namespace)
        if ns.batch_size is None:
            ns.batch_size = 8 if ns.model == LM else 64
        if ns.attention is None and ns.model == LM:
            ns.attention = "dense"
        return ns, rest


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default=LM, choices=[LM, *IMAGE_MODELS])
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=None,
                   help="sequences (default 8) or images (default 64) per "
                        "card")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--fused-bn", action="store_true",
                   help="ResNet family: BatchNorm statistics in the 1x1 "
                        "convs' matmul epilogue (kernel K5)")
    p.add_argument("--lm-layers", type=int, default=12)
    p.add_argument("--lm-dim", type=int, default=768)
    p.add_argument("--lm-heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--attention", default=None,
                   choices=["dense", "flash", "auto"],
                   help="transformer_lm attention (default dense)")
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


def _check_flags(args) -> None:
    """The JAX lane's errors for flags of the other lane."""
    if args.model == LM:
        if args.fused_bn:
            raise ValueError("--fused-bn applies to the ResNet family "
                             f"(got --model {LM})")
        if args.attention == "auto":
            raise NotImplementedError(
                "--attention auto needs the H100 dense/flash crossover, not "
                "measured yet (ROADMAP.md); pass dense or flash")
    elif args.attention is not None:
        raise ValueError(f"--attention applies to {LM} only (got --model "
                         f"{args.model})")


def _lm_lane(args, dev):
    """The LM, its step on one fixed batch per rank (no host sync: it
    returns the loss tensor), and the units a step."""
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
    fields = {"metric": "tokens/sec", "unit": "tokens/sec/card",
              "seq_len": L, "layers": args.lm_layers,
              "d_model": args.lm_dim, "heads": args.lm_heads,
              "vocab": args.vocab, "attention": args.attention}
    return model, lambda: step(tokens), B * L, fields


def _image_lane(args, dev):
    """The ResNet, its step on one fixed batch of synthetic images per rank,
    and the units (images) a step."""
    model = resnet.build(
        args.model, num_classes=1000,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        fused_bn=args.fused_bn, seed=42, device=dev)
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=getattr(Compression, args.compression),
        overlap=args.overlap, device=dev)
    step = make_image_train_step(model, opt, average_loss=False)
    n, r, B, S = basics.size(), basics.rank(), args.batch_size, \
        args.image_size
    rng = np.random.default_rng(42)
    rows = slice(r * B, (r + 1) * B)
    batch = {
        "image": torch.tensor(rng.standard_normal(
            (B * n, S, S, 3), dtype=np.float32)[rows], device=dev),
        "label": torch.tensor(rng.integers(0, 1000, B * n)[rows],
                              device=dev)}
    fields = {"metric": "img/sec", "unit": "img/sec/card",
              "image_size": S, "fused_bn": args.fused_bn}
    return model, lambda: step(batch)["loss"], B, fields


def run(args, device: DeviceLike = None) -> dict:
    """The lane; returns the record. ``device=None`` is the card."""
    _check_flags(args)
    dev = resolve_device(device)
    basics.init(device=dev)
    dev = basics.device()
    lane = _lm_lane if args.model == LM else _image_lane
    model, step, units, fields = lane(args, dev)
    wire = getattr(Compression, args.compression)
    plan = plan_summary(plan_buckets(
        [torch.empty(p.shape, dtype=wire.plan_dtype(p.dtype), device="meta")
         for p in model.parameters()],
        basics.config().fusion_threshold))

    for _ in range(args.num_warmup_batches):
        loss = step()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step()
        _sync(dev)
        rates.append(units * args.num_batches_per_iter
                     / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    # Data-parallel replicas must hold identical parameters after the
    # same reduced updates: every rank's checksum equals rank 0's.
    checksum = torch.stack([p.detach().double().sum()
                            for p in model.parameters()]).sum()
    sums = allgather(checksum.reshape(1)).tolist()
    n = basics.size()
    return {
        "metric": fields.pop("metric"),
        "value": mean,
        "unit": fields.pop("unit"),
        "conf": float(1.96 * np.std(rates)),
        "peak": float(np.max(rates)),
        "step_ms": units / mean * 1e3,
        "loss": float(loss),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "model": args.model, "batch_size": args.batch_size, **fields,
        "dtype": "float32" if args.fp32 else "bfloat16",
        "compression": args.compression,
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
