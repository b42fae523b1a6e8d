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
  of random tokens from a numpy seed; tokens/s per card. The JAX lane's
  step flags: ``--fused-ce`` (the chunked fused cross-entropy, no
  ``[B, L, V]`` logits), ``--zero`` (ZeRO-1 optimizer-state sharding;
  ``--overlap`` does not apply), ``--remat`` (each block recomputed in
  the backward pass), and with flash attention ``--flash-bwd
  {auto,scan,pallas,kernel}`` (``pallas`` is the JAX spelling of
  ``kernel``). ``--attention auto`` takes flash at every length, the
  H100's measured crossover (:func:`resolve_attention`).
* ``resnet18|34|50|101|152``: the JAX lane's image defaults (224x224x3
  synthetic images and 1000 classes from a numpy seed, 64 images per
  card, bfloat16 compute with float32 parameters and BatchNorm
  statistics, ``torch.optim.SGD(lr=0.01, momentum=0.9)`` under
  ``DistributedOptimizer``, the per-rank loss as with the JAX lane's
  ``average_loss=False``); images/s per card. ``--fused-bn`` runs every
  training-mode 1x1 ConvBN through kernel K5.

Both lanes take ``--steps-per-dispatch K``: each timed iteration runs
``--num-batches-per-iter`` windows of K steps (the warm-up
``--num-warmup-batches`` windows), each step a CUDA graph replay of one
captured step (:mod:`horovod_tpu_torch.distributed.window`; Adam is built
with ``capturable=True`` on the card), and the units count the K steps.
Its metric and unit carry the JAX lane's ``_winK`` suffix
(``tokens/sec_win10``, ``img/sec/card_win10``) and the record stamps
``"window": K``, so a window record never stands where a per-step record
should; ``K = 1`` is the per-step lane and its record as they were.

Flags of one lane given to the other raise, as in the JAX ``bench.py``;
so do the flash-only flags without flash. The JAX flags the port has not
taken yet (``--snapshot-every``,
``--hierarchical``, ``--compression int8|fp8``, ``--bf16-momentum``,
``--scan-layers``, and ``--flash-full-grid``: K1-K3 have no full-grid
mode) are parsed and raise ``NotImplementedError`` naming their
ROADMAP.md item.
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
from horovod_tpu_torch.distributed.window import stage_synthetic_window
from horovod_tpu_torch.distributed.zero import shard_info
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.train import (create_train_state,
                                            make_image_train_step,
                                            make_train_step)
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops.attention import (flash_attention,
                                             flash_grid_info,
                                             resolve_bwd_impl)


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
    p.add_argument("--fused-ce", action="store_true",
                   help="transformer_lm: chunked fused cross-entropy "
                        "(ops/xent.py), no [B, L, vocab] logits")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding over the ranks "
                        "(distributed/zero.py); --overlap does not apply")
    p.add_argument("--remat", action="store_true",
                   help="transformer_lm: recompute each block in the "
                        "backward pass")
    p.add_argument("--flash-bwd", default=None,
                   choices=["auto", "scan", "pallas", "kernel"],
                   help="transformer_lm + flash: the backward (pallas is "
                        "the JAX spelling of kernel, K2 + K3; auto takes "
                        "the H100's measured crossover)")
    p.add_argument("--overlap", default=None, choices=["auto", "on", "off"],
                   help="HOROVOD_OVERLAP for the gradient buckets; on "
                        "starts each bucket from gradient hooks during "
                        "the backward pass")
    p.add_argument("--compression", default="none",
                   choices=["none", "fp16", "bf16", "int8", "fp8"])
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K steps a window, each a CUDA graph replay of "
                        "one captured step (distributed/window.py); the "
                        "metric and unit carry _winK")
    # The JAX lane's flags that the port has not taken yet: parsed, and
    # each raises NotImplementedError naming its ROADMAP.md item.
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--hierarchical", default=None,
                   choices=["auto", "on", "off"])
    p.add_argument("--bf16-momentum", action="store_true")
    p.add_argument("--scan-layers", action="store_true")
    p.add_argument("--flash-full-grid", action="store_true")
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


#: The JAX lane's flags the port has not taken yet: (set?, flag, the
#: ROADMAP.md item that brings it).
_LATER = (
    (lambda a: a.snapshot_every != 0, "--snapshot-every",
     "ROADMAP.md Queue 1, training infrastructure (elastic)"),
    (lambda a: a.hierarchical not in (None, "off"), "--hierarchical",
     "ROADMAP.md Queue 1, parallelism (the hierarchical ladder)"),
    (lambda a: a.compression in ("int8", "fp8"), "--compression int8|fp8",
     "ROADMAP.md Queue 1, parallelism (the hierarchical ladder's codecs)"),
    (lambda a: a.bf16_momentum, "--bf16-momentum",
     "ROADMAP.md Queue 1, the rest of the model zoo and the image "
     "lane's options"),
    (lambda a: a.scan_layers, "--scan-layers",
     "ROADMAP.md Queue 1: XLA's compile-time layer scan has no eager "
     "PyTorch counterpart"),
    (lambda a: a.flash_full_grid, "--flash-full-grid",
     "ROADMAP.md Queue 2, TPU kernels: K1-K3 always skip the tiles above "
     "the causal diagonal and have no full-grid mode"),
)


def resolve_attention(args) -> str:
    """``dense``/``flash``, with ``auto`` resolved by the H100's measured
    crossover (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 7, c1c and c5):
    this lane at 16,384 tokens a step (``--seq-len L --batch-size
    16384/L``) runs faster on flash at every length measured, 32
    (1.008x) to 4096 (3.31x), and dense runs out of memory at 8192; so
    ``auto`` is flash at every length. The JAX package's crossover, dense
    below 4096, was measured on a TPU."""
    return "flash" if args.attention == "auto" else args.attention


def _check_flags(args) -> None:
    """The JAX lane's errors for flags of the other lane and for the
    flash-only flags without flash; then the flags not taken yet
    raise."""
    if args.model == LM:
        if args.fused_bn:
            raise ValueError("--fused-bn applies to the ResNet family "
                             f"(got --model {LM})")
        if resolve_attention(args) != "flash":
            for flag, on in (("--flash-full-grid", args.flash_full_grid),
                             ("--flash-bwd", args.flash_bwd is not None)):
                if on:
                    raise ValueError(
                        f"{flag} requires the flash attention path "
                        "(--attention flash or auto)")
    else:
        if args.attention is not None:
            raise ValueError(f"--attention applies to {LM} only (got "
                             f"--model {args.model})")
        for flag, on in (("--fused-ce", args.fused_ce),
                         ("--remat", args.remat),
                         ("--flash-bwd", args.flash_bwd is not None),
                         ("--flash-full-grid", args.flash_full_grid)):
            if on:
                raise ValueError(f"{flag} applies to {LM} only (got "
                                 f"--model {args.model})")
    if args.steps_per_dispatch < 1:
        raise ValueError(f"--steps-per-dispatch must be >= 1, got "
                         f"{args.steps_per_dispatch}")
    for is_set, flag, item in _LATER:
        if is_set(args):
            raise NotImplementedError(f"{flag} is not ported yet ({item})")


def _lm_lane(args, dev):
    """The LM, its step on one fixed batch per rank (no host sync: it
    returns the loss tensor), and the units a step."""
    L, B = args.seq_len, args.batch_size
    attention = resolve_attention(args)
    attn_fn, flash_grid = None, None
    if attention == "flash":
        bwd = "kernel" if args.flash_bwd == "pallas" else args.flash_bwd
        attn_fn = functools.partial(flash_attention, causal=True,
                                    bwd_impl=bwd)
        flash_grid = flash_grid_info(
            L, L, causal=True,
            head_dim=args.lm_dim // args.lm_heads,
            batch_heads=B * args.lm_heads, dtype_bytes=4 if args.fp32 else 2)
        flash_grid["bwd"] = resolve_bwd_impl(bwd, L)
    model = TransformerLM(
        vocab_size=args.vocab, num_layers=args.lm_layers,
        num_heads=args.lm_heads, embed_dim=args.lm_dim,
        max_len=max(L, 2048),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        attn_fn=attn_fn, remat=args.remat, seed=42, device=dev)
    # A window captures the step into a CUDA graph, which needs Adam's
    # step counts on the card; the per-step lane keeps torch's default.
    opt = create_train_state(
        model, torch.optim.Adam(
            model.parameters(), lr=1e-4,
            capturable=args.steps_per_dispatch > 1 and dev.type == "cuda"),
        compression=getattr(Compression, args.compression),
        overlap=args.overlap, device=dev, zero=args.zero)
    step = make_train_step(model, opt, fused_ce=args.fused_ce)
    # One global batch of B sequences per rank, each rank its own rows
    # (the JAX lane's sharded [B * n, L] batch).
    n, r = basics.size(), basics.rank()
    tokens = torch.tensor(np.random.default_rng(42).integers(
        0, args.vocab, (B * n, L))[r * B:(r + 1) * B], device=dev)
    fields = {"metric": "tokens/sec", "unit": "tokens/sec/card",
              "seq_len": L, "layers": args.lm_layers,
              "d_model": args.lm_dim, "heads": args.lm_heads,
              "vocab": args.vocab, "attention": attention,
              "flash_grid": flash_grid, "fused_ce": args.fused_ce,
              "remat": args.remat}
    return model, opt, step, tokens, B * L, fields


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
        overlap=args.overlap, device=dev, zero=args.zero)
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
    return model, opt, step, batch, B, fields


def run(args, device: DeviceLike = None) -> dict:
    """The lane; returns the record. ``device=None`` is the card."""
    _check_flags(args)
    dev = resolve_device(device)
    basics.init(device=dev)
    dev = basics.device()
    lane = _lm_lane if args.model == LM else _image_lane
    model, opt, step_fn, batch, units, fields = lane(args, dev)
    k = args.steps_per_dispatch
    window_fn, staged = stage_synthetic_window(step_fn, batch, k)

    def step():
        out = window_fn(staged)
        return out["loss"] if isinstance(out, dict) else out

    if args.zero:
        # ZeRO's exchange is reduce-scatter shaped; the overlap knob and
        # the bucket plan apply to DistributedOptimizer only.
        stamp = {"zero": shard_info(opt), "overlap": None, "buckets": None}
    else:
        wire = getattr(Compression, args.compression)
        stamp = {"zero": None,
                 "overlap": args.overlap or basics.config().overlap,
                 "buckets": plan_summary(plan_buckets(
                     [torch.empty(p.shape, dtype=wire.plan_dtype(p.dtype),
                                  device="meta")
                      for p in model.parameters() if p.requires_grad],
                     basics.config().fusion_threshold))}

    if dev.type == "cuda" and k > 1:
        # A window's memory is allocated at its capture, in the warm-up:
        # its peak counts from there (after it, replays allocate nothing).
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(args.num_warmup_batches):
        loss = step()
    _sync(dev)
    if dev.type == "cuda" and k == 1:
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step()
        _sync(dev)
        rates.append(units * k * args.num_batches_per_iter
                     / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    # Data-parallel replicas must hold identical parameters after the
    # same reduced updates: every rank's checksum equals rank 0's.
    checksum = torch.stack([p.detach().double().sum()
                            for p in model.parameters()]).sum()
    sums = allgather(checksum.reshape(1)).tolist()
    n = basics.size()
    # The JAX lane's _winK contract (bench.py metric_contract): a window
    # record never stands where a per-step record should.
    suffix = f"_win{k}" if k > 1 else ""
    return {
        "metric": fields.pop("metric") + suffix,
        "value": mean,
        "unit": fields.pop("unit") + suffix,
        "conf": float(1.96 * np.std(rates)),
        "peak": float(np.max(rates)),
        "step_ms": units / mean * 1e3,
        "loss": float(loss),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "model": args.model, "batch_size": args.batch_size, **fields,
        "dtype": "float32" if args.fp32 else "bfloat16",
        "compression": args.compression, **stamp, "world_size": n,
        "replicas_in_sync": all(x == sums[0] for x in sums),
        "device": dev.type, "card": card_description(dev),
        "torch": torch.__version__,
        **({"window": k} if k > 1 else {}),
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
