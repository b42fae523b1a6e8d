"""Static-cache decode throughput of the port: ``python -m
horovod_tpu_torch.decode_bench``, the counterpart of the JAX package's
``tools/decode_bench.py``.

Greedy decode of the GPT-2-small-class model (12L/768d, vocab 32k) with
the static-shape KV cache: prefill plus the whole generation loop run as
:class:`~horovod_tpu_torch.models.parallel_lm.StaticDecoder`'s CUDA
graphs (the prefill's and one step's). The first call (an eager
generation, then the capture) is timed as ``compile+prefill``; then
``--iters`` generations, each between CUDA events on the card (the host
clock on the CPU), give the mean tokens/s per card with +-1.96 std and
the high-variance warning on stderr. Prompts come from a seeded
``torch.Generator``, the weights from a numpy seed. Prints one JSON line
in the bench record's shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.lm_common import (add_model_args, build_params,
                                         validate_model_args)

METRIC = "transformer_lm_decode_tokens_per_sec_per_card"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.decode_bench",
        description="KV-cache decode throughput (tokens/sec/card) of the "
                    "static-cache lane.")
    add_model_args(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_model_args(ap, args)
    if args.steps < 1:
        ap.error(f"--steps must be >= 1, got {args.steps} (0 would "
                 "surface later as a scan/position-table shape error)")
    if args.prompt_len < 1 or args.batch < 1 or args.iters < 1:
        ap.error("--prompt-len, --batch and --iters must be >= 1")
    return args


def run(args) -> dict:
    """The lane; returns the record."""
    from horovod_tpu_torch.bench import card_description
    from horovod_tpu_torch.models.parallel_lm import StaticDecoder

    dev = resolve_device(args.device)
    lmax = args.prompt_len + args.steps
    params = build_params(args, lmax, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, args.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    decoder = StaticDecoder(params, args.batch, args.prompt_len,
                            args.steps, device=dev)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    decoder(prompt)
    sync()
    compile_s = time.perf_counter() - t0

    if on_card:
        from horovod_tpu_torch._timing import flush_buffer, time_cold_ms

        flush = flush_buffer(dev)

        def one_ms():
            return time_cold_ms(lambda: decoder(prompt), flush, iters=1,
                                warmup=0)
    else:
        def one_ms():
            t = time.perf_counter()
            decoder(prompt)
            return (time.perf_counter() - t) * 1e3

    tokens = args.batch * args.steps
    rates = []
    for x in range(args.iters):
        rates.append(tokens / (one_ms() / 1e3))
        print(f"Iter #{x}: {rates[-1]:.1f} decode tok/s",
              file=sys.stderr, flush=True)
    mean = sum(rates) / len(rates)
    var = sum((r - mean) ** 2 for r in rates) / len(rates)
    conf = 1.96 * var ** 0.5
    if conf > 0.1 * mean:
        print(f"WARNING: high variance (CI {conf:.0f} vs mean {mean:.0f})"
              " — contended card; rerun for a representative number",
              file=sys.stderr, flush=True)
    ms_gen = tokens / mean * 1e3
    print(f"decode: {mean:.1f} +-{conf:.1f} tok/s (batch {args.batch}, "
          f"{args.steps} steps @ {ms_gen:.1f} ms/gen, "
          f"compile+prefill first call {compile_s:.1f}s)",
          file=sys.stderr, flush=True)
    return {
        "metric": METRIC, "value": mean, "unit": "tokens/sec/card",
        "vs_baseline": None, "peak": max(rates),
        "ms_per_generation": ms_gen,
        "device": dev.type, "card": card_description(dev),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
