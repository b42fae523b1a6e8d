"""Shared LM construction for the port's inference bench lanes.

``python -m horovod_tpu_torch.decode_bench`` (the static-cache decode
lane) and ``python -m horovod_tpu_torch.serve_bench`` (the continuous-
batching serving engine) must price the SAME model for an A/B to mean
anything, so both build it here, as the JAX package's
``tools/lm_common.py`` does for its two lanes.
"""

from __future__ import annotations

import argparse

from horovod_tpu_torch._device import DeviceLike


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The GPT-2-small-class model knobs both inference lanes share."""
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32000)


def validate_model_args(ap: argparse.ArgumentParser, args) -> None:
    if args.layers < 1:
        ap.error(f"--layers must be >= 1, got {args.layers}")
    if args.d_model % args.heads:
        ap.error(f"--d-model {args.d_model} must be divisible by "
                 f"--heads {args.heads}")


def build_params(args, max_len: int, seed: int = 0,
                 device: DeviceLike = None):
    """Dense LM parameter dict (``models.parallel_lm.init_lm_params``,
    random weights from the numpy ``seed``) at the argparse'd sizes with
    a ``max_len``-entry position table (the KV cache bound both lanes
    size against), on ``device`` (``None`` = the card). FFN is the
    standard 4x d_model."""
    from horovod_tpu_torch.models import parallel_lm as plm

    return plm.init_lm_params(
        seed, args.vocab, max_len, args.layers, args.heads,
        args.d_model // args.heads, 4 * args.d_model, device=device)
