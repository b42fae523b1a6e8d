"""Time the chunked fused cross-entropy by chunk size at the LM lane's
loss-head shapes, against the unfused loss.

    python -m horovod_tpu_torch.tune_xent [t_chunk ...]

The head of the bench lane's step (GPT-2-small, 8 sequences of 2048: T =
8 x 2047 = 16,376 scored tokens, E = 768, V = 32000, float32 hidden
states and head, no TF32): ``ops.xent.fused_cross_entropy`` forward and
backward (``dh`` and ``dw``) at each ``t_chunk`` (default 256 to 8192),
and the unfused loss (the ``[T, V]`` logits, ``log_softmax``, the
target's gather and their backward) as the yardstick. Each is checked
against the unfused loss and gradients, then timed with the L2 flushed
(``_timing.time_cold_ms``) in two passes of opposite order, with the
peak memory one call allocates beyond its inputs. One JSON line per
variant and pass; ``models.train.FUSED_CE_CHUNK`` ships the fastest.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from horovod_tpu_torch._device import pin_fp32_policy
from horovod_tpu_torch._timing import card, flush_buffer, time_cold_ms
from horovod_tpu_torch.ops.xent import fused_cross_entropy

T, E, V = 8 * 2047, 768, 32000
CHUNKS = (256, 512, 1024, 2048, 4096, 8192)


def _unfused(h, w, targets):
    logp = torch.log_softmax(h @ w.t(), dim=-1)
    return -logp.gather(1, targets[:, None]).mean()


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("tune_xent: no CUDA device")
    pin_fp32_policy()
    argv = list(sys.argv[1:] if argv is None else argv)
    chunks = [int(x) for x in argv] or list(CHUNKS)
    rng = np.random.default_rng(14)
    h = torch.tensor(rng.standard_normal((T, E), dtype=np.float32),
                     device="cuda", requires_grad=True)
    w = torch.tensor((rng.standard_normal((V, E)) / np.sqrt(E)).astype(
        np.float32), device="cuda", requires_grad=True)
    targets = torch.tensor(rng.integers(0, V, T), device="cuda")
    variants = {"unfused": lambda: _unfused(h, w, targets)}
    for c in chunks:
        variants[f"chunk{c}"] = (
            lambda c=c: fused_cross_entropy(h, w, targets, c))

    def run(fn):
        loss = fn()
        return (loss.detach(), *torch.autograd.grad(loss, (h, w)))

    ref = run(variants["unfused"])
    flush = flush_buffer()
    smi = card()
    names = list(variants)
    for order in (names, names[::-1]):
        for name in order:
            got = run(variants[name])
            err = {k: float((a - b).abs().max())
                   for k, a, b in zip(("loss", "dh", "dw"), got, ref)}
            del got
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run(variants[name])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = time_cold_ms(lambda: run(variants[name]), flush, iters=10,
                              warmup=2)
            print(json.dumps({"variant": name, "ms": ms,
                              "peak_bytes_over_inputs": peak,
                              "max_abs_err_vs_unfused": err,
                              "card": smi}), flush=True)


if __name__ == "__main__":
    main()
