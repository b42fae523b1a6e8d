"""Per-slot sampling for the serving engine (``sample_tokens`` of
``horovod_tpu.serve.sampling``).

One call covers every lane of a step (decode slots + the prefill lane's
first token) with PER-SLOT knobs:

* ``temperature == 0`` — greedy: ``argmax(logits.float())``, the
  spelling ``models.parallel_lm.lm_decode`` uses (the first maximum),
  which keeps the engine's greedy stream token-identical to it;
* ``temperature > 0`` — categorical over ``logits / temperature``,
  optionally top-k-masked (``top_k <= 0`` = full vocab; ties at the
  k-th logit are all kept).

Draws are **position-seeded**: token i of request r draws with a
``torch.Generator`` seeded from ``(seed_r, i)``, where i indexes the
request's FULL generation stream. No sampler state lives between
steps, so a request evicted and recomputed re-draws the identical
tokens. The draw runs on the logits' device with a generator of that
device, so a stream is reproducible on one device type (the CPU and
CUDA generators draw different numbers). It cannot reproduce ``jax.random``'s numbers: sampled
streams are pinned by same-seed determinism within the port, and only
greedy streams are compared with the JAX package.

The speculative-decoding surfaces come with that slice (ROADMAP.md
Queue 1, serving features).
"""

from __future__ import annotations

import numpy as np
import torch


_M64 = (1 << 64) - 1


def _seed_of(seed: int, position: int) -> int:
    """The generator seed of (request seed, output position): the pair
    packed into 64 bits, mixed by splitmix64 and folded to 32 bits — the
    CPU generator keeps only the low 32 bits of a seed, so the fold must
    carry both halves."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def _masked_logits(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """Top-k + temperature masking of one float32 row ``[V]``: kept
    entries divided by the temperature, the rest ``-inf``."""
    v = logits.shape[0]
    k = v if top_k <= 0 else min(max(int(top_k), 1), v)
    thresh = torch.topk(logits, k).values[-1]
    return torch.where(logits >= thresh, logits / temperature,
                       torch.full((), float("-inf"), device=logits.device))


def sample_tokens(logits, temperature, top_k, seeds, positions) -> np.ndarray:
    """Per-slot sampling: logits ``[N, V]`` (any float dtype, any
    device), temperature ``[N]``, top_k ``[N]``, seeds ``[N]``,
    positions ``[N]`` (host arrays) -> tokens ``[N]`` int32 numpy.
    Rows are independent; inactive lanes sample garbage that the host
    discards."""
    temperature = np.asarray(temperature, np.float32)
    # float32 BEFORE the argmax: greedy rows take the exact tensor
    # lm_decode takes.
    lf = logits.float()
    tokens = torch.argmax(lf, dim=-1)
    hot = np.nonzero(temperature > 0)[0]
    if hot.size:
        # Drawn on the logits' device; the step's tokens go to the host
        # in one copy.
        draws = []
        for i in hot:
            g = torch.Generator(device=lf.device)
            g.manual_seed(_seed_of(seeds[i], positions[i]))
            masked = _masked_logits(lf[i], float(temperature[i]),
                                    int(top_k[i]))
            probs = torch.softmax(masked, dim=-1)
            draws.append(torch.multinomial(probs, 1, generator=g))
        tokens[torch.as_tensor(hot, device=lf.device)] = torch.cat(draws)
    return tokens.to("cpu").numpy().astype(np.int32)
