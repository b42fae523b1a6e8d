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
CUDA generators draw different numbers). It cannot reproduce
``jax.random``'s numbers: sampled streams are pinned by same-seed
determinism within the port, and only greedy streams are compared with
the JAX package.

**Speculative decoding** adds two surfaces, keyed by the same (seed,
absolute output position) with DOMAIN-SEPARATED folds (``DRAFT_FOLD``,
``ACCEPT_FOLD``, ``RESIDUAL_FOLD``, the JAX package's values), so the
draft's randomness never collides with the target's:

* :func:`draft_sample_tokens` — the draft's proposal, drawn ON THE
  DEVICE inside the engine's speculative lane (which the engine
  captures into a CUDA graph, where no host-seeded generator can run):
  greedy rows take ``argmax(float32)``, sampled rows a Gumbel-max draw
  over their masked logits whose noise is a counter-based hash of
  (seed, position, fold, vocabulary index) in int64 tensor ops. The
  draw is the same replayed or eager, and a recompute re-draws the same
  proposal at each position;
* :func:`speculative_accept` — the host-side acceptance rule for one
  slot. Greedy: keep the longest prefix where draft and target argmaxes
  agree, then the target's token at the first mismatch (the correction)
  or one bonus token. ``temperature > 0``: Leviathan rejection sampling
  (accept ``d_i`` iff ``u_i * q_i(d_i) <= p_i(d_i)``, else draw from the
  normalised residual ``max(p - q, 0)``), with the uniform and the
  residual draw from the same hash under their folds; the bonus token
  is :func:`sample_tokens`' own draw at its position.

The hash is splitmix64 (:func:`_key64` on the host, :func:`_key_t` on
tensors, held equal by tests/test_torch_serve_spec.py and on the card by
chip_smoke.py). Sampled spec streams are deterministic per seed and
schedule; like the JAX package's, they depend on where tick boundaries
fall, so only greedy streams equal the plain engine's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

#: Domain separators folded into the position key, so the draft's
#: proposal draw, the acceptance uniform and the residual resample are
#: three independent streams per (seed, position).
DRAFT_FOLD = 0x5D_01
ACCEPT_FOLD = 0x5D_02
RESIDUAL_FOLD = 0x5D_03

_M64 = (1 << 64) - 1
_GOLDEN, _MUL1, _MUL2 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                         0x94D049BB133111EB)


def _mix64(z: int) -> int:
    """One splitmix64 step on a Python integer (64-bit wraparound)."""
    z = (z + _GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * _MUL1) & _M64
    z = ((z ^ (z >> 27)) * _MUL2) & _M64
    return z ^ (z >> 31)


def _key64(seed: int, position: int, fold: int = 0) -> int:
    """The 64-bit key of (request seed, output position), with ``fold``
    mixed in when non-zero: the pair packed into 64 bits and mixed."""
    z = _mix64(((int(seed) & 0xFFFFFFFF) << 32)
               | (int(position) & 0xFFFFFFFF))
    return _mix64(z ^ fold) if fold else z


def _seed_of(seed: int, position: int, fold: int = 0) -> int:
    """The generator seed of (request seed, output position[, fold]):
    the key folded to 32 bits — the CPU generator keeps only the low 32
    bits of a seed, so the fold must carry both halves."""
    z = _key64(seed, position, fold)
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor (``>>`` is arithmetic)."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix64_t(z: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` on an int64 tensor: the same bits, since int64
    addition and multiplication wrap modulo 2^64."""
    z = z + _signed(_GOLDEN)
    z = (z ^ _srl(z, 30)) * _signed(_MUL1)
    z = (z ^ _srl(z, 27)) * _signed(_MUL2)
    return z ^ _srl(z, 31)


def _key_t(seeds: torch.Tensor, positions: torch.Tensor,
           fold: int) -> torch.Tensor:
    """:func:`_key64` of each (seed, position) pair of two integer
    tensors, as int64 bits."""
    z = _mix64_t(((seeds.long() & 0xFFFFFFFF) << 32)
                 | (positions.long() & 0xFFFFFFFF))
    return _mix64_t(z ^ fold) if fold else z


def _uniforms(seeds: torch.Tensor, positions: torch.Tensor, fold: int,
              n: int) -> torch.Tensor:
    """``[N, n]`` float32 uniforms in (0, 1), element ``[i, j]`` a pure
    function of (seed_i, position_i, fold, j): 23 bits of
    ``mix64(key ^ j)``, so ``1 - u`` never rounds to 0 in float32."""
    z = _mix64_t(_key_t(seeds, positions, fold)[:, None]
                 ^ torch.arange(n, device=seeds.device))
    return (_srl(z, 41).float() + 0.5) * 2.0 ** -23


def _gumbel(seeds, positions, fold: int, n: int) -> torch.Tensor:
    return -torch.log(-torch.log(_uniforms(seeds, positions, fold, n)))


def _masked_logits(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """Top-k + temperature masking of one float32 row ``[V]``: kept
    entries divided by the temperature, the rest ``-inf``."""
    v = logits.shape[0]
    k = v if top_k <= 0 else min(max(int(top_k), 1), v)
    thresh = torch.topk(logits, k).values[-1]
    return torch.where(logits >= thresh, logits / temperature,
                       torch.full((), float("-inf"), device=logits.device))


def _masked_rows(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor) -> torch.Tensor:
    """:func:`_masked_logits` of float32 rows ``[N, V]`` at once, with
    per-row ``temperature [N]`` and ``top_k [N]`` tensors (``<= 0`` = the
    full vocabulary) and no host read, for the speculative surfaces:
    kept entries (ties at the k-th logit all kept) divided by the
    temperature (1 where it is 0), the rest ``-inf``."""
    v = logits.shape[-1]
    k = torch.where(top_k <= 0, v, top_k).clamp(1, v).long()
    thresh = torch.sort(logits, dim=-1, descending=True).values.gather(
        -1, (k - 1)[:, None])
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    return torch.where(logits >= thresh, logits / safe_t[:, None],
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


def draft_sample_tokens(logits, temperature, top_k, seeds, positions):
    """The draft's proposals, on the logits' device with no host read
    (so a CUDA graph can hold it): logits ``[N, V]``, and ``[N]`` tensors
    on the same device for the temperature (float), top-k, seed and
    output position (integers) -> tokens ``[N]`` int64. Greedy rows
    (``temperature == 0``) take ``argmax(float32)``; the others a
    Gumbel-max draw from their own masked distribution under the
    ``DRAFT_FOLD`` key of their position — the ``q`` the rejection test
    needs proposals to follow."""
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1)
    noisy = (_masked_rows(lf, temperature, top_k)
             + _gumbel(seeds, positions, DRAFT_FOLD, lf.shape[-1]))
    return torch.where(temperature > 0, torch.argmax(noisy, dim=-1),
                       greedy)


def speculative_accept(target_logits, draft_toks, draft_logits, *,
                       temperature: float, top_k: int, seed: int,
                       position0: int,
                       target_tokens: Optional[Sequence[int]] = None
                       ) -> List[int]:
    """The acceptance rule for ONE slot's speculative tick.

    ``target_logits`` ``[w, V]`` are the verify pass's logits (row i
    draws the token at output position ``position0 + i``);
    ``draft_toks`` ``[w-1]`` and ``draft_logits`` ``[w-1, V]`` the
    draft's proposals (proposal i competes for output position
    ``position0 + i``). Returns the emitted tokens: between 1 (the
    correction alone) and ``w`` (every proposal accepted + the bonus).

    Greedy (``temperature <= 0``): emit ``argmax(float32 row)`` — the
    :func:`sample_tokens` greedy spelling, or ``target_tokens`` when the
    caller already holds those argmaxes (the engine's lane computes them
    on the device, and a greedy row's logits then stay there unread) —
    walking rows while the draft's proposal matches. Every emitted token
    is the target's argmax given exactly the emitted prefix, so the
    stream is the plain engine's whatever the draft proposed.

    ``temperature > 0``: proposal ``d_i ~ q_i`` is accepted iff ``u_i *
    q_i(d_i) <= p_i(d_i)`` (``u_i`` under the ``ACCEPT_FOLD`` key of its
    position); on rejection the correction is drawn from the normalised
    residual ``max(p_i - q_i, 0)`` under the ``RESIDUAL_FOLD`` key, which
    keeps the target distribution exactly. The bonus token (every
    proposal accepted) and a ``w == 1`` tick are :func:`sample_tokens`'
    draw at that position."""
    draft = [int(t) for t in draft_toks]
    if temperature <= 0:
        tgt = (list(map(int, target_tokens)) if target_tokens is not None
               else torch.argmax(target_logits.float(), dim=-1).tolist())
        out = []
        for i, tok in enumerate(tgt):
            out.append(tok)
            if i == len(tgt) - 1 or draft[i] != tok:
                break
        return out

    tl = target_logits.float()
    w, dev = tl.shape[0], tl.device
    if w > 1:
        n = w - 1
        temp = torch.full((n,), float(temperature), device=dev)
        topk = torch.full((n,), int(top_k), device=dev)
        p = torch.softmax(_masked_rows(tl[:n], temp, topk), dim=-1)
        q = torch.softmax(_masked_rows(draft_logits.float()[:n], temp,
                                       topk), dim=-1)
        seeds = torch.full((n,), int(seed), dtype=torch.long, device=dev)
        pos = position0 + torch.arange(n, device=dev)
        d = torch.as_tensor(draft[:n], device=dev)[:, None]
        u = _uniforms(seeds, pos, ACCEPT_FOLD, 1)[:, 0]
        tests = torch.stack([u, q.gather(1, d)[:, 0], p.gather(1, d)[:, 0]])
        for i, (ui, qd, pd) in enumerate(tests.t().tolist()):
            if ui * qd <= pd:
                continue
            residual = torch.clamp(p[i] - q[i], min=0.0)
            total = residual.sum()
            # total == 0 means p == q, where the test above always
            # accepts; guarded all the same.
            dist = torch.where(total > 0, residual / total, p[i])
            g = _gumbel(seeds[i:i + 1], pos[i:i + 1], RESIDUAL_FOLD,
                        dist.shape[-1])[0]
            return draft[:i] + [int(torch.argmax(torch.log(dist) + g))]
    # Every proposal accepted: the bonus draw IS the plain sampler's at
    # its position.
    return draft[:w - 1] + [int(sample_tokens(
        tl[w - 1:w], [temperature], [top_k], [seed],
        [position0 + w - 1])[0])]
