"""Serving SLO metrics: TTFT, per-token latency, throughput, occupancy.

A copy of ``horovod_tpu.serve.metrics``. Definitions (the ones
docs/serving.md's runbook tunes against):

* **TTFT** — time-to-first-token: ``t_first_token - arrival``. Includes
  queueing delay (open-loop honesty: a saturated engine shows it in
  TTFT, not by silently back-pressuring the generator).
* **per-token latency (TBT)** — inter-token gaps within one request:
  ``token_times[i] - token_times[i-1]`` (the first gap is measured
  from the first token). What a streaming client perceives per token.
* **tokens/s/chip** — total generated tokens / wall / chips. Generated
  only; prompt tokens are the cost of TTFT, not serving throughput.
* **occupancy** — fraction of allocatable KV pages in use, sampled
  once per engine step; mean and max over the run.

Percentiles use the nearest-rank method on the sorted sample (p50/p99
of an empty sample render as None) — no interpolation, so a reported
p99 is always a latency some real request paid.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in [0, 100]); None on empty input."""
    if not xs:
        return None
    s = sorted(xs)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


def _r(x: Optional[float], nd: int = 2) -> Optional[float]:
    return None if x is None else round(x, nd)


def summarize(requests, wall_s: float, chips: int = 1,
              occupancy_samples: Optional[List[float]] = None) -> Dict:
    """Aggregate a run into the bench-record stats dict.

    ``requests`` is any iterable of :class:`~horovod_tpu_torch.serve.
    scheduler.Request` (finished or not — unfinished ones count toward
    states but contribute only the latency samples they already
    earned)."""
    reqs = list(requests)
    ttft_ms, tbt_ms = [], []
    tokens = 0
    states: Dict[str, int] = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
        tokens += len(r.output)
        if r.t_first_token is not None:
            ttft_ms.append((r.t_first_token - r.arrival) * 1e3)
        prev = r.t_first_token
        for t in r.token_times:
            if prev is not None and t > prev:
                tbt_ms.append((t - prev) * 1e3)
            prev = t
    occ = occupancy_samples or []
    return {
        "requests": len(reqs),
        "by_state": states,
        "generated_tokens": tokens,
        "tokens_per_sec_per_chip":
            _r(tokens / wall_s / max(1, chips), 1) if wall_s > 0 else None,
        "ttft_ms": {"p50": _r(percentile(ttft_ms, 50)),
                    "p99": _r(percentile(ttft_ms, 99)),
                    "mean": _r(sum(ttft_ms) / len(ttft_ms))
                            if ttft_ms else None},
        "tbt_ms": {"p50": _r(percentile(tbt_ms, 50)),
                   "p99": _r(percentile(tbt_ms, 99))},
        "pages": {"occupancy_mean": _r(sum(occ) / len(occ), 4)
                              if occ else None,
                  "occupancy_max": _r(max(occ), 4) if occ else None},
    }
