"""Step-time autotuning (``HOROVOD_AUTOTUNE``): the port of
``horovod_tpu.jax.autotune``.

The reference tuned the fusion threshold and the cycle time numerically
and the hierarchical modes categorically, scoring bytes a second over
sampling windows (horovod/common/parameter_manager.h:35-43,149-217).
Here, as in the JAX package, the knobs are the gradient buckets' fusion
threshold (:mod:`horovod_tpu_torch.distributed.fusion`) and the
hierarchical ladder, and the score is measured steps a second.

A dispatch handle runs each step through :func:`tuned_call`: an eager
``DistributedOptimizer.step()``, a window step of
:func:`~horovod_tpu_torch.distributed.windowed` (one count a window
call, as a JAX window is one dispatch) and an
:func:`~horovod_tpu_torch.parallel.spmd.spmd_fn` handle. A handle called
inside another one's call is not counted. Every ``window`` dispatches the
tuner waits for the card (:func:`~horovod_tpu_torch.utils.devsync.
window_sync`) before it reads the clock, scores the current candidate,
moves to the next and adds one to ``generation``. The holders of a plan
key on the generation: ``DistributedOptimizer`` plans its buckets and
hooks again, and a captured window captures again. Each candidate's
first window is discarded as warm-up (it pays the new plan and the
capture). The order of the candidates comes from a GP surrogate with
expected improvement within each hierarchical category
(:mod:`horovod_tpu_torch.distributed._bayes`, the native tuner's
machinery in numpy), else a sweep. In a job of more than one rank, rank
0 decides every move and its score reaches every rank, so every rank
probes the same sequence and converges alike. When probing ends, the
best pair is applied, ``converged`` turns True and no dispatch waits
again. Scores append to ``HOROVOD_AUTOTUNE_LOG`` in the JAX package's
TSV layout.

Two differences from the JAX package (ROADMAP.md Queue 3): ``"auto"``
takes ``"ei"`` with 5 candidates or more, as the surrogate is always
there (the JAX package sweeps when its native library does not build);
and the dispatch handles are the port's (above), where the JAX package
counts ``spmd_fn`` dispatches only.
"""

from __future__ import annotations

import contextvars
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed._bayes import ei_next

# "No fusion" plus the power-of-two thresholds from 1 MB to 128 MB: the
# reference's 0..64 MB space and one octave past it.
DEFAULT_CANDIDATES = [0] + [1 << s for s in range(20, 28)]

Candidate = Tuple[int, bool]  # (fusion_threshold bytes, hierarchical)


def _hier_available() -> bool:
    """Whether the two-level ladder can tile the job's ranks: the
    exchange's own resolution (``fusion.resolve_hierarchical``), so the
    tuner's space and the executing path agree."""
    from horovod_tpu_torch.distributed.fusion import resolve_hierarchical

    return resolve_hierarchical("on", basics.size()) > 0


class StepAutotuner:
    """Tunes ``config.fusion_threshold`` and
    ``config.hierarchical_allreduce`` against the measured step rate.

    ``candidates`` takes plain thresholds (tuned flat) or
    ``(threshold, hierarchical)`` pairs; by default every threshold
    flat, and, where the ranks can ladder, every threshold hierarchical
    too. ``strategy``: ``"sweep"`` probes every candidate in order;
    ``"ei"`` probes 3 seeds, then lets expected improvement pick each
    next probe within a hierarchical category, alternating between the
    categories that still have unprobed candidates, up to
    ``max_probes``; ``"auto"`` is ``"ei"`` with 5 candidates or more.
    """

    def __init__(self, config, log_path: str = "",
                 candidates: Optional[Sequence] = None, window: int = 10,
                 strategy: str = "auto",
                 max_probes: Optional[int] = None) -> None:
        self.config = config
        if candidates is not None:
            cand = [c if isinstance(c, tuple) else (int(c), False)
                    for c in candidates]
        else:
            cand = [(t, False) for t in DEFAULT_CANDIDATES]
            if _hier_available():
                cand += [(t, True) for t in DEFAULT_CANDIDATES]
        # The current setting is probed first: a tuner whose handle stops
        # dispatching leaves the job at the untuned default.
        current: Candidate = (config.fusion_threshold,
                              bool(config.hierarchical_allreduce))
        self.candidates: List[Candidate] = [current] + [
            c for c in cand if c != current]
        self.window = max(1, int(window))
        self.strategy = strategy
        self.max_probes = max_probes or (
            3 + (len(self.candidates) - 3 + 1) // 2)
        self.generation = 1
        self.converged = False
        self.best_threshold = current[0]
        self.best_hierarchical = current[1]
        self.best_score = -1.0
        self.probed: dict = {}  # (threshold, hier) -> synced score
        if strategy == "auto":
            strategy = "ei" if len(self.candidates) >= 5 else "sweep"
        self._strategy_resolved = strategy
        self._ei_category = False  # alternates when both have unprobed
        self._warming = True
        self._steps_in_window = 0
        self._t0: Optional[float] = None
        self._samples = 0
        self._owner = None
        self._owner_idle = 0
        self._log = open(log_path, "w") if log_path else None
        self._apply(self.candidates[0])

    def _apply(self, cand: Candidate) -> None:
        self.config.fusion_threshold = cand[0]
        self.config.hierarchical_allreduce = cand[1]
        # The tri-state knob too, or a flat candidate would still ladder
        # through "auto" across hosts.
        self.config.hierarchical = "on" if cand[1] else "off"

    def _current(self) -> Candidate:
        return (self.config.fusion_threshold,
                bool(self.config.hierarchical_allreduce))

    # -- dispatch-side hooks ------------------------------------------------

    def claim(self, handle) -> bool:
        """Bind the tuner to one dispatch handle at a time; only the
        owner's steps are scored. After 3 windows of owner inactivity the
        active handle takes over and the partial window restarts. Claims
        follow program order, so every rank decides alike."""
        if self._owner is None or handle is self._owner:
            self._owner = handle
            self._owner_idle = 0
            return True
        self._owner_idle += 1
        if self._owner_idle > 3 * self.window:
            self._owner = handle
            self._owner_idle = 0
            self._steps_in_window = 0
            self._warming = True
            self._t0 = None
            return True
        return False

    def step_done(self) -> bool:
        """Count one dispatched step; True when the caller must call
        :meth:`end_window` with the step's output."""
        if self.converged:
            return False
        self._steps_in_window += 1
        return self._steps_in_window >= self.window

    def end_window(self, out=None) -> None:
        """Score the window that just ended. Given the window's output
        ``out``, wait for the card that holds it
        (:func:`~horovod_tpu_torch.utils.devsync.window_sync`) before
        reading the clock: kernels are queued asynchronously, so the
        clock alone would score the enqueue rate. ``out=None``: the
        caller has waited already."""
        if out is not None:
            from horovod_tpu_torch.utils.devsync import window_sync

            window_sync(out)
        now = time.perf_counter()
        self._steps_in_window = 0
        if self._warming or self._t0 is None:
            # Warm-up window: it paid the new plan (and a capture).
            self._log_line("warmup", self._current(), 0.0)
            self._warming = False
            self._t0 = now
            return
        score = self.window / (now - self._t0)  # steps/sec
        # Every rank adopts rank 0's measurement, so the probed scores,
        # every decision and the winner are the same on every rank.
        score = self._sync_value(score)
        cur = self._current()
        self.probed[cur] = score
        self._log_line("sample", cur, score)
        if score > self.best_score:
            self.best_score = score
            self.best_threshold, self.best_hierarchical = cur
        nxt = self._decide_next()
        if nxt is None:
            self._apply((self.best_threshold, self.best_hierarchical))
            self.converged = True
            self.generation += 1
            self._log_line("converged",
                           (self.best_threshold, self.best_hierarchical),
                           self.best_score)
            if self._log is not None:
                self._log.close()
                self._log = None
        else:
            self._apply(nxt)
            self.generation += 1
            self._warming = True
            self._t0 = now

    # -- candidate selection ------------------------------------------------

    @staticmethod
    def _xform(threshold: int) -> float:
        """The surrogate sees ``log2(1 + MB)``: thresholds evenly
        spaced."""
        return math.log2(1.0 + threshold / float(1 << 20))

    def _decide_next(self) -> Optional[Candidate]:
        """Rank 0 picks the next probe and broadcasts it over the job's
        group as integers (-1: converge); one rank deciding keeps every
        rank's sequence the same."""
        if basics.size() <= 1:
            return self._next_candidate()
        local = [-1, 0]
        if basics.process_rank() == 0:
            nxt = self._next_candidate()
            if nxt is not None:
                local = [int(nxt[0]), int(nxt[1])]
        got = self._broadcast(torch.tensor(local, dtype=torch.int64))
        t, hier = (int(v) for v in got.tolist())
        return None if t < 0 else (t, bool(hier))

    def _next_candidate(self) -> Optional[Candidate]:
        unprobed = [c for c in self.candidates if c not in self.probed]
        if not unprobed:
            return None
        if self._strategy_resolved == "sweep":
            return unprobed[0]
        if len(self.probed) >= self.max_probes:
            return None
        # Seeds: the default (probed first), the largest flat, then the
        # mid hierarchical candidate where there is one, else the mid
        # flat one.
        flats = [c for c in self.candidates if not c[1]]
        hiers = [c for c in self.candidates if c[1]]
        seeds = []
        if flats:
            seeds.append(flats[-1])
        if hiers:
            seeds.append(hiers[len(hiers) // 2])
        elif flats:
            seeds.append(flats[len(flats) // 2])
        for seed in seeds:
            if seed not in self.probed and seed in unprobed:
                return seed
        # EI within a category, alternating between the categories that
        # still have unprobed candidates.
        for _ in range(2):
            self._ei_category = not self._ei_category
            pool = [c for c in unprobed if c[1] == self._ei_category]
            if pool:
                break
        else:
            pool = unprobed
        if not pool:
            return unprobed[0]
        known = [(k, v) for k, v in self.probed.items()
                 if k[1] == pool[0][1]]
        if len(known) >= 2:
            i = ei_next([self._xform(k[0]) for k, _ in known],
                        [v for _, v in known],
                        [self._xform(c[0]) for c in pool])
            if i >= 0:
                return pool[i]
        return pool[0]

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from the job's rank 0, on every rank (over the job's
        group, on the job's device)."""
        t = t.to(basics.device())
        dist.broadcast(t, src=basics.job_ranks()[0],
                       group=basics.job_group())
        return t.cpu()

    def _sync_value(self, value: float) -> float:
        """Rank 0's measurement as float32 (identity in a job of one)."""
        if basics.size() <= 1:
            return value
        got = self._broadcast(torch.tensor([value], dtype=torch.float32))
        return float(got[0])

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None

    # -- logging ------------------------------------------------------------

    def _log_line(self, kind: str, cand: Candidate, score: float) -> None:
        self._samples += 1
        if self._log is not None:
            # The native tuner's TSV columns (sample index, kind,
            # threshold bytes, cycle ms (none here), score) and a sixth,
            # hierarchical 0/1.
            self._log.write(f"{self._samples}\t{kind}\t{cand[0]}\t0.0\t"
                            f"{score}\t{int(cand[1])}\n")
            self._log.flush()


def active() -> Optional[StepAutotuner]:
    """The job's tuner (``HOROVOD_AUTOTUNE``), or None."""
    st = basics._state
    return st.autotuner if st.initialized else None


def generation() -> int:
    """The tuner's generation (0 without a tuner): what every holder of
    a bucket plan keys on."""
    tuner = active()
    return 0 if tuner is None else tuner.generation


# Set while a handle's call runs: a handle called inside it (the
# optimizer's step inside a window or an SPMD region) is not counted.
_dispatching: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_tuned_dispatch", default=False)


def tuned_call(handle, fn: Callable, sync=None):
    """Run ``fn()`` as one dispatch of ``handle`` and return its result.
    With a tuner that has not converged, the dispatch counts towards its
    window (when ``handle`` owns it), and at a window's end the tuner
    waits for ``sync`` (default: the result) and scores the window."""
    tuner = active()
    if tuner is None or _dispatching.get():
        return fn()
    token = _dispatching.set(True)
    try:
        out = fn()
    finally:
        _dispatching.reset(token)
    if (not tuner.converged and tuner.claim(handle)
            and tuner.step_done()):
        tuner.end_window(out if sync is None else sync)
    return out
