"""Gaussian-process regression and expected improvement in float64: the
port's own copy of the native tuner's surrogate (``csrc/autotune/
gaussian_process.cc``, ``bayesian_optimization.cc`` and the
``hvdtpu_ei_next`` entry of ``csrc/c_api.cc``), which the JAX package
reaches through its C++ core and the port does not build.

The loops keep the C++ order of every sum and product, and ``math``
calls the same libm functions as ``<cmath>``, so :func:`ei_next` returns
the native index for the same observations and candidates. The sizes
are small (the step tuner observes at most 18 points), so plain Python
serves.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

# gaussian_process.h's defaults and FitWithHyperparameters' grid.
DEFAULT_LENGTH_SCALE = 0.3
DEFAULT_SIGNAL_VARIANCE = 1.0
DEFAULT_NOISE_VARIANCE = 1e-4
LENGTH_SCALES = (0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 2.0)
SIGNAL_VARIANCES = (0.25, 0.5, 1.0, 2.0, 4.0)
_LOG_2PI = 1.8378770664093453


def cholesky_factor(a: List[float], n: int) -> bool:
    """Lower Cholesky factor of the row-major ``n`` x ``n`` matrix ``a``,
    in place; False when it is not positive definite."""
    for i in range(n):
        for j in range(i + 1):
            s = a[i * n + j]
            for k in range(j):
                s -= a[i * n + k] * a[j * n + k]
            if i == j:
                if s <= 0.0:
                    return False
                a[i * n + j] = math.sqrt(s)
            else:
                a[i * n + j] = s / a[j * n + j]
        for j in range(i + 1, n):
            a[i * n + j] = 0.0
    return True


def forward_sub(low: Sequence[float], n: int, b: List[float]) -> None:
    """Solve ``L z = b`` in place."""
    for i in range(n):
        s = b[i]
        for k in range(i):
            s -= low[i * n + k] * b[k]
        b[i] = s / low[i * n + i]


def back_sub(low: Sequence[float], n: int, b: List[float]) -> None:
    """Solve ``L^T z = b`` in place."""
    for i in range(n - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, n):
            s -= low[k * n + i] * b[k]
        b[i] = s / low[i * n + i]


class GaussianProcess:
    """RBF-kernel GP regressor over points in the unit box."""

    def __init__(self, length_scale: float = DEFAULT_LENGTH_SCALE,
                 signal_variance: float = DEFAULT_SIGNAL_VARIANCE,
                 noise_variance: float = DEFAULT_NOISE_VARIANCE):
        self.length_scale = length_scale
        self.signal_variance = signal_variance
        self.noise_variance = noise_variance
        self.fitted = False
        self._x: list = []
        self._y: list = []
        self._alpha: list = []
        self._chol: list = []
        self._n = 0

    def kernel(self, a: Sequence[float], b: Sequence[float]) -> float:
        d2 = 0.0
        for u, v in zip(a, b):
            d = u - v
            d2 += d * d
        return self.signal_variance * math.exp(
            -d2 / (2.0 * self.length_scale * self.length_scale))

    def fit(self, x: Sequence[Sequence[float]], y: Sequence[float]) -> bool:
        n = self._n = len(x)
        if n == 0:
            return False
        self._x, self._y = list(x), list(y)
        chol = [0.0] * (n * n)
        for i in range(n):
            for j in range(n):
                chol[i * n + j] = self.kernel(x[i], x[j]) + (
                    self.noise_variance if i == j else 0.0)
        self._chol = chol
        if not cholesky_factor(chol, n):
            self.fitted = False
            return False
        alpha = list(y)
        forward_sub(chol, n, alpha)
        back_sub(chol, n, alpha)
        self._alpha = alpha
        self.fitted = True
        return True

    def log_marginal_likelihood(self) -> float:
        """``-1/2 y^T alpha - sum(log L_ii) - n/2 log(2 pi)``."""
        if not self.fitted:
            return -1e300
        n = self._n
        fit_term = 0.0
        for i in range(n):
            fit_term += self._y[i] * self._alpha[i]
        log_det_half = 0.0
        for i in range(n):
            log_det_half += math.log(self._chol[i * n + i])
        return -0.5 * fit_term - log_det_half - 0.5 * n * _LOG_2PI

    def fit_with_hyperparameters(self, x, y) -> bool:
        """Two rounds of coordinate ascent of the log marginal likelihood
        over the length-scale grid, then the signal-variance grid."""
        best_lml = -1e300
        best_ls, best_sv = self.length_scale, self.signal_variance
        for _ in range(2):
            for ls in LENGTH_SCALES:
                self.length_scale, self.signal_variance = ls, best_sv
                if not self.fit(x, y):
                    continue
                lml = self.log_marginal_likelihood()
                if lml > best_lml:
                    best_lml, best_ls = lml, ls
            for sv in SIGNAL_VARIANCES:
                self.length_scale, self.signal_variance = best_ls, sv
                if not self.fit(x, y):
                    continue
                lml = self.log_marginal_likelihood()
                if lml > best_lml:
                    best_lml, best_sv = lml, sv
        self.length_scale, self.signal_variance = best_ls, best_sv
        return self.fit(x, y)

    def predict(self, x: Sequence[float]) -> Tuple[float, float]:
        """Posterior mean and variance (floored at 1e-12) at ``x``."""
        if not self.fitted:
            return 0.0, self.signal_variance
        n = self._n
        k = [self.kernel(x, self._x[i]) for i in range(n)]
        mu = 0.0
        for i in range(n):
            mu += k[i] * self._alpha[i]
        v = list(k)
        forward_sub(self._chol, n, v)
        vtv = 0.0
        for i in range(n):
            vtv += v[i] * v[i]
        var = self.kernel(x, x) - vtv
        return mu, var if var > 1e-12 else 1e-12


def _normal_pdf(z: float) -> float:
    return math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _normal_cdf(z: float) -> float:
    return 0.5 * math.erfc(-z / math.sqrt(2.0))


class BayesianOptimization:
    """Expected improvement over a GP fitted to standardised scores, in
    the box ``bounds`` (one ``(lo, hi)`` a dimension), normalised to the
    unit box."""

    def __init__(self, bounds: Sequence[Tuple[float, float]],
                 xi: float = 0.01):
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        self.xi = xi
        self._x: list = []
        self._y: list = []

    def normalize(self, x: Sequence[float]) -> List[float]:
        z = []
        for v, (lo, hi) in zip(x, self.bounds):
            span = hi - lo
            z.append((v - lo) / span if span > 0 else 0.0)
        return z

    def add_sample(self, x: Sequence[float], y: float) -> None:
        self._x.append(self.normalize(x))
        self._y.append(float(y))

    def expected_improvement(self, z, gp: GaussianProcess,
                             best: float) -> float:
        mu, var = gp.predict(z)
        sigma = math.sqrt(var)
        imp = mu - best - self.xi
        u = imp / sigma
        return imp * _normal_cdf(u) + sigma * _normal_pdf(u)

    def fit_standardized(self, gp: GaussianProcess) -> Optional[float]:
        """Fit ``gp`` to the scores standardised (sd below 1e-12 taken as
        1); returns the best standardised score, or None when the fit
        fails."""
        ys = self._y
        if not ys:
            return None
        mean = 0.0
        for y in ys:
            mean += y
        mean /= len(ys)
        sd = 0.0
        for y in ys:
            sd += (y - mean) * (y - mean)
        sd = math.sqrt(sd / len(ys))
        if sd < 1e-12:
            sd = 1.0
        ynorm = [(y - mean) / sd for y in ys]
        if not gp.fit_with_hyperparameters(self._x, ynorm):
            return None
        return max(ynorm)

    def suggest_among(self, candidates) -> int:
        """Index of the candidate (denormalised coordinates) with the
        largest expected improvement, the first of equals; -1 with fewer
        than 2 samples, no candidate, or a failed fit."""
        if not candidates or len(self._x) < 2:
            return -1
        gp = GaussianProcess()
        best = self.fit_standardized(gp)
        if best is None:
            return -1
        best_idx, best_ei = -1, -1.0
        for i, c in enumerate(candidates):
            ei = self.expected_improvement(self.normalize(c), gp, best)
            if ei > best_ei:
                best_ei, best_idx = ei, i
        return best_idx


def ei_next(xs, ys, candidates, xi: float = 0.01) -> int:
    """Index of the candidate position that maximises expected
    improvement given the observed ``(position, score)`` pairs, over the
    span of the observations and the candidates; -1 with fewer than 2
    observations, no candidate, a span of 0, or a failed fit (the caller
    then takes its own order)."""
    xs = [float(v) for v in xs]
    ys = [float(v) for v in ys]
    cands = [float(v) for v in candidates]
    n = len(xs)
    if n < 2 or not cands:
        return -1
    lo = hi = xs[0]
    for v in xs + cands:
        lo, hi = min(lo, v), max(hi, v)
    if not hi - lo > 0:
        return -1
    bo = BayesianOptimization([(lo, hi)], xi)
    for x, y in zip(xs, ys):
        bo.add_sample([x], y)
    return bo.suggest_among([[c] for c in cands])
