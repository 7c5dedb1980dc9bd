"""Pathwise yield curves and curve interpolators (the port's copy of
``finite_difference_tpu.market_data.yield_curve``, host numpy).

Reconstruction of the reference's absent ``market_data/yield_curve.py`` and
``utils/interpolation.hermite_rt_interp`` (interfaces from ir_swap.py:249-253,
test_1.py:11): a curve is (year_fracs (n_tenors,), zero rates
(n_paths, n_tenors), interpolator), vectorized across simulation paths.

- ``linear_interp``     : linear in the zero rate;
- ``hermite_rt_interp`` : cubic Hermite with Bessel tangents on r(t)*t
  (the RiskFlow 'HermiteRT' convention) — interpolating the log-discount
  preserves forward-rate smoothness;
- discount factors DF(t) = exp(-r(t) * t) (continuous compounding);
- ``forward_rate(t0, t1, tau)`` = (DF(t0)/DF(t1) - 1) / tau (simple).

All query shapes broadcast: rates (n_paths, n_tenors) x query (m,) ->
(n_paths, m). Flat extrapolation outside the tenor range.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _hermite_tangents(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bessel tangents: weighted average of adjacent secant slopes; parabolic
    (2d - m) end conditions. Linear in y."""
    hs = np.diff(x)  # (n-1,)
    d = np.diff(y, axis=1) / hs[None, :]  # (n_paths, n-1)
    m = np.empty_like(y)
    if x.size > 2:
        w = hs[None, 1:] * d[:, :-1] + hs[None, :-1] * d[:, 1:]
        m[:, 1:-1] = w / (hs[:-1] + hs[1:])[None, :]
        m[:, 0] = 2.0 * d[:, 0] - m[:, 1]
        m[:, -1] = 2.0 * d[:, -1] - m[:, -2]
    else:
        m[:, 0] = d[:, 0]
        m[:, -1] = d[:, -1]
    return m


def _tangent_matrix(x: np.ndarray) -> np.ndarray:
    """(n, n) map Tm with tangents = y @ Tm (tangents are linear in y)."""
    n = x.size
    return _hermite_tangents(x, np.eye(n))


def _interp_weight_matrix(
    x: np.ndarray,
    xq: np.ndarray,
    hermite: bool,
    tangent_mat: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(n, m) weight matrix W with values = y @ W.

    Both linear and Hermite-Bessel interpolation are LINEAR in the node
    values y, so a whole query set reduces to one small GEMM
    (n_paths, n) @ (n, m) — this is what makes pathwise curve lookups
    cheap at 50k paths (docs/PERF_NOTES.md, exposure-engine section).
    Flat extrapolation outside [x_0, x_{n-1}] via clipping.
    """
    n = x.size
    xq = np.clip(np.asarray(xq, dtype=np.float64), x[0], x[-1])
    m = xq.size
    W = np.zeros((n, m))
    if n == 1:
        W[0, :] = 1.0
        return W

    j = np.clip(np.searchsorted(x, xq, side="right"), 1, n - 1)
    i = j - 1
    h = x[j] - x[i]
    t = (xq - x[i]) / np.where(h == 0.0, 1.0, h)
    cols = np.arange(m)

    if not hermite:
        np.add.at(W, (i, cols), 1.0 - t)
        np.add.at(W, (j, cols), t)
        return W

    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = (t3 - 2 * t2 + t) * h
    h01 = -2 * t3 + 3 * t2
    h11 = (t3 - t2) * h

    np.add.at(W, (i, cols), h00)
    np.add.at(W, (j, cols), h01)
    # tangent contributions: m = y @ Tm, so the weight picks up Tm columns
    Wt = np.zeros((n, m))
    np.add.at(Wt, (i, cols), h10)
    np.add.at(Wt, (j, cols), h11)
    Tm = _tangent_matrix(x) if tangent_mat is None else tangent_mat
    W += Tm @ Wt
    return W


def _interp_core(x: np.ndarray, y: np.ndarray, xq: np.ndarray, hermite: bool):
    """y (n_paths, n) over nodes x (n,) evaluated at xq (m,)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if y.ndim == 1:
        y = y[None, :]
    xq = np.atleast_1d(np.asarray(xq, dtype=np.float64))
    return y @ _interp_weight_matrix(x, xq, hermite)


def linear_interp(year_fracs, rates, t_query) -> np.ndarray:
    """Linear interpolation of the zero rate."""
    return _interp_core(year_fracs, rates, t_query, hermite=False)


def _hermite_rt_weights(
    x: np.ndarray, tq: np.ndarray, tangent_mat: Optional[np.ndarray] = None
) -> np.ndarray:
    """(n, m) weights with zero_rate = rates @ W (the r*t scaling and the
    1/t division folded into the weights; r(0) limit = first node's rate)."""
    tq_c = np.clip(np.asarray(tq, dtype=np.float64), x[0], x[-1])
    W = _interp_weight_matrix(x, tq_c, hermite=True, tangent_mat=tangent_mat)
    # rt = rates * x  =>  fold x into the rows; divide columns by t
    safe_t = np.where(tq_c == 0.0, 1.0, tq_c)
    W = (x[:, None] * W) / safe_t[None, :]
    at_zero = tq_c == 0.0
    if at_zero.any():
        W[:, at_zero] = 0.0
        W[0, at_zero] = 1.0
    return W


def hermite_rt_interp(year_fracs, rates, t_query) -> np.ndarray:
    """Hermite-Bessel interpolation on r*t, returned as a zero rate."""
    x = np.asarray(year_fracs, dtype=np.float64)
    r = np.asarray(rates, dtype=np.float64)
    if r.ndim == 1:
        r = r[None, :]
    tq = np.atleast_1d(np.asarray(t_query, dtype=np.float64))
    return r @ _hermite_rt_weights(x, tq)


class YieldCurve:
    """Pathwise zero-rate curve (market_data/yield_curve.py reconstruction).

    Parameters
    ----------
    year_fracs : (n_tenors,) node year fractions from the curve anchor.
    rates : (n_paths, n_tenors) continuously-compounded zero rates.
    interpolator : callable (year_fracs, rates, t_query) -> (n_paths, m);
        defaults to :func:`hermite_rt_interp`.
    """

    def __init__(
        self,
        year_fracs,
        rates,
        interpolator: Optional[Callable] = None,
    ) -> None:
        self.year_fracs = np.asarray(year_fracs, dtype=np.float64)
        r = np.asarray(rates, dtype=np.float64)
        self.rates = r[None, :] if r.ndim == 1 else r
        self.interpolator = interpolator or hermite_rt_interp
        # the tangent matrix depends only on the tenor grid; cache it so
        # each query costs one (n, m) weight build + one small GEMM
        self._tangent_mat: Optional[np.ndarray] = None

    @property
    def n_paths(self) -> int:
        return self.rates.shape[0]

    def zero_rate(self, t_query) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t_query, dtype=np.float64))
        if self.interpolator is hermite_rt_interp:
            if self._tangent_mat is None and self.year_fracs.size > 1:
                self._tangent_mat = _tangent_matrix(self.year_fracs)
            return self.rates @ _hermite_rt_weights(
                self.year_fracs, t, tangent_mat=self._tangent_mat
            )
        return self.interpolator(self.year_fracs, self.rates, t)

    def discount_factor(self, t_query) -> np.ndarray:
        """DF(0 -> t) per path: (n_paths, m)."""
        t = np.atleast_1d(np.asarray(t_query, dtype=np.float64))
        r = self.zero_rate(t)  # fresh array — safe to consume in place
        r *= -np.maximum(t, 0.0)[None, :]
        return np.exp(r, out=r)

    def forward_rate(self, t_start: float, t_end: float, tau: Optional[float] = None):
        """Simple forward rate over [t_start, t_end]: (n_paths,)."""
        if tau is None:
            tau = t_end - t_start
        df = self.discount_factor(np.array([t_start, t_end]))
        if tau <= 0.0:
            return np.zeros(self.n_paths)
        return (df[:, 0] / df[:, 1] - 1.0) / float(tau)

    def forward_nacc_rate(self, t_start: float, t_end: float):
        """Continuously-compounded forward rate over [t_start, t_end]."""
        tau = t_end - t_start
        if tau <= 0.0:
            return np.zeros(self.n_paths)
        df = self.discount_factor(np.array([t_start, t_end]))
        return np.log(df[:, 0] / df[:, 1]) / tau
