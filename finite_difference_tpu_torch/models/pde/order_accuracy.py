"""Empirical order-of-accuracy diagnostics for FD pricers (host numpy; the
port's own copy of ``finite_difference_tpu.models.pde.order_accuracy``).

Capability parity with the reference's convergence-order block
(discrete_barrier_fdm_pricer_cn.py:691-779 diagnose_order_of_accuracy,
:795-917 compute_empirical_order, :1050-1177 greek_order_of_accuracy,
:1192-1360 fd_order_accuracy_diagnostic): refine N_time on a ladder,
regress log|err| on log(dt) for the empirical order p, extrapolate the
reference value from the finest pair, predict the truncation error at a
production step count (FA uses N=30), and issue a CONSISTENT / EXCEEDS
verdict against an observed difference with a safety buffer.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def compute_empirical_order(
    price_fn: Callable[[int], float],
    n_ladder: Sequence[int] = (40, 80, 160, 320, 640),
    t_expiry: float = 1.0,
    richardson_reference: bool = True,
) -> Dict[str, object]:
    """Empirical convergence order from a time-step refinement ladder.

    ``price_fn(n_time)`` prices at a given step count. The reference value
    is the Richardson extrapolation of the two finest prices (or the finest
    price when ``richardson_reference`` is False); the order p comes from
    the least-squares slope of log|err| vs log(dt).
    """
    n_ladder = sorted(int(n) for n in n_ladder)
    prices = np.array([price_fn(n) for n in n_ladder])
    dts = t_expiry / np.asarray(n_ladder, dtype=float)

    # Fit on consecutive differences |P_n - P_{n_next}| ~ C (1 - s^-p) dt^p
    # (s = refinement ratio): unbiased without knowing the exact solution,
    # unlike regressing against the finest price directly.
    diffs = np.abs(np.diff(prices))
    diff_dts = dts[:-1]
    mask = diffs > 1e-15
    if mask.sum() >= 2:
        slope, diff_intercept = np.polyfit(
            np.log(diff_dts[mask]), np.log(diffs[mask]), 1
        )
    else:
        slope, diff_intercept = np.nan, np.nan

    # recover the error-law intercept: |P_n - ref| = C dt^p with
    # C = exp(diff_intercept) / (1 - s^-p) for the ladder's (geometric) ratio
    ratio = n_ladder[1] / n_ladder[0] if len(n_ladder) > 1 else 2.0
    if np.isfinite(slope) and ratio > 1.0:
        shrink = 1.0 - ratio ** (-slope)
        intercept = diff_intercept - np.log(max(shrink, 1e-12))
    else:
        intercept = np.nan

    if richardson_reference and len(prices) >= 2 and np.isfinite(slope):
        s_p = ratio**slope
        ref = (s_p * prices[-1] - prices[-2]) / (s_p - 1.0)
    else:
        ref = prices[-1]

    errs = np.abs(prices - ref)
    return {
        "n_ladder": list(n_ladder),
        "dts": dts.tolist(),
        "prices": prices.tolist(),
        "reference_price": float(ref),
        "errors": errs.tolist(),
        "order": float(slope),
        "log_intercept": float(intercept),
    }


def predict_truncation_error(
    order_result: Dict[str, object], n_production: int, t_expiry: float = 1.0
) -> float:
    """|err(N)| predicted from the fitted power law err = C * dt^p."""
    p = order_result["order"]
    c = np.exp(order_result["log_intercept"])
    if not np.isfinite(p):
        return float("nan")
    return float(c * (t_expiry / n_production) ** p)


def diagnose_order_of_accuracy(
    price_fn: Callable[[int], float],
    observed_difference: float,
    *,
    n_production: int = 30,
    n_ladder: Sequence[int] = (40, 80, 160, 320, 640),
    t_expiry: float = 1.0,
    buffer: float = 1.5,
) -> Dict[str, object]:
    """Is an observed model-vs-benchmark difference explained by FD
    truncation at the benchmark's production step count?

    Mirrors the reference verdict logic
    (discrete_barrier_fdm_pricer_cn.py:691-779, buffer 1.5x at :996):
    CONSISTENT when |observed| <= buffer * predicted truncation error at
    ``n_production``, else EXCEEDS.
    """
    fit = compute_empirical_order(price_fn, n_ladder, t_expiry)
    predicted = predict_truncation_error(fit, n_production, t_expiry)
    verdict = (
        "CONSISTENT"
        if np.isfinite(predicted) and abs(observed_difference) <= buffer * predicted
        else "EXCEEDS"
    )
    return {
        **fit,
        "n_production": int(n_production),
        "predicted_truncation_error": predicted,
        "observed_difference": float(observed_difference),
        "buffer": float(buffer),
        "verdict": verdict,
    }


def greek_order_of_accuracy(
    greek_fn: Callable[[int], float],
    n_ladder: Sequence[int] = (40, 80, 160, 320),
    t_expiry: float = 1.0,
) -> Dict[str, object]:
    """Convergence order of a greek (discrete_barrier_fdm_pricer_cn.py:1050-1177)."""
    return compute_empirical_order(greek_fn, n_ladder, t_expiry)
