"""Equity forward prices and TRS return-leg PV (the port's copy of
``finite_difference_tpu.instruments.equity_pv``, host numpy).

Reconstruction of the reference's absent ``models.equity_pv``
(``equity_forward_price``, ``trs_return_leg_pv``) and the cashflow helpers
``filter_future_periods`` / ``compute_period_year_fractions`` from their
call sites (equity_trs.py:470-586).

Conventions:
- F(t) = S * DF_div(t) / DF_carry(t) (cost-of-carry forward on the pathwise
  carry and dividend-yield curves); with a settlement anchor t0 > 0 the
  growth runs from t0: F = S * (DF_d(t)/DF_d(t0)) / (DF_c(t)/DF_c(t0));
- "Price" nominal scaling: period payoff = quantity * (F_end - F_start);
- "Initial Price": payoff = notional_fixed * (F_end/F_start - 1);
- an in-progress first period uses the locked start reference
  (initial_price scalar or the engine-stamped per-path fixing).
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..market_data.yield_curve import YieldCurve
from ..utils.daycount import year_fraction


def filter_future_periods(
    schedule: List[Tuple[dt.date, dt.date, dt.date, float]],
    val_date: dt.date,
    include_on_val_date: bool = False,
) -> List[Tuple[dt.date, dt.date, dt.date, float]]:
    """Periods whose payment is still outstanding at val_date."""
    out = []
    for p in schedule:
        pay = p[2]
        if pay > val_date or (pay == val_date and include_on_val_date):
            out.append(p)
    return out


def compute_period_year_fractions(
    periods: List[Tuple[dt.date, dt.date, dt.date, float]],
    val_date: dt.date,
    curve_day_count: str = "ACT/365",
):
    """(t_starts, t_ends, t_pays, accruals) arrays measured from val_date.

    Start/end year fractions are signed (negative when the date is past),
    which is how the pricing code distinguishes in-progress periods.
    """
    t_starts = np.array(
        [
            (1 if s >= val_date else -1) * year_fraction(min(s, val_date), max(s, val_date), curve_day_count)
            for s, _, _, _ in periods
        ]
    )
    t_ends = np.array(
        [
            (1 if e >= val_date else -1) * year_fraction(min(e, val_date), max(e, val_date), curve_day_count)
            for _, e, _, _ in periods
        ]
    )
    t_pays = np.array(
        [year_fraction(val_date, p, curve_day_count) for _, _, p, _ in periods]
    )
    accruals = np.array([a for _, _, _, a in periods])
    return t_starts, t_ends, t_pays, accruals


def equity_forward_price(
    spot: np.ndarray,
    carry_curve: YieldCurve,
    dividend_curve: Optional[YieldCurve],
    t: float,
    t0: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(F, df_carry, df_div) at horizon t (anchored at t0 when t0 > 0)."""
    ts = np.array([max(t0, 0.0), max(t, t0, 0.0)])
    df_c = carry_curve.discount_factor(ts)
    growth = df_c[:, 0] / df_c[:, 1]
    if dividend_curve is not None:
        df_d = dividend_curve.discount_factor(ts)
        div_decay = df_d[:, 1] / df_d[:, 0]
    else:
        df_d = np.ones_like(df_c)
        div_decay = np.ones(df_c.shape[0])
    return spot * growth * div_decay, df_c[:, 1], df_d[:, 1]


def trs_return_leg_pv(
    *,
    spot: np.ndarray,
    carry_curve: YieldCurve,
    dividend_curve: Optional[YieldCurve],
    discount_curve: YieldCurve,
    t_starts: np.ndarray,
    t_ends: np.ndarray,
    t_pays: np.ndarray,
    quantity: float,
    initial_price: Union[float, np.ndarray, None],
    nominal_scaling: str = "Price",
    notional_fixed: float = 0.0,
    end_fixings: Optional[List[Optional[np.ndarray]]] = None,
    t_settle: float = 0.0,
) -> np.ndarray:
    """PV of the TRS return leg over the outstanding periods: (n_paths,).

    Three period cases (equity_trs.py:470-510):
    1. future (t_start > 0): both F_start and F_end are forwards;
    2. in-progress (t_start <= 0 < t_end): F_start locked to initial_price;
    3. completed-but-unpaid (t_end <= 0): both locked — F_end comes from
       ``end_fixings[i]`` (engine-stamped), else today's spot.
    """
    n_paths = spot.shape[0]
    m = len(t_starts)
    if m == 0:
        return np.zeros(n_paths)

    # BATCHED curve queries: one growth-factor evaluation covers the anchor
    # t0 and every forward start/end, one discount call covers all pays
    # (the per-period single-point calls were a measured exposure-engine
    # hot spot; docs/PERF_NOTES.md).
    qs = np.concatenate(
        [[max(t_settle, 0.0)],
         np.maximum(np.asarray(t_starts, float) + t_settle, max(t_settle, 0.0)),
         np.maximum(np.asarray(t_ends, float) + t_settle, max(t_settle, 0.0))]
    )
    df_c = carry_curve.discount_factor(qs)          # (n_paths, 1+2m)
    growth = df_c[:, :1] / df_c                      # df_c(t0)/df_c(t)
    if dividend_curve is not None:
        df_d = dividend_curve.discount_factor(qs)
        growth = growth * (df_d / df_d[:, :1])       # * df_d(t)/df_d(t0)
    fwd_start_all = spot[:, None] * growth[:, 1 : 1 + m]
    fwd_end_all = spot[:, None] * growth[:, 1 + m :]
    dfs_pay = discount_curve.discount_factor(np.asarray(t_pays, float))

    f_start_cols = np.empty((n_paths, m), order="F")
    f_end_cols = np.empty((n_paths, m), order="F")
    for i in range(m):
        if float(t_starts[i]) > 0:
            f_start_cols[:, i] = fwd_start_all[:, i]
        elif i == 0 and initial_price is not None:
            f_start_cols[:, i] = (
                np.asarray(initial_price, dtype=np.float64)
                if np.ndim(initial_price) > 0
                else float(initial_price)
            )
        else:
            f_start_cols[:, i] = spot
        if float(t_ends[i]) > 0:
            f_end_cols[:, i] = fwd_end_all[:, i]
        else:
            stamped = end_fixings[i] if end_fixings is not None else None
            f_end_cols[:, i] = (
                np.asarray(stamped, dtype=np.float64)
                if stamped is not None
                else spot
            )

    if nominal_scaling == "Price":
        payoff = quantity * (f_end_cols - f_start_cols)
    else:  # "Initial Price"
        safe_start = np.where(f_start_cols == 0.0, 1.0, f_start_cols)
        payoff = notional_fixed * (f_end_cols / safe_start - 1.0)
    return np.einsum("pm,pm->p", dfs_pay, payoff)
