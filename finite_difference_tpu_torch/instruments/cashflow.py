"""Swap legs and pathwise leg PV (the port's copy of
``finite_difference_tpu.instruments.cashflow``, host numpy).

Reconstruction of the reference's absent ``instruments.components.
cashflow_leg`` (SwapLeg/LegType) and ``models.cashflow_pv.leg_pv``
(SURVEY §2.9; call sites ir_swap.py:236-279):

- FIXED legs: coupon = fixed_rate * accrual * notional at each payment;
- FLOATING legs: period rate from the cached fixing when the period has
  started (the engine stamps it once at the reset date), else the simple
  forward from the scenario curve;
- OIS legs (overnight_compounding): rate = (CF_realized * CF_future - 1) /
  accrual, CF_realized from the engine's incremental cache, CF_future =
  DF(max(p_start, val_date))/DF(p_end) on the pathwise curve (forward
  periods compound over the period only);
- compounded reset legs (reset_frequency_months > 0): the period coupon
  compounds sub-period rates, each sub-period resolved fixing-or-forward;
- payments strictly after the valuation date (or on it when
  ``include_on_val_date``).

Everything is vectorized over paths ((n_paths,) arrays end to end).
"""
from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve
from .schedule import ScheduleConfig, add_months, adjust, generate_sub_periods


class LegType(Enum):
    FIXED = "fixed"
    FLOATING = "floating"


@dataclass(frozen=True)
class SwapLeg:
    leg_type: LegType
    frequency: int  # payment frequency in months
    curve_name: Optional[str] = None  # projection curve for floating legs
    fixed_rate: float = 0.0
    spread: float = 0.0
    overnight_compounding: bool = False
    reset_frequency_months: int = 0
    fixing_tenor_months: Optional[int] = None
    forward_business_convention: Optional[str] = None


# Backwards-friendly alias matching the reference import
CashflowLeg = SwapLeg


def _period_rate(
    leg: SwapLeg,
    sc: ScheduleConfig,
    val_date: dt.date,
    p_start: dt.date,
    p_end: dt.date,
    accrual: float,
    fwd_curve: Optional[YieldCurve],
    fixings: Optional[Dict[Tuple[str, dt.date], np.ndarray]],
    n_paths: int,
) -> np.ndarray:
    """Simple period rate for one floating period, fixing-or-forward."""
    if leg.overnight_compounding:
        cf_realized = np.ones(n_paths)
        if fixings is not None and (leg.curve_name, p_start) in fixings:
            cf_realized = np.asarray(fixings[(leg.curve_name, p_start)], dtype=float)
        # future compounding runs from the LATER of the period start and
        # the valuation date: an in-progress period's realized part is the
        # stamped cache (from p_start to val_date), a forward-starting
        # period compounds only over [p_start, p_end] — NOT from val_date,
        # which would wrongly include growth over [val_date, p_start]
        t_now = sc.curve_year_fraction(val_date, max(p_start, val_date))
        t_end = sc.curve_year_fraction(val_date, p_end)
        if t_end > t_now and fwd_curve is not None:
            df = fwd_curve.discount_factor(np.array([t_now, t_end]))
            cf_future = df[:, 0] / df[:, 1]
        else:
            cf_future = np.ones(n_paths)
        if accrual <= 0.0:
            return np.zeros(n_paths)
        return (cf_realized * cf_future - 1.0) / accrual

    if p_start <= val_date:
        # period already started: the engine must have stamped the fixing
        if fixings is not None and (leg.curve_name, p_start) in fixings:
            return np.asarray(fixings[(leg.curve_name, p_start)], dtype=float)
        # fall through to a forward from today's curve (degenerate fallback
        # mirroring the reference's permissive behaviour)

    if fwd_curve is None:
        return np.zeros(n_paths)

    t_start = sc.curve_year_fraction(val_date, max(p_start, val_date))
    if leg.fixing_tenor_months is not None:
        fwd_conv = leg.forward_business_convention or "ModifiedFollowing"
        fix_end = adjust(
            add_months(p_start, leg.fixing_tenor_months), sc.cal, fwd_conv
        )
        t_end = sc.curve_year_fraction(val_date, fix_end)
        fwd_tau = sc.year_fraction(p_start, fix_end)
        return fwd_curve.forward_rate(t_start, t_end, tau=fwd_tau)
    t_end = sc.curve_year_fraction(val_date, p_end)
    return fwd_curve.forward_rate(t_start, t_end)


def leg_pv(
    schedule: List[Tuple[dt.date, dt.date, dt.date, float]],
    leg: SwapLeg,
    *,
    notional: float,
    val_date: dt.date,
    market_state: Dict[str, object],
    discount_curve: YieldCurve,
    n_paths: int,
    schedule_config: ScheduleConfig,
    fixings: Optional[Dict[Tuple[str, dt.date], np.ndarray]] = None,
    include_on_val_date: bool = False,
) -> np.ndarray:
    """Pathwise PV of one swap leg: (n_paths,).

    Curve queries are BATCHED: one ``discount_factor`` call covers every
    payment date, and one covers every pending forward bracket — the
    per-period single-point interpolation calls were the exposure
    engine's measured hot spot (docs/PERF_NOTES.md).
    """
    sc = schedule_config

    fwd_curve = None
    if leg.leg_type == LegType.FLOATING and leg.curve_name is not None:
        fwd_slice: CurveSlice = market_state[leg.curve_name]
        fwd_curve = YieldCurve(
            year_fracs=fwd_slice.tenors, rates=fwd_slice.values
        )

    live = [
        (p_start, p_end, pay_date, accrual)
        for p_start, p_end, pay_date, accrual in schedule
        if not (
            pay_date < val_date
            or (pay_date == val_date and not include_on_val_date)
        )
    ]
    if not live:
        return np.zeros(n_paths)
    m = len(live)

    # F-order: the per-period column writes below are then contiguous
    rate_cols = np.empty((n_paths, m), order="F")
    pending: List[Tuple[int, float, float, float]] = []  # col, t0, t1, tau
    for col, (p_start, p_end, pay_date, accrual) in enumerate(live):
        if leg.leg_type == LegType.FIXED:
            rate_cols[:, col] = leg.fixed_rate
        elif leg.reset_frequency_months > 0:
            # compounded sub-period rates: prod(1 + r_i tau_i) - 1 over accrual
            growth = np.ones(n_paths)
            for sub_start, sub_end, sub_tau in generate_sub_periods(
                p_start, p_end, leg.reset_frequency_months,
                sc.cal, sc.business_convention, sc.day_count,
                direction="Backward",
            ):
                r_sub = _period_rate(
                    leg, sc, val_date, sub_start, sub_end, sub_tau,
                    fwd_curve, fixings, n_paths,
                )
                growth = growth * (1.0 + r_sub * sub_tau)
            rate_cols[:, col] = (
                (growth - 1.0) / accrual if accrual > 0 else 0.0
            )
        elif leg.overnight_compounding:
            rate_cols[:, col] = _period_rate(
                leg, sc, val_date, p_start, p_end, accrual,
                fwd_curve, fixings, n_paths,
            )
        else:
            # same policy as _period_rate, with the forward batched
            if (
                p_start <= val_date
                and fixings is not None
                and (leg.curve_name, p_start) in fixings
            ):
                rate_cols[:, col] = np.asarray(
                    fixings[(leg.curve_name, p_start)], dtype=float
                )
            elif fwd_curve is None:
                rate_cols[:, col] = 0.0
            else:
                t_start = sc.curve_year_fraction(val_date, max(p_start, val_date))
                if leg.fixing_tenor_months is not None:
                    fwd_conv = leg.forward_business_convention or "ModifiedFollowing"
                    fix_end = adjust(
                        add_months(p_start, leg.fixing_tenor_months), sc.cal, fwd_conv
                    )
                    t_end = sc.curve_year_fraction(val_date, fix_end)
                    fwd_tau = sc.year_fraction(p_start, fix_end)
                else:
                    t_end = sc.curve_year_fraction(val_date, p_end)
                    fwd_tau = t_end - t_start
                pending.append((col, t_start, t_end, fwd_tau))

    if pending:
        ts = np.array([t for _, t0, t1, _ in pending for t in (t0, t1)])
        df = fwd_curve.discount_factor(ts)  # (n_paths, 2k)
        taus = np.array([tau for _, _, _, tau in pending])
        fwds = (df[:, 0::2] / df[:, 1::2] - 1.0) / np.where(taus <= 0.0, 1.0, taus)
        fwds[:, taus <= 0.0] = 0.0
        rate_cols[:, [col for col, _, _, _ in pending]] = fwds

    t_pays = np.array(
        [sc.curve_year_fraction(val_date, pay) for _, _, pay, _ in live]
    )
    dfs = discount_curve.discount_factor(t_pays)  # (n_paths, m)
    accr = np.array([acc for _, _, _, acc in live])
    rate_cols += leg.spread
    return np.einsum("pm,pm,m->p", dfs, rate_cols, accr) * notional
