"""Inflation leg pricing: CPI level resolution and leg PV (the port's copy of
``finite_difference_tpu.instruments.inflation_pv``, host numpy).

Reconstruction of the reference's absent ``models.inflation_pv`` from its
fragments (``get_cpi_level``, ``build_cpi_fixings``) and the
IndexLinkedSwap call sites (index_linked_swap.py:504-591):

- ``get_cpi_level``: pathwise CPI(ref_date) with two modes —
  * legacy: fixings -> historical map -> CPI-level curve interpolation;
  * RiskFlow two-curve (PriceIndex + InflationRate): dates at or before
    T_last_pub are true fixings; anything later (even calendar-past) is
    projected CPI(T_last_pub) / DF_infl(T_last_pub -> ref);
- ``inflation_leg_pv``: CF_i = N * CPI(ref_i)/base_cpi * accrual_i *
  real_rate, plus the final indexed notional exchange, discounted on the
  pathwise nominal curve.
"""
from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..market_data.cpi import besa_bracket, first_of_month, interp_cpi, shift_months
from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve, linear_interp
from ..utils.daycount import year_fraction
from .schedule import ScheduleConfig


@dataclass(frozen=True)
class InflationLeg:
    """CPI-indexed leg parameters (interface from index_linked_swap.py:98-157)."""

    real_rate: float
    base_cpi: float
    cpi_curve_name: str
    frequency: int = 3  # months
    lag_months: int = 4
    inflation_rate_curve_name: str = ""
    next_publication_date: Optional[dt.date] = None
    publication_frequency_months: int = 1
    pay_notional_at_maturity: bool = True


def get_cpi_level(
    ref_date: dt.date,
    val_date: dt.date,
    hist_map: Dict[dt.date, float],
    n_paths: int,
    curve_day_count: str = "ACT/365",
    cpi_fixings: Optional[Dict[dt.date, np.ndarray]] = None,
    spot_cpi: Optional[np.ndarray] = None,
    inflation_rate_curve: Optional[YieldCurve] = None,
    last_pub_date: Optional[dt.date] = None,
    cpi_interp: Optional[Callable[[float], np.ndarray]] = None,
) -> np.ndarray:
    """Pathwise CPI(ref_date): (n_paths,) (get_cpi_level fragment :1-91)."""
    use_riskflow = inflation_rate_curve is not None

    if not use_riskflow:
        if cpi_fixings is not None and ref_date in cpi_fixings:
            return np.asarray(cpi_fixings[ref_date], dtype=np.float64)
        if ref_date in hist_map:
            return np.full(n_paths, hist_map[ref_date], dtype=np.float64)
        if ref_date <= val_date:
            known = [k for k in hist_map if k <= val_date]
            if known:
                return np.full(n_paths, hist_map[max(known)], dtype=np.float64)
            return np.zeros(n_paths, dtype=np.float64)
        if cpi_interp is None:
            raise ValueError("cpi_interp is required in legacy CPI mode")
        t_ref = year_fraction(val_date, ref_date, curve_day_count)
        return np.asarray(cpi_interp(t_ref), dtype=np.float64)

    # RiskFlow-style mode: PriceIndex + InflationRate
    if last_pub_date is None:
        last_pub_date = shift_months(first_of_month(val_date), -1)

    if ref_date <= last_pub_date:
        if cpi_fixings is not None and ref_date in cpi_fixings:
            return np.asarray(cpi_fixings[ref_date], dtype=np.float64)
        if ref_date in hist_map:
            return np.full(n_paths, hist_map[ref_date], dtype=np.float64)
        raise ValueError(
            f"Missing published CPI fixing for ref_date={ref_date}; "
            f"last_pub_date={last_pub_date}."
        )

    # Projected from T_last_pub; deliberately ignore cpi_fixings[ref_date]
    # for unpublished dates (engine may pre-stamp before publication).
    anchor_cpi = _projection_anchor(
        last_pub_date, hist_map, n_paths, cpi_fixings, spot_cpi
    )
    t_ref = year_fraction(last_pub_date, ref_date, curve_day_count)
    df_infl = inflation_rate_curve.discount_factor(np.array([t_ref]))[:, 0]
    return anchor_cpi / df_infl


def _projection_anchor(
    anchor_date: dt.date,
    hist_map: Dict[dt.date, float],
    n_paths: int,
    cpi_fixings: Optional[Dict[dt.date, np.ndarray]],
    spot_cpi: Optional[np.ndarray],
) -> np.ndarray:
    """CPI(T_last_pub) the projection grows from: fixing > history > spot."""
    if cpi_fixings is not None and anchor_date in cpi_fixings:
        return np.asarray(cpi_fixings[anchor_date], dtype=np.float64)
    if anchor_date in hist_map:
        return np.full(n_paths, hist_map[anchor_date], dtype=np.float64)
    if spot_cpi is not None:
        return np.asarray(spot_cpi, dtype=np.float64)
    raise ValueError(f"Cannot determine CPI projection anchor at {anchor_date}.")


def inflation_leg_pv(
    schedule: List[Tuple[dt.date, dt.date, dt.date, float]],
    leg: InflationLeg,
    *,
    base_notional: float,
    val_date: dt.date,
    market_state: Dict[str, object],
    discount_curve: YieldCurve,
    n_paths: int,
    schedule_config: ScheduleConfig,
    historical_cpi_map: Dict[dt.date, float],
    include_on_val_date: bool = False,
    cpi_fixings: Optional[Dict[dt.date, np.ndarray]] = None,
    cpi_last_pub_date: Optional[dt.date] = None,
) -> np.ndarray:
    """Pathwise PV of the CPI-indexed leg: (n_paths,)."""
    sc = schedule_config

    inflation_rate_curve = None
    spot_cpi = None
    cpi_interp = None
    cpi_slice = market_state.get(leg.cpi_curve_name)
    if leg.inflation_rate_curve_name:
        infl_slice: CurveSlice = market_state[leg.inflation_rate_curve_name]
        inflation_rate_curve = YieldCurve(infl_slice.tenors, infl_slice.values)
        if cpi_slice is not None:
            spot_cpi = np.asarray(cpi_slice.values, dtype=np.float64)
            if spot_cpi.ndim == 2:
                spot_cpi = spot_cpi[:, 0]
    elif cpi_slice is not None and isinstance(cpi_slice, CurveSlice):
        # legacy mode: the factor IS a CPI-level term structure
        def cpi_interp(t_ref, _s=cpi_slice):
            t = np.atleast_1d(np.asarray(t_ref, dtype=np.float64))
            out = linear_interp(_s.tenors, _s.values, t)
            return out[:, 0] if np.ndim(t_ref) == 0 else out

    pv = np.zeros(n_paths)
    last_pay = max(p for _, _, p, _ in schedule)
    future = [
        (p_start, p_end, pay_date, accrual)
        for p_start, p_end, pay_date, accrual in schedule
        if pay_date > val_date
        or (pay_date == val_date and include_on_val_date)
    ]
    if not future:
        return pv

    # Resolve every bracket month this leg needs up front (adjacent periods
    # share months: j1 of one period == j of the next). Months past the
    # publication horizon ride ONE vectorized curve call — the same batch
    # pattern as the pay-date discounting below — instead of a single-point
    # interpolation each.
    _month_cache: Dict[dt.date, np.ndarray] = {}
    needed: set = set()
    for _, p_end, _, _ in future:
        needed.update(besa_bracket(p_end, leg.lag_months))
    if inflation_rate_curve is not None:
        last_pub = cpi_last_pub_date or shift_months(first_of_month(val_date), -1)
        projected = sorted(m for m in needed if m > last_pub)
        if projected:
            anchor_cpi = _projection_anchor(
                last_pub, historical_cpi_map, n_paths, cpi_fixings, spot_cpi
            )
            t_refs = np.array(
                [year_fraction(last_pub, m, sc.curve_day_count) for m in projected]
            )
            dfs_infl = inflation_rate_curve.discount_factor(t_refs)  # (n_paths, k)
            for i, m in enumerate(projected):
                _month_cache[m] = anchor_cpi / dfs_infl[:, i]
    elif cpi_interp is not None:
        interp_months = sorted(
            m
            for m in needed
            if m > val_date
            and not (cpi_fixings is not None and m in cpi_fixings)
            and m not in historical_cpi_map
        )
        if interp_months:
            t_refs = np.array(
                [year_fraction(val_date, m, sc.curve_day_count) for m in interp_months]
            )
            vals = cpi_interp(t_refs)  # (n_paths, k)
            for i, m in enumerate(interp_months):
                _month_cache[m] = vals[:, i]

    def _cpi_month(m: dt.date) -> np.ndarray:
        if m not in _month_cache:
            _month_cache[m] = get_cpi_level(
                m, val_date, historical_cpi_map, n_paths,
                curve_day_count=sc.curve_day_count,
                cpi_fixings=cpi_fixings, spot_cpi=spot_cpi,
                inflation_rate_curve=inflation_rate_curve,
                last_pub_date=cpi_last_pub_date, cpi_interp=cpi_interp,
            )
        return _month_cache[m]

    def _cpi_at(d: dt.date) -> np.ndarray:
        j, j1 = besa_bracket(d, leg.lag_months)
        cpi_j = _cpi_month(j)
        if j == j1:
            return cpi_j
        return interp_cpi(d, cpi_j, _cpi_month(j1))
    # ONE discount_factor call covers every payment date — the per-period
    # single-point interpolation was the exposure engine's measured hot
    # spot, eliminated the same way in cashflow.leg_pv/trs_return_leg_pv
    t_pays = np.array(
        [sc.curve_year_fraction(val_date, pay) for _, _, pay, _ in future]
    )
    dfs = discount_curve.discount_factor(t_pays)  # (n_paths, m)
    for i, (p_start, p_end, pay_date, accrual) in enumerate(future):
        index_ratio = _cpi_at(p_end) / leg.base_cpi
        cf = base_notional * index_ratio * accrual * leg.real_rate
        if leg.pay_notional_at_maturity and pay_date == last_pay:
            cf = cf + base_notional * index_ratio
        pv = pv + dfs[:, i] * cf
    return pv
