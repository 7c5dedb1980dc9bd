"""Commodity forward instruments priced against a ScenarioCube (the port's copy of
``finite_difference_tpu.instruments.commodity``, host numpy).

Reconstruction of the scenario-cube commodity instruments whose interface
the reference's ExposureEngine duck-types (exposure_engine.py:439-493:
``get_commodity_fixing_schedule`` yielding (averaging_date, pricing_date,
fx_settle_date), ``forward_curve_name``, ``_compute_fixing_for_date``):

- ``CommodityForwardInstrument``: single delivery, NPV = DF * notional *
  (F(t, delivery) - strike); after the pricing date the realized forward is
  stamped once by the engine and reused;
- ``CommodityAverageForwardInstrument``: Asian-style averaging over a
  schedule of dates; realized averaging dates use stamped fixings, future
  dates the simulated curve.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve
from ..utils.daycount import year_fraction
from .instrument import Instrument


def _interp_curve(slice_: CurveSlice, t: float) -> np.ndarray:
    """Linear interp (flat extrapolation) of a pathwise forward curve at
    tenor t: (n_paths,)."""
    tenors = slice_.tenors
    vals = slice_.values
    t = float(np.clip(t, tenors[0], tenors[-1]))
    j = int(np.clip(np.searchsorted(tenors, t), 1, len(tenors) - 1))
    w = (t - tenors[j - 1]) / max(tenors[j] - tenors[j - 1], 1e-12)
    return (1.0 - w) * vals[:, j - 1] + w * vals[:, j]


class CommodityForwardInstrument(Instrument):
    def __init__(
        self,
        name: str,
        delivery_date: dt.date,
        strike: float,
        notional: float,
        forward_curve_name: str,
        discount_curve_name: str,
        pricing_lag_days: int = 0,
        day_count: str = "ACT/365",
    ):
        super().__init__(name)
        self.delivery_date = delivery_date
        self.strike = float(strike)
        self.notional = float(notional)
        self.forward_curve_name = forward_curve_name
        self.discount_curve_name = discount_curve_name
        self.pricing_lag_days = int(pricing_lag_days)
        self.day_count = day_count

    # engine duck-type interface ---------------------------------------
    def get_commodity_fixing_schedule(
        self,
    ) -> List[Tuple[dt.date, dt.date, dt.date]]:
        pricing = self.delivery_date - dt.timedelta(days=self.pricing_lag_days)
        return [(self.delivery_date, pricing, self.delivery_date)]

    def _compute_fixing_for_date(
        self,
        avg_date: dt.date,
        pricing_date: dt.date,
        fx_settle_date: dt.date,
        fix_state: Dict,
        scenario_date: dt.date,
    ) -> Dict[tuple, np.ndarray]:
        fwd_slice: CurveSlice = fix_state[self.forward_curve_name]
        t = year_fraction(scenario_date, avg_date, self.day_count)
        return {
            (self.forward_curve_name, avg_date): _interp_curve(fwd_slice, t)
        }

    # pricing ----------------------------------------------------------
    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict,
        fixings: Optional[Dict[tuple, np.ndarray]] = None,
        rng=None,
    ) -> np.ndarray:
        disc_slice: CurveSlice = market_state[self.discount_curve_name]
        n_paths = disc_slice.values.shape[0]
        if val_date > self.delivery_date:
            return np.zeros(n_paths)

        key = (self.forward_curve_name, self.delivery_date)
        if fixings is not None and key in fixings:
            ref = np.asarray(fixings[key], dtype=np.float64)
        else:
            fwd_slice: CurveSlice = market_state[self.forward_curve_name]
            t = year_fraction(val_date, self.delivery_date, self.day_count)
            ref = _interp_curve(fwd_slice, t)

        disc = YieldCurve(disc_slice.tenors, disc_slice.values)
        t_pay = year_fraction(val_date, self.delivery_date, self.day_count)
        df = disc.discount_factor(np.array([t_pay]))[:, 0]
        return df * self.notional * (ref - self.strike)


class CommodityAverageForwardInstrument(Instrument):
    def __init__(
        self,
        name: str,
        averaging_dates: Sequence[dt.date],
        payment_date: dt.date,
        strike: float,
        notional: float,
        forward_curve_name: str,
        discount_curve_name: str,
        pricing_lag_days: int = 0,
        day_count: str = "ACT/365",
    ):
        super().__init__(name)
        self.averaging_dates = sorted(averaging_dates)
        self.payment_date = payment_date
        self.maturity_date = payment_date
        self.strike = float(strike)
        self.notional = float(notional)
        self.forward_curve_name = forward_curve_name
        self.discount_curve_name = discount_curve_name
        self.pricing_lag_days = int(pricing_lag_days)
        self.day_count = day_count

    def get_commodity_fixing_schedule(
        self,
    ) -> List[Tuple[dt.date, dt.date, dt.date]]:
        out = []
        for d in self.averaging_dates:
            pricing = d - dt.timedelta(days=self.pricing_lag_days)
            out.append((d, pricing, d))
        return out

    def _compute_fixing_for_date(
        self,
        avg_date: dt.date,
        pricing_date: dt.date,
        fx_settle_date: dt.date,
        fix_state: Dict,
        scenario_date: dt.date,
    ) -> Dict[tuple, np.ndarray]:
        fwd_slice: CurveSlice = fix_state[self.forward_curve_name]
        t = year_fraction(scenario_date, avg_date, self.day_count)
        return {
            (self.forward_curve_name, avg_date): _interp_curve(fwd_slice, t)
        }

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict,
        fixings: Optional[Dict[tuple, np.ndarray]] = None,
        rng=None,
    ) -> np.ndarray:
        disc_slice: CurveSlice = market_state[self.discount_curve_name]
        n_paths = disc_slice.values.shape[0]
        if val_date > self.payment_date:
            return np.zeros(n_paths)

        fwd_slice: CurveSlice = market_state[self.forward_curve_name]
        parts = np.zeros((len(self.averaging_dates), n_paths))
        for i, d in enumerate(self.averaging_dates):
            key = (self.forward_curve_name, d)
            if fixings is not None and key in fixings:
                parts[i] = np.asarray(fixings[key], dtype=np.float64)
            else:
                t = year_fraction(val_date, d, self.day_count)
                parts[i] = _interp_curve(fwd_slice, t)
        ref = parts.mean(axis=0)

        disc = YieldCurve(disc_slice.tenors, disc_slice.values)
        t_pay = year_fraction(val_date, self.payment_date, self.day_count)
        df = disc.discount_factor(np.array([t_pay]))[:, 0]
        return df * self.notional * (ref - self.strike)
