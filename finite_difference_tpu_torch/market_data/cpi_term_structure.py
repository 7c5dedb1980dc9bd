"""CPI term structure from historical fixings + ZC inflation swap quotes (the port's copy of
``finite_difference_tpu.market_data.cpi_term_structure``, host numpy).

QuantLib-free capability parity with the reference's
``cpi_term_structure.py:6-143`` (CPITermStructure.build_handle /
build_index): combine a first-of-month CPI history with zero-coupon
inflation-swap zero rates bootstrapped off the valuation date —

- past reference dates resolve through the BESA 4/3-month lagged
  interpolation of the historical fixings;
- future dates project the base (lagged) CPI by the compounded ZCIS zero
  rate interpolated at the date's maturity:
  CPI(d) = CPI_base * (1 + z(tau))^tau, the standard ZCIS indexation
  identity the QL PiecewiseZeroInflation bootstrap enforces.
"""
from __future__ import annotations

import datetime as dt
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from .cpi import besa_bracket, interp_cpi, shift_months


class CPITermStructure:
    def __init__(
        self,
        historical_cpi: Dict[dt.date, float],
        inflation_zero_rates: Sequence[Tuple[dt.date, float]],
        value_date: dt.date,
        observation_lag_months: int = 4,
        day_count: float = 365.0,
        rates_in_percent: bool = True,
    ) -> None:
        if not historical_cpi:
            raise ValueError("historical_cpi must be non-empty")
        self.historical_cpi = {k: float(v) for k, v in historical_cpi.items()}
        self.value_date = value_date
        self.observation_lag_months = int(observation_lag_months)
        self.day_count = float(day_count)

        quotes = sorted(inflation_zero_rates, key=lambda x: x[0])
        scale = 0.01 if rates_in_percent else 1.0
        self._mat_taus = np.array(
            [(d - value_date).days / self.day_count for d, _ in quotes]
        )
        self._zero_rates = np.array([q * scale for _, q in quotes])
        self._latest_fixing = max(self.historical_cpi)

    # ------------------------------------------------------------------

    def _historical_value(self, d: dt.date) -> float:
        j, j1 = besa_bracket(d, self.observation_lag_months)
        cpi_j = self.historical_cpi[j]
        if j == j1:
            return cpi_j
        return interp_cpi(d, cpi_j, self.historical_cpi[j1])

    def _has_history_for(self, d: dt.date) -> bool:
        j, j1 = besa_bracket(d, self.observation_lag_months)
        return j in self.historical_cpi and j1 in self.historical_cpi

    def zero_rate(self, d: dt.date) -> float:
        """ZCIS zero rate at d's maturity (linear, flat extrapolation)."""
        tau = (d - self.value_date).days / self.day_count
        return float(np.interp(tau, self._mat_taus, self._zero_rates))

    def cpi(self, d: dt.date) -> float:
        """Published/projected CPI at d (the build_index equivalent).

        Projection anchors at the VALUE DATE's lagged CPI — the ZCIS
        quote convention (the fixed leg compounds (1+z)^tau off exactly
        that base), matching QuantLib's ZeroInflationIndex.forecastFixing
        in the reference (cpi_term_structure.py:114-143). Like QL, this
        admits a jump at the history/projection boundary when realized
        inflation differs from the implied curve; the sibling
        HistoricalCPI.extend_historical_cpi deliberately uses the other
        (last-historical-anchor) convention for nominal-curve carry.
        """
        if self._has_history_for(d):
            return self._historical_value(d)
        base = self._historical_value(self.value_date)
        tau = max((d - self.value_date).days / self.day_count, 0.0)
        z = self.zero_rate(d)
        return base * (1.0 + z) ** tau

    def index_ratio(self, d: dt.date, base_date: dt.date) -> float:
        return self.cpi(d) / self.cpi(base_date)

    def build_index(self) -> Callable[[dt.date], float]:
        """Return CPI(d) as a callable (cpi_term_structure.py:115-143)."""
        return self.cpi

    def build_handle(self) -> Callable[[dt.date], float]:
        """API mirror of build_handle: the projected zero-rate function."""
        return self.zero_rate
