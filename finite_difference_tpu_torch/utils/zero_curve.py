"""NACC zero curve and standalone discount factors (QuantLib-free), host numpy.

The port's own copy of ``finite_difference_tpu.utils.zero_curve``.
Capability parity with the reference's ``discount.py`` (YieldCurve
wrapper :7-127, standalone ``discount_factor`` :130-189):

- ``ZeroCurve``: NACC zero rates at maturity dates with log-linear DF
  interpolation (the behaviour of QL's DiscountCurve over log DFs) and flat
  extrapolation; DF(d<=value_date) = 1; ``get_zero_rate`` returns the
  continuously-compounded rate; ``forward_rate`` the simple annual forward
  (DF(start)/DF(end) - 1) * denom/days;
- ``discount_factor``: single-rate DF with methods continuous / simple /
  compounded / discount over ACT/360, ACT/365(F) or ACT/365.25.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .dates import DateLike, to_date


class ZeroCurve:
    def __init__(
        self,
        zero_rates: Sequence[float],
        maturities: Sequence[DateLike],
        value_date: DateLike,
        day_count: float = 365.0,
    ) -> None:
        if len(zero_rates) != len(maturities):
            raise ValueError("Length of zero_rates and maturities must match.")
        if not all(isinstance(r, (float, int)) for r in zero_rates):
            raise TypeError("zero_rates must be a list of floats.")
        self.value_date = to_date(value_date)
        self.py_day_count = float(day_count)
        dates = [to_date(d) for d in maturities]
        order = np.argsort([d.toordinal() for d in dates])
        self._taus = np.array(
            [(dates[i] - self.value_date).days / self.py_day_count for i in order]
        )
        self._rates = np.array([float(zero_rates[i]) for i in order])
        if self._taus[0] > 0.0:  # anchor at t=0 with the first rate
            self._taus = np.insert(self._taus, 0, 0.0)
            self._rates = np.insert(self._rates, 0, self._rates[0])
        self._log_dfs = -self._rates * self._taus

    def _tau(self, d: DateLike) -> float:
        return (to_date(d) - self.value_date).days / self.py_day_count

    def get_discount_factor(self, date: DateLike) -> float:
        """Log-linear DF interpolation; 1.0 on/before the value date."""
        t = self._tau(date)
        if t <= 0.0:
            return 1.0
        if t >= self._taus[-1]:  # flat-zero-rate extrapolation
            return math.exp(-self._rates[-1] * t)
        return math.exp(float(np.interp(t, self._taus, self._log_dfs)))

    def get_zero_rate(self, date: DateLike) -> float:
        t = self._tau(date)
        if t <= 0.0:
            return float(self._rates[0])
        return -math.log(self.get_discount_factor(date)) / t

    def forward_rate(self, start_date: DateLike, end_date: DateLike) -> float:
        """Simple annual forward (discount.py:116-127)."""
        days = (to_date(end_date) - to_date(start_date)).days
        if days <= 0:
            raise ValueError("end_date must be after start_date")
        df_start = self.get_discount_factor(start_date)
        df_end = self.get_discount_factor(end_date)
        return (df_start / df_end - 1.0) * (self.py_day_count / days)

    def year_fraction(self, d0: DateLike, d1: DateLike) -> float:
        return (to_date(d1) - to_date(d0)).days / self.py_day_count


def discount_factor(
    rate: float,
    start_date: DateLike,
    end_date: DateLike,
    method: str = "continuous",
    compounding_frequency: int = 1,
    day_count: float = 365.0,
) -> float:
    """Single-rate DF with four compounding conventions (discount.py:130-189)."""
    if day_count not in (360, 365, 365.25):
        raise ValueError("Unsupported day count. Use 360, 365, or 365.25.")
    t = (to_date(end_date) - to_date(start_date)).days / float(day_count)
    if t <= 0:
        return 1.0
    method = method.lower()
    if method == "continuous":
        return math.exp(-rate * t)
    if method == "simple":
        return 1.0 / (1.0 + rate * t)
    if method == "compounded":
        f = float(compounding_frequency)
        return 1.0 / (1.0 + rate / f) ** (f * t)
    if method == "discount":
        return 1.0 - rate * t
    raise ValueError(
        "Unsupported method. Choose 'continuous', 'simple', 'compounded', or 'discount'."
    )
