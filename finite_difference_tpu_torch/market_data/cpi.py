"""CPI publication conventions and historical CPI stores (the port's copy of
``finite_difference_tpu.market_data.cpi``, host numpy).

Capability parity with the reference's ``cpi_publication.py:6-41`` and
``historical_cpi.py:11-226``:

- BESA 4/3-month bracketing: for date d, the bracket months are
  (m-4, m-3) first-of-month; day-1 dates collapse to a single month;
  intra-month linear interpolation by (day-1)/days_in_month;
- forward extension of the monthly fixing map from an inflation curve via
  the index-ratio rule CPI_next = CPI_prev * DF(prev)/DF(next).
"""
from __future__ import annotations

import calendar as _cal
import datetime as dt
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..utils.dates import to_date


def _as_date(x) -> dt.date:
    """A table's date cell as a date: a date, a datetime (or a pandas
    Timestamp), a numpy datetime64 or an ISO string."""
    if isinstance(x, np.datetime64):
        return x.astype("datetime64[D]").astype(dt.date)
    return to_date(x)


def first_of_month(d: dt.date) -> dt.date:
    return dt.date(d.year, d.month, 1)


def shift_months(d: dt.date, months: int) -> dt.date:
    """First-of-month shifted by a number of months."""
    y, m = divmod(d.month - 1 + months, 12)
    return dt.date(d.year + y, m + 1, 1)


def besa_bracket(d: dt.date, lag_months: int = 4) -> Tuple[dt.date, dt.date]:
    """BESA CPI bracket months for date d (cpi_publication.py:25-31).

    Returns (j, j1) = first-of-month lag and lag-1 months before d; day-1
    dates collapse to (j, j).
    """
    first = first_of_month(d)
    j = shift_months(first, -lag_months)
    j1 = shift_months(j, 1)
    if d.day == 1:
        return j, j
    return j, j1


def interp_cpi(d: dt.date, cpi_j: float, cpi_j1) -> float:
    """Intra-month linear interpolation CPI(d) = CPI_j + frac*(CPI_j1-CPI_j)."""
    days_in_month = _cal.monthrange(d.year, d.month)[1]
    fraction = (d.day - 1) / days_in_month
    return cpi_j + fraction * (cpi_j1 - cpi_j)


class CPIPublication:
    """Published CPI via the BESA 4/3-month rule (cpi_publication.py:6-41)."""

    def __init__(self, monthly_cpi: Mapping[dt.date, float]):
        self._monthly_cpi = dict(monthly_cpi)

    def published_cpi(self, d: dt.date) -> float:
        j, j1 = besa_bracket(d)
        cpi_j = self._monthly_cpi[j]
        if j == j1:
            return cpi_j
        return interp_cpi(d, cpi_j, self._monthly_cpi[j1])


class HistoricalCPI:
    """Monthly CPI history with curve-based forward extension
    (historical_cpi.py:11-226).

    Parameters
    ----------
    value_date : valuation anchor for the projection year fractions.
    monthly_cpi : mapping, or a table with Date and Value columns (a pandas
        DataFrame works, read by its columns), of first-of-month fixings.
    discount_factor_fn : callable date -> DF on the inflation curve, where
        DF(t) = I(0)/I(t); may be None if no extension is needed.
    extend_cpi : months to pre-extend the fixing map forward.
    """

    def __init__(
        self,
        value_date: dt.date,
        monthly_cpi,
        discount_factor_fn: Optional[Callable[[dt.date], float]] = None,
        extend_cpi: int = 96,
    ):
        self.value_date = value_date
        self._df_fn = discount_factor_fn
        self._monthly_cpi = self._coerce_map(monthly_cpi)
        # the projection anchor is the last HISTORICAL fixing: every
        # (re-)extension projects from here so on-demand re-extension in
        # cpi_value continues the same DF-ratio ladder instead of
        # re-applying near-spot growth to a far-out month
        self._last_historical = first_of_month(max(self._monthly_cpi))
        self._cpi_last_historical = float(
            self._monthly_cpi[self._last_historical]
        )
        if extend_cpi > 0 and self._df_fn is not None:
            self._monthly_cpi = self.extend_historical_cpi(extend_cpi)

    @staticmethod
    def _coerce_map(monthly_cpi) -> Dict[dt.date, float]:
        if hasattr(monthly_cpi, "columns"):  # a table, e.g. a pandas DataFrame
            cols = list(monthly_cpi.columns)
            date_col = "Date" if "Date" in cols else cols[0]
            value_col = "Value" if "Value" in cols else cols[1]
            return {
                first_of_month(_as_date(d)): float(v)
                for d, v in zip(monthly_cpi[date_col], monthly_cpi[value_col])
            }
        return {first_of_month(k): float(v) for k, v in dict(monthly_cpi).items()}

    @property
    def monthly_cpi(self) -> Dict[dt.date, float]:
        return self._monthly_cpi

    def extend_historical_cpi(self, months: int) -> Dict[dt.date, float]:
        """Project first-of-month fixings ``months`` beyond the current
        latest with the index-ratio rule CPI_next = CPI_prev *
        DF(carry_prev)/DF(carry_next) (historical_cpi.py:149-204,
        simplified to its documented rule). Telescoping makes month i
        after the last HISTORICAL fixing CPI_hist / DF(value_date + i
        months); projecting from that fixed anchor keeps on-demand
        re-extension on the same ladder (re-anchoring at the re-extension
        call would apply 1-month SPOT growth to a month years out — a
        kink in projected CPI whenever the curve isn't flat)."""
        fixings = dict(self._monthly_cpi)
        if months <= 0 or self._df_fn is None:
            return fixings
        latest = first_of_month(max(fixings))
        anchor = self._last_historical
        already = (
            (latest.year - anchor.year) * 12 + latest.month - anchor.month
        )
        carry_date = self.value_date
        for i in range(1, already + int(months) + 1):
            next_date = shift_months(anchor, i)
            # carry measured from value_date in month steps
            y, m = divmod(carry_date.month - 1 + i, 12)
            day = min(carry_date.day, _cal.monthrange(carry_date.year + y, m + 1)[1])
            carry = dt.date(carry_date.year + y, m + 1, day)
            next_df = float(self._df_fn(carry))
            fixings[next_date] = self._cpi_last_historical / next_df
        return fixings

    def published_cpi(self, d: dt.date) -> float:
        """Bond-variant API name for the BESA-interpolated value
        (historical_cpi_bond.py:199-219; same rule as cpi_value)."""
        return self.cpi_value(d)

    def cpi_value(self, d: dt.date) -> float:
        """BESA-interpolated CPI(d), extending the map on demand
        (historical_cpi.py:206-226)."""
        j, j1 = besa_bracket(d)
        latest = max(self._monthly_cpi)
        target = max(j, j1)
        if target > latest:
            months_to_add = (
                (target.year - latest.year) * 12 + target.month - latest.month
            )
            if months_to_add > 0 and self._df_fn is not None:
                self._monthly_cpi = self.extend_historical_cpi(months_to_add)
        earliest = min(self._monthly_cpi)
        # permissive clamp for brackets predating the history (mirrors the
        # reference's permissive curve lookups, SURVEY §5.3)
        cpi_j = self._monthly_cpi[max(j, earliest)]
        if j == j1:
            return cpi_j
        return interp_cpi(d, cpi_j, self._monthly_cpi[max(j1, earliest)])


# Bond-convention alias (historical_cpi_bond.py:11): identical BESA
# bracketing/interpolation; the reference variants differ only in the
# accretion-era extension scratch logic, superseded by the documented rule.
BondHistoricalCPI = HistoricalCPI
