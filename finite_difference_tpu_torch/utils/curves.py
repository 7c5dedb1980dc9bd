"""Daily NACA yield curves (host-side, array-backed, without pandas).

The port's own copy of ``finite_difference_tpu.utils.curves``. The JAX
package's curves take and return pandas DataFrames; the port keeps pandas
out of its import path, so a curve here is built from a ``(dates, naca)``
pair or from any table indexable by ``"Date"`` and ``"NACA"`` (a pandas
DataFrame, a dict of columns), and :func:`flat_naca_dataframe` and
:func:`load_curve_csv` return such tables without pandas. Capability parity
with the reference's ``class_yield.NacaCurve``:

    DF(d)            = (1 + NACA(d)) ** (-tau(valuation, d))
    fwd NACC(d0, d1) = -ln(DF(d1) / DF(d0)) / max(1e-12, tau(d0, d1))

with simple ACT/365F-style year fractions, the curve stored as a dense
(day-ordinal -> rate) numpy array.
"""
from __future__ import annotations

import csv
import datetime as dt
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dates import DateLike, to_date
from .daycount import normalize_convention, year_denominator, year_fraction


class DailyNacaCurve:
    """A daily NACA curve anchored at a valuation date.

    Parameters
    ----------
    curve : a ``(dates, rates)`` pair, or a table whose ``"Date"`` and
        ``"NACA"`` columns give them (a pandas DataFrame works). Dates may be
        ISO strings, "YYYY/MM/DD" strings, or date objects; a curve that is
        not contiguous-daily is forward-filled onto a daily grid.
    valuation_date : anchor date for discount factors.
    day_count : "ACT/365F" (default), "ACT/360", "ACT/364", "30/360".
    """

    def __init__(self, curve, valuation_date: DateLike, day_count: str = "ACT/365F") -> None:
        self.valuation_date = to_date(valuation_date)
        self.day_count = day_count
        self._denom = float(year_denominator(day_count))
        self._dc_norm = normalize_convention(day_count)

        if isinstance(curve, (tuple, list)):
            raw_dates, raw_rates = curve
        else:
            raw_dates, raw_rates = curve["Date"], curve["NACA"]
        dates = [to_date(d) for d in raw_dates]
        rates = np.asarray(raw_rates, dtype=np.float64)
        if len(dates) == 0:
            raise ValueError("Empty curve.")

        order = np.argsort(np.array([d.toordinal() for d in dates]))
        ords = np.array([dates[i].toordinal() for i in order], dtype=np.int64)
        vals = rates[order]

        # Forward-fill onto a dense daily ordinal grid for O(1) lookups.
        self._ord0 = int(ords[0])
        self._ord1 = int(ords[-1])
        n = self._ord1 - self._ord0 + 1
        marker = np.full(n, -1, dtype=np.int64)
        marker[ords - self._ord0] = np.arange(len(ords))
        filled = np.maximum.accumulate(marker)
        if filled[0] < 0:
            raise ValueError("Curve grid malformed.")
        self._rates = vals[filled]

    # ------------------------------------------------------------------ #
    # Lookups                                                             #
    # ------------------------------------------------------------------ #
    def naca(self, lookup_date: DateLike) -> float:
        """NACA rate at a date (strict: date must lie within curve span)."""
        o = to_date(lookup_date).toordinal()
        if o < self._ord0 or o > self._ord1:
            raise ValueError(
                f"Discount factor not found for date: {to_date(lookup_date).isoformat()}"
            )
        return float(self._rates[o - self._ord0])

    def naca_array(self, dates: Sequence[DateLike]) -> np.ndarray:
        ords = np.array([to_date(d).toordinal() for d in dates], dtype=np.int64)
        if ords.min(initial=self._ord1) < self._ord0 or ords.max(initial=self._ord0) > self._ord1:
            bad = [d for d in dates if not (self._ord0 <= to_date(d).toordinal() <= self._ord1)]
            raise ValueError(f"Dates outside curve span: {bad[:3]}")
        return self._rates[ords - self._ord0]

    def year_fraction(self, start: DateLike, end: DateLike) -> float:
        return year_fraction(start, end, self.day_count)

    def get_discount_factor(self, lookup_date: DateLike) -> float:
        naca = self.naca(lookup_date)
        tau = self.year_fraction(self.valuation_date, lookup_date)
        return (1.0 + naca) ** (-tau)

    def discount_factors(self, dates: Sequence[DateLike]) -> np.ndarray:
        nacas = self.naca_array(dates)
        taus = np.array(
            [self.year_fraction(self.valuation_date, d) for d in dates],
            dtype=np.float64,
        )
        return (1.0 + nacas) ** (-taus)

    def get_forward_nacc_rate(self, start_date: DateLike, end_date: DateLike) -> float:
        df_far = self.get_discount_factor(end_date)
        df_near = self.get_discount_factor(start_date)
        tau = self.year_fraction(start_date, end_date)
        return -np.log(df_far / df_near) / max(1e-12, tau)

    def get_nacc_rate(self, lookup_date: DateLike) -> float:
        """ln(1 + NACA) at a date; 0.0 when outside the span (permissive)."""
        try:
            return float(np.log1p(self.naca(lookup_date)))
        except ValueError:
            return 0.0


def flat_naca_dataframe(
    rate: float,
    start: DateLike = dt.date(2025, 7, 28),
    end: DateLike = dt.date(2028, 9, 28),
) -> Tuple[List[str], np.ndarray]:
    """Flat daily NACA curve (reference utils.create_rate_df:72) as a
    ``(dates, naca)`` pair: dates formatted "YYYY/MM/DD", the rate constant.
    The JAX package's function of this name returns a DataFrame with the
    same columns; :class:`DailyNacaCurve` takes either."""
    d0, d1 = to_date(start), to_date(end)
    n = (d1 - d0).days + 1
    dates = [(d0 + dt.timedelta(days=i)).strftime("%Y/%m/%d") for i in range(n)]
    return dates, np.full(n, float(rate))


def flat_curve(
    rate: float,
    valuation_date: DateLike,
    start: Optional[DateLike] = None,
    end: Optional[DateLike] = None,
    day_count: str = "ACT/365F",
) -> DailyNacaCurve:
    """Convenience: flat DailyNacaCurve spanning [start, end]."""
    v = to_date(valuation_date)
    d0 = to_date(start) if start is not None else v - dt.timedelta(days=30)
    d1 = to_date(end) if end is not None else v + dt.timedelta(days=3700)
    n = (d1 - d0).days + 1
    dates = [d0 + dt.timedelta(days=i) for i in range(n)]
    return DailyNacaCurve((dates, np.full(n, rate)), v, day_count=day_count)


def load_curve_csv(path: str, scale: float = 100.0) -> Dict[str, list]:
    """Load a 3-column (date, tenor, value%) CSV the way the reference's
    ``CurveImporter.load_data`` (curve_importer.py:16) does: values / scale.

    Returns the columns ``"Date"``, ``"Tenor"`` (as read) and ``"NACA"``
    (a float array), read with the standard ``csv`` module.
    """
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows or len(rows[0]) < 3:
        raise ValueError("Curve CSV must have at least 3 columns (date, tenor, value).")
    body = [r for r in rows[1:] if r]
    return {
        "Date": [r[0] for r in body],
        "Tenor": [r[1] for r in body],
        "NACA": np.array([float(r[2]) for r in body], dtype=np.float64) / scale,
    }


# API aliases matching the reference's names (class_yield.py:10, utils.py:72).
NacaCurve = DailyNacaCurve
create_rate_df = flat_naca_dataframe
