"""Fixed-rate bond with BESA accrued-interest conventions (the port's copy
of ``finite_difference_tpu.bonds.fixed_rate``, host Python; the book-close
date on the port's ``instruments.schedule.get_calendar``).

Capability parity with the reference's ``fixed_rate_bond.py:9-106`` and
``fixed_rate_bond_pricer.py:10-233`` without QuantLib:

- coupon schedule generated from the last coupon date to maturity at the
  payment frequency (unadjusted dates, like the reference's
  ``ql.Unadjusted`` schedule);
- dirty price = PV of remaining cashflows per 100 face, from the curve;
- BESA accrued interest: CUMEX = 1 iff settle < book-close (NCD - 10 bd);
  DAYSACC = settle - LCD (cum) or settle - NCD (ex);
  accrued = DAYSACC * coupon * 100 / 365;
- clean = dirty - accrued;
- YTM solved (Newton with bisection fallback) on compounded yield at the
  coupon frequency; val01 and gamma from central YTM bumps of the
  flat-yield dirty price.
"""
from __future__ import annotations

import datetime as dt
from typing import List, Optional, Tuple

from ..instruments.schedule import add_months, get_calendar

_FREQ_MONTHS = {
    "annual": 12,
    "semi-annual": 6,
    "semiannual": 6,
    "quarterly": 3,
    "monthly": 1,
}


class FixedRateBond:
    def __init__(
        self,
        notional: float,
        issue_date: dt.date,
        value_date: dt.date,
        last_coupon_date: dt.date,
        next_coupon_date: dt.date,
        maturity_date: dt.date,
        coupon_rate: float,
        frequency: str = "semi-annual",
        calendar: str = "SouthAfrica",
        ex_coupon_days: int = 10,
    ):
        freq_key = frequency.lower()
        if freq_key not in _FREQ_MONTHS:
            raise ValueError(f"Unsupported frequency {frequency!r}")
        self.frequency_months = _FREQ_MONTHS[freq_key]
        self.periods_per_year = 12 // self.frequency_months

        self.notional = notional
        self.issue_date = issue_date
        self.value_date = value_date
        self.lcd = last_coupon_date
        self.ncd = next_coupon_date
        self.maturity_date = maturity_date
        self.coupon_rate = coupon_rate
        self.calendar = get_calendar(calendar)
        self.ex_coupon_days = int(ex_coupon_days)
        self.schedule = self._cashflow_dates()

    def _cashflow_dates(self) -> List[dt.date]:
        """Unadjusted coupon dates from the LCD to maturity."""
        dates = []
        k = 0
        d = self.lcd
        while d < self.maturity_date:
            k += 1
            d = add_months(self.lcd, k * self.frequency_months)
            dates.append(min(d, self.maturity_date))
        # dedupe while preserving order
        out: List[dt.date] = []
        for d in dates:
            if not out or d != out[-1]:
                out.append(d)
        return out


class FixedRateBondPricer:
    def __init__(self, bond_def: FixedRateBond, yield_curve) -> None:
        self.bond_def = bond_def
        self.yield_curve = yield_curve

    # -- cashflows per 100 face ----------------------------------------
    def _cashflows(self) -> List[Tuple[dt.date, float]]:
        b = self.bond_def
        per_coupon = b.coupon_rate * 100.0 / b.periods_per_year
        cfs = [(d, per_coupon) for d in b.schedule]
        cfs[-1] = (cfs[-1][0], cfs[-1][1] + 100.0)
        return cfs

    def dirty_price(self) -> float:
        """PV per 100 face of cashflows after the value date."""
        b = self.bond_def
        pv = 0.0
        for d, cf in self._cashflows():
            if d <= b.value_date:
                continue
            pv += cf * float(self.yield_curve.get_discount_factor(d))
        return pv

    def accrued_amount(self) -> float:
        """BESA CUMEX accrued (fixed_rate_bond_pricer.py:32-63)."""
        b = self.bond_def
        settle = b.value_date
        book_close = b.calendar.add_working_days(b.ncd, -b.ex_coupon_days)
        cumex = 1 if settle < book_close else 0
        daysacc = (settle - b.lcd).days if cumex else (settle - b.ncd).days
        return daysacc * b.coupon_rate * 100.0 / 365.0

    def clean_price(self) -> float:
        return self.dirty_price() - self.accrued_amount()

    # -- flat compounded-yield machinery --------------------------------
    def _dirty_from_yield(self, y: float, value_date=None) -> float:
        b = self.bond_def
        vd = value_date or b.value_date
        f = b.periods_per_year
        pv = 0.0
        for d, cf in self._cashflows():
            if d <= vd:
                continue
            t = (d - vd).days / 365.0
            pv += cf / (1.0 + y / f) ** (f * t)
        return pv

    def yield_to_maturity(self, tol: float = 1e-12, max_iter: int = 100) -> float:
        """Newton-with-bisection on the compounded yield
        (fixed_rate_bond_pricer.py:65-85)."""
        target = self.dirty_price()
        lo, hi = -0.5, 2.0
        y = self.bond_def.coupon_rate
        for _ in range(max_iter):
            px = self._dirty_from_yield(y)
            err = px - target
            if abs(err) < tol:
                return y
            h = 1e-7
            deriv = (self._dirty_from_yield(y + h) - px) / h
            if deriv != 0.0:
                y_new = y - err / deriv
            else:
                y_new = 0.5 * (lo + hi)
            if not (lo < y_new < hi):
                if err > 0:
                    lo = y
                else:
                    hi = y
                y_new = 0.5 * (lo + hi)
            y = y_new
        return y

    def val01(self, value_date=None, bump: float = 1e-4,
              yield_to_maturity: Optional[float] = None) -> float:
        """Yield val01 as of ``value_date`` (defaults to the pricer's) —
        the reference reprices at the passed settlement date via
        ql.BondFunctions.dirtyPrice (fixed_rate_bond_pricer.py:86-121);
        this parameter used to be silently ignored."""
        ytm = yield_to_maturity if yield_to_maturity is not None else self.yield_to_maturity()
        up = self._dirty_from_yield(ytm + bump, value_date)
        down = self._dirty_from_yield(ytm - bump, value_date)
        return (up - down) / (2 * bump) * -bump

    def gamma(self, value_date=None, bump: float = 1e-4,
              yield_to_maturity: Optional[float] = None) -> float:
        ytm = yield_to_maturity if yield_to_maturity is not None else self.yield_to_maturity()
        mid = self._dirty_from_yield(ytm, value_date)
        up = self._dirty_from_yield(ytm + bump, value_date)
        down = self._dirty_from_yield(ytm - bump, value_date)
        return (up - 2 * mid + down) / bump**2 * bump
