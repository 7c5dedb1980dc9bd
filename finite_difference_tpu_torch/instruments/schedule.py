"""Payment schedules, business-day conventions, sub-periods (the port's copy of
``finite_difference_tpu.instruments.schedule``, host numpy).

QuantLib-free reconstruction of the reference's absent
``instruments.components.schedule_config`` / ``utils.ql_helpers``
(call sites: ir_swap.py:62-96,100-129, equity_trs.py, index_linked_swap.py):

- month-offset date arithmetic with end-of-month clamping;
- business-day conventions: Following / ModifiedFollowing / Preceding /
  Unadjusted over a pluggable holiday calendar;
- backward/forward schedule generation at a monthly frequency, emitting
  (accrual_start, accrual_end, payment_date, accrual_fraction) tuples;
- ``generate_sub_periods`` for compounded reset legs;
- ``build_overnight_tenors`` — the business-day year-fraction grid used by
  OIS compounding (models.cashflow_pv._build_overnight_tenors).
"""
from __future__ import annotations

import calendar as _cal
import datetime as dt
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..utils.calendars import SouthAfricaCalendar
from ..utils.daycount import year_fraction


class WeekendCalendar:
    """Weekend-only holiday calendar."""

    def is_working_day(self, day: dt.date) -> bool:
        return day.weekday() < 5

    def add_working_days(self, day: dt.date, delta: int) -> dt.date:
        step = 1 if delta >= 0 else -1
        remaining = abs(delta)
        while remaining > 0:
            day = day + dt.timedelta(days=step)
            if self.is_working_day(day):
                remaining -= 1
        return day


_CALENDARS = {
    "ZAR": SouthAfricaCalendar,
    "SOUTHAFRICA": SouthAfricaCalendar,
    "WEEKENDSONLY": WeekendCalendar,
    "TARGET": WeekendCalendar,
    "NULL": WeekendCalendar,
}


def get_calendar(name: str):
    key = name.replace(" ", "").replace("_", "").upper()
    if key not in _CALENDARS:
        raise KeyError(f"Unknown calendar {name!r}; known: {sorted(_CALENDARS)}")
    return _CALENDARS[key]()


def add_months(day: dt.date, months: int) -> dt.date:
    """Calendar-month shift with end-of-month clamping."""
    month_index = day.month - 1 + months
    year = day.year + month_index // 12
    month = month_index % 12 + 1
    dom = min(day.day, _cal.monthrange(year, month)[1])
    return dt.date(year, month, dom)


def adjust(day: dt.date, calendar, convention: str) -> dt.date:
    """Business-day adjustment."""
    conv = convention.replace(" ", "").replace("_", "").lower()
    if conv in ("unadjusted", "none"):
        return day
    if calendar.is_working_day(day):
        return day
    if conv == "following":
        return calendar.add_working_days(day, 1)
    if conv == "preceding":
        return calendar.add_working_days(day, -1)
    if conv == "modifiedfollowing":
        nxt = calendar.add_working_days(day, 1)
        return nxt if nxt.month == day.month else calendar.add_working_days(day, -1)
    if conv == "modifiedpreceding":
        prv = calendar.add_working_days(day, -1)
        return prv if prv.month == day.month else calendar.add_working_days(day, 1)
    raise ValueError(f"Unknown business convention {convention!r}")


@dataclass(frozen=True)
class ScheduleConfig:
    """Schedule conventions (reconstruction of ScheduleConfig, ir_swap.py:62-77)."""

    calendar: str = "ZAR"
    business_convention: str = "ModifiedFollowing"
    termination_business_convention: str = "ModifiedFollowing"
    date_generation: str = "Backward"
    day_count: str = "ACT/365"
    curve_day_count: str = "ACT/365"
    end_of_month: bool = False
    payment_lag_days: int = 0

    @property
    def cal(self):
        return get_calendar(self.calendar)

    def year_fraction(self, d0: dt.date, d1: dt.date) -> float:
        return year_fraction(d0, d1, self.day_count)

    def curve_year_fraction(self, d0: dt.date, d1: dt.date) -> float:
        return year_fraction(d0, d1, self.curve_day_count)

    def build(
        self,
        effective_date: dt.date,
        maturity_date: dt.date,
        frequency_months: int,
    ) -> List[Tuple[dt.date, dt.date, dt.date, float]]:
        """(accrual_start, accrual_end, payment_date, accrual) per period."""
        if frequency_months <= 0:
            raise ValueError("frequency_months must be positive.")
        cal = self.cal

        unadjusted: List[dt.date] = []
        if self.date_generation.lower() == "backward":
            d = maturity_date
            k = 0
            while d > effective_date:
                unadjusted.append(d)
                k += 1
                d = add_months(maturity_date, -k * frequency_months)
            unadjusted.append(effective_date)
            unadjusted.reverse()
        else:  # forward
            d = effective_date
            k = 0
            while d < maturity_date:
                unadjusted.append(d)
                k += 1
                d = add_months(effective_date, k * frequency_months)
            unadjusted.append(maturity_date)

        periods = []
        n = len(unadjusted)
        for idx in range(n - 1):
            conv0 = self.business_convention
            conv1 = (
                self.termination_business_convention
                if idx == n - 2
                else self.business_convention
            )
            start = adjust(unadjusted[idx], cal, conv0)
            end = adjust(unadjusted[idx + 1], cal, conv1)
            pay = end
            if self.payment_lag_days:
                pay = cal.add_working_days(pay, self.payment_lag_days)
            periods.append((start, end, pay, self.year_fraction(start, end)))
        return periods


def generate_sub_periods(
    start: dt.date,
    end: dt.date,
    sub_months: int,
    calendar,
    convention: str,
    day_count: str,
    direction: str = "Backward",
) -> List[Tuple[dt.date, dt.date, float]]:
    """Split [start, end] into compounding sub-periods (ir_swap.py:112-121)."""
    unadjusted: List[dt.date] = []
    if direction.lower() == "backward":
        d = end
        k = 0
        while d > start:
            unadjusted.append(d)
            k += 1
            d = add_months(end, -k * sub_months)
        unadjusted.append(start)
        unadjusted.reverse()
    else:
        d = start
        k = 0
        while d < end:
            unadjusted.append(d)
            k += 1
            d = add_months(start, k * sub_months)
        unadjusted.append(end)

    out = []
    for idx in range(len(unadjusted) - 1):
        s = adjust(unadjusted[idx], calendar, convention) if idx > 0 else unadjusted[idx]
        e = (
            adjust(unadjusted[idx + 1], calendar, convention)
            if idx + 1 < len(unadjusted) - 1
            else unadjusted[idx + 1]
        )
        out.append((s, e, year_fraction(s, e, day_count)))
    return out


def build_overnight_tenors(
    t_from: dt.date,
    t_to: dt.date,
    val_date: dt.date,
    calendar,
    curve_day_count: str = "ACT/365",
) -> np.ndarray:
    """Year fractions (from val_date) of each business day in [t_from, t_to].

    Reconstruction of models.cashflow_pv._build_overnight_tenors
    (ir_swap.py:168-176): the grid on which one-step OIS compound factors
    telescope.
    """
    days = [t_from]
    d = t_from
    while d < t_to:
        d = calendar.add_working_days(d, 1)
        days.append(min(d, t_to) if d > t_to else d)
        if d >= t_to:
            break
    if days[-1] != t_to:
        days.append(t_to)
    return np.array(
        [year_fraction(val_date, d, curve_day_count) for d in days], dtype=np.float64
    )
