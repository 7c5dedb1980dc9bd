"""Business-day calendars (host-side).

The port's own copy of ``finite_difference_tpu.utils.calendars`` (host code,
no torch), so the port imports nothing of the JAX package.

The reference relies on ``workalendar.africa.SouthAfrica`` for spot/settlement
lag resolution (fd_american_equity.py:190-225, discrete_barrier_bgk.py:211-245).
This module is a self-contained reimplementation of the same rules:

South African public holidays
-----------------------------
- New Year's Day (Jan 1), Human Rights Day (Mar 21), Good Friday (Easter - 2),
  Family Day (Easter Monday), Freedom Day (Apr 27), Workers' Day (May 1),
  Youth Day (Jun 16), National Women's Day (Aug 9), Heritage Day (Sep 24),
  Day of Reconciliation (Dec 16), Christmas Day (Dec 25),
  Day of Goodwill (Dec 26).
- Observance: a public holiday falling on a Sunday is observed the following
  Monday (Public Holidays Act 36 of 1994).

``add_working_days`` matches workalendar semantics: advance day-by-day,
counting only business days; ``add_working_days(d, 0)`` returns ``d``
unchanged (even when ``d`` is not itself a business day).
"""
from __future__ import annotations

import datetime as dt
from functools import lru_cache
from typing import FrozenSet, List

from .dates import DateLike, to_date


def easter_sunday(year: int) -> dt.date:
    """Anonymous Gregorian (Meeus/Jones/Butcher) Easter algorithm."""
    a = year % 19
    b, c = divmod(year, 100)
    d, e = divmod(b, 4)
    f = (b + 8) // 25
    g = (b - f + 1) // 3
    h = (19 * a + b - d - g + 15) % 30
    i, k = divmod(c, 4)
    l = (32 + 2 * e + 2 * i - h - k) % 7
    m = (a + 11 * h + 22 * l) // 451
    month = (h + l - 7 * m + 114) // 31
    day = ((h + l - 7 * m + 114) % 31) + 1
    return dt.date(year, month, day)


class SouthAfricaCalendar:
    """South African business-day calendar with Sunday→Monday observance."""

    FIXED_HOLIDAYS = (
        (1, 1),   # New Year's Day
        (3, 21),  # Human Rights Day
        (4, 27),  # Freedom Day
        (5, 1),   # Workers' Day
        (6, 16),  # Youth Day
        (8, 9),   # National Women's Day
        (9, 24),  # Heritage Day
        (12, 16), # Day of Reconciliation
        (12, 25), # Christmas Day
        (12, 26), # Day of Goodwill
    )

    @classmethod
    @lru_cache(maxsize=256)
    def holidays(cls, year: int) -> FrozenSet[dt.date]:
        days: List[dt.date] = [dt.date(year, m, d) for m, d in cls.FIXED_HOLIDAYS]
        easter = easter_sunday(year)
        days.append(easter - dt.timedelta(days=2))  # Good Friday
        days.append(easter + dt.timedelta(days=1))  # Family Day
        observed = set(days)
        for day in days:
            if day.weekday() == 6:  # Sunday -> observed Monday
                observed.add(day + dt.timedelta(days=1))
        return frozenset(observed)

    def is_holiday(self, day: DateLike) -> bool:
        d = to_date(day)
        return d in self.holidays(d.year)

    def is_working_day(self, day: DateLike) -> bool:
        d = to_date(day)
        if d.weekday() >= 5:  # Saturday/Sunday
            return False
        return d not in self.holidays(d.year)

    def add_working_days(self, day: DateLike, delta: int) -> dt.date:
        """Advance ``delta`` business days (workalendar-compatible semantics)."""
        d = to_date(day)
        delta = int(delta)
        step = 1 if delta >= 0 else -1
        remaining = abs(delta)
        while remaining > 0:
            d = d + dt.timedelta(days=step)
            if self.is_working_day(d):
                remaining -= 1
        return d

    def business_days_between(self, start: DateLike, end: DateLike) -> int:
        """Count business days in (start, end]."""
        d0, d1 = to_date(start), to_date(end)
        if d1 < d0:
            return -self.business_days_between(d1, d0)
        count = 0
        d = d0
        while d < d1:
            d = d + dt.timedelta(days=1)
            if self.is_working_day(d):
                count += 1
        return count

    def working_days_in_range(self, start: DateLike, end: DateLike) -> List[dt.date]:
        """All business days in [start, end]."""
        d0, d1 = to_date(start), to_date(end)
        out: List[dt.date] = []
        d = d0
        while d <= d1:
            if self.is_working_day(d):
                out.append(d)
            d = d + dt.timedelta(days=1)
        return out


def build_monitoring_dates(
    start: DateLike,
    end: DateLike,
    frequency: str = "daily",
    calendar: SouthAfricaCalendar | None = None,
) -> List[dt.date]:
    """Business-day-aware monitoring-date generator.

    Mirrors the reference's ``build_monitoring_dates``
    (discrete_barrier_bgk_main.py:123): daily = every business day in
    (start, end]; weekly/monthly = every 7th/~30th calendar day rolled
    forward to the next business day, de-duplicated, always including the
    final business day on/before ``end``.
    """
    cal = calendar or SouthAfricaCalendar()
    d0, d1 = to_date(start), to_date(end)
    if frequency == "daily":
        return [d for d in cal.working_days_in_range(d0 + dt.timedelta(days=1), d1)]
    step = {"weekly": 7, "monthly": 30}.get(frequency)
    if step is None:
        raise ValueError(f"Unknown monitoring frequency: {frequency!r}")
    out: List[dt.date] = []
    d = d0 + dt.timedelta(days=step)
    while d <= d1:
        b = d
        while not cal.is_working_day(b):
            b = b + dt.timedelta(days=1)
        if b <= d1 and (not out or out[-1] != b):
            out.append(b)
        d = d + dt.timedelta(days=step)
    # ensure maturity-side monitor
    last = d1
    while not cal.is_working_day(last):
        last = last - dt.timedelta(days=1)
    if not out or out[-1] != last:
        out.append(last)
    return out
