"""RiskFlow time-grid conventions: Excel serial dates and grid strings
(the port's copy of ``finite_difference_tpu.scenarios.time_grid``, host
only, on ``datetime.date``).

- all dates are Excel serial day numbers (days since 1899-12-30);
- year fractions use DAYS_IN_YEAR = 365.25;
- a grid string like ``'0d 2d 1w(1w) 1m(1m) 3m(3m)'`` expands to a sorted
  set of day offsets from the run date, where ``start(repeat)`` segments
  tick until the next segment's start (or max_date).

An offset is a :class:`DateOffset` with relativedelta's rule (pandas'
``DateOffset``): years and months first, the day clipped to the month's
end, then weeks and days.
"""
from __future__ import annotations

import calendar
import datetime as dt
import re
from dataclasses import dataclass
from typing import Union

import numpy as np

from ..utils.dates import to_date

DAYS_IN_YEAR = 365.25
EXCEL_OFFSET = dt.date(1899, 12, 30)
_OFFSET_LOOKUP = {"M": "months", "D": "days", "Y": "years", "W": "weeks"}

DateInput = Union[str, dt.date]


def as_date(d) -> dt.date:
    """A date from a date, a datetime (or pandas Timestamp), a numpy
    datetime64 or an ISO string with or without a time of day (dropped)."""
    if isinstance(d, str):
        return dt.datetime.fromisoformat(d.strip().replace("/", "-")).date()
    if isinstance(d, np.datetime64):
        return d.astype("datetime64[D]").astype(dt.date)
    return to_date(d)


@dataclass(frozen=True)
class DateOffset:
    """A calendar offset with pandas' ``DateOffset(years=, months=, weeks=,
    days=)`` arithmetic: ``date + offset`` adds the years and months (the
    day clipped to the target month's length), then the weeks and days."""

    years: int = 0
    months: int = 0
    weeks: int = 0
    days: int = 0

    def __radd__(self, other):
        if isinstance(other, dt.datetime):
            return dt.datetime.combine(self._apply(other.date()), other.time())
        if isinstance(other, dt.date):
            return self._apply(other)
        return NotImplemented

    def _apply(self, d: dt.date) -> dt.date:
        month_index = d.month - 1 + self.months + 12 * self.years
        year, month = d.year + month_index // 12, month_index % 12 + 1
        day = min(d.day, calendar.monthrange(year, month)[1])
        return dt.date(year, month, day) + dt.timedelta(days=7 * self.weeks + self.days)


def date_to_excel_days(ts: DateInput) -> int:
    """Excel serial day number of a date (cs_simulation.py:67-89)."""
    return (as_date(ts) - EXCEL_OFFSET).days


def excel_days_to_date(excel_days: float) -> dt.date:
    """Inverse of :func:`date_to_excel_days`."""
    return EXCEL_OFFSET + dt.timedelta(days=int(excel_days))


def parse_offset(s: str) -> DateOffset:
    """Parse '2d' / '1m' / '1y3m' into a :class:`DateOffset`
    (cs_simulation.py:196-215). Compound offsets accumulate unit-value
    pairs, so '1y3m' is 1 year plus 3 months."""
    pairs = re.findall(r"(\d+)([dDmMwWyY])", s)
    if not pairs:
        raise ValueError(f"Cannot parse offset: {s!r}")
    kwargs: dict = {}
    for value, unit in pairs:
        key = _OFFSET_LOOKUP[unit.upper()]
        kwargs[key] = kwargs.get(key, 0) + int(value)
    return DateOffset(**kwargs)


def parse_time_grid(run_date: DateInput, max_date: DateInput, grid_string: str) -> np.ndarray:
    """Expand a RiskFlow grid string into sorted day offsets from run_date.

    Mirrors cs_simulation.py:103-194 (itself riskflow config.parse_grid +
    TimeGrid.set_base_date): each ``start(repeat)`` segment generates dates
    from ``run_date + start`` stepping by ``repeat`` (repeated addition, so
    Jan 31 + 1m + 1m is Mar 28) until it passes the next segment's start
    date or ``max_date``. Bare offsets contribute a single date. Returns
    ``np.ndarray[int]`` — the scen_time_grid.

    RiskFlow quirk kept for parity: a repeating segment that steps past
    ``max_date`` stops the WHOLE parse, silently dropping later segments
    even when their start dates are inside the horizon. Grid strings are
    ascending in every RiskFlow config; keep yours ascending too.
    """
    run_date, max_date = as_date(run_date), as_date(max_date)
    parsed = []
    for seg in grid_string.strip().split():
        if "(" in seg:
            start_str, repeat_str = seg.split("(")
            parsed.append((parse_offset(start_str), parse_offset(repeat_str.rstrip(")"))))
        else:
            parsed.append((parse_offset(seg), None))

    fixed = [(run_date + start, repeat) for start, repeat in parsed]
    fixed.append((dt.date.max, None))

    dates = set()
    finish = False
    for (date_rule, repeat), (next_start, _) in zip(fixed[:-1], fixed[1:]):
        next_date = date_rule
        if next_date > max_date:
            break
        dates.add(next_date)
        if repeat:
            while True:
                next_date = next_date + repeat
                if next_date > max_date:
                    finish = True
                    break
                if next_date > next_start:
                    break
                dates.add(next_date)
        if finish:
            break

    return np.array(sorted((d - run_date).days for d in dates))
