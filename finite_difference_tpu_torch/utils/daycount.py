"""Day-count conventions (host-side, scalar and vectorized).

The port's own copy of ``finite_difference_tpu.utils.daycount`` (host code,
no torch), so the port imports nothing of the JAX package.

Semantics match the reference's per-pricer ``_year_fraction`` /
``_infer_denominator`` (e.g. fd_american_equity.py:270-334,
class_yield.py:27-41): simple ACT/NNN fractions with a floor at zero, plus the
US 30/360 adjustment (d1 capped at 30; d2 capped only when d1 == 30).
"""
from __future__ import annotations

import datetime as dt
from typing import Union

import numpy as np

from .dates import DateLike, to_date

_ACT_DENOMS = {
    "ACT/365": 365,
    "ACT/365F": 365,
    "ACT/360": 360,
    "ACT/364": 364,
}
_THIRTY360 = ("30/360", "BOND", "US30/360")


def normalize_convention(day_count: str) -> str:
    """Uppercase and strip the trailing 'F' the way the reference does."""
    return day_count.upper().replace("F", "")


def year_denominator(day_count: str) -> int:
    dc = day_count.upper()
    if dc in ("ACT/365", "ACT/365F"):
        return 365
    if dc == "ACT/360":
        return 360
    if dc == "ACT/364":
        return 364
    if dc in _THIRTY360:
        return 360
    return 365


def year_fraction(
    start_date: DateLike,
    end_date: DateLike,
    day_count: str = "ACT/365",
) -> float:
    """Year fraction between two dates; returns 0.0 when end <= start."""
    d0, d1 = to_date(start_date), to_date(end_date)
    if d1 <= d0:
        return 0.0
    dc = day_count.upper()
    if dc in _ACT_DENOMS:
        return (d1 - d0).days / float(_ACT_DENOMS[dc])
    if dc in _THIRTY360:
        y1, m1, dd1 = d0.year, d0.month, d0.day
        y2, m2, dd2 = d1.year, d1.month, d1.day
        dd1 = min(dd1, 30)
        if dd1 == 30:
            dd2 = min(dd2, 30)
        days = (y2 - y1) * 360 + (m2 - m1) * 30 + (dd2 - dd1)
        return days / 360.0
    return (d1 - d0).days / 365.0


def year_fractions_from_days(
    day_counts: Union[np.ndarray, int],
    day_count: str = "ACT/365",
) -> np.ndarray:
    """Vectorized ACT/NNN year fractions from whole-day offsets (floored at 0)."""
    denom = float(year_denominator(day_count))
    days = np.asarray(day_counts, dtype=np.float64)
    return np.maximum(days, 0.0) / denom
