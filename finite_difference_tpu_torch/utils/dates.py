"""Date coercion helpers (host-side only).

The port's own copy of ``finite_difference_tpu.utils.dates`` (host code,
no torch), so the port imports nothing of the JAX package.

Capability parity with the reference's ``dates.py`` (to_date / day_offset /
add_days / ensure_dates) — trivially small, re-specified here so nothing on
the host path depends on pandas internals.
"""
from __future__ import annotations

import datetime as dt
from typing import Iterable, List, Union

DateLike = Union[dt.date, dt.datetime, str]


def to_date(x: DateLike) -> dt.date:
    """Coerce a date-like object (date, datetime, pandas Timestamp, ISO string)."""
    if isinstance(x, dt.datetime):
        return x.date()
    if isinstance(x, dt.date):
        return x
    if isinstance(x, str):
        return dt.date.fromisoformat(x.replace("/", "-"))
    # pandas.Timestamp and numpy datetime64 both expose .date() via Timestamp
    if hasattr(x, "date") and callable(x.date):
        return x.date()
    raise TypeError(f"Unsupported date-like type: {type(x)!r}")


def day_offset(base_date: DateLike, d: DateLike) -> int:
    """Whole days from ``base_date`` to ``d``."""
    return (to_date(d) - to_date(base_date)).days


def add_days(base_date: DateLike, days: float) -> dt.date:
    """Add (rounded) calendar days to a date."""
    return to_date(base_date) + dt.timedelta(days=int(round(days)))


def ensure_dates(seq: Iterable[DateLike]) -> List[dt.date]:
    return [to_date(x) for x in seq]
