"""Scenario time grid (days from the base date; the port's copy of
``finite_difference_tpu.xva.time_grid``, host numpy).

Capability parity with the reference's ``time_grid.py:8-33`` — a regular
day grid that is clipped to the horizon when the step does not divide it.
For RiskFlow-style irregular grid strings ('0d 2d 1w(1w) ...') see
the JAX package's ``scenarios.time_grid``, which the port does not have
yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def regular_day_grid(dt_days: int, horizon_days: int) -> np.ndarray:
    """Day offsets ``0, dt, 2*dt, ...`` ending exactly at the horizon.

    When ``dt_days`` does not divide ``horizon_days`` the final interval is
    the remainder stub (so the grid always lands on the horizon).
    """
    if dt_days < 1:
        raise ValueError("dt_days must be positive.")
    if horizon_days < 1:
        raise ValueError("horizon_days must be positive.")
    n_whole = int(horizon_days) // int(dt_days)
    days = np.arange(n_whole + 1, dtype=np.float64) * float(dt_days)
    if days[-1] < horizon_days:
        days = np.append(days, float(horizon_days))
    return days


@dataclass(frozen=True)
class TimeGrid:
    """A (n_steps,) array of day offsets plus year-fraction conversion."""

    scen_days: np.ndarray

    @classmethod
    def regular(cls, dt_days: int, horizon_days: int) -> "TimeGrid":
        return cls(scen_days=regular_day_grid(dt_days, horizon_days))

    def __len__(self) -> int:
        return int(self.scen_days.size)

    @property
    def n_steps(self) -> int:
        return len(self)

    def year_fractions(self, days_in_year: float) -> np.ndarray:
        return self.scen_days / float(days_in_year)
