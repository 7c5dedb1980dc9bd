"""Configuration objects for the commodity-XVA engine (the port's copy of
``finite_difference_tpu.xva.config``, host numpy).

Capability parity with the reference ``xva_engine`` package's
``config.py:8-65``. Unlike the reference (plain field carriers), these
configs own the small closed-form pieces of math they describe —
survival probabilities, discount factors, the scenario grid — so the
engine and the CVA kernels stay purely orchestration + device code.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np


class SamplingConvention(str, Enum):
    """How a reference price samples fixings over its window (config.py:8-12)."""

    DAILY = "daily"
    BULLET = "bullet"
    WEEKLY = "weekly"
    MONTHLY = "monthly"

    @property
    def stride_days(self) -> Optional[int]:
        """Fixing spacing in days; ``None`` for a single bullet fixing."""
        return {"daily": 1, "weekly": 7, "monthly": 30, "bullet": None}[self.value]


@dataclass(frozen=True)
class SimulationConfig:
    """Scenario-simulation controls (config.py:15-32).

    ``num_sims`` Sobol/normal paths on a regular ``dt_days`` grid out to
    ``horizon_days``; ``fast_forward`` skips that many Sobol points for
    RiskFlow seed parity.
    """

    num_sims: int = 50_000
    seed: int = 1
    fast_forward: int = 0
    dt_days: int = 1
    horizon_days: int = 365
    days_in_year: float = 365.0

    def time_grid(self):
        """The scenario :class:`~finite_difference_tpu_torch.xva.time_grid.TimeGrid`."""
        from .time_grid import TimeGrid

        return TimeGrid.regular(self.dt_days, self.horizon_days)


@dataclass(frozen=True)
class CounterpartyConfig:
    """Deterministic flat-hazard credit curve (config.py:35-43)."""

    hazard_rate: float
    recovery: float = 0.4

    @property
    def lgd(self) -> float:
        return 1.0 - float(self.recovery)

    def survival(self, t_years: np.ndarray) -> np.ndarray:
        """S(t) = exp(-h t) under the flat hazard h."""
        return np.exp(-float(self.hazard_rate) * np.asarray(t_years, dtype=float))


@dataclass(frozen=True)
class DiscountingConfig:
    """Flat continuously-compounded funding (and optional collateral) rate
    (config.py:46-51)."""

    rate: float
    collateral_rate: Optional[float] = None

    def df(self, t_years: np.ndarray) -> np.ndarray:
        return np.exp(-float(self.rate) * np.asarray(t_years, dtype=float))
