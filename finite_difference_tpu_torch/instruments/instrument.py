"""Instrument base class (the port's copy of
``finite_difference_tpu.instruments.instrument``, host numpy).

Capability parity with the reference's ``instrument.py:15-147``: concrete
subclasses implement ``scenario_npvs`` (pathwise NPV at one simulation
date), may override ``precompute`` (PDE surfaces / LSM boundaries /
surrogates before the simulation loop), expose ``effective_maturity`` via
attribute probing, and can seed OIS compounding with historical compound
factors (the RiskFlow ``old_resets`` convention).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from datetime import date
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Instrument(ABC):
    def __init__(self, name: str):
        self.name = name

    @property
    def effective_maturity(self) -> Optional[date]:
        """Latest date with a possibly non-zero NPV (instrument.py:27-42)."""
        for attr in (
            "_effective_maturity",
            "maturity_date",
            "expiry_date",
            "delivery_date",
            "end_date",
        ):
            val = getattr(self, attr, None)
            if val is not None:
                return val
        return None

    def precompute(
        self,
        market_states: Sequence[Dict[str, object]],
        dates: Sequence[date],
    ) -> None:
        """Hook called once before the simulation loop (instrument.py:44-74)."""

    @abstractmethod
    def scenario_npvs(
        self,
        val_date: date,
        market_state: Dict[str, object],
        fixings: Optional[Dict[Tuple[str, date], np.ndarray]] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """NPV per path at one simulation date: (n_paths,)."""

    def get_ois_initial_cf(self, curve_name: str, p_start: date) -> Optional[float]:
        """Historical OIS compound-factor seed (instrument.py:109-134)."""
        cfs = getattr(self, "_ois_initial_cfs", None)
        if not cfs:
            return None
        return cfs.get((curve_name, p_start))

    def npv(
        self,
        val_date: date,
        market_state: Dict[str, object],
        fixings: Optional[Dict[Tuple[str, date], np.ndarray]] = None,
    ) -> float:
        """Scalar NPV convenience wrapper (instrument.py:136-147)."""
        return float(self.scenario_npvs(val_date, market_state, fixings)[0])
