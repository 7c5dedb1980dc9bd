"""Commodity forward product (the port of
``finite_difference_tpu.xva.commodity_forward``).

Capability parity with the reference's ``commodity_forward.py:12-53``:
MTM(t, path) = DF(t -> cashflow day) * notional * (reference - strike),
with the maturity day being the CASHFLOW/SETTLEMENT day. Every scenario
date is valued at once (``mtm_all``, on the curves' device); the
reference's per-date ``mtm`` remains as a thin slice for API parity.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import DiscountingConfig
from .reference_price import ReferencePrice


@dataclass(frozen=True)
class CommodityForward:
    maturity_day: int
    strike: float
    notional: float
    reference_price: ReferencePrice
    discounting: DiscountingConfig

    @staticmethod
    def discount_factor(t_day, T_day: float, days_in_year: float, r: float):
        """exp(-r max((T - t) / days_in_year, 0)) for a tensor of days ``t_day``."""
        tau = torch.clamp_min((T_day - t_day) / float(days_in_year), 0.0)
        return torch.exp(-r * tau)

    def mtm_all(
        self,
        scen_days: np.ndarray,
        curves: torch.Tensor,  # (n_steps, n_tenors, n_sims)
        tenor_days: np.ndarray,
        days_in_year: float,
    ) -> torch.Tensor:
        """MTM paths for all scenario dates: (n_steps, n_sims)."""
        curves = torch.as_tensor(curves)
        ref = self.reference_price.compute_all(scen_days, curves, tenor_days)
        df = self.discount_factor(
            torch.as_tensor(np.asarray(scen_days, dtype=np.float64), device=curves.device),
            float(self.maturity_day),
            float(days_in_year),
            float(self.discounting.rate),
        ).to(ref.dtype)
        return df[:, None] * float(self.notional) * (ref - float(self.strike))

    def mtm(
        self,
        scen_index: int,
        scen_day: float,
        scen_curve: torch.Tensor,  # (n_tenors, n_sims)
        tenor_days: np.ndarray,
        days_in_year: float,
    ) -> torch.Tensor:
        """Single-date API mirror (commodity_forward.py:31-53)."""
        return self.mtm_all(
            np.array([float(scen_day)]),
            torch.as_tensor(scen_curve)[None, :, :],
            tenor_days,
            days_in_year,
        )[0]
