"""Commodity reference prices from simulated forward curves (the port of
``finite_difference_tpu.xva.reference_price``).

Capability parity with the reference's ``reference_price.py`` (FixingSchedule
:13-48, ReferencePrice :50-146): instead of per-date interpolation calls,
the fixing mixture is precomputed host-side into gather indices and
weights and evaluated for EVERY scenario date at once, with two
``index_select`` gathers along the tenor axis on the curves' device.

Semantics preserved exactly:
- sample days from the convention (bullet / daily / weekly / monthly~30d)
  plus an offset;
- a settlement lag shifts the curve query day: F(t, fixing + lag);
- flat extrapolation and linear interpolation in tenor;
- realised fixings (sample day <= scenario day and present in the realised
  map) replace the curve sample; the output is the equal-weighted average
  over ALL sample days (the reference's pro-rata mix reduces to sum / n).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .config import SamplingConvention


@dataclass(frozen=True)
class FixingSchedule:
    """Fixing window [start_day, end_day] in days-from-value-date."""

    start_day: int
    end_day: int
    convention: SamplingConvention = SamplingConvention.DAILY
    offset_days: int = 0

    def sample_days(self) -> np.ndarray:
        start = int(self.start_day) + int(self.offset_days)
        end = int(self.end_day) + int(self.offset_days)
        if end < start:
            raise ValueError("FixingSchedule end_day must be >= start_day (after offset).")
        if self.convention == SamplingConvention.BULLET:
            return np.array([float(end)])
        step = {
            SamplingConvention.DAILY: 1,
            SamplingConvention.WEEKLY: 7,
            SamplingConvention.MONTHLY: 30,  # reference's lightweight approximation
        }.get(self.convention)
        if step is None:
            raise ValueError(f"Unsupported convention: {self.convention}")
        return np.arange(start, end + 1, step, dtype=float)


def _interp_plan(tenor_days: np.ndarray, query_days: np.ndarray):
    """Host-side linear-interp plan: (left idx, right idx, right weight)."""
    td = np.asarray(tenor_days, dtype=float)
    x = np.clip(np.asarray(query_days, dtype=float), td[0], td[-1])
    j = np.clip(np.searchsorted(td, x, side="left"), 1, td.size - 1)
    i = j - 1
    denom = np.where(td[j] - td[i] == 0.0, 1.0, td[j] - td[i])
    w = (x - td[i]) / denom
    return i, j, w


def _reference_price(curves, left, right, w, realised_vals, realised_mask):
    """ref[t, p] = mean_j( realised | interp ) over sample days.

    curves (n_steps, n_tenors, n_sims); left/right/w (n_samples,);
    realised_vals (n_samples,); realised_mask (n_steps, n_samples).
    """
    sampled = (1.0 - w)[None, :, None] * curves.index_select(1, left) + w[
        None, :, None
    ] * curves.index_select(1, right)  # (n_steps, n_samples, n_sims)
    mixed = torch.where(realised_mask[:, :, None], realised_vals[None, :, None], sampled)
    return mixed.mean(dim=1)  # (n_steps, n_sims)


class ReferencePrice:
    """Averaged reference price with realised fixings and settlement lag."""

    def __init__(
        self,
        fixing_schedule: FixingSchedule,
        settlement_lag_days: int = 2,
        realised_fixings: Optional[Dict[int, float]] = None,
    ) -> None:
        self.fixing_schedule = fixing_schedule
        self.settlement_lag_days = int(settlement_lag_days)
        self.realised_fixings = realised_fixings or {}

    def compute_all(
        self,
        scen_days: np.ndarray,
        curves: torch.Tensor,  # (n_steps, n_tenors, n_sims)
        tenor_days: np.ndarray,
    ) -> torch.Tensor:
        """Reference prices for every scenario date: (n_steps, n_sims), on
        the curves' device and in their dtype."""
        sample_days = self.fixing_schedule.sample_days()
        query_days = sample_days + float(self.settlement_lag_days)
        left, right, w = _interp_plan(tenor_days, query_days)

        has_fix = np.array([int(d) in self.realised_fixings for d in sample_days])
        vals = np.array(
            [self.realised_fixings.get(int(d), 0.0) for d in sample_days], dtype=float
        )
        scen = np.asarray(scen_days, dtype=float)
        realised_mask = (sample_days[None, :] <= scen[:, None]) & has_fix[None, :]

        curves = torch.as_tensor(curves)
        dev, dtype = curves.device, curves.dtype
        return _reference_price(
            curves,
            torch.as_tensor(left, device=dev),
            torch.as_tensor(right, device=dev),
            torch.as_tensor(w, device=dev, dtype=dtype),
            torch.as_tensor(vals, device=dev, dtype=dtype),
            torch.as_tensor(realised_mask, device=dev),
        )

    def compute(
        self,
        scen_index: int,
        scen_day: float,
        scen_curve: torch.Tensor,  # (n_tenors, n_sims)
        tenor_days: np.ndarray,
    ) -> torch.Tensor:
        """Single-date API mirror of the reference (reference_price.py:103-145)."""
        out = self.compute_all(
            np.array([float(scen_day)]), torch.as_tensor(scen_curve)[None, :, :], tenor_days
        )
        return out[0]
