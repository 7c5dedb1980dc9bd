"""Exposure profiles and CVA (the port of ``finite_difference_tpu.xva.cva``).

Capability parity with the reference's ``cva.py:10-82``:

- EE   = mean positive exposure per scenario date (optionally deflated
         to t=0 with a flat discount factor);
- PFE  = q-quantile of positive exposure per date;
- CVA  = LGD * sum_i 0.5*(EE*_{i-1}+EE*_i) * (S_{i-1}-S_i) with
         flat-hazard survival S(t)=exp(-h t).

The per-date reductions run where the MTM tensor lies (a tensor stays on
its device; a numpy array is reduced on the CPU), and only the
(n_steps,)-sized profile comes back to the host. The quantile is JAX's
``linear`` method computed from one sort along the path axis:
``torch.quantile`` refuses inputs above 2^24 elements, which a CVA cube
(200,000 paths x 121 dates) exceeds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import CounterpartyConfig


@dataclass(frozen=True)
class ExposureProfile:
    times_days: np.ndarray
    ee: np.ndarray
    pfe: np.ndarray


def quantile_linear(x: torch.Tensor, q: float, dim: int = -1) -> torch.Tensor:
    """The ``q`` quantile of ``x`` along ``dim`` by linear interpolation
    between order statistics at position q * (n - 1) (``jnp.quantile``'s
    default ``method="linear"``), for inputs of any size."""
    n = x.shape[dim]
    xs = torch.sort(x, dim=dim).values
    pos = float(q) * (n - 1)
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    w_hi = pos - np.floor(pos)
    return xs.select(dim, lo) * (1.0 - w_hi) + xs.select(dim, hi) * w_hi


def _ee_pfe(mtm: torch.Tensor, df0: torch.Tensor, q: float):
    """Deflated positive-exposure mean and quantile over the sim axis."""
    exposure = torch.clamp_min(mtm, 0.0) * df0[:, None]
    return exposure.mean(dim=1), quantile_linear(exposure, q, dim=1)


def exposure_profile(
    times_days,
    mtm_paths,
    *,
    pfe_quantile: float = 0.95,
    df0=None,
) -> ExposureProfile:
    """EE/PFE profile from an (n_steps, n_sims) mark-to-market tensor.

    ``df0`` (per-date deflators to t=0) defaults to 1 — undiscounted
    exposure, the convention the reference uses for PFE reporting.
    ``mtm_paths``: a tensor (reduced on its device, in its dtype) or an
    array (reduced on the CPU at float64).
    """
    times_days = np.asarray(times_days, dtype=float)
    mtm = mtm_paths if torch.is_tensor(mtm_paths) else torch.as_tensor(
        np.asarray(mtm_paths, dtype=np.float64)
    )
    if mtm.ndim != 2 or mtm.shape[0] != times_days.size:
        raise ValueError("mtm_paths must be (n_steps, n_sims) aligned to times_days.")
    deflator = np.ones(times_days.size) if df0 is None else np.asarray(df0, dtype=np.float64)
    ee, pfe = _ee_pfe(mtm, torch.as_tensor(deflator, dtype=mtm.dtype, device=mtm.device),
                      float(pfe_quantile))
    return ExposureProfile(
        times_days=times_days, ee=ee.cpu().numpy(), pfe=pfe.cpu().numpy()
    )


def cva_trapezoid(ee_star: np.ndarray, survival: np.ndarray, lgd: float) -> float:
    """Unilateral CVA: LGD-weighted trapezoid of EE* against default mass."""
    ee_star = np.asarray(ee_star, dtype=float)
    survival = np.asarray(survival, dtype=float)
    mid_ee = 0.5 * (ee_star[1:] + ee_star[:-1])
    default_mass = -np.diff(survival)
    return float(lgd * np.dot(mid_ee, default_mass))


class XvaCalculator:
    """Reference-shaped facade over the functional pieces (cva.py:22-82)."""

    def __init__(
        self,
        counterparty: CounterpartyConfig,
        days_in_year: float,
        pfe_quantile: float = 0.95,
        discount_to_zero: bool = True,
        flat_discount_rate: float = 0.0,
    ) -> None:
        self.cp = counterparty
        self.days_in_year = float(days_in_year)
        self.q = float(pfe_quantile)
        self.discount_to_zero = bool(discount_to_zero)
        self.flat_discount_rate = float(flat_discount_rate)

    def build_exposure_profile(self, times_days, mtm_paths) -> ExposureProfile:
        t_years = np.asarray(times_days, dtype=float) / self.days_in_year
        df0 = (
            np.exp(-self.flat_discount_rate * t_years)
            if self.discount_to_zero
            else None
        )
        return exposure_profile(
            times_days, mtm_paths, pfe_quantile=self.q, df0=df0
        )

    def cva_from_ee(self, times_days, ee_star) -> float:
        times_days = np.asarray(times_days, dtype=float)
        ee_star = np.asarray(ee_star, dtype=float)
        if times_days.size != ee_star.size:
            raise ValueError("times_days and ee_star must have same length.")
        S = self.cp.survival(times_days / self.days_in_year)
        return cva_trapezoid(ee_star, S, self.cp.lgd)
