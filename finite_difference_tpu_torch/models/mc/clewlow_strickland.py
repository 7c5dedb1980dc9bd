"""Clewlow–Strickland one-factor forward-curve simulator (counterpart of
``finite_difference_tpu.models.mc.clewlow_strickland``).

Capability parity with the reference's ``CSForwardCurveSimulator``
(clewlow_strickland.py:25-143), which replicates RiskFlow's
CSForwardPriceModel mechanics exactly:

    dF(t,T)/F = mu dt + sigma e^{-alpha (T - t)} dW

- maturity-clipped per-tenor dt matrix (variance stops accumulating once a
  curve node delivers, :52-70);
- OU cumulative variance var = sigma^2 e^{-2 alpha tenor} (1 - e^{-2 alpha
  t})/(2 alpha); per-step vol = sqrt(diff var); drift = mu t - var/2;
- F = F0 * exp(drift + cumsum(vol * Z)), one factor broadcast over tenors;
- risk_neutral=True zeroes mu (implied mode).

The (drift, vol) tensors are built on the host with numpy, as in the JAX
package; the paths run on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from .gbm import _on


@dataclass(frozen=True)
class CSParams:
    alpha: float
    sigma: float
    mu: float


def riskflow_dt_matrix_days(scen_days: np.ndarray, tenor_days: np.ndarray) -> np.ndarray:
    """Per-tenor clipped day increments (clewlow_strickland.py:52-70)."""
    tenor_rel = np.asarray(tenor_days, dtype=np.float64).reshape(1, -1)
    scen = np.asarray(scen_days, dtype=np.float64)
    start = scen[:-1].reshape(-1, 1)
    end = scen[1:].reshape(-1, 1)
    delta = np.clip(tenor_rel, start, end) - start
    return np.insert(delta, 0, 0.0, axis=0)  # (n_steps, n_tenors)


def cs_precalculate(
    params: CSParams,
    tenor_days: np.ndarray,
    scen_days: np.ndarray,
    days_in_year: float,
    risk_neutral: bool = False,
):
    """Host precompute of (drift, vol) tensors, both (n_steps, n_tenors)."""
    dt = riskflow_dt_matrix_days(scen_days, tenor_days) / days_in_year
    t_cum = dt.cumsum(axis=0)
    tenors = (
        np.asarray(tenor_days, np.float64).reshape(1, -1)
        - np.asarray(scen_days, np.float64).reshape(-1, 1)
    ).clip(0.0, np.inf) / days_in_year

    alpha, sigma = float(params.alpha), float(params.sigma)
    mu = 0.0 if risk_neutral else float(params.mu)

    var_adj = (1.0 - np.exp(-2.0 * alpha * t_cum)) / (2.0 * alpha)
    var = sigma**2 * np.exp(-2.0 * alpha * tenors) * var_adj
    delta_var = np.maximum(np.diff(np.insert(var, 0, 0.0, axis=0), axis=0), 0.0)
    vol = np.sqrt(delta_var)
    drift = mu * t_cum - 0.5 * var
    return drift, vol


def cs_simulate_paths(initial_curve, drift, vol, z, device=None):
    """F (n_steps, n_tenors, n_sims) from shocks z (n_steps, n_sims), on the
    device of ``z`` (or ``device``)."""
    if device is None:
        device = z.device if torch.is_tensor(z) else DEFAULT_DEVICE
    z = _on(z, device)
    init = _on(initial_curve, z.device)[None, :, None]
    drift = _on(drift, z.device)[:, :, None]
    vol = _on(vol, z.device)[:, :, None]
    return init * torch.exp(drift + torch.cumsum(vol * z[:, None, :], dim=0))


class CSForwardCurveSimulator:
    """API mirror of the reference class (clewlow_strickland.py:25)."""

    def __init__(self, params: CSParams, days_in_year: float, device=DEFAULT_DEVICE,
                 **_ignored) -> None:
        self.params = params
        self.days_in_year = float(days_in_year)
        self.device = resolve_device(device)

    def _riskflow_dt_matrix_days(self, scen_days, tenor_days):
        return riskflow_dt_matrix_days(scen_days, tenor_days)

    def simulate(
        self,
        initial_curve: np.ndarray,
        tenor_days: np.ndarray,
        scen_days: np.ndarray,
        z,
        risk_neutral: bool = False,
    ):
        z = _on(z, self.device)
        if z.ndim != 2 or z.shape[0] != np.asarray(scen_days).size:
            raise ValueError("z must be shape (n_steps, n_sims) aligned to scen_days.")
        drift, vol = cs_precalculate(
            self.params, tenor_days, scen_days, self.days_in_year, risk_neutral
        )
        return cs_simulate_paths(np.asarray(initial_curve), drift, vol, z)
