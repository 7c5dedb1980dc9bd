"""GBM path simulator (counterpart of ``finite_difference_tpu.models.mc.gbm``).

Capability parity with the reference's ``GBMSimulator``
(gbm_asset_price_diagnostic.py:55-123): exact log-Euler scheme on a
days-from-base grid (dt[0] = 0 so the first row is S0's date),
S_{t+dt} = S_t exp((mu - sigma^2/2) dt + sigma sqrt(dt) Z), plus the
Sobol/normal moment diagnostics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class GBMParams:
    mu: float
    sigma: float


def _on(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (resolved), keeping its dtype."""
    dev = resolve_device(device)
    return x.to(dev) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=dev)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def gbm_simulate_paths(s0, scen_days, z, mu, sigma, days_in_year: float = 365.0, device=None):
    """(n_steps, n_sims) spot paths on the device of ``z`` (or ``device``)."""
    if device is None:
        device = z.device if torch.is_tensor(z) else DEFAULT_DEVICE
    z = _on(z, device)
    t = torch.as_tensor(np.asarray(scen_days, dtype=np.float64), device=z.device) / days_in_year
    dt = torch.diff(t, prepend=t[0:1])[:, None]  # dt[0] = 0
    log_inc = (mu - 0.5 * sigma * sigma) * dt + sigma * torch.sqrt(dt.clamp_min(0.0)) * z
    return s0 * torch.exp(torch.cumsum(log_inc, dim=0))


class GBMSimulator:
    def __init__(self, params: GBMParams, days_in_year: float = 365.0, device=DEFAULT_DEVICE,
                 **_ignored) -> None:
        self.params = params
        self.days_in_year = float(days_in_year)
        self.device = resolve_device(device)

    def simulate(self, s0: float, scen_days: np.ndarray, z):
        scen_days = np.asarray(scen_days, dtype=float)
        if np.any(np.diff(scen_days) < 0.0):
            # the kernel clamps negative dt in the diffusion but not the
            # drift — a non-ascending grid would be silently wrong
            raise ValueError("scen_days must be ascending")
        z = _on(z, self.device)
        if z.ndim != 2 or z.shape[0] != scen_days.size:
            raise ValueError("z must be (n_steps, n_sims) aligned to scen_days.")
        return gbm_simulate_paths(
            float(s0), scen_days, z, self.params.mu, self.params.sigma, self.days_in_year
        )

    def sanity_check_mean(self, paths, s0: float, scen_days) -> Dict[str, float]:
        """E[S(t)] vs S0 e^{mu t} (gbm_asset_price_diagnostic.py:137-161)."""
        t = np.asarray(scen_days, dtype=float) / self.days_in_year
        empirical = _host(paths).mean(axis=1)
        target = float(s0) * np.exp(float(self.params.mu) * t)
        rel_err = (empirical - target) / np.maximum(target, 1e-12)
        return {
            "max_abs_rel_err": float(np.max(np.abs(rel_err))),
            "rel_err": rel_err,
        }

    def sanity_check_variance(self, paths, s0: float, scen_days) -> Dict[str, float]:
        """Var[log S/S0] vs sigma^2 t (gbm_asset_price_diagnostic.py:163-185)."""
        t = np.asarray(scen_days, dtype=float) / self.days_in_year
        log_ratio = np.log(_host(paths) / float(s0))
        emp_var = log_ratio.var(axis=1)
        target = float(self.params.sigma) ** 2 * t
        diff = emp_var - target
        return {"max_abs_err": float(np.max(np.abs(diff))), "err": diff}

    @staticmethod
    def sanity_check_z(z) -> Dict[str, float]:
        """Moment diagnostics of the shock matrix (mean~0, std~1, |skew|,
        kurtosis~3)."""
        z = np.asarray(_host(z), dtype=np.float64)
        mean = float(z.mean())
        std = float(z.std(ddof=1))
        zc = (z - z.mean()) / z.std()
        skew = float((zc**3).mean())
        kurt = float((zc**4).mean())
        return {"mean": mean, "std": std, "skew": skew, "kurtosis": kurt}
