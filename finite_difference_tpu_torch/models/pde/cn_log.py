"""Year-fraction CN discrete-barrier pricer (dataclass API).

Counterpart of ``finite_difference_tpu.models.pde.cn_log``. Capability parity with the reference's ``discrete_barrier_fdm_pricer_cn.py``
(DiscreteBarrierCrankNicolsonLog, :26-537): the date-free engine taking
T / sigma / r / b directly with the auto grid-chooser —

- space: log grid covering spot/strike/barriers / 4x margins,
  dx = sigma sqrt(T) / 12 (>= 300 nodes);
- time: lambda = 0.5 sigma^2 dt/dx^2 ~= 0.4 target, >= N_space steps, and
  >= 10 steps per monitor interval (configure_grid, :59-118);
- KO projection at monitor steps; KI by parity against the closed-form BS
  vanilla (:359-428, 472-537); PDE or closed-form greeks.

The solve itself is the framework's scan (``american._solve_batch``) on
the pricer's ``device``, replayed from a CUDA graph on a card; the closed
forms use the port's Hart/West ``norm_cdf`` on the same device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.special import norm_cdf, norm_pdf
from .american import _barrier, _dynamics, _solve_batch
from .grid import LogGrid, uniform_schedule


@dataclass
class DiscreteBarrierCrankNicolsonLog:
    S0: float
    K: float
    T: float
    sigma: float
    r_disc: float
    b_carry: float
    option_type: str = "call"
    barrier_type: str = "none"
    lower_barrier: Optional[float] = None
    upper_barrier: Optional[float] = None
    rebate: float = 0.0
    rebate_at_hit: bool = False
    monitor_times: Optional[List[float]] = None
    N_space: Optional[int] = None
    N_time: Optional[int] = None
    rannacher_steps: int = 2
    device: Any = DEFAULT_DEVICE

    _S_min: float = field(init=False, default=0.0)
    _S_max: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------

    def configure_grid(self) -> None:
        """Auto space/time sizing (discrete_barrier_fdm_pricer_cn.py:59-118)."""
        if self.T <= 0.0:
            raise ValueError("T must be positive")
        if self.sigma <= 0.0:
            raise ValueError("sigma must be positive")
        if self.S0 <= 0.0:
            raise ValueError("S0 must be positive")

        candidates = [self.S0, self.K]
        if self.lower_barrier is not None and self.lower_barrier > 0:
            candidates.append(self.lower_barrier)
        if self.upper_barrier is not None and self.upper_barrier > 0:
            candidates.append(self.upper_barrier)
        S_min = max(1e-8, min(candidates) / 4.0)
        S_max = max(candidates) * 4.0
        if S_min >= S_max:
            S_min, S_max = self.S0 / 5.0, self.S0 * 5.0
        self._S_min, self._S_max = S_min, S_max

        x_range = math.log(S_max) - math.log(S_min)
        dx_target = self.sigma * math.sqrt(self.T) / 12.0
        if dx_target <= 0.0:
            dx_target = x_range / 300.0
        if self.N_space is None:
            self.N_space = max(int(math.ceil(x_range / dx_target)), 300)

        if self.N_time is None:
            dx = x_range / self.N_space
            lambda_target = 0.4
            n_opt = int(
                math.ceil(0.5 * self.sigma**2 * self.T / (lambda_target * dx * dx))
            )
            valid_mon = [t for t in (self.monitor_times or []) if 0.0 < t < self.T]
            self.N_time = max(n_opt, self.N_space, 10 * (len(valid_mon) + 1))

    # ------------------------------------------------------------------
    # closed-form vanilla (discrete_barrier_fdm_pricer_cn.py:359-428)
    # ------------------------------------------------------------------

    def _vanilla_bs_price_and_greeks(self) -> Dict[str, float]:
        S, K, T, sig = self.S0, self.K, self.T, self.sigma
        r, b = self.r_disc, self.b_carry
        sqrtT = math.sqrt(T)
        d1 = (math.log(S / K) + (b + 0.5 * sig**2) * T) / (sig * sqrtT)
        d2 = d1 - sig * sqrtT
        df_r = math.exp(-r * T)
        growth = math.exp((b - r) * T)
        is_call = self.option_type == "call"
        t = lambda x: torch.tensor(x, dtype=torch.float64, device=self.device)
        N = lambda x: float(norm_cdf(t(x)))
        n = lambda x: float(norm_pdf(t(x)))
        if is_call:
            price = S * growth * N(d1) - K * df_r * N(d2)
            delta = growth * N(d1)
        else:
            price = K * df_r * N(-d2) - S * growth * N(-d1)
            delta = -growth * N(-d1)
        gamma = growth * n(d1) / (S * sig * sqrtT)
        vega = S * growth * n(d1) * sqrtT
        theta_term = -(S * growth * n(d1) * sig) / (2 * sqrtT)
        if is_call:
            theta = (
                theta_term
                - (b - r) * S * growth * N(d1)
                - r * K * df_r * N(d2)
            )
        else:
            theta = (
                theta_term
                + (b - r) * S * growth * N(-d1)
                + r * K * df_r * N(-d2)
            )
        return {
            "price": price, "delta": delta, "gamma": gamma,
            "vega": vega, "theta": theta,
        }

    # ------------------------------------------------------------------
    # PDE solve
    # ------------------------------------------------------------------

    def _solve(
        self, apply_ko: bool, sigma: Optional[float] = None, spot: Optional[float] = None
    ) -> float:
        self.configure_grid()
        sig = sigma if sigma is not None else self.sigma
        s_eval = spot if spot is not None else self.S0
        x_min = math.log(self._S_min)
        dx = (math.log(self._S_max) - x_min) / self.N_space
        monitor = [t for t in (self.monitor_times or []) if 0.0 < t <= self.T]
        sch = uniform_schedule(
            self.T, self.N_time, self.rannacher_steps, monitor if apply_ko else []
        )
        ko_type = self.barrier_type.replace("in", "out")
        has_lower = apply_ko and "down" in ko_type and self.lower_barrier is not None
        has_upper = apply_ko and "up" in ko_type and self.upper_barrier is not None
        if apply_ko and "double" in ko_type:
            has_lower = self.lower_barrier is not None
            has_upper = self.upper_barrier is not None
        barrier = None
        if has_lower or has_upper:
            barrier = _barrier(
                self.device, self.lower_barrier or 0.0, self.upper_barrier or 0.0,
                has_lower, has_upper, self.rebate, self.rebate_at_hit, self.r_disc,
            )
        dyn = _dynamics(
            self.device, self.K, self.option_type == "call", [sig], self.r_disc, self.b_carry
        )
        n_nodes = self.N_space + 1
        v = _solve_batch(
            LogGrid(x_min, dx, n_nodes), dyn, sch, n_nodes, False, american=False,
            barrier=barrier,
        )[0]
        s_grid = np.exp(x_min + dx * np.arange(n_nodes))
        return float(np.interp(s_eval, s_grid, v.cpu().numpy()))

    def _pde_price_and_greeks(self, dv_sigma: float = 1e-4) -> Dict[str, float]:
        """Bump-based PDE greeks (discrete_barrier_fdm_pricer_cn.py:429-470)."""
        base = self._solve(apply_ko=True)
        ds = self.S0 * 1e-4
        up = self._solve(apply_ko=True, spot=self.S0 + ds)
        dn = self._solve(apply_ko=True, spot=self.S0 - ds)
        vega = (
            self._solve(apply_ko=True, sigma=self.sigma + dv_sigma) - base
        ) / dv_sigma
        return {
            "price": base,
            "delta": (up - dn) / (2 * ds),
            "gamma": (up - 2 * base + dn) / ds**2,
            "vega": vega,
        }

    # ------------------------------------------------------------------
    # public API (discrete_barrier_fdm_pricer_cn.py:472-537)
    # ------------------------------------------------------------------

    def price(self) -> float:
        if self.barrier_type == "none":
            return self._solve(apply_ko=False)
        if "in" in self.barrier_type:
            vanilla = self._vanilla_bs_price_and_greeks()["price"]
            return vanilla - self._solve(apply_ko=True)
        return self._solve(apply_ko=True)

    def greeks(self, dv_sigma: float = 1e-4) -> Dict[str, float]:
        if self.barrier_type == "none":
            return self._vanilla_bs_price_and_greeks()
        ko = self._pde_price_and_greeks(dv_sigma)
        if "in" in self.barrier_type:
            van = self._vanilla_bs_price_and_greeks()
            return {
                "price": van["price"] - ko["price"],
                "delta": van["delta"] - ko["delta"],
                "gamma": van["gamma"] - ko["gamma"],
                "vega": van["vega"] - ko["vega"],
            }
        return ko
