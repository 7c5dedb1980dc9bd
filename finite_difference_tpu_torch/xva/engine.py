"""Commodity XVA engine (the port of ``finite_difference_tpu.xva.engine``).

Capability parity with the reference's ``engine.py:29-121``
(CommodityXvaEngine.run_forward_cva): normals -> Clewlow-Strickland curve
simulation -> forward MTM per scenario date -> EE/PFE profile -> CVA, on
``device`` (``cuda`` unless the caller passes ``"cpu"``):

- the per-date MTM python loop (engine.py:101-110) is one pass over all
  (dates, paths) via ``CommodityForward.mtm_all``;
- three draws, as in the JAX package: ``"threefry"`` (counter-based, on
  the device, the JAX package's ``jax.random.normal`` stream for the
  same seed up to erfinv's rounding), ``"sobol"`` (the reference's
  scrambled-Sobol stream, generated on the host, for RiskFlow parity)
  and ``"sobol_device"`` (unscrambled Sobol on the device, one dimension
  per time step).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mc.clewlow_strickland import CSForwardCurveSimulator, CSParams
from ..models.mc.rng import SobolNormalRng, prng_key, sobol_normals, threefry_normals
from .commodity_forward import CommodityForward
from .config import CounterpartyConfig, DiscountingConfig, SimulationConfig
from .cva import ExposureProfile, XvaCalculator
from .time_grid import TimeGrid


@dataclass(frozen=True)
class RunResult:
    times_days: np.ndarray
    mtm_paths: torch.Tensor
    exposure_profile: ExposureProfile
    cva: float


class CommodityXvaEngine:
    def __init__(
        self,
        sim_cfg: SimulationConfig,
        cs_params: CSParams,
        initial_curve: np.ndarray,
        tenor_days: np.ndarray,
        discounting: DiscountingConfig,
        counterparty: CounterpartyConfig,
        rng_backend: str = "sobol",
        pfe_quantile: float = 0.95,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.sim_cfg = sim_cfg
        self.cs_params = cs_params
        self.initial_curve = np.asarray(initial_curve, dtype=float)
        self.tenor_days = np.asarray(tenor_days, dtype=float)
        self.discounting = discounting
        self.counterparty = counterparty
        self.rng_backend = rng_backend
        self.device = resolve_device(device)

        self.time_grid = TimeGrid.regular(
            dt_days=sim_cfg.dt_days, horizon_days=sim_cfg.horizon_days
        )
        self.simulator = CSForwardCurveSimulator(
            params=cs_params, days_in_year=sim_cfg.days_in_year, device=self.device
        )
        self.xva = XvaCalculator(
            counterparty=counterparty,
            days_in_year=sim_cfg.days_in_year,
            pfe_quantile=pfe_quantile,
            discount_to_zero=True,
            flat_discount_rate=discounting.rate,
        )

    def _draw_normals(self, n_steps: int, n_sims: int) -> torch.Tensor:
        """(n_steps, n_sims) float64 normals on the engine's device."""
        if self.rng_backend == "sobol_device":
            # proper QMC layout: one Sobol dimension per time step, one
            # point per simulation (the reference's torch path instead draws
            # d=1 and reshapes, which destroys the low-discrepancy structure
            # along paths — kept only in the parity backend "sobol");
            # +1 skips the all-zeros origin point (an ~-8 sigma path)
            z = sobol_normals(
                n_sims, n_steps, fast_forward=self.sim_cfg.fast_forward + 1,
                device=self.device,
            )
            return z.T  # (n_steps, n_sims)
        if self.rng_backend == "sobol":
            rng = SobolNormalRng(
                seed=self.sim_cfg.seed, fast_forward=self.sim_cfg.fast_forward,
                device=str(self.device),
            )
            z = rng.draw_normals(1, n_steps * n_sims).reshape(1, n_steps, n_sims)[0]
            return torch.as_tensor(z, device=self.device)
        return threefry_normals(
            prng_key(self.sim_cfg.seed), (n_steps, n_sims), dtype=torch.float64,
            device=self.device,
        )

    def run_forward_cva(
        self, trade: CommodityForward, risk_neutral: bool = True
    ) -> RunResult:
        times_days = self.time_grid.scen_days
        n_steps = int(times_days.size)
        n_sims = int(self.sim_cfg.num_sims)

        z = self._draw_normals(n_steps, n_sims)
        curves = self.simulator.simulate(
            initial_curve=self.initial_curve,
            tenor_days=self.tenor_days,
            scen_days=times_days,
            z=z,
            risk_neutral=bool(risk_neutral),
        )  # (n_steps, n_tenors, n_sims)

        mtm_paths = trade.mtm_all(
            times_days, curves, self.tenor_days, self.sim_cfg.days_in_year
        )

        profile = self.xva.build_exposure_profile(times_days, mtm_paths)
        cva = self.xva.cva_from_ee(times_days, profile.ee)
        return RunResult(
            times_days=times_days,
            mtm_paths=mtm_paths,
            exposure_profile=profile,
            cva=float(cva),
        )
