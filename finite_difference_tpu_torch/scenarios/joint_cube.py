"""Joint multi-factor scenario cubes: correlated rates + FX/equity drivers
(the port of ``finite_difference_tpu.scenarios.joint_cube``).

The reference simulates factors one at a time (cs_simulation.py's
single- and multi-factor CS drivers, gbm_asset_price_diagnostic.py's GBM)
and never joins an interest-rate factor with an FX factor in one cube.
This module composes them the RiskFlow way — ONE block of correlated
driver normals via the healed Cholesky (`build_cholesky`,
cs_simulation.py:686-722 semantics) feeding each factor's exact
per-interval evolution — and emits a
:class:`~finite_difference_tpu_torch.market_data.scenario_cube.ScenarioCube`
ready for the exposure engine, or the device tensors of the device
exposure engine: curve factors for HW1F rates, scalar factors for GBM
FX/equity.

All drivers evolve on the same day grid; the t=0 slice (today's curve /
spot) is prepended so engine loops can start at the valuation date. The
normals are the JAX package's threefry draws (``prng_key(seed)``), so a
seed gives the same cube in both packages up to erfinv's rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import date, timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mc.gbm import GBMParams, gbm_simulate_paths
from ..models.mc.hw1f import HW1FCurveSimulator
from ..models.mc.rng import prng_key, threefry_normals
from .simulation import build_cholesky

DAYS_IN_YEAR = 365.25


@dataclass(frozen=True)
class HW1FCurveFactor:
    """A simulated zero-curve factor driven by one HW1F brownian."""

    simulator: HW1FCurveSimulator
    tenors: np.ndarray


@dataclass(frozen=True)
class GBMScalarFactor:
    """A simulated scalar (FX rate / equity spot) factor."""

    params: GBMParams
    s0: float


FactorSpec = Union[HW1FCurveFactor, GBMScalarFactor]


def simulate_joint_cube(
    base_date: date,
    scen_days: Sequence[int],
    factors: Dict[str, FactorSpec],
    n_paths: int,
    correlations: Optional[Dict[Tuple[str, str], float]] = None,
    seed: int = 42,
    antithetic: bool = True,
    days_in_year: float = DAYS_IN_YEAR,
    as_jax: bool = False,
    device=DEFAULT_DEVICE,
):
    """Simulate every factor off one correlated normal block on ``device``.

    Parameters
    ----------
    scen_days : strictly positive ascending day offsets (t=0 is prepended).
    factors : name -> :class:`HW1FCurveFactor` | :class:`GBMScalarFactor`.
        An HW1F factor's simulator must sit on ``device``.
    correlations : pairwise driver correlations keyed by factor-name pairs
        (either order); missing pairs are 0. The matrix is eigenvalue-healed
        exactly like the RiskFlow replica.
    as_jax : (the JAX package's name) keep every factor on ``device`` and
        return ``(dates, curves, scalars, tenors_by_name)``, tensors ready
        for :class:`~finite_difference_tpu_torch.xva.device_exposure.DeviceExposureEngine`,
        instead of a host ScenarioCube.
    """
    from ..market_data.scenario_cube import ScenarioCube

    dev = resolve_device(device)
    names = list(factors.keys())
    n_factors = len(names)
    scen_days = np.asarray(sorted(scen_days), dtype=np.int64)
    if scen_days.size == 0 or scen_days[0] <= 0:
        raise ValueError("scen_days must be strictly positive (t=0 is implicit).")
    for name, spec in factors.items():
        if isinstance(spec, HW1FCurveFactor) and spec.simulator.device != dev:
            raise ValueError(
                f"factor {name!r}: its simulator is on {spec.simulator.device}, the cube on {dev}"
            )
    n_times = scen_days.size
    t_grid = scen_days / float(days_in_year)

    chol = build_cholesky(correlations or {}, names)  # (n_factors, n_factors)

    key = prng_key(seed)
    if antithetic:
        half = (n_paths + 1) // 2
        z_half = threefry_normals(key, (n_times, n_factors, half), device=dev)
        z = torch.cat([z_half, -z_half], dim=2)[:, :, :n_paths]
    else:
        z = threefry_normals(key, (n_times, n_factors, n_paths), device=dev)
    # correlate across the factor axis: z_corr[t, f, p] = sum_g L[f,g] z[t,g,p]
    z_corr = torch.einsum("fg,tgp->tfp", torch.as_tensor(chol, device=dev), z)

    cube_factors: Dict[str, tuple] = {}
    dev_curves: Dict[str, torch.Tensor] = {}
    dev_scalars: Dict[str, torch.Tensor] = {}
    tenors_by_name: Dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        spec = factors[name]
        z_i = z_corr[:, i, :]
        if isinstance(spec, HW1FCurveFactor):
            tau = np.asarray(spec.tenors, dtype=np.float64)
            rates = spec.simulator.simulate(
                t_grid, tau, n_paths, normals=z_i, as_jax=as_jax
            )
            # t=0 slice convention lives in ONE place (hw1f
            # values_with_today, shared with to_scenario_cube)
            values = spec.simulator.values_with_today(
                rates, tau, n_paths, as_jax=as_jax
            )
            if as_jax:
                dev_curves[name] = values
                tenors_by_name[name] = tau
            else:
                cube_factors[name] = ("curve", values, tau)
        elif isinstance(spec, GBMScalarFactor):
            # gbm_simulate_paths expects dt[0]=0 on its own grid; prepend 0
            days0 = np.concatenate([[0], scen_days])
            z0 = torch.cat([torch.zeros((1, n_paths), dtype=z_i.dtype, device=dev), z_i])
            paths = gbm_simulate_paths(
                spec.s0, days0, z0, spec.params.mu, spec.params.sigma,
                days_in_year,
            )
            if as_jax:
                dev_scalars[name] = paths
            else:
                cube_factors[name] = ("scalar", paths.cpu().numpy())
        else:
            raise TypeError(f"Unknown factor spec for {name!r}: {type(spec)}")

    dates = [base_date] + [base_date + timedelta(days=int(d)) for d in scen_days]
    if as_jax:
        return dates, dev_curves, dev_scalars, tenors_by_name
    return ScenarioCube(dates, cube_factors)
