"""Commodity XVA multi-asset runner (the port of
``finite_difference_tpu.runners.xva_main``).

Capability parity with the reference's ``xva_commodity_forward_main.py``
(:202-356): per-asset CS simulation -> commodity-forward CVA, returning the
exposure profile and CVA per asset code, on ``device`` (``cuda`` unless
the caller passes ``"cpu"``); ``plot_path`` saves the EE/PFE plot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..device import DEFAULT_DEVICE
from ..models.mc.clewlow_strickland import CSParams
from ..xva import (
    CommodityForward,
    CommodityXvaEngine,
    CounterpartyConfig,
    DiscountingConfig,
    FixingSchedule,
    ReferencePrice,
    SamplingConvention,
    SimulationConfig,
)


def run_asset(
    asset_code: str,
    *,
    initial_curve: np.ndarray,
    tenor_days: np.ndarray,
    cs_params: CSParams,
    sim_cfg: Optional[SimulationConfig] = None,
    discount_rate: float = 0.05,
    hazard_rate: float = 0.02,
    recovery: float = 0.4,
    strike: Optional[float] = None,
    notional: float = 1.0,
    maturity_day: Optional[int] = None,
    fixing_start: Optional[int] = None,
    fixing_end: Optional[int] = None,
    sampling: SamplingConvention = SamplingConvention.DAILY,
    settlement_lag_days: int = 2,
    realised_fixings: Optional[Dict[int, float]] = None,
    risk_neutral: bool = True,
    rng_backend: str = "sobol",
    plot_path: Optional[str] = None,
    device=DEFAULT_DEVICE,
) -> Dict[str, Any]:
    """CVA pipeline for one commodity asset (xva_commodity_forward_main.py:202)."""
    sim_cfg = sim_cfg or SimulationConfig()
    maturity_day = maturity_day or int(sim_cfg.horizon_days)
    fixing_end = fixing_end if fixing_end is not None else maturity_day - settlement_lag_days
    fixing_start = fixing_start if fixing_start is not None else max(0, fixing_end - 10)
    strike = strike if strike is not None else float(np.interp(
        maturity_day, np.asarray(tenor_days, float), np.asarray(initial_curve, float)
    ))

    engine = CommodityXvaEngine(
        sim_cfg=sim_cfg,
        cs_params=cs_params,
        initial_curve=initial_curve,
        tenor_days=tenor_days,
        discounting=DiscountingConfig(rate=discount_rate),
        counterparty=CounterpartyConfig(hazard_rate=hazard_rate, recovery=recovery),
        rng_backend=rng_backend,
        device=device,
    )
    trade = CommodityForward(
        maturity_day=maturity_day,
        strike=strike,
        notional=notional,
        reference_price=ReferencePrice(
            FixingSchedule(fixing_start, fixing_end, sampling),
            settlement_lag_days=settlement_lag_days,
            realised_fixings=realised_fixings,
        ),
        discounting=DiscountingConfig(rate=discount_rate),
    )
    res = engine.run_forward_cva(trade, risk_neutral=risk_neutral)
    if plot_path:
        from ..utils.plotting import plot_ee_pfe

        plot_ee_pfe(
            res.times_days, res.exposure_profile.ee, res.exposure_profile.pfe,
            save_path=plot_path,
            title=f"Exposure profile — {asset_code} (CVA {res.cva:,.2f})",
        )
    return {
        "asset_code": asset_code,
        "cva": res.cva,
        "exposure_profile": res.exposure_profile,
        "times_days": res.times_days,
        "peak_ee": float(res.exposure_profile.ee.max()),
        "peak_pfe": float(res.exposure_profile.pfe.max()),
        "strike": strike,
        "maturity_day": maturity_day,
    }
