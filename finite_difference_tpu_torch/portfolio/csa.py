"""CSA (credit support annex) terms (the port's copy of
``finite_difference_tpu.portfolio.csa``, host numpy).

Reconstruction of the absent ``portfolio/csa.py`` from
exposure_engine.py:573-648: MPOR lookback, VM thresholds in both
directions, IM methods (NONE / FIXED / SCHEDULE supported; SIMM declared),
close-out method with optional risky-curve substitution (a single name or a
per-currency dict).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Union


class CloseOutMethod(Enum):
    STANDARD = "standard"
    FORWARD = "forward"


# Standardised (schedule/grid) IM percentages of notional, keyed by asset
# class with residual-maturity buckets for rates/credit — the BCBS-317
# "standardised initial margin schedule". The reference declares SCHEDULE
# but raises NotImplementedError (exposure_engine.py:640-644); here it is
# implemented as gross schedule IM (NGR fixed at 1 — conservative).
IM_SCHEDULE_GRID = {
    "interest_rate": ((2.0, 0.01), (5.0, 0.02), (float("inf"), 0.04)),
    "credit": ((2.0, 0.02), (5.0, 0.05), (float("inf"), 0.10)),
    "fx": ((float("inf"), 0.06),),
    "equity": ((float("inf"), 0.15),),
    "commodity": ((float("inf"), 0.15),),
    "other": ((float("inf"), 0.15),),
}


def schedule_im_factor(asset_class: str, residual_years: float) -> float:
    """Schedule IM percentage for one trade."""
    buckets = IM_SCHEDULE_GRID.get(asset_class, IM_SCHEDULE_GRID["other"])
    for ceiling, pct in buckets:
        if residual_years <= ceiling:
            return pct
    return buckets[-1][1]


class InitialMarginMethod(Enum):
    NONE = "none"
    FIXED = "fixed"
    SCHEDULE = "schedule"
    SIMM = "simm"


@dataclass(frozen=True)
class CSA:
    mpor_days: int = 10
    vm_threshold: float = 0.0
    vm_threshold_post: float = 0.0
    im_method: InitialMarginMethod = InitialMarginMethod.NONE
    im_amount: float = 0.0
    close_out_method: CloseOutMethod = CloseOutMethod.STANDARD
    risky_curve_name: Optional[Union[str, Dict[str, str]]] = None
    # SIMM calibration/config (portfolio.simm.SimmConfig); None = defaults.
    # Only read when im_method is SIMM.
    simm_config: Optional[object] = None
