"""ISDA-SIMM-style delta initial margin (the CSA ``im_method='simm'``; the
port of ``finite_difference_tpu.portfolio.simm``).

The reference declares the SIMM method but raises ``NotImplementedError``
(its ``exposure_engine.py:640-644``). This module implements the SIMM
**delta margin** aggregation so the exposure engines can simulate IM
pathwise:

- per risk class c, bucketed weighted sensitivities ``WS_k = RW_k * s_k``
  aggregate to ``K_c = sqrt(WS^T rho_c WS)``;
- classes combine with the cross-class correlation psi:
  ``IM = sqrt(sum_cd psi_cd K_c K_d)``.

Sensitivity conventions (ISDA SIMM definitions):

- interest_rate: ``s_k`` = netting-set PV change for a +1bp shift of the
  zero rate at SIMM tenor bucket k (PV01 by bucket);
- equity / fx / commodity: ``s_f`` = PV change for a +1%% relative shift
  of the spot/rate factor f.

Everything is vectorized over leading axes, so per-path (and per-date)
sensitivities aggregate to pathwise IM in one contraction. The
aggregation runs on torch tensors, on the device and in the dtype of the
sensitivities it is given (numpy arrays become float64 tensors on the
CPU): the device exposure engine aggregates its bumped sensitivities
where it computed them, and the generic engine uses the same functions on
the CPU. The parameters and the bucket assignment are host numpy.

**Scope and calibration.** Delta margin only (no vega/curvature margin, no
concentration thresholds, single regular-volatility currency bucket, and
sub-curve correlation inside one currency is ignored). The numeric
parameters in :class:`SimmParams` are CONFIGURATION, not law: ISDA
recalibrates them annually, and the intra-IR tenor correlation here is a
parametric fit ``rho_ij = max(rho_floor, exp(-theta |ln(t_i/t_j)|))``
rather than the published 12x12 table. For regulatory use load the current
ISDA parameter set via ``SimmParams(...)``; the defaults reproduce the
published magnitudes (risk weights in SIMM units, ~2.9%% of notional for a
5y IRS) and the correct aggregation structure.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# SIMM IR tenor grid (year fractions): 2w 1m 3m 6m 1y 2y 3y 5y 10y 15y 20y 30y
IR_TENORS: Tuple[float, ...] = (
    14.0 / 365.0, 1.0 / 12.0, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 15.0, 20.0, 30.0,
)
IR_TENOR_LABELS = ("2w", "1m", "3m", "6m", "1y", "2y", "3y", "5y", "10y", "15y", "20y", "30y")

# Regular-volatility-currency IR delta risk weights per tenor (SIMM units:
# margin per unit of 1bp sensitivity).
_DEFAULT_IR_RW = (109.0, 106.0, 91.0, 69.0, 68.0, 68.0, 66.0, 61.0, 59.0, 57.0, 56.0, 56.0)

RiskClass = str
RISK_CLASSES: Tuple[RiskClass, ...] = ("interest_rate", "equity", "fx", "commodity")


def _ir_corr_matrix(theta: float, floor: float) -> np.ndarray:
    t = np.asarray(IR_TENORS)
    ratio = np.abs(np.log(t[:, None] / t[None, :]))
    rho = np.maximum(floor, np.exp(-theta * ratio))
    np.fill_diagonal(rho, 1.0)
    return rho


@dataclass(frozen=True)
class SimmParams:
    """SIMM calibration parameters (annually recalibrated ISDA data)."""

    ir_risk_weights: Tuple[float, ...] = _DEFAULT_IR_RW
    ir_corr_theta: float = 0.15
    ir_corr_floor: float = 0.27
    # scalar-class risk weights: margin per unit of 1% relative sensitivity
    scalar_risk_weights: Mapping[RiskClass, float] = field(
        default_factory=lambda: {"equity": 23.0, "fx": 7.4, "commodity": 18.0}
    )
    # intra-class correlation between different scalar factors of one class
    scalar_intra_corr: Mapping[RiskClass, float] = field(
        default_factory=lambda: {"equity": 0.24, "fx": 0.5, "commodity": 0.4}
    )
    # cross-class correlation psi (symmetric, diag 1), RISK_CLASSES order
    cross_class_corr: Tuple[Tuple[float, ...], ...] = (
        (1.00, 0.29, 0.14, 0.31),
        (0.29, 1.00, 0.25, 0.43),
        (0.14, 0.25, 1.00, 0.30),
        (0.31, 0.43, 0.30, 1.00),
    )
    bump_bp: float = 1.0  # IR shift used to MEASURE s_k, rescaled to 1bp
    bump_rel: float = 0.01  # scalar shift used to measure s_f, rescaled to 1%

    def ir_corr(self) -> np.ndarray:
        return _ir_corr_matrix(self.ir_corr_theta, self.ir_corr_floor)


DEFAULT_SIMM = SimmParams()


def _tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device and dtype, anything else
    becomes float64 (on ``like``'s device and in its dtype when given)."""
    if torch.is_tensor(x):
        return x
    if like is not None:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=like.device).to(like.dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def assign_ir_buckets(tenors: Sequence[float]) -> np.ndarray:
    """Nearest SIMM bucket index (in log-tenor distance) per input tenor."""
    t = np.maximum(np.asarray(tenors, dtype=np.float64), 1e-6)
    grid = np.log(np.asarray(IR_TENORS))
    return np.argmin(np.abs(np.log(t)[:, None] - grid[None, :]), axis=1)


def _quad_margin(x: torch.Tensor, m) -> torch.Tensor:
    """sqrt(max(x^T m x, 0)) over the last axis of ``x``."""
    m = _tensor(m, like=x)
    return torch.sqrt(torch.clamp_min(((x @ m) * x).sum(dim=-1), 0.0))


def ir_delta_margin(ws, params: SimmParams = DEFAULT_SIMM) -> torch.Tensor:
    """K_ir = sqrt(WS^T rho WS); ``ws`` shape (..., 12) weighted sens."""
    return _quad_margin(_tensor(ws), params.ir_corr())


def scalar_delta_margin(ws_list: Sequence, intra_corr: float) -> torch.Tensor:
    """K_c for a scalar class: sqrt(sum_f ws_f^2 + rho sum_{f!=g} ws_f ws_g)."""
    if not ws_list:
        return torch.zeros((), dtype=torch.float64)
    first = next((w for w in ws_list if torch.is_tensor(w)), None)
    ws = torch.stack(torch.broadcast_tensors(*(_tensor(w, like=first) for w in ws_list)), dim=-1)
    tot = ws.sum(dim=-1)
    sq = (ws * ws).sum(dim=-1)
    return torch.sqrt(torch.clamp_min(sq + intra_corr * (tot * tot - sq), 0.0))


def simm_im(
    ir_ws=None,
    scalar_ws: Optional[Dict[RiskClass, Sequence]] = None,
    params: SimmParams = DEFAULT_SIMM,
) -> torch.Tensor:
    """Total SIMM delta margin from weighted sensitivities.

    ``ir_ws``: (..., 12) bucketed IR weighted sensitivities (RW already
    applied); ``scalar_ws``: per class, a list of per-factor weighted
    sensitivities (...,). Returns IM with the broadcast leading shape, a
    tensor on the sensitivities' device.
    """
    k = {c: None for c in RISK_CLASSES}
    if ir_ws is not None:
        k["interest_rate"] = ir_delta_margin(ir_ws, params)
    for cls, ws_list in (scalar_ws or {}).items():
        if cls not in k:
            raise ValueError(f"Unknown SIMM risk class: {cls}")
        if cls == "interest_rate":
            # would silently clobber the curve-bump margin above
            raise ValueError(
                "interest_rate margin comes from ir_ws (bucketed curve "
                "sensitivities), not scalar_ws"
            )
        k[cls] = scalar_delta_margin(ws_list, params.scalar_intra_corr[cls])

    classes = [c for c in RISK_CLASSES if k[c] is not None]
    if not classes:
        return torch.zeros((), dtype=torch.float64)
    first = k[classes[0]]
    ks = torch.stack(
        torch.broadcast_tensors(*(k[c].to(device=first.device, dtype=first.dtype) for c in classes)),
        dim=-1,
    )
    idx = [RISK_CLASSES.index(c) for c in classes]
    sub = np.asarray(params.cross_class_corr)[np.ix_(idx, idx)]
    return _quad_margin(ks, sub)


def weight_ir_sensitivities(bucket_sens, params: SimmParams = DEFAULT_SIMM) -> torch.Tensor:
    """WS_k = RW_k * s_k for (..., 12) per-1bp bucket sensitivities."""
    s = _tensor(bucket_sens)
    return s * _tensor(params.ir_risk_weights, like=s)


# ISO-4217 codes for currency-pair factor-name recognition ("USDZAR")
_ISO_CCYS = frozenset(
    "USD EUR GBP JPY CHF ZAR AUD NZD CAD SEK NOK DKK CNY CNH HKD SGD INR "
    "BRL MXN RUB TRY PLN HUF CZK ILS KRW TWD THB MYR IDR PHP COP CLP PEN "
    "ARS EGP NGN KES GHS SAR AED QAR KWD".split()
)


def infer_scalar_class(factor_name: str) -> RiskClass:
    """Heuristic risk-class for a ScalarSlice factor by name; equity wins
    ties (also the fallback). Override per factor via
    ``SimmConfig.factor_classes`` when names are not self-describing."""
    low = factor_name.lower()
    if "fx" in low or "ccy" in low:
        return "fx"
    # the repo's canonical FX naming is the bare currency pair ("USDZAR",
    # Trade.fx_rate_factor) — recognize XXXYYY of two ISO codes
    up = factor_name.upper()
    if len(up) == 6 and up[:3] in _ISO_CCYS and up[3:] in _ISO_CCYS:
        return "fx"
    if "commod" in low or "oil" in low or "power" in low or "gold" in low:
        return "commodity"
    return "equity"


@dataclass(frozen=True)
class SimmConfig:
    """Engine-facing SIMM configuration attached to a CSA."""

    params: SimmParams = DEFAULT_SIMM
    # explicit factor -> risk class overrides (ScalarSlice factors)
    factor_classes: Mapping[str, RiskClass] = field(default_factory=dict)
    # restrict bumping to these factors (None = every slice in the state)
    factors: Optional[Tuple[str, ...]] = None

    def scalar_class(self, name: str) -> RiskClass:
        cls = self.factor_classes.get(name) or infer_scalar_class(name)
        if cls not in self.params.scalar_risk_weights:
            raise ValueError(
                f"scalar factor {name!r} mapped to risk class {cls!r}, "
                "which has no scalar risk weight (scalar classes: "
                f"{sorted(self.params.scalar_risk_weights)}); "
                "interest-rate sensitivities come from CurveSlice bumps"
            )
        return cls
