"""FIS-style Taylor risk functions for spot scenarios.

Counterpart of ``finite_difference_tpu.models.pde.risk`` (host code: it
calls a pricer's ``price_log2`` and ``greeks_log2``). Capability parity with the reference's risk-function block
(discrete_barrier_fdm_pricer.py:1742-1830 and the engine copy at
:1142-1240): within the FIS price domain
``priceDomainScaleFactor * relPriceShiftModel * S0`` a shifted price is
approximated by f(S0) + Delta h + 0.5 Gamma h^2 from the base PDE run;
outside it a full revaluation is performed. Works with any pricer exposing
``spot``, ``price_log2()`` and ``greeks_log2()``.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Sequence


def risk_reprice_spot(
    pricer,
    shifted_spot: float,
    *,
    rel_price_shift_model: float = 0.01,
    price_domain_scale_factor: float = 1.1,
    force_full_revaluation: bool = False,
    base_price: Optional[float] = None,
    base_greeks: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Taylor-or-reval shifted price (discrete_barrier_fdm_pricer.py:1142-1240)."""
    S0 = pricer.spot
    if base_price is None:
        base_price = pricer.price_log2()
    if base_greeks is None:
        base_greeks = pricer.greeks_log2()

    price_shift = shifted_spot - S0
    shift_magnitude = abs(price_shift)
    price_domain = price_domain_scale_factor * rel_price_shift_model * S0
    outside_domain = shift_magnitude > price_domain

    if force_full_revaluation or outside_domain:
        shifted_pricer = deepcopy(pricer)
        shifted_pricer.spot = shifted_spot
        return {
            "result": shifted_pricer.price_log2(),
            "used_taylor_approx": False,
            "shift_magnitude": shift_magnitude,
            "price_domain": price_domain,
        }

    delta = base_greeks.get("delta", 0.0)
    gamma = base_greeks.get("gamma", 0.0)
    return {
        "result": base_price + delta * price_shift + 0.5 * gamma * price_shift**2,
        "used_taylor_approx": True,
        "shift_magnitude": shift_magnitude,
        "price_domain": price_domain,
    }


def risk_spot_scenario(
    pricer,
    shifted_spot: float,
    *,
    rel_price_shift_model: float = 0.01,
    price_domain_scale_factor: float = 1.1,
) -> Dict[str, float]:
    """Scenario price/delta/gamma (discrete_barrier_fdm_pricer.py:1742-1783)."""
    S0 = pricer.spot
    base_price = pricer.price_log2()
    base_greeks = pricer.greeks_log2()
    out = risk_reprice_spot(
        pricer,
        shifted_spot,
        rel_price_shift_model=rel_price_shift_model,
        price_domain_scale_factor=price_domain_scale_factor,
        base_price=base_price,
        base_greeks=base_greeks,
    )
    h = shifted_spot - S0
    if out["used_taylor_approx"]:
        return {
            "price": out["result"],
            "delta": base_greeks["delta"] + base_greeks["gamma"] * h,
            "gamma": base_greeks["gamma"],
        }
    clone = deepcopy(pricer)
    clone.spot = shifted_spot
    g = clone.greeks_log2()
    return {"price": clone.price_log2(), "delta": g["delta"], "gamma": g["gamma"]}


def front_arena_style_spot_curve(
    base_pricer,
    spot_grid: Sequence[float],
    *,
    rel_price_shift_model: float = 0.01,
    price_domain_scale_factor: float = 1.1,
) -> Dict[str, Any]:
    """Smooth FA-style spot-risk curve (discrete_barrier_fdm_pricer.py:1788-1830)."""
    base_price = base_pricer.price_log2()
    base_greeks = base_pricer.greeks_log2()

    prices, deltas, gammas, used = [], [], [], []
    for s in spot_grid:
        out = risk_reprice_spot(
            base_pricer,
            float(s),
            rel_price_shift_model=rel_price_shift_model,
            price_domain_scale_factor=price_domain_scale_factor,
            base_price=base_price,
            base_greeks=base_greeks,
        )
        h = float(s) - base_pricer.spot
        if out["used_taylor_approx"]:
            prices.append(out["result"])
            deltas.append(base_greeks["delta"] + base_greeks["gamma"] * h)
            gammas.append(base_greeks["gamma"])
        else:
            clone = deepcopy(base_pricer)
            clone.spot = float(s)
            g = clone.greeks_log2()
            prices.append(clone.price_log2())
            deltas.append(g["delta"])
            gammas.append(g["gamma"])
        used.append(out["used_taylor_approx"])
    return {
        "spots": list(map(float, spot_grid)),
        "price": prices,
        "delta": deltas,
        "gamma": gammas,
        "used_taylor": used,
    }
