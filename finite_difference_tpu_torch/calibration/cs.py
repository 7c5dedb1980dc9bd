"""Clewlow-Strickland calibration: historical (P) and implied (Q), the port
of ``finite_difference_tpu.calibration.cs``.

Capability parity with the reference's ``cs_historical_calibration.py:168-213``
and ``cs_implied_calibration.py`` (bootstrap :264-463, Black :465-505,
cs_variance :507-548, optimizer :550-620).

The implied objective is torch arithmetic at float64 on ``device``, and
scipy's L-BFGS-B consumes its exact gradient from ``torch.autograd``
(the JAX package takes ``jax.value_and_grad`` of the same function). The
historical fit and the JSON bootstrap stay on the host. The comparison is
a list of row dicts where JAX returns a DataFrame; dates are
``datetime.date``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, as_tensors, resolve_device
from ..ops.special import norm_cdf
from .curve_data import curve_array as _curve_array
from .statistics import calc_statistics


def calibrate_historical(
    data_frame, num_business_days: float = 252.0, verbose: bool = False
) -> Dict[str, float]:
    """P-measure CS parameters from a forward-price panel
    (cs_historical_calibration.py:168-213): Sigma = reversion volatility,
    Alpha = mean reversion speed, Drift = log drift + Jensen 0.5*vol^2."""
    stats, correlation, delta = calc_statistics(
        data_frame, method="Log", num_business_days=num_business_days, max_alpha=5.0
    )
    alpha = float(stats["Mean Reversion Speed"][0])
    sigma = float(stats["Reversion Volatility"][0])
    mu = float(stats["Drift"][0] + 0.5 * stats["Volatility"][0] ** 2)
    if verbose:
        print(f"CS historical: Sigma={sigma:.6f} Alpha={alpha:.6f} Drift={mu:.6f}")
    return {"Sigma": sigma, "Alpha": alpha, "Drift": mu}


def black_european_option_price(F, X, r, vol, tenor, buyOrSell, callOrPut, device=None):
    """Black-76 with riskflow's sign conventions
    (cs_implied_calibration.py:465-505), on the inputs' device (or
    ``device``); numbers become float64 tensors."""
    F, X, r, vol, tenor, buyOrSell, callOrPut = as_tensors(
        F, X, r, vol, tenor, buyOrSell, callOrPut, device=device)
    stddev = vol * torch.sqrt(tenor)
    sign = 2.0 * ((F > 0.0) & (X > 0.0)).to(stddev.dtype) - 1.0
    d1 = (torch.log(F / X) + 0.5 * stddev * stddev) / stddev
    d2 = d1 - stddev
    return (
        buyOrSell
        * callOrPut
        * (F * norm_cdf(callOrPut * sign * d1) - X * norm_cdf(callOrPut * sign * d2))
        * torch.exp(-r * tenor)
    )


def cs_variance(sigma, alpha, T, S, device=None):
    """Total log-variance of F(T,S): sigma^2 e^{-2aS} B(2a,T)
    (cs_implied_calibration.py:507-548), on the inputs' device."""
    sigma, alpha, T, S = as_tensors(sigma, alpha, T, S, device=device)
    B = torch.where(
        torch.abs(alpha) > 1e-12, (1.0 - torch.exp(-2.0 * alpha * T)) / (2.0 * alpha), T
    )
    return sigma * sigma * torch.exp(-2.0 * alpha * S) * B


def _implied_objective(x, F, K, r, T, S, premium, units, cp, w):
    sigma, alpha = x[0], x[1]
    total_var = cs_variance(sigma, alpha, T, S)
    total_stddev = torch.sqrt(torch.clamp_min(total_var, 1e-12))
    model = black_european_option_price(
        F, K, 0.0, total_stddev, 1.0, units, cp
    ) * torch.exp(-r * T)
    return torch.sum(w * (premium - model) ** 2)


def _objective_value_and_grad(x: np.ndarray, *arrays):
    """(objective, gradient) at ``x`` for scipy: a float and a numpy pair."""
    xt = torch.tensor(np.asarray(x, dtype=np.float64), device=arrays[0].device, requires_grad=True)
    v = _implied_objective(xt, *arrays)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.cpu().numpy()


def calibrate_implied(
    options: List[dict],
    x0=(0.3, 1.0),
    bounds=((0.001, 2.5), (-1.0, 2.0)),
    device=DEFAULT_DEVICE,
) -> Dict[str, float]:
    """Least-squares (sigma, alpha) from European commodity options
    (cs_implied_calibration.py:550-620), with exact autograd gradients of
    the objective on ``device``."""
    from scipy.optimize import minimize

    dev = resolve_device(device)
    column = lambda vals: torch.tensor(vals, dtype=torch.float64, device=dev)
    arrays = (
        column([o["Forward"] for o in options]),
        column([o["Strike"] for o in options]),
        column([o["r"] for o in options]),
        column([o["T"] for o in options]),
        column([o["S"] for o in options]),
        column([o["Premium"] for o in options]),
        column([o.get("Units", 1.0) for o in options]),
        column([1.0 if o.get("Option_Type", "Call") == "Call" else -1.0 for o in options]),
        column([o.get("Weight", 1.0) for o in options]),
    )
    res = minimize(_objective_value_and_grad, np.asarray(x0, dtype=float), args=arrays, jac=True,
                   bounds=bounds, method="L-BFGS-B")
    return {"Sigma": float(res.x[0]), "Alpha": float(res.x[1])}


def extract_cs_params(
    json_path: str, commodity_names=None, verbose: bool = False
) -> Dict[str, Dict[str, float]]:
    """Stored CSForwardPriceModelParameters from Price Factors
    (cs_implied_calibration_new.py:620-706)."""
    from ..scenarios.market_data import load_market_data

    market_data = load_market_data(json_path)
    price_factors = market_data.get("Price Factors", {})
    prefix = "CSForwardPriceModelParameters."

    if commodity_names is None:
        commodity_names = [k[len(prefix):] for k in price_factors if k.startswith(prefix)]
    elif isinstance(commodity_names, str):
        commodity_names = [commodity_names]

    results: Dict[str, Dict[str, float]] = {}
    for name in commodity_names:
        full_key = name if name.startswith(prefix) else prefix + name
        clean = full_key[len(prefix):]
        factor_data = price_factors.get(full_key)
        if factor_data is None:
            continue
        sigma, alpha = factor_data.get("Sigma"), factor_data.get("Alpha")
        if sigma is None or alpha is None:
            continue
        drift = factor_data.get("Drift", 0.0) or 0.0
        results[clean] = {
            "Sigma": float(sigma), "Alpha": float(alpha), "Drift": float(drift),
        }
        if verbose:
            print(f"{clean}: Sigma={sigma} Alpha={alpha}")
    return results


def compare_cs_params(
    calibrated: Dict[str, Dict[str, float]],
    extracted: Dict[str, Dict[str, float]],
    verbose: bool = False,
) -> List[dict]:
    """Scalar Sigma/Alpha comparison rows (cs_implied_calibration_new.py:706-838):
    keys Commodity, Parameter, Calibrated, Extracted, Abs_Diff, Rel_Diff_Pct."""
    rows = []
    for name, cal in calibrated.items():
        ext = extracted.get(name)
        if ext is None:
            continue
        for param in ("Sigma", "Alpha"):
            c, e = cal.get(param), ext.get(param)
            rows.append(
                {
                    "Commodity": name,
                    "Parameter": param,
                    "Calibrated": c,
                    "Extracted": e,
                    "Abs_Diff": abs(c - e) if c is not None and e is not None else None,
                    "Rel_Diff_Pct": (
                        abs(c - e) / max(abs(e), 1e-12) * 100.0
                        if c is not None and e is not None
                        else None
                    ),
                }
            )
    if verbose and rows:
        for row in rows:
            print("  ".join(f"{k}={v}" for k, v in row.items()))
    return rows


def run_cs_calibration(
    json_path: str,
    output_path: Optional[str] = None,
    commodity_names=None,
    verbose: bool = False,
    device=DEFAULT_DEVICE,
):
    """Bootstrap + extract + compare (+ CSV export) in one call
    (cs_implied_calibration_new.py:974 and export :840)."""
    calibrated = bootstrap_from_json(json_path, None, verbose=verbose, device=device)
    if commodity_names is not None:
        names = [commodity_names] if isinstance(commodity_names, str) else commodity_names
        calibrated = {k: v for k, v in calibrated.items() if k in names}
    extracted = extract_cs_params(json_path, commodity_names, verbose=verbose)
    comparison = compare_cs_params(calibrated, extracted, verbose=verbose)
    if output_path:
        from ..runners._cli import write_rows

        write_rows(comparison, output_path)
    return calibrated, extracted, comparison


def get_day_count_accrual(reference_date, time_in_days, day_count_code="ACT_365"):
    """Year fraction for a day offset (cs_implied_calibration.py:56-92)."""
    if day_count_code in ("ACT_365", "ACT365", "ACT/365"):
        return float(time_in_days) / 365.0
    if day_count_code in ("ACT_360", "ACT360", "ACT/360"):
        return float(time_in_days) / 360.0
    if day_count_code in ("ACT_365_25",):
        return float(time_in_days) / 365.25
    return float(time_in_days) / 365.0


def bootstrap_from_json(
    json_path: str, commodity_name: Optional[str] = None, verbose: bool = False,
    device=DEFAULT_DEVICE,
) -> Dict[str, Dict[str, float]]:
    """Full implied calibration from a RiskFlow JSON
    (cs_implied_calibration.py:264-463): for each
    CSForwardPriceModelPrices entry, resolve T/S year fractions, forwards at
    expiry/settlement, the discount rate, the surface vol (+Volatility_Delta),
    ATM strikes, the Black premium, and run the optimizer on ``device``."""
    from ..scenarios.market_data import load_market_data
    from ..scenarios.time_grid import EXCEL_OFFSET, as_date

    dev = resolve_device(device)
    market_data = load_market_data(json_path)
    price_factors = market_data.get("Price Factors", {})
    market_prices = market_data.get("Market Prices", {})
    sys_params = market_data.get("System Parameters", {})

    base_date = sys_params.get("Base_Date")
    if base_date is None:
        val_config = market_data.get("Valuation Configuration", {})
        if isinstance(val_config, dict):
            base_date = val_config.get("Base_Date", val_config.get("Run_Date"))
    if base_date is None:
        raise ValueError("Cannot find Base_Date in System Parameters or Valuation Configuration")
    base_date = as_date(base_date)
    vol_delta = sys_params.get("Volatility_Delta", 0.0)

    results: Dict[str, Dict[str, float]] = {}
    for market_price_name, implied_params in market_prices.items():
        parts = tuple(market_price_name.split("."))
        if parts[0] != "CSForwardPriceModelPrices":
            continue
        commodity = ".".join(parts[1:])
        if commodity_name is not None and commodity.upper() != commodity_name.upper():
            continue

        instrument = implied_params.get("instrument", implied_params)
        vol_name = instrument["Forward_Volatility"]
        energy_name = instrument["Energy"]
        discount_name = instrument["Discount_Rate"]
        quote_type = instrument.get("Quote_Type", "Implied_Volatility")

        fwd_arr = _curve_array(price_factors[f"ForwardPrice.{energy_name}"]["Curve"])
        disc_factor = price_factors[f"InterestRate.{discount_name}"]
        disc_arr = _curve_array(disc_factor["Curve"])
        day_count_code = disc_factor.get("Day_Count", "ACT_365")
        vol_factor = price_factors[f"ForwardPriceVol.{vol_name}"]
        vol_arr = _curve_array(
            vol_factor.get("Surface", vol_factor.get("Curve"))
        )  # rows (moneyness, expiry[, settle], vol)

        def forward_lookup(excel_day):
            return float(np.interp(excel_day, fwd_arr[:, 0], fwd_arr[:, 1]))

        def discount_lookup(t):
            return float(np.interp(t, disc_arr[:, 0], disc_arr[:, 1]))

        def vol_lookup(t, s, m):
            if vol_arr.shape[1] >= 4:
                # nearest (expiry, settle) node at given moneyness
                d2 = (vol_arr[:, 1] - t) ** 2 + (vol_arr[:, 2] - s) ** 2 + (
                    vol_arr[:, 0] - m
                ) ** 2
                return float(vol_arr[np.argmin(d2), 3])
            cols = vol_arr
            sel = cols[np.isclose(cols[:, 0], m)] if np.isclose(cols[:, 0], m).any() else cols
            return float(np.interp(t, sel[:, 1], sel[:, 2]))

        options_list = instrument.get("Energy_Futures_Options", [])
        for option in options_list:
            expiry_date = as_date(option["Expiry_Date"])
            settlement_date = as_date(option["Settlement_Date"])
            t = get_day_count_accrual(
                base_date, (expiry_date - base_date).days, day_count_code
            )
            d = get_day_count_accrual(
                base_date, (settlement_date - base_date).days, day_count_code
            )
            expiry_excel = (expiry_date - EXCEL_OFFSET).days
            settlement_excel = (settlement_date - EXCEL_OFFSET).days
            forward_at_exp = forward_lookup(expiry_excel)
            forward_at_settle = forward_lookup(settlement_excel)
            r = discount_lookup(t)
            if quote_type != "Implied_Volatility":
                continue
            sigma = option.get("Quoted_Market_Value") or vol_lookup(t, d, 1.0)
            sigma += vol_delta
            strike = option.get("Strike") or forward_at_exp
            cp = 1.0 if option.get("Option_Type", "Call") == "Call" else -1.0
            units = option.get("Units", 1.0)
            option.update(
                Forward=forward_at_settle, Strike=strike, r=r, S=d, T=t, sigma=sigma,
                Units=units,
                Premium=float(
                    black_european_option_price(
                        forward_at_settle, strike, r, sigma, t, units, cp, device=dev
                    )
                ),
            )
            option.setdefault("Weight", 1.0)

        if options_list:
            results[commodity] = calibrate_implied(options_list, device=dev)
            if verbose:
                print(f"{commodity}: {results[commodity]}")

    return results
