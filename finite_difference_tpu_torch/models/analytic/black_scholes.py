"""Black–Scholes / Black-76 closed forms and analytic Greeks on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.black_scholes``.
Every function is elementwise over its inputs (tensors, numbers or numpy
arrays, on the device of the tensors among them; see
:func:`finite_difference_tpu_torch.device.as_tensors`) and differentiable
under ``torch.func``.

Conventions follow the reference's vanilla legs:
- ``generalized_bs_price``: spot form with cost-of-carry b and discount r
  (discrete_barrier_fdm_pricer_cn.py:359 `_vanilla_bs_price_and_greeks`).
- ``black76_price``: forward form, discounted at r over `t_disc`
  (discrete_barrier_fdm_pricer.py:648 `_vanilla_black76_price`, which allows
  distinct expiry/carry/discount tenors — the FIS three-time-measure layout).
"""
from __future__ import annotations

import torch

from ...device import as_tensors
from ...ops.special import norm_cdf, norm_pdf


def _d1_d2(f_over_k_log, sigma, t):
    sig_sqrt = sigma * torch.sqrt(t)
    d1 = (f_over_k_log + 0.5 * sigma * sigma * t) / sig_sqrt
    return d1, d1 - sig_sqrt


def black76_price(forward, strike, sigma, t_expiry, df, is_call):
    """Black-76 on a forward with an explicit discount factor ``df``.

    ``is_call``: boolean (array); True = call.
    Degenerate inputs (t<=0 or sigma<=0) return discounted intrinsic.
    """
    forward, strike, sigma, t_expiry, df, is_call = as_tensors(
        forward, strike, sigma, t_expiry, df, is_call
    )
    t = torch.clamp(t_expiry, min=1e-300)
    sig = torch.clamp(sigma, min=1e-300)
    d1, d2 = _d1_d2(torch.log(forward / strike), sig, t)
    call = df * (forward * norm_cdf(d1) - strike * norm_cdf(d2))
    put = df * (strike * norm_cdf(-d2) - forward * norm_cdf(-d1))
    live = (t_expiry > 0.0) & (sigma > 0.0)
    intrinsic_c = df * torch.clamp(forward - strike, min=0.0)
    intrinsic_p = df * torch.clamp(strike - forward, min=0.0)
    price_c = torch.where(live, call, intrinsic_c)
    price_p = torch.where(live, put, intrinsic_p)
    return torch.where(is_call, price_c, price_p)


def generalized_bs_price(spot, strike, sigma, t, r, b, is_call):
    """Generalized Black–Scholes with cost-of-carry b, discount r, tenor t.

    b = r: standard BS; b = r - q: continuous dividend yield q;
    b = 0: Black-76 on futures.
    """
    spot, strike, sigma, t, r, b, is_call = as_tensors(spot, strike, sigma, t, r, b, is_call)
    forward = spot * torch.exp(b * t)
    df = torch.exp(-r * t)
    return black76_price(forward, strike, sigma, t, df, is_call)


def bs_price(spot, strike, sigma, t, r, q, is_call):
    """Standard Black–Scholes with continuous dividend yield q."""
    spot, strike, sigma, t, r, q, is_call = as_tensors(spot, strike, sigma, t, r, q, is_call)
    return generalized_bs_price(spot, strike, sigma, t, r, r - q, is_call)


def generalized_bs_greeks(spot, strike, sigma, t, r, b, is_call):
    """Analytic Greeks for the generalized BS form.

    Returns dict(price, delta, gamma, vega, theta, rho). Vega is per unit
    vol (multiply by 0.01 for per-vol-point, the reference's convention).
    """
    spot, strike, sigma, t, r, b, is_call = as_tensors(spot, strike, sigma, t, r, b, is_call)
    t_ = torch.clamp(t, min=1e-300)
    sig = torch.clamp(sigma, min=1e-300)
    sqrt_t = torch.sqrt(t_)
    d1, d2 = _d1_d2(torch.log(spot / strike) + b * t_, sig, t_)
    df_r = torch.exp(-r * t_)
    df_bq = torch.exp((b - r) * t_)  # carry-adjusted "dividend" discount

    nd1, nd2 = norm_cdf(d1), norm_cdf(d2)
    pdf1 = norm_pdf(d1)

    price_c = spot * df_bq * nd1 - strike * df_r * nd2
    price_p = strike * df_r * norm_cdf(-d2) - spot * df_bq * norm_cdf(-d1)

    delta_c = df_bq * nd1
    delta_p = df_bq * (nd1 - 1.0)
    gamma = df_bq * pdf1 / (spot * sig * sqrt_t)
    vega = spot * df_bq * pdf1 * sqrt_t
    theta_c = (
        -spot * df_bq * pdf1 * sig / (2.0 * sqrt_t)
        - (b - r) * spot * df_bq * nd1
        - r * strike * df_r * nd2
    )
    theta_p = (
        -spot * df_bq * pdf1 * sig / (2.0 * sqrt_t)
        + (b - r) * spot * df_bq * norm_cdf(-d1)
        + r * strike * df_r * norm_cdf(-d2)
    )
    rho_c = strike * t_ * df_r * nd2
    rho_p = -strike * t_ * df_r * norm_cdf(-d2)

    pick = lambda c, p: torch.where(is_call, c, p)
    return {
        "price": pick(price_c, price_p),
        "delta": pick(delta_c, delta_p),
        "gamma": gamma,
        "vega": vega,
        "theta": pick(theta_c, theta_p),
        "rho": pick(rho_c, rho_p),
    }


def bs_greeks(spot, strike, sigma, t, r, q, is_call):
    spot, strike, sigma, t, r, q, is_call = as_tensors(spot, strike, sigma, t, r, q, is_call)
    return generalized_bs_greeks(spot, strike, sigma, t, r, r - q, is_call)


def black76_greeks(forward, strike, sigma, t, r, is_call):
    """Greeks in the forward (Black-76) framing: delta is dPrice/dForward."""
    forward, strike, sigma, t, r, is_call = as_tensors(forward, strike, sigma, t, r, is_call)
    df = torch.exp(-r * torch.clamp(t, min=1e-300))
    t_ = torch.clamp(t, min=1e-300)
    sig = torch.clamp(sigma, min=1e-300)
    sqrt_t = torch.sqrt(t_)
    d1, d2 = _d1_d2(torch.log(forward / strike), sig, t_)
    pdf1 = norm_pdf(d1)
    price = black76_price(forward, strike, sigma, t, df, is_call)
    delta = torch.where(is_call, df * norm_cdf(d1), -df * norm_cdf(-d1))
    gamma = df * pdf1 / (forward * sig * sqrt_t)
    vega = df * forward * pdf1 * sqrt_t
    return {"price": price, "delta": delta, "gamma": gamma, "vega": vega}
