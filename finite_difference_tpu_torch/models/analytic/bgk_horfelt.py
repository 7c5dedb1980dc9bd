"""BGK/Hörfelt discrete-barrier analytic approximations on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.bgk_horfelt``, the
analytic half of the reference's ``DiscreteBarrierBGKPricer``
(discrete_barrier_bgk.py):

- phi-space coordinates phi(x) = ln(x/S_eff)/(sigma sqrt(T)) (:611-616)
- drift thetas theta0/theta1 (:618-629)
- Hörfelt F+/F- blocks with their clamping (:632-646)
- BGK continuity shift beta/sqrt(m) (beta = 0.5826) or the mean-sqrt(dt)
  variant for irregular schedules (:649-670)
- single-barrier OUT closed forms in the Black-76 forward layout (:929-966)
- double-barrier OUT via image series with Siegmund widening (:970-1016)
- survival probabilities S(T_k) and the per-monitor hazard decomposition
  used for the rebate-at-hit PV leg (:1021-1130)

All functions are elementwise; ``m`` and series lengths are ints.
"""
from __future__ import annotations

import torch

from ...device import as_tensors
from ...ops.special import norm_cdf as N

BETA_BGK = 0.5826
_EPS = 1e-12


def phi_coord(x, s_eff, sigma, t):
    x, s_eff, sigma, t = as_tensors(x, s_eff, sigma, t)
    return torch.log(torch.clamp(x, min=_EPS) / s_eff) / (sigma * torch.sqrt(torch.clamp(t, min=_EPS)))


def thetas(mu, sigma, t):
    """(theta0, theta1): drift coordinates at horizon t (:618-629)."""
    mu, sigma, t = as_tensors(mu, sigma, t)
    sqrt_t = torch.sqrt(torch.clamp(t, min=_EPS))
    theta0 = (mu - 0.5 * sigma * sigma) * sqrt_t / sigma
    return theta0, theta0 + sigma * sqrt_t


def f_plus(a, b, theta):
    """Hörfelt up-barrier block, clamped a <= b; 0 when b <= 0 (:632-637)."""
    a, b, theta = as_tensors(a, b, theta)
    a_eff = torch.minimum(a, b)
    val = N(a_eff - theta) - torch.exp(2.0 * b * theta) * N(a_eff - 2.0 * b - theta)
    return torch.where(b <= 0.0, 0.0, val)


def f_minus(a, b, theta):
    """Down-barrier block via symmetry; 0 when b >= 0 (:639-646)."""
    a, b, theta = as_tensors(a, b, theta)
    a_eff = torch.maximum(a, b)
    val = f_plus(-a_eff, -b, -theta)
    return torch.where(b >= 0.0, 0.0, val)


def bgk_shift_mag(m, t=None, mean_sqrt_dt=None):
    """Shift magnitude: beta/sqrt(m), or beta*mean(sqrt(dt))/sqrt(T) (:649-670)."""
    if mean_sqrt_dt is not None:
        mean_sqrt_dt, t = as_tensors(mean_sqrt_dt, t)
        return BETA_BGK * mean_sqrt_dt / torch.sqrt(torch.clamp(t, min=_EPS))
    (m,) = as_tensors(m)
    return BETA_BGK / torch.sqrt(torch.clamp(m, min=1.0))


def single_barrier_out_price(
    s_eff,
    strike,
    barrier,
    forward,
    mu,
    sigma,
    t,
    df,
    m,
    is_call,
    is_up,
    spot=None,
    shift_mag=None,
):
    """Discretely-monitored single-barrier knock-OUT price (:929-966).

    forward = S_eff * e^{carry * T_carry}; df = e^{-r * T_disc}; mu = the
    theta drift (carry - q, or ln(F/S_eff)/T_carry when theta_from_forward).
    ``m`` may be an array (monitors per trade); zero monitors => vanilla
    handled by caller. ``spot`` (un-escrowed) drives the immediate-KO check,
    defaulting to s_eff.
    """
    s_eff, strike, barrier, forward, mu, sigma, t, df, m, is_call, is_up = as_tensors(
        s_eff, strike, barrier, forward, mu, sigma, t, df, m, is_call, is_up
    )
    s_chk = s_eff if spot is None else as_tensors(spot, s_eff)[0]
    theta0, theta1 = thetas(mu, sigma, t)
    c = phi_coord(strike, s_eff, sigma, t)
    mag = bgk_shift_mag(m, t) if shift_mag is None else shift_mag

    d_up = phi_coord(barrier, s_eff, sigma, t)
    b_up = d_up + mag
    call_up = df * (
        forward * (f_plus(d_up, b_up, theta1) - f_plus(c, b_up, theta1))
        - strike * (f_plus(d_up, b_up, theta0) - f_plus(c, b_up, theta0))
    )
    put_up = df * (strike * f_plus(c, b_up, theta0) - forward * f_plus(c, b_up, theta1))

    d_dn = d_up
    b_dn = d_dn - mag
    put_dn = df * (
        strike * (f_minus(d_dn, b_dn, theta0) - f_minus(c, b_dn, theta0))
        - forward * (f_minus(d_dn, b_dn, theta1) - f_minus(c, b_dn, theta1))
    )
    call_dn = df * (forward * f_minus(c, b_dn, theta1) - strike * f_minus(c, b_dn, theta0))

    price = torch.where(
        is_up,
        torch.where(is_call, call_up, put_up),
        torch.where(is_call, call_dn, put_dn),
    )
    # Immediate KO / degenerate strike-beyond-barrier zeros (:934-939, 941, 959)
    dead = torch.where(
        is_up,
        (s_chk >= barrier) | (is_call & (strike >= barrier)),
        (s_chk <= barrier) | (~is_call & (strike <= barrier)),
    )
    return torch.where(dead, 0.0, price)


def g_continuous(a1, a2, b1, b2, theta, series_terms: int = 50):
    """Two-sided corridor probability block via symmetric image series
    (:970-979)."""
    a1, a2, b1, b2, theta = as_tensors(a1, a2, b1, b2, theta)
    total = N(a2 - theta) - N(a1 - theta)
    span = b2 - b1
    for k in range(1, series_terms + 1):
        shift = 2.0 * k * span
        total = total + (N(a2 - theta - shift) - N(a1 - theta - shift))
        total = total - (N(a2 - theta + shift) - N(a1 - theta + shift))
    return total


def double_barrier_out_price(
    s_eff,
    strike,
    lower,
    upper,
    forward,
    mu,
    sigma,
    t,
    df,
    m,
    is_call,
    series_terms: int = 50,
    shift_mag=None,
):
    """Discrete double-barrier KO with Siegmund widening (:981-1016)."""
    s_eff, strike, lower, upper, forward, mu, sigma, t, df, m, is_call = as_tensors(
        s_eff, strike, lower, upper, forward, mu, sigma, t, df, m, is_call
    )
    d1 = phi_coord(lower, s_eff, sigma, t)
    d2 = phi_coord(upper, s_eff, sigma, t)
    c = phi_coord(strike, s_eff, sigma, t)
    theta0, theta1 = thetas(mu, sigma, t)
    mag = bgk_shift_mag(m, t) if shift_mag is None else shift_mag
    b1 = d1 - mag
    b2 = d2 + mag

    a1_call, a2_call = torch.maximum(c, d1), d2
    a1_put, a2_put = d1, torch.minimum(c, d2)

    call = df * (
        forward * g_continuous(a1_call, a2_call, b1, b2, theta1, series_terms)
        - strike * g_continuous(a1_call, a2_call, b1, b2, theta0, series_terms)
    )
    put = df * (
        strike * g_continuous(a1_put, a2_put, b1, b2, theta0, series_terms)
        - forward * g_continuous(a1_put, a2_put, b1, b2, theta1, series_terms)
    )
    price = torch.where(is_call, call, put)
    dead = torch.where(is_call, strike >= upper, strike <= lower)
    return torch.where(dead, 0.0, price)


def survival_prob(s_eff, barrier, mu, sigma, t, m, is_up, shift_mag=None):
    """BGK survival probability S(t) with the first m monitors (:1021-1031)."""
    s_eff, barrier, mu, sigma, t, m, is_up = as_tensors(s_eff, barrier, mu, sigma, t, m, is_up)
    theta0, _ = thetas(mu, sigma, t)
    d = phi_coord(barrier, s_eff, sigma, t)
    mag = bgk_shift_mag(m, t) if shift_mag is None else shift_mag
    b_up = d + mag
    b_dn = d - mag
    return torch.where(is_up, f_plus(b_up, b_up, theta0), f_minus(b_dn, b_dn, theta0))


def hazard_rebate_pv(s_eff, barrier, mu, sigma, cumulative_t, dfs, rebate, is_up):
    """PV of a rebate paid at first barrier hit: sum_k rebate*DF_k*p_k with
    p_k = S(T_{k-1}) - S(T_k) from the survival curve (:1033-1105).

    cumulative_t: (..., m) monitor horizons along the last axis; dfs: (..., m)
    discount factors; the other inputs broadcast against (...,) (the JAX
    package's scalar form is the 1-d case).
    Returns (pv, p_hit_total, survival_to_T, hazards (..., m)).
    """
    s_eff, barrier, mu, sigma, cumulative_t, dfs, rebate, is_up = as_tensors(
        s_eff, barrier, mu, sigma, cumulative_t, dfs, rebate, is_up
    )
    col = lambda x: x[..., None]
    m_idx = torch.arange(1, cumulative_t.shape[-1] + 1, dtype=cumulative_t.dtype,
                         device=cumulative_t.device)
    s_k = survival_prob(col(s_eff), col(barrier), col(mu), col(sigma), cumulative_t, m_idx,
                        col(is_up))
    s_prev = torch.cat([torch.ones_like(s_k[..., :1]), s_k[..., :-1]], dim=-1)
    p_k = torch.clamp(s_prev - s_k, min=0.0)
    pv = torch.sum(col(rebate) * dfs * p_k, dim=-1)
    s_end = s_k[..., -1] if s_k.shape[-1] else torch.ones_like(pv)
    return pv, torch.sum(p_k, dim=-1), s_end, p_k
