"""Bjerksund–Stensland 2002 two-step American approximation on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.bjerksund_stensland_2002``
(the reference's ``bjerk_stens_new.py:17-649``):

- flat-boundary single-step valuation (Eq. 4) and the two-step Proposition 1
  composition with split t = 0.5*(sqrt(5)-1)*T and boundaries X = X_T,
  x = X_{T - t};
- both boundary variants: 'riskflow_1993' (h = -(bT + 2 sigma sqrt(T)) *
  B0/(B1-B0)) and 'paper_2002_modified' (scale K^2/((B1-B0) B0));
- the proxy method 2*two_step - single_step;
- puts via the call-put transform C(K, S, T, r-b, -b, sigma);
- European Black-76 floor throughout.

The bivariate normal CDF is the Gauss–Legendre
``ops.special.bivariate_norm_cdf``, whose quadrature runs along a trailing
axis, so the pricer broadcasts over trade tables.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ...device import DEFAULT_DEVICE, as_tensors
from ...ops.special import bivariate_norm_cdf, norm_cdf as N

_EPS = 1e-15


def _clip(x, lo, hi):
    """``jnp.clip``: the upper bound wins where lo > hi."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _black76_call(f, k, sigma, t, df):
    vol = torch.clamp(sigma * torch.sqrt(t), min=_EPS)
    d1 = (torch.log(torch.clamp(f, min=_EPS) / torch.clamp(k, min=_EPS)) + 0.5 * vol**2) / vol
    return df * (f * N(d1) - k * N(d1 - vol))


def _beta_B0_B1(k, r, b, sigma):
    sig2 = torch.clamp(sigma * sigma, min=1e-16)
    b_over = b / sig2
    rad = torch.clamp((b_over - 0.5) ** 2 + 2.0 * r / sig2, min=1e-12)
    beta = (0.5 - b_over) + torch.sqrt(rad)
    r_b = torch.clamp(r - b, min=1e-12)
    B0 = torch.maximum(k, (r / r_b) * k)
    B1 = (beta / torch.clamp(beta - 1.0, min=1e-12)) * k
    return beta, B0, B1


def boundary_XT(k, r, b, sigma, tau, variant: str = "riskflow_1993"):
    """Early-exercise boundary X_tau (bjerk_stens_new.py:320-356)."""
    k, r, b, sigma, tau = as_tensors(k, r, b, sigma, tau)
    tau = torch.clamp(tau, min=1e-8)
    beta, B0, B1 = _beta_B0_B1(k, r, b, sigma)
    denom = torch.clamp(B1 - B0, min=1e-12)
    if variant == "paper_2002_modified":
        scale = (k * k) / (denom * torch.clamp(B0, min=1e-12))
    else:
        scale = B0 / denom
    h = torch.clamp(-(b * tau + 2.0 * sigma * torch.sqrt(tau)) * scale, -50.0, 50.0)
    return torch.maximum(B0 + (B1 - B0) * (1.0 - torch.exp(h)), k)


def _phi(gamma, h, x, s, t, sigma, r, b):
    """Flat-boundary phi (bjerk_stens_new.py:358-392)."""
    t = torch.clamp(t, min=1e-12)
    sig2 = torch.clamp(sigma * sigma, min=1e-32)
    volT = torch.clamp(sigma * torch.sqrt(t), min=1e-16)
    h_, x_, s_ = (torch.clamp(v, min=1e-32) for v in (h, x, s))
    kappa = 2.0 * b / sig2 + 2.0 * gamma - 1.0
    d = (torch.log(h_ / s_) - (b + (gamma - 0.5) * sig2) * t) / volT
    lam = -r + gamma * b + 0.5 * gamma * (gamma - 1.0) * sig2
    log_xs = torch.log(x_ / s_)
    safe_exp = torch.clamp(kappa * log_xs, max=25.0)
    return torch.exp(lam * t) * (N(d) - torch.exp(safe_exp) * N(d - 2.0 * log_xs / volT))


def _A_eval(gamma, H, X, x, t, T, S, r, b, sigma):
    """Proposition-1 psi function via bivariate normals.

    Mirrors the reference's _A_eval (bjerk_stens_new.py:501-568) in role,
    but uses the standard argument structure (Haug's Psi(S,T|gamma,H,I2,I1,
    t1) with I2 = X the first-period boundary and I1 = x the second-period
    boundary): the reference flips the drift sign in all eight normal
    arguments, which collapses its two-step value to the European floor.
    """
    T = torch.clamp(T, min=1e-12)
    t = _clip(t, 1e-12, T - 1e-12)
    sig2 = torch.clamp(sigma * sigma, min=1e-16)
    vol_t = sigma * torch.sqrt(t)
    vol_T = sigma * torch.sqrt(T)
    S_, H_, I2, I1 = (torch.clamp(v, min=1e-16) for v in (S, H, X, x))
    a = b + (gamma - 0.5) * sig2

    e1 = (torch.log(S_ / I1) + a * t) / vol_t
    e2 = (torch.log((I2 * I2) / (S_ * I1)) + a * t) / vol_t
    e3 = (torch.log(S_ / I1) - a * t) / vol_t
    e4 = (torch.log((I2 * I2) / (S_ * I1)) - a * t) / vol_t

    f1 = (torch.log(S_ / H_) + a * T) / vol_T
    f2 = (torch.log((I2 * I2) / (S_ * H_)) + a * T) / vol_T
    f3 = (torch.log((I1 * I1) / (S_ * H_)) + a * T) / vol_T
    f4 = (torch.log((S_ * I1 * I1) / (H_ * I2 * I2)) + a * T) / vol_T

    lam = -r + gamma * b + 0.5 * gamma * (gamma - 1.0) * sig2
    kappa = 2.0 * b / sig2 + 2.0 * gamma - 1.0
    rho = torch.sqrt(t / T)

    M1 = bivariate_norm_cdf(-e1, -f1, rho)
    M2 = bivariate_norm_cdf(-e2, -f2, rho)
    M3 = bivariate_norm_cdf(-e3, -f3, -rho)
    M4 = bivariate_norm_cdf(-e4, -f4, -rho)

    pow_I2S = torch.exp(torch.clamp(kappa * torch.log(I2 / S_), max=25.0))
    pow_I1S = torch.exp(torch.clamp(kappa * torch.log(I1 / S_), max=25.0))
    pow_I1I2 = torch.exp(torch.clamp(kappa * torch.log(I1 / I2), max=25.0))
    inner = M1 - pow_I2S * M2 - pow_I1S * M3 + pow_I1I2 * M4
    return torch.exp(lam * T) * S_**gamma * inner


def american_call_single_2002(s, k, r, b, sigma, t, variant="riskflow_1993"):
    """Flat-boundary single-step value (bjerk_stens_new.py:395-446)."""
    s, k, r, b, sigma, t = as_tensors(s, k, r, b, sigma, t)
    F = s * torch.exp(b * t)
    df = torch.exp(-r * t)
    euro = _black76_call(F, k, sigma, t, df)
    I = boundary_XT(k, r, b, sigma, t, variant)
    beta, _, _ = _beta_B0_B1(k, r, b, sigma)
    alpha_I = (I - k) * I ** (-beta)
    s_phi = torch.minimum(torch.clamp(s, min=1e-16) - 1e-10, I)
    # with S^gamma factored out of phi, the paper's alpha*phi(beta) term
    # carries S^beta; the reference multiplies by I^beta instead
    # (bjerk_stens_new.py:438), which collapses its value to the European
    # floor for deep-carry calls
    c_flat = (
        alpha_I * s_phi**beta
        - alpha_I * s_phi**beta * _phi(beta, I, I, s_phi, t, sigma, r, b)
        + s_phi * (_phi(1.0, I, I, s_phi, t, sigma, r, b) - _phi(1.0, k, I, s_phi, t, sigma, r, b))
        + k * (_phi(0.0, k, I, s_phi, t, sigma, r, b) - _phi(0.0, I, I, s_phi, t, sigma, r, b))
    )
    c_flat = torch.maximum(euro, c_flat)
    return torch.where(s >= I, torch.clamp(s - k, min=0.0), c_flat), I


def american_call_two_step_2002(s, k, r, b, sigma, t_total, variant="riskflow_1993"):
    """Two-step Proposition-1 value (bjerk_stens_new.py:570-649)."""
    s, k, r, b, sigma, t_total = as_tensors(s, k, r, b, sigma, t_total)
    T = torch.clamp(t_total, min=1e-8)
    F = s * torch.exp(b * T)
    df = torch.exp(-r * T)
    euro = _black76_call(F, k, sigma, T, df)
    beta, _, _ = _beta_B0_B1(k, r, b, sigma)

    t_split = _clip(0.5 * (math.sqrt(5.0) - 1.0) * T, 1e-10, T - 1e-10)
    X = boundary_XT(k, r, b, sigma, T, variant)
    # second-period boundary at tau = t_split (Haug's I1; the reference's
    # T - t_split variant gives a slightly nearer boundary)
    x = boundary_XT(k, r, b, sigma, t_split, variant)
    x = torch.maximum(torch.minimum(x, X - 1e-12), k + 1e-12)

    alpha_X = (X - k) * X ** (-beta)
    alpha_x = (x - k) * x ** (-beta)
    s_phi = torch.minimum(torch.clamp(s, min=1e-16) - 1e-10, X)

    # same S^beta correction as the single-step composition (see above)
    c_two = (
        alpha_X * s_phi**beta
        - alpha_X * s_phi**beta * _phi(beta, X, X, s_phi, t_split, sigma, r, b)
        + s_phi * (
            _phi(1.0, X, X, s_phi, t_split, sigma, r, b)
            - _phi(1.0, x, X, s_phi, t_split, sigma, r, b)
        )
        - k * _phi(0.0, X, X, s_phi, t_split, sigma, r, b)
        + k * _phi(0.0, x, X, s_phi, t_split, sigma, r, b)
        + alpha_x * s_phi**beta * _phi(beta, x, X, s_phi, t_split, sigma, r, b)
        - alpha_x * _A_eval(beta, x, X, x, t_split, T, s_phi, r, b, sigma)
        + _A_eval(1.0, x, X, x, t_split, T, s_phi, r, b, sigma)
        - _A_eval(1.0, k, X, x, t_split, T, s_phi, r, b, sigma)
        - k * _A_eval(0.0, x, X, x, t_split, T, s_phi, r, b, sigma)
        + k * _A_eval(0.0, k, X, x, t_split, T, s_phi, r, b, sigma)
    )
    c_two = torch.maximum(euro, c_two)
    return torch.where(s >= X, torch.clamp(s - k, min=0.0), c_two), X, x, t_split


class BjerksundStensland2002Pricer:
    """Scalar wrapper matching the reference API (bjerk_stens_new.py:17);
    computes at float64 on ``device``."""

    def __init__(self, device=DEFAULT_DEVICE) -> None:
        self.device = device

    def _resolve_forward(self, S, r, T, F=None, q=None, dividends=None):
        if F is not None:
            return float(F)
        if q is not None:
            return S * math.exp((r - q) * T)
        if dividends:
            pv = sum(
                d * math.exp(-r * ti)
                for ti, d in dividends
                if 0.0 < ti <= T and d != 0.0
            )
            return (S - pv) * math.exp(r * T)
        return S * math.exp(r * T)

    def price(
        self, S, K, T, r, sigma, option_type: str = "call",
        F=None, q=None, dividends=None,
        method: str = "single", boundary_variant: str = "riskflow_1993",
    ) -> Dict[str, float]:
        if T <= 0.0:
            intrinsic = max(0.0, (S - K) if option_type == "call" else (K - S))
            return {"price": intrinsic, "early_exercise": 0.0, "I": 0.0,
                    "X": 0.0, "x": 0.0, "t_split": 0.0}

        F_eff = self._resolve_forward(S, r, T, F, q, dividends)
        b = math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / max(T, 1e-12)

        if option_type == "call":
            s_, k_, r_, b_ = S, K, r, b
        else:  # put via transform C(K, S, T, r-b, -b)
            s_, k_, r_, b_ = K, S, r - b, -b
        args = as_tensors(s_, k_, r_, b_, sigma, T, device=self.device)

        out = {"I": 0.0, "X": 0.0, "x": 0.0, "t_split": 0.0}
        if method == "single":
            px, I = american_call_single_2002(*args, boundary_variant)
            out["I"] = float(I)
            price = float(px)
            early = float(s_ >= float(I))
        elif method == "two_step":
            px, X, x, ts = american_call_two_step_2002(*args, boundary_variant)
            out.update(X=float(X), x=float(x), t_split=float(ts))
            price = float(px)
            early = float(s_ >= float(X))
        else:  # proxy = 2*two_step - single (bjerk_stens_new.py docstring)
            p1, I = american_call_single_2002(*args, boundary_variant)
            p2, X, x, ts = american_call_two_step_2002(*args, boundary_variant)
            out.update(I=float(I), X=float(X), x=float(x), t_split=float(ts))
            price = float(2.0 * p2 - p1)
            early = float(s_ >= float(X))

        return {"price": price, "early_exercise": early, **out}

    def greeks(
        self, S, K, T, r, sigma, option_type: str = "call",
        F=None, q=None, dividends=None,
        method: str = "single", boundary_variant: str = "riskflow_1993",
        dS: float = 1e-4, dSigma: float = 1e-4,
    ) -> Dict[str, float]:
        F_eff = self._resolve_forward(S, r, T, F, q, dividends)
        b = math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / max(T, 1e-12)
        px = lambda s, sig: self.price(
            s, K, T, r, sig, option_type, F=s * math.exp(b * T),
            method=method, boundary_variant=boundary_variant,
        )["price"]
        base = px(S, sigma)
        S_up, S_dn = S * (1 + dS), S * (1 - dS)
        up, dn = px(S_up, sigma), px(S_dn, sigma)
        return {
            "price": base,
            "delta": (up - dn) / (S_up - S_dn),
            "gamma": (up - 2 * base + dn) / ((0.5 * (S_up - S_dn)) ** 2),
            "vega": (px(S, sigma * (1 + dSigma)) - px(S, sigma * (1 - dSigma)))
            / (2 * sigma * dSigma),
        }
