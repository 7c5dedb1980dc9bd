"""Bjerksund–Stensland (1993) American option approximation on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.bjerksund_stensland``
(the reference's ``BjerksundStenslandOptionPricer``,
bjerksund_stensland.py:4-313): forward (Black-76) framing where the carry
is backed out of an explicit forward, b = ln(F/S)/T; puts priced via the
call transform S*=K, K*=S, r*=r-b, F*=K*S/F (:232-247); the same numerical
guards (safe b/r when not American, h(tau) with the 2*sigma*sqrt(T) term,
max with European, exercise-region cap at S-K).

Everything is elementwise with ``torch.where`` branches, so whole trade
tables price (and differentiate) in one call.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ...device import DEFAULT_DEVICE, as_tensors
from ...ops.special import norm_cdf as N

_EPS = 1e-16


def _black_call_forward(f, k, vol, df):
    f = torch.clamp(f, min=_EPS)
    k = torch.clamp(k, min=_EPS)
    vol = torch.clamp(vol, min=_EPS)
    d1 = (torch.log(f / k) + 0.5 * vol * vol) / vol
    return df * (f * N(d1) - k * N(d1 - vol))


def _phi(gamma, h, i, s, t, r, b, sig2, vol):
    """phi(gamma; H, I) (bjerksund_stensland.py:126-151)."""
    kappa = 2.0 * b / torch.clamp(sig2, min=_EPS) + 2.0 * gamma - 1.0
    h_, i_, s_ = (torch.clamp(v, min=_EPS) for v in (h, i, s))
    vol_ = torch.clamp(vol, min=_EPS)
    d = (torch.log(h_ / s_) - (b + (gamma - 0.5) * sig2) * t) / vol_
    lam = -r + gamma * b + 0.5 * gamma * (gamma - 1.0) * sig2
    log_is = torch.log(i_ / s_)
    safe_exp = torch.clamp(kappa * log_is, max=25.0)
    return torch.exp(lam * t) * (N(d) - torch.exp(safe_exp) * N(d - 2.0 * log_is / vol_))


def american_call_bs93(s, f, k, t, r, sigma):
    """BS93 American call in the forward frame; carry b = ln(F/S)/T.

    Elementwise; returns price array. Mirrors _american_call_price_core
    (bjerksund_stensland.py:153-231) including its guards.
    """
    s, f, k, t, r, sigma = torch.broadcast_tensors(*as_tensors(s, f, k, t, r, sigma))
    t = torch.clamp(t, min=1e-5)
    vol = sigma * torch.sqrt(t)
    sig2 = sigma * sigma
    s_pos = torch.clamp(s, min=_EPS)
    f = torch.clamp(f, min=_EPS)
    b = torch.log(f / s_pos) / t

    df = torch.exp(-r * t)
    euro = _black_call_forward(f, k, vol, df)

    american = b < (r - 1e-6)
    b_safe = torch.where(american, b, 0.0)
    r_safe = torch.where(american, r, 0.375 * sig2)

    b_over = b_safe / torch.clamp(sig2, min=_EPS)
    sqrt_term = torch.clamp((b_over - 0.5) ** 2 + 2.0 * r_safe / torch.clamp(sig2, min=_EPS), min=1e-6)
    beta = (0.5 - b_over) + torch.sqrt(sqrt_term)

    b0 = k * torch.clamp(r_safe / torch.clamp(r_safe - b_safe, min=_EPS), min=1.0)
    tiny = torch.full_like(beta, 1e-12)
    denom_beta = torch.where(
        torch.abs(beta - 1.0) < 1e-12, torch.where(beta >= 1.0, tiny, -tiny), beta - 1.0
    )
    binf = k * beta / denom_beta
    denom_b = torch.where(torch.abs(binf - b0) < 1e-12, 1e-12, binf - b0)
    h_tau = -(b * t + 2.0 * vol) * (b0 / denom_b)
    bnd_i = b0 + (binf - b0) * (1.0 - torch.exp(h_tau))

    s_phi = torch.minimum(s_pos - 1e-6, bnd_i)

    phi_b_ii = _phi(beta, bnd_i, bnd_i, s_phi, t, r_safe, b_safe, sig2, vol)
    phi_1_ii = _phi(1.0, bnd_i, bnd_i, s_phi, t, r_safe, b_safe, sig2, vol)
    phi_1_ki = _phi(1.0, k, bnd_i, s_phi, t, r_safe, b_safe, sig2, vol)
    phi_0_ki = _phi(0.0, k, bnd_i, s_phi, t, r_safe, b_safe, sig2, vol)
    phi_0_ii = _phi(0.0, bnd_i, bnd_i, s_phi, t, r_safe, b_safe, sig2, vol)

    log_s_i = torch.log(torch.clamp(s_phi, min=_EPS) / torch.clamp(bnd_i, min=_EPS))
    core = (bnd_i - k) * torch.exp(beta * log_s_i) * (1.0 - phi_b_ii)
    c_bs = core + s_phi * (phi_1_ii - phi_1_ki) + k * (phi_0_ki - phi_0_ii)
    c_bs = torch.where(k <= 0.0, b0, c_bs)
    c_bs = torch.maximum(euro, c_bs)

    return torch.where(b >= r, euro, torch.where(s_pos < bnd_i, c_bs, s_pos - k))


def american_put_bs93(s, f, k, t, r, sigma):
    """Put via the duality transform (bjerksund_stensland.py:232-247)."""
    s, f, k, t, r, sigma = torch.broadcast_tensors(*as_tensors(s, f, k, t, r, sigma))
    t_eff = torch.clamp(t, min=1e-5)
    s_pos = torch.clamp(s, min=_EPS)
    f_pos = torch.clamp(f, min=_EPS)
    b = torch.log(f_pos / s_pos) / t_eff
    r_star = r - b
    f_star = k * s_pos / f_pos
    return american_call_bs93(k, f_star, s_pos, t_eff, r_star, sigma)


def american_price_bs93(s, f, k, t, r, sigma, is_call):
    s, f, k, t, r, sigma, is_call = as_tensors(s, f, k, t, r, sigma, is_call)
    return torch.where(
        is_call,
        american_call_bs93(s, f, k, t, r, sigma),
        american_put_bs93(s, f, k, t, r, sigma),
    )


class BjerksundStenslandOptionPricer:
    """Scalar wrapper matching the reference API (bjerksund_stensland.py:4);
    computes at float64 on ``device``.

    Forward resolution priority: explicit forward -> continuous div yield ->
    discrete dividends -> none (:97-115).
    """

    def __init__(
        self,
        spot: float,
        strike: float,
        expiry: float,
        rate: float,
        vol: float,
        forward: Optional[float] = None,
        div_yield: Optional[float] = None,
        dividends: Optional[List[Tuple[float, float]]] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.spot, self.strike, self.expiry = float(spot), float(strike), float(expiry)
        self.rate, self.vol = float(rate), float(vol)
        self.forward = None if forward is None else float(forward)
        self.div_yield = None if div_yield is None else float(div_yield)
        self.dividends = dividends or []
        self.device = device

    def _forward(self) -> float:
        if self.forward is not None:
            return self.forward
        if self.div_yield is not None:
            return self.spot * math.exp((self.rate - self.div_yield) * self.expiry)
        if self.dividends:
            pv = sum(
                d * math.exp(-self.rate * ti)
                for ti, d in self.dividends
                if 0.0 < ti <= self.expiry and d != 0.0
            )
            return (self.spot - pv) * math.exp(self.rate * self.expiry)
        return self.spot * math.exp(self.rate * self.expiry)

    def _price(self, pricer, *args) -> float:
        return float(pricer(*as_tensors(*args, device=self.device)))

    def price_call(self) -> float:
        return self._price(american_call_bs93, self.spot, self._forward(), self.strike,
                           self.expiry, self.rate, self.vol)

    def price_put(self) -> float:
        return self._price(american_put_bs93, self.spot, self._forward(), self.strike,
                           self.expiry, self.rate, self.vol)

    def _greeks(self, pricer, dS=1e-4, dV=1e-4, dT=1 / 365.0) -> Dict[str, float]:
        """Bump greeks in the reference's exact conventions.

        CAUTION — theta SIGN: this reproduces the reference's
        (P(T-dT) - P(T)) / (-dT) = +dP/dT (bjerksund_stensland.py:66-68),
        which is POSITIVE for a long option with time value — the OPPOSITE
        sign of the standard decay theta that ``generalized_bs_greeks``
        (black_scholes.py) and the PDE pricers report (-dP/dT). Kept
        as-is for parity with the reference's exported greeks;
        negate when mixing with the other engines' theta.
        """
        f0 = self._forward()
        px = lambda s=None, t=None, v=None: self._price(
            pricer,
            self.spot if s is None else s,
            f0,
            self.strike,
            self.expiry if t is None else t,
            self.rate,
            self.vol if v is None else v,
        )
        base = px()
        su, sd = self.spot * (1 + dS), self.spot * (1 - dS)
        up, dn = px(s=su), px(s=sd)
        delta = (up - dn) / (su - sd)
        gamma = (up - 2 * base + dn) / ((0.5 * (su - sd)) ** 2)
        vu, vd = self.vol * (1 + dV), self.vol * (1 - dV)
        vega = (px(v=vu) - px(v=vd)) / (2.0 * self.vol * dV)
        tu = max(1e-8, self.expiry - dT)
        theta = (px(t=tu) - base) / (-dT)
        return {"price": base, "delta": delta, "gamma": gamma, "vega": vega, "theta": theta}

    def greeks_call(self, dS: float = 1e-4, dV: float = 1e-4, dT: float = 1 / 365.0):
        return self._greeks(american_call_bs93, dS, dV, dT)

    def greeks_put(self, dS: float = 1e-4, dV: float = 1e-4, dT: float = 1 / 365.0):
        return self._greeks(american_put_bs93, dS, dV, dT)
