"""Reiner–Rubinstein (1991) continuous single-barrier engine on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.reiner_rubinstein``:
the reference's ``BarrierEngine`` (barrier_engine.py:17-193), the full A–F
factor decomposition with phi/eta sign conventions, selectable rebate
timing (IN: expiry|hit, OUT: hit|expiry) and ``barrier_status='crossed'``
conditioning. All inputs broadcast elementwise, so a scenario table prices
in one call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...device import DEFAULT_DEVICE, as_tensors
from ...ops.special import norm_cdf as N


class BarrierFactors(NamedTuple):
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    F: torch.Tensor


def barrier_factors(s, x, h, k, t, r, b, sigma, phi, eta) -> BarrierFactors:
    """The six Reiner–Rubinstein factors (barrier_engine.py:79-135).

    phi: +1 call / -1 put; eta: +1 down / -1 up; k = rebate amount.
    """
    s, x, h, k, t, r, b, sigma, phi, eta = as_tensors(s, x, h, k, t, r, b, sigma, phi, eta)
    sqrt_t = torch.sqrt(t)
    sig_rt = sigma * sqrt_t
    ebmt = torch.exp((b - r) * t)
    ert = torch.exp(-r * t)

    mu = (b - 0.5 * sigma * sigma) / (sigma * sigma)
    lam = torch.sqrt(mu * mu + 2.0 * r / (sigma * sigma))

    x1 = torch.log(s / x) / sig_rt + (1.0 + mu) * sig_rt
    x2 = torch.log(s / h) / sig_rt + (1.0 + mu) * sig_rt
    y1 = torch.log(h * h / (s * x)) / sig_rt + (1.0 + mu) * sig_rt
    y2 = torch.log(h / s) / sig_rt + (1.0 + mu) * sig_rt
    z = torch.log(h / s) / sig_rt + lam * sig_rt

    hs_2mu1 = (h / s) ** (2.0 * (mu + 1.0))
    hs_2mu = (h / s) ** (2.0 * mu)
    hs_mlp = (h / s) ** (mu + lam)
    hs_mlm = (h / s) ** (mu - lam)

    A = phi * s * ebmt * N(phi * x1) - phi * x * ert * N(phi * (x1 - sig_rt))
    B = phi * s * ebmt * N(phi * x2) - phi * x * ert * N(phi * (x2 - sig_rt))
    C = phi * s * ebmt * hs_2mu1 * N(eta * y1) - phi * x * ert * hs_2mu * N(
        eta * (y1 - sig_rt)
    )
    D = phi * s * ebmt * hs_2mu1 * N(eta * y2) - phi * x * ert * hs_2mu * N(
        eta * (y2 - sig_rt)
    )
    E = k * ert * (N(eta * (x2 - sig_rt)) - hs_2mu * N(eta * (y2 - sig_rt)))
    F = k * (hs_mlp * N(eta * z) + hs_mlm * N(eta * (z - 2.0 * lam * sig_rt)))
    return BarrierFactors(A, B, C, D, E, F)


def barrier_price(
    s,
    x,
    h,
    t,
    r,
    b,
    sigma,
    is_call,
    is_up,
    is_in,
    rebate=0.0,
    rebate_timing_in: str = "expiry",
    rebate_timing_out: str = "hit",
    crossed=False,
):
    """Continuous-barrier price with the reference's piecewise A–F table
    (barrier_engine.py:146-186) and crossed-state conditioning (:140-147).

    ``is_call/is_up/is_in/crossed`` are boolean (broadcastable); the rebate
    timing strings are static.
    """
    s, x, h, t, r, b, sigma, is_call, is_up, is_in, k, crossed = as_tensors(
        s, x, h, t, r, b, sigma, is_call, is_up, is_in, rebate, crossed
    )
    s, x, h, t, r, b, sigma = torch.broadcast_tensors(s, x, h, t, r, b, sigma)
    one = torch.ones_like(s)
    phi = torch.where(is_call, one, -one)
    eta = torch.where(is_up, -one, one)
    A, B, C, D, E, F = barrier_factors(s, x, h, k, t, r, b, sigma, phi, eta)

    ert = torch.exp(-r * t)
    rebate_in = E if rebate_timing_in == "expiry" else F
    rebate_out = F if rebate_timing_out == "hit" else (k * ert - E)

    x_gt_h = (x - h) > 1e-14
    zero = torch.zeros_like(A)

    # piecewise base values (call/put x up/down x in/out x strike-side)
    dic = torch.where(x_gt_h, C, A - B + D)
    doc = torch.where(x_gt_h, A - C, B - D)
    uic = torch.where(x_gt_h, A, B - C + D)
    uoc = torch.where(x_gt_h, zero, A - B + C - D)
    dip = torch.where(x_gt_h, B - C + D, A)
    dop = torch.where(x_gt_h, A - B + C - D, zero)
    uip = torch.where(x_gt_h, A - B + D, C)
    uop = torch.where(x_gt_h, B - D, A - C)

    base_in = torch.where(is_call, torch.where(is_up, uic, dic), torch.where(is_up, uip, dip))
    base_out = torch.where(is_call, torch.where(is_up, uoc, doc), torch.where(is_up, uop, dop))

    price = torch.where(is_in, base_in + rebate_in, base_out + rebate_out)

    # crossed conditioning: IN -> vanilla; OUT -> rebate now/at expiry
    crossed_out = k if rebate_timing_out == "hit" else k * ert
    price_crossed = torch.where(is_in, A, crossed_out)
    return torch.where(crossed, price_crossed, price)


class BarrierEngine:
    """Scalar wrapper matching the reference class API (barrier_engine.py:17);
    computes at float64 on ``device``."""

    def __init__(
        self,
        s: float,
        b: float,
        r: float,
        t: float,
        x: float,
        sigma: float,
        h: float,
        optionflag: str,
        directionflag: str,
        in_out_flag: str,
        k: float,
        barrier_status: Optional[str] = None,
        rebate_timing_in: Optional[str] = None,
        rebate_timing_out: Optional[str] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        if sigma <= 0 or t <= 0:
            raise ValueError("sigma and t must be positive.")
        for flag, opts in ((optionflag, "cp"), (directionflag, "ud"), (in_out_flag, "io")):
            if flag.lower() not in opts:
                raise ValueError(f"invalid flag {flag!r}")
        if barrier_status not in (None, "crossed", "not_crossed"):
            raise ValueError("barrier_status must be None, 'crossed', or 'not_crossed'.")

        def _timing(v, default):
            if v is None:
                return default
            v = v.strip().lower()
            if v in ("hit", "pay at hit", "at hit"):
                return "hit"
            if v in ("expiry", "exp", "maturity", "pay at expiry", "at expiry"):
                return "expiry"
            raise ValueError("rebate timing must be 'hit' or 'expiry'")

        is_call = optionflag.lower() == "c"
        is_up = directionflag.lower() == "u"
        is_in = in_out_flag.lower() == "i"
        crossed = barrier_status == "crossed"

        self.phi = 1 if is_call else -1
        self.eta = -1 if is_up else 1
        args = as_tensors(s, x, h, k, t, r, b, sigma, float(self.phi), float(self.eta), device=device)
        fac = barrier_factors(*args)
        self.factors = {n: float(v) for n, v in zip("ABCDEF", fac)}
        s_, x_, h_, k_, t_, r_, b_, sigma_ = args[:8]
        self.price_value = float(
            barrier_price(
                s_, x_, h_, t_, r_, b_, sigma_, is_call, is_up, is_in,
                rebate=k_,
                rebate_timing_in=_timing(rebate_timing_in, "expiry"),
                rebate_timing_out=_timing(rebate_timing_out, "hit"),
                crossed=crossed,
            )
        )
        self.vanilla_value = self.factors["A"]

    def get_factors(self):
        return self.factors

    def price(self) -> float:
        return self.price_value

    def vanilla(self) -> float:
        return self.vanilla_value
