"""Double-barrier (knock-out/in) closed forms on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.double_barrier``:
the Ikeda–Kunitomo (1992) flat-barrier image series (Haug, ch. 4.17.3 with
curvature d1 = d2 = 0), the same m-term family as the reference's Douady
``DoubleBarrier`` (double _barrier.py:5-135), whose put branch has a
transcription bug (its reflection bound ``alpha`` is the literal ``1``
instead of the log-barrier ``l``).

KI prices follow by parity: KI = vanilla - KO (double _barrier.py:88,128).
"""
from __future__ import annotations

import torch

from ...device import DEFAULT_DEVICE, as_tensors
from ...ops.special import norm_cdf as N
from .black_scholes import generalized_bs_price


def double_barrier_ko_price(s, x, l, u, t, r, b, sigma, is_call, m: int = 5):
    """Double knock-out price, flat barriers L < S < U, m image terms.

    Elementwise over inputs; ``is_call`` boolean. Degenerate strikes
    (call with X >= U, put with X <= L) return 0.
    """
    s, x, l, u, t, r, b, sigma, is_call = as_tensors(s, x, l, u, t, r, b, sigma, is_call)
    s, x, l, u, t, r, b, sigma = torch.broadcast_tensors(s, x, l, u, t, r, b, sigma)
    sqrt_t = torch.sqrt(t)
    sig_rt = sigma * sqrt_t
    sig2 = sigma * sigma
    drift = (b + 0.5 * sig2) * t
    ebrt = torch.exp((b - r) * t)
    ert = torch.exp(-r * t)

    mu1 = 2.0 * b / sig2 + 1.0  # flat barriers: mu2 = 0, mu3 = mu1

    # the image series runs along a leading term axis n
    n = torch.arange(-m, m + 1, dtype=s.dtype, device=s.device).reshape((-1,) + (1,) * s.ndim)
    ln_ul = torch.log(u / l)
    ln_l = torch.log(l)
    ln_u = torch.log(u)

    # log-space powers: (u/l)^n, l^(n+1)/(u^n s), l^(2n+2)/(u^(2n) ...)
    ln_un_ln = n * ln_ul
    fac1 = torch.exp(mu1 * ln_un_ln)
    fac1k = torch.exp((mu1 - 2.0) * ln_un_ln)
    ln_ratio3 = (n + 1.0) * ln_l - n * ln_u - torch.log(s)
    fac3 = torch.exp(mu1 * ln_ratio3)
    fac3k = torch.exp((mu1 - 2.0) * ln_ratio3)

    ln_s_ratio = torch.log(s) + 2.0 * n * ln_ul
    ln_img = (2.0 * n + 2.0) * ln_l - 2.0 * n * ln_u - torch.log(s)

    # call bounds: strike X up to upper barrier U
    d1 = (ln_s_ratio - torch.log(x) + drift) / sig_rt
    d2 = (ln_s_ratio - ln_u + drift) / sig_rt
    d3 = (ln_img - torch.log(x) + drift) / sig_rt
    d4 = (ln_img - ln_u + drift) / sig_rt
    # put bounds: lower barrier L up to strike X
    y1 = (ln_s_ratio - ln_l + drift) / sig_rt
    y2 = d1  # strike bound
    y3 = (ln_img - ln_l + drift) / sig_rt
    y4 = d3

    call_s_sum = torch.sum(fac1 * (N(d1) - N(d2)) - fac3 * (N(d3) - N(d4)), dim=0)
    call_k_sum = torch.sum(
        fac1k * (N(d1 - sig_rt) - N(d2 - sig_rt))
        - fac3k * (N(d3 - sig_rt) - N(d4 - sig_rt)),
        dim=0,
    )
    put_s_sum = torch.sum(fac1 * (N(y1) - N(y2)) - fac3 * (N(y3) - N(y4)), dim=0)
    put_k_sum = torch.sum(
        fac1k * (N(y1 - sig_rt) - N(y2 - sig_rt))
        - fac3k * (N(y3 - sig_rt) - N(y4 - sig_rt)),
        dim=0,
    )

    call_ko = s * ebrt * call_s_sum - x * ert * call_k_sum
    put_ko = x * ert * put_k_sum - s * ebrt * put_s_sum

    call_ko = torch.where(x >= u, 0.0, call_ko)
    put_ko = torch.where(x <= l, 0.0, put_ko)
    price = torch.where(is_call, call_ko, put_ko)
    # knocked already if spot outside the corridor
    return torch.where((s <= l) | (s >= u), 0.0, torch.clamp(price, min=0.0))


def double_barrier_price(s, x, l, u, t, r, b, sigma, is_call, is_in, m: int = 5):
    """KO directly; KI via parity KI = vanilla - KO."""
    s, x, l, u, t, r, b, sigma, is_call, is_in = as_tensors(s, x, l, u, t, r, b, sigma, is_call, is_in)
    ko = double_barrier_ko_price(s, x, l, u, t, r, b, sigma, is_call, m=m)
    vanilla = generalized_bs_price(s, x, sigma, t, r, b, is_call)
    return torch.where(is_in, vanilla - ko, ko)


class DoubleBarrier:
    """Scalar wrapper matching the reference class API (double _barrier.py:5);
    computes at float64 on ``device``."""

    def __init__(self, S, X, L, U, sigma, callflag: str, inflag: str, m: int = 4,
                 device=DEFAULT_DEVICE):
        self.S, self.X, self.L, self.U = map(float, (S, X, L, U))
        self.sigma = float(sigma)
        self.callflag = callflag.lower()
        self.inflag = inflag.lower()
        self.m = int(m)
        self.device = device

    def price(self, b: float, r: float, T: float) -> float:
        is_in = self.inflag in ("in", "i")
        args = as_tensors(self.S, self.X, self.L, self.U, T, r, b, self.sigma, device=self.device)
        return float(double_barrier_price(*args, self.callflag == "c", is_in, m=max(self.m, 4)))
