"""Batched Black-76 / Black-Scholes implied volatility on tensors.

Counterpart of ``finite_difference_tpu.models.analytic.implied_vol``, line
by line. The reference has no implied-vol solver (its calibrations fit
model parameters to quoted VOLS directly, cs_implied_calibration.py:465);
this is the inverse map for price-quoted chains, elementwise over whole
chains on the inputs' device.

Method: reduce to the normalized Black call  c(x, v) = e^{x/2} N(d+) -
e^{-x/2} N(d-),  d± = x/v ± v/2,  x = ln(F/K), v = sigma sqrt(T), on the
undiscounted OTM option (an ITM quote sheds its intrinsic once; Jaeckel's
"Let's be rational" reduction); 32 bisections in ln v over [1e-5, 16],
then ``n_iter`` Newton steps in ln v, each clipped to ±1. f64 converges to
~1e-14 over the practical domain (|x| <= 6, 0.5% <= sigma sqrt(T) <= 400%).

Returns NaN where no vol can reproduce the price (outside the
no-arbitrage band, or a time value below the input's rounding).

The working dtype is JAX's ``result_type(price, f, k, t, float32)``:
float64 in gives float64 out, float32 in gives float32 out, and a Python
number (float64, as under JAX's x64 mode) never demotes a float64 input.
The loops are plain Python loops of elementwise ops, so the solver
differentiates under ``torch.func`` (``jvp`` of sigma in the price).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...device import resolve_device
from ...ops.special import norm_cdf as N, norm_pdf

_BISECTIONS = 32


def _norm_black_call(x, v):
    """Undiscounted normalized Black call: F=e^{x/2}, K=e^{-x/2} units."""
    v = torch.clamp(v, min=1e-16)
    d1 = x / v + 0.5 * v
    d2 = d1 - v
    return torch.exp(0.5 * x) * N(d1) - torch.exp(-0.5 * x) * N(d2)


def _norm_vega(x, v):
    v = torch.clamp(v, min=1e-16)
    d1 = x / v + 0.5 * v
    return torch.exp(0.5 * x) * norm_pdf(d1)


def _as_tensor(a, device) -> torch.Tensor:
    """A tensor on ``device`` keeping the input's dtype (numpy's too; a
    Python float is float64, an int int64, a bool bool)."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def implied_vol_black76(price, f, k, t, df=1.0, is_call=True, n_iter: int = 8):
    """Implied Black-76 vol from option prices.

    Elementwise over broadcastable inputs: ``price`` (premium, discounted
    by ``df``), forward ``f``, strike ``k``, tenor ``t``, discount factor
    ``df``, ``is_call`` bool. Tensors, numpy arrays or numbers, on the
    device of the first tensor among them (else the default device, the
    card). Returns sigma (NaN outside the arbitrage band); fixed
    ``n_iter`` Newton steps in ln v.
    """
    args = (price, f, k, t, df, is_call)
    dev = next((a.device for a in args if torch.is_tensor(a)), None) or resolve_device()
    price, f, k, t, df, is_call = torch.broadcast_tensors(*(_as_tensor(a, dev) for a in args))
    dtype = functools.reduce(torch.promote_types, (price.dtype, f.dtype, k.dtype, t.dtype),
                             torch.float32)
    price, f, k, t, df = (a.to(dtype) for a in (price, f, k, t, df))
    is_call = is_call.to(torch.bool)

    undisc = price / torch.clamp(df, min=1e-300)
    x = torch.log(torch.clamp(f, min=1e-300) / torch.clamp(k, min=1e-300))
    # normalize to unit-geometric-mean units: divide by sqrt(F K)
    scale = torch.sqrt(f * k)
    c_in = undisc / torch.clamp(scale, min=1e-300)

    # Condition on the OTM option. Put-call symmetry in normalized units:
    # put(x, v) = call(-x, v), so an already-OTM quote maps to the OTM call
    # at xm = -|x| with no arithmetic (full input precision kept); an ITM
    # quote sheds its intrinsic once: call(-|x|, v) = quote - |e^{x/2} - e^{-x/2}|.
    intr_mag = torch.abs(torch.exp(0.5 * x) - torch.exp(-0.5 * x))
    original_itm = torch.where(is_call, x > 0, x < 0)
    xm = -torch.abs(x)
    c_otm = c_in - torch.where(original_itm, intr_mag, torch.zeros_like(intr_mag))
    upper = torch.exp(0.5 * xm)  # OTM call value as v -> inf
    # noise floor: an ITM time value below a few ulps of its intrinsic was
    # already rounded away in the input; report NaN instead of a vol
    eps = torch.finfo(dtype).eps
    floor = torch.where(original_itm, 8.0 * eps * intr_mag, torch.zeros_like(intr_mag))
    valid = (c_otm > floor) & (c_otm < upper) & (t > 0.0)
    c_safe = torch.minimum(torch.clamp(c_otm, min=1e-300), upper * (1.0 - 1e-16))

    x = xm

    # Stage 1: fixed bisection in ln v over [1e-5, 16] (c is monotone
    # increasing in v): 32 halvings shrink the bracket to ~2e-9 relative,
    # unconditionally, where a Newton descent from a bad seed on the convex
    # deep-OTM wing can fail.
    lo = torch.full_like(c_safe, math.log(1e-5))
    hi = torch.full_like(c_safe, math.log(16.0))
    for _ in range(_BISECTIONS):
        mid = 0.5 * (lo + hi)
        below = _norm_black_call(x, torch.exp(mid)) < c_safe
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    lv = 0.5 * (lo + hi)

    # Stage 2: Newton polish in ln v down to full precision;
    # d(c)/d(ln v) = vega * v
    for _ in range(n_iter):
        v = torch.exp(lv)
        diff = _norm_black_call(x, v) - c_safe
        step = diff / torch.clamp(_norm_vega(x, v) * v, min=1e-300)
        lv = lv - torch.clamp(step, -1.0, 1.0)
    v = torch.exp(lv)
    sigma = v / torch.sqrt(torch.clamp(t, min=1e-300))
    return torch.where(valid, sigma, torch.full_like(sigma, math.nan))


def implied_vol_bs(price, s, k, t, r, q=0.0, is_call=True, n_iter: int = 8):
    """Black-Scholes spot-form wrapper: F = S e^{(r-q)T}, df = e^{-rT}."""
    args = (price, s, k, t, r, q, is_call)
    dev = next((a.device for a in args if torch.is_tensor(a)), None) or resolve_device()
    s, t, r, q = (_as_tensor(a, dev) for a in (s, t, r, q))
    f = s * torch.exp((r - q) * t)
    df = torch.exp(-r * t)
    return implied_vol_black76(price, f, k, t, df, is_call, n_iter=n_iter)
