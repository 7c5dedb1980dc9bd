"""Longstaff-Schwartz (LSM) American Monte Carlo on the device (counterpart
of ``finite_difference_tpu.models.mc.lsm``).

An independent cross-check of the CN American engine, and the
regression-based continuation-value machinery XVA needs for American
trades: one threefry-keyed GBM simulation (the JAX package's draws for a
seed), then a backward loop over the exercise dates (JAX's reverse
``lax.scan``). Each step regresses the discounted continuation values on a
polynomial basis of the ITM paths: a (d x d) Gram matrix contracted over
the path axis and a ridge-regularised ``torch.linalg.solve``. Masks replace
data-dependent path selection, so every shape is static. Antithetic pairing
halves variance at no extra draw cost.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from .rng import prng_key, threefry_normals


def _basis(s_norm, degree: int):
    """Polynomial-in-moneyness regressors (n_paths, degree+1)."""
    return torch.stack([s_norm**i for i in range(degree + 1)], dim=-1)


def _lsm_kernel(
    key, s0: float, strike: float, sigma: float, t: float, r: float, q: float,
    is_call: bool, n_paths: int, n_steps: int, degree: int, antithetic: bool,
    device=DEFAULT_DEVICE,
):
    """(price, stderr) as 0-d tensors on ``device``.

    float64 throughout: the JAX kernel's dtype is result_type(s0, sigma,
    float32) of float64 scalars, float64 under x64 (the JAX tests' setting).
    """
    dev = resolve_device(device)
    dtype = torch.float64
    dt = t / n_steps
    n_draw = n_paths // 2 if antithetic else n_paths
    z = threefry_normals(key, (n_steps, n_draw), dtype, device=dev)
    if antithetic:
        z = torch.cat([z, -z], dim=1)
    drift = (r - q - 0.5 * sigma * sigma) * dt
    vol = sigma * math.sqrt(dt)
    s0_t = torch.tensor(s0, dtype=dtype, device=dev)
    s = torch.exp(torch.log(s0_t) + torch.cumsum(drift + vol * z, dim=0))  # (n_steps, n_paths): t_1 .. t_n
    del z

    def payoff(sv):
        return torch.clamp_min(sv - strike, 0.0) if is_call else torch.clamp_min(strike - sv, 0.0)

    disc = math.exp(-r * dt)
    eye = torch.eye(degree + 1, dtype=dtype, device=dev)
    cf = payoff(s[-1])
    # interior dates t_{n-1} .. t_1 (maturity handled by cf_T; no exercise
    # at t_0 — the valuation date — matching the CN engine's convention)
    for k in range(n_steps - 2, -1, -1):
        s_t = s[k]
        cf_disc = disc * cf  # continuation cashflow PV'd to t
        ex = payoff(s_t)
        itm = ex > 0.0
        x = _basis(s_t / strike, degree)  # (n_paths, d)
        xw = x * itm.to(dtype)[:, None]
        gram = xw.T @ x  # (d, d), contracted over the paths
        rhs = xw.T @ cf_disc
        # ridge keeps the solve well-posed when few paths are ITM
        beta = torch.linalg.solve(gram + 1e-8 * eye, rhs)
        cont = x @ beta
        cf = torch.where(itm & (ex > cont), ex, cf_disc)
    pv = disc * cf  # discount t_1 -> t_0
    # the holder may also exercise AT the valuation date: floor at payoff(S0)
    price = torch.maximum(torch.mean(pv), payoff(s0_t))
    if antithetic:
        # mirrored paths are (negatively) correlated — the independent
        # samples are the n_paths/2 PAIR MEANS; std with ddof=0, as jnp.std
        n_half = n_paths // 2
        pair_mean = 0.5 * (pv[:n_half] + pv[n_half:])
        stderr = torch.std(pair_mean, correction=0) / math.sqrt(n_half)
    else:
        stderr = torch.std(pv, correction=0) / math.sqrt(n_paths)
    return price, stderr


def price_american_lsm(
    s0, strike, sigma, t, r, q=0.0, is_call: bool = False,
    n_paths: int = 200_000, n_steps: int = 50, degree: int = 3,
    antithetic: bool = True, seed: int = 0, key=None, device=DEFAULT_DEVICE,
) -> Tuple[float, float]:
    """American option price by Longstaff-Schwartz regression MC on ``device``.

    GBM under (r, q) with ``n_steps`` equally spaced exercise dates.
    Returns ``(price, stderr)``. ``key`` is a :func:`.rng.prng_key` (the
    JAX package's takes a jax key); without it, ``prng_key(seed)``. Note the
    usual LSM caveats: the in-sample regression induces a small upward bias
    at low path counts, and the exercise policy is only as rich as the
    polynomial basis (``degree``).
    """
    if key is None:
        key = prng_key(seed)
    price, stderr = _lsm_kernel(
        key, float(s0), float(strike), float(sigma), float(t), float(r), float(q),
        bool(is_call), int(n_paths), int(n_steps), int(degree), bool(antithetic),
        device=device,
    )
    return float(price), float(stderr)
