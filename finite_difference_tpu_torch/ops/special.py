"""Special functions of the analytic layer, on torch tensors.

Counterpart of ``finite_difference_tpu.ops.special``: elementwise, so they
broadcast over trade tables and differentiate under ``torch.func``.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..device import as_tensors

_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def norm_pdf(x):
    (x,) = as_tensors(x)
    return _INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def norm_cdf(x):
    """Standard normal CDF to full double precision (Hart 1968 rationals,
    as popularized by West, "Better approximations to cumulative normal
    functions"), the JAX package's arithmetic. ``torch.special.ndtr`` is not
    used: the float64 closed forms are held against the JAX package at
    1e-12 and their own identities at about 1e-15.
    """
    (x,) = as_tensors(x)
    xa = torch.abs(x)
    e = torch.exp(-0.5 * xa * xa)

    # Central branch: |x| < 7.07106781186547
    num = 3.52624965998911e-2 * xa + 0.700383064443688
    num = num * xa + 6.37396220353165
    num = num * xa + 33.912866078383
    num = num * xa + 112.079291497871
    num = num * xa + 221.213596169931
    num = num * xa + 220.206867912376
    den = 8.83883476483184e-2 * xa + 1.75566716318264
    den = den * xa + 16.064177579207
    den = den * xa + 86.7807322029461
    den = den * xa + 296.564248779674
    den = den * xa + 637.333633378831
    den = den * xa + 793.826512519948
    den = den * xa + 440.413735824752
    central = e * num / den

    # Tail branch: continued fraction
    build = xa + 0.65
    build = xa + 4.0 / build
    build = xa + 3.0 / build
    build = xa + 2.0 / build
    build = xa + 1.0 / build
    tail = e / (build * 2.506628274631000502)

    cum = torch.where(xa < 7.07106781186547, central, tail)
    cum = torch.where(xa > 37.0, 0.0, cum)
    return torch.where(x > 0.0, 1.0 - cum, cum)


def norm_icdf(u):
    """Inverse standard-normal CDF via erfinv, the JAX package's form (its
    lower tail loses what 2u - 1 rounds away: below u ~ 1e-16 it is -inf)."""
    (u,) = as_tensors(u)
    return _SQRT2 * torch.erfinv(2.0 * u - 1.0)


def bivariate_norm_cdf(a, b, rho, n_points: int = 128):
    """P(X <= a, Y <= b) for the standard bivariate normal with correlation rho.

    Gauss–Legendre integration of Drezner–Wesolowsky's single-integral form:

        Phi2(a, b, rho) = Phi(a) Phi(b)
            + (1 / 2 pi) * ∫_0^rho exp(-(a^2 - 2 r a b + b^2) / (2 (1 - r^2)))
                           / sqrt(1 - r^2) dr

    on ``n_points`` fixed nodes (``numpy.polynomial.legendre.leggauss``, as
    in the JAX package). The nodes run along a trailing axis, so ``a``,
    ``b`` and ``rho`` broadcast elementwise (the JAX package vmaps scalars).
    """
    a, b, rho = as_tensors(a, b, rho)
    x, w = _leggauss(n_points)
    nodes = torch.as_tensor(x, dtype=a.dtype, device=a.device)
    weights = torch.as_tensor(w, dtype=a.dtype, device=a.device)
    # map nodes from [-1, 1] to [0, rho]
    r = 0.5 * rho[..., None] * (nodes + 1.0)
    w = 0.5 * rho[..., None] * weights
    rr = 1.0 - r * r
    a_, b_ = a[..., None], b[..., None]
    integrand = torch.exp(-(a_ * a_ - 2.0 * r * a_ * b_ + b_ * b_) / (2.0 * rr)) / torch.sqrt(rr)
    corr = torch.sum(w * integrand, dim=-1) / (2.0 * math.pi)
    return norm_cdf(a) * norm_cdf(b) + corr


@lru_cache(maxsize=None)
def _leggauss(n: int):
    return np.polynomial.legendre.leggauss(n)
