"""Interpolation on batched torch tensors.

Counterpart of ``finite_difference_tpu.ops.interp``: ``linear_interp``
(``jnp.interp`` semantics, the price read off each trade's grid) and the
natural cubic spline (``natural_cubic_spline``, ``cubic_spline_eval``) of
the dividend jump V(t-, S) = V(t+, S - D) (fd_american_equity.py:479-558,
732-776). The JAX functions work on one row and are vmapped; here every
argument carries the batch as leading axes and the knots on the last axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .tridiag import thomas_solve_pscan


def linear_interp(xq: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of y(x) at ``xq``, clamped to the end
    values (``jnp.interp`` semantics), ``x`` ascending. Two forms: JAX's
    1-D one, ``x`` and ``y`` (N,) with ``xq`` of any shape; and the row
    form (``jax.vmap(jnp.interp)``), ``x`` and ``y`` (B, N), one table per
    row, with ``xq`` (B,), one query per row (each trade's price),
    or (B, M), M queries per row (the exposure engine's paths)."""
    if x.dim() == 1:
        n = x.shape[0]
        i = torch.searchsorted(x, xq.contiguous(), right=True).clamp(1, n - 1)
        x0, x1, f0, f1 = x[i - 1], x[i], y[i - 1], y[i]
        f = f0 + ((xq - x0) / (x1 - x0)) * (f1 - f0)
        f = torch.where(xq < x[0], y[0], f)
        return torch.where(xq > x[-1], y[-1], f)
    n = x.shape[1]
    q = xq[:, None] if xq.dim() == 1 else xq
    i = torch.searchsorted(x, q.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(x, 1, i - 1), torch.gather(x, 1, i)
    f0, f1 = torch.gather(y, 1, i - 1), torch.gather(y, 1, i)
    f = f0 + ((q - x0) / (x1 - x0)) * (f1 - f0)
    f = torch.where(q < x[:, :1], y[:, :1], f)
    f = torch.where(q > x[:, -1:], y[:, -1:], f)
    return f[:, 0] if xq.dim() == 1 else f


class SplineCoeffs(NamedTuple):
    x: torch.Tensor  # (..., n) knots
    y: torch.Tensor  # (..., n) values at knots
    b: torch.Tensor  # (..., n-1) slope coefficients
    c: torch.Tensor  # (..., n-1) curvature coefficients
    d: torch.Tensor  # (..., n-1) cubic coefficients


def natural_cubic_spline(x: torch.Tensor, y: torch.Tensor) -> SplineCoeffs:
    """Natural cubic spline through (x_i, y_i) along the last axis, with
    c_0 = c_{n-1} = 0; the second-derivative system is solved with the
    log-depth :func:`ops.tridiag.thomas_solve_pscan`."""
    h = torch.diff(x, dim=-1)
    dy = torch.diff(y, dim=-1)
    alpha = 3.0 * (dy[..., 1:] / h[..., 1:] - dy[..., :-1] / h[..., :-1])
    # interior system: h[i-1] c[i-1] + 2(h[i-1]+h[i]) c[i] + h[i] c[i+1] = alpha
    dl = h[..., :-1]
    du = h[..., 1:]
    dm = 2.0 * (h[..., :-1] + h[..., 1:])
    c_int = thomas_solve_pscan(dl, dm, du, alpha)
    zeros = torch.zeros_like(x[..., :1])
    c_full = torch.cat([zeros, c_int, zeros], dim=-1)
    b = dy / h - h * (c_full[..., 1:] + 2.0 * c_full[..., :-1]) / 3.0
    d = (c_full[..., 1:] - c_full[..., :-1]) / (3.0 * h)
    return SplineCoeffs(x=x, y=y, b=b, c=c_full[..., :-1], d=d)


def cubic_spline_eval(coeffs: SplineCoeffs, xq: torch.Tensor, idx=None) -> torch.Tensor:
    """The spline at ``xq`` (..., M), the leading axes those of the knots.
    Outside the knot span the value clamps to the end knot values
    (fd_american_equity.py:752-758).

    ``idx``: optional precomputed interval indices, shaped like ``xq``, for
    grids where the bracketing interval has a closed form (log-uniform PDE
    grids: ``floor((log(xq) - x_min) / dx)``); it replaces the
    ``searchsorted``. An off-by-one at an exact knot is harmless (the
    spline is C^2); indices are clipped to the valid range.
    """
    x, y = coeffs.x, coeffs.y
    n = x.shape[-1]
    if idx is None:
        idx = torch.searchsorted(x.contiguous(), xq.contiguous(), right=True) - 1
    idx = idx.long().clamp(0, n - 2)
    xg, yg, bg, cg, dg = (
        torch.gather(a, -1, idx) for a in (x[..., :-1], y[..., :-1], coeffs.b, coeffs.c, coeffs.d)
    )
    z = xq - xg
    val = yg + z * (bg + z * (cg + z * dg))
    val = torch.where(xq <= x[..., :1], y[..., :1], val)
    return torch.where(xq >= x[..., -1:], y[..., -1:], val)
