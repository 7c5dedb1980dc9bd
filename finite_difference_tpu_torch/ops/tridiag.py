"""Tridiagonal solves on batched torch tensors, in log depth.

Counterparts of ``finite_difference_tpu.ops.tridiag``:

- ``thomas_solve_const``, the CN hot path of the scan stepper, and its two
  halves ``const_factor`` / ``const_solve`` (the stepper factors each run of
  equal (theta, dt) steps once and solves every step of the run with it);
- ``thomas_solve_pscan``, the general-coefficient solve behind the
  natural cubic spline of the dividend jump (``ops.interp``), and its
  factor ``thomas_factor`` (the FIS stencil pricer solves every step of
  a run of equal coefficients with one factor);
- ``thomas_solve``, JAX's general solve by name, computed by the same
  log-depth scan as ``thomas_solve_pscan``;
- ``tridiag_matvec``.

With constant diagonals
(a_l, a_c, a_u) the forward-elimination denominators satisfy the
constant-coefficient Riccati recurrence  D_i = a_c - a_l*a_u / D_{i-1},
whose closed form in the characteristic roots
l1,2 = (a_c ± sqrt(a_c^2 - 4 a_l a_u)) / 2, with rho = l2/l1 (|rho| < 1 for
the diagonally dominant CN systems), is

    D_i = l1 * (1 - rho^{i+2}) / (1 - rho^{i+1}),

evaluated for all i at once. The forward and backward sweeps are then
first-order affine recurrences, run as log-depth doubling scans.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch


def tridiag_matvec(dl, d, du, x):
    """y = T @ x for tridiagonal T given by its (sub, main, super) diagonals.

    All inputs shaped (..., n); dl[..., 0] and du[..., -1] are ignored.
    """
    dl, d, du, x = torch.broadcast_tensors(dl, d, du, x)
    y = d * x
    y[..., 1:] += dl[..., 1:] * x[..., :-1]
    y[..., :-1] += du[..., :-1] * x[..., 1:]
    return y


def _scan_multipliers(alpha: torch.Tensor, reverse: bool = False) -> List[torch.Tensor]:
    """The multipliers of each pass of the doubling scan of
    y_i = alpha_i * y_{i-1} + beta_i along the last axis (``reverse``:
    y_i = alpha_i * y_{i+1} + beta_i): after the pass with shift s, element
    i holds the composition of the affine maps i-2s+1..i (i..i+2s-1), so
    ceil(log2 n) passes finish it. They depend on ``alpha`` only, so a
    solve whose matrix repeats reuses them (:func:`const_factor`).
    """
    n = alpha.shape[-1]
    out = []
    a, s = alpha, 1
    while s < n:
        if reverse:
            out.append(a[..., :-s])
            if 2 * s < n:
                a = torch.cat([a[..., :-s] * a[..., s:], a[..., -s:]], dim=-1)
        else:
            out.append(a[..., s:])
            if 2 * s < n:
                a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return out


def _scan_apply(multipliers: List[torch.Tensor], beta: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """The doubling scan's passes on ``beta`` (y_{-1} = 0, or y_n = 0 when
    ``reverse``): two launches per pass."""
    b, s = beta, 1
    for m in multipliers:
        if reverse:
            b = torch.cat([torch.addcmul(b[..., :-s], m, b[..., s:]), b[..., -s:]], dim=-1)
        else:
            b = torch.cat([b[..., :s], torch.addcmul(b[..., s:], m, b[..., :-s])], dim=-1)
        s *= 2
    return b


def _affine_scan(alpha: torch.Tensor, beta: torch.Tensor, reverse: bool = False):
    """Solve y_i = alpha_i * y_{i-1} + beta_i (y_{-1} = 0) along the last axis,
    in log depth (Hillis–Steele). ``reverse=True`` runs the recurrence from
    the far end (y_i = alpha_i * y_{i+1} + beta_i).
    """
    a, b = torch.broadcast_tensors(alpha, beta)
    return _scan_apply(_scan_multipliers(a, reverse), b, reverse)


class ConstFactor(NamedTuple):
    """A tridiagonal system factored for :func:`const_solve` (by
    :func:`const_factor` or :func:`thomas_factor`): the forward-elimination
    weights w_i = 1/D_i and the doubling scans' multipliers of both
    sweeps."""

    w: torch.Tensor
    forward: List[torch.Tensor]
    backward: List[torch.Tensor]


def const_factor(a_l, a_c, a_u, n: int, dtype: torch.dtype, device) -> ConstFactor:
    """Factor the constant-diagonal systems of size ``n``: ``a_l, a_c, a_u``
    scalars or tensors of the batch shape, the constant sub/main/super
    diagonal of each system. Requires a_c^2 - 4 a_l a_u > 0, which holds
    for the diagonally dominant Crank–Nicolson / fully implicit systems
    the stepper builds."""
    a_l = torch.as_tensor(a_l, dtype=dtype, device=device)[..., None]
    a_c = torch.as_tensor(a_c, dtype=dtype, device=device)[..., None]
    a_u = torch.as_tensor(a_u, dtype=dtype, device=device)[..., None]

    sq = torch.sqrt(a_c * a_c - 4.0 * a_l * a_u)
    # l1 is the larger-magnitude root, so |rho| < 1
    l1 = 0.5 * (a_c + torch.sign(a_c) * sq)
    rho = (a_l * a_u) / (l1 * l1)  # == l2 / l1 since l1*l2 = a_l*a_u

    # rho^(i+1), rho^(i+2) with sign and magnitude split: rho may be
    # negative (advection-dominated steps) and a negative base to a float
    # power is NaN
    k = torch.arange(n, dtype=dtype, device=device) + 1.0
    mag = torch.abs(rho) ** k
    odd = torch.remainder(k, 2.0) > 0.5
    sgn = torch.where(odd, torch.sign(rho), torch.ones_like(rho))
    rp1 = sgn * mag
    rp2 = rho * rp1
    w = 1.0 / (l1 * (1.0 - rp2) / (1.0 - rp1))
    c_prime = a_u * w
    # forward sweep d'_i = w_i rhs_i - (a_l w_i) d'_{i-1};
    # backward sweep x_i = d'_i - c'_i x_{i+1}
    return ConstFactor(w, _scan_multipliers(-a_l * w), _scan_multipliers(-c_prime, reverse=True))


def const_solve(factor: ConstFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for ``rhs`` (..., n)."""
    d_prime = _scan_apply(factor.forward, factor.w * rhs)
    return _scan_apply(factor.backward, d_prime, reverse=True)


def thomas_solve_const(a_l, a_c, a_u, rhs: torch.Tensor) -> torch.Tensor:
    """Constant-diagonal Thomas solve in O(log n) depth.

    ``a_l, a_c, a_u``: scalars or tensors of ``rhs``'s batch shape — the
    constant sub/main/super diagonal of each system. ``rhs``: (..., n).
    See :func:`const_factor` for the condition on the coefficients.
    """
    return const_solve(const_factor(a_l, a_c, a_u, rhs.shape[-1], rhs.dtype, rhs.device), rhs)


def _homography_scan(m00, m01, m10, m11):
    """Inclusive products M_i ... M_0 of 2x2 matrices along the last axis.

    Log-depth doubling scan; each product is renormalised by its largest
    |entry| (a homography is scale-invariant), so products stay O(1).
    """
    n = m00.shape[-1]
    s = 1
    while s < n:
        o00, o01, o10, o11 = (x[..., :-s] for x in (m00, m01, m10, m11))
        n00, n01, n10, n11 = (x[..., s:] for x in (m00, m01, m10, m11))
        c00 = n00 * o00 + n01 * o10
        c01 = n00 * o01 + n01 * o11
        c10 = n10 * o00 + n11 * o10
        c11 = n10 * o01 + n11 * o11
        sc = torch.maximum(
            torch.maximum(c00.abs(), c01.abs()), torch.maximum(c10.abs(), c11.abs())
        )
        sc = torch.where(sc > 0.0, sc, torch.ones_like(sc))
        m00, m01, m10, m11 = (
            torch.cat([x[..., :s], c / sc], dim=-1)
            for x, c in ((m00, c00), (m01, c01), (m10, c10), (m11, c11))
        )
        s *= 2
    return m00, m01, m10, m11


def thomas_factor(dl, d, du) -> ConstFactor:
    """Factor the general tridiagonal systems (dl, d, du), shapes (..., n)
    (dl[..., 0] and du[..., -1] are ignored), for :func:`const_solve`, in
    O(log n) depth. The forward elimination's recurrence
    c'_i = du_i / (d_i - dl_i c'_{i-1}) is a linear-fractional map of
    c'_{i-1}, so all c'_i come from the products of the homographies
    M_i = [[0, du_i], [-dl_i, d_i]]; the forward and backward sweeps are
    then affine scans. For diagonally dominant systems (splines, the FIS
    stencil's CN systems), where the recurrence is contractive.
    """
    dl, d, du = torch.broadcast_tensors(dl, d, du)
    zero = torch.zeros_like(d[..., :1])
    # zero the ignored corners so arbitrary caller values cannot overflow
    # the matrix products (they never affect the solution)
    dl = torch.cat([zero, dl[..., 1:]], dim=-1)
    du = torch.cat([du[..., :-1], zero], dim=-1)
    _, c01, _, c11 = _homography_scan(torch.zeros_like(d), du, -dl, d)
    # c'_i = (M_i ... M_0) applied to c'_{-1} = 0, i.e. column [0, 1]^T
    c_prime = c01 / c11
    cp_prev = torch.cat([zero, c_prime[..., :-1]], dim=-1)
    w = 1.0 / (d - dl * cp_prev)
    return ConstFactor(w, _scan_multipliers(-dl * w), _scan_multipliers(-c_prime, reverse=True))


def thomas_solve_pscan(dl, d, du, rhs):
    """General-coefficient Thomas solve of T x = rhs in O(log n) depth
    (:func:`thomas_factor`, then :func:`const_solve`). Shapes (..., n);
    dl[..., 0] and du[..., -1] are ignored."""
    dl, d, du, rhs = torch.broadcast_tensors(dl, d, du, rhs)
    return const_solve(thomas_factor(dl, d, du), rhs)


def thomas_solve(dl, d, du, rhs):
    """General batched tridiagonal solve of T x = rhs, JAX's ``thomas_solve``.

    Shapes (..., n); dl[..., 0] and du[..., -1] are ignored. The JAX
    function is the classic sequential Thomas algorithm (a ``lax.scan``
    over the space axis). A loop over rows would cost 2n launches per call
    on the card, so this is the log-depth homography scan of
    :func:`thomas_solve_pscan`; the two agree to roundings on the
    diagonally dominant systems both are used for.
    """
    return thomas_solve_pscan(dl, d, du, rhs)


# JAX's alias of the constant-coefficient solve, kept under its name.
thomas_solve_assoc = thomas_solve_const
