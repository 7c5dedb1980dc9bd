"""Constant-diagonal tridiagonal solve on batched torch tensors.

Counterpart of ``finite_difference_tpu.ops.tridiag.thomas_solve_const``,
the CN hot path of the scan stepper. With constant diagonals
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

import torch


def _affine_scan(alpha: torch.Tensor, beta: torch.Tensor, reverse: bool = False):
    """Solve y_i = alpha_i * y_{i-1} + beta_i (y_{-1} = 0) along the last axis.

    Log-depth doubling (Hillis–Steele) scan: after the pass with shift s,
    element i holds the composition of the affine maps i-2s+1..i, so
    ceil(log2 n) passes finish it. ``reverse=True`` runs the recurrence from
    the far end (y_i = alpha_i * y_{i+1} + beta_i).
    """
    a, b = torch.broadcast_tensors(alpha, beta)
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    n = b.shape[-1]
    s = 1
    while s < n:
        b = torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], dim=-1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return b.flip(-1) if reverse else b


def thomas_solve_const(a_l, a_c, a_u, rhs: torch.Tensor) -> torch.Tensor:
    """Constant-diagonal Thomas solve in O(log n) depth.

    ``a_l, a_c, a_u``: scalars or tensors of ``rhs``'s batch shape — the
    constant sub/main/super diagonal of each system. ``rhs``: (..., n).
    Requires a_c^2 - 4 a_l a_u > 0, which holds for the diagonally
    dominant Crank–Nicolson / fully implicit systems the stepper builds.
    """
    dtype, device = rhs.dtype, rhs.device
    n = rhs.shape[-1]
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
    d_prime = _affine_scan(-a_l * w, w * rhs)
    return _affine_scan(-c_prime, d_prime, reverse=True)
