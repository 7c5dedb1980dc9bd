"""Delta/gamma stencils on batched FD value grids.

Counterpart of ``finite_difference_tpu.ops.stencils``. The JAX functions
work on one grid and are vmapped; here every grid argument is (B, N), one
row per trade, and node indices and spot levels are (B,):

- ``nonuniform_central``: 3-point non-uniform central stencil
  (discrete_barrier_fdm_pricer.py:905-960, the live production path);
- ``nonuniform_forward`` / ``nonuniform_backward``: one-sided 3-point
  stencils pointing away from a barrier (discrete_barrier_fdm_pricer.py:549-612);
- ``local_cubic_fit``: 4-point local cubic polynomial fit around spot
  (fd_american_equity.py:876-911);
- ``barrier_aware_delta_gamma``: the central stencil, or the one-sided one
  within a band of nodes of a knock-out barrier, gamma clamped to ±1e5
  there (discrete_barrier_fdm_pricer.py:610).
"""
from __future__ import annotations

import torch

GAMMA_CLAMP = 1e5


def nearest_index(s_nodes: torch.Tensor, s0: torch.Tensor, lo: int = 0, hi_offset: int = 0):
    """Index of the node closest to ``s0`` within [lo, N-1-hi_offset], per row
    of ``s_nodes`` (B, N); ``s0`` (B,). Ties take the lower index."""
    n = s_nodes.shape[-1]
    idx = torch.argmin(torch.abs(s_nodes - s0[..., None]), dim=-1)
    return idx.clamp(lo, n - 1 - hi_offset)


def _at(a: torch.Tensor, idx: torch.Tensor, off: int) -> torch.Tensor:
    return torch.gather(a, -1, (idx + off)[..., None])[..., 0]


def nonuniform_central(s: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
    """3-point non-uniform central (delta, gamma) at node ``idx`` of each row.

    ``s``, ``v``: (B, N) node locations and values; ``idx``: (B,) interior
    node indices (1 <= idx <= N-2). Returns two (B,) tensors.
    """
    s_m, s_0, s_p = _at(s, idx, -1), _at(s, idx, 0), _at(s, idx, 1)
    v_m, v_0, v_p = _at(v, idx, -1), _at(v, idx, 0), _at(v, idx, 1)
    h1 = s_0 - s_m
    h2 = s_p - s_0
    delta = (
        -h2 / (h1 * (h1 + h2)) * v_m
        + (h2 - h1) / (h1 * h2) * v_0
        + h1 / (h2 * (h1 + h2)) * v_p
    )
    gamma = 2.0 * (
        v_m / (h1 * (h1 + h2)) - v_0 / (h1 * h2) + v_p / (h2 * (h1 + h2))
    )
    return delta, gamma


def nonuniform_forward(s: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
    """One-sided forward stencil on nodes idx, idx+1, idx+2 (away from a
    lower barrier)."""
    s0, s1, s2 = _at(s, idx, 0), _at(s, idx, 1), _at(s, idx, 2)
    v0, v1, v2 = _at(v, idx, 0), _at(v, idx, 1), _at(v, idx, 2)
    h1 = s1 - s0
    h2 = s2 - s1
    a0 = (-2.0 * h1 - h2) / (h1 * h1 + h1 * h2)
    a1 = (h1 + h2) / (h1 * h2)
    a2 = -h1 / (h1 * h2 + h2 * h2)
    b0 = 2.0 / (h1 * h1 + h1 * h2)
    b1 = -2.0 / (h1 * h2)
    b2 = 2.0 / (h1 * h2 + h2 * h2)
    return a0 * v0 + a1 * v1 + a2 * v2, b0 * v0 + b1 * v1 + b2 * v2


def nonuniform_backward(s: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
    """One-sided backward stencil on nodes idx, idx-1, idx-2 (away from an
    upper barrier)."""
    s0, s1, s2 = _at(s, idx, 0), _at(s, idx, -1), _at(s, idx, -2)
    v0, v1, v2 = _at(v, idx, 0), _at(v, idx, -1), _at(v, idx, -2)
    h1 = s0 - s1
    h2 = s1 - s2
    c0 = (2.0 * h1 + h2) / (h1 * h1 + h1 * h2)
    c1 = -(h1 + h2) / (h1 * h2)
    c2 = h1 / (h1 * h2 + h2 * h2)
    d0 = 2.0 / (h1 * h1 + h1 * h2)
    d1 = -2.0 / (h1 * h2)
    d2 = 2.0 / (h1 * h2 + h2 * h2)
    return c0 * v0 + c1 * v1 + c2 * v2, d0 * v0 + d1 * v1 + d2 * v2


def local_cubic_fit(s: torch.Tensor, v: torch.Tensor, s0: torch.Tensor, idx: torch.Tensor):
    """4-point local cubic fit around ``idx``; (delta, gamma) at ``s0``, (B,) each.

    Solves the 4x4 Vandermonde in (s - s0) powers, exactly like
    fd_american_equity.py:876-911 (``idx`` pre-clamped to [1, N-3]).
    """
    cols = torch.stack([_at(s, idx, k) for k in (-1, 0, 1, 2)], dim=-1) - s0[..., None]
    y = torch.stack([_at(v, idx, k) for k in (-1, 0, 1, 2)], dim=-1)
    design = torch.stack([cols**3, cols**2, cols, torch.ones_like(cols)], dim=-1)
    coef = torch.linalg.solve(design, y[..., None])[..., 0]
    return coef[..., 2], 2.0 * coef[..., 1]


def barrier_aware_delta_gamma(
    s: torch.Tensor,
    v: torch.Tensor,
    s0: torch.Tensor,
    lower_barrier=None,
    upper_barrier=None,
    band_nodes: int = 2,
    one_sided: bool = True,
):
    """Delta/gamma at ``s0`` with one-sided stencils near a knock-out barrier.

    Central stencil by default; within ``band_nodes`` grid nodes of the
    barrier (the lower one where given, else the upper), and ``one_sided``,
    the stencil pointing away from it, gamma clamped to ±1e5
    (discrete_barrier_fdm_pricer.py:549-612). Barrier levels are numbers or
    None, shared by the rows.
    """
    n = s.shape[-1]
    idx = nearest_index(s, s0, lo=1, hi_offset=1)
    delta_c, gamma_c = nonuniform_central(s, v, idx)
    if not one_sided or (lower_barrier is None and upper_barrier is None):
        return delta_c, gamma_c

    use_lower = lower_barrier is not None
    h_level = torch.full_like(s0, float(lower_barrier if use_lower else upper_barrier))
    j = nearest_index(s, h_level).clamp(0, n - 2)
    near = torch.abs(idx - j) <= band_nodes
    if use_lower:
        delta_1, gamma_1 = nonuniform_forward(s, v, (j + 1).clamp(2, n - 3))
    else:
        delta_1, gamma_1 = nonuniform_backward(s, v, j.clamp(2, n - 3))
    gamma_1 = gamma_1.clamp(-GAMMA_CLAMP, GAMMA_CLAMP)
    return torch.where(near, delta_1, delta_c), torch.where(near, gamma_1, gamma_c)
