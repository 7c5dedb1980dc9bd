"""Fused Crank–Nicolson march with constant-coefficient cyclic reduction (K4).

Counterpart of ``finite_difference_tpu/models/pde/pallas_cr.py``: the slot
table ``_SLOTS``/``N_SLOTS`` and ``cr_level_coeffs`` are copied here,
``_class_vec`` is :func:`class_vec`, the Pallas kernel ``_cr_kernel`` is the
CUDA kernel ``csrc/cr_march.cu`` with :func:`cr_march_reference` as its plain
PyTorch version, and ``cn_barrier_solve_pallas_cr`` is
:func:`cn_barrier_solve_cr`.

The march is the scan march of :mod:`.fused` (same prep, same schedule
family and guard, same deliberate differences from the JAX package), with
the tridiagonal solve done by cyclic reduction: log2 n levels of even/odd
elimination over the n = N-2 interior rows, then back-substitution. The
interior system is Toeplitz, and with zero-extended phantom unknowns every
level stays Toeplitz except its first and last rows, so each level's
coefficients are at most three scalars per class (first, interior, last),
prepared once per (theta, trade). n must be a power of two (at least 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import kernels
from .fused import FusedPrep, cn_operator, explicit_rhs, finish_prep, step_edges

# slot layout inside the packed per-level coefficient tensor
_SLOTS = dict(
    alpha_f=0, alpha_i=1, alpha_l=2,
    gamma_f=3, gamma_i=4, gamma_l=5,
    ae_f=6, ae_i=7, ae_l=8,
    be_f=9, be_i=10, be_l=11,
    ce_f=12, ce_i=13, ce_l=14,
    b_final=15,  # only meaningful at level 0 row (scalar per trade)
)
N_SLOTS = 16


def _check_size(n: int) -> int:
    """log2 n for a power of two n >= 2; raises ValueError otherwise."""
    if n < 2 or n & (n - 1) != 0:
        raise ValueError(f"n_nodes - 2 must be a power of two (at least 2) for the CR kernel: {n}")
    return int(math.log2(n))


def cr_level_coeffs(a_l, a_c, a_u, n: int) -> torch.Tensor:
    """Packed (n_levels, 16, B) CR level scalars for per-trade constant
    diagonals (a_l, a_c, a_u), each (B,); n must be a power of two."""
    n_levels = _check_size(n)
    B = a_l.shape[0]
    S = _SLOTS

    av = a_l[None, :].expand(n, B).clone()
    av[0] = 0.0
    bv = a_c[None, :].expand(n, B)
    cv = a_u[None, :].expand(n, B).clone()
    cv[n - 1] = 0.0

    out = []
    m = n
    for _ in range(n_levels):
        half = m // 2
        a_e, b_e, c_e = av[0::2], bv[0::2], cv[0::2]  # even rows (half, B)
        a_o, b_o, c_o = av[1::2], bv[1::2], cv[1::2]  # odd rows
        alpha = a_o / b_e
        # upper neighbour of odd k is even k+1; the last odd row has none
        b_e_up = torch.cat([b_e[1:], torch.ones_like(b_e[:1])])
        a_e_up = torch.cat([a_e[1:], torch.zeros_like(a_e[:1])])
        c_e_up = torch.cat([c_e[1:], torch.zeros_like(c_e[:1])])
        gamma = c_o / b_e_up
        gamma[-1] = 0.0
        mid = half // 2
        lvl = torch.zeros(N_SLOTS, B, dtype=a_l.dtype, device=a_l.device)
        for name, x in (("alpha", alpha), ("ae", a_e), ("be", b_e), ("ce", c_e)):
            lvl[S[name + "_f"]] = x[0]
            lvl[S[name + "_i"]] = x[mid]
            lvl[S[name + "_l"]] = x[-1]
        lvl[S["gamma_f"]] = gamma[0]
        lvl[S["gamma_i"]] = gamma[mid] if half > 1 else gamma[0]
        lvl[S["gamma_l"]] = gamma[-1]
        out.append(lvl)

        av = -alpha * a_e
        cv = -gamma * c_e_up
        bv = b_o - alpha * c_e - gamma * a_e_up
        m = half

    # final 1x1 system pivot goes into level-0's b_final slot
    out[0][S["b_final"]] = bv[0]
    return torch.stack(out)


def class_vec(rows: int, first, interior, last) -> torch.Tensor:
    """(B, rows) vector from three (B,) class scalars: ``first`` at row 0,
    ``last`` at row rows-1 (it wins when rows == 1), ``interior`` between."""
    v = interior[:, None].expand(interior.shape[0], rows).clone()
    v[:, 0] = first
    v[:, -1] = last
    return v


def prepare_cr(batch, sigma, n_nodes: int, n_steps: Optional[int] = None,
               rannacher_steps: int = 2) -> FusedPrep:
    """Host prep of the CR march (``cn_barrier_solve_pallas_cr:284-332``): the
    :mod:`.fused` prep with ``solver`` the (2, B, n_levels, 16) level
    scalars of both theta sets, one trade's levels contiguous (the JAX pack
    is (2, n_levels, 16, B)), at float64 rounded once to the march's dtype."""
    _check_size(n_nodes - 2)
    n_steps = batch.n_steps if n_steps is None else n_steps
    op = cn_operator(batch, sigma, n_nodes, n_steps, rannacher_steps)
    lvl = torch.stack([
        cr_level_coeffs(a_l, a_c, a_u, n_nodes - 2).permute(2, 0, 1)
        for a_l, a_c, a_u in op["diags"]
    ])
    return finish_prep(batch, op, lvl, n_steps, rannacher_steps)


def cr_march_reference(prep: FusedPrep) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the whole march, V (B, N).

    Mirrors ``_cr_kernel``'s step: the rhs; the forward reduction over the
    packed classes, each level's evens kept on a stack; the 1x1 pivot
    ``b_final``; back-substitution and the interleaving; then the edges and
    the knock-out projection."""
    B, N = prep.v0.shape
    n_levels = prep.solver.shape[2]
    S = _SLOTS
    v = prep.v0
    for k in range(prep.n_steps):
        t = 0 if k < prep.n_rann else 1
        lv = prep.solver[t]  # (B, n_levels, 16)
        cls = lambda lev, rows, name: class_vec(
            rows, lv[:, lev, S[name + "_f"]], lv[:, lev, S[name + "_i"]], lv[:, lev, S[name + "_l"]]
        )
        v_min, v_max, rebate_pv, knocked = step_edges(prep, k)
        d = explicit_rhs(prep, t, v, v_min, v_max)  # (B, n)

        stack = []
        for lev in range(n_levels):
            evens, odds = d[:, 0::2], d[:, 1::2]
            stack.append(evens)
            half = evens.shape[1]
            ev_up = torch.nn.functional.pad(evens[:, 1:], (0, 1))
            d = odds - cls(lev, half, "alpha") * evens - cls(lev, half, "gamma") * ev_up

        x = d / lv[:, 0, S["b_final"], None]  # (B, 1)
        for lev in range(n_levels - 1, -1, -1):
            evens = stack.pop()
            half = evens.shape[1]
            x_lo = torch.nn.functional.pad(x[:, :-1], (1, 0))
            x_even = (evens - cls(lev, half, "ae") * x_lo - cls(lev, half, "ce") * x) / cls(lev, half, "be")
            x = torch.stack([x_even, x], dim=2).reshape(B, 2 * half)

        x = torch.cat([v_min[:, None], x, v_max[:, None]], dim=1)
        v = torch.where(knocked, rebate_pv[:, None], x)
    return v


def cr_march(prep: FusedPrep) -> torch.Tensor:
    """The march: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors, with no fallback between the two."""
    if prep.v0.device.type == "cuda":
        return kernels.cr_march_cuda(prep)
    if prep.v0.device.type == "cpu":
        return cr_march_reference(prep)
    raise ValueError(f"cr_march: unsupported device {prep.v0.device}")


def cn_barrier_solve_cr(batch, sigma, n_nodes: int, n_steps: int, rannacher_steps: int = 2):
    """CR solve of a barrier batch: the values V (B, N) on the batch's
    device. ``n_nodes - 2`` must be a power of two (e.g. n_nodes = 1026),
    else ValueError; the schedule guard is that of :mod:`.fused`."""
    return cr_march(prepare_cr(batch, sigma, n_nodes, n_steps, rannacher_steps))
