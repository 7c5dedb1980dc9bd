"""Fused Crank–Nicolson march of a barrier batch with Hillis–Steele scans (K3).

Counterpart of the non-SPIKE half of ``finite_difference_tpu/models/pde/
pallas_kernel.py``:

- ``_solver_vectors`` is :func:`solver_vectors`;
- the host preparation of ``cn_barrier_solve_pallas`` is :func:`prepare_fused`;
- the Pallas kernel ``_kernel`` is the CUDA kernel ``csrc/hs_march.cu``, with
  :func:`hs_march_reference` as its plain PyTorch version;
- the XLA twin ``cn_barrier_solve_hoisted`` is :func:`cn_barrier_solve_hoisted`
  (the prep and the plain version, on any device);
- ``cn_barrier_solve_pallas`` is :func:`cn_barrier_solve_fused` and
  ``price_barrier_batch_pallas`` is :func:`price_barrier_batch_fused`.

Scope, as in the JAX package: uniform dt per trade, theta = 1 on the first
``rannacher_steps`` steps and 1/2 after, European exercise, no dividends.
Each step builds the explicit right-hand side with Dirichlet edges from tau
(the European put's lower asymptote), solves the constant-diagonal
tridiagonal system as a forward and a backward first-order affine
recurrence over the closed-form Thomas vectors, and projects knocked-out
nodes to the rebate PV on monitor steps. The solver vectors depend only on
(theta, trade), so both theta sets are prepared once, outside the march.

Deliberate differences from the JAX package:

- a batch outside that schedule family (dt not uniform per trade, theta not
  the Rannacher prefix pattern, or dividends) raises ValueError; JAX prices
  it silently with ``dt[:, 0]``;
- no ``trade_block``/``interpret`` arguments and no ``B % TB`` rule, which
  are TPU rules; the march runs on the batch's device (the CUDA kernel on a
  card, the plain version on the CPU);
- the prep runs at float64 and is rounded once to the march's dtype, as
  ``spike.prepare_spike`` is; at float32 that differs from JAX's float32 prep;
- the solves return the values V (B, N) only: the node positions are
  recomputed at float64 by ``batch._outputs_of``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ... import kernels
from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.tridiag import _affine_scan
from .batch import _outputs_of, _vol_points
from .spike import require_default_schedule
from .stepper import _payoff

# column order of FusedPrep.trade and FusedPrep.coef (the kernels read the same)
TRADE_COLS = (
    "strike", "is_call", "r", "growth_rate", "rebate", "rebate_at_hit",
    "rebate_rate", "s_min", "s_max",
)
COEF_COLS = ("bl", "bc", "bu", "al", "au")
FIELD_ROWS = ("w", "af", "ab")
THETAS = (1.0, 0.5)  # solver set 0: the Rannacher steps; set 1: Crank–Nicolson


@dataclass
class FusedPrep:
    """The prepared tensors of one fused march (one device, one dtype).

    ``trade`` (B, 9) per-trade constants in :data:`TRADE_COLS` order;
    ``coef`` (2, B, 5) explicit and implicit CN coefficients per theta set
    (:data:`THETAS`); ``solver`` the per-set solver data: (2, 3, B, N) Thomas
    vectors :data:`FIELD_ROWS` for the scans (:func:`prepare_fused`), or
    (2, B, n_levels, 16) level scalars for cyclic reduction
    (``cr.prepare_cr``); ``omask`` (B, N) knock-out mask; ``tau``/``mon``
    (B, n_steps) schedule; ``v0`` (B, N) payoff. Steps k < ``n_rann`` take
    set 0, the rest set 1.
    """

    trade: torch.Tensor
    coef: torch.Tensor
    solver: torch.Tensor
    omask: torch.Tensor
    tau: torch.Tensor
    mon: torch.Tensor
    v0: torch.Tensor
    n_rann: int

    @property
    def n_steps(self) -> int:
        return self.tau.shape[1]


def solver_vectors(a_l, a_c, a_u, n_int: int) -> torch.Tensor:
    """Closed-form constant-diagonal Thomas vectors over the interior rows.

    ``a_l, a_c, a_u``: (B,) per-trade constant diagonals. Returns w
    (B, n_int) with w_i = 1/D_i, the math of ``ops.tridiag.thomas_solve_const``
    (the JAX function returns the transpose, (n_int, B)).
    """
    sq = torch.sqrt(a_c * a_c - 4.0 * a_l * a_u)
    l1 = 0.5 * (a_c + torch.sign(a_c) * sq)
    rho = ((a_l * a_u) / (l1 * l1))[:, None]
    k = torch.arange(n_int, dtype=a_l.dtype, device=a_l.device)[None, :] + 1.0
    mag = torch.abs(rho) ** k
    odd = torch.remainder(k, 2.0) > 0.5
    rp1 = torch.where(odd, torch.sign(rho), 1.0) * mag
    rp2 = rho * rp1
    return 1.0 / (l1[:, None] * (1.0 - rp2) / (1.0 - rp1))


def cn_operator(batch, sigma, n_nodes: int, n_steps: int, rannacher_steps: int) -> Dict[str, object]:
    """The parts of a fused march's prep that the scan and cyclic-reduction
    marches share, at float64: the node grid ``s`` (B, N), the payoff, the
    knock-out mask, the per-trade table, and per theta set the explicit and
    implicit coefficients (``coef`` (2, B, 5)) and the implicit diagonals
    ``diags`` [(a_l, a_c, a_u), ...]. Raises ValueError for a batch outside
    the uniform-dt Rannacher schedule family."""
    require_default_schedule(batch, n_steps, rannacher_steps, "the fused march")
    f = lambda x: x.to(torch.float64)
    sigma, r, b, q, dx = f(sigma), f(batch.r), f(batch.b), f(batch.q), f(batch.dx)
    dt = f(batch.dt[:, 0])

    i = torch.arange(n_nodes, dtype=torch.float64, device=batch.x_min.device)
    s = torch.exp(f(batch.x_min)[:, None] + i[None, :] * dx[:, None])
    strike = f(batch.strike)

    sig2 = sigma * sigma
    mu_x = (b - q) - 0.5 * sig2
    alpha_c = 0.5 * sig2 / (dx * dx)
    beta_adv = mu_x / (2.0 * dx)
    a_coef = alpha_c - beta_adv
    c_coef = alpha_c + beta_adv
    b_coef = -2.0 * alpha_c - r

    coef, diags = [], []
    for theta in THETAS:
        a_l = -theta * dt * a_coef
        a_u = -theta * dt * c_coef
        diags.append((a_l, 1.0 - theta * dt * b_coef, a_u))
        coef.append(torch.stack([
            (1.0 - theta) * dt * a_coef,
            1.0 + (1.0 - theta) * dt * b_coef,
            (1.0 - theta) * dt * c_coef,
            a_l,
            a_u,
        ], dim=1))
    out_mask = (batch.has_lower[:, None] & (s <= f(batch.lower)[:, None])) | (
        batch.has_upper[:, None] & (s >= f(batch.upper)[:, None])
    )
    trade = torch.stack([
        strike, f(batch.is_call), r, b - q - r, f(batch.rebate),
        f(batch.rebate_at_hit), f(batch.rebate_rate), s[:, 0], s[:, -1],
    ], dim=1)
    return dict(s=s, payoff=_payoff(s, strike, batch.is_call), omask=f(out_mask),
                trade=trade, coef=torch.stack(coef), diags=diags)


def finish_prep(batch, op: Dict[str, object], solver: torch.Tensor, n_steps: int,
                rannacher_steps: int) -> FusedPrep:
    """Round the float64 prep once to the march's dtype (that of ``batch.x_min``)."""
    out = lambda x: x.to(batch.x_min.dtype).contiguous()
    return FusedPrep(
        trade=out(op["trade"]), coef=out(op["coef"]), solver=out(solver),
        omask=out(op["omask"]), tau=out(batch.tau_next[:, :n_steps]),
        mon=out(batch.monitor[:, :n_steps]), v0=out(op["payoff"]),
        n_rann=min(rannacher_steps, n_steps),
    )


def prepare_fused(batch, sigma, n_nodes: int, n_steps: Optional[int] = None,
                  rannacher_steps: int = 2) -> FusedPrep:
    """Host prep of the scan march (``cn_barrier_solve_pallas:186-261``):
    both theta sets of ``w``, ``alpha_fwd``, ``alpha_bwd`` over all N rows
    (zero on the rows the recurrences must not cross), at float64, rounded
    once to the march's dtype. ``sigma`` may be the batch's or a bumped copy."""
    n_steps = batch.n_steps if n_steps is None else n_steps
    op = cn_operator(batch, sigma, n_nodes, n_steps, rannacher_steps)
    N = n_nodes
    row = torch.arange(N, device=batch.x_min.device)
    fields = []
    for a_l, a_c, a_u in op["diags"]:
        w = torch.zeros(a_l.shape[0], N, dtype=torch.float64, device=a_l.device)
        w[:, 1 : N - 1] = solver_vectors(a_l, a_c, a_u, N - 2)
        af = torch.where((row <= 1) | (row >= N - 1), 0.0, -a_l[:, None] * w)
        ab = torch.where((row == 0) | (row >= N - 2), 0.0, -(a_u[:, None] * w))
        fields.append(torch.stack([w, af, ab]))
    return finish_prep(batch, op, torch.stack(fields), n_steps, rannacher_steps)


def step_edges(prep: FusedPrep, k: int):
    """(v_min, v_max, rebate_pv, knock-out rows) of step k, each (B,) but
    the last (B, N): the Dirichlet edges from tau (European put lower
    asymptote) and the rebate paid at hit or discounted."""
    (strike, is_call, r, growth_rate, rebate, at_hit, rebate_rate,
     s_min, s_max) = prep.trade.unbind(1)
    tau = prep.tau[:, k]
    growth = torch.exp(growth_rate * tau)
    disc = torch.exp(-r * tau)
    zero = torch.zeros_like(tau)
    call = is_call != 0
    v_min = torch.where(call, zero, strike * disc - s_min * growth)
    v_max = torch.where(call, s_max * growth - strike * disc, zero)
    rebate_pv = torch.where(at_hit != 0, rebate, rebate * torch.exp(-rebate_rate * tau))
    knocked = (prep.mon[:, k] != 0)[:, None] & (prep.omask != 0)
    return v_min, v_max, rebate_pv, knocked


def explicit_rhs(prep: FusedPrep, t: int, v, v_min, v_max):
    """The interior rows' right-hand side (B, N-2) of one step with solver set t."""
    bl, bc, bu, al, au = (x[:, None] for x in prep.coef[t].unbind(1))
    rhs = bl * v[:, :-2] + bc * v[:, 1:-1] + bu * v[:, 2:]
    rhs[:, :1] = rhs[:, :1] - al * v_min[:, None]
    rhs[:, -1:] = rhs[:, -1:] - au * v_max[:, None]
    return rhs


def hs_march_reference(prep: FusedPrep) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the whole march, V (B, N).

    Follows ``_kernel`` step by step; both recurrences run as the doubling
    ``ops.tridiag._affine_scan`` over the full rows (the kernel scans in
    another order, so the two agree to rounding)."""
    v = prep.v0
    for k in range(prep.n_steps):
        t = 0 if k < prep.n_rann else 1
        w, af, ab = prep.solver[t]
        v_min, v_max, rebate_pv, knocked = step_edges(prep, k)
        rhs = torch.nn.functional.pad(explicit_rhs(prep, t, v, v_min, v_max), (1, 1))
        x = _affine_scan(ab, _affine_scan(af, w * rhs), reverse=True)
        x = torch.cat([v_min[:, None], x[:, 1:-1], v_max[:, None]], dim=1)
        v = torch.where(knocked, rebate_pv[:, None], x)
    return v


def hs_march(prep: FusedPrep) -> torch.Tensor:
    """The march: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. There is no fallback between the two: a kernel that fails
    to build or launch raises."""
    if prep.v0.device.type == "cuda":
        return kernels.hs_march_cuda(prep)
    if prep.v0.device.type == "cpu":
        return hs_march_reference(prep)
    raise ValueError(f"hs_march: unsupported device {prep.v0.device}")


def cn_barrier_solve_fused(batch, sigma, n_nodes: int, n_steps: int, rannacher_steps: int = 2):
    """Fused solve of a barrier batch: the values V (B, N), on the batch's
    device (the CUDA kernel on a card, the plain version on the CPU).
    ``sigma`` may be the batch's or a bumped copy (vega)."""
    return hs_march(prepare_fused(batch, sigma, n_nodes, n_steps, rannacher_steps))


def cn_barrier_solve_hoisted(batch, sigma, n_nodes: int, n_steps: int, rannacher_steps: int = 2):
    """The same solve through the plain version on any device (JAX's XLA
    twin of the kernel): V (B, N)."""
    return hs_march_reference(prepare_fused(batch, sigma, n_nodes, n_steps, rannacher_steps))


def price_barrier_batch_fused(
    batch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Price a barrier batch through the fused march on ``device``: dict of
    (B,) tensors, price and with greeks vega, delta, gamma and theta,
    post-processed at float64 as the other routes (``batch._outputs_of``).
    ``dv_sigma=None`` takes the dtype-aware bump. Not a ``solver=`` value of
    ``price_barrier_batch``: the JAX package has no such route either."""
    batch = batch.to(resolve_device(device))
    dv_sigma, sigmas = _vol_points(batch, dv_sigma, with_greeks)
    values = [cn_barrier_solve_fused(batch, sig, n_nodes, batch.n_steps) for sig in sigmas]
    return _outputs_of(batch, n_nodes, values, dv_sigma, with_theta=True)
