"""Batched Crank–Nicolson / Rannacher theta-stepper in log-S (plain torch).

Counterpart of ``finite_difference_tpu.models.pde.stepper.cn_solve``. The
JAX version is written per trade and vmapped; here every field carries a
written-out batch axis: per-trade values are (B,) tensors, schedules
(B, n_steps), value grids (B, N). The ``lax.scan`` over time steps is a
Python step loop.

- Per-step behaviour (theta for Rannacher smoothing, dt, KO-monitor flags,
  lambda resets) is data, precomputed host-side into a :class:`CNSchedule`.
- The tridiagonal solve is the log-depth constant-diagonal Thomas
  (:func:`ops.tridiag.thomas_solve_const`).
- Discrete-barrier knock-out is a masked projection on monitor steps
  (discrete_barrier_fdm_pricer.py:413-440), with rebate PV.
- American early exercise is Ikonen–Toivanen operator splitting
  (fd_american_equity.py:701-723).
- Discrete cash dividends apply the natural-cubic-spline jump
  V(t-, S) = V(t+, S - D) (fd_american_equity.py:732-776), with the
  American-call exercise check at ex-div.

This is the port's ``solver="scan"`` and its float64 oracle for the SPIKE
kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops.interp import cubic_spline_eval, natural_cubic_spline
from ...ops.tridiag import thomas_solve_const


class CNGrid(NamedTuple):
    """Uniform log-S grids: x_i = x_min + i*dx, i = 0..n_nodes-1; (B,) each."""

    x_min: torch.Tensor
    dx: torch.Tensor


class CNDynamics(NamedTuple):
    """Black–Scholes dynamics + payoff, (B,) each."""

    strike: torch.Tensor
    is_call: torch.Tensor  # bool
    sigma: torch.Tensor
    r: torch.Tensor  # discount NACC
    b: torch.Tensor  # cost of carry NACC
    q: torch.Tensor  # continuous dividend yield NACC (escrowed model)


class BarrierSpec(NamedTuple):
    """Knock-out barriers, (B,) each; absent barriers have has_* = False."""

    lower: torch.Tensor
    upper: torch.Tensor
    has_lower: torch.Tensor  # bool
    has_upper: torch.Tensor  # bool
    rebate: torch.Tensor
    rebate_at_hit: torch.Tensor  # bool
    # rate used to PV a maturity-paid rebate back from expiry; the
    # reference discounts at the CARRY rate (discrete_barrier_fdm_pricer.py:424)
    rebate_rate: torch.Tensor


class CNSchedule(NamedTuple):
    """Per-time-step controls, (B, n_steps) each; build host-side."""

    dt: torch.Tensor
    theta: torch.Tensor  # 1.0 = fully implicit (Rannacher), 0.5 = CN
    tau_next: torch.Tensor  # time-to-maturity after the step
    monitor: torch.Tensor  # bool: apply KO projection after the step
    div_amount: torch.Tensor  # cash dividend jump applied after the step (0 = none)
    reset_lambda: torch.Tensor  # bool: zero the IT multiplier before the step


def _payoff(s, strike, is_call):
    return torch.where(
        is_call[:, None],
        torch.clamp(s - strike[:, None], min=0.0),
        torch.clamp(strike[:, None] - s, min=0.0),
    )


def _boundary_values(tau, s_min, s_max, dyn: CNDynamics, euro_put_lower: bool):
    """Dirichlet far-field values at time-to-maturity tau, (B,) each.

    Calls: V_max = S_max e^{(b-q-r) tau} - K e^{-r tau}; V_min = 0.
    Puts:  V_max = 0; V_min = K e^{-r tau} (American pricer convention,
    fd_american_equity.py:474-478) or K e^{-r tau} - S_min e^{(b-q-r) tau}
    (full European asymptote used by the barrier stepper).
    """
    growth = torch.exp((dyn.b - dyn.q - dyn.r) * tau)
    disc = torch.exp(-dyn.r * tau)
    v_max_call = s_max * growth - dyn.strike * disc
    v_min_put = dyn.strike * disc
    if euro_put_lower:
        v_min_put = v_min_put - s_min * growth
    zero = torch.zeros_like(tau)
    v_min = torch.where(dyn.is_call, zero, v_min_put)
    v_max = torch.where(dyn.is_call, v_max_call, zero)
    return v_min, v_max


def cn_solve(
    grid: CNGrid,
    dyn: CNDynamics,
    schedule: CNSchedule,
    n_nodes: int,
    barrier: Optional[BarrierSpec] = None,
    american: bool = False,
    with_dividends: bool = False,
    exercise_call_at_div: bool = True,
    euro_put_lower_boundary: bool = True,
    terminal_values: Optional[torch.Tensor] = None,
):
    """March the value grids from expiry (tau=0) to valuation (tau=T).

    Returns ``(V, s_nodes)``, both (B, n_nodes): the values at valuation
    and the S-space node locations. ``with_dividends`` applies the spline
    jump after each step where a trade's ``div_amount`` is nonzero (the JAX
    stepper evaluates it on every step and keeps it where the amount is
    nonzero; here only the columns where some trade has a dividend run it,
    with the same result).
    """
    dtype, device = grid.x_min.dtype, grid.x_min.device
    i = torch.arange(n_nodes, dtype=dtype, device=device)
    s = torch.exp(grid.x_min[:, None] + i[None, :] * grid.dx[:, None])
    s_min, s_max = s[:, 0], s[:, -1]

    payoff = _payoff(s, dyn.strike, dyn.is_call)
    v = payoff if terminal_values is None else terminal_values

    sig2 = dyn.sigma * dyn.sigma
    mu_x = (dyn.b - dyn.q) - 0.5 * sig2
    alpha = 0.5 * sig2 / (grid.dx * grid.dx)
    beta_adv = mu_x / (2.0 * grid.dx)
    a_coef = alpha - beta_adv
    c_coef = alpha + beta_adv
    b_coef = -2.0 * alpha - dyn.r

    payoff_int = payoff[:, 1:-1]
    lam = torch.zeros_like(payoff_int)
    if barrier is not None:
        out_mask = (barrier.has_lower[:, None] & (s <= barrier.lower[:, None])) | (
            barrier.has_upper[:, None] & (s >= barrier.upper[:, None])
        )

    div_cols = set()
    if with_dividends:
        # tolist, not numpy: the scan runs inside torch.func.jvp too (ad greeks)
        has_div = (schedule.div_amount != 0).any(dim=0).tolist()
        div_cols = {k for k, has in enumerate(has_div) if has}

    for k in range(schedule.dt.shape[1]):
        dt, theta = schedule.dt[:, k], schedule.theta[:, k]
        tau = schedule.tau_next[:, k]

        a_l = -theta * dt * a_coef
        a_c = 1.0 - theta * dt * b_coef
        a_u = -theta * dt * c_coef
        b_l = (1.0 - theta) * dt * a_coef
        b_c = 1.0 + (1.0 - theta) * dt * b_coef
        b_u = (1.0 - theta) * dt * c_coef

        v_min, v_max = _boundary_values(
            tau, s_min, s_max, dyn, euro_put_lower_boundary
        )

        rhs = b_l[:, None] * v[:, :-2] + b_c[:, None] * v[:, 1:-1] + b_u[:, None] * v[:, 2:]
        if american:
            lam = torch.where(schedule.reset_lambda[:, k, None], 0.0, lam)
            rhs = rhs + dt[:, None] * lam
        rhs[:, 0] -= a_l * v_min  # rhs is a fresh tensor: in place is safe
        rhs[:, -1] -= a_u * v_max

        tilde = thomas_solve_const(a_l, a_c, a_u, rhs)

        if american:
            # Ikonen–Toivanen: v = max(payoff, tilde - dt*lam_old);
            # lam_new = max(0, lam_old + (payoff - tilde)/dt)
            v_int = torch.maximum(payoff_int, tilde - dt[:, None] * lam)
            lam = torch.clamp(lam + (payoff_int - tilde) / dt[:, None], min=0.0)
        else:
            v_int = tilde

        v = torch.cat([v_min[:, None], v_int, v_max[:, None]], dim=1)

        if barrier is not None:
            rebate_pv = torch.where(
                barrier.rebate_at_hit,
                barrier.rebate,
                barrier.rebate * torch.exp(-barrier.rebate_rate * tau),
            )
            v = torch.where(
                schedule.monitor[:, k, None] & out_mask, rebate_pv[:, None], v
            )

        if k in div_cols:
            div = schedule.div_amount[:, k, None]
            v_shift = cubic_spline_eval(natural_cubic_spline(s, v), s - div)
            if exercise_call_at_div:
                # American calls may exercise just before ex-div
                v_shift = torch.where(dyn.is_call[:, None], torch.maximum(v_shift, payoff), v_shift)
            v = torch.where(div != 0.0, v_shift, v)
    return v, s
