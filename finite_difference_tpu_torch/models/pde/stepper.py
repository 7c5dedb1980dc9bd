"""Batched Crank–Nicolson / Rannacher theta-stepper in log-S (plain torch).

Counterpart of ``finite_difference_tpu.models.pde.stepper.cn_solve``. The
JAX version is written per trade and vmapped; here every field carries a
written-out batch axis: per-trade values are (B,) tensors, schedules
(B, n_steps), value grids (B, N). The ``lax.scan`` over time steps is a
Python step loop.

- Per-step behaviour (theta for Rannacher smoothing, dt, KO-monitor flags,
  lambda resets) is data, precomputed host-side into a :class:`CNSchedule`.
- The tridiagonal solve is the log-depth constant-diagonal Thomas
  (:mod:`ops.tridiag`), factored once per run of equal (theta, dt) steps
  (:func:`ops.tridiag.const_factor`) and applied at each step
  (:func:`ops.tridiag.const_solve`); the far-field values and the rebate's
  PV are formed for every step at once. What the loop reads from the
  schedule on the host (those runs, the dividend and reset columns) is a
  :class:`ScanPlan`: given beforehand, the loop makes no host read, so it
  can be captured into a CUDA graph.
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

from typing import NamedTuple, Optional, Tuple

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.interp import cubic_spline_eval, natural_cubic_spline
from ...ops.tridiag import const_factor, const_solve


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

    @staticmethod
    def none(batch: int, dtype=torch.float64, device=DEFAULT_DEVICE) -> "BarrierSpec":
        """No barrier for ``batch`` trades (JAX's ``BarrierSpec.none``,
        one row per trade): zero levels and rebates, every flag False."""
        dev = resolve_device(device)
        z = torch.zeros(batch, dtype=dtype, device=dev)
        f = torch.zeros(batch, dtype=torch.bool, device=dev)
        return BarrierSpec(z, z, f, f, z, f, z)


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


class ScanPlan(NamedTuple):
    """The host-side plan of one scan: the steps that start a run of equal
    (theta, dt) columns (the systems are factored once per run), the steps
    after which some trade takes a dividend jump or is monitored, and the
    steps before which some trade resets its Ikonen–Toivanen multiplier."""

    runs: Tuple[int, ...]
    div_cols: Tuple[int, ...]
    monitor_cols: Tuple[int, ...]
    reset_cols: Tuple[int, ...]


def scan_plan(schedule: CNSchedule, with_dividends: bool) -> ScanPlan:
    """Read :class:`ScanPlan` from ``schedule`` (one host read per field)."""
    # tolist, not numpy: the scan runs inside torch.func.jvp too (ad greeks)
    dt, theta = schedule.dt, schedule.theta
    same = ((dt[:, 1:] == dt[:, :-1]) & (theta[:, 1:] == theta[:, :-1])).all(dim=0).tolist()
    cols = lambda mask: tuple(k for k, has in enumerate(mask.any(dim=0).tolist()) if has)
    return ScanPlan(
        runs=(0,) + tuple(k + 1 for k, eq in enumerate(same) if not eq),
        div_cols=cols(schedule.div_amount != 0) if with_dividends else (),
        monitor_cols=cols(schedule.monitor),
        reset_cols=cols(schedule.reset_lambda),
    )


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
    plan: Optional[ScanPlan] = None,
):
    """March the value grids from expiry (tau=0) to valuation (tau=T).

    Returns ``(V, s_nodes)``, both (B, n_nodes): the values at valuation
    and the S-space node locations. ``with_dividends`` applies the spline
    jump after each step where a trade's ``div_amount`` is nonzero (the JAX
    stepper evaluates it on every step and keeps it where the amount is
    nonzero; here only the columns where some trade has a dividend run it,
    with the same result). ``plan``: the schedule's :class:`ScanPlan`, read
    from it when not given.
    """
    if plan is None:
        plan = scan_plan(schedule, with_dividends)
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

    # the far-field values and the rebate's PV after every step, (B, n_steps)
    col = lambda x: x[:, None]
    v_min_all, v_max_all = _boundary_values(
        schedule.tau_next, col(s_min), col(s_max), CNDynamics(*map(col, dyn)),
        euro_put_lower_boundary,
    )
    if barrier is not None:
        out_mask = (barrier.has_lower[:, None] & (s <= barrier.lower[:, None])) | (
            barrier.has_upper[:, None] & (s >= barrier.upper[:, None])
        )
        rebate_pv_all = torch.where(
            col(barrier.rebate_at_hit),
            col(barrier.rebate),
            col(barrier.rebate) * torch.exp(-col(barrier.rebate_rate) * schedule.tau_next),
        )

    payoff_int = payoff[:, 1:-1]
    lam = torch.zeros_like(payoff_int)
    runs, resets, monitors = set(plan.runs), set(plan.reset_cols), set(plan.monitor_cols)
    for k in range(schedule.dt.shape[1]):
        if k in runs:
            dt, theta = schedule.dt[:, k], schedule.theta[:, k]
            dt_col = dt[:, None]
            a_l = -theta * dt * a_coef
            a_c = 1.0 - theta * dt * b_coef
            a_u = -theta * dt * c_coef
            b_l = ((1.0 - theta) * dt * a_coef)[:, None]
            b_c = (1.0 + (1.0 - theta) * dt * b_coef)[:, None]
            b_u = ((1.0 - theta) * dt * c_coef)[:, None]
            factor = const_factor(a_l, a_c, a_u, n_nodes - 2, dtype, device)

        # rhs = b_l v[i-1] + b_c v[i] + b_u v[i+1] (+ dt lam), then the
        # boundary columns; rhs is a fresh tensor, so in place is safe
        rhs = torch.addcmul(torch.addcmul(b_c * v[:, 1:-1], b_l, v[:, :-2]), b_u, v[:, 2:])
        if american:
            if k in resets:
                lam = torch.where(schedule.reset_lambda[:, k, None], 0.0, lam)
            rhs = torch.addcmul(rhs, dt_col, lam)
        rhs[:, 0].addcmul_(a_l, v_min_all[:, k], value=-1.0)
        rhs[:, -1].addcmul_(a_u, v_max_all[:, k], value=-1.0)

        tilde = const_solve(factor, rhs)

        if american:
            # Ikonen–Toivanen: v = max(payoff, tilde - dt*lam_old);
            # lam_new = max(0, lam_old + (payoff - tilde)/dt)
            v_int = torch.maximum(payoff_int, torch.addcmul(tilde, dt_col, lam, value=-1.0))
            lam = torch.clamp(lam + (payoff_int - tilde) / dt_col, min=0.0)
        else:
            v_int = tilde

        v = torch.cat([v_min_all[:, k, None], v_int, v_max_all[:, k, None]], dim=1)

        if barrier is not None and k in monitors:
            v = torch.where(
                schedule.monitor[:, k, None] & out_mask, rebate_pv_all[:, k, None], v
            )

        if k in plan.div_cols:
            div = schedule.div_amount[:, k, None]
            v_shift = cubic_spline_eval(natural_cubic_spline(s, v), s - div)
            if exercise_call_at_div:
                # American calls may exercise just before ex-div
                v_shift = torch.where(dyn.is_call[:, None], torch.maximum(v_shift, payoff), v_shift)
            v = torch.where(div != 0.0, v_shift, v)
    return v, s
