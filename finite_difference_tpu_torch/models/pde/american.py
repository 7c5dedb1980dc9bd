"""American vanilla option FD pricer (CN + Rannacher + Ikonen–Toivanen).

Counterpart of ``finite_difference_tpu.models.pde.american``, with
capability parity with the reference's ``AmericanFDMPricer``
(fd_american_equity.py:42-1068): log-S uniform grid with spot/strike
snapping, discrete dividends via time-segment splitting + natural-cubic-
spline jumps (with the American-call ex-div exercise check), Rannacher
restarts (always at expiry; at dividends for calls), Richardson
extrapolation in time, local-cubic delta/gamma, double-Richardson vega
bumps, theta from the BS PDE identity.

The date, calendar and curve work happens once on the host in
``__init__``. Every solve is one batched scan (:func:`_solve_batch`) over
all its sigma bumps, at float64, on the pricer's ``device`` (the card by
default; ``device="cpu"`` on a machine without one). On a card the scan
is replayed from a CUDA graph captured per shape and schedule plan
(:func:`spectral.run_graphed`'s rule: eager on a key's first solve,
captured on its second), the counterpart of ``jax.jit``'s static
arguments; the scalar pricers keep to the scan, as the JAX package's do.
"""
from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.stencils import local_cubic_fit
from ...utils.calendars import SouthAfricaCalendar
from ...utils.curves import DailyNacaCurve
from ...utils.daycount import normalize_convention, year_fraction
from .grid import LogGrid, ScheduleArrays, american_log_grid, segmented_schedule
from .spectral import run_graphed
from .stepper import BarrierSpec, CNDynamics, CNGrid, CNSchedule, cn_solve, scan_plan

OptionType = Literal["call", "put"]


def _schedule_to_device(s: ScheduleArrays, device, rows: int = 1) -> CNSchedule:
    """The host schedule as (rows, n_steps) tensors on ``device``: one row
    for each solve of a batch."""
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)[None].expand(rows, -1).contiguous()
    return CNSchedule(
        dt=t(s.dt),
        theta=t(s.theta),
        tau_next=t(s.tau_next),
        monitor=t(s.monitor),
        div_amount=t(s.div_amount),
        reset_lambda=t(s.reset_lambda),
    )


def _dynamics(device, strike, is_call, sigmas, r, b, q=0.0) -> CNDynamics:
    """One row of float64 dynamics per sigma, the rest shared."""
    n = len(sigmas)
    f = lambda x: torch.full((n,), float(x), dtype=torch.float64, device=device)
    return CNDynamics(
        strike=f(strike),
        is_call=torch.full((n,), bool(is_call), device=device),
        sigma=torch.tensor([float(x) for x in sigmas], dtype=torch.float64, device=device),
        r=f(r),
        b=f(b),
        q=f(q),
    )


def _barrier(device, lower, upper, has_lower, has_upper, rebate, rebate_at_hit, rebate_rate):
    """A float64 :class:`BarrierSpec` of 0-d tensors (the rows share it)."""
    f = lambda x: torch.tensor(float(x), dtype=torch.float64, device=device)
    b = lambda x: torch.tensor(bool(x), device=device)
    return BarrierSpec(
        lower=f(lower), upper=f(upper), has_lower=b(has_lower), has_upper=b(has_upper),
        rebate=f(rebate), rebate_at_hit=b(rebate_at_hit), rebate_rate=f(rebate_rate),
    )


def _solve_batch(
    grid: LogGrid,
    dyn: CNDynamics,
    sch: ScheduleArrays,
    n_nodes: int,
    with_dividends: bool,
    american: bool = True,
    barrier: Optional[BarrierSpec] = None,
) -> torch.Tensor:
    """The value grids at valuation, (B, n_nodes), one scan per row of
    ``dyn`` (sigma bumps etc.) on its device, sharing ``grid``, the host
    schedule ``sch`` and ``barrier``.

    ``american=False`` drops the Ikonen-Toivanen projection AND switches
    the put far-field to the full European asymptotic (the European
    exercise of VanillaOptionPricerFIS, and the barrier pricers). On a
    card the scan goes through :func:`spectral.run_graphed`, keyed on the
    shape (rows, nodes, steps), the flags and the schedule's
    :class:`stepper.ScanPlan` (its (theta, dt) runs, dividend and reset
    columns, read here from the host arrays): everything the captured
    work depends on besides the tensors' values.
    """
    dev = dyn.sigma.device
    rows = dyn.sigma.shape[0]
    plan = scan_plan(_schedule_to_device(sch, "cpu"), with_dividends)
    full = lambda x: torch.full((rows,), float(x), dtype=torch.float64, device=dev)
    tensors = (full(grid.x_min), full(grid.dx), *dyn, *_schedule_to_device(sch, dev, rows))
    if barrier is not None:
        tensors += tuple(x.expand(rows).contiguous() for x in barrier)

    def solve(*t):
        bar = BarrierSpec(*t[14:]) if barrier is not None else None
        v, _ = cn_solve(
            CNGrid(*t[:2]), CNDynamics(*t[2:8]), CNSchedule(*t[8:14]), n_nodes,
            barrier=bar, american=american, with_dividends=with_dividends,
            euro_put_lower_boundary=not american, plan=plan,
        )
        return (v,)

    if dev.type != "cuda":
        return solve(*tensors)[0]
    key = ("scalar_scan", rows, n_nodes, len(sch.dt), torch.float64, american,
           with_dividends, barrier is not None, plan)
    return run_graphed(key, solve, tensors)[0]


class AmericanFDMPricer:
    """American vanilla option on a dividend-paying equity (date-driven API).

    Mirrors the reference constructor signature (fd_american_equity.py:80)
    with curves as ``(dates, naca)`` pairs, tables with "Date" and "NACA"
    columns, or DailyNacaCurve objects. ``device``: where the solves run.
    """

    def __init__(
        self,
        spot: float,
        strike: float,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        sigma: float,
        option_type: OptionType,
        discount_curve,
        forward_curve=None,
        dividend_schedule: Optional[List[Tuple[_dt.date, float]]] = None,
        trade_id: Optional[int] = None,
        direction: str = "long",
        quantity: int = 1,
        contract_multiplier: float = 1.0,
        underlying_spot_days: int = 0,
        option_days: int = 0,
        option_settlement_days: int = 0,
        day_count: str = "ACT/365",
        grid_type: str = "uniform",
        num_space_nodes: int = 400,
        num_time_steps: int = 400,
        rannacher_steps: int = 2,
        s_max_mult: float = 4.5,
        snap_spot_to_grid: bool = True,
        snap_strike_to_grid: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        if spot <= 0 or strike <= 0 or sigma <= 0:
            raise ValueError("spot, strike and sigma must be positive.")
        if maturity_date <= valuation_date:
            raise ValueError("maturity_date must be after valuation_date.")
        opt = option_type.lower()
        if opt not in ("call", "put"):
            raise ValueError("option_type must be 'call' or 'put'.")

        self.device = resolve_device(device)
        self.spot = float(spot)
        self.strike = float(strike)
        self.valuation_date = valuation_date
        self.maturity_date = maturity_date
        self.sigma = float(sigma)
        self.option_type = opt
        self.trade_id = trade_id
        self.direction = direction
        self.quantity = int(quantity)
        self.contract_multiplier = float(contract_multiplier)

        self.day_count = normalize_convention(day_count)
        self.calendar = SouthAfricaCalendar()

        def _curve(c):
            if c is None:
                return None
            if isinstance(c, DailyNacaCurve):
                return c
            return DailyNacaCurve(c, valuation_date, day_count=self.day_count)

        self.discount_curve = _curve(discount_curve)
        self.forward_curve = _curve(forward_curve)
        self.dividend_schedule = sorted(dividend_schedule or [], key=lambda x: x[0])

        # Three time measures via business-day lags (fd_american_equity.py:204-238)
        cal = self.calendar
        self.carry_start_date = cal.add_working_days(valuation_date, underlying_spot_days)
        self.carry_end_date = cal.add_working_days(maturity_date, underlying_spot_days)
        self.discount_start_date = cal.add_working_days(valuation_date, option_days)
        self.discount_end_date = cal.add_working_days(maturity_date, option_settlement_days)

        yf = lambda a, b: year_fraction(a, b, self.day_count)
        self.time_to_expiry = yf(valuation_date, maturity_date)
        self.time_to_carry = yf(self.carry_start_date, self.carry_end_date)
        self.time_to_discount = yf(self.discount_start_date, self.discount_end_date)
        if self.time_to_expiry <= 0:
            raise ValueError("time_to_expiry must be positive.")

        self.discount_rate_nacc = self.discount_curve.get_forward_nacc_rate(
            self.discount_start_date, self.discount_end_date
        )
        if self.forward_curve is not None:
            self.carry_rate_nacc = self.forward_curve.get_forward_nacc_rate(
                self.carry_start_date, self.carry_end_date
            )
        else:
            self.carry_rate_nacc = self.discount_rate_nacc
        self.div_yield_nacc = 0.0  # discrete-dividend model: q = 0 in the PDE

        self.num_space_nodes = max(int(num_space_nodes), 3)
        self.num_time_steps = max(int(num_time_steps), 4)
        self.rannacher_steps = max(int(rannacher_steps), 0)
        self.s_max_mult = float(s_max_mult)
        self.snap_spot_to_grid = snap_spot_to_grid
        self.snap_strike_to_grid = snap_strike_to_grid

        # one grid shared by all solves (sigma bumps do not move it)
        self.grid: LogGrid = american_log_grid(
            self.spot,
            self.strike,
            self.sigma,
            self.time_to_expiry,
            self.num_space_nodes,
            self.s_max_mult,
        )
        self.s_nodes = self.grid.s_nodes
        self.spot_snapped = (
            self.grid.snapped(self.spot) if snap_spot_to_grid else self.spot
        )
        self.strike_snapped = (
            self.grid.snapped(self.strike) if snap_strike_to_grid else self.strike
        )

    # ------------------------------------------------------------------ #
    # Dividend/segment plumbing                                           #
    # ------------------------------------------------------------------ #
    def _div_times_tau(self) -> List[Tuple[float, float]]:
        """(tau_div, amount), tau measured from expiry, ascending
        (fd_american_equity.py:454-476)."""
        out = []
        for pay_date, amount in self.dividend_schedule:
            if self.valuation_date < pay_date < self.maturity_date:
                t_rel = year_fraction(self.valuation_date, pay_date, self.day_count)
                if 0.0 < t_rel < self.time_to_expiry:
                    out.append((self.time_to_expiry - t_rel, float(amount)))
        out.sort(key=lambda x: x[0])
        return out

    def _schedule(self, n_time: int) -> ScheduleArrays:
        return segmented_schedule(
            self.time_to_expiry,
            n_time,
            self._div_times_tau(),
            rannacher_steps=self.rannacher_steps,
            restart_rannacher_at_div=(self.option_type == "call"),
        )

    def _solve(self, n_time: int, sigmas: List[float]) -> np.ndarray:
        """One batched solve: (len(sigmas), n_nodes) grids on the host."""
        dyn = _dynamics(
            self.device, self.strike_snapped, self.option_type == "call", sigmas,
            self.discount_rate_nacc, self.carry_rate_nacc,
        )
        has_div = len(self._div_times_tau()) > 0
        v = _solve_batch(self.grid, dyn, self._schedule(n_time), self.grid.n_nodes, has_div)
        return v.cpu().numpy()

    # ------------------------------------------------------------------ #
    # Price & Greeks                                                      #
    # ------------------------------------------------------------------ #
    def _interp_price(self, v: np.ndarray) -> float:
        return float(np.interp(self.spot_snapped, self.s_nodes, v))

    def _delta_gamma(self, v: np.ndarray) -> Tuple[float, float]:
        idx = int(np.clip(np.argmin(np.abs(self.s_nodes - self.spot_snapped)), 1, len(self.s_nodes) - 3))
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))[None]
        d, g = local_cubic_fit(t(self.s_nodes), t(v), t(self.spot_snapped), torch.tensor([idx]))
        return float(d[0]), float(g[0])

    def price_log(self, n_time: Optional[int] = None) -> float:
        n = int(n_time) if n_time is not None else self.num_time_steps
        v = self._solve(n, [self.sigma])[0]
        return self._interp_price(v)

    def price_log2(self, apply_ko: bool = True, use_richardson: bool = True) -> float:
        """Richardson price. NOTE: preserves the reference quirk of using
        2*num_space_nodes (not 2*num_time_steps) as the refined step count
        (fd_american_equity.py:944-952)."""
        if not use_richardson:
            return self.price_log(self.num_time_steps)
        p_n = self.price_log(self.num_time_steps)
        p_2n = self.price_log(2 * self.num_space_nodes)
        return (4.0 * p_2n - p_n) / 3.0

    def greeks_log2(
        self, dv_sigma: float = 0.01, use_richardson: bool = True
    ) -> Dict[str, float]:
        """Price/delta/gamma/vega/theta (fd_american_equity.py:970-1068).

        All N-step solves (base + 4 vega bumps) run as ONE batched solve;
        the 2N Richardson solve is a second.
        """
        sig0, h = self.sigma, dv_sigma
        if use_richardson:
            sigmas = [sig0, sig0 + h, sig0 - h, sig0 + 2 * h, sig0 - 2 * h]
        else:
            sigmas = [sig0, sig0 + h, sig0 - h]
        v_all = self._solve(self.num_time_steps, sigmas)
        v_n = v_all[0]
        price_n = self._interp_price(v_n)
        delta_n, gamma_n = self._delta_gamma(v_n)

        if use_richardson:
            v_2n = self._solve(2 * self.num_time_steps, [sig0])[0]
            price_2n = self._interp_price(v_2n)
            delta_2n, gamma_2n = self._delta_gamma(v_2n)
            price = (4.0 * price_2n - price_n) / 3.0
            delta = (4.0 * delta_2n - delta_n) / 3.0
            gamma = (4.0 * gamma_2n - gamma_n) / 3.0

            p_up_h, p_dn_h = self._interp_price(v_all[1]), self._interp_price(v_all[2])
            p_up_2h, p_dn_2h = self._interp_price(v_all[3]), self._interp_price(v_all[4])
            fd_h = (p_up_h - p_dn_h) / (2.0 * h)
            fd_2h = (p_up_2h - p_dn_2h) / (4.0 * h)
            dv_dsigma = (4.0 * fd_h - fd_2h) / 3.0
        else:
            price, delta, gamma = price_n, delta_n, gamma_n
            p_up, p_dn = self._interp_price(v_all[1]), self._interp_price(v_all[2])
            dv_dsigma = (p_up - p_dn) / (2.0 * h)

        vega = dv_dsigma / 100.0

        r, b, s0 = self.discount_rate_nacc, self.carry_rate_nacc, self.spot
        theta = -(
            0.5 * sig0 * sig0 * s0 * s0 * gamma + b * s0 * delta - r * price
        )
        return {
            "price": float(price),
            "delta": float(delta),
            "gamma": float(gamma),
            "vega": float(vega),
            "theta": float(theta),
        }
