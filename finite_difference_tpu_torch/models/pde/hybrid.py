"""Hybrid analytic / Crank-Nicolson discrete-barrier pricer.

Counterpart of ``finite_difference_tpu.models.pde.hybrid``. Capability parity with the reference's
``discrete_barrier_analytic_pricer.py:52-660``
(DiscreteBarrierFDMPricerAnalytic):

- the FIS n_lim monitoring decision (:278-342): equidistant dt = T/n
  (n = 400), n_m = max(n_min, round(t_m/dt)) per monitor interval; when
  sum(n_m) > n_lim * n the pricer switches to a CONTINUOUS approximation
  between the first and last monitor with BGK-shifted barriers
  H/adj, H*adj, adj = exp(beta * sigma * sqrt(dt_avg)), beta = 0.5826;
- continuous branch -> Reiner-Rubinstein / Douady analytic engines with
  the shifted barriers; FAIL-SAFE fallback to a CN solve projecting every
  step in the monitor window (:440-531);
- discrete branch -> CN projecting only at monitor steps;
- knock-ins via vanilla(CN) - KO (:551-562);
- escrowed spot (S_eff = S - PV divs) used for interpolation (:538-566);
- one-sided delta near the (shifted) barrier (:573-616).

The CN overlay here is the framework's log-S scan (``american._solve_batch``,
replayed from a CUDA graph on a card) rather than the reference's S-space
scalar loops; it and the analytic engines run on the pricer's ``device``.
"""
from __future__ import annotations

import datetime as _dt
import math
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.curves import DailyNacaCurve
from ...utils.daycount import normalize_convention, year_fraction
from ..analytic.double_barrier import DoubleBarrier
from ..analytic.reiner_rubinstein import BarrierEngine
from .american import _barrier, _dynamics, _solve_batch
from .grid import LogGrid, barrier_log_grid, uniform_schedule

OptionType = Literal["call", "put"]
BarrierType = Literal[
    "none",
    "down-and-out", "up-and-out", "double-out",
    "down-and-in", "up-and-in", "double-in",
]


class DiscreteBarrierFDMPricerAnalytic:
    BGK_BETA = 0.5826  # Broadie-Glasserman-Kou continuity-correction constant

    def __init__(
        self,
        trade_id: str = "T-0001",
        direction: Literal["long", "short"] = "long",
        quantity: int = 1,
        contract_multiplier: float = 1.0,
        *,
        option_type: OptionType = "call",
        barrier_type: BarrierType = "none",
        strike: float,
        lower_barrier: Optional[float] = None,
        upper_barrier: Optional[float] = None,
        rebate_amount: float = 0.0,
        rebate_timing_in: Optional[str] = None,
        rebate_timing_out: Optional[str] = None,
        barrier_status: Optional[str] = None,
        spot: float = 100.0,
        volatility: float = 0.20,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        monitoring_dates: Optional[List[_dt.date]] = None,
        discount_curve: Any = None,
        forward_curve: Any = None,
        dividend_schedule: Optional[List[Tuple[_dt.date, float]]] = None,
        day_count: str = "ACT/365",
        time_steps: int = 600,
        space_nodes: int = 600,
        rannacher_steps: int = 2,
        n_desired_for_decision: int = 400,
        n_min_steps_per_interval: int = 1,
        n_lim_multiplier: int = 5,
        device=DEFAULT_DEVICE,
    ) -> None:
        if spot <= 0 or strike <= 0 or volatility <= 0:
            raise ValueError("spot, strike, volatility must be positive.")
        if maturity_date <= valuation_date:
            raise ValueError("maturity_date must be after valuation_date.")

        self.device = resolve_device(device)
        self.trade_id = trade_id
        self.direction = direction
        self.quantity = int(quantity)
        self.contract_multiplier = float(contract_multiplier)
        self.option_type = option_type
        self.barrier_type = barrier_type
        self.strike = float(strike)
        self.lower_barrier = lower_barrier
        self.upper_barrier = upper_barrier
        self.rebate_amount = float(rebate_amount)
        self.rebate_timing_in = rebate_timing_in
        self.rebate_timing_out = rebate_timing_out
        self.barrier_status = barrier_status
        self.spot = float(spot)
        self.sigma = float(volatility)
        self.valuation_date = valuation_date
        self.maturity_date = maturity_date
        self.monitoring_dates = sorted(monitoring_dates or [])
        self.dividend_schedule = dividend_schedule or []
        self.day_count = normalize_convention(day_count)
        self.time_steps = int(time_steps)
        self.space_nodes = int(space_nodes)
        self.rannacher_steps = int(rannacher_steps)
        self.n_desired_for_decision = int(n_desired_for_decision)
        self.n_min_steps_per_interval = int(n_min_steps_per_interval)
        self.n_lim_multiplier = int(n_lim_multiplier)

        self.tenor_years = self._yf(valuation_date, maturity_date)

        def _curve(c):
            if c is None:
                return None
            if isinstance(c, DailyNacaCurve):
                return c
            return DailyNacaCurve(c, valuation_date)

        self.discount_curve = _curve(discount_curve)
        self.forward_curve = _curve(forward_curve) or self.discount_curve

        self.flat_rate_r = (
            float(
                self.discount_curve.get_forward_nacc_rate(
                    valuation_date, maturity_date
                )
            )
            if self.discount_curve is not None
            else 0.0
        )
        pv_divs = self._pv_dividends()
        self.flat_dividend_q = (
            -math.log(max(1e-12, 1.0 - pv_divs / self.spot)) / self.tenor_years
            if pv_divs > 0
            else 0.0
        )
        self.flat_carry_b = self.flat_rate_r - self.flat_dividend_q

        (
            self.use_continuous_window,
            self._win_k0,
            self._win_k1,
            self.bgk_lower_barrier,
            self.bgk_upper_barrier,
            self.monitor_steps_discrete,
            self.monitor_steps_continuous,
        ) = self._monitoring_decision_and_bgk_shift()

    # ------------------------------------------------------------------

    def _yf(self, d0: _dt.date, d1: _dt.date) -> float:
        return year_fraction(d0, d1, self.day_count)

    def _pv_dividends(self) -> float:
        if not self.dividend_schedule or self.discount_curve is None:
            return 0.0
        pv = 0.0
        for pay_date, cash in self.dividend_schedule:
            if self.valuation_date < pay_date <= self.maturity_date and cash:
                pv += cash * float(self.discount_curve.get_discount_factor(pay_date))
        return pv

    def _escrowed_spot(self) -> float:
        return self.spot - self._pv_dividends()

    # ------------------------------------------------------------------
    # FIS n_lim decision (discrete_barrier_analytic_pricer.py:278-342)
    # ------------------------------------------------------------------

    def _monitoring_decision_and_bgk_shift(self):
        if self.barrier_type == "none" or not self.monitoring_dates:
            return (False, None, None, self.lower_barrier, self.upper_barrier, {}, {})
        md = sorted(
            d for d in self.monitoring_dates
            if self.valuation_date < d <= self.maturity_date
        )
        if not md:
            return (False, None, None, self.lower_barrier, self.upper_barrier, {}, {})

        dt_eq = self.tenor_years / max(1, self.n_desired_for_decision)
        intervals = [self._yf(a, b) for a, b in zip(md[:-1], md[1:])] or [
            self.tenor_years / len(md)
        ]
        steps_per_interval = [
            max(self.n_min_steps_per_interval, int(round(ti / max(1e-12, dt_eq))))
            for ti in intervals
        ]
        use_continuous = (
            sum(steps_per_interval)
            > self.n_lim_multiplier * self.n_desired_for_decision
        )

        dt_grid = self.tenor_years / self.time_steps
        monitor_steps_discrete = {
            max(0, min(self.time_steps, int(round(self._yf(self.valuation_date, d) / dt_grid)))): True
            for d in md
        }
        monitor_steps_continuous: Dict[int, bool] = {}
        if use_continuous:
            k0 = int(round(self._yf(self.valuation_date, md[0]) / dt_grid))
            k1 = int(round(self._yf(self.valuation_date, md[-1]) / dt_grid))
            k0, k1 = sorted(
                (max(0, min(self.time_steps, k0)), max(0, min(self.time_steps, k1)))
            )
            for k in range(k0, k1 + 1):
                monitor_steps_continuous[k] = True
            avg_dt = sum(intervals) / len(intervals)
            adj = math.exp(self.BGK_BETA * self.sigma * math.sqrt(max(1e-12, avg_dt)))
            Hdn = self.lower_barrier / adj if self.lower_barrier is not None else None
            Hup = self.upper_barrier * adj if self.upper_barrier is not None else None
            return (True, k0, k1, Hdn, Hup, monitor_steps_discrete, monitor_steps_continuous)

        return (
            False, None, None, self.lower_barrier, self.upper_barrier,
            monitor_steps_discrete, monitor_steps_continuous,
        )

    # ------------------------------------------------------------------
    # CN overlay on the framework stepper
    # ------------------------------------------------------------------

    def _cn_price(
        self,
        lower: Optional[float],
        upper: Optional[float],
        monitor_steps: Dict[int, bool],
        s_eval: float,
    ) -> float:
        t = self.tenor_years
        n = self.time_steps
        dt_grid = t / n
        monitor_times = [k * dt_grid for k in monitor_steps if k > 0]

        g = barrier_log_grid(
            spot_eff=self._escrowed_spot(),
            strike=self.strike,
            sigma=self.sigma,
            t_expiry=t,
            num_time_steps=n,
            lower_barrier=lower,
            upper_barrier=upper,
            num_space_nodes=self.space_nodes,
        )
        sch = uniform_schedule(t, n, self.rannacher_steps, monitor_times)
        dyn = _dynamics(
            self.device, self.strike, self.option_type == "call", [self.sigma],
            self.flat_rate_r, self.flat_carry_b,
        )
        barrier = None
        if lower is not None or upper is not None:
            barrier = _barrier(
                self.device,
                lower if lower is not None else 0.0,
                upper if upper is not None else 0.0,
                lower is not None,
                upper is not None,
                self.rebate_amount,
                self.rebate_timing_out == "hit",
                self.flat_rate_r,
            )
        n_nodes = self.space_nodes + 1
        v = _solve_batch(
            LogGrid(g.x_min, g.dx, n_nodes), dyn, sch, n_nodes, False, american=False,
            barrier=barrier,
        )[0]
        s_grid = np.exp(g.x_min + g.dx * np.arange(n_nodes))
        return float(np.interp(s_eval, s_grid, v.cpu().numpy()))

    # ------------------------------------------------------------------
    # Branches (discrete_barrier_analytic_pricer.py:453-536)
    # ------------------------------------------------------------------

    def _can_use_single_barrier_analytic(self) -> bool:
        if self.barrier_type not in (
            "down-and-out", "up-and-out", "down-and-in", "up-and-in"
        ):
            return False
        H = self.lower_barrier if "down" in self.barrier_type else self.upper_barrier
        if H is None or H <= 0.0:
            return False
        if self.barrier_status is not None:
            return False
        if self.rebate_timing_in not in (None, "hit", "expiry"):
            return False
        if self.rebate_timing_out not in (None, "hit", "expiry"):
            return False
        return True

    def _continuous_branch_analytic(self, S_eff: float) -> float:
        if self.barrier_type in ("double-out", "double-in"):
            if self.bgk_lower_barrier is None or self.bgk_upper_barrier is None:
                return self._continuous_branch_cn(S_eff)
            try:
                engine = DoubleBarrier(
                    S=S_eff, X=self.strike,
                    L=self.bgk_lower_barrier, U=self.bgk_upper_barrier,
                    sigma=self.sigma,
                    callflag="c" if self.option_type == "call" else "p",
                    inflag="in" if "in" in self.barrier_type else "out",
                    m=6,
                    device=self.device,
                )
                return float(
                    engine.price(
                        b=self.flat_carry_b, r=self.flat_rate_r, T=self.tenor_years
                    )
                )
            except ValueError:  # the engine refuses the inputs
                return self._continuous_branch_cn(S_eff)

        if not self._can_use_single_barrier_analytic():
            return self._continuous_branch_cn(S_eff)
        shifted_H = (
            self.bgk_lower_barrier
            if "down" in self.barrier_type
            else self.bgk_upper_barrier
        )
        if shifted_H is None:
            return self._continuous_branch_cn(S_eff)
        try:
            engine = BarrierEngine(
                s=S_eff, b=self.flat_carry_b, r=self.flat_rate_r,
                t=self.tenor_years, x=self.strike, sigma=self.sigma,
                h=shifted_H,
                optionflag="c" if self.option_type == "call" else "p",
                directionflag="d" if "down" in self.barrier_type else "u",
                in_out_flag="i" if "in" in self.barrier_type else "o",
                k=self.rebate_amount,
                barrier_status=self.barrier_status,
                rebate_timing_in=self.rebate_timing_in,
                rebate_timing_out=self.rebate_timing_out,
                device=self.device,
            )
            return float(engine.price())
        except ValueError:  # the engine refuses the inputs
            return self._continuous_branch_cn(S_eff)

    def _continuous_branch_cn(self, S_eff: float) -> float:
        return self._cn_price(
            self.bgk_lower_barrier, self.bgk_upper_barrier,
            self.monitor_steps_continuous, S_eff,
        )

    def _discrete_branch_cn(self, S_eff: float) -> float:
        return self._cn_price(
            self.lower_barrier, self.upper_barrier,
            self.monitor_steps_discrete, S_eff,
        )

    def _ki_rebate_leg(self) -> float:
        """R*DF(T): the never-knocked-in rebate leg (RR term E) in the
        parity KI(R) = vanilla - KO(R at expiry) + R*DF — the identity
        used by barrier.price_log2, instruments/equity_barrier, and the
        device surface kernel. The reference's parity branch drops this
        leg (discrete_barrier_analytic_pricer.py:545-552)."""
        if not self.rebate_amount:
            return 0.0
        return self.rebate_amount * math.exp(
            -self.flat_rate_r * self.tenor_years
        )

    # ------------------------------------------------------------------
    # Public API (discrete_barrier_analytic_pricer.py:538-616)
    # ------------------------------------------------------------------

    def price(self) -> float:
        S_eff = self._escrowed_spot()

        if self.barrier_type in ("down-and-in", "up-and-in", "double-in"):
            vanilla = self._cn_price(None, None, {}, S_eff)
            if self.use_continuous_window:
                # analytic IN engines price directly (the RR engine owns
                # the IN rebate conventions); fall back to parity against
                # the continuous KO otherwise
                if self.barrier_type != "double-in" and self._can_use_single_barrier_analytic():
                    base_price = self._continuous_branch_analytic(S_eff)
                else:
                    out_type = self.barrier_type.replace("in", "out")
                    saved = (self.barrier_type, self.rebate_timing_out)
                    try:
                        self.barrier_type = out_type  # type: ignore[assignment]
                        self.rebate_timing_out = "expiry"
                        ko_val = self._continuous_branch_analytic(S_eff)
                    finally:
                        self.barrier_type, self.rebate_timing_out = saved
                    base_price = vanilla - ko_val + self._ki_rebate_leg()
            else:
                saved_timing = self.rebate_timing_out
                try:
                    self.rebate_timing_out = "expiry"
                    ko_val = self._discrete_branch_cn(S_eff)
                finally:
                    self.rebate_timing_out = saved_timing
                base_price = vanilla - ko_val + self._ki_rebate_leg()
        else:
            if self.use_continuous_window:
                base_price = self._continuous_branch_analytic(S_eff)
            else:
                base_price = self._discrete_branch_cn(S_eff)

        sign = 1.0 if self.direction == "long" else -1.0
        return float(sign * self.quantity * self.contract_multiplier * base_price)

    def _refresh_derived(self) -> None:
        """Recompute bump-dependent derived state: the escrowed-dividend
        flat q depends on spot, the BGK-shifted window on sigma. The
        reference computes both ONCE in __init__ and bumps in place
        (discrete_barrier_analytic_pricer.py:573-607), so its vega misses
        the barrier-shift sensitivity exp(beta*sigma*sqrt(dt)) (largest
        near the barrier) and its delta/gamma reprice dividend payers
        with a stale q — deviation: refreshed here on every bump."""
        pv_divs = self._pv_dividends()
        self.flat_dividend_q = (
            -math.log(max(1e-12, 1.0 - pv_divs / self.spot)) / self.tenor_years
            if pv_divs > 0
            else 0.0
        )
        self.flat_carry_b = self.flat_rate_r - self.flat_dividend_q
        (
            self.use_continuous_window,
            self._win_k0,
            self._win_k1,
            self.bgk_lower_barrier,
            self.bgk_upper_barrier,
            self.monitor_steps_discrete,
            self.monitor_steps_continuous,
        ) = self._monitoring_decision_and_bgk_shift()

    def greeks(
        self, rel_spot_bump: float = 1e-4, abs_vol_bump: float = 1e-4
    ) -> Dict[str, float]:
        save = (self.direction, self.quantity, self.contract_multiplier)
        self.direction, self.quantity, self.contract_multiplier = "long", 1, 1.0

        base_px = self.price()
        s0 = self.spot
        ds = max(1e-8, rel_spot_bump * s0)

        def near_barrier(S: float) -> bool:
            # ~2 grid cells in S around the (shifted) barrier
            tol = 2.0 * S * 6.0 * self.sigma * math.sqrt(self.tenor_years) / self.space_nodes
            Hdn = self.bgk_lower_barrier if self.use_continuous_window else self.lower_barrier
            Hup = self.bgk_upper_barrier if self.use_continuous_window else self.upper_barrier
            return (Hdn is not None and abs(S - Hdn) <= tol) or (
                Hup is not None and abs(S - Hup) <= tol
            )

        sig0 = self.sigma
        try:
            self.spot = s0 + ds
            self._refresh_derived()
            up = self.price()
            self.spot = s0 - ds
            self._refresh_derived()
            dn = self.price()
            self.spot = s0
            self._refresh_derived()

            if self.use_continuous_window and near_barrier(s0):
                delta = (base_px - dn) / ds
            else:
                delta = (up - dn) / (2 * ds)
            gamma = (up - 2 * base_px + dn) / (ds * ds)

            self.sigma = sig0 + abs_vol_bump
            self._refresh_derived()
            upv = self.price()
            self.sigma = sig0 - abs_vol_bump
            self._refresh_derived()
            dnv = self.price()
        finally:
            self.spot, self.sigma = s0, sig0
            self._refresh_derived()
        vega = (upv - dnv) / (2 * abs_vol_bump)

        self.direction, self.quantity, self.contract_multiplier = save
        sign = 1.0 if self.direction == "long" else -1.0
        scale = sign * self.quantity * self.contract_multiplier
        return {
            "delta": scale * float(delta),
            "gamma": scale * float(gamma),
            "vega": scale * float(vega),
        }

    def print_details(self) -> None:
        print(f"==== Discrete Barrier Option (Hybrid Analytic + CN) ====")
        print(f"trade {self.trade_id}: {self.option_type} {self.barrier_type}")
        print(
            f"S={self.spot} K={self.strike} sigma={self.sigma} "
            f"T={self.tenor_years:.6f} r={self.flat_rate_r:.6f} "
            f"b={self.flat_carry_b:.6f}"
        )
        print(
            f"continuous window: {self.use_continuous_window} "
            f"BGK barriers: {self.bgk_lower_barrier} / {self.bgk_upper_barrier}"
        )
        print(f"price: {self.price():.10g}")
