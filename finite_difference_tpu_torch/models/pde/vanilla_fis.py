"""FA-exact vanilla option pricer (the FIS/Front-Arena validation harness).

Counterpart of ``finite_difference_tpu.models.pde.vanilla_fis``. Native (QuantLib-free) re-implementation of the reference's
``VanillaOptionPricerTest`` (vanilla_option_pricer_test.py:10-420), the
harness the validation notebook prices FA trades with:

- Effective underlying quote: cash settlement uses the escrowed spot
  s_cash = S - PV(divs) (ITM calls keep S); physical uses
  S * e^{-q*T_carry} * e^{-r_disc * tau(val->carry_start)} (:140-156).
- The engine's risk-free AND drift curve are both the flat carry rate
  (forward NACC over the carry window, :118-135), dividend curve flat 0.
- Engine tenor runs valuation -> discount_end; American exercise spans
  [discount_start, discount_end].
- Cash-settlement PV adjustment corr_cash =
  exp(-fwd_nacc(maturity -> carry_end) * tau(maturity, carry_end)) (:360-375).
- FIS grid sizing: x-nodes M = ceil(N*L / (2 sigma T*^{1.5})) with
  L = 2*K_DOMAIN*sigma*sqrt(T_disc), T* = min(T_disc, first div time),
  minimum 30/30 nodes/steps (:308-340); time grid aligned to dividends;
  Rannacher damping_steps=2; Richardson (4 P_N - P_{N/2})/3 (:377-391).

The PDE engine is the shared batched CN scan (``american._solve_batch``)
on the pricer's ``device``, replayed from a CUDA graph on a card.
"""
from __future__ import annotations

import datetime as _dt
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.calendars import SouthAfricaCalendar
from ...utils.curves import DailyNacaCurve
from ...utils.daycount import normalize_convention, year_fraction
from .american import _dynamics, _solve_batch
from .grid import LogGrid, american_log_grid, segmented_schedule


class VanillaOptionPricerFIS:
    """American/European vanilla priced the way Front Arena does (via the
    reference's QL harness semantics), on the CN scan. ``device``: where
    the solves run."""

    K_DOMAIN = 3
    XGRID_MIN = 30
    TGRID_MIN = 30
    USE_RICHARDSON = True

    def __init__(
        self,
        spot_price: float,
        strike_price: float,
        volatility: float,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        discount_curve,
        forward_curve=None,
        dividend_schedule: Optional[List[Tuple[_dt.date, float]]] = None,
        contracts: int = 1,
        contract_multiplier: float = 1.0,
        side: str = "buy",
        option_type: str = "put",
        exercise_type: str = "american",
        option_spot_days: int = 0,
        option_settlement_days: int = 0,
        underlying_spot_days: int = 3,
        settlement_type: str = "cash",
        day_count: str = "ACT/365",
        trade_number: Optional[int] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        self.spot_price = float(spot_price)
        self.strike_price = float(strike_price)
        self.volatility = float(volatility)
        self.valuation_date = valuation_date
        self.maturity_date = maturity_date
        self.option_type = option_type.lower()
        self.exercise_type = exercise_type.lower()
        self.settlement_type = settlement_type.lower()
        self.contracts = int(contracts)
        self.contract_multiplier = float(contract_multiplier)
        self._side_sign = +1 if side.lower() in ("buy", "long", "+", "b") else -1
        self.trade_number = trade_number
        self.option_spot_days = int(option_spot_days)
        self.option_settlement_days = int(option_settlement_days)
        self.underlying_spot_days = int(underlying_spot_days)
        self.day_count = normalize_convention(day_count)
        self.calendar = SouthAfricaCalendar()

        def _curve(c):
            if c is None:
                return None
            if isinstance(c, DailyNacaCurve):
                return c
            return DailyNacaCurve(c, valuation_date, day_count=self.day_count)

        self.discount_curve = _curve(discount_curve)
        self.forward_curve = _curve(forward_curve) or self.discount_curve
        self.dividend_schedule = sorted(dividend_schedule or [], key=lambda x: x[0])

        cal = self.calendar
        yf = lambda a, b: year_fraction(a, b, self.day_count)
        self.time_to_expiry = yf(valuation_date, maturity_date)
        self.carry_start = cal.add_working_days(valuation_date, underlying_spot_days)
        if self.settlement_type == "physical":
            self.carry_end = cal.add_working_days(maturity_date, option_settlement_days)
        else:
            self.carry_end = cal.add_working_days(maturity_date, underlying_spot_days)
        self.time_to_carry = yf(self.carry_start, self.carry_end)
        self.discount_start = cal.add_working_days(valuation_date, option_spot_days)
        self.discount_end = cal.add_working_days(maturity_date, option_settlement_days)
        # NOTE: reference measures time_to_discount from *valuation*
        # (vanilla_option_pricer_test.py:101-106)
        self.time_to_discount = yf(valuation_date, self.discount_end)

        dc = self.discount_curve
        self.discount_rate = math.log1p(dc.naca(self.discount_end))
        self.carry_rate = self.forward_curve.get_forward_nacc_rate(
            self.carry_start, self.carry_end
        )
        self.pv_dividends = self._pv_dividends()
        self.dividend_yield = self._dividend_yield_nacc()

        # Effective underlying quote (:140-156)
        tau_v_cs = yf(valuation_date, self.carry_start)
        self.s_physical = (
            self.spot_price
            * math.exp(-self.dividend_yield * self.time_to_carry)
            * math.exp(-self.discount_rate * tau_v_cs)
        )
        if self.option_type == "call":
            self.s_cash = (
                self.spot_price
                if self.spot_price > self.strike_price
                else self.spot_price - self.pv_dividends
            )
        else:
            self.s_cash = self.spot_price - self.pv_dividends
        self.s_eff = self.s_physical if self.settlement_type == "physical" else self.s_cash

        # Cash-settlement PV adjustment (:360-375)
        tau_mat_ce = yf(maturity_date, self.carry_end)
        if self.settlement_type == "physical" or tau_mat_ce <= 0.0:
            self.settle_adjustment = 1.0
        else:
            corr_nacc = self.forward_curve.get_forward_nacc_rate(
                maturity_date, self.carry_end
            )
            self.settle_adjustment = math.exp(-corr_nacc * tau_mat_ce)

    # ------------------------------------------------------------------ #
    def _pv_dividends(self) -> float:
        """PV dividends to carry_start with forward NACC discounting
        (vanilla_option_pricer_test.py:228-243)."""
        pv = 0.0
        for pay_date, amount in self.dividend_schedule:
            if pay_date <= self.carry_start:
                continue
            tau = year_fraction(self.carry_start, pay_date, self.day_count)
            fwd = self.forward_curve.get_forward_nacc_rate(self.carry_start, pay_date)
            pv += amount * math.exp(-fwd * tau)
        return pv

    def _dividend_yield_nacc(self) -> float:
        pv = self.pv_dividends
        if pv <= 0.0:
            return 0.0
        if self.spot_price <= pv:
            raise ValueError("PV(dividends) >= spot.")
        return -math.log((self.spot_price - pv) / self.spot_price) / max(
            1e-12, self.time_to_carry
        )

    # ------------------------------------------------------------------ #
    # FIS grid rules (:308-340)                                           #
    # ------------------------------------------------------------------ #
    def _div_taus(self) -> List[float]:
        return sorted(
            year_fraction(self.carry_start, d, self.day_count)
            for d, _ in self.dividend_schedule
        )

    def _nearest_horizon_T(self) -> float:
        t_disc = max(1e-12, self.time_to_discount)
        taus = [t for t in self._div_taus() if t > 0]
        if not taus:
            return t_disc
        return max(1e-12, min(t_disc, taus[0]))

    def _domain_width_L(self) -> float:
        t = max(1e-12, self.time_to_discount)
        return 2.0 * self.K_DOMAIN * self.volatility * math.sqrt(t)

    def _xgrid_for(self, t_steps: int) -> int:
        n = max(self.TGRID_MIN, int(t_steps))
        t_star = self._nearest_horizon_T()
        L = self._domain_width_L()
        m = int(math.ceil((n * L) / (2.0 * self.volatility * (t_star**1.5))))
        return max(self.XGRID_MIN, m)

    def _align_tgrid_to_dividends(self, n: int) -> int:
        tau_total = max(1e-12, self.time_to_discount)
        div_taus = [t for t in self._div_taus() if 0 < t < tau_total]
        if not div_taus:
            return n
        for trial in range(n, n + 100):
            if all(
                abs(t / tau_total * trial - round(t / tau_total * trial)) <= 1e-6
                for t in div_taus
            ):
                return trial
        return n

    # ------------------------------------------------------------------ #
    # Pricing                                                             #
    # ------------------------------------------------------------------ #
    def _price_once(self, t_steps: int, sigma: Optional[float] = None) -> float:
        sigma = self.volatility if sigma is None else sigma
        n_base = max(self.TGRID_MIN, int(t_steps))
        n = self._align_tgrid_to_dividends(n_base)
        m = self._xgrid_for(n)

        t_engine = max(self.time_to_discount, 1e-12)
        grid_h: LogGrid = american_log_grid(
            self.s_eff, self.strike_price, sigma, t_engine, m, s_max_mult=2.0 * self.K_DOMAIN
        )
        divs_tau = [
            (t_engine - t, a)
            for (d, a), t in zip(self.dividend_schedule, self._div_taus())
            if 0.0 < t < t_engine
        ]
        # Cash-settled puts/OTM calls escrow dividends into s_eff; the
        # explicit jump path is used for ITM calls only (QL engine branch,
        # vanilla_option_pricer_test.py:342-358)
        use_jump_divs = (
            self.option_type == "call"
            and self.spot_price > self.strike_price
            and len(divs_tau) > 0
        )
        sch_np = segmented_schedule(
            t_engine,
            n,
            divs_tau if use_jump_divs else [],
            rannacher_steps=2,
            restart_rannacher_at_div=(self.option_type == "call"),
        )
        # QL process: risk-free = drift = the carry curve
        dyn = _dynamics(
            self.device, self.strike_price, self.option_type == "call", [sigma],
            self.carry_rate, self.carry_rate,
        )
        v = _solve_batch(
            grid_h, dyn, sch_np, grid_h.n_nodes, use_jump_divs,
            # the reference builds the QL exercise object from this
            # flag (vanilla_option_pricer_test.py:271-280); European
            # must NOT pick up the early-exercise projection
            american=(self.exercise_type == "american"),
        )[0].cpu().numpy()
        pv = float(np.interp(self.s_eff, grid_h.s_nodes, v))
        return pv * self.settle_adjustment

    def price(self, time_steps: int) -> float:
        p_n = self._price_once(time_steps)
        if not self.USE_RICHARDSON:
            return self._scale(p_n)
        half = max(self.TGRID_MIN, int(time_steps) // 2)
        p_h = self._price_once(half)
        return self._scale((4.0 * p_n - p_h) / 3.0)

    def batch_price(self, time_steps_list: List[int]) -> Dict[int, float]:
        return {int(n): self.price(int(n)) for n in time_steps_list}

    def _scale(self, x: float) -> float:
        return self._side_sign * self.contracts * self.contract_multiplier * x

    def calculate_greeks(
        self, time_steps: int = 1000, ds_rel: float = 0.001, dsigma: float = 0.001
    ) -> Dict[str, float]:
        """Bump-and-revalue greeks at N=time_steps (notebook cell 4 uses 1000).
        All repriced clones are unscaled (side=buy, 1 contract)."""

        def reprice(spot=None, sigma=None):
            clone = VanillaOptionPricerFIS(
                spot_price=spot if spot is not None else self.spot_price,
                strike_price=self.strike_price,
                volatility=sigma if sigma is not None else self.volatility,
                valuation_date=self.valuation_date,
                maturity_date=self.maturity_date,
                discount_curve=self.discount_curve,
                forward_curve=self.forward_curve,
                dividend_schedule=self.dividend_schedule,
                contracts=1,
                contract_multiplier=1.0,
                side="buy",
                option_type=self.option_type,
                exercise_type=self.exercise_type,
                option_spot_days=self.option_spot_days,
                option_settlement_days=self.option_settlement_days,
                underlying_spot_days=self.underlying_spot_days,
                settlement_type=self.settlement_type,
                day_count=self.day_count,
                device=self.device,
            )
            return clone.price(time_steps)

        base = reprice()
        ds = self.spot_price * ds_rel
        p_up = reprice(spot=self.spot_price + ds)
        p_dn = reprice(spot=self.spot_price - ds)
        delta = (p_up - p_dn) / (2 * ds)
        gamma = (p_up - 2 * base + p_dn) / (ds * ds)
        vega = (reprice(sigma=self.volatility + dsigma) - base) / (100 * dsigma)
        theta_ann = -(
            0.5 * self.volatility**2 * self.spot_price**2 * gamma
            + self.carry_rate * self.spot_price * delta
            - self.discount_rate * base
        )
        scale = self._side_sign * self.contracts * self.contract_multiplier
        return {
            "Price": scale * base,
            "Delta": scale * delta,
            "Gamma": scale * gamma,
            "Vega": scale * vega,
            "Theta (Annual)": scale * theta_ann,
            "Theta (Daily)": scale * theta_ann / 365.0,
        }
