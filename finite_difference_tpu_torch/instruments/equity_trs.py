"""Equity total return swap (the port's copy of
``finite_difference_tpu.instruments.equity_trs``, host numpy).

Capability parity with the reference's ``equity_trs.py:19-586``:

- return leg with the three period cases (future / in-progress /
  completed-but-unpaid), equity forwards on pathwise carry + dividend
  curves, optional spot settlement lag shifting forward tenors;
- "Price" vs "Initial Price" nominal scaling on both legs ("Price" resets
  the notional to F(T_{i-1}) x quantity per period);
- interest leg through the shared ``leg_pv`` (fixed/floating/OIS), with an
  optional per-period notional schedule when interest scaling is "Price";
- reset stamping interface: interest-leg floating resets via
  ``get_reset_dates``/``compute_fixings``/``compute_cf_increment``; equity
  spot resets via ``get_equity_reset_schedule`` /
  ``_compute_equity_fixing_for_date`` (start AND end dates — end resets
  cover completed-but-unpaid periods).
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..market_data.risk_factor import CurveSlice, ScalarSlice
from ..market_data.yield_curve import YieldCurve
from .cashflow import LegType, SwapLeg, leg_pv
from .equity_pv import (
    compute_period_year_fractions,
    equity_forward_price,
    filter_future_periods,
    trs_return_leg_pv,
)
from .instrument import Instrument
from .schedule import ScheduleConfig, add_months, adjust


class EquityTRS(Instrument):
    def __init__(
        self,
        name: str,
        effective_date: dt.date,
        maturity_date: dt.date,
        quantity: float,
        notional: float,
        interest_leg: SwapLeg,
        spot_name: str,
        carry_curve_name: str,
        dividend_curve_name: str,
        discount_curve_name: str,
        schedule_config: Optional[ScheduleConfig] = None,
        return_frequency: Optional[int] = None,
        initial_price: Optional[float] = None,
        return_nominal_scaling: str = "Price",
        interest_nominal_scaling: str = "Initial Price",
        is_receiver: bool = True,
        spot_lag: int = 0,
        include_sim_date_cashflows: bool = False,
        **schedule_kwargs,
    ):
        super().__init__(name)
        self.effective_date = effective_date
        self.maturity_date = maturity_date
        self.quantity = float(quantity)
        self.notional = float(notional)
        self.interest_leg = interest_leg
        self.spot_name = spot_name
        self.carry_curve_name = carry_curve_name
        self.dividend_curve_name = dividend_curve_name
        self.discount_curve_name = discount_curve_name
        self.initial_price = initial_price
        self.return_nominal_scaling = return_nominal_scaling
        self.interest_nominal_scaling = interest_nominal_scaling
        self.is_receiver = is_receiver
        self.spot_lag = int(spot_lag)
        self.include_sim_date_cashflows = include_sim_date_cashflows

        self.schedule_config = schedule_config or ScheduleConfig(**schedule_kwargs)
        ret_freq = return_frequency or interest_leg.frequency
        self.return_schedule = self.schedule_config.build(
            effective_date, maturity_date, ret_freq
        )
        self.interest_schedule = self.schedule_config.build(
            effective_date, maturity_date, interest_leg.frequency
        )
        self._effective_maturity = max(
            max(p for _, _, p, _ in self.return_schedule),
            max(p for _, _, p, _ in self.interest_schedule),
        )
        self._build_settle_map()

    def _build_settle_map(self) -> None:
        """Spot-lag settlement dates for every schedule boundary
        (equity_trs.py:182-200)."""
        self._settle_map: Dict[dt.date, dt.date] = {}
        if self.spot_lag > 0:
            cal = self.schedule_config.cal
            all_dates: set = set()
            for sched in (self.return_schedule, self.interest_schedule):
                for s, e, _, _ in sched:
                    all_dates.add(s)
                    all_dates.add(e)
            self._settle_map = {
                d: cal.add_working_days(d, self.spot_lag) for d in all_dates
            }

    def _settled(self, d: dt.date) -> dt.date:
        return self._settle_map.get(d, d)

    # ------------------------------------------------------------------
    # reset / fixing interface
    # ------------------------------------------------------------------

    def get_reset_dates(self) -> List[Tuple[dt.date, str, dt.date, dt.date, bool]]:
        """Interest-leg floating resets only (equity_trs.py:275-298)."""
        resets: List[Tuple[dt.date, str, dt.date, dt.date, bool]] = []
        if self.interest_leg.leg_type == LegType.FLOATING:
            is_ois = self.interest_leg.overnight_compounding
            resets.extend(
                (start, self.interest_leg.curve_name, start, end, is_ois)
                for start, end, _, _ in self.interest_schedule
            )
        return resets

    def compute_fixings(
        self,
        resets: List[Tuple[dt.date, str, dt.date, dt.date]],
        time_slice: Dict,
        scenario_date: dt.date,
    ) -> Dict[Tuple[str, dt.date], np.ndarray]:
        """LIBOR forwards (or spot stamps) from an earlier scenario's state
        (equity_trs.py:300-364)."""
        fixings: Dict[Tuple[str, dt.date], np.ndarray] = {}
        sc = self.schedule_config
        leg = self.interest_leg
        for _reset_date, curve_name, p_start, p_end in resets:
            if curve_name == self.spot_name:
                spot_slice = time_slice[curve_name]
                fixings[(curve_name, p_start)] = np.asarray(
                    spot_slice.values, dtype=np.float64
                ).copy()
                continue
            fwd_slice: CurveSlice = time_slice[curve_name]
            fwd_curve = YieldCurve(fwd_slice.tenors, fwd_slice.values)
            t_start = sc.curve_year_fraction(scenario_date, p_start)
            if leg.fixing_tenor_months is not None:
                fix_end = adjust(
                    add_months(p_start, leg.fixing_tenor_months),
                    sc.cal,
                    leg.forward_business_convention or "ModifiedFollowing",
                )
                t_end = sc.curve_year_fraction(scenario_date, fix_end)
                fwd_tau = sc.year_fraction(p_start, fix_end)
                fixings[(curve_name, p_start)] = fwd_curve.forward_rate(
                    t_start, t_end, tau=fwd_tau
                )
            else:
                t_end = sc.curve_year_fraction(scenario_date, p_end)
                fwd_tau = sc.year_fraction(p_start, p_end)
                fixings[(curve_name, p_start)] = fwd_curve.forward_rate(
                    t_start, t_end, tau=fwd_tau
                )
        return fixings

    def compute_cf_increment(
        self, curve_name: str, t_from: dt.date, t_to: dt.date, time_slice: Dict
    ) -> np.ndarray:
        """One-step OIS compound factor 1/DF (equity_trs.py:366-389)."""
        sc = self.schedule_config
        fwd_slice: CurveSlice = time_slice[curve_name]
        fwd_curve = YieldCurve(fwd_slice.tenors, fwd_slice.values)
        tau = sc.curve_year_fraction(t_from, t_to)
        return 1.0 / fwd_curve.discount_factor(np.array([tau]))[:, 0]

    # ------------------------------------------------------------------
    # equity spot fixing interface (equity_trs.py:391-430)
    # ------------------------------------------------------------------

    def get_equity_reset_schedule(self) -> List[dt.date]:
        reset_dates: set = set()
        for start, end, _, _ in self.return_schedule:
            reset_dates.add(start)
            reset_dates.add(end)
        if self.interest_nominal_scaling == "Price":
            for start, _end, _, _ in self.interest_schedule:
                reset_dates.add(start)
        return sorted(reset_dates)

    def _compute_equity_fixing_for_date(
        self, reset_date: dt.date, fix_state: Dict
    ) -> Dict[tuple, np.ndarray]:
        spot_slice = fix_state[self.spot_name]
        return {
            (self.spot_name, reset_date): np.asarray(
                spot_slice.values, dtype=np.float64
            ).copy()
        }

    # ------------------------------------------------------------------
    # pricing (equity_trs.py:436-586)
    # ------------------------------------------------------------------

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict,
        fixings: Optional[Dict[tuple, np.ndarray]] = None,
        rng=None,
    ) -> np.ndarray:
        spot_slice: ScalarSlice = market_state[self.spot_name]
        spot = np.asarray(spot_slice.values, dtype=np.float64)
        n_paths = spot.shape[0]

        # cut off at the last adjusted/lagged payment, not the contractual
        # maturity: a 'Following'-adjusted or payment-lagged final period
        # can pay after maturity_date and its return+interest is still
        # outstanding MTM (same rule as IRSwap/IndexLinkedSwap); due-today
        # flows count on the terminal date so the final coupon isn't lost
        if val_date > self._effective_maturity:
            return np.zeros(n_paths)
        include_on_val = (
            self.include_sim_date_cashflows
            or val_date == self._effective_maturity
        )

        sc = self.schedule_config
        carry_slice: CurveSlice = market_state[self.carry_curve_name]
        carry_curve = YieldCurve(carry_slice.tenors, carry_slice.values)
        div_slice = market_state.get(self.dividend_curve_name)
        div_curve = (
            YieldCurve(div_slice.tenors, div_slice.values)
            if div_slice is not None
            else None
        )
        disc_slice: CurveSlice = market_state[self.discount_curve_name]
        disc_curve = YieldCurve(disc_slice.tenors, disc_slice.values)

        # -- Return leg --
        future_return = filter_future_periods(
            self.return_schedule, val_date, include_on_val
        )
        if future_return:
            settled_periods = [
                (self._settled(s), self._settled(e), p, a)
                for s, e, p, a in future_return
            ]
            t_starts, t_ends, t_pays, _ = compute_period_year_fractions(
                settled_periods, val_date, sc.curve_day_count
            )
            t_settle = 0.0
            if self.spot_lag > 0:
                val_settle = sc.cal.add_working_days(val_date, self.spot_lag)
                t_settle = sc.curve_year_fraction(val_date, val_settle)

            # in-progress first period: per-path stamped fixing wins over the
            # scalar initial_price (equity_trs.py:245-268)
            initial_price = self.initial_price
            if t_starts[0] <= 0 and fixings is not None:
                stored = fixings.get((self.spot_name, future_return[0][0]))
                if stored is not None:
                    initial_price = stored

            end_fixings = [
                fixings.get((self.spot_name, e)) if fixings else None
                for _, e, _, _ in future_return
            ]

            return_pv = trs_return_leg_pv(
                spot=spot,
                carry_curve=carry_curve,
                dividend_curve=div_curve,
                discount_curve=disc_curve,
                t_starts=t_starts,
                t_ends=t_ends,
                t_pays=t_pays,
                quantity=self.quantity,
                initial_price=initial_price,
                nominal_scaling=self.return_nominal_scaling,
                notional_fixed=self.notional,
                end_fixings=end_fixings,
                t_settle=t_settle,
            )
        else:
            return_pv = np.zeros(n_paths)

        # -- Interest leg --
        # "Price" scaling: average the per-period equity-forward notionals
        # into an effective notional for the shared leg_pv (the reference
        # threads a full notional schedule; capability preserved via the
        # per-period loop below).
        interest_pv = np.zeros(n_paths)
        future_int = filter_future_periods(
            self.interest_schedule, val_date, include_on_val
        )
        if future_int:
            if self.interest_nominal_scaling == "Price":
                for p_start, p_end, pay, accrual in future_int:
                    one_period = [(p_start, p_end, pay, accrual)]
                    t_s = sc.curve_year_fraction(val_date, max(p_start, val_date))
                    if p_start <= val_date:
                        stored = (
                            fixings.get((self.spot_name, p_start)) if fixings else None
                        )
                        notional_i = (
                            np.asarray(stored, dtype=np.float64)
                            if stored is not None
                            else spot
                        ) * self.quantity
                    else:
                        F_s, _, _ = equity_forward_price(
                            spot, carry_curve, div_curve, t_s
                        )
                        notional_i = F_s * self.quantity
                    pv_unit = leg_pv(
                        one_period, self.interest_leg,
                        notional=1.0,
                        val_date=val_date,
                        market_state=market_state,
                        discount_curve=disc_curve,
                        n_paths=n_paths,
                        schedule_config=sc,
                        fixings=fixings,
                        include_on_val_date=include_on_val,
                    )
                    interest_pv = interest_pv + notional_i * pv_unit
            else:
                interest_pv = leg_pv(
                    self.interest_schedule, self.interest_leg,
                    notional=self.notional,
                    val_date=val_date,
                    market_state=market_state,
                    discount_curve=disc_curve,
                    n_paths=n_paths,
                    schedule_config=sc,
                    fixings=fixings,
                    include_on_val_date=include_on_val,
                )

        direction = 1.0 if self.is_receiver else -1.0
        return direction * (return_pv - interest_pv)
