"""Interest-rate swap priced against a ScenarioCube (the port's copy of
``finite_difference_tpu.instruments.ir_swap``, host numpy).

Capability parity with the reference's ``ir_swap.py:23-279``: schedules
generated once at construction; per simulation date a pathwise yield curve
is built from the scenario curve factor, forwards resolved fixing-or-
forward, and both legs discounted; reset tuples (reset_date, curve_name,
p_start, p_end, is_overnight) feed the ExposureEngine's fixing caches; OIS
legs expose one-step compound factors that telescope to DF ratios.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve
from .cashflow import LegType, SwapLeg, leg_pv
from .instrument import Instrument
from .schedule import (
    ScheduleConfig,
    add_months,
    adjust,
    generate_sub_periods,
)

ResetTuple = Tuple[dt.date, str, dt.date, dt.date, bool]


def _pathwise_curve(factor_slice: CurveSlice) -> YieldCurve:
    """Vectorised (n_paths, n_tenors) yield curve from a scenario slice."""
    return YieldCurve(year_fracs=factor_slice.tenors, rates=factor_slice.values)


class IRSwap(Instrument):
    def __init__(
        self,
        name: str,
        effective_date: dt.date,
        maturity_date: dt.date,
        notional: float,
        receive_leg: SwapLeg,
        pay_leg: SwapLeg,
        discount_curve_name: str,
        schedule_config: Optional[ScheduleConfig] = None,
        calendar: str = "ZAR",
        business_convention: str = "ModifiedFollowing",
        termination_business_convention: str = "ModifiedFollowing",
        date_generation: str = "Backward",
        day_count: str = "ACT/365",
        curve_day_count: str = "ACT/365",
        include_sim_date_cashflows: bool = False,
        ois_initial_cfs: Optional[Dict[Tuple[str, dt.date], float]] = None,
    ):
        super().__init__(name)
        self._ois_initial_cfs = ois_initial_cfs or {}
        self.effective_date = effective_date
        self.maturity_date = maturity_date
        self.notional = notional
        self.receive_leg = receive_leg
        self.pay_leg = pay_leg
        self.discount_curve_name = discount_curve_name
        self.include_sim_date_cashflows = include_sim_date_cashflows
        self.schedule_config = schedule_config or ScheduleConfig(
            calendar=calendar,
            business_convention=business_convention,
            termination_business_convention=termination_business_convention,
            date_generation=date_generation,
            day_count=day_count,
            curve_day_count=curve_day_count,
        )

        sched = self.schedule_config
        self.receive_schedule = sched.build(
            effective_date, maturity_date, receive_leg.frequency
        )
        self.pay_schedule = sched.build(
            effective_date, maturity_date, pay_leg.frequency
        )
        # last adjusted payment date across both legs — PVs are zero past it
        self._effective_maturity: dt.date = max(
            pay for leg in (self.receive_schedule, self.pay_schedule)
            for _, _, pay, _ in leg
        )

    # ------------------------------------------------------------------
    # reset / fixing interface (ir_swap.py:100-129)
    # ------------------------------------------------------------------

    def _floating(self) -> Iterator[Tuple[list, SwapLeg]]:
        for schedule, leg in (
            (self.receive_schedule, self.receive_leg),
            (self.pay_schedule, self.pay_leg),
        ):
            if leg.leg_type == LegType.FLOATING:
                yield schedule, leg

    def get_reset_dates(self) -> List[ResetTuple]:
        """One reset tuple per floating accrual (or sub-)period.

        Legs with ``reset_frequency_months > 0`` split each payment period
        into compounding sub-periods, each with its own reset.
        """
        sc = self.schedule_config
        out: List[ResetTuple] = []
        for schedule, leg in self._floating():
            if leg.reset_frequency_months > 0:
                out.extend(
                    (sub0, leg.curve_name, sub0, sub1, False)
                    for pay_start, pay_end, _, _ in schedule
                    for sub0, sub1, _ in generate_sub_periods(
                        pay_start, pay_end, leg.reset_frequency_months,
                        sc.cal, sc.business_convention, sc.day_count,
                        direction="Backward",
                    )
                )
            else:
                out.extend(
                    (start, leg.curve_name, start, end, leg.overnight_compounding)
                    for start, end, _, _ in schedule
                )
        return out

    def compute_cf_increment(
        self,
        curve_name: str,
        t_from: dt.date,
        t_to: dt.date,
        time_slice: Dict[str, object],
    ) -> np.ndarray:
        """One-step OIS compound factor over [t_from, t_to] (ir_swap.py:131-176).

        The reference keeps the daily grid explicit and documents that the
        telescoping product of consecutive DF ratios "equals DF(0)/DF(tau)
        = 1/DF(tau), matching the scalar shortcut exactly" (ir_swap.py:
        142-148) — the grid is ~22 interpolation points plus a (n_paths x
        n_bdays+1) materialization per engine step for a value one DF
        query yields (DF(0)=1 exactly on the shared interpolator; the
        product only adds ~1e-15 of accumulated rounding). EquityTRS and
        IndexLinkedSwap already use the endpoint form; this is the same
        shortcut.
        """
        sc = self.schedule_config
        curve = _pathwise_curve(time_slice[curve_name])
        tau = sc.curve_year_fraction(t_from, t_to)
        return 1.0 / curve.discount_factor(np.array([tau]))[:, 0]

    def _forward_for_reset(
        self,
        curve: YieldCurve,
        leg: Optional[SwapLeg],
        scenario_date: dt.date,
        p_start: dt.date,
        p_end: dt.date,
    ) -> np.ndarray:
        """Simple forward over the reset's fixing window.

        A leg with an explicit ``fixing_tenor_months`` projects over the
        index tenor (e.g. 3M JIBAR inside a 6M accrual); otherwise the
        accrual period itself is the fixing window.
        """
        sc = self.schedule_config
        t0 = sc.curve_year_fraction(scenario_date, p_start)
        if leg is not None and leg.fixing_tenor_months is not None:
            fix_end = adjust(
                add_months(p_start, leg.fixing_tenor_months),
                sc.cal,
                leg.forward_business_convention or "ModifiedFollowing",
            )
            return curve.forward_rate(
                t0,
                sc.curve_year_fraction(scenario_date, fix_end),
                tau=sc.year_fraction(p_start, fix_end),
            )
        return curve.forward_rate(t0, sc.curve_year_fraction(scenario_date, p_end))

    def compute_fixings(
        self,
        resets: List[Tuple[dt.date, str, dt.date, dt.date]],
        time_slice: Dict[str, object],
        scenario_date: dt.date,
    ) -> Dict[Tuple[str, dt.date], np.ndarray]:
        """Forward rates for resets from an earlier scenario's curve
        (ir_swap.py:179-233)."""
        leg_of = {
            leg.curve_name: leg
            for _, leg in self._floating()
            if leg.curve_name
        }
        out: Dict[Tuple[str, dt.date], np.ndarray] = {}
        for _reset_date, curve_name, p_start, p_end in resets:
            out[(curve_name, p_start)] = self._forward_for_reset(
                _pathwise_curve(time_slice[curve_name]),
                leg_of.get(curve_name),
                scenario_date, p_start, p_end,
            )
        return out

    # ------------------------------------------------------------------
    # pricing (ir_swap.py:236-279)
    # ------------------------------------------------------------------

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict[str, object],
        fixings: Optional[Dict[Tuple[str, dt.date], np.ndarray]] = None,
        rng=None,
    ) -> np.ndarray:
        disc_slice: CurveSlice = market_state[self.discount_curve_name]
        n_paths = disc_slice.values.shape[0]
        if val_date > self._effective_maturity:
            return np.zeros(n_paths)

        def one_leg(schedule, leg):
            return leg_pv(
                schedule,
                leg,
                notional=self.notional,
                val_date=val_date,
                market_state=market_state,
                discount_curve=_pathwise_curve(disc_slice),
                n_paths=n_paths,
                schedule_config=self.schedule_config,
                fixings=fixings,
                # due-today flows count on the terminal date so the final
                # coupon is not dropped (RiskFlow behaviour)
                include_on_val_date=(
                    self.include_sim_date_cashflows
                    or val_date == self._effective_maturity
                ),
            )

        return one_leg(self.receive_schedule, self.receive_leg) - one_leg(
            self.pay_schedule, self.pay_leg
        )
