"""Index-linked (inflation) swap priced against a ScenarioCube (the port's copy of
``finite_difference_tpu.instruments.index_linked_swap``, host numpy).

Capability parity with the reference's ``index_linked_swap.py:19-591``:
inflation leg paying a real coupon on a CPI-indexed notional (BESA bracket
dates, lag months), nominal fixed/floating counter-leg, CPI fixing
stamping interface for the ExposureEngine (reference dates, T_last_pub
pre-seeding, per-path bracket-date fixings), and RiskFlow two-curve mode
(PriceIndex spot + InflationRate projection from T_last_pub).
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..market_data.cpi import besa_bracket, first_of_month, shift_months
from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve
from .cashflow import LegType, SwapLeg, leg_pv
from .inflation_pv import InflationLeg, inflation_leg_pv
from .instrument import Instrument
from .schedule import ScheduleConfig, build_overnight_tenors, generate_sub_periods


class IndexLinkedSwap(Instrument):
    def __init__(
        self,
        name: str,
        effective_date: dt.date,
        maturity_date: dt.date,
        notional: float,
        inflation_leg: InflationLeg,
        nominal_leg: SwapLeg,
        discount_curve_name: str,
        inflation_index=None,
        inflation_receiver: bool = True,
        schedule_config: Optional[ScheduleConfig] = None,
        include_sim_date_cashflows: bool = False,
        **schedule_kwargs,
    ):
        super().__init__(name)
        self.effective_date = effective_date
        self.maturity_date = maturity_date
        self.notional = notional
        self.inflation_leg = inflation_leg
        self.nominal_leg = nominal_leg
        self.discount_curve_name = discount_curve_name
        self.inflation_index = inflation_index
        self.inflation_receiver = inflation_receiver
        self.include_sim_date_cashflows = include_sim_date_cashflows
        self.schedule_config = schedule_config or ScheduleConfig(**schedule_kwargs)
        self._generate_schedules()
        self._build_historical_cpi_map()

    def _generate_schedules(self) -> None:
        self.inflation_schedule = self.schedule_config.build(
            self.effective_date, self.maturity_date, self.inflation_leg.frequency
        )
        self.nominal_schedule = self.schedule_config.build(
            self.effective_date, self.maturity_date, self.nominal_leg.frequency
        )
        self._effective_maturity: dt.date = max(
            max(p for _, _, p, _ in self.inflation_schedule),
            max(p for _, _, p, _ in self.nominal_schedule),
        )

    def _build_historical_cpi_map(self) -> None:
        """Seed the first-of-month CPI map (index_linked_swap.py:182-199)."""
        self._historical_cpi_map: Dict[dt.date, float] = {}
        if self.inflation_index is None:
            return
        if hasattr(self.inflation_index, "_monthly_cpi"):
            self._historical_cpi_map = dict(self.inflation_index._monthly_cpi)
        elif isinstance(self.inflation_index, dict):
            self._historical_cpi_map = dict(self.inflation_index)

    # ------------------------------------------------------------------
    # Reset / fixing interface — nominal floating leg
    # ------------------------------------------------------------------

    def get_reset_dates(self) -> List[Tuple[dt.date, str, dt.date, dt.date, bool]]:
        leg = self.nominal_leg
        if leg.leg_type != LegType.FLOATING:
            return []
        sc = self.schedule_config
        resets: List[Tuple[dt.date, str, dt.date, dt.date, bool]] = []
        if leg.reset_frequency_months > 0:
            for pay_start, pay_end, _, _ in self.nominal_schedule:
                for sub_start, sub_end, _ in generate_sub_periods(
                    pay_start, pay_end, leg.reset_frequency_months,
                    sc.cal, sc.business_convention, sc.day_count,
                    direction="Backward",
                ):
                    resets.append((sub_start, leg.curve_name, sub_start, sub_end, False))
        else:
            for start, end, _, _ in self.nominal_schedule:
                resets.append(
                    (start, leg.curve_name, start, end, leg.overnight_compounding)
                )
        return resets

    def compute_cf_increment(
        self, curve_name: str, t_from: dt.date, t_to: dt.date, time_slice: Dict
    ) -> np.ndarray:
        """One-step OIS compound factor 1/DF(t_from -> t_to)
        (index_linked_swap.py:242-289)."""
        sc = self.schedule_config
        fwd_slice: CurveSlice = time_slice[curve_name]
        fwd_curve = YieldCurve(fwd_slice.tenors, fwd_slice.values)
        tau = sc.curve_year_fraction(t_from, t_to)
        return 1.0 / fwd_curve.discount_factor(np.array([tau]))[:, 0]

    def compute_fixings(
        self,
        resets: List[Tuple[dt.date, str, dt.date, dt.date]],
        time_slice: Dict,
        scenario_date: dt.date,
    ) -> Dict[Tuple[str, dt.date], np.ndarray]:
        """Nominal-leg forward-rate fixings (index_linked_swap.py:448-502)."""
        from .schedule import add_months, adjust

        sc = self.schedule_config
        leg = self.nominal_leg
        fixings: Dict[Tuple[str, dt.date], np.ndarray] = {}
        for _reset_date, curve_name, p_start, p_end in resets:
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
                fixings[(curve_name, p_start)] = fwd_curve.forward_rate(t_start, t_end)
        return fixings

    # ------------------------------------------------------------------
    # CPI fixing interface (index_linked_swap.py:291-446)
    # ------------------------------------------------------------------

    def get_cpi_last_pub_date(self, val_date: dt.date) -> dt.date:
        """Exact T_last_pub for val_date (index_linked_swap.py:291-324)."""
        npd = self.inflation_leg.next_publication_date
        freq = self.inflation_leg.publication_frequency_months
        if npd is None or not self._historical_cpi_map:
            return shift_months(first_of_month(val_date), -1)
        last_period_start = max(self._historical_cpi_map)
        n = 0
        while shift_months(first_of_month(npd), n * freq).replace(
            day=min(npd.day, 28)
        ) <= val_date:
            n += 1
        return shift_months(last_period_start, n * freq)

    def get_cpi_reference_dates(self) -> List[Tuple[dt.date, str]]:
        """Unique BESA bracket dates across the inflation schedule
        (index_linked_swap.py:326-350)."""
        seen: set = set()
        refs: List[Tuple[dt.date, str]] = []
        for _, end_date, _, _ in self.inflation_schedule:
            j, j1 = besa_bracket(end_date, self.inflation_leg.lag_months)
            for ref_date in sorted({j, j1}):
                if ref_date not in seen:
                    refs.append((ref_date, self.inflation_leg.cpi_curve_name))
                    seen.add(ref_date)
        return sorted(refs, key=lambda x: x[0])

    def _spot_cpi_from(self, state: Dict) -> np.ndarray:
        cpi_slice = state[self.inflation_leg.cpi_curve_name]
        vals = np.asarray(cpi_slice.values, dtype=np.float64)
        return vals[:, 0].copy() if vals.ndim == 2 else vals.copy()

    def _compute_cpi_fixing_for_date(
        self, ref_date: dt.date, fix_state: Dict
    ) -> Dict[dt.date, np.ndarray]:
        """{ref_date: spot CPI} or {} for historical dates (:352-366)."""
        if ref_date in self._historical_cpi_map:
            return {}
        return {ref_date: self._spot_cpi_from(fix_state)}

    def _compute_t_last_pub_fixing(
        self, time_slice: Dict, sim_date: dt.date, existing_fixings: Dict
    ) -> Dict[dt.date, np.ndarray]:
        """Pre-seed the projection anchor CPI(T_last_pub) (:368-392)."""
        t_pub = self.get_cpi_last_pub_date(sim_date)
        if t_pub in self._historical_cpi_map or t_pub in existing_fixings:
            return {}
        return {t_pub: self._spot_cpi_from(time_slice)}

    def compute_cpi_fixings(
        self,
        time_slice: Dict,
        scenario_date: dt.date,
        existing_fixings: Optional[Dict[dt.date, np.ndarray]] = None,
    ) -> Dict[dt.date, np.ndarray]:
        """Standalone bracket-date stamping (:394-446)."""
        fixings: Dict[dt.date, np.ndarray] = {}
        if existing_fixings is not None:
            fixings.update(
                self._compute_t_last_pub_fixing(
                    time_slice, scenario_date, existing_fixings
                )
            )
        for _, end_date, _, _ in self.inflation_schedule:
            j, j1 = besa_bracket(end_date, self.inflation_leg.lag_months)
            for ref_date in sorted({j, j1}):
                if ref_date > scenario_date or ref_date in fixings:
                    continue
                if existing_fixings is not None and ref_date in existing_fixings:
                    continue
                fixings.update(self._compute_cpi_fixing_for_date(ref_date, time_slice))
        return fixings

    # ------------------------------------------------------------------
    # pricing (index_linked_swap.py:504-591)
    # ------------------------------------------------------------------

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict,
        fixings: Optional[Dict[Tuple[str, dt.date], np.ndarray]] = None,
        rng=None,
        cpi_fixings: Optional[Dict[dt.date, np.ndarray]] = None,
        cpi_last_pub_date: Optional[dt.date] = None,
    ) -> np.ndarray:
        disc_slice: CurveSlice = market_state[self.discount_curve_name]
        n_paths = disc_slice.values.shape[0]
        if val_date > self._effective_maturity:
            return np.zeros(n_paths)

        discount_curve = YieldCurve(disc_slice.tenors, disc_slice.values)
        sc = self.schedule_config

        infl_pv = inflation_leg_pv(
            self.inflation_schedule,
            self.inflation_leg,
            base_notional=self.notional,
            val_date=val_date,
            market_state=market_state,
            discount_curve=discount_curve,
            n_paths=n_paths,
            schedule_config=sc,
            historical_cpi_map=self._historical_cpi_map,
            include_on_val_date=self.include_sim_date_cashflows,
            cpi_fixings=cpi_fixings,
            cpi_last_pub_date=cpi_last_pub_date,
        )
        nom_pv = leg_pv(
            self.nominal_schedule,
            self.nominal_leg,
            notional=self.notional,
            val_date=val_date,
            market_state=market_state,
            discount_curve=discount_curve,
            n_paths=n_paths,
            schedule_config=sc,
            fixings=fixings,
            include_on_val_date=self.include_sim_date_cashflows,
        )
        if self.inflation_receiver:
            return infl_pv - nom_pv
        return nom_pv - infl_pv
