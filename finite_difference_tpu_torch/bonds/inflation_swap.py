"""Inflation-linked swap, fixed on an indexed notional against a floating
leg (the port's copy of ``finite_difference_tpu.bonds.inflation_swap``,
host Python, on the port's ``ScheduleConfig`` and ``HistoricalCPI``).

Capability parity with the reference's ``inflation_linked_swap.py:5-138``
and ``inflation_linked_swap_pricer.py:9-92`` without QuantLib:

- one leg pays fixed_rate on a CPI-indexed notional (CPI leg), the other
  pays floating (simple curve forwards) on the plain notional;
- both legs share a backward-generated schedule at the float frequency;
- base CPI is the BESA lagged fixing at the issue date;
- NPV signed by ``pay_fixed_leg``; the fair fixed rate is
  PV_float / annuity with annuity = sum tau_i * I(t_i)/I_base * DF(t_i) * N.
"""
from __future__ import annotations

import datetime as dt
from typing import List, Optional, Tuple

from ..instruments.schedule import ScheduleConfig
from ..market_data.cpi import HistoricalCPI


class InflationLinkedSwap:
    def __init__(
        self,
        issue_date: dt.date,
        maturity_date: dt.date,
        notional: float,
        fixed_rate: float,
        historical_cpi: HistoricalCPI,
        yield_curve,
        value_date: Optional[dt.date] = None,
        pay_fixed_leg: bool = True,
        float_frequency_months: int = 6,
        calendar: str = "SouthAfrica",
        day_count: str = "ACT/365",
    ):
        self.issue_date = issue_date
        self.maturity_date = maturity_date
        self.notional = notional
        self.fixed_rate = fixed_rate
        self.historical_cpi = historical_cpi
        self.yield_curve = yield_curve
        self.value_date = value_date or getattr(
            yield_curve, "valuation_date", issue_date
        )
        self.pay_fixed_leg = pay_fixed_leg
        self.schedule_config = ScheduleConfig(
            calendar=calendar, day_count=day_count, curve_day_count=day_count
        )
        # Anchored at value_date, NOT issue_date — deliberate reference
        # parity: inflation_linked_swap.py:60-69 passes the curve's
        # referenceDate into ql.Schedule, so a seasoned swap's first
        # period is the value_date-truncated stub (Backward generation
        # keeps all later boundaries identical). Financially the full
        # contractual coupon accrues from the period start; use
        # issue-date-anchored IndexLinkedSwap (instruments/) for that
        # convention.
        self.schedule = self.schedule_config.build(
            self.value_date, maturity_date, float_frequency_months
        )
        # BESA lagged base CPI at issue (inflation_linked_swap.py:39-48)
        self.base_cpi = historical_cpi.cpi_value(issue_date)

    def _df(self, d: dt.date) -> float:
        return float(self.yield_curve.get_discount_factor(d))

    def cpi_leg_cashflows(self) -> List[Tuple[dt.date, float]]:
        """Fixed real coupons on the indexed notional."""
        out = []
        for start, end, pay, accrual in self.schedule:
            if pay <= self.value_date:
                continue
            index_ratio = self.historical_cpi.cpi_value(end) / self.base_cpi
            out.append((pay, self.notional * index_ratio * self.fixed_rate * accrual))
        return out

    def float_leg_cashflows(self) -> List[Tuple[dt.date, float]]:
        """Simple forwards on the plain notional."""
        out = []
        for start, end, pay, accrual in self.schedule:
            if pay <= self.value_date:
                continue
            df_s = self._df(max(start, self.value_date))
            df_e = self._df(end)
            fwd = (df_s / df_e - 1.0) / accrual if accrual > 0 else 0.0
            out.append((pay, self.notional * fwd * accrual))
        return out


class InflationLinkedSwapPricer:
    def __init__(self, swap_def: InflationLinkedSwap):
        self.instrument = swap_def

    def _pv(self, cashflows) -> float:
        return sum(cf * self.instrument._df(d) for d, cf in cashflows)

    def npv(self) -> float:
        s = self.instrument
        pv_cpi = self._pv(s.cpi_leg_cashflows())
        pv_float = self._pv(s.float_leg_cashflows())
        # pay_fixed_leg: pay the CPI-linked fixed coupons, receive float
        return (pv_float - pv_cpi) if s.pay_fixed_leg else (pv_cpi - pv_float)

    def fair_fixed_rate(self) -> float:
        """r* = PV_float / annuity (inflation_linked_swap_pricer.py:17-46)."""
        s = self.instrument
        pv_float = self._pv(s.float_leg_cashflows())
        annuity = 0.0
        for start, end, pay, accrual in s.schedule:
            if pay <= s.value_date:
                continue
            index_ratio = s.historical_cpi.cpi_value(end) / s.base_cpi
            annuity += accrual * index_ratio * s._df(pay) * s.notional
        if annuity == 0.0:
            raise ValueError(
                "fair_fixed_rate undefined: no future payments at "
                f"value_date {s.value_date} (maturity {s.maturity_date})"
            )
        return pv_float / annuity
