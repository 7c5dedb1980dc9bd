"""Inflation-linked bond, spot and forward pricers (the port's copy of
``finite_difference_tpu.bonds.inflation_bond``, host Python, on the port's
``ScheduleConfig`` and ``HistoricalCPI``).

Capability parity with the reference's ``inflation_bond_pricer.py:11-256``
and ``forward_inflation_bond_pricer.py:9-303`` without pandas schedules:

- coupon schedule from the ScheduleConfig conventions;
- per-period indexed notional = N * CPI_BESA(period end) / base_cpi;
- coupon = indexed notional * real coupon rate * year fraction; principal
  = final indexed notional;
- dirty price = PV / notional * 100; accrued by day-fraction within the
  current period; clean = dirty - accrued; spot index ratio floored at 1;
- forward pricer: carry = PV of coupons paid in (spot, forward];
  forward dirty = (spot dirty - carry_per_100) / DF(forward); forward
  clean = forward dirty - accrued(forward); NPV = sign * (forward clean -
  strike) * notional * DF(settlement) / 100.
"""
from __future__ import annotations

import datetime as dt
from typing import List, Literal, Optional

from ..instruments.schedule import ScheduleConfig
from ..market_data.cpi import HistoricalCPI


class InflationLinkedBondPricer:
    def __init__(
        self,
        issue_date: dt.date,
        maturity_date: dt.date,
        notional: float,
        coupon_rate: float,
        value_date: Optional[dt.date] = None,
        discount_curve=None,
        historical_cpi: Optional[HistoricalCPI] = None,
        base_cpi: Optional[float] = None,
        payment_frequency: int = 6,
        calendar: str = "SouthAfrica",
        business_convention: str = "ModifiedFollowing",
        termination_business_convention: str = "ModifiedFollowing",
        date_generation: str = "Backward",
        day_count: str = "ACT/365",
        end_of_month: bool = False,
    ):
        if discount_curve is None:
            raise ValueError("discount_curve must be provided")
        if historical_cpi is None:
            raise ValueError("historical_cpi must be provided")
        if base_cpi is None:
            raise ValueError("base_cpi must be provided")

        self.issue_date = issue_date
        self.maturity_date = maturity_date
        self.notional = notional
        self.coupon_rate = coupon_rate
        self.value_date = value_date or issue_date
        self.discount_curve = discount_curve
        self.historical_cpi = historical_cpi
        self.base_cpi = base_cpi
        self.schedule_config = ScheduleConfig(
            calendar=calendar,
            business_convention=business_convention,
            termination_business_convention=termination_business_convention,
            date_generation=date_generation,
            day_count=day_count,
            curve_day_count=day_count,
        )
        self.payment_frequency = payment_frequency
        self._build_rows()

    def _df(self, d: dt.date) -> float:
        if hasattr(self.discount_curve, "get_discount_factor"):
            return float(self.discount_curve.get_discount_factor(d))
        return float(self.discount_curve(d))

    def _build_rows(self) -> None:
        """Rows: (start, end, pay, accrual, indexed_notional, coupon,
        principal, cashflow, df, pv)."""
        periods = self.schedule_config.build(
            self.issue_date, self.maturity_date, self.payment_frequency
        )
        self.rows: List[dict] = []
        n = len(periods)
        for i, (start, end, pay, accrual) in enumerate(periods):
            live = pay > self.value_date
            if not live:
                # dead periods carry no cashflow and need no CPI / DF lookup
                # (the reference zeroes them after the fact,
                # inflation_bond_pricer.py:133-140)
                self.rows.append(
                    dict(
                        start=start, end=end, pay=pay, accrual=accrual,
                        notional=0.0, coupon=0.0, principal=0.0,
                        cashflow=0.0, df=0.0, pv=0.0,
                    )
                )
                continue
            indexed = (
                self.notional
                * self.historical_cpi.cpi_value(end)
                / self.base_cpi
            )
            coupon = indexed * self.coupon_rate * accrual
            principal = indexed if i == n - 1 else 0.0
            cashflow = coupon + principal
            df = self._df(pay)
            self.rows.append(
                dict(
                    start=start, end=end, pay=pay, accrual=accrual,
                    notional=indexed, coupon=coupon, principal=principal,
                    cashflow=cashflow, df=df, pv=cashflow * df,
                )
            )

    def pv(self) -> float:
        return sum(r["pv"] for r in self.rows)

    def dirty_price(self) -> float:
        return self.pv() / self.notional * 100.0

    def accrued_interest(self, as_of: Optional[dt.date] = None) -> float:
        """Accrued per 100 face by day-fraction within the current period
        (inflation_bond_pricer.py:158-191)."""
        d = as_of or self.value_date
        current = [r for r in self.rows if r["start"] <= d]
        if not current:
            return 0.0
        r = current[-1]
        total_days = (r["end"] - r["start"]).days
        if total_days <= 0:
            return 0.0
        frac = (d - r["start"]).days / total_days
        accrued = r["notional"] * self.coupon_rate * frac * r["accrual"]
        return accrued / self.notional * 100.0

    def clean_price(self) -> float:
        return self.dirty_price() - self.accrued_interest()

    def index_ratio(self, as_of_date: Optional[dt.date] = None) -> float:
        """CPI(as_of)/base, floored at 1 (inflation_bond_pricer.py:203-218)."""
        d = as_of_date or self.value_date
        return max(self.historical_cpi.cpi_value(d) / self.base_cpi, 1.0)

    def summary(self) -> dict:
        return {
            "pv": self.pv(),
            "dirty_price": self.dirty_price(),
            "clean_price": self.clean_price(),
            "accrued_interest": self.accrued_interest(),
            "index_ratio": self.index_ratio(),
        }


class ForwardInflationBondPricer:
    def __init__(
        self,
        underlying_bond: InflationLinkedBondPricer,
        forward_date: dt.date,
        settlement_date: Optional[dt.date] = None,
        strike_price: Optional[float] = None,
        position: Literal["long", "short"] = "long",
        contract_notional: Optional[float] = None,
    ):
        if forward_date <= underlying_bond.value_date:
            raise ValueError("Forward date must be after value date")
        self.underlying_bond = underlying_bond
        self.forward_date = forward_date
        self.settlement_date = settlement_date or forward_date
        self.position = position
        self.contract_notional = (
            contract_notional if contract_notional is not None
            else underlying_bond.notional
        )
        self.strike_price = (
            strike_price if strike_price is not None else self.forward_clean_price()
        )

    def _calculate_carry(self) -> float:
        """PV of coupons paid in (spot, forward]
        (forward_inflation_bond_pricer.py:65-91)."""
        b = self.underlying_bond
        return sum(
            r["coupon"] * r["df"]
            for r in b.rows
            if b.value_date < r["pay"] <= self.forward_date
        )

    def _accrued_at_forward(self) -> float:
        return self.underlying_bond.accrued_interest(as_of=self.forward_date)

    def forward_dirty_price(self) -> float:
        b = self.underlying_bond
        carry_per_100 = self._calculate_carry() / b.notional * 100.0
        df_fwd = b._df(self.forward_date)
        return (b.dirty_price() - carry_per_100) / df_fwd

    def forward_clean_price(self) -> float:
        return self.forward_dirty_price() - self._accrued_at_forward()

    def npv(self) -> float:
        b = self.underlying_bond
        sign = 1.0 if self.position == "long" else -1.0
        df_settle = b._df(self.settlement_date)
        return (
            sign
            * (self.forward_clean_price() - self.strike_price)
            * self.contract_notional
            * df_settle
            / 100.0
        )

    def forward_index_ratio(self) -> float:
        b = self.underlying_bond
        return max(b.historical_cpi.cpi_value(self.forward_date) / b.base_cpi, 1.0)

    def spot_index_ratio(self) -> float:
        return self.underlying_bond.index_ratio()

    def summary(self) -> dict:
        return {
            "forward_dirty_price": self.forward_dirty_price(),
            "forward_clean_price": self.forward_clean_price(),
            "forward_accrued": self._accrued_at_forward(),
            "strike_price": self.strike_price,
            "npv": self.npv(),
            "carry": self._calculate_carry(),
            "spot_index_ratio": self.spot_index_ratio(),
            "forward_index_ratio": self.forward_index_ratio(),
        }
