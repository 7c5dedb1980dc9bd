"""Bond, rates and inflation pricers (the port of
``finite_difference_tpu.bonds``, host Python): zero-coupon bonds,
fixed-rate bonds (BESA accrued, YTM, val01, gamma), FRAs,
inflation-linked bonds (spot and forward) and the fixed-vs-CPI inflation
swap. They take any curve with ``get_discount_factor`` (and, where used,
``get_zero_rate`` / ``year_fraction``), e.g. ``utils.curves.DailyNacaCurve``,
and the port's ``market_data.HistoricalCPI``. None of them does device
work, in either package, so none takes ``device=``.
"""
from .zero_coupon import ZeroCouponBond, ZeroCouponBondPricer
from .fixed_rate import FixedRateBond, FixedRateBondPricer
from .fra import ForwardRateAgreement, ForwardRateAgreementPricer
from .inflation_bond import ForwardInflationBondPricer, InflationLinkedBondPricer
from .inflation_swap import InflationLinkedSwap, InflationLinkedSwapPricer

__all__ = [
    "ZeroCouponBond",
    "ZeroCouponBondPricer",
    "FixedRateBond",
    "FixedRateBondPricer",
    "ForwardRateAgreement",
    "ForwardRateAgreementPricer",
    "ForwardInflationBondPricer",
    "InflationLinkedBondPricer",
    "InflationLinkedSwap",
    "InflationLinkedSwapPricer",
]
