"""Instruments priced against scenario cubes (the port of
``finite_difference_tpu.instruments``).

The ``Instrument`` contract mirrors the reference's instrument.py:15-147;
IRSwap, EquityTRS, IndexLinkedSwap and the commodity forwards price
pathwise against ScenarioCube slices on the host, and the PDE-surface
exotics (EquityBarrierOption, AmericanOptionPosition) solve their value
surfaces on ``device`` through the batched CN solve.
"""
from .instrument import Instrument
from .schedule import (
    ScheduleConfig,
    WeekendCalendar,
    add_months,
    adjust,
    build_overnight_tenors,
    generate_sub_periods,
    get_calendar,
)
from .cashflow import CashflowLeg, LegType, SwapLeg, leg_pv
from .ir_swap import IRSwap
from .inflation_pv import InflationLeg, get_cpi_level, inflation_leg_pv
from .index_linked_swap import IndexLinkedSwap
from .equity_pv import (
    compute_period_year_fractions,
    equity_forward_price,
    filter_future_periods,
    trs_return_leg_pv,
)
from .american_option import AmericanOptionPosition
from .equity_barrier import EquityBarrierOption
from .equity_trs import EquityTRS
from .commodity import CommodityAverageForwardInstrument, CommodityForwardInstrument

__all__ = [
    "Instrument",
    "ScheduleConfig",
    "WeekendCalendar",
    "add_months",
    "adjust",
    "build_overnight_tenors",
    "generate_sub_periods",
    "get_calendar",
    "CashflowLeg",
    "LegType",
    "SwapLeg",
    "leg_pv",
    "IRSwap",
    "InflationLeg",
    "get_cpi_level",
    "inflation_leg_pv",
    "IndexLinkedSwap",
    "compute_period_year_fractions",
    "equity_forward_price",
    "filter_future_periods",
    "trs_return_leg_pv",
    "AmericanOptionPosition",
    "EquityBarrierOption",
    "EquityTRS",
    "CommodityAverageForwardInstrument",
    "CommodityForwardInstrument",
]
