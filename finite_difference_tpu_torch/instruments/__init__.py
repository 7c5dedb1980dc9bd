"""Instruments priced against scenario cubes (the port of
``finite_difference_tpu.instruments``).

The ``Instrument`` contract mirrors the reference's instrument.py:15-147;
IRSwap prices pathwise against ScenarioCube slices on the host, and the
PDE-surface exotics (EquityBarrierOption, AmericanOptionPosition) solve
their value surfaces on ``device`` through the batched CN solve. The
equity TRS, index-linked swap, inflation and commodity instruments come
with ROADMAP.md queue 1 item 4b.
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
from .american_option import AmericanOptionPosition
from .equity_barrier import EquityBarrierOption

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
    "AmericanOptionPosition",
    "EquityBarrierOption",
]
