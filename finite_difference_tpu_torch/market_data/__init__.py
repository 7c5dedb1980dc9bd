"""Market-data layer of the port (counterpart of
``finite_difference_tpu.market_data``): the risk-factor slices, the
scenario cube, the pathwise yield curve, the CPI publication conventions
and the CPI term structure, host numpy, copied."""
from .risk_factor import CurveSlice, RiskFactorSlice, ScalarSlice, SurfaceSlice
from .scenario_cube import ScenarioCube, StaticMarketData
from .yield_curve import YieldCurve, hermite_rt_interp, linear_interp
from .cpi import BondHistoricalCPI, CPIPublication, HistoricalCPI, besa_bracket, first_of_month, shift_months
from .cpi_term_structure import CPITermStructure

__all__ = [
    "CurveSlice",
    "RiskFactorSlice",
    "ScalarSlice",
    "SurfaceSlice",
    "ScenarioCube",
    "StaticMarketData",
    "YieldCurve",
    "hermite_rt_interp",
    "linear_interp",
    "BondHistoricalCPI",
    "CPIPublication",
    "HistoricalCPI",
    "besa_bracket",
    "first_of_month",
    "shift_months",
    "CPITermStructure",
]
