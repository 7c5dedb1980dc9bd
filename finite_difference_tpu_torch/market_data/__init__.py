"""Market-data layer of the port (counterpart of
``finite_difference_tpu.market_data``): the risk-factor slices, the
scenario cube and the pathwise yield curve, host numpy, copied. The CPI
modules come with ROADMAP.md queue 1 item 4b."""
from .risk_factor import CurveSlice, RiskFactorSlice, ScalarSlice, SurfaceSlice
from .scenario_cube import ScenarioCube, StaticMarketData
from .yield_curve import YieldCurve, hermite_rt_interp, linear_interp

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
]
