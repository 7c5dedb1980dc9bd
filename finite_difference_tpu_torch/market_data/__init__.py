"""Market-data layer of the port (counterpart of
``finite_difference_tpu.market_data``): the risk-factor slices and the
scenario cube, host numpy, copied. The yield-curve and CPI modules come
with the XVA and host-only slices."""
from .risk_factor import CurveSlice, RiskFactorSlice, ScalarSlice, SurfaceSlice
from .scenario_cube import ScenarioCube, StaticMarketData

__all__ = [
    "CurveSlice",
    "RiskFactorSlice",
    "ScalarSlice",
    "SurfaceSlice",
    "ScenarioCube",
    "StaticMarketData",
]
