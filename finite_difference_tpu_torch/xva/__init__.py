"""XVA / exposure layer (the port of ``finite_difference_tpu.xva``): the
commodity CVA stack (config -> time grid -> reference price -> forward
MTM -> EE/PFE/CVA), the netting-set exposure engines (the generic host
engine and the device engine), and the HW1F CVA pipeline.
"""
from .config import (
    CounterpartyConfig,
    DiscountingConfig,
    SamplingConvention,
    SimulationConfig,
)
from .time_grid import TimeGrid
from .reference_price import FixingSchedule, ReferencePrice
from .commodity_forward import CommodityForward
from .cva import ExposureProfile, XvaCalculator
from .engine import CommodityXvaEngine, RunResult
from .exposure_engine import ExposureEngine, ExposureProfile as NettingExposureProfile
from .device_exposure import DeviceExposureEngine, hw1f_cva_pipeline

__all__ = [
    "CounterpartyConfig",
    "DiscountingConfig",
    "SamplingConvention",
    "SimulationConfig",
    "TimeGrid",
    "FixingSchedule",
    "ReferencePrice",
    "CommodityForward",
    "ExposureProfile",
    "XvaCalculator",
    "CommodityXvaEngine",
    "RunResult",
    "ExposureEngine",
    "DeviceExposureEngine",
    "hw1f_cva_pipeline",
    "NettingExposureProfile",
]
