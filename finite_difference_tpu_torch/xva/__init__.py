"""XVA / exposure layer (the port of ``finite_difference_tpu.xva``): the
netting-set exposure engines (the generic host engine and the device
engine), EE/PFE/CVA, and the HW1F CVA pipeline. The commodity CVA stack
(time grid, reference price, commodity forward, its engine) comes with
ROADMAP.md queue 1 item 4b.
"""
from .config import (
    CounterpartyConfig,
    DiscountingConfig,
    SamplingConvention,
    SimulationConfig,
)
from .cva import ExposureProfile, XvaCalculator
from .exposure_engine import ExposureEngine, ExposureProfile as NettingExposureProfile
from .device_exposure import DeviceExposureEngine, hw1f_cva_pipeline

__all__ = [
    "CounterpartyConfig",
    "DiscountingConfig",
    "SamplingConvention",
    "SimulationConfig",
    "ExposureProfile",
    "XvaCalculator",
    "ExposureEngine",
    "DeviceExposureEngine",
    "hw1f_cva_pipeline",
    "NettingExposureProfile",
]
