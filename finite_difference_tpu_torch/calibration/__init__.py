"""Calibration layer (the port of ``finite_difference_tpu.calibration``):
the OU statistics of a panel, Clewlow–Strickland historical and implied
(the implied objective in torch on ``device``, its gradient by autograd)
and Hull–White one-factor. Panels are :class:`statistics.Panel` (importable from here too); the
JAX package's PCA and GBM-FX calibrations are not ported yet."""
from .statistics import Panel, calc_statistics, force_positive_shift
from .cs import (
    black_european_option_price,
    bootstrap_from_json,
    calibrate_historical,
    calibrate_implied,
    compare_cs_params,
    cs_variance,
    extract_cs_params,
    get_day_count_accrual,
    run_cs_calibration,
)
from .hw1f import calibrate_hw1f_interest_rate, compare_hw1f_params, extract_hw1f_params

__all__ = [
    "calc_statistics",
    "force_positive_shift",
    "black_european_option_price",
    "bootstrap_from_json",
    "calibrate_historical",
    "calibrate_implied",
    "compare_cs_params",
    "cs_variance",
    "extract_cs_params",
    "run_cs_calibration",
    "get_day_count_accrual",
    "calibrate_hw1f_interest_rate",
    "compare_hw1f_params",
    "extract_hw1f_params",
]
