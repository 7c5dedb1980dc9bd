"""Calibration layer (the port of ``finite_difference_tpu.calibration``):
the OU statistics of a panel, Clewlow–Strickland historical and implied
(the implied objective in torch on ``device``, its gradient by autograd),
Hull–White one-factor, the PCA interest-rate model and GBM FX from implied
vols (host numpy). Panels are :class:`statistics.Panel` (importable from
here too)."""
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
from .pca import (
    CalibrationInfo,
    calibrate_pca_interest_rate,
    compare_pca_params,
    compute_curve_statistics,
    extract_pca_params,
    pca,
)
from .gbm_fx import (
    bootstrap_fx_from_json,
    build_parser,
    compare_gbm_fx_params,
    correct_declining_variance,
    export_gbm_fx_results,
    extract_atm_vols,
    extract_gbm_fx_params,
    read_vol_surface,
    run_gbm_fx_calibration,
)

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
    "CalibrationInfo",
    "calibrate_pca_interest_rate",
    "compare_pca_params",
    "compute_curve_statistics",
    "extract_pca_params",
    "pca",
    "bootstrap_fx_from_json",
    "build_parser",
    "compare_gbm_fx_params",
    "correct_declining_variance",
    "export_gbm_fx_results",
    "extract_atm_vols",
    "extract_gbm_fx_params",
    "read_vol_surface",
    "run_gbm_fx_calibration",
]
