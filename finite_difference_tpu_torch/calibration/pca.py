"""PCA interest-rate model calibration and parameter extraction: the port
of ``finite_difference_tpu.calibration.pca``, host numpy.

Capability parity with the reference's ``calibrations.py:19-168``
(compute_curve_statistics + calibrate_pca_interest_rate_manual) and
``extract_pca_params.py:1-99``: per-tenor OU statistics, covariance =
outer(reversion vols) * delta correlation, top-k eigendecomposition, and
the PCAInterestRateModel parameter dict (Reversion_Speed, Historical_Yield,
Yield_Volatility, Eigenvectors). Panels are :class:`~.statistics.Panel`
(or anything :func:`~.statistics.as_panel` takes); the comparison is a
list of row dicts where JAX returns a DataFrame.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict, namedtuple
from typing import Dict, List, Tuple, Union

import numpy as np

from .curve_data import unpack_curve_rows
from .hw1f import _abs_diff
from .statistics import Panel, _fill_linear, as_panel, calc_statistics, force_positive_shift, parse_tenor_labels

CalibrationInfo = namedtuple("CalibrationInfo", ["param", "correlation_coef", "delta"])


def pca(covariance: np.ndarray, num_factors: int):
    """Top-k PCA of a covariance matrix: (aki, eigenvectors, eigenvalues).

    aki = evec * sqrt(eval) (factor loadings), columns sorted by descending
    eigenvalue, mirroring riskflow utils.PCA.
    """
    evals, evecs = np.linalg.eigh(covariance)
    order = np.argsort(evals)[::-1][:num_factors]
    evals = evals[order]
    evecs = evecs[:, order]
    # deterministic sign: largest-magnitude entry positive
    for k in range(evecs.shape[1]):
        idx = np.argmax(np.abs(evecs[:, k]))
        if evecs[idx, k] < 0:
            evecs[:, k] = -evecs[:, k]
    aki = evecs * np.sqrt(np.maximum(evals, 0.0))[None, :]
    return aki, evecs, evals


def compute_curve_statistics(
    curve_panel,
    num_business_days: float = 252.0,
    max_alpha: float = 4.0,
) -> Tuple[Panel, Panel, Panel, float]:
    """(stats, correlation, delta, force_positive) (calibrations.py:19-52).

    ``calc_statistics`` drops the all-NaN rows and columns itself; the
    checks count what survives that drop."""
    panel = as_panel(curve_panel)
    missing = np.isnan(panel.values)
    if int((~missing.all(axis=0)).sum()) < 2:
        raise ValueError("Need at least 2 tenors for PCAInterestRate calibration.")
    if int((~missing.all(axis=1)).sum()) < 5:
        raise ValueError("Need more history to estimate OU/PCA stats reliably.")
    force_positive = force_positive_shift(panel)
    stats, correlation, delta = calc_statistics(
        panel + force_positive,
        method="Log",
        num_business_days=num_business_days,
        max_alpha=max_alpha,
    )
    return stats, correlation, delta, force_positive


def calibrate_pca_interest_rate(
    curve_panel,
    *,
    rate_drift_model: str = "Drift_To_Forward",
    matrix_type: str = "Covariance",
    distribution_type: str = "LogNormal",
    num_business_days: float = 252.0,
    num_factors: int = 3,
    max_alpha: float = 4.0,
) -> CalibrationInfo:
    """PCAInterestRateModel parameters (calibrations.py:57-129)."""
    stats, correlation, delta, force_positive = compute_curve_statistics(
        curve_panel, num_business_days=num_business_days, max_alpha=max_alpha
    )
    # tenors from the surviving stats rows (all-NaN columns are dropped
    # inside calc_statistics)
    tenors = parse_tenor_labels(stats.index)
    # pandas' Series.interpolate(): linear by position, leading gaps kept;
    # then bfill().ffill() for the reversion level
    positions = np.arange(len(stats.index), dtype=np.float64)
    standard_deviation = _fill_linear(stats["Reversion Volatility"], positions, keep_leading=True)
    covariance = (
        np.dot(standard_deviation.reshape(-1, 1), standard_deviation.reshape(1, -1))
        * correlation.values
    )
    aki, evecs, evals = pca(covariance, num_factors)
    with np.errstate(invalid="ignore"):
        alphas = stats["Mean Reversion Speed"]
        mean_reversion_speed = float(np.nanmean(alphas)) if (~np.isnan(alphas)).any() else float("nan")
    reversion_level = _fill_linear(stats["Long Run Mean"], positions, keep_leading=False)

    param = OrderedDict(
        {
            "Reversion_Speed": mean_reversion_speed,
            "Historical_Yield": list(zip(tenors.tolist(), reversion_level.tolist())),
            "Yield_Volatility": list(zip(tenors.tolist(), standard_deviation.tolist())),
            "Eigenvectors": [
                OrderedDict(
                    {
                        "Eigenvector": list(zip(tenors.tolist(), evec.tolist())),
                        "Eigenvalue": float(ev),
                    }
                )
                for evec, ev in zip(evecs.T, evals)
            ],
            "Rate_Drift_Model": rate_drift_model,
            "Princ_Comp_Source": matrix_type,
            "Distribution_Type": distribution_type,
            "Force_Positive": force_positive,
        }
    )
    return CalibrationInfo(param, aki.T, delta)


def extract_pca_params(filepath: str, asset_names: Union[str, List[str]]) -> Dict:
    """PCAInterestRateModel params from MarketData.json
    (extract_pca_params.py:1-66)."""
    if isinstance(asset_names, str):
        asset_names = [asset_names]
    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File not found: {filepath}")
    with open(filepath, "r", encoding="utf-8") as f:
        market_data = json.load(f)
    price_models = market_data.get("MarketData", {}).get("Price Models", {})

    results = {}
    for asset_name in asset_names:
        if asset_name not in price_models:
            continue
        model = price_models[asset_name]
        results[asset_name] = {
            "Reversion_Speed": model.get("Reversion_Speed"),
            "Historical_Yield": unpack_curve_rows(model.get("Historical_Yield")),
            "Yield_Volatility": unpack_curve_rows(model.get("Yield_Volatility")),
            "Eigenvectors": [
                {
                    "Eigenvalue": ev.get("Eigenvalue"),
                    "Eigenvector": unpack_curve_rows(ev.get("Eigenvector")),
                }
                for ev in model.get("Eigenvectors", [])
            ],
            "Rate_Drift_Model": model.get("Rate_Drift_Model"),
            "Princ_Comp_Source": model.get("Princ_Comp_Source"),
            "Distribution_Type": model.get("Distribution_Type"),
        }
    return results


def compare_pca_params(calibrated, extracted, asset_name: str) -> List[dict]:
    """Reversion speed and eigenvalue comparison rows (compare_pca_param
    fragment): keys Parameter, Calibrated, Extracted, Abs_Diff (NaN where
    either side is absent, as pandas' subtraction gives)."""
    cal = getattr(calibrated, "param", calibrated)
    ext = extracted.get(asset_name, extracted)
    rows = [
        {
            "Parameter": "Reversion_Speed",
            "Calibrated": cal.get("Reversion_Speed"),
            "Extracted": ext.get("Reversion_Speed"),
        }
    ]
    for k, (cal_ev, ext_ev) in enumerate(
        zip(cal.get("Eigenvectors", []), ext.get("Eigenvectors", []))
    ):
        rows.append(
            {
                "Parameter": f"Eigenvalue_{k}",
                "Calibrated": cal_ev.get("Eigenvalue"),
                "Extracted": ext_ev.get("Eigenvalue"),
            }
        )
    for row in rows:
        row["Abs_Diff"] = _abs_diff(row["Calibrated"], row["Extracted"])
    return rows
