"""Hull-White 1-factor interest-rate calibration: the port of
``finite_difference_tpu.calibration.hw1f``, host numpy.

Capability parity with the reference's ``calibrate_hw1f_interest_rate.py``
(:1-155 calibration, :157-228 extraction, :230-369 comparison): the
pre-computed-statistics-averaging method — force_positive shift, per-tenor
OU stats, scalar Alpha = mean of per-tenor alphas, Sigma stored as a
.Curve, Historical_Yield per tenor. Panels are :class:`~.statistics.Panel`
(or any table with ``.index``, ``.columns`` and ``.to_numpy()``); the
comparison is a list of row dicts where JAX returns a DataFrame.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .curve_data import unpack_curve_rows
from .statistics import Panel, _fill_linear, as_panel, calc_statistics, force_positive_shift, parse_tenor_labels


def calibrate_hw1f_interest_rate(
    curve_panel,
    num_business_days: float = 252.0,
    smooth: float = 0.0,
    frequency: int = 1,
    max_alpha: float = 4.0,
    rate_drift_model: str = "Drift_To_Forward",
    distribution_type: str = "Lognormal",
) -> Tuple[OrderedDict, Panel, Panel]:
    """(param OrderedDict, correlation, delta) from a rates panel."""
    panel = as_panel(curve_panel)
    force_positive = force_positive_shift(panel)
    stats, correlation, delta = calc_statistics(
        panel + force_positive,
        method="Log",
        num_business_days=num_business_days,
        max_alpha=max_alpha,
        smooth=smooth,
    )
    # tenors from the SURVIVING columns (all-NaN columns are dropped
    # inside calc_statistics; parsing the panel's columns would misalign
    # every tenor after a dropped column)
    tenor = parse_tenor_labels(stats.index)

    with np.errstate(invalid="ignore"):
        alphas = stats["Mean Reversion Speed"]
        mean_reversion_speed = float(np.nanmean(alphas)) if (~np.isnan(alphas)).any() else float("nan")
    # pandas' Series.interpolate(): linear by position, leading gaps kept;
    # then bfill().ffill() for the reversion level
    positions = np.arange(len(stats.index), dtype=np.float64)
    sigma_curve = _fill_linear(stats["Reversion Volatility"], positions, keep_leading=True)
    reversion_level = _fill_linear(stats["Long Run Mean"], positions, keep_leading=False)

    param = OrderedDict(
        {
            "Lambda": 0.0,
            "Alpha": mean_reversion_speed,
            "Sigma": {
                ".Curve": {
                    "meta": [],
                    "data": list(zip(tenor.tolist(), sigma_curve.tolist())),
                }
            },
            "Historical_Yield": list(zip(tenor.tolist(), reversion_level.tolist())),
            "Quanto_FX_Correlation": 0.0,
            "Quanto_FX_Volatility": 0.0,
            "Rate_Drift_Model": rate_drift_model,
            "Distribution_Type": distribution_type,
            "Force_Positive": force_positive,
        }
    )
    return param, correlation, delta


def extract_hw1f_params(filepath: str, asset_names: Union[str, List[str]]) -> Dict:
    """HullWhite1FactorInterestRateModel params from MarketData.json
    (extract_hw1f_params.py:1-74)."""
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
            "Lambda": model.get("Lambda"),
            "Alpha": model.get("Alpha"),
            "Sigma": unpack_curve_rows(model.get("Sigma")),
            "Quanto_FX_Correlation": model.get("Quanto_FX_Correlation"),
            "Quanto_FX_Volatility": model.get("Quanto_FX_Volatility"),
        }
    return results


def _abs_diff(c, e):
    # pandas' subtraction of an absent value gives NaN
    return float("nan") if c is None or e is None else abs(c - e)


def compare_hw1f_params(
    calibrated_param, extracted_param, asset_name: str,
    output_path: Optional[str] = None,
) -> List[dict]:
    """Alpha/Sigma comparison rows (compare_hw1f_params, :230-369): keys
    Parameter, Tenor, Calibrated, Extracted, Abs_Diff, Rel_Diff_Pct, written
    to ``output_path`` as CSV when one is given."""
    ext = extracted_param.get(asset_name, extracted_param)
    cal = getattr(calibrated_param, "param", calibrated_param)

    def curve_to_dict(pairs):
        pairs = unpack_curve_rows(pairs) if not isinstance(pairs, list) else pairs
        return {float(p[0]): float(p[1]) for p in pairs} if pairs else {}

    rows = [
        {
            "Parameter": "Alpha (Mean Reversion Speed)",
            "Tenor": "scalar",
            "Calibrated": cal.get("Alpha"),
            "Extracted": ext.get("Alpha"),
        }
    ]
    cal_sigma = curve_to_dict(cal.get("Sigma"))
    ext_sigma = curve_to_dict(ext.get("Sigma"))
    for t in sorted(set(cal_sigma) | set(ext_sigma)):
        rows.append(
            {
                "Parameter": "Sigma",
                "Tenor": t,
                "Calibrated": cal_sigma.get(t),
                "Extracted": ext_sigma.get(t),
            }
        )
    for row in rows:
        row["Abs_Diff"] = _abs_diff(row["Calibrated"], row["Extracted"])
        ext_abs = float("nan") if row["Extracted"] is None else max(abs(row["Extracted"]), 1e-12)
        row["Rel_Diff_Pct"] = row["Abs_Diff"] / ext_abs * 100.0
    if output_path:
        from ..runners._cli import write_rows

        write_rows(rows, output_path)
    return rows

