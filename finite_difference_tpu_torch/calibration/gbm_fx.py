"""GBM FX implied calibration with declining-variance correction: the port
of ``finite_difference_tpu.calibration.gbm_fx``, host numpy.

Capability parity with the reference's ``gbm_fx_implied_calibration.py``
(:111-244 ATM extraction + correction, :246-460 bootstrap + comparison,
:507-616 exports) and ``gbm_risk_neutral_calibration.py:397-780``
(extraction / comparison / runner), plus the argparse CLI of
``gbm_fx_calibration_runner.py:70-396``. A comparison is a list of row
dicts per currency where JAX returns a DataFrame; the CSVs are written in
pandas' layout by ``runners._cli.write_rows``.

    python -m finite_difference_tpu_torch.calibration.gbm_fx market.json --csv-dir out
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .curve_data import curve_array as _curve_array

_MARKET_PRICE_TYPES = {"GBMAssetPriceTSModelPrices", "GBMTSModelPrices"}


def read_vol_surface(price_factors: dict, vol_name: str, is_fx: bool = True) -> np.ndarray:
    """(N, 3) array of (moneyness, expiry, vol) rows
    (gbm_fx_implied_calibration.py:79-109)."""
    prefix = "FXVol." if is_fx else "EquityPriceVol."
    key = vol_name if vol_name.startswith(prefix) else prefix + vol_name
    if key not in price_factors:
        raise KeyError(f"{key} not found in Price Factors")
    arr = _curve_array(price_factors[key].get("Surface", price_factors[key].get("Curve")))
    if arr.ndim != 2 or arr.shape[1] < 3:
        raise ValueError(f"Unexpected vol surface shape {arr.shape} for {key}")
    return arr[:, :3]


def extract_atm_vols(surface_arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ATM (moneyness=1) vols per expiry (gbm_fx_implied_calibration.py:111-141)."""
    expiries = np.unique(surface_arr[:, 1])
    atm_vols = np.empty(len(expiries))
    for i, exp in enumerate(expiries):
        slice_ = surface_arr[surface_arr[:, 1] == exp]
        order = np.argsort(slice_[:, 0])
        atm_vols[i] = float(np.interp(1.0, slice_[order, 0], slice_[order, 2]))
    return expiries, atm_vols


def correct_declining_variance(expiries, atm_vols):
    """Make V(t) = sigma_avg(t)^2 t non-decreasing by the piecewise-linear
    exact-integral rule (gbm_fx_implied_calibration.py:147-243).

    Returns (avg_vols, inst_vols, corrected, details).
    """
    expiries = np.asarray(expiries, dtype=float)
    atm_vols = np.asarray(atm_vols, dtype=float)
    n = len(expiries)
    if n == 0:
        return [], [], False, []

    dt = np.diff(np.concatenate([[0.0], expiries]))
    var_target = expiries * atm_vols**2

    sig = [float(atm_vols[0])]
    avg = [float(atm_vols[0])]
    var_prev = float(var_target[0])
    corrected = False
    details = [
        {
            "expiry": expiries[0],
            "raw_atm_vol": atm_vols[0],
            "avg_vol": atm_vols[0],
            "inst_vol": atm_vols[0],
            "var_target": var_target[0],
            "var_actual": var_target[0],
            "clamped": False,
        }
    ]

    for i in range(1, n):
        delta_t = dt[i] / 3.0
        var_t = float(var_target[i])
        M = var_prev + delta_t * sig[-1] ** 2
        clamped = False
        if var_t < M:
            corrected = True
            clamped = True
            var_t = M
        a = delta_t
        b = sig[-1] * delta_t
        c = M - var_t
        disc = b * b - 4.0 * a * c
        sig_i = (-b + np.sqrt(max(disc, 0.0))) / (2.0 * a)
        avg_i = np.sqrt(var_t / expiries[i])
        sig.append(float(sig_i))
        avg.append(float(avg_i))
        var_prev = var_t
        details.append(
            {
                "expiry": expiries[i],
                "raw_atm_vol": float(atm_vols[i]),
                "avg_vol": float(avg_i),
                "inst_vol": float(sig_i),
                "var_target": float(var_target[i]),
                "var_actual": float(var_t),
                "clamped": clamped,
            }
        )
    return avg, sig, corrected, details


def bootstrap_fx_from_json(
    json_path: str, fx_name: Optional[str] = None, verbose: bool = False
) -> Dict[str, dict]:
    """GBM FX calibration for all (or one) GBM*TSModelPrices entries
    (gbm_fx_implied_calibration.py:246-388)."""
    from ..scenarios.market_data import load_market_data

    market_data = load_market_data(json_path)
    price_factors = market_data.get("Price Factors", {})
    market_prices = market_data.get("Market Prices", {})

    results: Dict[str, dict] = {}
    for name, entry in market_prices.items():
        parts = name.split(".")
        if parts[0] not in _MARKET_PRICE_TYPES:
            continue
        currency = ".".join(parts[1:])
        if fx_name is not None and currency.upper() != fx_name.upper():
            continue
        instrument = entry.get("instrument", entry)
        vol_name = instrument.get("Asset_Price_Volatility", currency)
        surface = read_vol_surface(price_factors, vol_name, is_fx=True)
        expiries, atm_vols = extract_atm_vols(surface)
        avg, inst, corrected, details = correct_declining_variance(expiries, atm_vols)
        results[currency] = {
            "Vol": list(zip(expiries.tolist(), avg)),
            "InstantaneousVol": list(zip(expiries.tolist(), inst)),
            "corrected": corrected,
            "details": details,
            "raw_atm_vols": atm_vols.tolist(),
            "expiries": expiries.tolist(),
        }
        if verbose:
            print(f"{currency}: {len(expiries)} expiries, corrected={corrected}")
    return results


def extract_gbm_fx_params(
    json_path: str, fx_names: Optional[List[str]] = None, verbose: bool = False
) -> Dict[str, dict]:
    """Stored GBMAssetPriceTSModelParameters from the JSON
    (gbm_risk_neutral_calibration.py:397-478)."""
    with open(json_path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    md = raw.get("MarketData", raw)
    price_factors = md.get("Price Factors", {})
    out: Dict[str, dict] = {}
    for key, val in price_factors.items():
        if not key.startswith("GBMAssetPriceTSModelParameters."):
            continue
        ccy = key.split(".", 1)[1]
        if fx_names is not None and ccy not in fx_names:
            continue
        vol = val.get("Vol")
        if isinstance(vol, dict) and ".Curve" in vol:
            vol = vol[".Curve"]["data"]
        out[ccy] = {"Vol": vol, "Quanto_FX_Correlation": val.get("Quanto_FX_Correlation")}
    return out


def compare_gbm_fx_params(
    calibrated: Dict[str, dict], extracted: Dict[str, dict], verbose: bool = False
) -> Dict[str, List[dict]]:
    """Per-currency tenor-by-tenor vol comparison rows, keys Tenor,
    Calibrated, Extracted, Abs_Diff (gbm_risk_neutral_calibration.py:480-595)."""
    comparisons = {}
    for ccy, cal in calibrated.items():
        ext = extracted.get(ccy)
        if ext is None or not ext.get("Vol"):
            continue
        cal_map = {float(t): v for t, v in cal["Vol"]}
        ext_map = {float(t): float(v) for t, v in ext["Vol"]}
        rows = []
        for t in sorted(set(cal_map) | set(ext_map)):
            c, e = cal_map.get(t), ext_map.get(t)
            rows.append(
                {
                    "Tenor": t,
                    "Calibrated": c,
                    "Extracted": e,
                    "Abs_Diff": abs(c - e) if c is not None and e is not None else None,
                }
            )
        comparisons[ccy] = rows
        if verbose:
            print(f"{ccy}:")
            for row in rows:
                print("  ".join(f"{k}={v}" for k, v in row.items()))
    return comparisons


def export_gbm_fx_results(
    calibrated: Dict[str, dict],
    comparisons: Dict[str, List[dict]],
    output_dir: str,
) -> List[str]:
    """CSV export per currency (gbm_fx_implied_calibration.py:568-616):
    ``gbm_fx_<ccy>.csv`` of the correction's details and
    ``gbm_fx_<ccy>_comparison.csv`` of the comparison rows."""
    from ..runners._cli import write_rows

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for ccy, cal in calibrated.items():
        path = os.path.join(output_dir, f"gbm_fx_{ccy}.csv")
        write_rows(cal["details"], path)
        written.append(path)
        if ccy in comparisons:
            cpath = os.path.join(output_dir, f"gbm_fx_{ccy}_comparison.csv")
            write_rows(comparisons[ccy], cpath)
            written.append(cpath)
    return written


def run_gbm_fx_calibration(
    json_path: str,
    output_dir: Optional[str] = None,
    fx_names: Optional[List[str]] = None,
    verbose: bool = False,
) -> Tuple[Dict[str, dict], Dict[str, List[dict]]]:
    """Calibrate + extract + compare (+ export) in one call
    (gbm_risk_neutral_calibration.py:685-780)."""
    calibrated = {}
    for ccy in fx_names or [None]:
        calibrated.update(bootstrap_fx_from_json(json_path, ccy, verbose=verbose))
    extracted = extract_gbm_fx_params(json_path, fx_names, verbose=verbose)
    comparisons = compare_gbm_fx_params(calibrated, extracted, verbose=verbose)
    if output_dir:
        export_gbm_fx_results(calibrated, comparisons, output_dir)
    return calibrated, comparisons


def build_parser() -> argparse.ArgumentParser:
    """CLI mirror of gbm_fx_calibration_runner.py:313-368."""
    p = argparse.ArgumentParser(
        prog="gbm-fx-calibration",
        description="GBM FX implied calibration from a RiskFlow JSON file.",
    )
    p.add_argument("json_path", help="Path to the RiskFlow market-data JSON")
    p.add_argument("--fx", nargs="*", default=None, help="Currencies to calibrate")
    p.add_argument("--csv-dir", default=None, help="Directory for CSV exports")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    calibrated, comparisons = run_gbm_fx_calibration(
        args.json_path, output_dir=args.csv_dir, fx_names=args.fx,
        verbose=args.verbose,
    )
    for ccy, cal in calibrated.items():
        print(f"{ccy}: corrected={cal['corrected']}, vols={cal['Vol']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
