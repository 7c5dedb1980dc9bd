"""CVAMarketData JSON loading (RiskFlow format): the port's copy of
``finite_difference_tpu.scenarios.market_data``, host only.

Capability parity with the reference's loader stack
(cs_simulation.py:221-554), mirroring riskflow's config.parse_json:

- a JSON ``object_hook`` converting RiskFlow custom types (.Curve, .Percent,
  .DateList, .ModelParams, ...) bottom-up; dates become ``datetime.date``
  (``datetime.datetime`` where the text carries a time of day) and
  ``.DateOffset`` the port's :class:`~.time_grid.DateOffset`, where JAX's
  loader builds pandas Timestamps and DateOffsets;
- two file formats: a standalone ``{"MarketData": {...}}`` file, and a
  deal/job file whose ``Calc.MergeMarketData`` section references a base
  market-data file plus ``ExplicitMarketData`` overrides;
- extractors for forward curves (tenors deduplicated as in riskflow
  Factor1D.get_tenor), CS model parameters (implied beats historical), and
  the correlation dictionary keyed ``(name1, name2) -> rho``.
"""
from __future__ import annotations

import datetime as dt
import json
import os
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

from .time_grid import DateOffset

_SECTION_DEFAULTS = (
    "Price Factors",
    "Price Models",
    "Model Configuration",
    "Correlations",
    "Valuation Configuration",
    "System Parameters",
    "Price Factor Interpolation",
)


def _timestamp(text):
    """A RiskFlow date string as a date, or a datetime when it carries a
    time of day other than midnight (pandas' ``Timestamp(text)``)."""
    stamp = dt.datetime.fromisoformat(str(text).strip().replace("/", "-"))
    return stamp.date() if stamp.time() == dt.time() and stamp.tzinfo is None else stamp


def _as_internal(dct: dict):
    """JSON object_hook for RiskFlow custom types (cs_simulation.py:221-263)."""
    if ".Curve" in dct:
        payload = dct[".Curve"]
        return {
            "_type": "Curve",
            "meta": payload["meta"],
            "array": np.array(sorted(payload["data"])),
        }
    if ".Percent" in dct:
        return dct[".Percent"] / 100.0
    if ".Basis" in dct:
        return dct[".Basis"]
    if ".Descriptor" in dct:
        return dct[".Descriptor"]
    if ".DateList" in dct:
        return OrderedDict(
            (_timestamp(date), val) for date, val in dct[".DateList"]
        )
    if ".DateEqualList" in dct:
        return [[_timestamp(v[0])] + v[1:] for v in dct[".DateEqualList"]]
    if ".CreditSupportList" in dct:
        return dct[".CreditSupportList"]
    if ".DateOffset" in dct:
        return DateOffset(**dct[".DateOffset"])
    if ".Offsets" in dct:
        return dct[".Offsets"]
    if ".Timestamp" in dct:
        return _timestamp(dct[".Timestamp"])
    if ".ModelParams" in dct:
        mp = dct[".ModelParams"]
        return {
            "_type": "ModelParams",
            "modeldefaults": mp.get("modeldefaults", {}),
            "modelfilters": mp.get("modelfilters", {}),
        }
    if ".Deal" in dct:
        return dct[".Deal"]
    return dct


def _flatten_correlations(market_data: dict) -> None:
    """Nested {name1: {name2: rho}} -> {(name1, name2): rho} in place."""
    corr = market_data.get("Correlations")
    if isinstance(corr, dict) and not any(
        isinstance(k, tuple) for k in corr.keys()
    ):
        flat = {}
        for rate1, rate_list in corr.items():
            if isinstance(rate_list, dict):
                for rate2, rho in rate_list.items():
                    flat[(rate1, rate2)] = rho
        market_data["Correlations"] = flat


def load_market_data(json_path: str) -> dict:
    """Load a RiskFlow market-data or deal JSON (cs_simulation.py:276-400).

    Returns the merged market-data dict with keys 'Price Factors',
    'Price Models', 'Model Configuration', 'Correlations', ... . Deal files
    load their referenced base MarketDataFile (relative to the deal file)
    first, then apply ExplicitMarketData overrides section by section.
    """
    with open(json_path, "rt") as f:
        data = json.load(f, object_hook=_as_internal)

    if "MarketData" in data:
        market_data = data["MarketData"]
        _flatten_correlations(market_data)
        return market_data

    if "Calc" in data and "MergeMarketData" in data.get("Calc", {}):
        merge = data["Calc"]["MergeMarketData"]
        base_params: dict = {k: {} for k in _SECTION_DEFAULTS}

        base_file = merge.get("MarketDataFile")
        if base_file:
            base_path = os.path.join(
                os.path.dirname(os.path.abspath(json_path)), base_file
            )
            if os.path.exists(base_path):
                with open(base_path, "rt") as f:
                    base_data = json.load(f, object_hook=_as_internal)
                if "MarketData" in base_data:
                    base_params = base_data["MarketData"]
                    _flatten_correlations(base_params)
            else:
                # reference prints "WARNING: Base market data file not
                # found" (cs_simulation.py merge path) — proceeding with
                # only the deal's explicit overrides is rarely intended
                import warnings

                warnings.warn(
                    f"Base market data file not found: {base_path}; "
                    "proceeding with ExplicitMarketData overrides only",
                    stacklevel=2,
                )

        for section, section_data in merge.get("ExplicitMarketData", {}).items():
            if isinstance(section_data, dict) and isinstance(
                base_params.get(section), dict
            ):
                base_params.setdefault(section, {}).update(section_data)
            else:
                base_params[section] = section_data

        for key in ("Valuation Configuration", "System Parameters"):
            if key in data["Calc"] and isinstance(data["Calc"][key], dict):
                if isinstance(base_params.get(key), dict):
                    base_params.setdefault(key, {}).update(data["Calc"][key])
                else:
                    base_params[key] = data["Calc"][key]

        _flatten_correlations(base_params)
        return base_params

    if "Price Factors" in data:
        return data

    raise KeyError(
        f"Cannot find market data in JSON; top-level keys: {list(data.keys())}"
    )


def extract_forward_curve(
    market_data: dict, factor_name: str
) -> Tuple[np.ndarray, np.ndarray, str]:
    """(tenor excel days, prices, currency) for a ForwardPrice factor.

    Mirrors riskfactors.ForwardPrice loading + Factor1D.get_tenor dedup
    (cs_simulation.py:403-445): tenors are unique-sorted and prices
    re-interpolated onto them.
    """
    factor_data = market_data["Price Factors"][factor_name]
    curve = factor_data["Curve"]
    if isinstance(curve, dict) and curve.get("_type") == "Curve":
        arr = curve["array"]
    else:
        arr = np.array(sorted(curve))
    tenors = np.unique(arr[:, 0])
    prices = np.interp(tenors, arr[:, 0], arr[:, 1])
    return tenors, prices, factor_data.get("Currency", "USD")


def extract_model_params(
    market_data: dict, factor_name: str
) -> Tuple[Dict[str, float], str]:
    """CS model params + model type ('implied' | 'historical').

    Implied parameters live in Price Factors under
    ``CSForwardPriceModelParameters.<name>`` (drift forced to 0); historical
    under Price Models ``CSForwardPriceModel.<name>``
    (cs_simulation.py:446-515).
    """
    commodity = factor_name.replace("ForwardPrice.", "")
    model_config = market_data.get("Model Configuration", {})
    configured = (
        model_config.get("ForwardPrice") if isinstance(model_config, dict) else None
    )

    implied_key = f"CSForwardPriceModelParameters.{commodity}"
    historical_key = f"CSForwardPriceModel.{commodity}"

    if configured == "CSImpliedForwardPriceModel" or implied_key in market_data.get(
        "Price Factors", {}
    ):
        implied = market_data["Price Factors"].get(implied_key, {})
        if not implied:
            # reference semantics (cs_simulation.py:491-501): a configured
            # implied model with a missing/typo'd parameters factor falls
            # back to Sigma=0.3/Alpha=1.0 — kept for parity, but a whole
            # simulation on invented calibration deserves noise
            import warnings

            warnings.warn(
                f"{implied_key} absent from Price Factors; simulating "
                f"{commodity!r} with DEFAULT implied params Sigma=0.3 "
                "Alpha=1.0 (reference fallback semantics)"
            )
        return (
            {
                "Sigma": implied.get("Sigma", 0.3),
                "Alpha": implied.get("Alpha", 1.0),
                "Drift": 0.0,
            },
            "implied",
        )

    if historical_key in market_data.get("Price Models", {}):
        hist = market_data["Price Models"][historical_key]
        return (
            {
                "Sigma": hist.get("Sigma", 0.3),
                "Alpha": hist.get("Alpha", 1.0),
                "Drift": hist.get("Drift", 0.0),
            },
            "historical",
        )

    raise KeyError(
        f"No model parameters found for {commodity!r} in Price Models or Price Factors"
    )


_FACTOR_TYPES = (
    "ForwardPrice", "InterestRate", "FxRate", "EquityPrice",
    "PriceIndex", "ReferencePrice",
)


def _strip_process_prefix(name: str) -> str:
    """RiskFlow correlation keys carry the stochastic-process prefix
    ('ClewlowStricklandProcess.ForwardPrice.X' — riskflow config.py:739)
    while the simulation factors are keyed by bare factor name. Strip one
    leading process token when the remainder starts with a known factor
    type."""
    parts = name.split(".", 1)
    if len(parts) == 2 and parts[1].split(".", 1)[0] in _FACTOR_TYPES:
        return parts[1]
    return name


def extract_correlations(market_data: dict) -> Dict[Tuple[str, str], float]:
    """Correlation dict keyed (name1, name2) (cs_simulation.py:517-554).

    Keys are registered BOTH as written and with the process prefix
    stripped: the reference's build_cholesky looks correlations up by
    bare factor name against prefixed JSON keys and silently got rho=0
    for every configured pair (its own docstring notes the prefix,
    cs_simulation.py:527-530, but never strips it) — real RiskFlow maps
    the prefix in config.py:739. Documented reference correction.
    """
    corr_section = market_data.get("Correlations", {})
    correlations: Dict[Tuple[str, str], float] = {}

    def _put(k1: str, k2: str, rho: float) -> None:
        correlations[(k1, k2)] = rho
        stripped = (_strip_process_prefix(k1), _strip_process_prefix(k2))
        if stripped != (k1, k2):
            correlations.setdefault(stripped, rho)

    for key, val in corr_section.items():
        if isinstance(key, tuple):
            _put(key[0], key[1], val)
        elif isinstance(val, dict):
            for rate2, rho in val.items():
                _put(key, rate2, rho)
    return correlations
