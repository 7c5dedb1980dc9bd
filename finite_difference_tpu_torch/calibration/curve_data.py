"""Shared normalization of RiskFlow curve encodings (the port's copy of
``finite_difference_tpu.calibration.curve_data``, numpy only).

One helper for the call sites that previously re-implemented it four
times (``cs.bootstrap_from_json``'s inner closure, ``gbm_fx._curve_array``,
``hw1f._unpack_curve``, ``pca.extract_pca_params``'s inner closure):
a MarketData.json factor may store its curve as

- ``{"_type": "Curve", "array": [[t, v], ...]}``
- ``{".Curve": {"meta": [...], "data": [[t, v], ...]}}``
- ``{"data": [[t, v], ...]}``
- a plain sequence of rows

and NOTHING in the loaders enforces row order. ``curve_array`` therefore
sorts rows ascending (lexicographic, matching ``sorted(rows)``) so that
``np.interp`` consumers are correct regardless of the JSON's row order —
the ``_type == "Curve"`` branch used to skip the sort, silently
corrupting every interpolated forward/discount rate on out-of-order
input.
"""
from __future__ import annotations

from typing import List

import numpy as np


def unpack_curve_rows(raw) -> List:
    """Rows from any curve encoding; [] for None/unrecognized dicts."""
    if raw is None:
        return []
    if isinstance(raw, dict):
        if raw.get("_type") == "Curve":
            return list(raw.get("array", []))
        if ".Curve" in raw:
            return list(raw[".Curve"].get("data", []))
        if "data" in raw:
            return list(raw["data"])
        return []
    return list(raw)


def curve_array(obj) -> np.ndarray:
    """Float ndarray of the curve rows, sorted ascending by tenor
    (full lexicographic row order, i.e. ``sorted(rows)`` semantics)."""
    arr = np.asarray(unpack_curve_rows(obj), dtype=float)
    if arr.ndim == 1:
        return np.sort(arr)
    if arr.ndim == 2 and arr.shape[0] > 1:
        order = np.lexsort(
            tuple(arr[:, c] for c in range(arr.shape[1] - 1, -1, -1))
        )
        arr = arr[order]
    return arr
