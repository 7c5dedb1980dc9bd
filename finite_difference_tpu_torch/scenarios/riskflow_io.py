"""RiskFlow scenario-frame round-trip and comparison: the port of
``finite_difference_tpu.scenarios.riskflow_io``, host numpy.

Capability parity with cs_simulation.py:1079-1446: conversion between the raw
(n_steps, n_tenors, n_scenarios) array and RiskFlow's scenario frame layout
(rows = (tenor, scenario) pairs, tenor-major; columns = scenario dates),
CSV export in RiskFlow's format, extraction of scenario frames from a
Credit_Monte_Carlo output dict, and a moment/path-level/KS comparator.

Where the JAX package holds the frame in a pandas DataFrame (a
(tenor, scenario) MultiIndex by a DatetimeIndex), the port holds it in a
:class:`ScenarioFrame`. The CSV layout is pandas' (``tenor,scenario,<ISO
dates>``), so a file either package writes loads in the other; a DataFrame
in that layout is accepted wherever a frame is.
"""
from __future__ import annotations

import csv
import datetime as dt
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .time_grid import as_date


@dataclass(frozen=True, eq=False)
class ScenarioFrame:
    """RiskFlow's scenario frame: ``values`` (n_tenors * n_scenarios,
    n_dates), row ``i * n_scenarios + s`` holding tenor ``tenors[i]`` in
    scenario ``scenarios[s]``, column ``j`` the scenario date ``dates[j]``."""

    values: np.ndarray
    tenors: np.ndarray
    scenarios: np.ndarray
    dates: tuple

    def __post_init__(self):
        values = np.asarray(self.values, dtype=np.float64)
        tenors, scenarios = np.asarray(self.tenors), np.asarray(self.scenarios)
        dates = tuple(as_date(d) for d in self.dates)
        if values.shape != (tenors.size * scenarios.size, len(dates)):
            raise ValueError(f"values {values.shape} do not match {tenors.size} tenors x "
                             f"{scenarios.size} scenarios by {len(dates)} dates")
        for name, v in (("values", values), ("tenors", tenors), ("scenarios", scenarios), ("dates", dates)):
            object.__setattr__(self, name, v)

    def block(self, tenor) -> np.ndarray:
        """(n_scenarios, n_dates): the rows of one tenor (``df.loc[tenor]``)."""
        i = int(np.flatnonzero(self.tenors == tenor)[0])
        n = self.scenarios.size
        return self.values[i * n:(i + 1) * n]

    def to_array(self) -> np.ndarray:
        """(n_dates, n_tenors, n_scenarios)."""
        return self.values.T.reshape(len(self.dates), self.tenors.size, self.scenarios.size)


def as_scenario_frame(frame) -> ScenarioFrame:
    """A :class:`ScenarioFrame` from a frame, or from a pandas DataFrame in
    RiskFlow's layout (a tenor-major (tenor, scenario) row index)."""
    if isinstance(frame, ScenarioFrame):
        return frame
    tenors = np.asarray(list(dict.fromkeys(frame.index.get_level_values(0))))
    scenarios = np.asarray(list(dict.fromkeys(frame.index.get_level_values(1))))
    return ScenarioFrame(np.asarray(frame.to_numpy(), dtype=np.float64), tenors, scenarios,
                         tuple(frame.columns))


def to_riskflow_dataframe(simulated: np.ndarray, metadata: dict) -> ScenarioFrame:
    """(steps, tenors, scens) array -> RiskFlow scenario frame.

    Mirrors riskflow calculation.report (cs_simulation.py:1079-1122): rows
    are the (tenor excel-day, scenario) product, columns the scenario dates.
    """
    simulated = np.asarray(simulated)
    tenors_excel = metadata["tenors_excel"]
    base_date = as_date(metadata["base_date"])
    scen_time_grid = metadata["scen_time_grid"]
    n_timesteps, _, n_scenarios = simulated.shape

    scenario_dates = sorted(base_date + dt.timedelta(days=int(d)) for d in scen_time_grid)
    return ScenarioFrame(
        simulated.reshape(n_timesteps, -1).T,
        np.asarray(tenors_excel),
        np.arange(n_scenarios),
        tuple(scenario_dates[:n_timesteps]),
    )


def from_riskflow_dataframe(
    scenario_df, metadata: Optional[dict] = None
) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """Inverse of :func:`to_riskflow_dataframe` (cs_simulation.py:1125-1162):
    (simulated, tenors, scenario dates)."""
    frame = as_scenario_frame(scenario_df)
    simulated = frame.to_array()
    if metadata is not None:
        metadata["tenors_excel"] = frame.tenors
        metadata["total_scenarios"] = frame.scenarios.size
        metadata["scenario_dates"] = frame.dates
    return simulated, frame.tenors, frame.dates


def _cell(x) -> str:
    # pandas' to_csv text: integers as they are, floats in their shortest
    # round-trip form ("45693.0")
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    return repr(float(x))


def export_scenarios_csv(scenario_df, filepath: str, factor_name: Optional[str] = None) -> None:
    """CSV in RiskFlow's export layout (cs_simulation.py:1165-1191):
    ``tenor,scenario,<ISO dates>``, one row per (tenor, scenario)."""
    frame = as_scenario_frame(scenario_df)
    n = frame.scenarios.size
    with open(filepath, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["tenor", "scenario"] + [d.isoformat() for d in frame.dates])
        for r, row in enumerate(frame.values):
            writer.writerow([_cell(frame.tenors[r // n]), _cell(frame.scenarios[r % n])]
                            + [_cell(v) for v in row])


def _parse_numbers(texts):
    """A column of CSV text as pandas reads it: integers if every cell is
    one, else floats."""
    try:
        return np.array([int(t) for t in texts], dtype=np.int64)
    except ValueError:
        return np.array([float(t) for t in texts], dtype=np.float64)


def load_scenarios_csv(filepath) -> ScenarioFrame:
    """Exact inverse of :func:`export_scenarios_csv`.

    Reads the RiskFlow CSV layout back into the scenario frame
    :func:`to_riskflow_dataframe` produces. Beyond the reference
    (cs_simulation.py:1165-1191 exports but nothing loads); completes the
    CSV round-trip so exported cubes are re-ingestable by
    ``from_riskflow_dataframe``/``compare_scenario_outputs``.
    """
    with open(filepath, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], [r for r in rows[1:] if r]
    tenor_col = _parse_numbers([r[0] for r in body])
    scen_col = _parse_numbers([r[1] for r in body])
    tenors = np.asarray(list(dict.fromkeys(tenor_col.tolist())), dtype=tenor_col.dtype)
    scenarios = np.asarray(list(dict.fromkeys(scen_col.tolist())), dtype=scen_col.dtype)
    expect_t = np.repeat(tenors, scenarios.size)
    expect_s = np.tile(scenarios, tenors.size)
    if len(body) != expect_t.size or not (np.array_equal(tenor_col, expect_t)
                                          and np.array_equal(scen_col, expect_s)):
        raise ValueError(f"{filepath}: rows are not the tenor-major (tenor, scenario) product")
    values = np.array([[float(v) for v in r[2:]] for r in body], dtype=np.float64)
    return ScenarioFrame(values.reshape(len(body), len(header) - 2), tenors, scenarios,
                         tuple(as_date(d) for d in header[2:]))


def load_riskflow_scenarios(riskflow_output, factor_name: str):
    """Pull one factor's scenario frame out of a RiskFlow output dict.

    Handles out['Results']['scenarios'][name], out['scenarios'][name], a
    plain {name: frame} dict, an already-extracted frame, or a path to a
    CSV written by :func:`export_scenarios_csv`; falls back to substring
    matching on the factor name (cs_simulation.py:1194-1245).
    """
    if isinstance(riskflow_output, ScenarioFrame) or hasattr(riskflow_output, "to_numpy"):
        return riskflow_output
    if isinstance(riskflow_output, (str, os.PathLike)):
        return load_scenarios_csv(riskflow_output)

    if "Results" in riskflow_output:
        scenarios = riskflow_output["Results"].get("scenarios", {})
    elif "scenarios" in riskflow_output:
        scenarios = riskflow_output["scenarios"]
    else:
        scenarios = riskflow_output

    if factor_name in scenarios:
        return scenarios[factor_name]
    for key, df in scenarios.items():
        if factor_name in str(key) or str(key) in factor_name:
            return df
    raise KeyError(
        f"No scenarios found for {factor_name!r}; available: {list(scenarios.keys())}"
    )


def compare_scenario_outputs(
    df_validation,
    df_riskflow,
    metadata: Optional[dict] = None,
    labels: Tuple[str, str] = ("Validation", "RiskFlow"),
    tol: float = 1e-6,
    verbose: bool = False,
) -> Dict:
    """Moment, path-level, and distributional comparison of two outputs.

    Mirrors cs_simulation.py:1248-1446: per-(tenor, date) cross-scenario
    moments (``moment_df``, a list of row dicts); if the scenario counts
    match, path-by-path max/mean abs and rel diffs plus correlation with a
    MATCH/MISMATCH verdict at ``tol``; otherwise two-sample KS tests.
    Returns the comparison dict (the reference's plots are dropped).
    """
    from scipy import stats as sp_stats

    fv, fr = as_scenario_frame(df_validation), as_scenario_frame(df_riskflow)
    common_tenors = sorted(set(fv.tenors.tolist()) & set(fr.tenors.tolist()))
    common_dates = sorted(set(fv.dates) & set(fr.dates))
    same_scenario_count = fv.scenarios.size == fr.scenarios.size

    if not common_tenors:
        return {"error": "no_common_tenors"}
    if not common_dates:
        return {"error": "no_common_dates"}

    col_v = {d: j for j, d in enumerate(fv.dates)}
    col_r = {d: j for j, d in enumerate(fr.dates)}

    def column_pair(tenor, date):
        return fv.block(tenor)[:, col_v[date]], fr.block(tenor)[:, col_r[date]]

    moment_records = []
    for tenor in common_tenors:
        for date in common_dates:
            vals_v, vals_r = column_pair(tenor, date)
            moment_records.append(
                {
                    "tenor": tenor,
                    "date": date,
                    "mean_val": np.mean(vals_v),
                    "mean_rf": np.mean(vals_r),
                    "mean_diff": np.mean(vals_v) - np.mean(vals_r),
                    "std_val": np.std(vals_v, ddof=1),
                    "std_rf": np.std(vals_r, ddof=1),
                    "std_diff": np.std(vals_v, ddof=1) - np.std(vals_r, ddof=1),
                    "p5_val": np.percentile(vals_v, 5),
                    "p5_rf": np.percentile(vals_r, 5),
                    "p95_val": np.percentile(vals_v, 95),
                    "p95_rf": np.percentile(vals_r, 95),
                }
            )

    path_results: Dict = {}
    ks_results: Dict = {}
    verdict = None
    if same_scenario_count:
        for tenor in common_tenors:
            for di in {0, len(common_dates) // 2, len(common_dates) - 1}:
                date = common_dates[di]
                vals_v, vals_r = column_pair(tenor, date)
                abs_diff = np.abs(vals_v - vals_r)
                rel_diff = abs_diff / np.maximum(np.abs(vals_r), 1e-10)
                degenerate = (
                    len(vals_v) < 2 or np.std(vals_v) == 0 or np.std(vals_r) == 0
                )
                corr = np.nan if degenerate else np.corrcoef(vals_v, vals_r)[0, 1]
                path_results[(tenor, date)] = {
                    "max_abs_diff": float(np.max(abs_diff)),
                    "mean_abs_diff": float(np.mean(abs_diff)),
                    "max_rel_diff": float(np.max(rel_diff)),
                    "mean_rel_diff": float(np.mean(rel_diff)),
                    "correlation": float(corr),
                }
        max_abs = max(v["max_abs_diff"] for v in path_results.values())
        verdict = "MATCH" if max_abs < tol else "MISMATCH"
        if verbose:
            print(f"Path-level verdict: {verdict} (max abs diff {max_abs:.2e})")
    else:
        for tenor in common_tenors:
            for di in {0, len(common_dates) // 2, len(common_dates) - 1}:
                date = common_dates[di]
                vals_v, vals_r = column_pair(tenor, date)
                ks_stat, ks_p = sp_stats.ks_2samp(vals_v, vals_r)
                ks_results[(tenor, date)] = {
                    "ks_stat": float(ks_stat),
                    "ks_pvalue": float(ks_p),
                    "match": bool(ks_p > 0.05),
                }

    return {
        "moment_df": moment_records,
        "path_results": path_results if same_scenario_count else None,
        "ks_results": ks_results or None,
        "common_tenors": common_tenors,
        "common_dates": common_dates,
        "same_scenario_count": same_scenario_count,
        "verdict": verdict,
    }
