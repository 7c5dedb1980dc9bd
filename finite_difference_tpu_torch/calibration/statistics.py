"""OU / log statistics for time-series panels (RiskFlow calc_statistics):
the port of ``finite_difference_tpu.calibration.statistics``, host numpy.

Per-column OU estimates from daily levels —

    beta  = Cov(dX, X)/Var(X);  alpha = -N ln(1+beta), clipped
    sigma^2 = [Var(dX) - (1-e^{-a/N})^2 Var(X)] * 2a / (1-e^{-2a/N})
    theta = mean(X) + mean(dX)/(1-e^{-a/N})  (log-theta Jensen-adjusted)

Returns the stats table ('Volatility', 'Drift', 'Mean Reversion Speed',
'Long Run Mean', 'Reversion Volatility'), the delta correlation matrix, and
the delta panel, each a :class:`Panel` where the JAX package returns
DataFrames. ``smooth`` > 0 applies the outlier removal used by the
curve-panel variant (calibrations.py:272-416).

The JAX function is written in pandas; this one reproduces its semantics
in numpy: NaN-skipping reductions (each statistic over the rows where its
own operands are present), variances at ddof=1, time- or index-weighted
linear filling, and pairwise-complete Pearson correlation by pandas'
Welford recurrence.
"""
from __future__ import annotations

import datetime as dt
import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np

STATS_COLUMNS = ("Volatility", "Drift", "Mean Reversion Speed", "Long Run Mean",
                 "Reversion Volatility")


@dataclass(frozen=True, eq=False)
class Panel:
    """A column table: row labels ``index``, column labels ``columns`` and
    ``values``, a 2-D float64 array (rows, columns) in which NaN marks a
    missing value. ``panel[label]`` is a column."""

    index: tuple
    columns: tuple
    values: np.ndarray

    def __post_init__(self):
        values = np.asarray(self.values, dtype=np.float64)
        index, columns = tuple(self.index), tuple(self.columns)
        if values.shape != (len(index), len(columns)):
            raise ValueError(f"values {values.shape} do not match {len(index)} rows x {len(columns)} columns")
        object.__setattr__(self, "values", values)
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "columns", columns)

    def __getitem__(self, label) -> np.ndarray:
        return self.values[:, self.columns.index(label)]

    def __add__(self, shift: float) -> "Panel":
        return Panel(self.index, self.columns, self.values + shift)


def as_panel(table) -> Panel:
    """A :class:`Panel` from a panel, or from any table with ``.index``,
    ``.columns`` and ``.to_numpy()`` (a pandas DataFrame, for example)."""
    if isinstance(table, Panel):
        return table
    return Panel(list(table.index), list(table.columns), np.asarray(table.to_numpy(), dtype=np.float64))


def _is_datelike(x) -> bool:
    return isinstance(x, (dt.date, np.datetime64))


def _positions(index) -> np.ndarray:
    """The interpolation abscissae of an index: nanoseconds since the epoch
    for dates (pandas' ``method="time"``), else the labels as numbers
    (``method="index"``)."""
    if len(index) and all(_is_datelike(x) for x in index):
        return np.array([np.datetime64(x, "ns") for x in index]).astype(np.int64)
    return np.asarray([float(x) for x in index], dtype=np.float64)


def _fill_linear(y: np.ndarray, x: np.ndarray, keep_leading: bool) -> np.ndarray:
    """pandas' linear ``interpolate`` of one column over abscissae ``x``:
    interior gaps linear, trailing gaps flat; leading gaps stay NaN when
    ``keep_leading`` (pandas' default direction), else flat as well."""
    invalid = np.isnan(y)
    if invalid.all() or not invalid.any():
        return y
    out = y.copy()
    order = np.argsort(x[~invalid])
    out[invalid] = np.interp(x[invalid], x[~invalid][order], y[~invalid][order])
    if keep_leading:
        out[: int(np.argmax(~invalid))] = np.nan
    return out


def _by_column(a: np.ndarray) -> np.ndarray:
    # columns as contiguous rows, pandas' block layout: sums along them are
    # numpy's pairwise sums, as in pandas' reductions
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64).reshape(len(a), -1).T)


def _nanmean(a: np.ndarray) -> np.ndarray:
    """NaN-skipping column means (pandas ``mean(axis=0)``)."""
    t = _by_column(a)
    mask = np.isnan(t)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(mask, 0.0, t).sum(axis=1) / (~mask).sum(axis=1)


def _nanvar(a: np.ndarray, ddof: int = 1) -> np.ndarray:
    """NaN-skipping column variances by pandas' two-pass formula; NaN
    where a column has no more than ``ddof`` values."""
    t = _by_column(a)
    mask = np.isnan(t)
    count = (~mask).sum(axis=1).astype(np.float64)
    d = count - ddof
    count[d <= 0] = np.nan
    d[d <= 0] = np.nan
    values = np.where(mask, 0.0, t)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = values.sum(axis=1) / count
        sqr = (avg[:, None] - values) ** 2
        sqr[mask] = 0.0
        return sqr.sum(axis=1) / d


def _nanstd(a: np.ndarray, ddof: int = 1) -> np.ndarray:
    return np.sqrt(_nanvar(a, ddof))


def _nanmedian(a: np.ndarray) -> np.ndarray:
    t = _by_column(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmedian(t, axis=1)


def _nancorr(mat: np.ndarray) -> np.ndarray:
    """Pairwise-complete Pearson correlation of the columns of ``mat``:
    pandas' ``nancorr`` (Welford's recurrence over the rows both columns
    hold, clipped to [-1, 1]; NaN without a pair or a spread)."""
    n_rows, k = mat.shape
    valid = ~np.isnan(mat)
    nobs = np.zeros((k, k))
    meanx, meany = np.zeros((k, k)), np.zeros((k, k))
    ssqdmx, ssqdmy, covxy = np.zeros((k, k)), np.zeros((k, k)), np.zeros((k, k))
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(n_rows):
            both = valid[r][:, None] & valid[r][None, :]
            if not both.any():
                continue
            vx = np.broadcast_to(mat[r][:, None], (k, k))
            vy = np.broadcast_to(mat[r][None, :], (k, k))
            nobs = nobs + both
            dx, dy = vx - meanx, vy - meany
            inv = 1.0 / nobs
            mx = np.where(both, meanx + inv * dx, meanx)
            my = np.where(both, meany + inv * dy, meany)
            ssqdmx = np.where(both, ssqdmx + (vx - mx) * dx, ssqdmx)
            ssqdmy = np.where(both, ssqdmy + (vy - my) * dy, ssqdmy)
            covxy = np.where(both, covxy + (vx - mx) * dy, covxy)
            meanx, meany = mx, my
    divisor = np.sqrt(ssqdmx * ssqdmy)
    with np.errstate(divide="ignore", invalid="ignore"):
        val = np.clip(covxy / divisor, -1.0, 1.0)
    val[(divisor == 0) | (nobs < 1)] = np.nan
    # pandas computes the lower triangle (the row column first) and mirrors it
    low = np.tril(np.ones((k, k), dtype=bool))
    return np.where(low, val, val.T)


def calc_statistics(
    data_frame,
    method: str = "Log",
    num_business_days: float = 252.0,
    max_alpha: float = 4.0,
    smooth: float = 0.0,
) -> Tuple[Panel, Panel, Panel]:
    """(stats, correlation, delta) of a panel (a :class:`Panel` or any table
    with ``.index``, ``.columns`` and ``.to_numpy()``)."""
    if method not in ("Log", "Diff"):
        raise ValueError("method must be 'Log' or 'Diff'")

    panel = as_panel(data_frame)
    x_index = _positions(panel.index)
    order = np.argsort(x_index, kind="stable")
    values = panel.values[order]
    index = [panel.index[i] for i in order]
    x_index = x_index[order]
    rows = ~np.isnan(values).all(axis=1)
    values, x_index = values[rows], x_index[rows]
    index = [i for i, keep in zip(index, rows) if keep]
    cols = ~np.isnan(values).all(axis=0)
    values = values[:, cols]
    columns = [c for c, keep in zip(panel.columns, cols) if keep]

    if smooth > 0.0:
        med = _nanmedian(values)
        sd = _nanstd(values, ddof=0)
        with np.errstate(invalid="ignore"):
            keep = np.abs(values - med) <= smooth * sd
        values = np.where(keep, values, np.nan)
        values = np.column_stack([_fill_linear(values[:, j], x_index, keep_leading=False)
                                  for j in range(values.shape[1])]) if values.size else values

    y = values if method == "Diff" else np.log(np.clip(values, 0.0001, np.inf))
    data = np.full_like(y, np.nan)
    data[:-1] = y[1:] - y[:-1]  # dX aligned at t; the last row stays NaN
    n = num_business_days

    with np.errstate(divide="ignore", invalid="ignore"):
        xm, ym = _nanmean(data), _nanmean(y)
        beta = _nanmean((data - xm) * (y - ym)) / _nanmean((y - ym) ** 2.0)
        alpha = np.clip(-n * np.log(1.0 + beta), 0.001, max_alpha)
        theta = ym + xm / (1.0 - np.exp(-alpha / n))
        dt_factor = 1.0 - np.exp(-alpha / n)
        sigma2 = (_nanvar(data) - dt_factor**2 * _nanvar(y)) * (2.0 * alpha) / (
            1.0 - np.exp(-2.0 * alpha / n))

        if method == "Log":
            theta = np.exp(theta + sigma2 / (4.0 * alpha))
            theta[np.isinf(theta)] = np.nan
            median = _nanmedian(theta[:, None])[0]
            spread = 2 * _nanstd(theta[:, None])[0]
            theta[np.abs(theta - median) > spread] = np.nan

        stats = np.column_stack([
            _nanstd(data) * np.sqrt(n),
            xm * n,
            alpha,
            theta,
            np.sqrt(np.clip(sigma2, 0.0, None)),
        ]) if columns else np.empty((0, len(STATS_COLUMNS)))
    return (
        Panel(columns, STATS_COLUMNS, stats),
        Panel(columns, columns, _nancorr(data)),
        Panel(index, columns, data),
    )


def parse_tenor_labels(labels) -> np.ndarray:
    """Tenor year-fractions from panel column labels ('NAME,2.0' or plain
    numeric). Parse from the STATS index (the columns that survived
    calc_statistics' all-NaN drop), never the original panel columns —
    zipping original labels against surviving stats silently shifts every
    volatility/yield after a dropped column onto the wrong tenor."""
    return np.array(
        [
            float(str(x).split(",")[1]) if "," in str(x) else float(x)
            for x in labels
        ],
        dtype=np.float64,
    )


def force_positive_shift(curve_panel) -> float:
    """RiskFlow positivity shift: 0 if all positive else -5*min
    (calibrate_hw1f_interest_rate.py:29-35)."""
    values = as_panel(curve_panel).values
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        min_rate = float(np.nanmin(values)) if values.size else np.nan
    return 0.0 if min_rate > 0.0 else -5.0 * min_rate
