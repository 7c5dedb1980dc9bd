"""Shared plumbing of the runner mains: the ``--cpu`` flag, and the config
and result tables as CSV files through the standard ``csv`` module."""
from __future__ import annotations

import csv
import math
from typing import Any, Dict, List, Optional, Sequence

from ..device import DEFAULT_DEVICE

Row = Dict[str, Any]


def add_backend_flag(parser) -> None:
    parser.add_argument(
        "--cpu",
        action="store_true",
        help="price on the CPU (the default is the CUDA card, and a run "
        "without one fails)",
    )


def device_of(args) -> str:
    """The device the ``--cpu`` flag asks for."""
    return "cpu" if getattr(args, "cpu", False) else DEFAULT_DEVICE


def _cell(text: str):
    """A config cell as ``pandas.read_csv`` reads it: a number where it parses
    as one, None where it is empty or NaN, else the string."""
    if text.strip() == "":
        return None
    try:
        x = float(text)
    except ValueError:
        return text
    return None if math.isnan(x) else x


def read_rows(path: str) -> List[Row]:
    """The config CSV's rows, each a dict from column name to cell."""
    with open(path, newline="") as fh:
        return [{k: _cell(v or "") for k, v in row.items()} for row in csv.DictReader(fh)]


def write_rows(rows: Sequence[Row], path: str) -> None:
    """Write result rows as a CSV with a header, NaN and None as empty cells
    (``DataFrame.to_csv``'s output for the same rows: the columns are every
    row's keys in order of first appearance, a row without a column empty
    there, as a runner's ``error`` row is)."""
    fields = list(dict.fromkeys(k for r in rows for k in r))
    empty = lambda v: v is None or (isinstance(v, float) and math.isnan(v))
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(fields)
        for r in rows:
            w.writerow(["" if empty(r.get(k)) else r[k] for k in fields])


def print_summary(rows: Sequence[Row], columns: Sequence[str] = (
        "scenario_name", "model_price", "FA_price", "price_pct_diff")) -> None:
    """Print the named columns of ``rows`` as a plain table."""
    cols = [c for c in columns if rows and c in rows[0]]
    fmt = lambda v: f"{v:.10g}" if isinstance(v, float) else str(v)
    table = [cols] + [[fmt(r[c]) for c in cols] for r in rows]
    widths = [max(len(line[i]) for line in table) for i in range(len(cols))]
    for line in table:
        print("  ".join(x.rjust(w) for x, w in zip(line, widths)))


def diff_block(prefix: str, model: float, fa: Optional[float]) -> Row:
    """The model value beside FA's, their absolute and percentage gaps (NaN
    where FA gives none)."""
    has_fa = fa is not None and not math.isnan(fa)
    return {
        f"model_{prefix}": model,
        f"FA_{prefix}": fa if has_fa else math.nan,
        f"{prefix}_diff": abs(model - fa) if has_fa else math.nan,
        f"{prefix}_pct_diff": abs(model - fa) / abs(fa) * 100.0 if has_fa and fa != 0.0 else math.nan,
    }

