"""Whether the rows the timed path returned are correct: a sample of them,
drawn from the seed, against the plain reference (:mod:`reference`), run
once the window has closed and the program's state is freed.

Each output (price, delta, ...) gives one number: the widest gap between
the program's row and the reference's over the sample, as a share of the
reference's largest magnitude of that output there. Each has a limit in the
configuration's ``check`` section. A request that the service answered
with an error makes the run not correct.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

from . import reference


class Sample:
    """``k`` (trade, returned row) pairs drawn from the seed, uniformly among
    every row offered, request by request (a reservoir): the window keeps
    only these rows, not every row it returned."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = int(k), 0, []
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 4])

    def offer(self, trades: Sequence[dict], rows: Sequence[dict]) -> None:
        fill = min(self.k - len(self.items), len(rows))
        self.items.extend(zip(trades[:fill], rows[:fill]))
        rest = len(rows) - fill
        if rest > 0:
            index = self.seen + fill + 1 + np.arange(rest)  # each row's place among all rows
            taken = np.flatnonzero(self.rng.random(rest) < self.k / index)
            for j, slot in zip(taken, self.rng.integers(0, self.k, len(taken))):
                self.items[slot] = (trades[fill + j], rows[fill + j])
        self.seen += len(rows)


def gaps(got: Sequence[dict], want: Sequence[dict]) -> Dict[str, float]:
    out = {}
    for key in want[0]:
        g = np.array([r.get(key, math.nan) for r in got], float)
        w = np.array([r[key] for r in want], float)
        gap = float(np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1e-300))
        out[key] = gap if math.isfinite(gap) else math.inf
    return out


def judge(config: dict, records, sample: Sample, device) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}) of a run's records and its
    sample of rows."""
    svc = config["service"]
    limits = config["check"]["limits"]
    pairs = sample.items
    checks = {}
    ok = bool(pairs)
    if pairs:
        trades = [t for t, _ in pairs]
        rows = reference.ROWS[svc["kind"]]
        kw = dict(richardson=bool(svc.get("richardson"))) if svc["kind"] == "american" else {}
        want = rows(trades, int(svc["n_time_steps"]), int(svc["num_space_nodes"]), device, **kw)
        for key, gap in gaps([r for _, r in pairs], want).items():
            checks[key] = dict(value=gap, limit=limits[key])
            ok &= gap <= limits[key]
    failed = sum(1 for r in records if not r.ok)
    checks["requests_in_error"] = dict(value=failed, limit=0)
    ok &= failed == 0
    return ok, checks
