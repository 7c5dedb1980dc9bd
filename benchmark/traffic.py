"""The one generator of requests: a configuration's trade mix (its file's
``trades``) under a traffic mix (``traffic/<mix>.json``), both data.

A value in either file is a number, a string or a boolean, or a draw:
``{"uniform": [lo, hi]}``, ``{"int_uniform": [lo, hi]}`` (both ends
included), ``{"choice": [...]}``,
``{"linspace": [lo, hi, n]}`` (the trade's place in its book picks the
point), each optionally scaled by ``"times"``. A field listed in the trade
mix's ``per_request`` is drawn once per book; a ``choice`` drawn per request runs through its values
in a seeded order, each once per cycle, so every seed prices the same set.

Trade mix keys: ``fields`` (drawn for every trade), ``styles`` (weighted
alternatives of further fields, one drawn per trade), ``monitors``
(``{"count": draw}``: evenly spaced monitor times up to expiry) and
``dividends`` (``{"first", "every", "amount"}``: cash dividends at
``first + k every`` years before expiry, while before it).

Traffic keys (closed loops, one client): ``book`` (``{"size", "redraw":
"per_run" | "per_request"}``: one book for the whole pool, or a fresh one
for each request of it), ``ladder`` (``{"spot_rel": draw, "vol_abs":
draw}``: each book trade repeated at every point of the spot ladder times
the vol ladder), ``market_move`` (one spot and vol move per request, added
to every ladder point), ``pool`` (the number of distinct requests; the
window cycles through them, so set-up makes only these), ``seed``
(optional: the pool is drawn from it for every run, and the run's seed only
orders it; without it the pool is drawn from the run's seed) and
``warmup_requests`` (requests of the pool, in the order drawn and wrapping
round, priced before the window).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def seeded(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def draw(spec: Any, rng: np.random.Generator, index: int = 0):
    """One value of ``spec`` (see the module docstring)."""
    if not isinstance(spec, dict):
        return spec
    times = spec.get("times", 1.0)
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return float(rng.uniform(lo, hi)) * times
    if "int_uniform" in spec:
        lo, hi = spec["int_uniform"]
        return int(rng.integers(lo, hi + 1))
    if "choice" in spec:
        return spec["choice"][int(rng.integers(len(spec["choice"])))]
    if "linspace" in spec:
        lo, hi, n = spec["linspace"]
        return float(np.linspace(lo, hi, int(n))[index % int(n)]) * times
    raise ValueError(f"unknown draw {spec!r}")


def points(spec: Any) -> List[float]:
    """The points of a ladder draw (``linspace``) or a single number."""
    if isinstance(spec, dict) and "linspace" in spec:
        lo, hi, n = spec["linspace"]
        return [float(x) * spec.get("times", 1.0) for x in np.linspace(lo, hi, int(n))]
    return [float(spec)]


class Cycle:
    """A ``choice`` drawn per request: every value once per cycle, in a
    seeded order."""

    def __init__(self, values, rng):
        self.values, self.rng, self.queue = list(values), rng, []

    def next(self):
        if not self.queue:
            self.queue = [self.values[i] for i in self.rng.permutation(len(self.values))]
        return self.queue.pop()


class TradeMix:
    """Trade dicts from a configuration's ``trades`` section."""

    def __init__(self, spec: Dict[str, Any], rng: np.random.Generator):
        self.spec, self.rng = spec, rng
        self.per_request = set(spec.get("per_request", ()))
        self.cycles = {k: Cycle(v["choice"], rng) for k, v in spec["fields"].items()
                       if k in self.per_request and isinstance(v, dict) and "choice" in v}

    def shared(self) -> Dict[str, Any]:
        """The per-request fields of one request."""
        out = {}
        for k, v in self.spec["fields"].items():
            if k in self.per_request:
                out[k] = self.cycles[k].next() if k in self.cycles else draw(v, self.rng)
        return out

    def trade(self, shared: Dict[str, Any], index: int) -> Dict[str, Any]:
        rng, spec = self.rng, self.spec
        t = {k: (shared[k] if k in shared else draw(v, rng, index))
             for k, v in spec["fields"].items()}
        styles = spec.get("styles")
        if styles:
            w = np.array([s.get("weight", 1.0) for s in styles], float)
            style = styles[int(rng.choice(len(styles), p=w / w.sum()))]
            t.update({k: draw(v, rng, index) for k, v in style["fields"].items()})
        te = float(t["t_expiry"])
        if "monitors" in spec:
            n = int(draw(spec["monitors"]["count"], rng))
            t["monitor_times"] = [te * (k + 1) / n for k in range(n)]
        if "dividends" in spec:
            d = spec["dividends"]
            taus = []
            while d["first"] + len(taus) * d["every"] < te:
                taus.append(d["first"] + len(taus) * d["every"])
            t["dividends"] = [[tau, d["amount"]] for tau in taus]
        return t

    def book(self, size: int) -> List[Dict[str, Any]]:
        shared = self.shared()
        return [self.trade(shared, i) for i in range(size)]


def _ladder(book, traffic, rng) -> List[Dict[str, Any]]:
    """Each book trade at every spot x vol point, moved by one market move."""
    move = traffic.get("market_move", {})
    ds = float(draw(move.get("spot_rel", 0.0), rng))
    dv = float(draw(move.get("vol_abs", 0.0), rng))
    lad = traffic.get("ladder", {})
    out = []
    for t in book:
        for sr in points(lad.get("spot_rel", 0.0)):
            for va in points(lad.get("vol_abs", 0.0)):
                out.append(dict(t, spot=t["spot"] * (1.0 + ds + sr), sigma=t["sigma"] + dv + va))
    return out


class ClosedLoop:
    """The requests of a closed loop: a pool of ``pool`` distinct requests,
    drawn from the traffic's ``seed`` or else the run's, cycled in an order
    set by the run's seed."""

    def __init__(self, trades: Dict[str, Any], traffic: Dict[str, Any], seed: int):
        base = int(traffic.get("seed", seed))
        mix = TradeMix(trades, seeded(base, 1))
        moves = seeded(base, 2)
        size = int(traffic["book"]["size"])
        book = mix.book(size) if traffic["book"].get("redraw", "per_run") == "per_run" else None
        self.pool = [_ladder(book or mix.book(size), traffic, moves)
                     for _ in range(int(traffic["pool"]))]
        self.order = seeded(seed, 3).permutation(len(self.pool))
        self.warmup = [self.pool[i % len(self.pool)] for i in range(int(traffic.get("warmup_requests", 1)))]

    def request(self, i: int) -> List[Dict[str, Any]]:
        """The window's ``i``-th request."""
        return self.pool[self.order[i % len(self.pool)]]
