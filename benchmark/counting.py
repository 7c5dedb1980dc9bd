"""The work of the Crank–Nicolson problem a request poses, counted from the
trades and the configured grid, never from the route or the program's own
layout, so the count is the same whatever solves it.

- Operations: 10 flops per interior node and step (the right-hand side's
  three-point product 5, the tridiagonal solve's elimination 3 and
  back-substitution 2), 9 more in an American solve (the Ikonen–Toivanen
  source term 2 and projection 7), and 30 per node for each cash dividend's
  spline jump (system 8, coefficients 10, evaluation 8, shift and check 4).
- Solves per trade: the price and the one-sided vega re-solve when greeks
  are asked for; Richardson's runs at n and 2n steps each count as marched.
- Bytes: each input read once, each output written once: the trade's
  numbers as handed to the service and its priced row, at 8 bytes each.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

CN_FLOPS = 10
AMERICAN_FLOPS = 9
DIVIDEND_FLOPS = 30
WORD = 8


def _words(trade: Mapping[str, Any]) -> int:
    n = 0
    for v in trade.values():
        if isinstance(v, (list, tuple)):
            n += sum(len(x) if isinstance(x, (list, tuple)) else 1 for x in v)
        elif not isinstance(v, str):
            n += 1
    return n


def trade_work(trade: Mapping[str, Any], service: Mapping[str, Any]) -> Dict[str, float]:
    """(flops, bytes) of pricing one trade on the configured service."""
    american = service["kind"] == "american"
    steps = int(service["n_time_steps"])
    n_nodes = int(service["num_space_nodes"]) + (2 if american else 1)
    interior = n_nodes - 2
    greeks = bool(service.get("with_greeks", True))
    solves = 2 if greeks else 1
    runs = [steps, 2 * steps] if american and service.get("richardson") else [steps]
    per_node = CN_FLOPS + (AMERICAN_FLOPS if american else 0)
    n_div = sum(1 for tau, _ in trade.get("dividends", ()) if 0.0 < tau < trade["t_expiry"])
    flops = solves * sum(interior * n * per_node + n_div * DIVIDEND_FLOPS * n_nodes for n in runs)
    outputs = (5 if not american else 4) if greeks else 1
    return dict(flops=float(flops), bytes=float(WORD * (_words(trade) + outputs)))


def request_work(trades: Sequence[Mapping[str, Any]], service: Mapping[str, Any]) -> Dict[str, float]:
    out = dict(flops=0.0, bytes=0.0)
    for t in trades:
        w = trade_work(t, service)
        out["flops"] += w["flops"]
        out["bytes"] += w["bytes"]
    return out


def least_seconds(flops: float, nbytes: float, peak: Mapping[str, float], dtype: str):
    """The least time the chip could take, and what bounds it."""
    t_ops = flops / peak[f"{dtype}_flops"]
    t_bytes = nbytes / peak["bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
