"""Shared arithmetic of the metric readers in ``metrics/``: each reader is
a file of its own that calls one of these on the run's context."""
from __future__ import annotations

from typing import Optional

from . import counting, stats


def trades_per_s(ctx) -> Optional[float]:
    if not ctx.done:
        return None
    return stats.rate(sum(len(r.trades) for r in ctx.done), ctx.window_s)


def span_share(ctx, name: str) -> Optional[float]:
    """The share of the window, in percent, that spans ``name`` cover."""
    if name not in ctx.spans.by_name:
        return None
    return 100.0 * ctx.spans.total(name, ctx.t0, ctx.t_end) / ctx.window_s


def idle_share(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or t["window_s"] <= 0.0 or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def pde_roofline(ctx) -> Optional[float]:
    """The least time of the window's CN work (:mod:`counting`) over the
    device's busy time, in percent."""
    t, svc = ctx.trace, ctx.config["service"]
    if t is None or ctx.peak is None or t["busy_s"] <= 0.0 or not ctx.done:
        return None
    flops = nbytes = 0.0
    for r in ctx.done:
        w = counting.request_work(r.trades, svc)
        flops += w["flops"]
        nbytes += w["bytes"]
    least, _ = counting.least_seconds(flops, nbytes, ctx.peak, svc["dtype"])
    return 100.0 * least / t["busy_s"]
