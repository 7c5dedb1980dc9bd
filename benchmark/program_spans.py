"""The program's own spans (``finite_difference_tpu_torch.tracing``), read
by the per-layer metrics in ``metrics/``: a span's share of the window, and
counts over the attributes of its records.

The port records its spans only while a profiler collects, so only in a
traced run. A reader returns None where the program holds no request of the
window (a program without the recorder, or an untraced run); a span that
never ran in a traced window reads 0. The recorder is imported when called,
as :mod:`system` imports the port.
"""
from __future__ import annotations

from typing import List, Optional

from . import stats


def _window(ctx) -> Optional[List]:
    """The program's closed span records that start in the window, or None
    where no ``service.price`` among them does."""
    try:
        from finite_difference_tpu_torch import tracing
    except ImportError:
        return None
    lo, hi = ctx.t0 * 1e9, ctx.t_end * 1e9
    recs = [r for r in tracing.records if r.end_ns is not None and lo <= r.start_ns <= hi]
    return recs if any(r.name == "service.price" for r in recs) else None


def share(ctx, name: str) -> Optional[float]:
    """The share of the window, in percent, that the spans ``name`` cover."""
    recs = _window(ctx)
    if recs is None:
        return None
    spans = [(r.start_ns / 1e9, r.end_ns / 1e9) for r in recs if r.name == name]
    return 100.0 * stats.covered(spans, ctx.t0, ctx.t_end) / ctx.window_s


def upload_mb_per_request(ctx) -> Optional[float]:
    """The bytes that ``batch.upload`` moved, over the requests (root
    ``service.price`` spans), in 10^6 B."""
    recs = _window(ctx)
    if recs is None:
        return None
    requests = sum(1 for r in recs if r.name == "service.price")
    moved = sum(r.attrs.get("bytes", 0) for r in recs if r.name == "batch.upload")
    return moved / requests / 1e6


def guard_refused_share(ctx) -> Optional[float]:
    """The share of ``batch.driver`` calls, in percent, in which a guard
    turned ``auto`` away from the route its rule prefers."""
    recs = _window(ctx)
    drivers = [r for r in recs if r.name == "batch.driver"] if recs is not None else []
    if not drivers:
        return None
    return 100.0 * sum(bool(r.attrs.get("guard_refused")) for r in drivers) / len(drivers)
