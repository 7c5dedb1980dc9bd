"""The traced window: ``torch.profiler`` over it, reduced to the device's
operation intervals, the kernel count, the busiest operations and the idle
gaps by what the host was doing.

A host span of the benchmark's own (``service.price``, ``batch.driver``,
...; see :mod:`system`) is a profiler range, so each idle gap is named by
the innermost such range over its midpoint, and by the host operation that
thread was in (``python`` between two operations); a gap that no range
covers is ``no request in service``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from . import stats

WINDOW = "bench.window"
SPAN_PREFIXES = ("service.", "batch.", "bench.")
TOP = 10


def profile():
    from torch.profiler import ProfilerActivity, profile as torch_profile

    return torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(prof) -> Dict:
    """``busy_s``, ``window_s``, ``kernels``, ``device_ops`` and
    ``idle_gaps`` of the traced window (the ``bench.window`` range)."""
    from torch.autograd import DeviceType

    device, host = [], []
    names: Dict[str, float] = defaultdict(float)
    kernels = 0
    window = None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.name().startswith(SPAN_PREFIXES) and e.device_type() == DeviceType.CUDA:
            continue  # a range of ours drawn on the device's timeline: no operation
        if e.device_type() == DeviceType.CUDA:
            device.append((start, end))
            names[e.name()] += (end - start) / 1e9
            kernels += not e.name().startswith(("Memcpy", "Memset"))
        elif e.name() == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, e.name(), e.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    lo, hi = window
    busy = stats.covered(device, lo, hi)
    return dict(
        busy_s=busy / 1e9, window_s=(hi - lo) / 1e9, kernels=kernels,
        device_ops=[[n[:160], s] for n, s in sorted(names.items(), key=lambda x: -x[1])[:TOP]],
        idle_gaps=_idle_by_host(stats.gaps(device, lo, hi), host),
    )


def _idle_by_host(gaps: List[Tuple[int, int]], host) -> List[list]:
    spans = sorted((s, e, n, t) for s, e, n, t in host if n.startswith(SPAN_PREFIXES))
    ops_by_thread = defaultdict(list)
    for s, e, n, t in host:
        if not n.startswith(SPAN_PREFIXES):
            ops_by_thread[t].append((s, e, n))
    index = {}
    for t, ops in ops_by_thread.items():
        ops.sort()
        index[t] = ([s for s, _, _ in ops], ops)
    span_starts = [s for s, _, _, _ in spans]
    totals: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "no request in service"
        j0 = bisect.bisect_right(span_starts, mid) - 1
        # spans nest a few deep per request: the covering one is among the last few begun
        for j in range(j0, max(j0 - 32, -1), -1):
            s, e, n, t = spans[j]
            if e >= mid:
                label = f"{n}/{_op_at(index.get(t), mid)}"
                break
        totals[label] += (g1 - g0) / 1e9
    return [[k, v] for k, v in sorted(totals.items(), key=lambda x: -x[1])[:TOP]]


def _op_at(index, t: int) -> str:
    """The host operation of one thread running at ``t``: the latest one
    started before it that has not ended, else ``python``."""
    if index is None:
        return "python"
    starts, ops = index
    j = bisect.bisect_right(starts, t) - 1
    best = "python"
    # the innermost op running at t started last among those still open
    for k in range(j, max(j - 64, -1), -1):
        s, e, n = ops[k]
        if e >= t:
            best = n
            break
    return best
