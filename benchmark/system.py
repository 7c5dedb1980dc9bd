"""The system under test: the port's pricing services, built from a
configuration's ``service`` section, and the spans and counters the
benchmark reads from them.

This module is the only one of the benchmark that imports the port, and it
imports it when called, so the rest of the benchmark (the reference, the
generator, the arithmetic) loads without it. Spans wrap the port's calls
from outside: a service instance's ``price``, ``build_batch`` and
knock-in parity, and the service module's names of the batch drivers. No
code is added to the port.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

SERVICE_CLASSES = {"barrier": "BarrierPricingService", "american": "AmericanPricingService"}
DRIVERS = {"barrier": "price_barrier_batch", "american": "price_american_batch"}


class Spans:
    """Host-clock spans by name, each also a profiler range when traced."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = {}

    @contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.by_name.setdefault(name, []).append((t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        wrapped.__wrapped__ = fn
        return wrapped

    def total(self, name: str, lo: float, hi: float) -> float:
        from .stats import covered

        return covered(self.by_name.get(name, ()), lo, hi)


def build_service(service: Dict[str, Any], device: str, spans: Spans, overrides=None):
    """The configured service on ``device``, its calls wrapped in spans;
    ``overrides`` (the control's section) replaces configured keys."""
    import numpy as np

    from finite_difference_tpu_torch import serving
    from finite_difference_tpu_torch.serving import service as service_module

    kw = dict(service, **(overrides or {}))
    kind = kw.pop("kind")
    for key in ("dtype", "greeks_dtype"):
        if key in kw:
            kw[key] = np.dtype(kw[key])
    svc = getattr(serving, SERVICE_CLASSES[kind])(device=device, **kw)
    svc.price = spans.wrap("service.price", svc.price)
    svc.build_batch = spans.wrap("service.build_batch", svc.build_batch)
    if hasattr(svc, "_apply_ki_parity"):
        svc._apply_ki_parity = spans.wrap("service.ki_parity", svc._apply_ki_parity)
    name = DRIVERS[kind]
    driver = getattr(service_module, name)
    if not hasattr(driver, "__wrapped__"):
        setattr(service_module, name, spans.wrap("batch.driver", driver))
    return svc


def unwrap_drivers() -> None:
    """Restore the service module's driver names."""
    from finite_difference_tpu_torch.serving import service as service_module

    for name in DRIVERS.values():
        fn = getattr(service_module, name)
        setattr(service_module, name, getattr(fn, "__wrapped__", fn))


def counters(svc) -> Dict[str, Any]:
    """A copy of the program's counters: the service's stats,
    the spectral route's graph counts and the kernels' launch counts."""
    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import spectral

    out = dict(service={k: v for k, v in svc.stats.items() if k != "bucket_hits"},
               buckets=dict(svc.stats["bucket_hits"]), graphs=dict(spectral.graph_counts),
               launches={k: v for k, v in kernels.launch_counts.items()})
    return out


def delta(after: Dict[str, Any], before: Dict[str, Any]) -> Dict[str, Any]:
    """``after`` - ``before``, group by group and key by key."""
    return {g: {k: v - before.get(g, {}).get(k, 0) for k, v in after[g].items()} for g in after}
