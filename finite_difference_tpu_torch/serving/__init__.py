"""Serving layer: shape-bucketed pricing services and a micro-batching server.

Counterpart of ``finite_difference_tpu.serving``:

- :class:`BarrierPricingService` / :class:`AmericanPricingService` —
  request batches rounded up to power-of-two buckets (padded with clones
  of the first trade), so a handful of batch shapes serve every request
  size;
- :class:`PricingServer` — a stdlib-only threaded HTTP front that
  coalesces concurrent requests into one device batch (micro-batching).

``python -m finite_difference_tpu_torch.serving`` starts the server.
"""
from .service import AmericanPricingService, BarrierPricingService
from .server import PricingServer

__all__ = [
    "AmericanPricingService",
    "BarrierPricingService",
    "PricingServer",
]
