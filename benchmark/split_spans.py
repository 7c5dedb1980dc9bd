"""The program's spans of a mesh split (``batch.shard_copy``,
``batch.shard``, ``batch.gather``; ``finite_difference_tpu_torch.tracing``),
read by the ``.sweep4`` metrics in ``metrics/``.

A program that does not record the split's spans (one that splits no call,
or one from before they were added) holds none of them in the window: each
reader then returns None, as :mod:`program_spans`' readers do for an
untraced run.
"""
from __future__ import annotations

from typing import List, Optional

from . import program_spans

PARTS = ("batch.shard_copy", "batch.shard", "batch.gather")


def _split(ctx) -> Optional[List]:
    """The window's records, or None where none of them is a split's."""
    recs = program_spans._window(ctx)
    if recs is None or not any(r.name in PARTS for r in recs):
        return None
    return recs


def share(ctx, name: str) -> Optional[float]:
    """The share of the window, in percent, that the spans ``name`` cover."""
    return None if _split(ctx) is None else program_spans.share(ctx, name)


def peer_mb_per_request(ctx) -> Optional[float]:
    """The bytes that crossed between cards in the window's shard copies
    and gathers, over its requests (root ``service.price`` spans), in
    10^6 B."""
    recs = _split(ctx)
    if recs is None:
        return None
    requests = sum(1 for r in recs if r.name == "service.price")
    moved = sum(r.attrs.get("bytes", 0) for r in recs if r.name in ("batch.shard_copy", "batch.gather"))
    return moved / requests / 1e6
