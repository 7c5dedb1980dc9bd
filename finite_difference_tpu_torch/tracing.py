"""Spans of the port's pricing services and batch drivers, recorded on the
profiler's clock.

A span records only while a ``torch.profiler`` session is collecting on
the calling thread (``torch.autograd._profiler_enabled()``): under the
profiler, and so under ``utils.profiling.trace``. It is then a ``torch.profiler.record_function``
range, on the same timeline as the device's activity, and a :class:`Record`
in :data:`records`: its name, its start and end from
``time.perf_counter_ns()`` (the host clock of ``time.perf_counter``) and its
attributes. :data:`records` keeps the newest :data:`MAX_RECORDS` until
:func:`clear`; the ranges are in every trace the profiler writes, so
nothing is exported.

With no profiler collecting, :func:`span` costs one check: it returns one
shared context manager that yields None, reads no clock and opens no range.
A caller sets an attribute that costs work only on a yielded record::

    with tracing.span("batch.upload") as rec:
        ...
        if rec is not None:
            rec.attrs["bytes"] = nbytes

Every name starts with ``service.`` or ``batch.`` (:data:`PREFIXES`): a
trace reader tells the program's ranges, which the profiler also draws on
the device's timeline, from the device's operations by those prefixes. A
span wraps one call of a layer, never the body of a per-launch,
per-segment or per-chunk loop, so a request opens a few dozen at most; a
loop whose calls would each record is one :func:`covering` span. Inside
one, :func:`inside` records the parts of the covering span's own layer (a
mesh split's copy and issue per shard, and its gather), while every span
under them stays muted.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch
from torch.profiler import record_function

__all__ = ["PREFIXES", "MAX_RECORDS", "Record", "records", "span", "covering", "inside", "current",
           "clear"]

PREFIXES = ("service.", "batch.")
MAX_RECORDS = 1 << 17

_enabled = torch.autograd._profiler_enabled


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``perf_counter_ns``;
    ``end_ns`` None while open) and ``attrs``."""

    __slots__ = ("name", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name, self.attrs = name, attrs
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None


records: Deque[Record] = deque(maxlen=MAX_RECORDS)
_local = threading.local()


class _Off:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _open() -> List[Record]:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("record", "covers", "range")

    def __init__(self, name: str, attrs: Dict[str, Any], covers: bool = False) -> None:
        self.record, self.covers = Record(name, attrs), covers

    def __enter__(self) -> Record:
        rec = self.record
        records.append(rec)
        _open().append(rec)
        if self.covers:
            _local.muted = True
        self.range = record_function(rec.name)
        self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        self.record.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _open().pop()
        if self.covers:
            _local.muted = False
        return False


def span(name: str, **attrs):
    """A context manager around one call of a layer: a profiler range and a
    :class:`Record` (yielded) while a profiler collects, else nothing
    (yields None)."""
    if not _enabled() or getattr(_local, "muted", False):
        return _OFF
    return _Span(name, attrs)


def covering(name: str):
    """:func:`span` over a loop whose calls would each open spans (chunks,
    shards): inside it nothing else records on this thread."""
    if not _enabled() or getattr(_local, "muted", False):
        return _OFF
    return _Span(name, {}, covers=True)


def inside(name: str, **attrs):
    """:func:`span` for a part of a :func:`covering` span's own loop: it
    records while a profiler collects, though the covering span mutes this
    thread; the spans of the calls under it stay muted."""
    if not _enabled():
        return _OFF
    return _Span(name, attrs)


def current(name: str) -> Optional[Record]:
    """The innermost span open on this thread if it is ``name``, else None
    (always None while nothing records)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack and stack[-1].name == name else None


def clear() -> None:
    """Drop the records kept so far (between requests, not inside one)."""
    records.clear()
