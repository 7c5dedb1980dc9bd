"""The loop that drives the system in the measured window: one client
calls ``service.price`` with the next request as soon as the last one
returned, until the window's seconds are spent; the requests are made
before the window opens."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List


@dataclass
class Record:
    """One request of the window (host-clock seconds)."""

    trades: list
    due: float
    done: float = 0.0
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error


def closed_loop(price: Callable, requests: Callable[[int], list], seconds: float,
                keep: Callable[[list, list], None]) -> List[Record]:
    """Requests ``requests(0), requests(1), ...`` back to back for ``seconds``;
    ``keep(trades, rows)`` sees each answer, which the record then drops."""
    records: List[Record] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rec = Record(trades=requests(len(records)), due=time.perf_counter())
        try:
            rows = price(rec.trades)
        except Exception as e:  # noqa: BLE001 - a failed request is counted, and the run goes on
            rec.error = repr(e)
        rec.done = time.perf_counter()
        if rec.ok:
            keep(rec.trades, rows)
        records.append(rec)
    return records
