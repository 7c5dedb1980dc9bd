"""Micro-batching HTTP pricing server (stdlib only).

Counterpart of ``finite_difference_tpu.serving.server``. Concurrent
POST /price requests are coalesced by a single batcher thread into one
device batch per ``window_ms`` window: the kernels' throughput comes from
batch width, so N concurrent 1-trade requests cost one batch, not N.

Endpoints
---------
- ``POST /price``  body ``{"trades": [...]}`` → ``{"results": [...]}``
  (trade schema: the wrapped service's — see serving.service).
- ``GET /healthz`` → ``{"ok": true, "backend": ..., "stats": {...}}``.

The batcher thread does all device work. The handler threads make no CUDA
call: a spectral solve may be capturing a CUDA graph on the batcher thread,
and a capture fails on a CUDA call from any other thread. So ``/healthz``
reports a backend string made when the server is built.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

__all__ = ["PricingServer"]


class _Httpd(ThreadingHTTPServer):
    # http.server's default listen backlog is 5; a burst of concurrent
    # clients (the micro-batching pattern's whole point) overflows it and
    # the kernel resets the excess connections
    request_queue_size = 1024


def _backend(service) -> str:
    """The backend string of /healthz: "cuda (<card name>)", "cpu", or
    "unknown" for a service without a device."""
    dev = getattr(service, "device", None)
    if dev is None:
        return "unknown"
    dev = torch.device(dev)
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


class _Pending:
    """One enqueued request: its trades, and a slot the batcher fills."""

    __slots__ = ("trades", "event", "results", "error", "deadline")

    def __init__(self, trades: List[Dict[str, Any]], deadline: float) -> None:
        self.trades = trades
        self.event = threading.Event()
        self.results: Optional[List[Dict[str, float]]] = None
        self.error: Optional[str] = None
        # past this instant the client has already been told 504 —
        # pricing it would be dead work
        self.deadline = deadline


class PricingServer:
    """Wrap a bucketed pricing service in a micro-batching HTTP front.

    ``window_ms``: after the first request of a batch arrives, the
    batcher keeps draining the queue for this long (or until
    ``max_batch_trades``) before launching one coalesced ``service.price``
    call. 0 disables coalescing (one batch per request).

    Backpressure: the pending queue is bounded at ``max_queue`` requests —
    a flood beyond it is rejected with 503 instead of growing memory
    without bound — and a pending whose client already timed out (504)
    is dropped before pricing (counted in ``stats['dropped_expired']``),
    so overload never buys dead device work.
    """

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        window_ms: float = 5.0,
        max_batch_trades: Optional[int] = None,
        request_timeout_s: float = 300.0,
        max_queue: int = 256,
    ) -> None:
        self.service = service
        self.backend = _backend(service)
        self.window_s = max(float(window_ms), 0.0) / 1e3
        self.max_batch_trades = (
            max_batch_trades
            if max_batch_trades is not None
            else getattr(service, "max_bucket", None)
        )
        self.request_timeout_s = float(request_timeout_s)
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=max(int(max_queue), 1))
        self._stop = threading.Event()
        # batcher-thread-only: a drained-but-unbatched overflow pending
        self._carry: Optional[_Pending] = None
        # 'requests'/'rejected' are bumped from many handler threads (under
        # _stats_lock); the rest only from the single batcher thread
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "requests": 0,
            "batches": 0,
            "trades": 0,
            "rejected": 0,
            "dropped_expired": 0,
        }
        self._httpd = _Httpd((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #
    def start(self) -> "PricingServer":
        for name, target in (
            ("pricing-batcher", self._batcher_loop),
            ("pricing-http", self._httpd.serve_forever),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        # fast-wake the batcher's queue.get; if the bounded queue is full
        # the get(timeout=...) poll observes _stop within its timeout
        try:
            self._queue.put_nowait(None)  # type: ignore[arg-type]
        except queue.Full:
            pass
        for t in self._threads:
            t.join(timeout=10.0)

    def __enter__(self) -> "PricingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    # batcher                                                             #
    # ------------------------------------------------------------------ #
    def _drain_window(self, first: _Pending) -> List[_Pending]:
        batch = [first]
        total = len(first.trades)
        deadline = time.monotonic() + self.window_s
        while not self._stop.is_set():
            if self.max_batch_trades is not None and total >= self.max_batch_trades:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            if (
                self.max_batch_trades is not None
                and total + len(item.trades) > self.max_batch_trades
            ):
                # would overflow the bucket: carry it into the next batch
                # (a bounded queue may be full, so a put-back could
                # deadlock the sole consumer)
                self._carry = item
                break
            batch.append(item)
            total += len(item.trades)
        return batch

    def _batcher_loop(self) -> None:
        while not self._stop.is_set():
            item = self._carry
            self._carry = None
            if item is None:
                try:
                    item = self._queue.get(timeout=0.25)
                except queue.Empty:
                    continue
            if item is None:
                continue
            batch = self._drain_window(item)
            # drop pendings whose client already got 504 — pricing them
            # would be dead device work under overload
            now = time.monotonic()
            live = []
            for p in batch:
                if p.deadline <= now:
                    self.stats["dropped_expired"] += 1
                    p.event.set()
                else:
                    live.append(p)
            batch = live
            if not batch:
                continue
            trades: List[Dict[str, Any]] = []
            for p in batch:
                trades.extend(p.trades)
            try:
                results = self.service.price(trades)
            except Exception as e:  # noqa: BLE001 - report to each caller
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()
                continue
            self.stats["batches"] += 1
            self.stats["trades"] += len(trades)
            off = 0
            for p in batch:
                p.results = results[off : off + len(p.trades)]
                off += len(p.trades)
                p.event.set()

    # ------------------------------------------------------------------ #
    # http                                                                #
    # ------------------------------------------------------------------ #
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr spam
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path != "/healthz":
                    return self._send(404, {"error": "unknown path"})
                self._send(
                    200,
                    {
                        "ok": True,
                        "backend": server.backend,
                        "stats": dict(server.stats),
                        "service_stats": dict(server.service.stats),
                    },
                )

            def do_POST(self) -> None:
                if self.path != "/price":
                    return self._send(404, {"error": "unknown path"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    trades = req["trades"]
                    if not isinstance(trades, list):
                        raise TypeError("'trades' must be a list")
                except Exception as e:  # noqa: BLE001 - malformed request
                    return self._send(400, {"error": f"bad request: {e}"})
                if not trades:
                    return self._send(200, {"results": []})
                with server._stats_lock:
                    server.stats["requests"] += 1
                pending = _Pending(trades, time.monotonic() + server.request_timeout_s)
                try:
                    server._queue.put_nowait(pending)
                except queue.Full:
                    with server._stats_lock:
                        server.stats["rejected"] += 1
                    return self._send(503, {"error": "server overloaded, retry later"})
                if not pending.event.wait(server.request_timeout_s):
                    return self._send(504, {"error": "pricing timed out"})
                if pending.error is not None:
                    return self._send(500, {"error": pending.error})
                self._send(200, {"results": pending.results})

        return Handler
