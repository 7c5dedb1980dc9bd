"""The port's spans (``finite_difference_tpu_torch.tracing``) on the CPU.

Without a profiler nothing records and a span is one shared object; under
``torch.profiler.profile`` the services and the batch drivers record their
layers nested inside one ``service.price`` a request, at most 24 spans a
request, and price the same rows bit for bit as without it. Every name the
port passes to ``tracing.span`` or ``tracing.covering`` carries a program
prefix, which is how a trace reader tells the program's ranges from the
device's operations (``tracing.inside`` too, the parts of a mesh split).
"""
import ast
from collections import Counter, deque
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import finite_difference_tpu_torch
from finite_difference_tpu_torch import tracing
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.parallel.mesh import make_mesh
from finite_difference_tpu_torch.serving import AmericanPricingService, BarrierPricingService
from finite_difference_tpu_torch.utils import profiling

PACKAGE = Path(finite_difference_tpu_torch.__file__).resolve().parent
SPANS = {
    "service.price", "service.build_batch", "service.trade_fields", "service.host_copy",
    "service.ki_parity", "batch.build_grids", "batch.build_arrays", "batch.upload",
    "batch.driver", "batch.route", "batch.spike_prep", "batch.march", "batch.greeks",
    "batch.solve", "batch.shard_copy", "batch.shard", "batch.gather",
}
MONITORS = [0.02, 0.04, 0.06, 0.08]


def _barrier_trades():
    base = dict(spot=100.0, strike=95.0, sigma=0.3, t_expiry=0.08, r=0.05, is_call=True,
                monitor_times=list(MONITORS))
    return [
        dict(base, barrier_type="up-and-out", upper=130.0),
        dict(base, barrier_type="up-and-in", upper=120.0, rebate=1.5),
        dict(base, spot=90.0, barrier_type="down-and-in", lower=80.0, is_call=False),
        dict(base, barrier_type="none"),
        dict(base, sigma=0.25, barrier_type="double-out", lower=70.0, upper=140.0),
    ]


def _american_trades():
    return [dict(spot=s, strike=100.0, sigma=0.3, t_expiry=0.5, r=0.05, is_call=False,
                 dividends=[[0.25, 1.2]]) for s in (90.0, 100.0, 110.0)]


SERVICES = {
    "barrier": (lambda: BarrierPricingService(32, 63, min_bucket=4, max_bucket=64, device="cpu"),
                _barrier_trades),
    "american": (lambda: AmericanPricingService(32, 62, min_bucket=4, max_bucket=64, richardson=True,
                                                device="cpu"), _american_trades),
}


def _profiled(fn):
    """``fn()`` under the profiler, with the spans it recorded."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = list(tracing.records)
    tracing.clear()
    return out, recs, prof


def _parents(recs):
    """Each record's enclosing record (None for a root): the last record
    opened before it whose interval holds it (records keep opening order)."""
    out = []
    for i, rec in enumerate(recs):
        out.append(next((p for p in reversed(recs[:i])
                         if p.start_ns <= rec.start_ns and rec.end_ns <= p.end_ns), None))
    return out


def _per_request(recs):
    """The number of records inside each ``service.price``."""
    roots = [r for r in recs if r.name == "service.price"]
    return [sum(root.start_ns <= r.start_ns and r.end_ns <= root.end_ns for r in recs)
            for root in roots]


def _batch(sigma=0.3, n=3):
    return port_batch.build_trade_batch(
        spots=[100.0] * n, strikes=[95.0] * n, sigmas=[sigma] * n, t_expiry=[0.08] * n,
        r=[0.05] * n, b=[0.05] * n, is_call=[True] * n, n_time_steps=32,
        monitor_times=[MONITORS] * n, upper=[130.0] * n, num_space_nodes=63, device="cpu")


def test_nothing_records_without_a_profiler():
    tracing.clear()
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("service.price") is tracing.span("batch.driver", route="spike")
    assert tracing.covering("batch.solve") is tracing.span("batch.march")
    with tracing.span("batch.upload") as rec:
        assert rec is None
        assert tracing.current("batch.upload") is None
    make, trades = SERVICES["barrier"]
    make().price(trades())
    assert list(tracing.records) == []


def test_spans_nest_inside_one_price_a_request():
    make, trades = SERVICES["barrier"]
    svc = make()
    _, recs, prof = _profiled(lambda: [svc.price(trades()) for _ in range(2)])
    parents = _parents(recs)
    roots = [r for r, p in zip(recs, parents) if p is None]
    assert [r.name for r in roots] == ["service.price"] * 2
    assert roots[0].end_ns <= roots[1].start_ns
    assert roots[0].attrs == {"trades": 5, "bucket": 8}
    assert all(r.start_ns <= r.end_ns for r in recs)
    parent_of = {r.name: p.name for r, p in zip(recs, parents) if p is not None}
    assert parent_of == {
        "service.build_batch": "service.price", "service.trade_fields": "service.build_batch",
        "batch.build_grids": "service.build_batch", "batch.build_arrays": "service.build_batch",
        "batch.upload": "service.build_batch", "batch.driver": "service.price",
        "batch.route": "batch.driver", "batch.march": "batch.driver", "batch.greeks": "batch.driver",
        "service.host_copy": "service.price", "service.ki_parity": "service.price",
    }
    ki = [r for r in recs if r.name == "service.ki_parity"]
    assert [r.attrs["trades"] for r in ki] == [2, 2]
    # each span is a profiler range too
    names = {e.key for e in prof.key_averages()}
    assert {r.name for r in recs} <= names


def _under(event):
    """Every profiler event nested under ``event``."""
    for child in event.cpu_children:
        yield child
        yield from _under(child)


def test_knock_in_parity_copies_nothing_to_the_host(monkeypatch):
    """Inside ``service.ki_parity`` no tensor crosses to the host and
    nothing waits on the device: no ``.cpu()``, ``.numpy()``, ``.item()``
    or ``.tolist()``, and under the profiler no ``aten::_to_copy`` and no
    ``aten::_local_scalar_dense`` (the host copy follows the span)."""
    crossed = []
    for name in ("cpu", "numpy", "item", "tolist"):
        def wrapped(self, *a, _orig=getattr(torch.Tensor, name), _name=name, **kw):
            if tracing.current("service.ki_parity") is not None:
                crossed.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    make, trades = SERVICES["barrier"]
    svc = make()
    _, recs, prof = _profiled(lambda: svc.price(trades()))
    assert [r.attrs for r in recs if r.name == "service.ki_parity"] == [{"trades": 2}]
    spans = [e for e in prof.events() if e.name == "service.ki_parity"]
    inside = {e.name for span in spans for e in _under(span)}
    assert spans and inside
    assert not inside & {"aten::_to_copy", "aten::_local_scalar_dense"}
    assert crossed == []


def test_every_span_name_carries_a_program_prefix():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "covering", "inside")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "tracing"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), f"{path}: a span's name is a literal"
                names.add(arg.value)
    assert names == SPANS
    assert all(n.startswith(tracing.PREFIXES) for n in names)
    assert not any(n.startswith("bench.") for n in names)


@pytest.mark.parametrize("kind", sorted(SERVICES))
def test_rows_are_bit_identical_under_the_profiler(kind):
    make, trades = SERVICES[kind]
    want = make().price(trades())
    got, recs, _ = _profiled(lambda: make().price(trades()))
    assert got == want
    assert recs


@pytest.mark.parametrize("kind", sorted(SERVICES))
def test_a_request_records_at_most_24_spans(kind):
    make, trades = SERVICES[kind]
    svc = make()
    _, recs, _ = _profiled(lambda: [svc.price(trades()) for _ in range(3)])
    per_request = _per_request(recs)
    assert len(per_request) == 3 and sum(per_request) == len(recs)
    assert max(per_request) <= 24
    # on the CPU auto takes no SPIKE prep; Richardson builds and drives twice
    assert set(per_request) == {12 if kind == "barrier" else 21}


def test_upload_bytes_are_the_batch_tensors_bytes():
    tb, recs, _ = _profiled(_batch)
    (up,) = [r for r in recs if r.name == "batch.upload"]
    # the trades share one schedule: its row and the (B,) row index cross,
    # and the device expands the row to the trades
    per_trade = [getattr(tb, k) for k in port_batch.FIELD_NAMES if k not in port_batch.SCHEDULE_FIELDS]
    rows = [getattr(tb, k)[:1] for k in port_batch.SCHEDULE_FIELDS]
    assert up.attrs["bytes"] == sum(t.nbytes for t in per_trade + rows) + 8 * tb.batch_size > 0
    grids = [r for r in recs if r.name == "batch.build_grids"]
    assert [r.attrs["native"] for r in grids] == [port_batch.native.available()]


@pytest.mark.parametrize("sigma", [0.3, 0.315])
def test_driver_route_is_the_auto_rule(sigma):
    tb = _batch(sigma)
    layout = port_batch._spectral_layout(tb, 64)
    want = port_batch.auto_solver("cpu", None, True, spectral_ok=layout is not None)
    _, recs, _ = _profiled(lambda: port_batch.price_barrier_batch(tb, 64, device="cpu"))
    (drv,) = [r for r in recs if r.name == "batch.driver"]
    assert drv.attrs["route"] == want
    # at sigma 0.315 (b = r) the channels' conditioning guard refuses the layout
    assert drv.attrs["guard_refused"] == (sigma == 0.315) == (layout is None)
    names = Counter(r.name for r in recs)
    assert names == {"batch.driver": 1, "batch.route": 1, "batch.march": 1, "batch.greeks": 1}


@pytest.mark.parametrize("split", ["chunks", "shards"])
def test_a_split_call_is_one_solve_span(split):
    """A scan in chunks, or a call over a mesh's shards, records one
    ``batch.solve`` over every kernel call and no kernel call's span inside
    it; over shards it records the split's own parts there, a copy and an
    issue a shard and one gather, and in chunks nothing."""
    tb = _batch(n=9)
    kw = (dict(solver="scan", max_chunk=4) if split == "chunks"
          else dict(mesh=make_mesh(devices=["cpu"] * 3)))
    got, recs, _ = _profiled(lambda: port_batch.price_barrier_batch(tb, 64, device="cpu", **kw))
    names = Counter(r.name for r in recs)
    parts = {} if split == "chunks" else {"batch.shard_copy": 3, "batch.shard": 3, "batch.gather": 1}
    assert names == {"batch.driver": 1, "batch.route": 1, "batch.solve": 1, **parts}
    (solve,) = [r for r in recs if r.name == "batch.solve"]
    assert solve.attrs == {}
    want = port_batch.price_barrier_batch(tb, 64, device="cpu", **kw)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # recording resumes after the covering span
    _, recs, _ = _profiled(lambda: port_batch.price_barrier_batch(tb, 64, device="cpu"))
    assert "batch.march" in {r.name for r in recs}


def test_records_are_bounded_and_cleared_when_a_trace_starts(monkeypatch, tmp_path):
    assert tracing.records.maxlen == tracing.MAX_RECORDS
    monkeypatch.setattr(tracing, "records", deque(maxlen=3))
    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    for name in ("batch.route", "batch.march", "batch.greeks", "batch.upload"):
        with tracing.span(name):
            pass
    assert [r.name for r in tracing.records] == ["batch.march", "batch.greeks", "batch.upload"]
    monkeypatch.undo()
    tracing.records.append(tracing.Record("batch.route", {}))
    with profiling.trace(str(tmp_path)):
        _batch()
    assert [r.name for r in tracing.records] == ["batch.build_grids", "batch.build_arrays",
                                                  "batch.upload"]
    tracing.clear()


def test_threads_keep_their_own_open_spans(monkeypatch):
    """Each thread nests its spans on its own stack (recording forced on:
    the profiler collects the thread that started it)."""
    import threading

    seen = {}

    def work(tag):
        rows = seen[tag] = []
        with tracing.span("service.price") as root:
            for _ in range(50):
                with tracing.span("batch.driver") as rec:
                    rows.append((tracing.current("batch.driver") is rec,
                                 tracing.current("service.price")))
                rows.append((tracing.current("service.price") is root, None))

    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    tracing.clear()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    tracing.clear()
    assert sorted(seen) == [0, 1, 2, 3]
    for rows in seen.values():
        assert rows == [(True, None)] * 100
