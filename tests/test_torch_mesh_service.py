"""The pricing services over a mesh named as data, on the CPU.

A configuration file cannot hold a ``parallel.Mesh``, so the services (and
the batch drivers) also take a mesh as an int, the first n CUDA devices, or
as a list of device names (``parallel.mesh.check_mesh``); the benchmark's
four-card barrier deployment (``benchmark/configs/fa_barrier_f64_mesh4.json``)
names its mesh as the int 4. Here the mesh repeats the CPU, at a tiny grid:
the meshed rows equal the unmeshed service's (bit for bit on the scan
route, within 1e-12 of max|price| on the spectral route), agree with the
benchmark's plain reference within that configuration's limits, and a
request over the mesh records the split's spans (``batch.shard_copy``,
``batch.shard``, ``batch.gather``), with the bytes that crossed between
devices. A CUDA graph is captured on the stream of the card whose shard it
runs.
"""
import contextlib
import importlib.util
import json
from collections import Counter, OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from finite_difference_tpu_torch import parallel, tracing
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import spectral
from finite_difference_tpu_torch.parallel.mesh import Mesh, check_mesh
from finite_difference_tpu_torch.serving import AmericanPricingService, BarrierPricingService
from finite_difference_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "fa_barrier_f64_mesh4.json").read_text())
GRID = dict(n_time_steps=64, num_space_nodes=127)
CPU4 = ["cpu"] * 4
PARTS = ("batch.shard_copy", "batch.shard", "batch.gather")


def _bench_module(name: str):
    """A module of the benchmark by path (plain numpy and torch; it imports
    nothing of the port)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _bench_module("reference")
traffic = _bench_module("traffic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # step loops in Python (tests/test_torch_parallel.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _service(mesh=None, **kw):
    """The configuration's barrier service at the tiny grid, bucketed at 6
    so that its PDE batch is no multiple of the mesh's 4 (the driver pads
    it to 8)."""
    svc = {k: v for k, v in CONFIG["service"].items() if k not in ("kind", "mesh")}
    svc.update(GRID, min_bucket=2, max_bucket=6, **kw)
    return BarrierPricingService(device="cpu", mesh=mesh, **svc)


def _request():
    """Six trades of the configuration's desk mix: a book of 3 at two spot
    points of the ladder."""
    mix = dict(book={"size": 3, "redraw": "per_run"},
               ladder={"spot_rel": {"linspace": [-0.1, 0.1, 2]}, "vol_abs": 0.0},
               market_move={"spot_rel": 0.0, "vol_abs": 0.0}, pool=1, seed=20261018)
    return traffic.ClosedLoop(CONFIG["trades"], mix, 7).request(0)


def _gaps(got, want):
    """Per output, the widest gap over the largest magnitude of ``want``."""
    out = {}
    for key in want[0]:
        g = np.array([r[key] for r in got])
        w = np.array([r[key] for r in want])
        out[key] = float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300))
    return out


def test_a_mesh_named_as_data(monkeypatch):
    """A list (or tuple) of device names and a ``Mesh`` name the same mesh;
    the errors of a ``Mesh`` stay; an int wants the card."""
    want = parallel.make_mesh(4, devices=CPU4)
    for named in (CPU4, tuple(CPU4), [torch.device("cpu")] * 4, want):
        got = check_mesh(named, "cpu")
        assert isinstance(got, Mesh) and got.axis_names == ("data",)
        assert got.shape == (4,) and list(got.devices.flat) == list(want.devices.flat)
    assert check_mesh(want, "cpu") is want and check_mesh(None) is None
    for cls in (BarrierPricingService, AmericanPricingService):
        assert list(cls(device="cpu", mesh=CPU4).mesh.devices.flat) == list(want.devices.flat)
    with pytest.raises(ValueError, match="one type"):
        check_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="the call's device"):
        check_mesh(["cpu"] * 2, "cuda")
    for bad in (True, "cpu", object()):
        with pytest.raises(ValueError, match="mesh must be"):
            check_mesh(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_mesh(4)
    for cls in (BarrierPricingService, AmericanPricingService):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(device="cpu", mesh=4)
    # one card: an int or an index beyond what torch sees raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="sees only 1"):
        check_mesh(2)
    with pytest.raises(ValueError, match="sees only 1"):
        check_mesh(["cuda:0", "cuda:1"])
    assert list(check_mesh(1, "cuda").devices.flat) == [torch.device("cuda", 0)]


@pytest.mark.parametrize("solver", ["scan", "spectral"])
def test_meshed_rows_equal_the_unmeshed_service(solver):
    """Six trades, bucket 6, over 4 shards (padded to 8): the scan's rows bit
    for bit; the spectral route's per-shard DSTs may differ in the last bits,
    so each output within 1e-12 of max|price| (the vega bump's difference
    of two solves amplifies them about 1e4-fold, to ~1e-11 of max|vega|)."""
    trades = _request()
    assert len(trades) == 6
    got = _service(CPU4, solver=solver).price(trades)
    want = _service(solver=solver).price(trades)
    if solver == "scan":
        assert got == want
    else:
        scale = max(abs(r["price"]) for r in want)
        for key in want[0]:
            assert max(abs(a[key] - b[key]) for a, b in zip(got, want)) <= 1e-12 * scale, key


def test_meshed_rows_against_the_plain_reference():
    """The configuration's route (``auto``) over the mesh, held to the
    benchmark's plain reference within the configuration's limits."""
    trades = _request()
    got = _service(CPU4).price(trades)
    want = reference.barrier_rows(trades, GRID["n_time_steps"], GRID["num_space_nodes"], "cpu")
    limits = CONFIG["check"]["limits"]
    gaps = _gaps(got, want)
    assert set(gaps) == set(limits) and all(gaps[k] <= limits[k] for k in limits), gaps


def test_a_meshed_request_records_the_split(tmp_path):
    """One request over 4 shards records 4 ``batch.shard_copy`` (2 rows
    each), 4 ``batch.shard`` and 1 ``batch.gather`` inside its
    ``batch.solve``; on a mesh that repeats the CPU nothing crosses between
    devices, so every ``bytes`` is 0. An unmeshed request records none."""
    trades = _request()
    meshed, plain = _service(CPU4), _service()
    with profiling.trace(str(tmp_path)):
        meshed.price(trades)
    recs = list(tracing.records)
    names = Counter(r.name for r in recs)
    assert {k: names[k] for k in PARTS} == {"batch.shard_copy": 4, "batch.shard": 4, "batch.gather": 1}
    assert all(n.startswith("batch.") for n in PARTS)
    (solve,) = [r for r in recs if r.name == "batch.solve"]
    parts = [r for r in recs if r.name in PARTS]
    assert all(solve.start_ns <= r.start_ns and r.end_ns <= solve.end_ns for r in parts)
    copies = [r for r in parts if r.name == "batch.shard_copy"]
    assert [r.attrs for r in copies] == [dict(device=None, rows=2, bytes=0)] * 4
    assert [r.attrs for r in parts if r.name == "batch.shard"] == [dict(device=None)] * 4
    assert [r.attrs for r in parts if r.name == "batch.gather"] == [dict(bytes=0)]
    # every copy is issued before any shard's work
    assert max(r.end_ns for r in copies) <= min(r.start_ns for r in parts if r.name == "batch.shard")
    assert not {"batch.march", "batch.greeks"} & set(names)
    with profiling.trace(str(tmp_path)):
        plain.price(trades)
    assert not {r.name for r in tracing.records} & set(PARTS)
    tracing.clear()


def test_shard_copy_bytes_are_those_that_cross_devices():
    """``bytes`` of a shard copy: the copied rows of every batch field and
    sigma where the shard's device is not the batch's (the meta device
    stands in for another card), 0 where it is."""
    n = 6
    tb = port_batch.build_trade_batch(
        spots=list(np.linspace(90.0, 110.0, n)), strikes=[100.0] * n, sigmas=[0.3] * n,
        t_expiry=[0.25] * n, r=[0.05] * n, b=[0.05] * n, is_call=[True] * n, n_time_steps=16,
        monitor_times=[[0.125, 0.25]] * n, upper=[130.0] * n, num_space_nodes=31, device="cpu")
    sigmas = [tb.sigma, tb.sigma + 1e-4]
    fields = [getattr(tb, f.name) for f in port_batch.dc_fields(tb) if getattr(tb, f.name) is not None]
    want = sum(x[2:5].nbytes for x in fields + sigmas)
    for device, moved in ((torch.device("meta"), want), (torch.device("cpu"), 0)):
        rec = tracing.Record("batch.shard_copy", {})
        b, sg, prep = port_batch._shard_rows(tb, sigmas, None, 2, 3, device, rec)
        assert rec.attrs == {"bytes": moved} and prep is None
        assert b.batch_size == 3 and b.x_min.device == device and sg[1].device == device
    b, _, _ = port_batch._shard_rows(tb, sigmas, None, 2, 3, torch.device("cpu"))
    assert torch.equal(b.dt, tb.dt[2:5]) and torch.equal(b.upper, tb.upper[2:5])


def test_a_graph_is_captured_on_the_current_cards_stream(monkeypatch):
    """``spectral.run_graphed`` captures on the side stream it made for the
    warm-up, on the card current at the call, never on
    ``torch.cuda.graph``'s default capture stream: that one is made once,
    on the card current at the process's first capture, and a capture of
    another card's shard there fails (CUDA stands in by fakes here)."""
    made, captured = [], []

    class Stream:
        def __init__(self):
            made.append(self)

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, stream=None, **kw):
        captured.append(stream)
        yield

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream.__new__(Stream))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(spectral, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(spectral, "_SEEN", OrderedDict())
    monkeypatch.setattr(spectral, "graph_counts", {"eager": 0, "captures": 0, "replays": 0})
    x = torch.arange(3.0)
    outs = [spectral.run_graphed(("key",), lambda t: (2 * t,), [x])[0] for _ in range(3)]
    assert spectral.graph_counts == {"eager": 1, "captures": 1, "replays": 2}
    # one stream made (the warm-up's), and the capture on it
    assert len(made) == 1 and captured == made
    assert all(torch.equal(o, 2 * x) for o in outs)
