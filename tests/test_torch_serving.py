"""The port's serving layer on the CPU: bucketed services and the HTTP server.

Counterparts of tests/test_serving.py's TestBarrierService,
TestGreeksDtypePolicy, TestAmericanService, TestPricingServer and
TestServerBackpressure, on ``device="cpu"`` at the same grid (64 steps x
127 nodes), and the port's services held against the JAX package's on the
same trade dicts: within 1e-9 of each output's max|value| (the driver
tests' tolerance for the routes both ``auto`` rules take on the CPU:
spectral for a barrier batch, the scan for an American one), except the
hybrid route's gamma, within 1e-7: its continuous lane's gamma is the
analytic sweep's bump gamma, held to JAX's at 1e-7 in
tests/test_torch_analytic.py (the second difference divides the closed
forms' last-digit differences by (1e-4 S)^2).

Not ported: TestGreeksDtypePolicy's test_policy_warns_when_x64_disabled
(torch always has float64, so the policy has no x64 branch).
TestMeshShardedService is held in tests/test_torch_parallel.py (services
over a mesh of repeated CPU devices); here, a service given a ``mesh``
that is not a ``parallel.Mesh`` raises.
"""
import http.client
import json
import sys
import threading
import time

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu import serving as jax_serving
from finite_difference_tpu_torch.models.analytic import (
    continuous_barrier_sweep_greeks,
    generalized_bs_price,
    monitoring_decision,
)
from finite_difference_tpu_torch.models.pde.batch import (
    build_american_batch,
    build_trade_batch,
    price_american_batch,
    price_american_batch_richardson,
    price_barrier_batch,
)
from finite_difference_tpu_torch.serving import (
    AmericanPricingService,
    BarrierPricingService,
    PricingServer,
)
from finite_difference_tpu_torch.serving import __main__ as cli
from finite_difference_tpu_torch.serving import server as port_server
from finite_difference_tpu_torch.models.pde.batch import pad_batch

GRID = dict(n_time_steps=64, num_space_nodes=127)
MONITORS = [0.02, 0.04, 0.06, 0.08]
KEYS = ("price", "delta", "gamma", "vega", "theta")
SERVICE_TOL = 1e-9


def _barrier_service(**kw):
    return BarrierPricingService(min_bucket=4, max_bucket=64, device="cpu", **{**GRID, **kw})


def _ko_trade(**over):
    t = dict(
        spot=100.0, strike=95.0, sigma=0.3, t_expiry=0.08, r=0.05,
        is_call=True, barrier_type="up-and-out", upper=130.0,
        monitor_times=list(MONITORS),
    )
    t.update(over)
    return t


def _vanilla(s, k, sig, te, r, b, is_call):
    return float(generalized_bs_price(*(torch.tensor(x, dtype=torch.float64)
                                        for x in (s, k, sig, te, r, b)), is_call))


class TestBarrierService:
    def test_matches_direct_batch_call_despite_padding(self):
        trades = [
            _ko_trade(),
            _ko_trade(spot=90.0, barrier_type="down-and-out", lower=70.0,
                      upper=None, is_call=False),
            _ko_trade(barrier_type="none", upper=None),
        ]
        svc = _barrier_service()
        got = svc.price(trades)  # bucket=4 -> one padded clone

        tb = build_trade_batch(
            spots=[t["spot"] for t in trades],
            strikes=[t["strike"] for t in trades],
            sigmas=[t["sigma"] for t in trades],
            t_expiry=[t["t_expiry"] for t in trades],
            r=[t["r"] for t in trades],
            b=[t["r"] for t in trades],
            is_call=[t["is_call"] for t in trades],
            n_time_steps=GRID["n_time_steps"],
            monitor_times=[MONITORS for _ in trades],
            lower=[t.get("lower") for t in trades],
            upper=[t.get("upper") for t in trades],
            num_space_nodes=GRID["num_space_nodes"],
            device="cpu",
        )
        want = price_barrier_batch(tb, n_nodes=GRID["num_space_nodes"] + 1, device="cpu")
        for i, row in enumerate(got):
            for k in KEYS:
                # B=4 (padded) and B=3 differ in the spectral plan's roundings;
                # the vega bump quotient amplifies them by 1/(dv*100)
                assert row[k] == pytest.approx(float(want[k][i]), rel=1e-9, abs=1e-12), (i, k)
        assert svc.stats == {"requests": 1, "trades": 3, "bucket_hits": {4: 1}}

    def test_knock_in_parity_sums_to_vanilla(self):
        """KI is served as vanilla − KO, so KI + KO == analytic vanilla."""
        svc = _barrier_service()
        out_ko, out_ki = svc.price([_ko_trade(), _ko_trade(barrier_type="up-and-in")])
        s, k, sig, te, r = 100.0, 95.0, 0.3, 0.08, 0.05
        van = _vanilla(s, k, sig, te, r, r, True)
        assert out_ko["price"] + out_ki["price"] == pytest.approx(van, rel=1e-12)
        # greeks obey the same parity against the closed-form bumps
        ds = s * 1e-4
        v = lambda s_=s, sig_=sig: _vanilla(s_, k, sig_, te, r, r, True)
        delta_van = (v(s + ds) - v(s - ds)) / (2 * ds)
        vega_van = (v(sig_=sig + 1e-4) - van) / (100.0 * 1e-4)
        assert out_ko["delta"] + out_ki["delta"] == pytest.approx(delta_van, rel=1e-9)
        assert out_ko["vega"] + out_ki["vega"] == pytest.approx(vega_van, rel=1e-9)

    def test_knock_in_rebate_conserves_discounted_rebate(self):
        """The KI rebate pays at expiry iff the barrier is never hit and the
        KO rebate iff it is, so both legs together are worth R*DF."""
        svc = _barrier_service()
        ki0, ki5, ko0, ko5 = svc.price([
            _ko_trade(barrier_type="up-and-in"),
            _ko_trade(barrier_type="up-and-in", rebate=5.0),
            _ko_trade(),
            _ko_trade(rebate=5.0),
        ])
        df = np.exp(-0.05 * 0.08)
        ki_leg = ki5["price"] - ki0["price"]  # 5*DF*P(no hit)
        ko_leg = ko5["price"] - ko0["price"]  # 5*DF*P(hit)
        assert ki_leg > 0 and ko_leg > 0
        assert ki_leg + ko_leg == pytest.approx(5.0 * df, rel=1e-10)

    def test_bucket_rounding_and_overflow(self):
        svc = _barrier_service(with_greeks=False)
        svc.price([_ko_trade(barrier_type="none", upper=None)] * 5)
        assert svc.stats["bucket_hits"] == {8: 1}
        with pytest.raises(ValueError, match="exceeds max_bucket"):
            svc.price([_ko_trade()] * 65)

    def test_pad_batch_clones_the_first_trade_and_the_spectral_layout(self):
        tb = _barrier_service().build_batch([_ko_trade(), _ko_trade(spot=104.0)], 2)
        tb.sp_k_end = torch.tensor([[3, 7], [4, 9]])
        padded = pad_batch(tb, 3)
        assert padded.batch_size == 5 and padded.sp_apply is None
        assert torch.equal(padded.sp_k_end[2:], torch.tensor([[3, 7]] * 3))
        assert torch.equal(padded.dt[2:], tb.dt[:1].expand(3, -1))
        assert torch.equal(padded.spot[:2], tb.spot)

    def test_hybrid_route_splits_lanes(self):
        """Continuous-regime trades (FIS n_lim rule) leave the PDE bucket for
        the analytic sweep with BGK-shifted barriers; discrete-regime trades
        price exactly as the pure-PDE service."""
        dense = [0.08 * i / 2100.0 for i in range(1, 2101)]
        tr_pde = _ko_trade()
        tr_cont = _ko_trade(monitor_times=dense)
        got = _barrier_service(route="hybrid").price([tr_pde, tr_cont])

        want_pde = _barrier_service().price([tr_pde])[0]
        for k, v in want_pde.items():
            assert got[0][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k

        use_cont, adj = monitoring_decision(np.array([0.08]), [dense], np.array([0.3]))
        assert bool(use_cont[0])
        direct = continuous_barrier_sweep_greeks(
            np.array([100.0]), np.array([95.0]), np.array([0.08]),
            np.array([0.05]), np.array([0.05]), np.array([0.3]),
            lower=[None], upper=[130.0 * adj[0]],
            is_call=np.array([True]), is_in=np.array([False]), device="cpu",
        )
        for k in ("price", "delta", "gamma", "vega"):
            assert got[1][k] == pytest.approx(float(direct[k][0]), rel=1e-12), k
        assert np.isfinite(got[1]["theta"])

    def test_hybrid_route_keeps_rebates_on_pde(self):
        dense = [0.08 * i / 2100.0 for i in range(1, 2101)]
        trade = _ko_trade(monitor_times=dense, rebate=5.0, rebate_at_hit=True)
        hybrid = _barrier_service(route="hybrid").price([trade])[0]
        pde = _barrier_service().price([trade])[0]
        for k, v in pde.items():
            assert hybrid[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k

    def test_barrier_level_validation(self):
        svc = _barrier_service()
        with pytest.raises(ValueError, match="requires 'upper'"):
            svc.price([_ko_trade(upper=None)])
        with pytest.raises(ValueError, match="unknown barrier_type"):
            svc.price([_ko_trade(barrier_type="sideways-out")])

    @pytest.mark.parametrize("service", [BarrierPricingService, AmericanPricingService])
    def test_mesh_and_default_device(self, service, monkeypatch):
        """A mesh that is not a ``parallel.Mesh`` raises; without a card the
        default device raises."""
        with pytest.raises(ValueError, match="mesh"):
            service(mesh=object(), device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            service()
        assert service(device="cpu").device == torch.device("cpu")

    def test_concurrent_callers_are_serialised(self):
        """price from many threads at once: each caller gets its own rows,
        the same as a call alone, and the stats count every request."""
        svc = _barrier_service(with_greeks=False)
        requests = [[_ko_trade(spot=95.0 + i + 0.5 * j) for j in range(1 + i % 3)]
                    for i in range(12)]
        alone = [svc.price(req) for req in requests]
        got = [None] * len(requests)

        def call(i):
            got[i] = svc.price(requests[i])

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert got == alone
        assert svc.stats["requests"] == 2 * len(requests)


class TestGreeksDtypePolicy:
    """A greek-bearing float32 service solves at float64 unless told
    otherwise (service._resolve_greeks_dtype)."""

    @pytest.mark.parametrize("f32", [np.float32, torch.float32, "float32"])
    def test_f32_greeks_service_defaults_to_f64(self, f32):
        assert _barrier_service(dtype=f32, with_greeks=True).dtype == torch.float64
        am = AmericanPricingService(n_time_steps=8, num_space_nodes=62, dtype=f32,
                                    with_greeks=True, min_bucket=4, max_bucket=8, device="cpu")
        assert am.dtype == torch.float64

    def test_explicit_f32_greeks_opt_out_and_price_only_keep_f32(self):
        svc = _barrier_service(dtype=np.float32, with_greeks=True, greeks_dtype=np.float32)
        assert svc.dtype == torch.float32
        assert _barrier_service(dtype=torch.float32, with_greeks=False).dtype == torch.float32
        assert _barrier_service(dtype=np.float64, with_greeks=True).dtype == torch.float64
        with pytest.raises(ValueError, match="float32 or float64"):
            _barrier_service(dtype=np.float16)

    def test_f32_greeks_service_ships_f64_accuracy(self):
        """The served greeks of a float32 service equal the float64 service's."""
        trades = [_ko_trade(), _ko_trade(spot=105.0)]
        got = _barrier_service(dtype=np.float32, with_greeks=True).price(trades)
        want = _barrier_service(dtype=np.float64, with_greeks=True).price(trades)
        for g, w in zip(got, want):
            for k in KEYS:
                assert g[k] == pytest.approx(w[k], rel=1e-12), k


class TestAmericanService:
    def test_matches_direct_batch_call(self):
        trades = [
            dict(spot=100.0, strike=110.0, sigma=0.25, t_expiry=0.5, r=0.06),
            dict(spot=100.0, strike=90.0, sigma=0.35, t_expiry=0.5, r=0.06,
                 is_call=True, dividends=[[0.25, 1.5]]),
        ]
        svc = AmericanPricingService(n_time_steps=64, num_space_nodes=126, min_bucket=2,
                                     max_bucket=16, device="cpu")
        got = svc.price(trades)
        tb = build_american_batch(
            spots=[100.0, 100.0], strikes=[110.0, 90.0],
            sigmas=[0.25, 0.35], t_expiry=[0.5, 0.5], r=[0.06, 0.06],
            b=[0.06, 0.06], is_call=[False, True], n_time_steps=64,
            dividends_tau=[[], [(0.25, 1.5)]], num_space_nodes=126, device="cpu",
        )
        want = price_american_batch(tb, n_nodes=128, device="cpu")
        for i, row in enumerate(got):
            for k in ("price", "delta", "gamma", "vega"):
                assert row[k] == pytest.approx(float(want[k][i]), rel=1e-12, abs=1e-14), (i, k)
        # early-exercise premium over the analytic European put
        assert got[0]["price"] > _vanilla(100.0, 110.0, 0.25, 0.5, 0.06, 0.06, False)

    def test_richardson_matches_batched_driver(self):
        trades = [
            dict(spot=100.0, strike=105.0, sigma=0.3, t_expiry=0.5, r=0.05),
            dict(spot=100.0, strike=95.0, sigma=0.2, t_expiry=0.5, r=0.05),
        ]
        svc = AmericanPricingService(n_time_steps=64, num_space_nodes=126, min_bucket=2,
                                     max_bucket=16, richardson=True, device="cpu")
        got = svc.price(trades)
        want = price_american_batch_richardson(
            n_nodes=128, n_time_steps=64,
            spots=[100.0, 100.0], strikes=[105.0, 95.0], sigmas=[0.3, 0.2],
            t_expiry=[0.5, 0.5], r=[0.05, 0.05], b=[0.05, 0.05],
            is_call=[False, False], num_space_nodes=126, device="cpu",
        )
        for i, row in enumerate(got):
            for k in ("price", "delta", "gamma", "vega"):
                assert row[k] == pytest.approx(float(want[k][i]), rel=1e-9, abs=1e-12), (i, k)


def _assert_rows_close(got, want, tols=None):
    """Each output within its tolerance (``tols``, else SERVICE_TOL) of its
    max|value| over the request."""
    assert [set(r) for r in got] == [set(r) for r in want]
    for k in want[0]:
        g = np.array([r[k] for r in got])
        w = np.array([r[k] for r in want])
        scale = max(float(np.max(np.abs(w))), 1e-300)
        tol = (tols or {}).get(k, SERVICE_TOL)
        assert float(np.max(np.abs(g - w))) <= tol * scale, (k, float(np.max(np.abs(g - w))) / scale)


class TestServiceAgainstJax:
    """The port's services and the JAX package's on the same trade dicts."""

    @pytest.mark.parametrize("route", ["pde", "hybrid"])
    def test_barrier_service(self, route):
        dense = [0.08 * i / 2100.0 for i in range(1, 2101)]
        trades = [
            _ko_trade(),
            _ko_trade(spot=92.0, barrier_type="down-and-in", lower=85.0, upper=None,
                      is_call=False, rebate=1.5, b=0.02, q=0.01),
            _ko_trade(barrier_type="double-out", lower=80.0, upper=125.0, rebate=1.0,
                      rebate_at_hit=True, t_expiry=0.1, monitor_times=[0.05, 0.1]),
            _ko_trade(barrier_type="up-and-in", rebate=2.0),
            _ko_trade(barrier_type="none", upper=None, is_call=False),
            _ko_trade(spot=104.0, monitor_times=dense, sigma=0.25),
        ]
        kw = dict(min_bucket=8, max_bucket=64, route=route, **GRID)
        got = BarrierPricingService(device="cpu", **kw).price(trades)
        want = jax_serving.BarrierPricingService(**kw).price(trades)
        _assert_rows_close(got, want, {"gamma": 1e-7} if route == "hybrid" else None)

    def test_american_service(self):
        trades = [
            dict(spot=90.0 + 5 * i, strike=100.0, sigma=0.2 + 0.03 * i, t_expiry=0.5 + 0.25 * i,
                 r=0.06, b=0.03) for i in range(4)
        ]
        kw = dict(n_time_steps=64, num_space_nodes=126, min_bucket=4, max_bucket=16)
        got = AmericanPricingService(device="cpu", **kw).price(trades)
        _assert_rows_close(got, jax_serving.AmericanPricingService(**kw).price(trades))


class TestPricingServer:
    @pytest.fixture()
    def server(self):
        with PricingServer(_barrier_service(with_greeks=False), window_ms=100.0) as srv:
            yield srv

    @staticmethod
    def _post(srv, payload):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        try:
            conn.request("POST", "/price", json.dumps(payload),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    @staticmethod
    def _get(srv, path):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def test_concurrent_requests_coalesce_into_one_batch(self, server):
        results = [None, None]

        def post(i):
            results[i] = self._post(server, {"trades": [_ko_trade(spot=100.0 + i)]})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        for status, body in results:
            assert status == 200
            assert len(body["results"]) == 1
            assert body["results"][0]["price"] > 0
        # spot=101 knocks out slightly more -> a different price
        assert results[1][1]["results"][0]["price"] != results[0][1]["results"][0]["price"]
        assert server.stats["requests"] == 2
        # both landed within one 100 ms window -> a single batch
        # (>=1 guards scheduler jitter; ==1 is the expected path)
        assert 1 <= server.stats["batches"] <= 2

    def test_healthz_and_malformed_request(self, server):
        status, _ = self._post(server, {"trades": [_ko_trade()]})
        assert status == 200
        status, health = self._get(server, "/healthz")
        assert status == 200
        assert health["ok"] is True and health["backend"] == "cpu"
        assert health["stats"]["requests"] >= 1
        assert health["service_stats"]["requests"] >= 1

        status, body = self._post(server, {"nope": 1})
        assert status == 400 and "bad request" in body["error"]
        # a pricing error is reported per request, not a server crash
        status, body = self._post(server, {"trades": [_ko_trade(upper=None)]})
        assert status == 500 and "requires 'upper'" in body["error"]
        status, _ = self._post(server, {"trades": [_ko_trade()]})
        assert status == 200

    def test_healthz_makes_no_cuda_call(self, monkeypatch):
        """The backend string is made when the server is built; a handler
        thread then touches no CUDA entry point (a graph capture on the
        batcher thread would fail on one)."""
        svc = _BlockingService()
        svc.device = torch.device("cuda")
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Test Card")
        with PricingServer(svc) as srv:
            calls = []

            def refuse(*a, **k):
                calls.append(threading.current_thread().name)
                raise RuntimeError("a CUDA call from a handler thread")

            for name in ("get_device_name", "is_available", "current_device", "device_count",
                         "synchronize", "memory_reserved", "mem_get_info"):
                monkeypatch.setattr(torch.cuda, name, refuse)
            status, health = self._get(srv, "/healthz")
        assert status == 200 and health["backend"] == "cuda (Test Card)"
        assert calls == []
        assert port_server._backend(object()) == "unknown"


class _BlockingService:
    """Stub service: records priced trades, blocks until released — lets
    the tests hold the batcher mid-price deterministically."""

    max_bucket = None

    def __init__(self):
        self.stats = {"requests": 0}
        self.release = threading.Event()
        self.started = threading.Event()
        self.priced = []

    def price(self, trades):
        self.started.set()
        self.release.wait(30.0)
        self.priced.extend(trades)
        return [{"price": 1.0} for _ in trades]


class TestServerBackpressure:
    """The pending queue is bounded (flood -> 503) and a pending whose
    client already timed out at 504 is dropped before pricing."""

    def test_flood_beyond_queue_bound_gets_503(self):
        svc = _BlockingService()
        with PricingServer(svc, window_ms=0.0, max_queue=2, request_timeout_s=30.0) as srv:
            statuses = []
            lock = threading.Lock()

            def post(i):
                s, _ = TestPricingServer._post(srv, {"trades": [{"id": i}]})
                with lock:
                    statuses.append(s)

            t0 = threading.Thread(target=post, args=(0,))
            t0.start()
            assert svc.started.wait(10.0)  # batcher is pricing request 0
            fillers = [threading.Thread(target=post, args=(i,)) for i in (1, 2)]
            for t in fillers:
                t.start()
            deadline = time.monotonic() + 10.0
            while srv._queue.qsize() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv._queue.qsize() == 2  # bounded queue is full
            for i in (3, 4):
                s, body = TestPricingServer._post(srv, {"trades": [{"id": i}]})
                assert s == 503 and "overloaded" in body["error"]
            svc.release.set()
            t0.join(20.0)
            for t in fillers:
                t.join(20.0)
            assert statuses.count(200) == 3
            assert srv.stats["rejected"] == 2
            assert sorted(tr["id"] for tr in svc.priced) == [0, 1, 2]

    def test_expired_pending_never_priced(self):
        svc = _BlockingService()
        with PricingServer(svc, window_ms=0.0, max_queue=8, request_timeout_s=0.4) as srv:
            res = {}

            def post(key, i):
                res[key] = TestPricingServer._post(srv, {"trades": [{"id": i}]})

            ta = threading.Thread(target=post, args=("a", 0))
            ta.start()
            assert svc.started.wait(10.0)  # batcher holds request a
            tb = threading.Thread(target=post, args=("b", 1))
            tb.start()
            ta.join(10.0)
            tb.join(10.0)
            assert res["a"][0] == 504 and res["b"][0] == 504
            svc.release.set()
            deadline = time.monotonic() + 10.0
            while srv.stats["dropped_expired"] < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            # b was dropped before pricing: only a's trade ever ran
            assert srv.stats["dropped_expired"] == 1
            assert [tr["id"] for tr in svc.priced] == [0]


class TestCommandLine:
    def test_cpu_flag_builds_a_cpu_service(self):
        args = cli.parse_args(["--cpu", "--service", "american", "--steps", "16", "--nodes", "62",
                               "--no-greeks", "--f32", "--richardson", "--port", "0"])
        svc = cli.make_service(args)
        assert isinstance(svc, AmericanPricingService)
        assert svc.device == torch.device("cpu") and svc.dtype == torch.float32
        assert svc.richardson and not svc.with_greeks and svc.num_space_nodes == 62
        svc = cli.make_service(cli.parse_args(["--cpu", "--route", "hybrid"]))
        assert isinstance(svc, BarrierPricingService) and svc.route == "hybrid"
        assert svc.dtype == torch.float64 and svc.num_space_nodes == 1023

    @pytest.mark.parametrize("argv", [["--service", "american", "--route", "hybrid"],
                                      ["--richardson"]])
    def test_flags_of_the_other_service_are_refused(self, argv):
        with pytest.raises(SystemExit):
            cli.parse_args(argv)
