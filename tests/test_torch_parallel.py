"""The port's device mesh (``finite_difference_tpu_torch.parallel`` and the
``mesh=`` of the drivers, services, batched runners and the device
exposure engine) on the CPU.

torch has no virtual devices (JAX's CPU backend fakes eight under an XLA
flag), so every mesh here repeats the CPU: ``make_mesh(k, devices=["cpu"] *
k)``. That exercises the split, the padding, the per-shard calls and the
gather, not any overlap across devices.

The cases carry over tests/test_multichip.py (TestMultichip, TestMeshSpike,
TestShardedDeviceExposure, TestShardedReductions) and test_serving.py's
TestMeshShardedService. Each sharded port call is held against the port's
unsharded call (the SPIKE routes bit for bit, the scan and spectral routes
within 1e-12) and against the JAX package's mesh path, which runs here in
this process on its one-device CPU mesh (``finite_difference_tpu.
parallel.make_mesh(1)``), at the tolerances the single-device tests use:
the drivers 1e-9 (the port's SPIKE march against JAX's scan), the services
and batched runners 1e-9 of max|value|, the reductions rtol 1e-12
(stderr and PFE 1e-10, JAX's own limits) and the MTM 1e-12 of max|MTM|.
"""
import datetime as dt
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import finite_difference_tpu.parallel as jax_par
from finite_difference_tpu import serving as jax_serving
from finite_difference_tpu.instruments.cashflow import LegType as JaxLegType, SwapLeg as JaxSwapLeg
from finite_difference_tpu.instruments.ir_swap import IRSwap as JaxIRSwap
from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu.runners import american_scenarios as jax_am
from finite_difference_tpu.runners import barrier_scenarios as jax_bar
from finite_difference_tpu.xva.device_exposure import DeviceExposureEngine as JaxDeviceEngine
from finite_difference_tpu_torch import parallel
from finite_difference_tpu_torch.entry import dryrun_multichip, entry
from finite_difference_tpu_torch.instruments import IRSwap, LegType, SwapLeg
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import spectral, spike
from finite_difference_tpu_torch.parallel.mesh import Mesh, Sharded, check_mesh
from finite_difference_tpu_torch.portfolio import CSA, InitialMarginMethod
from finite_difference_tpu_torch.runners import american_scenarios as port_am
from finite_difference_tpu_torch.runners import barrier_scenarios as port_bar
from finite_difference_tpu_torch.serving import AmericanPricingService, BarrierPricingService
from finite_difference_tpu_torch.xva import DeviceExposureEngine

KEYS = ("price", "vega", "delta", "gamma", "theta")


def cpu_mesh(k: int, **kw) -> Mesh:
    return parallel.make_mesh(k, devices=["cpu"] * k, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # step loops in Python; under the suite's xdist workers torch's thread
    # per core made such loops far slower (tests/test_torch_mc.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


def _close(got, want, tol):
    """Each output within ``tol`` of its max|want| (``want`` tensors or arrays)."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], dtype=float), np.asarray(want[k], dtype=float)
        assert np.max(np.abs(g - w)) <= tol * max(np.max(np.abs(w)), 1e-300), k


def _calls(B, seed=0, steps=32, nodes=127, upper=260.0):
    """test_multichip.py's trade set: 1-month up-and-out calls, 4 monitors."""
    rng = np.random.default_rng(seed)
    t = 31.0 / 365.0
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[t] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=steps,
        monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        upper=[upper] * B, num_space_nodes=nodes,
    )


class TestMakeMesh:
    def test_shape_axes_and_specs(self):
        mesh = parallel.make_mesh(4, axis_names=("data", "model"), shape=(2, 2), devices=["cpu"] * 4)
        assert mesh.shape == (2, 2) and mesh.size == 4 and mesh.axis_size("model") == 2
        assert mesh.axis_devices("data") == (torch.device("cpu"),) * 2
        assert parallel.make_mesh(devices=["cpu"] * 3).shape == (3,)
        assert tuple(parallel.batch_pspec(mesh, "model")) == (mesh, "model", 0)
        assert check_mesh(None) is None and check_mesh(mesh, "cpu") is mesh

    def test_errors(self, monkeypatch):
        with pytest.raises(ValueError, match="shape"):
            parallel.make_mesh(4, shape=(3,), devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="only 2"):
            parallel.make_mesh(3, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="axis 'model'"):
            cpu_mesh(2).axis_size("model")
        with pytest.raises(ValueError, match="one type"):
            parallel.make_mesh(devices=["cpu", "cuda:0"])
        with pytest.raises(ValueError, match="mesh must be"):
            check_mesh(object())
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            parallel.make_mesh()
        # one card: more CUDA devices than exist raise, naming the devices= list
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match=r"devices=\['cuda:0'\] \* 2"):
            parallel.make_mesh(2)
        with pytest.raises(ValueError, match="sees only 1"):
            parallel.make_mesh(devices=["cuda:0", "cuda:1"])
        assert parallel.make_mesh(4, devices=["cuda:0"] * 4).size == 4
        with pytest.raises(ValueError, match="the call's device"):
            check_mesh(cpu_mesh(2), "cuda")

    def test_shard_batch_and_gather(self):
        mesh = cpu_mesh(4)
        x = torch.arange(30.0).reshape(10, 3)
        tree = parallel.shard_batch({"a": x, "b": [np.arange(10)]}, mesh)
        assert isinstance(tree["a"], Sharded) and tree["a"].sizes == (3, 3, 2, 2)
        assert torch.equal(tree["a"].gather(), x) and torch.equal(tree["b"][0].gather(), torch.arange(10))
        cube = parallel.shard_batch(x.T, mesh, dim=1)
        assert cube.sizes == (3, 3, 2, 2) and torch.equal(cube.gather("cpu"), x.T)


class TestShardedReductions:
    def test_mean_stderr_and_profile_match_numpy_and_jax(self):
        """tests/test_multichip.py's reductions: 4096 values and a (4096, 7)
        MTM over 8 shards, against numpy and JAX's shard_map forms."""
        rng = np.random.default_rng(0)
        v = rng.normal(5.0, 2.0, size=4096)
        mtm = rng.normal(0.0, 3.0, size=(4096, 7))
        mesh, jmesh = cpu_mesh(8), jax_par.make_mesh(1)
        mean, se = parallel.sharded_mean_stderr(torch.as_tensor(v), mesh)
        np.testing.assert_allclose(float(mean), v.mean(), rtol=1e-12)
        np.testing.assert_allclose(float(se), v.std(ddof=1) / np.sqrt(len(v)), rtol=1e-10)
        jmean, jse = jax_par.sharded_mean_stderr(jnp.asarray(v), jmesh)
        np.testing.assert_allclose(float(mean), float(jmean), rtol=1e-12)
        np.testing.assert_allclose(float(se), float(jse), rtol=1e-10)
        # a value already sharded reduces as it lies
        again = parallel.sharded_mean_stderr(parallel.shard_batch(torch.as_tensor(v), mesh), mesh)
        assert torch.equal(again[0], mean) and torch.equal(again[1], se)

        ee, pfe = parallel.sharded_exposure_profile(torch.as_tensor(mtm), mesh)
        exp = np.maximum(mtm, 0.0)
        np.testing.assert_allclose(ee.numpy(), exp.mean(axis=0), rtol=1e-12)
        np.testing.assert_allclose(pfe.numpy(), np.quantile(exp, 0.95, axis=0), rtol=1e-10)
        jee, jpfe = jax_par.sharded_exposure_profile(jnp.asarray(mtm), jmesh)
        np.testing.assert_allclose(ee.numpy(), np.asarray(jee), rtol=1e-12)
        np.testing.assert_allclose(pfe.numpy(), np.asarray(jpfe), rtol=1e-10)


class TestMeshDrivers:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_spike_sharded_with_padding_matches_unsharded(self, dtype):
        """TestMeshSpike's B=36 over 8 devices: padded to 40 (5 a shard) and
        sliced back, equal to the unsharded SPIKE march bit for bit; at
        float64 within 1e-9 of JAX's mesh path (its scan)."""
        kw = _calls(36)
        tb = port_batch.build_trade_batch(dtype=dtype, device="cpu", **kw)
        single = port_batch.price_barrier_batch(tb, 128, solver="spike", device="cpu")
        sharded = port_batch.price_barrier_batch(tb, 128, mesh=cpu_mesh(8), solver="spike", device="cpu")
        assert sharded["price"].shape == (36,)
        _equal(sharded, single)
        if dtype == torch.float64:
            jb = jax_batch.build_trade_batch(**kw)
            ref = jax_batch.price_barrier_batch(jb, 128, mesh=jax_par.make_mesh(1), solver="scan")
            _close(sharded, ref, 1e-9)

    def test_shards_march_at_the_whole_batch_p(self, monkeypatch):
        """B=2050 over 2 shards at 512 nodes: the whole batch takes P=32
        (more than spike.WIDE_MAX_BATCH trades), and so does each shard,
        though a shard of 1025 trades on its own would take P=64 and march
        another discretisation. (At 64 nodes no P of several warps fits the
        grid: spike.spike_p_choices(64, B) is (16,) at every B.)"""
        tb = port_batch.build_trade_batch(dtype=torch.float32, device="cpu", **_calls(2050, steps=8, nodes=511))
        assert spike.spike_p_choices(512, 1025)[0] == 64 and spike.spike_p_choices(512, 2050) == (32,)
        single = port_batch.price_barrier_batch(tb, 512, with_greeks=False, solver="spike", device="cpu")
        marched = []
        real = port_batch.cn_barrier_solve_spike
        monkeypatch.setattr(port_batch, "cn_barrier_solve_spike",
                            lambda b, *a, **k: marched.append((b.batch_size, k["prep"].P)) or real(b, *a, **k))
        sharded = port_batch.price_barrier_batch(tb, 512, with_greeks=False, mesh=cpu_mesh(2), solver="spike",
                                                 device="cpu")
        assert marched == [(1025, 32), (1025, 32)]
        _equal(sharded, single)
        own = port_batch.price_barrier_batch(tb[:1025], 512, with_greeks=False, solver="spike", device="cpu")
        assert not torch.equal(own["price"], single["price"][:1025])

    def test_a_guard_refusal_in_one_shard_sends_the_call_to_the_scan(self, monkeypatch):
        """Auto on a card (the CPU read as CUDA), a batch whose second half
        is drift dominated (spike_prep's _drift_dominated_kwargs: the
        interface guard refuses it) over 2 shards: the first shard's guard
        passes, the second's refuses, and the whole call takes the scan."""
        B = 4
        drift = dict(sigmas=[0.01] * B, b=[0.5] * B)
        fine = dict(sigmas=[0.3] * B, b=[0.05] * B)
        kw = dict(spots=[100.0] * 2 * B, strikes=[100.0] * 2 * B, t_expiry=[1.0] * 2 * B, r=[0.05] * 2 * B,
                  is_call=[True] * 2 * B, n_time_steps=4, num_space_nodes=127, upper=[130.0] * 2 * B,
                  monitor_times=[[0.5, 1.0]] * 2 * B,
                  sigmas=fine["sigmas"] + drift["sigmas"], b=fine["b"] + drift["b"])
        tb = port_batch.build_trade_batch(device="cpu", **kw)
        sched = port_batch._spike_schedule_impl(tb, 128)
        real = port_batch.auto_solver
        routes = []
        monkeypatch.setattr(port_batch, "auto_solver",
                            lambda dev, s, passed, **k: routes.append(real("cuda", s, passed, **k)) or routes[-1])
        half = port_batch._run_batch_driver(tb[:B], 128, None, True, 1024, "bump", "auto", sched)
        got = port_batch._run_batch_driver(tb, 128, None, True, 1024, "bump", "auto", sched, mesh=cpu_mesh(2))
        assert routes == ["spike", "scan"]
        monkeypatch.undo()
        _equal(half, port_batch.price_barrier_batch(tb[:B], 128, solver="spike", device="cpu"))
        _close(got, port_batch.price_barrier_batch(tb, 128, solver="scan", device="cpu"), 1e-12)

    def test_scan_chunks_each_shard(self, monkeypatch):
        """TestMultichip's chunked mesh batch: B=4096 at 64 nodes, 16
        steps, max_chunk=256 over 8 shards chunks each shard of 512 in two
        (JAX chunks the whole batch at max_chunk x mesh.size); equal to the
        unsharded chunked scan within 1e-12, and to JAX's mesh path within
        1e-9."""
        kw = _calls(4096, seed=1, steps=16, nodes=63)
        tb = port_batch.build_trade_batch(device="cpu", **kw)
        single = port_batch.price_barrier_batch(tb, 64, with_greeks=False, max_chunk=256, solver="scan",
                                                device="cpu")
        sizes = []
        real = port_batch.price_batch_kernel
        monkeypatch.setattr(port_batch, "price_batch_kernel",
                            lambda b, *a, **k: sizes.append(b.batch_size) or real(b, *a, **k))
        sharded = port_batch.price_barrier_batch(tb, 64, with_greeks=False, max_chunk=256, mesh=cpu_mesh(8),
                                                 solver="scan", device="cpu")
        assert sizes == [256] * 16
        _close(sharded, single, 1e-12)
        jb = jax_batch.build_trade_batch(**kw)
        ref = jax_batch.price_barrier_batch(jb, 64, mesh=jax_par.make_mesh(1), max_chunk=256, with_greeks=False,
                                            solver="scan")
        _close(sharded, ref, 1e-9)

    def test_spectral_sharded_matches_single_device(self):
        """TestMultichip's sharded batch (B=32, 32 steps, 128 nodes, float64,
        auto: the spectral route on the CPU) over 8 shards: within 1e-12 of
        the unsharded call, and 1e-9 of JAX's mesh path."""
        kw = _calls(32, steps=32, nodes=127)
        tb = port_batch.build_trade_batch(device="cpu", **kw)
        single = port_batch.price_barrier_batch(tb, 128, device="cpu")
        sharded = port_batch.price_barrier_batch(tb, 128, mesh=cpu_mesh(8), device="cpu")
        _close(sharded, single, 1e-12)
        ref = jax_batch.price_barrier_batch(jax_batch.build_trade_batch(**kw), 128, mesh=jax_par.make_mesh(1))
        _close(sharded, ref, 1e-9)

    def test_american_dividend_spike_sharded_matches_unsharded(self):
        """TestMeshSpike's dividend American batch (B=16, two dividends) over
        8 shards: the jumps and lambda resets run per shard between its
        launches, equal to the unsharded march bit for bit; within 1e-9 of
        JAX's mesh path (its scan); Richardson's pair takes the mesh too."""
        rng = np.random.default_rng(2)
        B = 16
        kw = dict(spots=list(rng.uniform(80.0, 120.0, B)), strikes=[100.0] * B,
                  sigmas=list(rng.uniform(0.15, 0.3, B)), t_expiry=[1.0] * B, r=[0.06] * B, b=[0.06] * B,
                  is_call=[False] * B, n_time_steps=32, num_space_nodes=127,
                  dividends_tau=[[(0.1, 1.5), (0.6, 1.0)]] * B)
        tb = port_batch.build_american_batch(device="cpu", **kw)
        mesh = cpu_mesh(8)
        single = port_batch.price_american_batch(tb, 128, solver="spike", device="cpu")
        sharded = port_batch.price_american_batch(tb, 128, mesh=mesh, solver="spike", device="cpu")
        _equal(sharded, single)
        ref = jax_batch.price_american_batch(jax_batch.build_american_batch(**kw), 128, mesh=jax_par.make_mesh(1),
                                             solver="scan")
        _close(sharded, ref, 1e-9)
        rich = {**kw, "n_nodes": 64, "n_time_steps": 8, "num_space_nodes": 63, "dividends_tau": None}
        _equal(port_batch.price_american_batch_richardson(mesh=cpu_mesh(3), device="cpu", **rich),
               port_batch.price_american_batch_richardson(device="cpu", **rich))


GRID = dict(n_time_steps=64, num_space_nodes=127)
MONITORS = [0.02, 0.04, 0.06, 0.08]


def _ko_trade(**over):
    t = dict(spot=100.0, strike=95.0, sigma=0.3, t_expiry=0.08, r=0.05, is_call=True,
             barrier_type="up-and-out", upper=130.0, monitor_times=list(MONITORS))
    t.update(over)
    return t


def _rows_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        scale = max(abs(v) for r in want for v in r.values())
        for k, v in b.items():
            assert abs(a[k] - v) <= tol * scale, k


def test_graph_cache_is_bounded_per_device(monkeypatch):
    """spectral.run_graphed keeps GRAPH_CACHE_SIZE graphs per device: a
    device full of graphs drops its least recent one for a new key, and
    the keys a 4-card mesh adds on its other cards evict none of it."""
    cache = OrderedDict()
    monkeypatch.setattr(spectral, "_GRAPHS", cache)
    dev = [torch.device("cuda", i) for i in range(4)]
    for i in range(spectral.GRAPH_CACHE_SIZE + 1):
        cache[("home", i)] = (None, None, None, dev[0])
        spectral._drop_least_recent(dev[0])
    assert list(cache) == [("home", i) for i in range(1, spectral.GRAPH_CACHE_SIZE + 1)]
    for i in range(1, 4):
        cache[("shard", i)] = (None, None, None, dev[i])
        spectral._drop_least_recent(dev[i])
    assert len(cache) == spectral.GRAPH_CACHE_SIZE + 3 and ("home", 1) in cache


class TestMeshServicesAndRunners:
    def test_barrier_service_over_a_mesh(self):
        """TestMeshShardedService: a service built with an 8-way mesh shards
        its bucket; its rows equal the unsharded service's, and JAX's mesh
        service's within 1e-9 of max|value|."""
        trades = [_ko_trade(spot=90.0 + 2.0 * i, is_call=bool(i % 2)) for i in range(8)]
        svc = lambda **kw: BarrierPricingService(min_bucket=4, max_bucket=64, device="cpu", **GRID, **kw)
        plain = svc().price(trades)
        sharded = svc(mesh=cpu_mesh(8)).price(trades)
        assert sharded == plain
        want = jax_serving.BarrierPricingService(min_bucket=4, max_bucket=64, mesh=jax_par.make_mesh(1),
                                                 **GRID).price(trades)
        _rows_close(sharded, want, 1e-9)

    def test_american_service_over_a_mesh(self):
        """An American bucket of 8 (5 trades and their padding) over 3
        shards, padded to 9: the unsharded service's rows, and JAX's mesh
        service's within 1e-9 of max|value|."""
        trades = [dict(spot=90.0 + 5.0 * i, strike=100.0, sigma=0.25, t_expiry=0.5, r=0.06) for i in range(5)]
        grid = dict(n_time_steps=32, num_space_nodes=126, min_bucket=2, max_bucket=16)
        sharded = AmericanPricingService(device="cpu", mesh=cpu_mesh(3), **grid).price(trades)
        assert sharded == AmericanPricingService(device="cpu", **grid).price(trades)
        want = jax_serving.AmericanPricingService(mesh=jax_par.make_mesh(1), **grid).price(trades)
        _rows_close(sharded, want, 1e-9)

    def test_batched_runners_over_a_mesh(self, tmp_path):
        """Both batched runners with a mesh: the unsharded runner's rows, and
        the JAX runner's with its mesh within 1e-9 of max|model value|."""
        val, mat = dt.date(2025, 7, 28), dt.date(2025, 8, 28)
        monitors = [val + dt.timedelta(days=d) for d in range(32) if (val + dt.timedelta(days=d)).weekday() < 5]
        base = dict(valuation=val, maturity=mat, monitor_dates=monitors, opt_type="call", num_space_nodes=100,
                    num_time_steps=60)
        cfg = tmp_path / "barrier.csv"
        pd.DataFrame([
            {"scenario_name": f"s{i}", "S0": 229.74 - 3.0 * i, "K": 190.0, "sigma": 0.2879, "rate": 0.0731,
             "barrier_type": bt, "upper_barrier": 260.0, "lower_barrier": np.nan, "FA_price": np.nan,
             "FA_delta": np.nan, "FA_gamma": np.nan, "FA_vega": np.nan}
            for i, bt in enumerate(["up-and-out", "up-and-in", "up-and-out", "up-and-in", "up-and-out"])
        ]).to_csv(cfg, index=False)
        am_cfg = tmp_path / "american.csv"
        pd.DataFrame([
            {"scenario_name": f"a{i}", "S0": 160.0 + 5.0 * i, "K": 170.0, "sigma": 0.25 + 0.01 * i,
             "rate": np.exp(0.0705) - 1.0, "FA_price": np.nan, "FA_delta": np.nan, "FA_gamma": np.nan,
             "FA_vega": np.nan}
            for i in range(3)
        ]).to_csv(am_cfg, index=False)
        am_base = dict(valuation=val, maturity=dt.date(2026, 7, 28), opt_type="put", num_space_nodes=60,
                       num_time_steps=30)
        for port, jax_run, path, b in ((port_bar.run_all_scenarios_batched, jax_bar.run_all_scenarios_batched,
                                        cfg, base),
                                       (port_am.run_all_american_scenarios_batched,
                                        jax_am.run_all_american_scenarios_batched, am_cfg, am_base)):
            sharded = port(str(path), None, b, mesh=cpu_mesh(2), device="cpu")
            assert sharded == port(str(path), None, b, device="cpu")
            want = jax_run(str(path), None, b, mesh=jax_par.make_mesh(1))
            model = [c for c in want.columns if c.startswith("model_")]
            got = pd.DataFrame(sharded)[model].to_numpy(dtype=float)
            ref = want[model].to_numpy(dtype=float)
            assert np.max(np.abs(got - ref)) <= 1e-9 * np.max(np.abs(ref))


VAL = dt.date(2025, 7, 28)
TENORS = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0])


def _swap(pkg_swap=IRSwap, leg=SwapLeg, leg_type=LegType):
    return pkg_swap(
        name="irs", effective_date=VAL, maturity_date=dt.date(2026, 7, 28), notional=1e6,
        receive_leg=leg(leg_type.FLOATING, frequency=3, curve_name="C"),
        pay_leg=leg(leg_type.FIXED, frequency=3, fixed_rate=0.075),
        discount_curve_name="C",
    )


def _cube(n_times=14, n_paths=64, seed=0):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    cube = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    return dates, cube


class TestShardedDeviceExposure:
    def test_path_sharded_mtm_matches_unsharded_and_jax(self):
        """TestShardedDeviceExposure's 14 x 64 x 6 cube, its path axis
        sharded over 8: the unsharded MTM at rtol 1e-12, and JAX's engine on
        a cube sharded over its one-device mesh within 1e-12 of max|MTM|
        (the contractions sum in another order). An unsharded FX factor in
        the same call is split alike."""
        dates, cube = _cube()
        mesh = cpu_mesh(8)
        swap = _swap()
        plain = DeviceExposureEngine(dates, {"C": cube}, TENORS, device="cpu").mtm([swap])
        sharded = DeviceExposureEngine(dates, {"C": parallel.shard_batch(cube, mesh, dim=1)}, TENORS,
                                       device="cpu").mtm([swap])
        np.testing.assert_allclose(sharded.numpy(), plain.numpy(), rtol=1e-12)
        jcube = jax.device_put(jnp.asarray(cube), NamedSharding(jax_par.make_mesh(1), PartitionSpec(None, "data",
                                                                                                      None)))
        jswap = _swap(JaxIRSwap, JaxSwapLeg, JaxLegType)
        want = np.asarray(JaxDeviceEngine(dates, {"C": jcube}, TENORS).mtm([jswap]))
        assert np.max(np.abs(sharded.numpy() - want)) <= 1e-12 * np.max(np.abs(want))
        fx = 1.0 + 0.01 * np.random.default_rng(3).normal(size=cube.shape[:2])
        fx_plain = DeviceExposureEngine(dates, {"C": cube}, TENORS, scalars={"FX": fx}, device="cpu").mtm(
            [swap], fx_factors=["FX"])
        fx_sharded = DeviceExposureEngine(dates, {"C": parallel.shard_batch(cube, mesh, dim=1)}, TENORS,
                                          scalars={"FX": fx}, device="cpu").mtm([swap], fx_factors=["FX"])
        np.testing.assert_allclose(fx_sharded.numpy(), fx_plain.numpy(), rtol=1e-12)
        with pytest.raises(ValueError, match="same shards"):
            DeviceExposureEngine(dates, {"C": parallel.shard_batch(cube, mesh, dim=1),
                                         "D": parallel.shard_batch(cube, cpu_mesh(4), dim=1)},
                                 TENORS, device="cpu").mtm([swap])

    def test_simm_gathers_a_sharded_cube(self):
        """A SIMM CSA over a path-sharded cube gathers it first (each bump
        moves the whole cube): the collateral equals the unsharded one."""
        dates, cube = _cube(n_times=8, n_paths=12, seed=4)
        csa = CSA(mpor_days=10, vm_threshold=300.0, vm_threshold_post=500.0, im_method=InitialMarginMethod.SIMM)
        swap = _swap()
        plain = DeviceExposureEngine(dates, {"C": cube}, TENORS, device="cpu").compute([swap], csa=csa)
        sharded = DeviceExposureEngine(dates, {"C": parallel.shard_batch(cube, cpu_mesh(4), dim=1)}, TENORS,
                                       device="cpu").compute([swap], csa=csa)
        assert np.abs(plain.collateral).max() > 0
        for f in ("mtm", "collateral", "exposure"):
            np.testing.assert_allclose(getattr(sharded, f), getattr(plain, f), rtol=1e-12, atol=1e-9, err_msg=f)


class TestEntry:
    def test_entry_and_dryrun_multichip(self):
        """entry(): the priced tiny batch, finite, with greeks; and every
        step of the JAX package's multi-chip dry run over a 2-way CPU mesh
        (the production shape: B=128 at float64, 1024 x 512, within
        1e-12 of max|price| of the unsharded call)."""
        fn, (tb,) = entry(device="cpu")
        out = fn(tb)
        assert set(out) == set(KEYS) and all(v.shape == (8,) and bool(torch.isfinite(v).all())
                                             for v in out.values())
        wall = dryrun_multichip(2, devices=["cpu", "cpu"])
        assert wall["production_rel_gap"] <= 1e-12
        assert {"sharded_step", "auto", "mean_stderr", "device_exposure", "american", "spike",
                "production"} <= set(wall)
