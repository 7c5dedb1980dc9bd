"""Port (finite_difference_tpu_torch) host layer against the JAX package:
grids, schedules, the native C++ builder, build_trade_batch and
build_american_batch bit for bit; import hygiene; the default device."""
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu import native as jax_native
from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu.models.pde import grid as jax_grid
from finite_difference_tpu_torch import native as port_native
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import grid as port_grid

REPO_ROOT = Path(port_batch.__file__).resolve().parents[3]


def _trade_kwargs(seed=0, B=6, monitor_aligned=False):
    rng = np.random.default_rng(seed)
    t = float(rng.uniform(0.1, 1.0))
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)),
        strikes=list(rng.uniform(90.0, 110.0, B)),
        sigmas=list(rng.uniform(0.15, 0.45, B)),
        t_expiry=[t] * B,
        r=list(rng.uniform(0.0, 0.1, B)),
        b=list(rng.uniform(-0.02, 0.1, B)),
        is_call=list(rng.integers(0, 2, B) == 1),
        n_time_steps=24,
        monitor_times=[[t * (k + 1) / 5.0 for k in range(5)]] * B,
        lower=[None if i % 3 else 70.0 for i in range(B)],
        upper=[130.0 if i % 2 == 0 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 2.0, B)),
        rebate_at_hit=list(rng.integers(0, 2, B) == 1),
        num_space_nodes=127,
        monitor_aligned=monitor_aligned,
    )


class TestBuildTradeBatch:
    @pytest.mark.parametrize("use_native", [False, None], ids=["numpy", "default"])
    @pytest.mark.parametrize("monitor_aligned", [False, True])
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_bit_identical_to_jax(self, use_native, monitor_aligned, dtype):
        # the default on a uniform schedule is the C++ builder, in both packages
        kw = _trade_kwargs(seed=3, monitor_aligned=monitor_aligned)
        if use_native is not None:
            kw["use_native"] = use_native
        ref = jax_batch.build_trade_batch(dtype=getattr(np, dtype), **kw)
        got = port_batch.build_trade_batch(
            dtype=getattr(torch, dtype), device="cpu", **kw
        )
        for name in port_batch.FIELD_NAMES:
            want = np.asarray(getattr(ref, name))
            have = getattr(got, name).numpy()
            assert have.dtype == want.dtype, name
            np.testing.assert_array_equal(have, want, err_msg=name)

    def test_native_default_tau_rounding(self):
        """On a non-dyadic dt the C++ builder's tau_next (dt*(k+1)) and the
        numpy loop's (a running sum of dt) are a few roundings apart. The
        port's default route is its own copy of the C++ builder, so it is
        bit-identical to the JAX default, tau_next included."""
        assert port_native.available() and jax_native.available()
        kw = _trade_kwargs(seed=3)
        ref = jax_batch.build_trade_batch(**kw)
        got = port_batch.build_trade_batch(device="cpu", **kw)
        loop = port_batch.build_trade_batch(device="cpu", use_native=False, **kw)
        assert not np.array_equal(loop.tau_next.numpy(), got.tau_next.numpy())
        for name in port_batch.FIELD_NAMES:
            want, have = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
            assert have.dtype == want.dtype, name
            np.testing.assert_array_equal(have, want, err_msg=name)

    def test_batch_from_numpy_carries_a_jax_batch(self):
        ref = jax_batch.build_trade_batch(**_trade_kwargs(seed=5))
        fields = {k: np.asarray(v) for k, v in ref.__dict__.items() if v is not None}
        got = port_batch.batch_from_numpy(fields, device="cpu")
        assert got.batch_size == ref.batch_size and got.n_steps == ref.n_steps
        for name in port_batch.FIELD_NAMES:
            np.testing.assert_array_equal(getattr(got, name).numpy(), fields[name])

    def test_astype_and_slice(self):
        got = port_batch.build_trade_batch(device="cpu", **_trade_kwargs(seed=7))
        f32 = got.astype(torch.float32)
        assert f32.sigma.dtype == torch.float32 and f32.is_call.dtype == torch.bool
        part = got[2:4]
        assert part.batch_size == 2
        np.testing.assert_array_equal(part.dt.numpy(), got.dt.numpy()[2:4])


def _american_kwargs(seed=11, B=12, dividends=True):
    """Mixed calls and puts, per-trade maturities, 0-3 dividends per trade."""
    rng = np.random.default_rng(seed)
    te = rng.uniform(0.1, 1.2, B)
    divs = [
        [(float(rng.uniform(0.01, te[i] * 0.95)), float(rng.uniform(0.5, 3.0)))
         for _ in range(int(rng.integers(0, 4)))]
        for i in range(B)
    ]
    divs[0] = [(float(te[0] / 2.0), 1.0)]
    return dict(
        spots=list(rng.uniform(80.0, 120.0, B)),
        strikes=list(rng.uniform(80.0, 120.0, B)),
        sigmas=list(rng.uniform(0.15, 0.4, B)),
        t_expiry=list(te),
        r=list(rng.uniform(0.01, 0.1, B)),
        b=list(rng.uniform(0.0, 0.1, B)),
        is_call=[bool(i % 2) for i in range(B)],
        n_time_steps=96,
        dividends_tau=divs if dividends else None,
        num_space_nodes=201,
    )


class TestBuildAmericanBatch:
    # the three routes: dividend-free (vectorised), the C++ builder and the loop
    @pytest.mark.parametrize(
        "route,dividends,use_native",
        [("vectorised", False, True), ("native", True, True), ("loop", True, False)],
    )
    @pytest.mark.parametrize("snap", [False, True])
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_bit_identical_to_jax(self, route, dividends, use_native, snap, dtype):
        if route == "native":
            assert port_native.available() and jax_native.available()
        kw = _american_kwargs(dividends=dividends)
        ref = jax_batch.build_american_batch(
            use_native=use_native, snap_to_grid=snap, dtype=getattr(np, dtype), **kw
        )
        got = port_batch.build_american_batch(
            use_native=use_native, snap_to_grid=snap, dtype=getattr(torch, dtype),
            device="cpu", **kw,
        )
        for name in port_batch.FIELD_NAMES:
            want = np.asarray(getattr(ref, name))
            have = getattr(got, name).numpy()
            assert have.dtype == want.dtype, name
            np.testing.assert_array_equal(have, want, err_msg=name)

    def test_native_american_batches_match_jax(self):
        kw = _american_kwargs(seed=5, B=9)
        args = (
            kw["spots"], kw["strikes"], kw["sigmas"], kw["t_expiry"], kw["is_call"],
            kw["dividends_tau"], kw["n_time_steps"], 2, kw["num_space_nodes"], 4.5, True,
        )
        want, have = jax_native.american_batches(*args), port_native.american_batches(*args)
        assert set(have) == set(want)
        for name in want:
            np.testing.assert_array_equal(have[name], want[name], err_msg=name)

    @pytest.mark.parametrize("use_native", [True, False])
    def test_too_many_dividends_raises(self, use_native):
        kw = dict(
            spots=[100.0], strikes=[100.0], sigmas=[0.3], t_expiry=[1.0], r=[0.05],
            b=[0.05], is_call=[False], n_time_steps=4,
            dividends_tau=[[(0.01 * (k + 1), 1.0) for k in range(8)]],
        )
        with pytest.raises(ValueError, match="exceeded n_time_steps"):
            port_batch.build_american_batch(use_native=use_native, device="cpu", **kw)

    def test_batch_from_numpy_carries_a_jax_american_batch(self):
        ref = jax_batch.build_american_batch(**_american_kwargs(seed=2))
        fields = {k: np.asarray(v) for k, v in ref.__dict__.items() if v is not None}
        got = port_batch.batch_from_numpy(fields, device="cpu")
        for name in port_batch.FIELD_NAMES:
            np.testing.assert_array_equal(getattr(got, name).numpy(), fields[name])


class TestGrid:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_grids_and_schedules_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        t = float(rng.uniform(0.05, 2.0))
        args = dict(
            spot_eff=float(rng.uniform(80, 120)), strike=float(rng.uniform(80, 120)),
            sigma=float(rng.uniform(0.1, 0.5)), t_expiry=t, num_time_steps=64,
            lower_barrier=float(rng.uniform(50, 75)), upper_barrier=None,
        )
        a, b = port_grid.barrier_log_grid(**args), jax_grid.barrier_log_grid(**args)
        assert (a.x_min, a.dx, a.n_nodes) == (b.x_min, b.dx, b.n_nodes)
        mons = sorted(rng.uniform(0.0, t, 6).tolist()) + [t]
        for fn, kw in (
            ("uniform_schedule", dict(t_expiry=t, n_steps=40, monitor_times=mons)),
            ("monitor_aligned_schedule", dict(t_expiry=t, monitor_times=mons, target_dt=t / 30)),
        ):
            a, b = getattr(port_grid, fn)(**kw), getattr(jax_grid, fn)(**kw)
            for name in ("dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("restart", [False, True])
    def test_american_grid_and_segmented_schedule_match_jax(self, seed, restart):
        rng = np.random.default_rng(seed)
        t = float(rng.uniform(0.2, 2.0))
        args = dict(spot=float(rng.uniform(60, 140)), strike=float(rng.uniform(80, 120)),
                    sigma=float(rng.uniform(0.1, 0.5)), t_expiry=t, num_space_nodes=301)
        a, b = port_grid.american_log_grid(**args), jax_grid.american_log_grid(**args)
        assert (a.x_min, a.dx, a.n_nodes) == (b.x_min, b.dx, b.n_nodes)
        # out-of-range dividends are dropped; the rest are sorted by tau
        divs = [(float(x), float(rng.uniform(0.5, 2.0))) for x in rng.uniform(0.0, t, 3)]
        divs += [(0.0, 1.0), (t, 1.0)]
        kw = dict(t_expiry=t, base_steps=50, dividends_tau=divs, restart_rannacher_at_div=restart)
        a, b = port_grid.segmented_schedule(**kw), jax_grid.segmented_schedule(**kw)
        for name in ("dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


class TestPortBoundary:
    IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|finite_difference_tpu)(?:[.\s]|$)", re.M)
    PANDAS = re.compile(r"^(?:from|import)\s+pandas(?:[.\s]|$)", re.M)  # at module level

    def test_sources_import_no_jax(self):
        sources = sorted((REPO_ROOT / "finite_difference_tpu_torch").rglob("*.py"))
        sources.append(REPO_ROOT / "chip_smoke.py")
        assert len(sources) > 5
        names = {p.relative_to(REPO_ROOT).as_posix() for p in sources}
        assert {"finite_difference_tpu_torch/ops/special.py",
                "finite_difference_tpu_torch/models/analytic/batch.py",
                "finite_difference_tpu_torch/serving/service.py",
                "finite_difference_tpu_torch/serving/server.py",
                "finite_difference_tpu_torch/utils/curves.py",
                "finite_difference_tpu_torch/models/pde/barrier.py",
                "finite_difference_tpu_torch/models/pde/hybrid.py",
                "finite_difference_tpu_torch/runners/barrier_scenarios.py",
                "finite_difference_tpu_torch/runners/american_scenarios.py",
                "finite_difference_tpu_torch/models/analytic/bgk_pricer.py",
                "finite_difference_tpu_torch/models/analytic/bs_forward.py",
                "finite_difference_tpu_torch/models/analytic/implied_vol.py",
                "finite_difference_tpu_torch/models/pde/fis_stencil.py",
                "finite_difference_tpu_torch/models/pde/crosscheck.py",
                "finite_difference_tpu_torch/models/pde/order_accuracy.py",
                "finite_difference_tpu_torch/runners/bs_scenarios.py",
                "finite_difference_tpu_torch/runners/bgk_scenarios.py",
                "finite_difference_tpu_torch/utils/zero_curve.py",
                "finite_difference_tpu_torch/utils/profiling.py",
                "finite_difference_tpu_torch/utils/plotting.py",
                "finite_difference_tpu_torch/models/mc/__init__.py",
                "finite_difference_tpu_torch/models/mc/rng.py",
                "finite_difference_tpu_torch/models/mc/gbm.py",
                "finite_difference_tpu_torch/models/mc/clewlow_strickland.py",
                "finite_difference_tpu_torch/models/mc/discrete_barrier.py",
                "finite_difference_tpu_torch/models/mc/lsm.py",
                "finite_difference_tpu_torch/models/mc/hw1f.py",
                "finite_difference_tpu_torch/market_data/__init__.py",
                "finite_difference_tpu_torch/market_data/risk_factor.py",
                "finite_difference_tpu_torch/market_data/scenario_cube.py",
                "finite_difference_tpu_torch/market_data/yield_curve.py",
                "finite_difference_tpu_torch/instruments/__init__.py",
                "finite_difference_tpu_torch/instruments/instrument.py",
                "finite_difference_tpu_torch/instruments/schedule.py",
                "finite_difference_tpu_torch/instruments/cashflow.py",
                "finite_difference_tpu_torch/instruments/ir_swap.py",
                "finite_difference_tpu_torch/instruments/equity_barrier.py",
                "finite_difference_tpu_torch/instruments/american_option.py",
                "finite_difference_tpu_torch/portfolio/__init__.py",
                "finite_difference_tpu_torch/portfolio/csa.py",
                "finite_difference_tpu_torch/portfolio/netting_set.py",
                "finite_difference_tpu_torch/xva/__init__.py",
                "finite_difference_tpu_torch/xva/config.py",
                "finite_difference_tpu_torch/xva/cva.py",
                "finite_difference_tpu_torch/xva/exposure_engine.py",
                "finite_difference_tpu_torch/xva/device_exposure.py",
                "finite_difference_tpu_torch/market_data/cpi.py",
                "finite_difference_tpu_torch/market_data/cpi_term_structure.py",
                "finite_difference_tpu_torch/instruments/equity_pv.py",
                "finite_difference_tpu_torch/instruments/equity_trs.py",
                "finite_difference_tpu_torch/instruments/inflation_pv.py",
                "finite_difference_tpu_torch/instruments/index_linked_swap.py",
                "finite_difference_tpu_torch/instruments/commodity.py",
                "finite_difference_tpu_torch/portfolio/simm.py",
                "finite_difference_tpu_torch/xva/time_grid.py",
                "finite_difference_tpu_torch/xva/reference_price.py",
                "finite_difference_tpu_torch/xva/commodity_forward.py",
                "finite_difference_tpu_torch/xva/engine.py",
                "finite_difference_tpu_torch/runners/xva_main.py",
                "finite_difference_tpu_torch/ops/__init__.py",
                "finite_difference_tpu_torch/scenarios/__init__.py",
                "finite_difference_tpu_torch/scenarios/time_grid.py",
                "finite_difference_tpu_torch/scenarios/market_data.py",
                "finite_difference_tpu_torch/scenarios/simulation.py",
                "finite_difference_tpu_torch/scenarios/joint_cube.py",
                "finite_difference_tpu_torch/scenarios/riskflow_io.py",
                "finite_difference_tpu_torch/scenarios/diagnostics.py",
                "finite_difference_tpu_torch/calibration/__init__.py",
                "finite_difference_tpu_torch/calibration/curve_data.py",
                "finite_difference_tpu_torch/calibration/statistics.py",
                "finite_difference_tpu_torch/calibration/cs.py",
                "finite_difference_tpu_torch/calibration/hw1f.py"} <= names
        bad = [
            f"{p.relative_to(REPO_ROOT)}: {m.group(0).strip()}"
            for p in sources
            for pattern in (self.IMPORT, self.PANDAS)
            for m in pattern.finditer(p.read_text())
        ]
        assert not bad, bad

    # names the JAX package exports that wait for later slices of the port
    # (the IR swap FA check, the PCA and GBM-FX calibrations) or have no
    # counterpart (df64: the card computes float64 natively), and the
    # port's own additions of earlier slices
    LATER = {"runners": {"IRSwapFAPricer", "run_irswap_fa_check", "synthetic_zar_curves"},
             "ops": {"df64"},
             "calibration": {"CalibrationInfo", "calibrate_pca_interest_rate", "compare_pca_params",
                             "compute_curve_statistics", "extract_pca_params", "pca",
                             "bootstrap_fx_from_json", "build_parser", "compare_gbm_fx_params",
                             "correct_declining_variance", "export_gbm_fx_results", "extract_atm_vols",
                             "extract_gbm_fx_params", "read_vol_surface", "run_gbm_fx_calibration"}}
    PORT_ONLY = {"models.analytic": {"generalized_bs_greeks"}, "utils": {"build_monitoring_dates"},
                 "runners": {"run_all_american_scenarios_batched"}}

    @pytest.mark.parametrize("package", ["models.analytic", "models.pde", "runners", "utils", "models.mc",
                                         "market_data", "instruments", "portfolio", "xva", "ops",
                                         "scenarios", "calibration", "parallel"])
    def test_exports_what_jax_exports(self, package):
        import importlib

        jax_all = set(importlib.import_module(f"finite_difference_tpu.{package}").__all__)
        port_mod = importlib.import_module(f"finite_difference_tpu_torch.{package}")
        port_all = set(port_mod.__all__)
        assert jax_all - port_all == self.LATER.get(package, set())
        assert port_all - jax_all == self.PORT_ONLY.get(package, set())
        assert all(hasattr(port_mod, name) for name in port_all)

    def test_import_loads_no_jax(self):
        code = (
            "import sys; import finite_difference_tpu_torch.models.pde.batch, "
            "finite_difference_tpu_torch.models.pde.fused, "
            "finite_difference_tpu_torch.models.pde.cr, "
            "finite_difference_tpu_torch.kernels, finite_difference_tpu_torch.native, "
            "finite_difference_tpu_torch.ops.interp, finite_difference_tpu_torch.ops.special, "
            "finite_difference_tpu_torch.models.analytic, finite_difference_tpu_torch.serving, "
            "finite_difference_tpu_torch.serving.__main__, finite_difference_tpu_torch.utils, "
            "finite_difference_tpu_torch.models.pde, finite_difference_tpu_torch.runners, "
            "finite_difference_tpu_torch.models.mc, finite_difference_tpu_torch.market_data, "
            "finite_difference_tpu_torch.instruments, finite_difference_tpu_torch.portfolio, "
            "finite_difference_tpu_torch.xva, finite_difference_tpu_torch.ops, "
            "finite_difference_tpu_torch.scenarios, finite_difference_tpu_torch.calibration, "
            "finite_difference_tpu_torch.parallel, finite_difference_tpu_torch.entry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'finite_difference_tpu', 'pandas')]; "
            "assert not bad, bad"
        )
        subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, check=True, timeout=120)

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        kw = _trade_kwargs(seed=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.build_trade_batch(**kw)
        cpu_batch = port_batch.build_trade_batch(device="cpu", **kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.price_barrier_batch(cpu_batch, n_nodes=128)
        am = _american_kwargs(B=3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.build_american_batch(**am)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.price_american_batch(
                port_batch.build_american_batch(device="cpu", **am), n_nodes=202
            )
