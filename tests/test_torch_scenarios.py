"""The port's scenario layer (``finite_difference_tpu_torch.scenarios``: the
time grid, the market JSON, the CS simulation, the RiskFlow frames and
CSVs, the comparator, the diagnostics and the joint cube) against the JAX
package, on the CPU at float64, on the same inputs; and the checks of
tests/test_scenarios.py, test_diagnostics.py, test_hw1f.py::TestJointCube,
test_mc.py's Sobol scenario backend and test_device_exposure.py's joint
cube pipeline on the port.

Tolerances, with the largest gap measured on these inputs in brackets:

- Excel dates, offsets, grids (month-end and leap-day run dates), the JSON
  loader and its extractors, the Cholesky factor and ``precalculate``:
  equal [0];
- ``threefry_fold_in``: word for word [0];
- ``generate_random_numbers``: threefry and sobol_device within 1e-12 of
  max|z| [5.5e-15] (torch's ``erfinv`` and XLA's round differently,
  models/mc/rng.py); a float32 request within one float32 spacing of
  max|z| [0: the float64 draws may round to float32 on either side of a
  tie]; the torch backend bit for bit [0];
- ``generate_paths``, the single- and multi-factor runs (threefry,
  sobol_device and torch) and ``simulate_joint_cube`` (host cube and
  device tensors): 1e-12 of max|value| [6.0e-16];
- scenario frames and CSVs: equal across the packages in both directions,
  the CSV text byte for byte [0]; pandas' own CSV reader within one
  rounding of the text [2.3e-16 relative];
- ``compare_scenario_outputs`` and every diagnostic: the same keys and
  verdicts, numbers within 1e-10 relative [8.1e-13, a KS statistic's
  p-value; the diagnostics 0 on the same simulation].
"""
import dataclasses
import datetime as dt
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import finite_difference_tpu.scenarios as jax_sc
import finite_difference_tpu.scenarios.diagnostics as jax_diag
import finite_difference_tpu.scenarios.simulation as jax_sim
import finite_difference_tpu.scenarios.time_grid as jax_tg
import finite_difference_tpu_torch.scenarios as port_sc
import finite_difference_tpu_torch.scenarios.diagnostics as port_diag
import finite_difference_tpu_torch.scenarios.riskflow_io as port_io
import finite_difference_tpu_torch.scenarios.simulation as port_sim
import finite_difference_tpu_torch.scenarios.time_grid as port_tg
from finite_difference_tpu_torch.models.mc import rng as port_rng

RUN = dt.date(2025, 1, 6)
CPU = "cpu"
BRENT, GOLD = "ForwardPrice.BRENT.OIL", "ForwardPrice.GOLD"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops (restored after): the
    suite's xdist workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _market_json(tmp_path, fmt="standalone"):
    """tests/test_scenarios.py's market: BRENT (historical CS, 6 tenors) and
    GOLD (implied CS, 5 tenors), rho 0.6 under the process prefix."""
    base_excel = port_tg.date_to_excel_days(RUN)
    curve_a = [[base_excel + 30 * (i + 1), 100.0 + 2.0 * i] for i in range(6)]
    curve_b = [[base_excel + 45 * (i + 1), 60.0 + i] for i in range(5)]
    md = {
        "Price Factors": {
            BRENT: {"Curve": {".Curve": {"meta": [], "data": curve_a}}, "Currency": "USD"},
            GOLD: {"Curve": {".Curve": {"meta": [], "data": curve_b}}, "Currency": "USD"},
            "CSForwardPriceModelParameters.GOLD": {"Sigma": {".Percent": 25.0}, "Alpha": 1.2},
        },
        "Price Models": {"CSForwardPriceModel.BRENT.OIL": {"Sigma": 0.35, "Alpha": 0.9, "Drift": 0.04}},
        "Model Configuration": {},
        "Correlations": {"ClewlowStricklandProcess.ForwardPrice.BRENT.OIL": {
            "ClewlowStricklandProcess.ForwardPrice.GOLD": 0.6}},
        "Valuation Configuration": {"Run_Date": RUN.isoformat(), "Time_grid": "0d 2d 1w(1w) 1m(1m)"},
    }
    if fmt == "standalone":
        path = tmp_path / "market.json"
        path.write_text(json.dumps({"MarketData": md}))
        return str(path)
    (tmp_path / "base_market.json").write_text(json.dumps({"MarketData": md}))
    deal = {"Calc": {"MergeMarketData": {
        "MarketDataFile": "base_market.json",
        "ExplicitMarketData": {"Price Models": {
            "CSForwardPriceModel.BRENT.OIL": {"Sigma": 0.5, "Alpha": 0.9, "Drift": 0.0}}},
    }, "System Parameters": {"Base_Date": "2025-01-06"}}}
    path = tmp_path / "deal.json"
    path.write_text(json.dumps(deal))
    return str(path)


def _normalize(x):
    """A loaded JSON structure with the packages' date and offset types
    made comparable: dates and datetimes as datetimes, offsets as their
    non-zero keyword dicts, arrays as lists."""
    if isinstance(x, pd.DateOffset):
        return ("offset", {k: v for k, v in x.kwds.items() if v})
    if isinstance(x, port_tg.DateOffset):
        return ("offset", {k: v for k, v in dataclasses.asdict(x).items() if v})
    if isinstance(x, pd.Timestamp):
        return x.to_pydatetime()
    if isinstance(x, dt.datetime):
        return x
    if isinstance(x, dt.date):
        return dt.datetime.combine(x, dt.time())
    if isinstance(x, np.ndarray):
        return _normalize(x.tolist())
    if isinstance(x, dict):
        key = lambda k: _normalize(k) if isinstance(k, dt.date) else k
        return {key(k): _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x


def _close(got, want, rel):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0, 1e-300)
    gap = float(np.nanmax(np.abs(got - want))) / scale if want.size else 0.0
    assert gap <= rel, gap


def _same_value(got, want, rel=1e-10):
    """Two diagnostics values: numbers within ``rel`` (relative), NaN
    matching NaN, everything else equal."""
    if isinstance(want, (pd.Timestamp, dt.date)):
        assert _normalize(got) == _normalize(want)
    elif isinstance(want, (float, np.floating, int, np.integer)) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert abs(float(got) - float(want)) <= rel * max(abs(float(want)), 1e-300), (got, want)
    elif isinstance(want, np.ndarray):
        _close(got, want, rel)
    else:
        assert got == want


def _same_rows(port_rows, jax_df, rel=1e-10):
    assert len(port_rows) == len(jax_df)
    for row, (_, want) in zip(port_rows, jax_df.iterrows()):
        assert list(row) == list(jax_df.columns)
        for k in row:
            _same_value(row[k], want[k], rel)


def _same_tree(got, want, rel=1e-10):
    if isinstance(want, pd.DataFrame):
        _same_rows(got, want, rel)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k], rel)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w, rel)
    else:
        _same_value(got, want, rel)


# ---------------------------------------------------------------------------
# time grid

DATES = [dt.date(2025, 1, 6), dt.date(2024, 1, 31), dt.date(2023, 8, 31), dt.date(2024, 2, 29),
         dt.date(2023, 12, 31), dt.date(1900, 1, 1), dt.date(2023, 1, 31)]
OFFSETS = ["0d", "2d", "1w", "1m", "3m", "1y", "1y3m", "2w3d", "1y1m1w1d", "13m", "6M", "1Y"]
GRIDS = ["0d 2d 1w(1w) 1m(1m) 3m(3m)", "0d 1m(1m)", "0d 2d 5d", "1y3m", "0d 1w(1w) 2y 1m",
         "0d 3m(3m) 1y(6m)", "0d 1w(2w) 1m(1m) 1y(1y)"]


class TestTimeGrid:
    @pytest.mark.parametrize("day", DATES)
    def test_excel_days_equal_jax(self, day):
        n = port_tg.date_to_excel_days(day)
        assert n == jax_tg.date_to_excel_days(pd.Timestamp(day))
        assert port_tg.excel_days_to_date(n) == day == jax_tg.excel_days_to_date(n).date()
        assert port_tg.date_to_excel_days(day.isoformat()) == n
        assert port_tg.EXCEL_OFFSET == jax_tg.EXCEL_OFFSET.date()

    def test_known_anchor(self):
        assert port_tg.date_to_excel_days(dt.date(1900, 1, 1)) == 2
        assert port_tg.excel_days_to_date(port_tg.date_to_excel_days(RUN)) == RUN

    @pytest.mark.parametrize("text", OFFSETS)
    def test_offsets_equal_jax(self, text):
        off, jax_off = port_tg.parse_offset(text), jax_tg.parse_offset(text)
        assert _normalize(off) == _normalize(jax_off)
        for day in DATES:
            assert day + off == (pd.Timestamp(day) + jax_off).date(), (day, text)

    @pytest.mark.parametrize("grid", GRIDS)
    def test_grids_equal_jax(self, grid):
        for run in DATES[:5]:
            for horizon in (dt.timedelta(days=10), dt.timedelta(days=400), dt.timedelta(days=1100)):
                got = port_tg.parse_time_grid(run, run + horizon, grid)
                want = jax_tg.parse_time_grid(pd.Timestamp(run), pd.Timestamp(run + horizon), grid)
                np.testing.assert_array_equal(got, want, err_msg=f"{run} {grid} {horizon}")

    def test_repeated_addition_from_the_clipped_date(self):
        grid = port_tg.parse_time_grid(dt.date(2024, 1, 31), dt.date(2024, 5, 1), "0d 1m(1m)")
        days = [dt.date(2024, 1, 31) + dt.timedelta(days=int(d)) for d in grid]
        assert days == [dt.date(2024, 1, 31), dt.date(2024, 2, 29), dt.date(2024, 3, 29), dt.date(2024, 4, 29)]

    def test_simple_offsets(self):
        grid = port_tg.parse_time_grid(RUN, RUN + dt.timedelta(days=30), "0d 2d 5d")
        np.testing.assert_array_equal(grid, [0, 2, 5])

    def test_repeating_segment_handoff(self):
        grid = port_tg.parse_time_grid(RUN, RUN + port_tg.DateOffset(months=3), "0d 1w(1w) 1m(1m)")
        assert {0, 7, 14, 21, 31, 59} <= set(grid.tolist())
        assert max(d for d in grid if d % 7 == 0 and d > 0) <= 35

    def test_max_date_truncates(self):
        assert port_tg.parse_time_grid(RUN, RUN + dt.timedelta(days=10), "0d 1w(1w) 1m(1m)").max() <= 10

    def test_compound_offset(self):
        grid = port_tg.parse_time_grid(RUN, RUN + port_tg.DateOffset(years=2), "1y3m")
        np.testing.assert_array_equal(grid, [(RUN + port_tg.DateOffset(years=1, months=3) - RUN).days])

    def test_bad_offset_raises(self):
        with pytest.raises(ValueError, match="Cannot parse offset"):
            port_tg.parse_offset("soon")


# ---------------------------------------------------------------------------
# market data


class TestMarketData:
    def test_hooks_equal_jax(self, tmp_path):
        doc = {"MarketData": {
            "Price Factors": {"X": {
                "Curve": {".Curve": {"meta": [1], "data": [[3.0, 1.0], [1.0, 2.0]]}},
                "Pct": {".Percent": 12.5}, "Basis": {".Basis": "ACT_365"}, "Desc": {".Descriptor": "d"},
                "Dates": {".DateList": [["2024-01-31", 1.5], ["2024-02-29", 2.5]]},
                "Equal": {".DateEqualList": [["2023-08-31", 1.0, 2.0]]},
                "Support": {".CreditSupportList": [[1, 2]]},
                "Offset": {".DateOffset": {"months": 3, "days": 2}},
                "Offsets": {".Offsets": [[1, "m"]]},
                "Stamp": {".Timestamp": "2024-02-29"}, "Timed": {".Timestamp": "2024-02-29 12:30:00"},
                "Model": {".ModelParams": {"modeldefaults": {"a": 1}}}, "Deal": {".Deal": {"x": 1}},
            }},
            "Correlations": {"A": {"B": 0.3, "C": -0.2}},
        }}
        path = tmp_path / "hooks.json"
        path.write_text(json.dumps(doc))
        got, want = port_sc.load_market_data(str(path)), jax_sc.load_market_data(str(path))
        assert _normalize(got) == _normalize(want)
        pf = got["Price Factors"]["X"]
        assert pf["Stamp"] == dt.date(2024, 2, 29) and pf["Timed"] == dt.datetime(2024, 2, 29, 12, 30)
        assert dt.date(2024, 1, 31) + pf["Offset"] == dt.date(2024, 5, 2)

    @pytest.mark.parametrize("fmt", ["standalone", "deal"])
    def test_loader_and_extractors_equal_jax(self, tmp_path, fmt):
        path = _market_json(tmp_path, fmt=fmt)
        got, want = port_sc.load_market_data(path), jax_sc.load_market_data(path)
        assert _normalize(got) == _normalize(want)
        for name in (BRENT, GOLD):
            for a, b in zip(port_sc.extract_forward_curve(got, name), jax_sc.extract_forward_curve(want, name)):
                np.testing.assert_array_equal(a, b)
            assert port_sc.extract_model_params(got, name) == jax_sc.extract_model_params(want, name)
        assert port_sc.extract_correlations(got) == jax_sc.extract_correlations(want)

    def test_standalone_loader(self, tmp_path):
        md = port_sc.load_market_data(_market_json(tmp_path))
        tenors, prices, ccy = port_sc.extract_forward_curve(md, BRENT)
        assert len(tenors) == 6 and ccy == "USD" and prices[0] == 100.0 and np.all(np.diff(tenors) > 0)

    def test_percent_hook_and_implied_params(self, tmp_path):
        params, mtype = port_sc.extract_model_params(port_sc.load_market_data(_market_json(tmp_path)), GOLD)
        assert mtype == "implied" and params["Sigma"] == pytest.approx(0.25) and params["Drift"] == 0.0

    def test_historical_params(self, tmp_path):
        params, mtype = port_sc.extract_model_params(port_sc.load_market_data(_market_json(tmp_path)), BRENT)
        assert mtype == "historical" and params == {"Sigma": 0.35, "Alpha": 0.9, "Drift": 0.04}

    def test_deal_format_merges_overrides(self, tmp_path):
        md = port_sc.load_market_data(_market_json(tmp_path, fmt="deal"))
        assert port_sc.extract_model_params(md, BRENT)[0]["Sigma"] == 0.5
        assert len(port_sc.extract_forward_curve(md, GOLD)[0]) == 5

    def test_correlations_flattened_and_stripped(self, tmp_path):
        corr = port_sc.extract_correlations(port_sc.load_market_data(_market_json(tmp_path)))
        assert corr[("ClewlowStricklandProcess.ForwardPrice.BRENT.OIL",
                     "ClewlowStricklandProcess.ForwardPrice.GOLD")] == 0.6
        assert corr[(BRENT, GOLD)] == 0.6


# ---------------------------------------------------------------------------
# Cholesky, precalculate, draws


CORRS = [({}, ["a", "b", "c"]), ({("a", "b"): 0.7}, ["a", "b"]),
         ({("a", "b"): 0.9, ("a", "c"): 0.9, ("b", "c"): -0.9}, ["a", "b", "c"])]


class TestCholesky:
    @pytest.mark.parametrize("case", range(len(CORRS)))
    def test_equals_jax(self, case):
        corr, names = CORRS[case]
        np.testing.assert_array_equal(port_sc.build_cholesky(corr, names), jax_sc.build_cholesky(corr, names))

    def test_identity_when_uncorrelated(self):
        np.testing.assert_allclose(port_sc.build_cholesky({}, ["a", "b", "c"]), np.eye(3))

    def test_correlated_reconstruction(self):
        L = port_sc.build_cholesky({("a", "b"): 0.7}, ["a", "b"])
        np.testing.assert_allclose(L @ L.T, [[1.0, 0.7], [0.7, 1.0]], atol=1e-12)

    def test_eigenvalue_healing(self):
        L = port_sc.build_cholesky(*CORRS[2])
        rebuilt = L @ L.T
        np.testing.assert_allclose(np.diag(rebuilt), 1.0, atol=1e-10)
        assert np.all(np.linalg.eigvalsh(rebuilt) > 0)


class TestPrecalculate:
    @pytest.mark.parametrize("implied", [False, True])
    def test_equals_jax(self, implied):
        args = (np.array([10.0, 11.0, 12.0]), np.array([45100.0, 45200.0, 45300.0]),
                np.array([0, 10, 50, 120, 250]), 0.3, 1.1, 0.05, 45000)
        got, want = port_sc.precalculate(*args, use_implied=implied), jax_sc.precalculate(*args, use_implied=implied)
        for k in ("initial_curve", "vol", "drift"):
            np.testing.assert_array_equal(got[k], want[k])

    def test_variance_stops_at_delivery(self):
        pre = port_sc.precalculate(np.array([10.0]), np.array([45030.0]), np.array([0, 15, 30, 60, 90]),
                                   0.3, 1.0, 0.0, 45000)
        vol = pre["vol"][:, 0, 0]
        assert vol[1] > 0 and vol[2] > 0
        np.testing.assert_allclose(vol[3:], 0.0, atol=1e-14)


class TestRandomNumbers:
    @pytest.mark.parametrize("seed", [0, 42, 2**31 + 7, 2**40 + 3])
    def test_fold_in_equals_jax(self, seed):
        key = port_rng.prng_key(seed)
        for data in (0, 1, 2, 15, 2**31, 2**32 - 1):
            want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data)))
            np.testing.assert_array_equal(port_rng.threefry_fold_in(key, data), want)

    @pytest.mark.parametrize("backend", ["threefry", "sobol_device"])
    @pytest.mark.parametrize("antithetic", [False, True])
    def test_draws_equal_jax(self, backend, antithetic):
        L = jax_sc.build_cholesky({("a", "b"): 0.5, ("b", "c"): -0.3}, ["a", "b", "c"])
        kw = dict(use_antithetic=antithetic, rng_backend=backend, seed=7, sobol_offset=5)
        key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
        want = np.asarray(jax_sc.generate_random_numbers(L, 9, 64, key=key, **kw))
        got = port_sc.generate_random_numbers(L, 9, 64, key=port_rng.threefry_fold_in(port_rng.prng_key(7), 3),
                                              device=CPU, **kw)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        _close(got.numpy(), want, 1e-12)

    def test_float32_request_equals_jax(self):
        L = jax_sc.build_cholesky({("a", "b"): 0.5}, ["a", "b"])
        want = np.asarray(jax_sc.generate_random_numbers(L, 12, 256, seed=3, dtype=np.float32))
        got = port_sc.generate_random_numbers(L, 12, 256, seed=3, dtype=np.float32, device=CPU)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        # one float32 rounding of the largest draw: the float64 draws differ
        # in their last bits and may round to float32 on either side
        assert np.abs(got.numpy() - want).max() <= np.spacing(np.float32(np.abs(want).max()))

    def test_torch_backend_bit_for_bit_and_global_state_untouched(self):
        L = jax_sc.build_cholesky({("a", "b"): 0.5}, ["a", "b"])
        torch.manual_seed(42)
        want = jax_sc.generate_random_numbers(L, 3, 8, use_antithetic=True, rng_backend="torch")
        torch.manual_seed(1234)
        state = torch.get_rng_state()
        got = port_sc.generate_random_numbers(L, 3, 8, use_antithetic=True, rng_backend="torch",
                                              seed=42, device=CPU)
        assert torch.equal(torch.get_rng_state(), state)
        np.testing.assert_array_equal(got.numpy(), want)
        torch.manual_seed(42)
        ref = torch.matmul(torch.tensor(L, dtype=torch.float64),
                           torch.randn(2, 4 * 3, dtype=torch.float64)).reshape(2, 3, -1)
        np.testing.assert_array_equal(got.numpy(), torch.concat([ref, -ref], dim=-1).numpy())

    def test_threefry_shape_and_antithetic(self):
        L = port_sc.build_cholesky({("a", "b"): 0.5}, ["a", "b"])
        z = port_sc.generate_random_numbers(L, 7, 64, use_antithetic=True, seed=0, device=CPU).numpy()
        assert z.shape == (2, 7, 64)
        np.testing.assert_allclose(z[:, :, :32], -z[:, :, 32:], atol=1e-12)

    def test_threefry_correlation(self):
        L = port_sc.build_cholesky({("a", "b"): 0.8}, ["a", "b"])
        z = port_sc.generate_random_numbers(L, 50, 4000, seed=3, device=CPU).numpy()
        assert np.corrcoef(z[0].ravel(), z[1].ravel())[0, 1] == pytest.approx(0.8, abs=0.02)

    def test_scenario_backend_correlation(self):
        """test_mc.py::TestMultiDimDeviceSobol::test_scenario_backend_correlation."""
        L = port_sc.build_cholesky({("A", "B"): 0.6}, ["A", "B"])
        z = port_sc.generate_random_numbers(L, num_timesteps=16, batch_size=4096,
                                            rng_backend="sobol_device", seed=0, device=CPU).numpy()
        assert z.shape == (2, 16, 4096)
        assert abs(np.mean([np.corrcoef(z[0, t], z[1, t])[0, 1] for t in range(16)]) - 0.6) < 0.02

    def test_generate_paths_equals_jax(self):
        pre = jax_sc.precalculate(np.array([50.0, 52.0, 55.0]), np.array([45030.0, 45180.0, 45365.0]),
                                  np.array([0, 2, 7, 30, 60, 90, 180, 270]), 0.35, 1.2, 0.08, 45000)
        z = np.random.default_rng(0).standard_normal((2, 8, 300))
        want = jax_sc.generate_paths(pre, z, factor_index=1)
        got = port_sc.generate_paths(pre, z, factor_index=1, device=CPU)
        assert isinstance(got, np.ndarray)
        _close(got, want, 1e-12)
        _close(port_sc.generate_paths(pre, torch.as_tensor(z), factor_index=1), want, 1e-12)


# ---------------------------------------------------------------------------
# the simulation drivers


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    return _market_json(tmp_path_factory.mktemp("market"))


def _both_runs(path, names, **kw):
    want = jax_sc.run_multi_factor_simulation_from_json(path, names, **kw)
    if kw.get("rng_backend") == "torch":
        torch.manual_seed(1)  # the port ignores the global generator
    got = port_sc.run_multi_factor_simulation_from_json(path, names, device=CPU, **kw)
    return got, want


class TestPipelineEqualsJax:
    @pytest.mark.parametrize("backend", ["threefry", "sobol_device", "torch"])
    def test_multi_factor(self, market, backend):
        (res, frames, metas), (jres, jdfs, jmetas) = _both_runs(
            market, [BRENT, GOLD], batch_size=64, simulation_batches=3, random_seed=5, rng_backend=backend)
        for name in (BRENT, GOLD):
            # the torch draws are equal bit for bit (TestRandomNumbers); the
            # paths' exp and cumsum round differently from XLA's
            _close(res[name], jres[name], 1e-12)
            np.testing.assert_array_equal(frames[name].values, res[name].reshape(res[name].shape[0], -1).T)
            _close(frames[name].values, jdfs[name].values, 1e-12)
            meta, jmeta = metas[name], jmetas[name]
            assert set(meta) == set(jmeta)
            assert meta["base_date"] == jmeta["base_date"].date()
            assert meta["scenario_dates"] == [d.date() for d in jmeta["scenario_dates"]]
            for k in set(meta) - {"base_date", "scenario_dates"}:
                if isinstance(jmeta[k], np.ndarray):
                    np.testing.assert_array_equal(meta[k], jmeta[k])
                else:
                    assert meta[k] == jmeta[k], k

    def test_single_factor_with_max_date(self, market):
        kw = dict(batch_size=32, simulation_batches=2, random_seed=9, time_grid_string="0d 1w(1w) 1m(1m)")
        sim, frame, meta = port_sc.run_simulation_from_json(market, GOLD, max_date=RUN + dt.timedelta(days=100),
                                                            device=CPU, **kw)
        jsim, jdf, jmeta = jax_sc.run_simulation_from_json(market, GOLD, max_date=pd.Timestamp(RUN) + pd.Timedelta(days=100),
                                                           **kw)
        _close(sim, jsim, 1e-12)
        np.testing.assert_array_equal(meta["scen_time_grid"], jmeta["scen_time_grid"])

    def test_grid_without_day_zero_warns(self, market):
        with pytest.warns(UserWarning, match="does not start at day 0"):
            port_sc.run_simulation_from_json(market, GOLD, time_grid_string="2d 1w(1w)", batch_size=8,
                                             simulation_batches=1, device=CPU)

    def test_default_device_raises_without_cuda(self, market, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_sc.run_simulation_from_json(market, GOLD, batch_size=8, simulation_batches=1)


class TestPipeline:
    """tests/test_scenarios.py::TestPipeline on the port."""

    def test_implied_martingale(self, market):
        sim, _, meta = port_sc.run_simulation_from_json(market, GOLD, batch_size=4096, simulation_batches=2,
                                                        random_seed=1, device=CPU)
        for i, f0 in enumerate(meta["prices"]):
            assert sim[-1, i, :].mean() == pytest.approx(f0, rel=2e-2)

    def test_historical_drift(self, market):
        sim, _, meta = port_sc.run_simulation_from_json(market, BRENT, batch_size=8192, simulation_batches=1,
                                                        random_seed=2, device=CPU)
        t = meta["scen_time_grid"][-1] / port_sc.DAYS_IN_YEAR
        expected = meta["prices"][-1] * np.exp(meta["params"]["Drift"] * t)
        assert sim[-1, -1, :].mean() == pytest.approx(expected, rel=2e-2)

    def test_multi_factor_correlation_recovery(self, market):
        results, _, _ = port_sc.run_multi_factor_simulation_from_json(
            market, [BRENT, GOLD], batch_size=8192, simulation_batches=1, random_seed=4,
            time_grid_string="0d 2d 1w(1w)", device=CPU)
        a, b = np.log(results[BRENT][1, -1, :]), np.log(results[GOLD][1, -1, :])
        assert np.corrcoef(a, b)[0, 1] == pytest.approx(0.6, abs=0.05)

    def test_riskflow_frame_round_trip(self, market):
        sim, frame, meta = port_sc.run_simulation_from_json(market, GOLD, batch_size=64, simulation_batches=1,
                                                            device=CPU)
        assert isinstance(frame, port_io.ScenarioFrame)
        back, tenors, dates = port_sc.from_riskflow_dataframe(frame)
        np.testing.assert_array_equal(back, sim)
        np.testing.assert_array_equal(tenors, meta["tenors_excel"])
        assert list(dates) == meta["scenario_dates"]

    def test_csv_export_and_reload(self, market, tmp_path):
        _, frame, _ = port_sc.run_simulation_from_json(market, GOLD, batch_size=16, simulation_batches=1,
                                                       device=CPU)
        out = tmp_path / "scen.csv"
        port_sc.export_scenarios_csv(frame, str(out))
        rt = port_sc.load_scenarios_csv(str(out))
        np.testing.assert_array_equal(rt.values, frame.values)
        np.testing.assert_array_equal(rt.tenors, frame.tenors)
        assert rt.dates == frame.dates
        np.testing.assert_array_equal(port_sc.load_riskflow_scenarios(out, GOLD).values, frame.values)
        assert port_sc.compare_scenario_outputs(rt, rt, tol=1e-12)["verdict"] == "MATCH"

    def test_load_riskflow_scenarios_nesting(self, market):
        _, frame, _ = port_sc.run_simulation_from_json(market, GOLD, batch_size=16, simulation_batches=1,
                                                       device=CPU)
        assert port_sc.load_riskflow_scenarios({"Results": {"scenarios": {GOLD: frame}}}, GOLD) is frame
        assert port_sc.load_riskflow_scenarios({"scenarios": {"X.GOLD.Y": frame}}, "GOLD") is frame
        assert port_sc.load_riskflow_scenarios({GOLD: frame}, GOLD) is frame
        assert port_sc.load_riskflow_scenarios(frame, GOLD) is frame
        with pytest.raises(KeyError, match="No scenarios found"):
            port_sc.load_riskflow_scenarios({"scenarios": {"SILVER": frame}}, "COPPER")


class TestFramesAcrossPackages:
    @pytest.fixture(scope="class")
    def pair(self, market):
        (_, frames, _), (_, jdfs, _) = _both_runs(market, [GOLD], batch_size=8, simulation_batches=1,
                                                  random_seed=3)
        return frames[GOLD], jdfs[GOLD]

    def test_frame_layout_equals_jax(self, pair):
        frame, df = pair
        np.testing.assert_array_equal(frame.tenors, df.index.get_level_values("tenor").unique().values)
        np.testing.assert_array_equal(frame.scenarios, df.index.get_level_values("scenario").unique().values)
        assert list(frame.dates) == [d.date() for d in df.columns]
        from_df = port_io.as_scenario_frame(df)
        np.testing.assert_array_equal(from_df.values, df.values)
        np.testing.assert_array_equal(port_sc.from_riskflow_dataframe(df)[0],
                                      jax_sc.from_riskflow_dataframe(df)[0])

    def test_csv_both_directions(self, pair, tmp_path):
        frame, df = pair
        port_path, jax_path = tmp_path / "port.csv", tmp_path / "jax.csv"
        # the same values in both frames, so the texts must be the same
        same = pd.DataFrame(frame.values, index=df.index, columns=df.columns)
        port_sc.export_scenarios_csv(frame, str(port_path))
        jax_sc.export_scenarios_csv(same, str(jax_path))
        assert port_path.read_text() == jax_path.read_text()
        from_jax = port_sc.load_scenarios_csv(str(jax_path))
        np.testing.assert_array_equal(from_jax.values, frame.values)
        np.testing.assert_array_equal(from_jax.tenors, frame.tenors)
        assert from_jax.dates == frame.dates
        from_port = jax_sc.load_scenarios_csv(str(port_path))
        # pandas' default CSV float parser rounds the last bit of some cells
        np.testing.assert_allclose(from_port.values, frame.values, rtol=2.3e-16, atol=0)
        assert list(from_port.columns) == list(same.columns)


class TestComparator:
    @pytest.fixture(scope="class")
    def frames(self, market):
        out = {}
        for seed, n in ((1, 64), (2, 128)):
            (_, f, _), (_, j, _) = _both_runs(market, [GOLD], batch_size=n, simulation_batches=1, random_seed=seed)
            out[seed] = f[GOLD], j[GOLD]
        return out

    @staticmethod
    def _same_result(got, want):
        assert set(got) == set(want) and got["verdict"] == want["verdict"]
        _same_rows(got["moment_df"], want["moment_df"])
        assert got["common_tenors"] == [float(t) for t in want["common_tenors"]]
        assert got["common_dates"] == [d.date() for d in want["common_dates"]]
        for k in ("path_results", "ks_results"):
            if want[k] is None:
                assert got[k] is None
                continue
            assert list(got[k]) == [(float(t), d.date()) for t, d in want[k]]
            for g, w in zip(got[k].values(), want[k].values()):
                _same_tree(g, w)

    def test_identical_match_equals_jax(self, frames):
        f, j = frames[1]
        got, want = port_sc.compare_scenario_outputs(f, f), jax_sc.compare_scenario_outputs(j, j.copy())
        assert got["verdict"] == "MATCH" and got["same_scenario_count"]
        self._same_result(got, want)

    def test_perturbed_mismatch_equals_jax(self, frames):
        f, j = frames[1]
        scaled = dataclasses.replace(f, values=f.values * 1.001)
        got, want = port_sc.compare_scenario_outputs(f, scaled), jax_sc.compare_scenario_outputs(j, j * 1.001)
        assert got["verdict"] == "MISMATCH"
        self._same_result(got, want)

    def test_different_counts_ks_equals_jax(self, frames):
        (f1, j1), (f2, j2) = frames[1], frames[2]
        got, want = port_sc.compare_scenario_outputs(f1, f2), jax_sc.compare_scenario_outputs(j1, j2)
        assert got["verdict"] is None and got["ks_results"]
        assert np.mean([v["match"] for v in got["ks_results"].values()]) > 0.5
        self._same_result(got, want)

    def test_pandas_frame_accepted(self, frames):
        f, j = frames[1]
        assert port_sc.compare_scenario_outputs(f, j, tol=1e-10)["verdict"] == "MATCH"

    def test_no_common_tenors(self, frames):
        f, _ = frames[1]
        moved = dataclasses.replace(f, tenors=f.tenors + 1.0e6)
        assert port_sc.compare_scenario_outputs(f, moved) == {"error": "no_common_tenors"}


class TestReviewHardening:
    def test_sobol_batches_are_distinct(self, market):
        run = lambda seed, n: port_sc.run_simulation_from_json(market, GOLD, batch_size=128, simulation_batches=n,
                                                               random_seed=seed, rng_backend="sobol_device",
                                                               device=CPU)[0]
        sim2 = run(1, 2)
        b0, b1 = sim2[..., :128], sim2[..., 128:]
        assert not np.allclose(b0, b1)
        assert not np.allclose(b0, run(9, 1))
        np.testing.assert_allclose(b1, run(1 + 64, 1), rtol=0)

    def test_convergence_analysis_small_run(self, market):
        sim, _, meta = port_sc.run_simulation_from_json(market, GOLD, batch_size=32, simulation_batches=1,
                                                        random_seed=1, device=CPU)
        assert port_diag.convergence_analysis(sim, meta)[-1]["n"] == 32

    def test_theoretical_moments_clip_at_delivery(self):
        params = {"Sigma": 0.3, "Alpha": 1.2, "Drift": 0.04}
        args = ([100.0], [45000.0 + 0.5 * 365.25], 45000.0, params)
        out = port_sim._theoretical_moments(*args, 2.0)
        np.testing.assert_allclose(out, port_sim._theoretical_moments(*args, 0.5), rtol=1e-12)
        assert out == jax_sim._theoretical_moments(*args, 2.0)


# ---------------------------------------------------------------------------
# diagnostics (tests/test_diagnostics.py)


@pytest.fixture(scope="module")
def diag_sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("diag")
    base_excel = port_tg.date_to_excel_days(RUN)
    curve = lambda rows: {".Curve": {"meta": [], "data": rows}}
    md = {"MarketData": {
        "Price Factors": {
            "ForwardPrice.BRENT": {"Curve": curve([[base_excel + 120, 100.0], [base_excel + 240, 102.0],
                                                   [base_excel + 480, 104.0]]), "Currency": "USD"},
            "ForwardPrice.GOLD": {"Curve": curve([[base_excel + 120, 50.0], [base_excel + 480, 52.0]]),
                                  "Currency": "USD"},
            "CSForwardPriceModelParameters.BRENT": {"Sigma": 0.4, "Alpha": 1.1},
            "CSForwardPriceModelParameters.GOLD": {"Sigma": 0.25, "Alpha": 0.8},
        },
        "Price Models": {}, "Model Configuration": {},
        "Correlations": {"ClewlowStricklandProcess.ForwardPrice.BRENT": {
            "ClewlowStricklandProcess.ForwardPrice.GOLD": 0.5}},
        "Valuation Configuration": {"Run_Date": RUN.isoformat(), "Time_grid": "0d 2d 1w(1w) 1m(1m)"},
    }}
    p = tmp / "md.json"
    p.write_text(json.dumps(md))
    sim, frame, meta = port_sc.run_simulation_from_json(
        str(p), "ForwardPrice.BRENT", batch_size=8192, simulation_batches=2, random_seed=3,
        max_date=RUN + dt.timedelta(days=100), device=CPU)
    return str(p), sim, frame, meta


def _jax_meta(meta):
    out = dict(meta)
    out["base_date"] = pd.Timestamp(meta["base_date"])
    out["scenario_dates"] = pd.DatetimeIndex(meta["scenario_dates"])
    return out


class TestDiagnosticsEqualJax:
    @pytest.mark.parametrize("name", ["martingale_test", "moment_matching", "tail_analysis",
                                      "parameter_recovery", "convergence_analysis",
                                      "standard_error_analysis"])
    def test_diagnostic(self, diag_sim, name):
        _, sim, _, meta = diag_sim
        _same_tree(getattr(port_diag, name)(sim, meta), getattr(jax_diag, name)(sim, _jax_meta(meta)))

    def test_full_suite_on_a_frame(self, diag_sim):
        _, sim, frame, meta = diag_sim
        got = port_diag.run_full_diagnostics(frame, dict(meta), sim_benchmark=sim)
        want = jax_diag.run_full_diagnostics(sim, _jax_meta(meta), sim_benchmark=sim)
        _same_tree(got, want)

    def test_correlation_recovery(self, diag_sim):
        path, _, _, _ = diag_sim
        names = ["ForwardPrice.BRENT", "ForwardPrice.GOLD"]
        (res, _, metas), (jres, _, jmetas) = _both_runs(path, names, batch_size=512, simulation_batches=1,
                                                        random_seed=5)
        corr = {(names[0], names[1]): 0.5}
        _same_tree(port_diag.correlation_recovery(res, metas, corr),
                   jax_diag.correlation_recovery(jres, jmetas, corr), rel=1e-10)
        assert port_diag.correlation_recovery({names[0]: res[names[0]]}, metas) is None

    def test_theory_equals_jax(self):
        args = (0.3, 1.0, np.array([0.5, 1.0, 2.0]), np.array([0.25, 1.0, 5.0]))
        np.testing.assert_array_equal(port_sc.cs_log_variance(*args), jax_sc.cs_log_variance(*args))
        _same_tree(port_sc.cs_theoretical_price_moments(100.0, 0.3, 1.0, 0.05, 2.0, 1.0),
                   jax_sc.cs_theoretical_price_moments(100.0, 0.3, 1.0, 0.05, 2.0, 1.0))


class TestDiagnostics:
    """tests/test_diagnostics.py on the port's simulation."""

    def test_log_variance_limits(self):
        assert port_sc.cs_log_variance(0.3, 0.0, 2.0, 1.0) == pytest.approx(0.09)
        assert port_sc.cs_log_variance(0.3, 1.0, 1.0, 5.0) == port_sc.cs_log_variance(0.3, 1.0, 1.0, 1.0)

    def test_price_moments_consistency(self):
        out = port_sc.cs_theoretical_price_moments(100.0, 0.3, 1.0, 0.05, 2.0, 1.0)
        assert out["price_mean"] == pytest.approx(100.0 * np.exp(0.05)) and out["price_std"] > 0

    def test_implied_passes(self, diag_sim):
        _, sim, _, meta = diag_sim
        rows = port_sc.martingale_test(sim, meta)
        assert np.mean([r["pass"] for r in rows]) > 0.8
        np.testing.assert_allclose([r["ratio"] for r in rows], 1.0, atol=0.02)

    def test_log_and_price_moments(self, diag_sim):
        _, sim, _, meta = diag_sim
        log_rows, price_rows = port_sc.moment_matching(sim, meta)
        assert log_rows
        np.testing.assert_allclose([r["sim_var"] for r in log_rows], [r["theo_var"] for r in log_rows], rtol=0.1)
        np.testing.assert_allclose([r["sim_mean"] for r in price_rows], [r["theo_mean"] for r in price_rows],
                                   rtol=0.02)

    def test_ks_and_quantiles(self, diag_sim):
        _, sim, _, meta = diag_sim
        out = port_sc.tail_analysis(sim, meta)
        assert out["ks_pvalue"] > 0.001
        for d in out["quantiles"].values():
            assert d["sim"] == pytest.approx(d["theo"], abs=0.05)

    def test_parameter_recovery(self, diag_sim):
        _, sim, _, meta = diag_sim
        rec = port_sc.parameter_recovery(sim, meta)
        assert rec["alpha"] == pytest.approx(meta["params"]["Alpha"], abs=0.3)
        assert rec["sigma"] == pytest.approx(meta["params"]["Sigma"], rel=0.15)
        assert rec["drift"] == pytest.approx(0.0, abs=0.05)

    def test_correlation_recovered(self, diag_sim):
        path, _, _, _ = diag_sim
        results, _, metas = port_sc.run_multi_factor_simulation_from_json(
            path, ["ForwardPrice.BRENT", "ForwardPrice.GOLD"], batch_size=8192, simulation_batches=1,
            random_seed=5, device=CPU)
        rows = port_sc.correlation_recovery(results, metas)
        assert rows is not None and len(rows) == 1
        assert rows[0]["rho_sim"] == pytest.approx(0.5, abs=0.05)

    def test_run_full_diagnostics(self, diag_sim):
        _, sim, _, meta = diag_sim
        out = port_sc.run_full_diagnostics(sim, meta, sim_benchmark=sim)
        assert set(out) >= {"martingale", "moments", "tails", "recovery", "convergence", "standard_errors",
                            "comparison"}
        assert out["comparison"]["max_abs_diff"] == 0.0
        assert out["convergence"][-1]["se"] < out["convergence"][0]["se"]


# ---------------------------------------------------------------------------
# the joint cube (test_hw1f.py::TestJointCube, test_device_exposure.py's pipeline)

TENORS0 = np.array([0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
RATES0 = np.array([0.070, 0.071, 0.072, 0.074, 0.077, 0.079, 0.080])
VAL = dt.date(2025, 7, 28)
TENORS = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])


def _joint_specs(pkg, device=None):
    """TestJointCube's factors in either package (``device`` for the port)."""
    from importlib import import_module

    mc = import_module(f"{pkg}.models.mc")
    jc = import_module(f"{pkg}.scenarios.joint_cube")
    kw = {} if device is None else {"device": device}
    sim = mc.HW1FCurveSimulator(mc.HW1FParams.flat(alpha=0.15, sigma=0.01), TENORS0, RATES0, **kw)
    return {"ZAR-SWAP": jc.HW1FCurveFactor(simulator=sim, tenors=TENORS0),
            "FX.USDZAR": jc.GBMScalarFactor(params=mc.GBMParams(mu=0.0, sigma=0.15), s0=18.0)}


def _pipeline_specs(pkg, device=None):
    """TestJointCubeDevicePipeline's factors and correlations."""
    from importlib import import_module

    mc = import_module(f"{pkg}.models.mc")
    jc = import_module(f"{pkg}.scenarios.joint_cube")
    kw = {} if device is None else {"device": device}
    mk = lambda r0: mc.HW1FCurveSimulator(mc.HW1FParams.flat(alpha=0.05, sigma=0.008), curve_tenors=TENORS,
                                          curve_rates=np.full(TENORS.size, r0), **kw)
    factors = {"ZAR-SWAP": jc.HW1FCurveFactor(mk(0.075), TENORS), "INFL.ZA": jc.HW1FCurveFactor(mk(0.05), TENORS),
               "CPI.ZA": jc.GBMScalarFactor(mc.GBMParams(mu=0.05, sigma=0.015), 102.4),
               "EQ.SPOT": jc.GBMScalarFactor(mc.GBMParams(mu=0.07, sigma=0.25), 100.0)}
    return factors, {("ZAR-SWAP", "INFL.ZA"): 0.4, ("CPI.ZA", "INFL.ZA"): 0.6}


class TestJointCube:
    @pytest.mark.parametrize("antithetic", [True, False])
    def test_host_cube_equals_jax(self, antithetic):
        kw = dict(n_paths=33, correlations={("ZAR-SWAP", "FX.USDZAR"): -0.4}, seed=5, antithetic=antithetic)
        got = port_sc.simulate_joint_cube(VAL, [30, 61, 92, 400], _joint_specs("finite_difference_tpu_torch", CPU),
                                          device=CPU, **kw)
        want = jax_sc.simulate_joint_cube(VAL, [30, 61, 92, 400], _joint_specs("finite_difference_tpu"), **kw)
        assert got.dates == want.dates
        for name in ("ZAR-SWAP", "FX.USDZAR"):
            _close(got.factor_array(name), want.factor_array(name), 1e-12)

    def test_device_arrays_equal_jax(self):
        scen_days = list(range(30, 400, 30))
        factors, corr = _pipeline_specs("finite_difference_tpu_torch", CPU)
        jfactors, _ = _pipeline_specs("finite_difference_tpu")
        dates, curves, scalars, tbn = port_sc.simulate_joint_cube(VAL, scen_days, factors, 16, corr, as_jax=True,
                                                                  device=CPU)
        jdates, jcurves, jscalars, jtbn = jax_sc.simulate_joint_cube(VAL, scen_days, jfactors, 16, corr, as_jax=True)
        assert dates == jdates and set(tbn) == set(jtbn)
        for name in jcurves:
            assert torch.is_tensor(curves[name])
            _close(curves[name].numpy(), np.asarray(jcurves[name]), 1e-12)
            np.testing.assert_array_equal(tbn[name], jtbn[name])
        for name in jscalars:
            _close(scalars[name].numpy(), np.asarray(jscalars[name]), 1e-12)

    def test_simulator_on_another_device_raises(self):
        with pytest.raises(ValueError, match="its simulator is on cpu"):
            port_sc.simulate_joint_cube(VAL, [30], _joint_specs("finite_difference_tpu_torch", CPU), 4,
                                        device="meta")

    def test_bad_grid_and_spec_raise(self):
        with pytest.raises(ValueError, match="strictly positive"):
            port_sc.simulate_joint_cube(VAL, [0, 30], _joint_specs("finite_difference_tpu_torch", CPU), 4,
                                        device=CPU)
        with pytest.raises(TypeError, match="Unknown factor spec"):
            port_sc.simulate_joint_cube(VAL, [30], {"X": 1.0}, 4, device=CPU)

    def test_shapes_and_t0_slices(self):
        cube = port_sc.simulate_joint_cube(VAL, [30, 60, 90], _joint_specs("finite_difference_tpu_torch", CPU),
                                           n_paths=64, seed=5, device=CPU)
        assert cube.n_times == 4 and cube.n_paths == 64
        s0 = cube.get_time_slice(0)
        np.testing.assert_allclose(s0["FX.USDZAR"].values, 18.0)
        np.testing.assert_allclose(s0["ZAR-SWAP"].values, np.broadcast_to(RATES0, (64, RATES0.size)))

    def test_cross_factor_correlation_recovered(self):
        rho = 0.7
        cube = port_sc.simulate_joint_cube(VAL, list(range(7, 371, 7)),
                                           _joint_specs("finite_difference_tpu_torch", CPU), n_paths=20_000,
                                           correlations={("ZAR-SWAP", "FX.USDZAR"): rho}, seed=9, device=CPU)
        d_fx = np.diff(np.log(cube.factor_array("FX.USDZAR")), axis=0)
        d_r = np.diff(cube.factor_array("ZAR-SWAP")[:, :, 0], axis=0)
        assert abs(np.mean([np.corrcoef(d_fx[t], d_r[t])[0, 1] for t in range(d_fx.shape[0])]) - rho) < 0.03

    def test_mixed_cube_through_exposure_engine(self):
        from finite_difference_tpu_torch.instruments import IRSwap, LegType, SwapLeg
        from finite_difference_tpu_torch.portfolio import NettingSet, Trade
        from finite_difference_tpu_torch.xva import ExposureEngine

        cube = port_sc.simulate_joint_cube(VAL, [30 * i for i in range(1, 13)] + [400],
                                           _joint_specs("finite_difference_tpu_torch", CPU), n_paths=128,
                                           correlations={("ZAR-SWAP", "FX.USDZAR"): -0.3}, seed=3, device=CPU)
        swap = IRSwap(name="s", effective_date=VAL, maturity_date=dt.date(2026, 7, 28), notional=1_000_000,
                      receive_leg=SwapLeg(LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
                      pay_leg=SwapLeg(LegType.FIXED, frequency=3, fixed_rate=0.073),
                      discount_curve_name="ZAR-SWAP")
        prof = ExposureEngine(cube).compute(NettingSet("NS", [Trade(swap, "T1", currency="USD",
                                                                    fx_rate_factor="FX.USDZAR")]))
        assert prof.ee().max() > 0
        prof_zar = ExposureEngine(cube).compute(NettingSet("NS", [Trade(swap, "T1")]))
        fx = cube.factor_array("FX.USDZAR").T
        np.testing.assert_allclose(prof.mtm, prof_zar.mtm * fx, rtol=1e-12, atol=1e-9)

    def test_multifactor_device_pipeline_matches_generic(self):
        """test_device_exposure.py::TestJointCubeDevicePipeline on the port."""
        from finite_difference_tpu_torch import instruments as inst
        from finite_difference_tpu_torch import market_data as md
        from finite_difference_tpu_torch.portfolio import NettingSet, Trade
        from finite_difference_tpu_torch.xva import DeviceExposureEngine, ExposureEngine

        n_paths, scen_days = 16, list(range(30, 780, 30))
        factors, corr = _pipeline_specs("finite_difference_tpu_torch", CPU)
        dates, curves, scalars, _ = port_sc.simulate_joint_cube(VAL, scen_days, factors, n_paths, corr,
                                                                as_jax=True, device=CPU)
        div = np.full((len(dates), n_paths, TENORS.size), 0.02)
        curves["EQ.DIV"] = torch.as_tensor(div)
        host_cube = md.ScenarioCube(dates, {
            **{k: ("curve", v.numpy(), TENORS) for k, v in curves.items()},
            **{k: ("scalar", v.numpy()) for k, v in scalars.items()},
        })
        swap = inst.IRSwap(name="irs", effective_date=VAL, maturity_date=dt.date(2027, 7, 28), notional=1_000_000,
                           receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
                           pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=3, fixed_rate=0.08),
                           discount_curve_name="ZAR-SWAP")
        trs = inst.EquityTRS(
            name="trs", effective_date=VAL, maturity_date=dt.date(2027, 7, 28), quantity=1000.0,
            notional=100_000.0,
            interest_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP", spread=0.01),
            spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
            discount_curve_name="ZAR-SWAP", initial_price=100.0)
        hist = {md.shift_months(md.first_of_month(VAL), -k): 100.0 + 0.3 * (8 - k) for k in range(0, 9)}
        ils = inst.IndexLinkedSwap(
            name="ils", effective_date=VAL, maturity_date=dt.date(2027, 7, 28), notional=1_000_000,
            inflation_leg=inst.InflationLeg(real_rate=0.025, base_cpi=100.0, cpi_curve_name="CPI.ZA", frequency=6,
                                            inflation_rate_curve_name="INFL.ZA"),
            nominal_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=6, fixed_rate=0.08),
            discount_curve_name="ZAR-SWAP", inflation_index=hist)
        generic = ExposureEngine(host_cube).compute(
            NettingSet("NS", [Trade(swap, "T1"), Trade(trs, "T2"), Trade(ils, "T3")]))
        mtm = DeviceExposureEngine(dates, curves, TENORS, scalars=scalars, device=CPU).mtm([swap, trs, ils])
        np.testing.assert_allclose(mtm.numpy(), generic.mtm, rtol=1e-9, atol=1e-4)
