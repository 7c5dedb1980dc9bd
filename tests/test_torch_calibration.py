"""The port's calibration layer (``finite_difference_tpu_torch.calibration``:
the panel statistics, Clewlow–Strickland historical and implied, and
Hull–White one-factor) against the JAX package, on the CPU at float64, on
the same numpy panels and JSON files; and the checks of
tests/test_calibration.py's TestStatistics, TestCSCalibration,
TestCSPipeline and the HW1F part of TestHW1F, and of
test_hw1f.py::TestHW1FParams::test_from_calibration_pipeline_output, on
the port.

Tolerances, with the largest gap measured on these inputs in brackets:

- ``calc_statistics`` (stats, correlation, delta) and
  ``calibrate_hw1f_interest_rate`` on panels with NaN holes, an all-NaN
  column, an all-NaN row, a date index and a shuffled integer index, at
  ``smooth`` 0 and 2.5: 1e-12 relative, element by element, with NaN in
  the same places [2.2e-13: a drift near zero, the mean of differences];
- the Black price, ``cs_variance``, the implied objective and its gradient
  at fixed (sigma, alpha): 1e-12 relative [6.9e-16];
- the fitted (Sigma, Alpha) of ``calibrate_implied`` and
  ``bootstrap_from_json``: 1e-6 absolute, L-BFGS-B's own tolerance: both
  packages stop at its default ``pgtol``/``ftol`` from gradients that
  differ in their last bits, so the iterates may part at that level
  [5.6e-16 on the round trip].
"""
import datetime as dt
import json
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import finite_difference_tpu.calibration as jax_cal
import finite_difference_tpu.calibration.cs as jax_cs
import finite_difference_tpu.calibration.statistics as jax_stats
import finite_difference_tpu_torch.calibration as port_cal
import finite_difference_tpu_torch.calibration.cs as port_cs
import finite_difference_tpu_torch.calibration.statistics as port_stats
from finite_difference_tpu.models.mc.hw1f import HW1FParams as JaxHW1FParams
from finite_difference_tpu_torch.models.mc.hw1f import HW1FParams

CPU = "cpu"
STATS_GAP = 1e-12
OBJECTIVE_GAP = 1e-12
FIT_GAP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _ou_values(alpha=1.5, sigma=0.4, n_days=4000, n_cols=3, seed=7):
    """tests/test_calibration.py's OU levels (exp of a discretised OU log)."""
    rng = np.random.default_rng(seed)
    dt_ = 1.0 / 252.0
    theta = np.log(100.0)
    out = np.empty((n_days, n_cols))
    for c in range(n_cols):
        x = np.empty(n_days)
        x[0] = theta
        for i in range(1, n_days):
            x[i] = x[i - 1] + alpha * (theta - x[i - 1]) * dt_ + sigma * np.sqrt(dt_) * rng.normal()
        out[:, c] = np.exp(x)
    return out


def _ou_panel(alpha=1.5, sigma=0.4, n_days=4000, n_cols=3, seed=7):
    values = _ou_values(alpha, sigma, n_days, n_cols, seed)
    cols = {f"A,{0.25 * (c + 1)}": values[:, c] for c in range(n_cols)}
    return pd.DataFrame(cols, index=pd.bdate_range("2010-01-01", periods=n_days))


def _panels():
    """The panels held against JAX: holes, an all-NaN column and row, a
    date index and a shuffled integer index."""
    base = _ou_panel(n_days=700, n_cols=4, seed=11)
    rng = np.random.default_rng(3)
    holes = base.copy()
    mask = rng.random(holes.shape) < 0.05
    holes = holes.mask(mask)
    holes.iloc[0, 1] = np.nan  # a leading gap
    holes.iloc[-1, 2] = np.nan  # a trailing gap
    dropped = holes.copy()
    dropped["A,0.5"] = np.nan
    dropped.iloc[10] = np.nan
    outlier = base.copy()
    outlier.iloc[250] *= 100.0
    shuffled = holes.reset_index(drop=True).iloc[rng.permutation(len(holes))]
    rates = _ou_panel(n_days=500, n_cols=3, seed=5) / 1000.0 - 0.05
    return {"holes": holes, "all_nan_column_and_row": dropped, "outlier": outlier,
            "integer_index_shuffled": shuffled, "negative": rates}


PANELS = _panels()


def _port_panel(df):
    """The same panel as the port's ``Panel`` built with numpy (dates as
    ``datetime.date``, integer labels as ints)."""
    index = [d.date() for d in df.index] if isinstance(df.index, pd.DatetimeIndex) else [int(i) for i in df.index]
    return port_cal.Panel(index, list(df.columns), df.to_numpy())


def _elementwise(got, want, rel):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    gap = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-300)
    assert gap.size == 0 or gap.max() <= rel, float(gap.max())


def _same_panel(got, want, rel=STATS_GAP):
    assert list(got.columns) == list(want.columns)
    as_date = lambda i: i.date() if isinstance(i, pd.Timestamp) else i
    assert [as_date(i) for i in got.index] == [as_date(i) for i in want.index]
    _elementwise(got.values, want.to_numpy(), rel)


# ---------------------------------------------------------------------------
# statistics


class TestStatisticsEqualJax:
    @pytest.mark.parametrize("smooth", [0.0, 2.5])
    @pytest.mark.parametrize("method", ["Log", "Diff"])
    @pytest.mark.parametrize("panel", list(PANELS))
    def test_calc_statistics(self, panel, method, smooth):
        df = PANELS[panel]
        if method == "Log" and panel == "negative":
            df = df + 1.0
        want = jax_stats.calc_statistics(df, method=method, smooth=smooth)
        for got in (port_stats.calc_statistics(_port_panel(df), method=method, smooth=smooth),
                    port_stats.calc_statistics(df, method=method, smooth=smooth)):
            for g, w in zip(got, want):
                _same_panel(g, w)

    def test_force_positive_equals_jax(self):
        for df in PANELS.values():
            assert port_cal.force_positive_shift(_port_panel(df)) == jax_cal.force_positive_shift(df)

    def test_bad_method_raises(self):
        with pytest.raises(ValueError, match="method must be"):
            port_cal.calc_statistics(_port_panel(PANELS["holes"]), method="Level")

    def test_parse_tenor_labels(self):
        labels = ["A,0.25", 2.0, "B,10"]
        np.testing.assert_array_equal(port_stats.parse_tenor_labels(labels), jax_stats.parse_tenor_labels(labels))


class TestStatistics:
    """tests/test_calibration.py::TestStatistics on the port."""

    def test_ou_parameter_recovery(self):
        stats, corr, delta = port_cal.calc_statistics(_port_panel(_ou_panel(alpha=1.5, sigma=0.4)), method="Log")
        assert np.nanmean(stats["Mean Reversion Speed"]) == pytest.approx(1.5, rel=0.5)
        assert np.nanmean(stats["Reversion Volatility"]) == pytest.approx(0.4, rel=0.1)
        assert corr.values.shape == (3, 3)
        np.testing.assert_allclose(np.diag(corr.values), 1.0)

    def test_force_positive(self):
        table = lambda v: port_cal.Panel(range(len(v)), ["a"], np.array(v)[:, None])
        assert port_cal.force_positive_shift(table([0.01, -0.02, 0.03])) == pytest.approx(0.1)
        assert port_cal.force_positive_shift(table([0.01, 0.02])) == 0.0

    def test_smooth_outlier_removal(self):
        df = _ou_panel(n_days=500, n_cols=1)
        df.iloc[250] *= 100.0
        stats_s, _, _ = port_cal.calc_statistics(_port_panel(df), smooth=3.0)
        stats_r, _, _ = port_cal.calc_statistics(_port_panel(df))
        assert stats_s["Reversion Volatility"][0] < stats_r["Reversion Volatility"][0]


# ---------------------------------------------------------------------------
# Clewlow–Strickland


def _round_trip_options():
    """test_calibration.py::TestCSCalibration::test_implied_round_trip's
    fifteen options, priced from (0.45, 0.8) by the JAX package."""
    options = []
    for T, S in [(0.25, 0.3), (0.5, 0.6), (1.0, 1.1), (1.5, 1.6), (2.0, 2.1)]:
        for K in (90.0, 100.0, 110.0):
            var = float(jax_cs.cs_variance(0.45, 0.8, T, S))
            prem = float(jax_cs.black_european_option_price(100.0, K, 0.0, np.sqrt(var), 1.0, 1.0, 1.0)) * np.exp(
                -0.05 * T)
            options.append(dict(Forward=100.0, Strike=K, r=0.05, T=T, S=S, Premium=prem, Units=1.0,
                                Option_Type="Call", Weight=1.0))
    return options


def _bootstrap_json(tmp_path, reversed_rows=False, name="md.json"):
    """test_calibration.py::TestCSCalibration::test_bootstrap_from_json's
    market (optionally with the curves as ``_type`` arrays in reverse)."""
    fwd = [[45000 + 30 * i, 100.0 + i] for i in range(1, 13)]
    vol_rows = [[1.0, T, T + 0.08, 0.35] for T in (0.25, 0.5, 1.0)]
    fwd_curve = {"_type": "Curve", "array": fwd[::-1]} if reversed_rows else {".Curve": {"meta": [], "data": fwd}}
    disc = [[0.0, 0.05], [5.0, 0.05]]
    disc_curve = {"_type": "Curve", "array": disc[::-1]} if reversed_rows else {".Curve": {"meta": [], "data": disc}}
    options = [{"Expiry_Date": e, "Settlement_Date": s, "Option_Type": "Call"}
               for e, s in (("2023-06-15", "2023-07-15"), ("2023-09-15", "2023-10-15"),
                            ("2024-03-15", "2024-04-15"))]
    md = {"MarketData": {
        "Price Factors": {
            "ForwardPrice.BRENT.OIL": {"Curve": fwd_curve, "Currency": "USD"},
            "InterestRate.USD-OIS": {"Curve": disc_curve, "Day_Count": "ACT_365"},
            "ForwardPriceVol.BRENT.VOL": {"Surface": {".Curve": {"meta": [], "data": vol_rows}}},
            "CSForwardPriceModelParameters.BRENT.OIL": {"Sigma": 0.42, "Alpha": 1.1},
        },
        "Price Models": {}, "Model Configuration": {}, "Correlations": {},
        "System Parameters": {"Base_Date": "2023-03-15"},
        "Market Prices": {"CSForwardPriceModelPrices.BRENT.OIL": {"instrument": {
            "Forward_Volatility": "BRENT.VOL", "Energy": "BRENT.OIL", "Discount_Rate": "USD-OIS",
            "Energy_Futures_Options": options}}},
    }}
    p = tmp_path / name
    p.write_text(json.dumps(md))
    return str(p)


def _objective_arrays(options, torch_device=None):
    cols = ("Forward", "Strike", "r", "T", "S", "Premium")
    vals = [[o[c] for o in options] for c in cols]
    vals += [[o.get("Units", 1.0) for o in options],
             [1.0 if o.get("Option_Type", "Call") == "Call" else -1.0 for o in options],
             [o.get("Weight", 1.0) for o in options]]
    if torch_device is None:
        return [jnp.asarray(v, dtype=jnp.float64) for v in vals]
    return [torch.tensor(v, dtype=torch.float64, device=torch_device) for v in vals]


class TestCSEqualJax:
    def test_black_and_variance(self):
        rng = np.random.default_rng(0)
        F, K = rng.uniform(50, 150, 64), rng.uniform(50, 150, 64)
        r, vol, t = rng.uniform(0, 0.1, 64), rng.uniform(0.05, 0.8, 64), rng.uniform(0.1, 3, 64)
        bs, cp = np.where(rng.random(64) < 0.5, 1.0, -1.0), np.where(rng.random(64) < 0.5, 1.0, -1.0)
        got = port_cal.black_european_option_price(F, K, r, vol, t, bs, cp, device=CPU).numpy()
        _elementwise(got, np.asarray(jax_cal.black_european_option_price(F, K, r, vol, t, bs, cp)), 1e-12)
        for alpha in (0.0, 1e-13, 0.8, -0.5):
            args = (0.3, alpha, t, t + 0.1)
            _elementwise(port_cal.cs_variance(*args, device=CPU).numpy(), np.asarray(jax_cal.cs_variance(*args)),
                         1e-12)

    @pytest.mark.parametrize("x", [(0.3, 1.0), (0.5, 0.7), (1.2, -0.5), (0.05, 1.9)])
    def test_objective_and_gradient(self, x):
        import jax

        options = _round_trip_options()
        value, grad = port_cs._objective_value_and_grad(np.asarray(x), *_objective_arrays(options, CPU))
        jv, jg = jax.value_and_grad(jax_cs._implied_objective)(jnp.asarray(x), *_objective_arrays(options))
        assert abs(value - float(jv)) <= OBJECTIVE_GAP * abs(float(jv))
        jg = np.asarray(jg)
        assert np.abs(grad - jg).max() <= OBJECTIVE_GAP * np.abs(jg).max()

    def test_calibrate_implied(self):
        got = port_cal.calibrate_implied(_round_trip_options(), device=CPU)
        want = jax_cal.calibrate_implied(_round_trip_options())
        for k in ("Sigma", "Alpha"):
            assert abs(got[k] - want[k]) <= FIT_GAP, (k, got[k], want[k])

    def test_bootstrap_from_json(self, tmp_path):
        got = port_cal.bootstrap_from_json(_bootstrap_json(tmp_path), device=CPU)
        want = jax_cal.bootstrap_from_json(_bootstrap_json(tmp_path, name="md2.json"))
        assert set(got) == set(want) == {"BRENT.OIL"}
        for k in ("Sigma", "Alpha"):
            assert abs(got["BRENT.OIL"][k] - want["BRENT.OIL"][k]) <= FIT_GAP

    def test_calibrate_historical(self):
        df = _ou_panel(alpha=1.0, sigma=0.4, n_cols=1, n_days=1500)
        got, want = port_cal.calibrate_historical(_port_panel(df)), jax_cal.calibrate_historical(df)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= STATS_GAP * abs(want[k])

    def test_extract_compare_and_run(self, tmp_path):
        path = _bootstrap_json(tmp_path)
        assert port_cal.extract_cs_params(path) == jax_cal.extract_cs_params(path)
        assert port_cal.extract_cs_params(path, "BRENT.OIL") == jax_cal.extract_cs_params(path, "BRENT.OIL")
        cal = {"BRENT.OIL": {"Sigma": 0.44, "Alpha": 1.05}, "GOLD": {"Sigma": 0.2, "Alpha": 1.0}}
        ext = port_cal.extract_cs_params(path)
        rows = port_cal.compare_cs_params(cal, ext)
        assert rows == jax_cal.compare_cs_params(cal, ext).to_dict("records")
        out = tmp_path / "cmp.csv"
        calibrated, extracted, comparison = port_cal.run_cs_calibration(path, str(out), device=CPU)
        assert extracted == ext and [r["Parameter"] for r in comparison] == ["Sigma", "Alpha"]
        written = pd.read_csv(out)
        assert list(written.columns) == list(comparison[0])
        np.testing.assert_allclose(written["Calibrated"], [r["Calibrated"] for r in comparison], rtol=1e-15)

    def test_day_count(self):
        for code in ("ACT_365", "ACT360", "ACT_365_25", "30/360"):
            assert port_cal.get_day_count_accrual(None, 90, code) == jax_cal.get_day_count_accrual(None, 90, code)


class TestCSCalibration:
    """tests/test_calibration.py::TestCSCalibration on the port."""

    def test_historical_recovery(self):
        params = port_cal.calibrate_historical(_port_panel(_ou_panel(alpha=1.0, sigma=0.4, n_cols=1)))
        assert params["Alpha"] == pytest.approx(1.0, rel=0.6)
        assert params["Sigma"] == pytest.approx(0.4, rel=0.1)

    def test_cs_variance_limits(self):
        assert float(port_cal.cs_variance(0.3, 0.0, 2.0, 2.0, device=CPU)) == pytest.approx(0.09 * 2.0)
        assert float(port_cal.cs_variance(0.3, 1.0, 1.0, 3.0, device=CPU)) < float(
            port_cal.cs_variance(0.3, 1.0, 1.0, 1.0, device=CPU))

    def test_black_put_call_parity(self):
        F, K, r, vol, t = 100.0, 95.0, 0.05, 0.3, 1.0
        c = float(port_cal.black_european_option_price(F, K, r, vol, t, 1.0, 1.0, device=CPU))
        p = float(port_cal.black_european_option_price(F, K, r, vol, t, 1.0, -1.0, device=CPU))
        assert c - p == pytest.approx((F - K) * np.exp(-r * t), rel=1e-10)

    def test_implied_round_trip(self):
        out = port_cal.calibrate_implied(_round_trip_options(), device=CPU)
        assert out["Sigma"] == pytest.approx(0.45, rel=1e-3)
        assert out["Alpha"] == pytest.approx(0.8, rel=1e-2)

    def test_bootstrap_from_json_any_row_order(self, tmp_path):
        out = port_cal.bootstrap_from_json(_bootstrap_json(tmp_path), device=CPU)["BRENT.OIL"]
        assert 0.001 < out["Sigma"] < 2.5 and -1.0 <= out["Alpha"] <= 2.0
        out2 = port_cal.bootstrap_from_json(_bootstrap_json(tmp_path, reversed_rows=True, name="r.json"),
                                            device=CPU)["BRENT.OIL"]
        assert out2["Sigma"] == pytest.approx(out["Sigma"], rel=1e-12)
        assert out2["Alpha"] == pytest.approx(out["Alpha"], rel=1e-12)

    def test_default_device_raises_without_cuda(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cal.calibrate_implied(_round_trip_options())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cal.bootstrap_from_json(_bootstrap_json(tmp_path))


class TestCSPipeline:
    def test_extract_and_compare(self, tmp_path):
        md = {"MarketData": {"Price Factors": {"CSForwardPriceModelParameters.BRENT.OIL": {"Sigma": 0.42,
                                                                                           "Alpha": 1.1}},
                             "Price Models": {}, "Model Configuration": {}, "Correlations": {}}}
        p = tmp_path / "md.json"
        p.write_text(json.dumps(md))
        ext = port_cal.extract_cs_params(str(p))
        assert ext["BRENT.OIL"]["Sigma"] == 0.42
        rows = port_cal.compare_cs_params({"BRENT.OIL": {"Sigma": 0.44, "Alpha": 1.05}}, ext)
        assert [r for r in rows if r["Parameter"] == "Sigma"][0]["Abs_Diff"] == pytest.approx(0.02)


# ---------------------------------------------------------------------------
# Hull–White one-factor


def _same_param(got, want, rel=STATS_GAP):
    assert list(got) == list(want)
    for k in want:
        if k == "Sigma":
            g, w = got[k][".Curve"]["data"], want[k][".Curve"]["data"]
        elif k == "Historical_Yield":
            g, w = got[k], want[k]
        else:
            if isinstance(want[k], float):
                _elementwise([got[k]], [want[k]], rel)
            else:
                assert got[k] == want[k], k
            continue
        assert [t for t, _ in g] == [t for t, _ in w], k
        _elementwise([v for _, v in g], [v for _, v in w], rel)


class TestHW1FEqualJax:
    @pytest.mark.parametrize("smooth", [0.0, 2.5])
    @pytest.mark.parametrize("panel", list(PANELS))
    def test_calibrate(self, panel, smooth):
        df = PANELS[panel]
        got = port_cal.calibrate_hw1f_interest_rate(_port_panel(df), smooth=smooth)
        want = jax_cal.calibrate_hw1f_interest_rate(df, smooth=smooth)
        _same_param(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            _same_panel(g, w)

    def test_leading_nan_sigma_stays_nan(self):
        """Series.interpolate() keeps a leading gap: a first tenor whose
        reversion volatility is NaN stays NaN in Sigma, as in JAX."""
        df = PANELS["holes"].copy()
        df.iloc[:, 0] = 0.0  # log of a clipped constant: no spread, sigma2 NaN (0/0)
        got, want = (port_cal.calibrate_hw1f_interest_rate(_port_panel(df))[0],
                     jax_cal.calibrate_hw1f_interest_rate(df)[0])
        _same_param(got, want)

    def test_extract_and_compare_equal_jax(self, tmp_path):
        md = {"MarketData": {"Price Models": {"HullWhite1FactorInterestRateModel.ZAR-SWAP": {
            "Lambda": 0.0, "Alpha": 1.2, "Sigma": {".Curve": {"meta": [], "data": [[0.0, 0.1], [1.0, 0.12]]}},
            "Quanto_FX_Correlation": 0.0, "Quanto_FX_Volatility": 0.0}}}}
        p = tmp_path / "md.json"
        p.write_text(json.dumps(md))
        name = "HullWhite1FactorInterestRateModel.ZAR-SWAP"
        ext = port_cal.extract_hw1f_params(str(p), name)
        assert ext == jax_cal.extract_hw1f_params(str(p), name)
        assert port_cal.extract_hw1f_params(str(p), ["nothing"]) == {}
        with pytest.raises(FileNotFoundError):
            port_cal.extract_hw1f_params(str(tmp_path / "missing.json"), name)
        cal = {"Alpha": 1.25, "Sigma": {".Curve": {"meta": [], "data": [[0.0, 0.11], [2.0, 0.2]]}}}
        out_p, out_j = tmp_path / "port.csv", tmp_path / "jax.csv"
        rows = port_cal.compare_hw1f_params(cal, ext, name, output_path=str(out_p))
        want = jax_cal.compare_hw1f_params(cal, ext, name, output_path=str(out_j))
        assert len(rows) == len(want)
        for row, (_, w) in zip(rows, want.iterrows()):
            assert list(row) == list(want.columns)
            for k, v in row.items():
                if isinstance(w[k], float) and np.isnan(w[k]):
                    assert v is None or np.isnan(v), k
                else:
                    assert v == w[k], k
        assert out_p.read_text() == out_j.read_text()


class TestHW1F:
    """tests/test_calibration.py::TestHW1F (the HW1F part) on the port."""

    def test_calibrate_structure(self):
        param, corr, delta = port_cal.calibrate_hw1f_interest_rate(_port_panel(_ou_panel(n_cols=3)))
        assert set(param) >= {"Lambda", "Alpha", "Sigma", "Historical_Yield", "Quanto_FX_Correlation",
                              "Force_Positive"}
        assert param["Force_Positive"] == 0.0
        pairs = param["Sigma"][".Curve"]["data"]
        assert len(pairs) == 3 and all(v > 0 for _, v in pairs)

    def test_all_nan_column_keeps_tenor_alignment(self):
        df = _ou_panel(n_cols=4)
        df_nan = df.copy()
        df_nan["A,0.5"] = np.nan
        param, _, _ = port_cal.calibrate_hw1f_interest_rate(_port_panel(df_nan))
        pairs = param["Sigma"][".Curve"]["data"]
        assert [t for t, _ in pairs] == [0.25, 0.75, 1.0]
        ref, _, _ = port_cal.calibrate_hw1f_interest_rate(_port_panel(df[["A,0.25", "A,0.75", "A,1.0"]]))
        np.testing.assert_allclose([v for _, v in pairs], [v for _, v in ref["Sigma"][".Curve"]["data"]],
                                   rtol=1e-12)
        assert [t for t, _ in param["Historical_Yield"]] == [0.25, 0.75, 1.0]

    def test_negative_rates_shifted(self):
        param, _, _ = port_cal.calibrate_hw1f_interest_rate(_port_panel(_ou_panel(n_cols=2) / 1000.0 - 0.05))
        assert param["Force_Positive"] > 0

    def test_from_calibration_pipeline_output(self):
        """test_hw1f.py::TestHW1FParams::test_from_calibration_pipeline_output:
        the OrderedDict as it comes feeds the port's HW1FParams, equal to
        JAX's from the JAX calibration."""
        rng = np.random.default_rng(0)
        values = 0.07 + 0.002 * rng.standard_normal((300, 4)).cumsum(axis=0) / 50.0
        cols = [0.25, 1.0, 5.0, 10.0]
        param, _, _ = port_cal.calibrate_hw1f_interest_rate(port_cal.Panel(range(300), cols, values))
        p = HW1FParams.from_calibration(param)
        assert p.alpha > 0 and (p.sigma_values >= 0).all()
        jp = JaxHW1FParams.from_calibration(jax_cal.calibrate_hw1f_interest_rate(pd.DataFrame(values, columns=cols))[0])
        np.testing.assert_array_equal(p.sigma_tenors, jp.sigma_tenors)
        _elementwise(p.sigma_values, jp.sigma_values, STATS_GAP)
        _elementwise([p.alpha], [jp.alpha], STATS_GAP)
