"""Port scenario runners (finite_difference_tpu_torch.runners) against the
JAX package's on the same config CSVs, at float64 on the CPU.

The port returns a list of row dicts where the JAX runners return a
DataFrame; the columns are the same and each model column is held within
1e-10 (per-scenario runners) or 1e-9 (batched runners) of the largest
|model value| of the table. The cases mirror test_runners.py's barrier and
American runner tests, TestReferenceModelParity and TestRunnerCLIs (the
port's CLIs with ``--cpu``), and the rejections: unsupported base
parameters, an unknown route, and a ``mesh`` that is not a
``parallel.Mesh`` (the runners over a mesh of repeated CPU devices are
held in tests/test_torch_parallel.py).

The Bjerksund–Stensland and BGK runners (TestBSRunner, TestBGKRunner and
their CLIs) return row dicts like the JAX ones, which are held column by
column: the same keys in the same order, the trade and resolution columns
equal, model prices within 1e-12 relative, bump greeks within 1e-12
relative (gamma 1e-8) plus the rounding their difference quotient
amplifies (64 eps |price| / h, h^2 for gamma; test_torch_fa_analytic.py),
and the benchmark-diff columns recomputed from the row's own model value.
"""
import datetime as dt
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from finite_difference_tpu.runners import american_scenarios as jax_am
from finite_difference_tpu.runners import barrier_scenarios as jax_bar
from finite_difference_tpu.runners import bgk_scenarios as jax_bgk
from finite_difference_tpu.runners import bs_scenarios as jax_bs
from finite_difference_tpu_torch.runners import american_scenarios as port_am
from finite_difference_tpu_torch.runners import barrier_scenarios as port_bar
from finite_difference_tpu_torch.runners import bgk_scenarios as port_bgk
from finite_difference_tpu_torch.runners import bs_scenarios as port_bs

REPO_ROOT = Path(port_bar.__file__).resolve().parents[2]
VAL = dt.date(2025, 7, 28)
MAT = dt.date(2025, 8, 28)
# the reference's 24 ZA-business-day monitor schedule (run_config_scenarios.py:206-231)
MONITORS = [VAL + dt.timedelta(days=d) for d in range(32) if (VAL + dt.timedelta(days=d)).weekday() < 5]
BASE = dict(valuation=VAL, maturity=MAT, monitor_dates=MONITORS, opt_type="call",
            num_space_nodes=100, num_time_steps=60)


def _same(port_rows, jax_df, tol):
    """Same columns, the same non-model cells, and every model column within
    ``tol`` of the table's largest |model value|."""
    assert list(port_rows[0]) == list(jax_df.columns)
    got = pd.DataFrame(port_rows)
    model = [c for c in jax_df.columns if c.startswith("model_")]
    scale = np.abs(jax_df[model].to_numpy(dtype=float)).max()
    for c in jax_df.columns:
        if c.startswith("model_") or c.endswith("diff"):
            err = np.nanmax(np.abs(got[c].to_numpy(dtype=float) - jax_df[c].to_numpy(dtype=float)),
                            initial=0.0)
            assert err <= (tol * scale if c.startswith("model_") else tol * scale * 100.0), c
            assert (np.isnan(got[c].to_numpy(dtype=float)) == jax_df[c].isna().to_numpy()).all(), c
        else:
            assert list(got[c]) == list(jax_df[c]) or np.allclose(
                got[c].to_numpy(dtype=float), jax_df[c].to_numpy(dtype=float), equal_nan=True), c


def _barrier_config(tmp_path, extra=()):
    rows = [
        {"scenario_name": "s1", "S0": 229.74, "K": 190.0, "sigma": 0.2879, "rate": 0.0731,
         "barrier_type": "up-and-out", "upper_barrier": 260.0, "lower_barrier": np.nan,
         "FA_price": 32.41, "FA_delta": np.nan, "FA_gamma": np.nan, "FA_vega": np.nan},
        {"scenario_name": "s2", "S0": 229.74, "K": 190.0, "sigma": 0.2879, "rate": 0.0731,
         "barrier_type": "up-and-in", "upper_barrier": 260.0, "lower_barrier": np.nan,
         "FA_price": 8.52, "FA_delta": 0.87, "FA_gamma": 0.0, "FA_vega": np.nan},
        *extra,
    ]
    p = tmp_path / "config.csv"
    pd.DataFrame(rows).to_csv(p, index=False)
    return str(p)


MORE_ROWS = (
    {"scenario_name": "s3", "S0": 229.74, "K": 200.0, "sigma": 0.2785, "rate": 0.0731,
     "barrier_type": "down-and-out", "upper_barrier": np.nan, "lower_barrier": 210.0,
     "FA_price": 20.0, "FA_delta": np.nan, "FA_gamma": np.nan, "FA_vega": np.nan},
    {"scenario_name": "s4", "S0": 229.74, "K": 220.0, "sigma": 0.2613, "rate": 0.0731,
     "barrier_type": "down-and-in", "upper_barrier": np.nan, "lower_barrier": 210.0,
     "FA_price": np.nan, "FA_delta": np.nan, "FA_gamma": np.nan, "FA_vega": np.nan},
    {"scenario_name": "s5", "S0": 229.74, "K": 230.0, "sigma": 0.25, "rate": 0.0731,
     "barrier_type": "double-out", "upper_barrier": 255.0, "lower_barrier": 205.0,
     "FA_price": 1.0, "FA_delta": np.nan, "FA_gamma": np.nan, "FA_vega": np.nan},
)


class TestBarrierRunner:
    @pytest.mark.parametrize("extra", [dict(), dict(rebate_amount=5.0, rebate_at_hit=False),
                                       dict(use_one_sided_greeks_near_barrier=True,
                                            divs=[(dt.date(2025, 8, 12), 2.0)], underlying_spot_days=3)],
                             ids=["plain", "rebate", "one_sided_divs_lag"])
    def test_run_all_scenarios_matches_jax(self, tmp_path, extra):
        cfg = _barrier_config(tmp_path, MORE_ROWS[:2])
        base = dict(BASE, **extra)
        out = tmp_path / "results.csv"
        want = jax_bar.run_all_scenarios(cfg, None, base)
        got = port_bar.run_all_scenarios(cfg, str(out), base, device="cpu")
        _same(got, want, 1e-10)
        # the CSV reads back as the JAX runner's table would
        _same(pd.read_csv(out).to_dict("records"), want, 1e-10)

    @pytest.mark.parametrize("kw,extra", [
        (dict(), dict()),
        (dict(), dict(rebate_amount=5.0, rebate_at_hit=False)),
        (dict(schedule="monitor-aligned"), dict()),
        (dict(route="hybrid"), dict()),
        (dict(num_space_nodes=80), dict(opt_type="put")),
    ], ids=["pde", "rebate", "monitor_aligned", "hybrid_discrete", "put_nodes"])
    def test_batched_matches_jax(self, tmp_path, kw, extra):
        cfg = _barrier_config(tmp_path, MORE_ROWS)
        base = dict(BASE, **extra)
        want = jax_bar.run_all_scenarios_batched(cfg, None, base, **kw)
        got = port_bar.run_all_scenarios_batched(cfg, None, base, device="cpu", **kw)
        _same(got, want, 1e-9)

    def test_hybrid_continuous_regime_matches_jax(self, tmp_path):
        """A 10y daily-monitor table trips the FIS n_lim rule: the analytic
        sweep with BGK-shifted barriers prices it."""
        mat = dt.date(2035, 7, 28)
        base = dict(valuation=VAL, maturity=mat, opt_type="call", num_space_nodes=60,
                    num_time_steps=40,
                    monitor_dates=[VAL + dt.timedelta(days=i) for i in range(1, (mat - VAL).days + 1)])
        cfg = _barrier_config(tmp_path, MORE_ROWS)
        want = jax_bar.run_all_scenarios_batched(cfg, None, base, route="hybrid")
        got = port_bar.run_all_scenarios_batched(cfg, None, base, route="hybrid", device="cpu")
        _same(got, want, 1e-9)

    def test_batched_matches_scalar(self, tmp_path):
        """test_runners.py's scalar-vs-batched check through the port: the
        chooser's grid per scenario against the batch's pinned one."""
        cfg = _barrier_config(tmp_path)
        base = dict(BASE, num_space_nodes=300, num_time_steps=300)
        scalar = port_bar.run_all_scenarios(cfg, None, base, device="cpu")
        batched = port_bar.run_all_scenarios_batched(cfg, None, base, device="cpu")
        s = np.array([r["model_price"] for r in scalar])
        b = np.array([r["model_price"] for r in batched])
        np.testing.assert_allclose(b, s, rtol=2e-2, atol=0.2)
        assert b.sum() == pytest.approx(s.sum(), rel=2e-2)  # KO + KI = vanilla in both

    def test_batched_rejects(self, tmp_path):
        """Base parameters the batch cannot express, an unknown route, and a
        ``mesh`` that is not a ``parallel.Mesh``, each ValueError."""
        cfg = _barrier_config(tmp_path)
        for key, val in (("divs", [(dt.date(2025, 8, 15), 1.0)]), ("already_hit", True),
                         ("already_in", True), ("underlying_spot_days", 3), ("option_days", 1),
                         ("option_settlement_days", 2), ("grid_type", "sinh")):
            for run in (jax_bar.run_all_scenarios_batched, port_bar.run_all_scenarios_batched):
                kw = {} if run is jax_bar.run_all_scenarios_batched else {"device": "cpu"}
                with pytest.raises(ValueError, match="batched barrier runner"):
                    run(cfg, None, dict(BASE, **{key: val}), **kw)
        with pytest.raises(ValueError, match="route must be 'pde' or 'hybrid'"):
            port_bar.run_all_scenarios_batched(cfg, None, BASE, route="spike", device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            port_bar.run_all_scenarios_batched(cfg, None, BASE, mesh=object(), device="cpu")


class TestReferenceModelParity:
    """test_runners.py's golden rows (the reference's own 500x500 model
    outputs) through the port's per-scenario runner at full width."""

    def test_xlsx_model_block(self, tmp_path):
        cfg = tmp_path / "golden.csv"
        pd.DataFrame([
            {"scenario_name": "uo_call_H260", "S0": 229.74, "K": 190.0, "sigma": 0.28790,
             "rate": 0.073086, "barrier_type": "up-and-out", "upper_barrier": 260.0,
             "lower_barrier": np.nan, "FA_price": 32.413972, "FA_delta": np.nan,
             "FA_gamma": np.nan, "FA_vega": np.nan},
            {"scenario_name": "ui_call_H260", "S0": 229.74, "K": 190.0, "sigma": 0.28790,
             "rate": 0.073086, "barrier_type": "up-and-in", "upper_barrier": 260.0,
             "lower_barrier": np.nan, "FA_price": 8.5185837, "FA_delta": np.nan,
             "FA_gamma": np.nan, "FA_vega": np.nan},
        ]).to_csv(cfg, index=False)
        rows = port_bar.run_all_scenarios(
            str(cfg), None, dict(BASE, num_space_nodes=500, num_time_steps=500), device="cpu")
        want = {"uo_call_H260": 32.464175, "ui_call_H260": 8.4683807}
        for r in rows:
            assert r["model_price"] == pytest.approx(want[r["scenario_name"]], rel=1e-4)
        assert rows[0]["price_pct_diff"] == pytest.approx(0.1549, abs=0.01)


def _american_config(tmp_path, rows=None):
    rows = rows or [
        {"scenario_name": "am1", "S0": 176.39, "K": 170.0, "sigma": 0.2968,
         "rate": np.exp(0.0705) - 1.0, "FA_price": 2.9847, "FA_delta": -0.2979,
         "FA_gamma": 0.0231, "FA_vega": 0.1778},
        {"scenario_name": "am2", "S0": 160.0, "K": 170.0, "sigma": 0.25,
         "rate": np.exp(0.0705) - 1.0, "FA_price": np.nan, "FA_delta": np.nan,
         "FA_gamma": np.nan, "FA_vega": np.nan},
    ]
    p = tmp_path / "am.csv"
    pd.DataFrame(rows).to_csv(p, index=False)
    return str(p)


AM_BASE = dict(valuation=VAL, maturity=MAT, opt_type="put", num_space_nodes=80, num_time_steps=60)


class TestAmericanRunner:
    @pytest.mark.parametrize("extra", [dict(), dict(opt_type="call", underlying_spot_days=3)])
    def test_run_all_matches_jax(self, tmp_path, extra):
        cfg = _american_config(tmp_path)
        base = dict(AM_BASE, **extra)
        want = jax_am.run_all_american_scenarios(cfg, None, base)
        got = port_am.run_all_american_scenarios(cfg, str(tmp_path / "o.csv"), base, device="cpu")
        _same(got, want, 1e-10)

    @pytest.mark.parametrize("kw,extra", [
        (dict(), dict()),
        (dict(richardson=False), dict()),
        (dict(), dict(maturity=dt.date(2026, 1, 28), divs=[(dt.date(2025, 10, 15), 4.0)])),
    ], ids=["richardson", "flat", "dividends"])
    def test_batched_matches_jax_and_scalar(self, tmp_path, kw, extra):
        cfg = _american_config(tmp_path)
        base = dict(AM_BASE, **extra)
        want = jax_am.run_all_american_scenarios_batched(cfg, None, base, **kw)
        got = port_am.run_all_american_scenarios_batched(cfg, None, base, device="cpu", **kw)
        _same(got, want, 1e-9)
        if kw.get("richardson", True):
            # test_runners.py: the same snapped grid and Richardson quirk give
            # the scalar pricer's prices (greeks: central vs local-cubic)
            scalar = port_am.run_all_american_scenarios(cfg, None, base, device="cpu")
            np.testing.assert_allclose([r["model_price"] for r in got],
                                       [r["model_price"] for r in scalar], rtol=1e-10)

    def test_batched_rejects(self, tmp_path):
        """Non-zero settlement lags, and a ``mesh`` that is not a
        ``parallel.Mesh``, each ValueError."""
        cfg = _american_config(tmp_path)
        for lag in ("underlying_spot_days", "option_days", "option_settlement_days"):
            with pytest.raises(ValueError, match="batched American runner does not support"):
                port_am.run_all_american_scenarios_batched(cfg, None, dict(AM_BASE, **{lag: 1}),
                                                           device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            port_am.run_all_american_scenarios_batched(cfg, None, AM_BASE, mesh=object(),
                                                       device="cpu")


EPS = np.finfo(np.float64).eps


def _missing(v) -> bool:
    """None, or NaN (a CSV's empty cell read back by pandas)."""
    return v is None or (isinstance(v, float) and np.isnan(v))


def _same_trade_rows(got, want, spot_bump=1e-4, vol_bump=None):
    """Row dicts of the BS / BGK runners, column by column (module docstring).
    ``vol_bump``: the absolute sigma bump (None: 1e-4 of the row's sigma)."""
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        if "error" in w:
            assert g == w
            continue
        p = abs(w["model_price"])
        sigma = w.get("sigma")
        h = {"model_delta": (spot_bump * w.get("S", 229.74), 1),
             "model_vega": (vol_bump or 1e-4 * (sigma or 0.0), 1),
             "model_gamma": (spot_bump * w.get("S", 229.74), 2)}
        for key, wv in w.items():
            gv = g[key]
            if _missing(wv):
                assert _missing(gv), key
            elif key == "model_price":
                assert gv == pytest.approx(wv, rel=1e-12, abs=1e-300), key
            elif key in h:
                bump, order = h[key]
                rel = 1e-8 if key == "model_gamma" else 1e-12
                assert abs(gv - wv) <= rel * abs(wv) + 64 * EPS * p / bump**order, (key, gv, wv)
            elif key == "mc_std_error":
                assert gv == pytest.approx(wv, rel=1e-10, abs=1e-300)
            elif key.endswith("_abs_diff") or key.endswith("_pct_diff"):
                g_name = key.rsplit("_", 2)[0]
                bench = g[f"bench_{g_name}"]
                d = abs(g[f"model_{g_name}"] - bench)
                assert gv == pytest.approx(d if key.endswith("abs_diff") else d / abs(bench) * 100.0,
                                           rel=1e-15), key
            else:
                assert gv == wv, key


BS_TRADES = [
    dict(trade_name="t1", S=100.0, K=95.0, sigma=0.25, T=0.5, r=0.06, option_type="call",
         bench_price=None),
    dict(trade_name="t2", S=176.39, K=170.0, sigma=0.2968, valuation_date=VAL, maturity_date=MAT,
         option_type="put", discount_curve=None, underlying_spot_days=3, bench_price=2.9847),
    dict(trade_name="divs", S=110.0, K=100.0, sigma=0.3, T=0.5, r=0.06, option_type="put",
         dividends=[(0.2, 1.0), (0.4, 1.5)], bench_delta=-0.3),
    dict(trade_name="dates_only", S=95.0, K=100.0, sigma=0.28, r=0.065, option_type="call",
         valuation_date=VAL, maturity_date=dt.date(2026, 4, 28), F=99.5, bench_vega=30.0),
    dict(trade_name="fwd_curve", S=100.0, K=100.0, sigma=0.25, valuation_date=dt.date(2025, 8, 28),
         maturity_date=dt.date(2026, 8, 28), option_type="call", discount_curve=None,
         forward_curve=None, option_days=1, option_settlement_days=3,
         dividend_schedule=[(dt.date(2026, 2, 2), 2.0)], bench_gamma=0.0),
]


def _bs_trades(jax_side):
    """BS_TRADES with their curves: the JAX runner's build_flat_curve gives a
    DataFrame, the port's a (dates, naca) pair."""
    build = (jax_bgk if jax_side else port_bgk).build_flat_curve
    out = []
    for tr in BS_TRADES:
        tr = dict(tr)
        if "discount_curve" in tr:
            tr["discount_curve"] = build(0.0731, tr["valuation_date"], tr["maturity_date"])
        if "forward_curve" in tr:
            tr["forward_curve"] = build(0.085, tr["valuation_date"], tr["maturity_date"])
        out.append(tr)
    return out


class TestBSRunner:
    def test_rows_match_jax(self, tmp_path):
        want = jax_bs.run_all_bs_scenarios(_bs_trades(True), output_csv=str(tmp_path / "j.csv"))
        got = port_bs.run_all_bs_scenarios(_bs_trades(False), output_csv=str(tmp_path / "p.csv"),
                                           device="cpu")
        assert [r["path"] for r in got] == ["simple", "curve", "simple", "simple", "curve"]
        _same_trade_rows(got, want)
        # the CSV reads back as the JAX runner's
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "p.csv"), pd.read_csv(tmp_path / "j.csv"),
                                      check_exact=False, rtol=1e-6)

    def test_missing_tenor_raises(self):
        with pytest.raises(ValueError, match="supply 'T'"):
            port_bs.run_bs_scenario(dict(trade_name="x", S=1.0, K=1.0, sigma=0.2, r=0.05),
                                    device="cpu")


BGK_TRADES = [
    dict(trade_name="bgk1", S=229.74, K=190.0, sigma=0.2879, option_type="call",
         barrier_type="up-and-out", upper_barrier=260.0, monitor_dates=MONITORS, pricing_method="bgk"),
    dict(trade_name="vanilla", S=229.74, K=190.0, sigma=0.2879, option_type="call", barrier_type="none"),
    dict(trade_name="ki_rebate_weekly", S=229.74, K=200.0, sigma=0.3, option_type="put",
         barrier_type="down-and-in", lower_barrier=210.0, rebate_amount=1.5, monitor_frequency="weekly"),
    dict(trade_name="mc_monthly", S=229.74, K=230.0, sigma=0.3, option_type="call",
         barrier_type="up-and-out", upper_barrier=280.0, monitor_frequency="monthly", mc_n_paths=4096,
         rebate_amount=2.0, rebate_at_hit=True, bench_price=5.0, maturity_date=dt.date(2026, 7, 28)),
    dict(trade_name="bad", S=-1.0),
]


def _bgk_trades(jax_side):
    build = (jax_bgk if jax_side else port_bgk).build_flat_curve
    out = []
    for tr in BGK_TRADES:
        if tr["trade_name"] != "bad":
            tr = dict(dict(valuation_date=VAL, maturity_date=MAT), **tr)
            tr["discount_curve"] = build(0.0731, VAL, tr["maturity_date"])
        out.append(tr)
    return out


class TestBGKRunner:
    def test_flat_curve_builder(self):
        want = jax_bgk.build_flat_curve(0.085, VAL, MAT, pad_days=5)
        dates, naca = port_bgk.build_flat_curve(0.085, VAL, MAT, pad_days=5)
        assert dates == list(want["Date"]) and dates[0] == str(VAL - dt.timedelta(days=1))
        np.testing.assert_array_equal(naca, want["NACA"].to_numpy())

    def test_rows_match_jax(self, tmp_path, capsys):
        want = jax_bgk.run_all_bgk_scenarios(_bgk_trades(True), output_csv=str(tmp_path / "j.csv"))
        got = port_bgk.run_all_bgk_scenarios(_bgk_trades(False), output_csv=str(tmp_path / "p.csv"),
                                             print_results=True, device="cpu")
        assert "bad: ERROR" in capsys.readouterr().out
        assert [r.get("pricing_method") for r in got] == ["BGK", "BGK", "BGK", "MC", None]
        assert "error" in got[-1] and got[0]["model_price"] < got[1]["model_price"]
        _same_trade_rows(got, want, vol_bump=1e-4)
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "p.csv"), pd.read_csv(tmp_path / "j.csv"),
                                      check_exact=False, rtol=1e-6)


class TestRunnerCLIs:
    def test_barrier_cli_matches_jax(self, tmp_path, capsys):
        cfg = _barrier_config(tmp_path)
        for extra in ([], ["--batched", "--route", "hybrid", "--num-space-nodes", "200"]):
            jax_out, port_out = tmp_path / "j.csv", tmp_path / "p.csv"
            jax_bar.main([cfg, "-o", str(jax_out), "--cpu", *extra])
            rows = port_bar.main([cfg, "-o", str(port_out), "--cpu", *extra])
            assert "model_price" in capsys.readouterr().out
            want = pd.read_csv(jax_out)
            _same(rows, want, 1e-9)
            _same(pd.read_csv(port_out).to_dict("records"), want, 1e-9)

    def test_american_cli_matches_jax(self, tmp_path):
        cfg = _american_config(tmp_path, [
            {"scenario_name": "a1", "S0": 176.39, "K": 170.0, "sigma": 0.296783,
             "rate": 0.070538, "FA_price": 2.9847, "FA_delta": None, "FA_gamma": None,
             "FA_vega": None}])
        for extra in ([], ["--batched"]):
            want = jax_am.main([cfg, "--opt-type", "put", "--cpu", *extra])
            got = port_am.main([cfg, "--opt-type", "put", "--cpu", *extra])
            _same(got, want, 1e-9)

    def test_bs_cli_matches_jax(self, tmp_path, capsys):
        """test_runners.py's BS CLI case: the demo book, then a config CSV."""
        port_bs.main(["--cpu"])
        assert "ATM_Call_1Y_simple" in capsys.readouterr().out
        cfg = tmp_path / "bs.csv"
        pd.DataFrame([
            {"trade_name": "Simple1", "option_type": "call", "S": 100.0, "K": 100.0, "sigma": 0.25,
             "T": 1.0, "r": 0.07, "bench_price": 13.3639},
            {"trade_name": "CurvePut", "option_type": "put", "S": 100.0, "K": 100.0, "sigma": 0.25,
             "rate": 0.07, "valuation": "2025-08-28", "maturity": "2026-08-28", "fwd_rate": 0.08},
        ]).to_csv(cfg, index=False)
        jax_bs.main([str(cfg), "-o", str(tmp_path / "j.csv"), "--cpu"])
        rows = port_bs.main([str(cfg), "-o", str(tmp_path / "p.csv"), "--cpu"])
        assert abs(rows[0]["model_price"] - 13.3639) < 5e-4
        assert rows[1]["path"] == "curve" and rows[1]["carry_rate"] > rows[1]["disc_rate"]
        _same_trade_rows(pd.read_csv(tmp_path / "p.csv").to_dict("records"),
                         pd.read_csv(tmp_path / "j.csv").to_dict("records"))

    def test_bgk_cli_matches_jax(self, tmp_path, capsys):
        """test_runners.py's BGK CLI case (a daily BGK row with a rebate, a
        weekly MC knock-in), and the CSV route equals a trade dict's."""
        cfg = tmp_path / "bgk.csv"
        pd.DataFrame([
            {"trade_name": "D1", "option_type": "call", "barrier_type": "up-and-out", "S": 100.0,
             "K": 95.0, "sigma": 0.3, "rate": 0.085, "valuation": "2025-07-28",
             "maturity": "2026-07-28", "monitor_frequency": "daily", "upper_barrier": 130.0,
             "rebate_amount": 1.5},
            {"trade_name": "M1", "option_type": "put", "barrier_type": "down-and-in", "S": 100.0,
             "K": 105.0, "sigma": 0.28, "rate": 0.085, "valuation": "2025-07-28",
             "maturity": "2026-01-28", "monitor_frequency": "weekly", "lower_barrier": 85.0,
             "pricing_method": "mc", "mc_n_paths": 4096},
        ]).to_csv(cfg, index=False)
        jax_bgk.main([str(cfg), "-o", str(tmp_path / "j.csv"), "--cpu"])
        rows = port_bgk.main([str(cfg), "-o", str(tmp_path / "p.csv"), "--cpu"])
        assert "D1" in capsys.readouterr().out
        assert [r["pricing_method"] for r in rows] == ["BGK", "MC"]
        assert 200 <= rows[0]["n_monitors"] <= 260
        direct = port_bgk.run_bgk_scenario(port_bgk.trades_from_csv(str(cfg))[0], device="cpu")
        assert direct["model_price"] == rows[0]["model_price"]
        _same_trade_rows(pd.read_csv(tmp_path / "p.csv").to_dict("records"),
                         pd.read_csv(tmp_path / "j.csv").to_dict("records"), vol_bump=1e-4)

    def test_cli_runs_as_a_module(self, tmp_path):
        """``python -m ...runners.barrier_scenarios --cpu`` writes its CSV."""
        cfg, out = _barrier_config(tmp_path), tmp_path / "out.csv"
        subprocess.run(
            [sys.executable, "-m", "finite_difference_tpu_torch.runners.barrier_scenarios", cfg,
             "--batched", "--num-space-nodes", "100", "--cpu", "-o", str(out)],
            cwd=REPO_ROOT, check=True, timeout=300, capture_output=True,
        )
        df = pd.read_csv(out)
        assert len(df) == 2 and np.isfinite(df["model_price"]).all()


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a card the default device raises; nothing falls back to the CPU."""
    from finite_difference_tpu_torch.models import pde
    from finite_difference_tpu_torch.utils.curves import flat_curve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    curve = flat_curve(0.06, VAL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pde.AmericanFDMPricer(100.0, 100.0, VAL, MAT, 0.3, "put", curve)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pde.DiscreteBarrierFDMPricer(100.0, 100.0, VAL, MAT, 0.3, "call", discount_curve=curve)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bar.run_all_scenarios_batched(_barrier_config(tmp_path), None, BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_am.main([_american_config(tmp_path)])
    # the BGK runner's per-trade ``except`` must not turn a missing card into error rows
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bgk.run_all_bgk_scenarios(_bgk_trades(False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bs.main([])
