"""Port host utilities (finite_difference_tpu_torch.utils) against the JAX
package's: the South African calendar and monitoring dates, day counts,
rate conversions, the daily NACA curves (discount factors and forward
NACC rates) built from the same (dates, naca) arrays, and the NACC zero
curve with the standalone discount factors. The code is the same, so
every value must be equal; the curves' floats are held exactly.

The profiling harness and the plots are held as the JAX package's own
tests hold them (test_utils.py's TestProfiling, test_plotting.py): the
throughput dict's keys and signs, a non-empty trace directory, PNGs
above 5 kB.
"""
import datetime as dt

import numpy as np
import pandas as pd
import pytest

from finite_difference_tpu.utils import calendars as jax_cal
from finite_difference_tpu.utils import curves as jax_curves
from finite_difference_tpu.utils import daycount as jax_dc
from finite_difference_tpu.utils import dates as jax_dates
from finite_difference_tpu.utils import rates as jax_rates
from finite_difference_tpu.utils import zero_curve as jax_zc
from finite_difference_tpu_torch.utils import calendars as port_cal
from finite_difference_tpu_torch.utils import curves as port_curves
from finite_difference_tpu_torch.utils import daycount as port_dc
from finite_difference_tpu_torch.utils import dates as port_dates
from finite_difference_tpu_torch.utils import rates as port_rates
from finite_difference_tpu_torch.utils import zero_curve as port_zc

VAL = dt.date(2025, 7, 28)


def _sweep(seed, n=60):
    rng = np.random.default_rng(seed)
    return [VAL + dt.timedelta(days=int(d)) for d in rng.integers(-400, 4000, n)]


class TestCalendar:
    @pytest.mark.parametrize("year", [2024, 2025, 2026, 2027, 2030, 2033])
    def test_holidays(self, year):
        assert port_cal.SouthAfricaCalendar.holidays(year) == jax_cal.SouthAfricaCalendar.holidays(year)
        assert port_cal.easter_sunday(year) == jax_cal.easter_sunday(year)

    def test_working_days_and_lags(self):
        pc, jc = port_cal.SouthAfricaCalendar(), jax_cal.SouthAfricaCalendar()
        for d in _sweep(0):
            assert pc.is_working_day(d) == jc.is_working_day(d)
            for lag in (-3, 0, 1, 3, 10):
                assert pc.add_working_days(d, lag) == jc.add_working_days(d, lag)
            end = d + dt.timedelta(days=45)
            assert pc.business_days_between(d, end) == jc.business_days_between(d, end)
            assert pc.working_days_in_range(d, end) == jc.working_days_in_range(d, end)

    @pytest.mark.parametrize("freq", ["daily", "weekly", "monthly"])
    def test_monitoring_dates(self, freq):
        for start in (VAL, dt.date(2025, 12, 12), dt.date(2026, 3, 30)):
            end = start + dt.timedelta(days=400)
            assert port_cal.build_monitoring_dates(start, end, freq) == \
                jax_cal.build_monitoring_dates(start, end, freq)
        with pytest.raises(ValueError, match="frequency"):
            port_cal.build_monitoring_dates(VAL, VAL + dt.timedelta(days=30), "hourly")


class TestDayCountAndRates:
    @pytest.mark.parametrize("dc", ["ACT/365", "ACT/365F", "ACT/360", "ACT/364", "30/360", "BOND", "XYZ"])
    def test_year_fractions(self, dc):
        ds = _sweep(1)
        for a, b in zip(ds, ds[1:] + ds[:1]):
            assert port_dc.year_fraction(a, b, dc) == jax_dc.year_fraction(a, b, dc)
        assert port_dc.year_denominator(dc) == jax_dc.year_denominator(dc)
        days = np.arange(-5, 900, 7)
        np.testing.assert_array_equal(port_dc.year_fractions_from_days(days, dc),
                                      jax_dc.year_fractions_from_days(days, dc))

    def test_dates(self):
        for x in ("2025-07-28", "2025/07/28", dt.datetime(2025, 7, 28, 9), VAL, pd.Timestamp(VAL)):
            assert port_dates.to_date(x) == jax_dates.to_date(x) == VAL
        assert port_dates.add_days(VAL, 2.6) == jax_dates.add_days(VAL, 2.6)
        assert port_dates.day_offset(VAL, "2026-01-01") == jax_dates.day_offset(VAL, "2026-01-01")

    def test_rates(self):
        r = np.linspace(-0.02, 0.2, 23)
        np.testing.assert_array_equal(port_rates.naca_to_nacc(r), jax_rates.naca_to_nacc(r))
        np.testing.assert_array_equal(port_rates.nacc_to_naca(r), jax_rates.nacc_to_naca(r))
        for m in ("continuous", "simple", "compounded", "discount"):
            np.testing.assert_array_equal(port_rates.discount_factor(r, 1.7, m, 2),
                                          jax_rates.discount_factor(r, 1.7, m, 2))
        with pytest.raises(ValueError):
            port_rates.discount_factor(0.05, 1.0, "bogus")


class TestCurves:
    def _arrays(self, seed):
        """A curve with gaps (forward-filled) and a non-flat NACA."""
        rng = np.random.default_rng(seed)
        days = np.sort(rng.choice(np.arange(-30, 3000), 400, replace=False))
        days[0] = -30
        dates = [(VAL + dt.timedelta(days=int(d))).strftime("%Y/%m/%d") for d in days]
        return dates, 0.05 + 0.03 * np.sin(days / 300.0)

    @pytest.mark.parametrize("dc", ["ACT/365F", "ACT/360", "30/360"])
    def test_discount_factors_and_forwards(self, dc):
        dates, naca = self._arrays(2)
        jc = jax_curves.DailyNacaCurve((dates, naca), VAL, day_count=dc)
        pc = port_curves.DailyNacaCurve((dates, naca), VAL, day_count=dc)
        # the port also takes a table with "Date" and "NACA" columns
        pt = port_curves.DailyNacaCurve(pd.DataFrame({"Date": dates, "NACA": naca}), VAL, day_count=dc)
        ds = [d for d in _sweep(3) if VAL - dt.timedelta(days=30) <= d <= VAL + dt.timedelta(days=2900)]
        np.testing.assert_array_equal(pc.discount_factors(ds), jc.discount_factors(ds))
        np.testing.assert_array_equal(pt.discount_factors(ds), jc.discount_factors(ds))
        for a, b in zip(ds, ds[1:]):
            assert pc.get_forward_nacc_rate(a, b) == jc.get_forward_nacc_rate(a, b)
            assert pc.get_nacc_rate(a) == jc.get_nacc_rate(a)
        far = VAL + dt.timedelta(days=5000)
        assert pc.get_nacc_rate(far) == jc.get_nacc_rate(far) == 0.0
        with pytest.raises(ValueError, match="not found"):
            pc.get_discount_factor(far)

    def test_flat_curves(self):
        jd = jax_curves.flat_naca_dataframe(0.0731, VAL, dt.date(2026, 9, 1))
        dates, naca = port_curves.flat_naca_dataframe(0.0731, VAL, dt.date(2026, 9, 1))
        assert dates == list(jd["Date"])
        np.testing.assert_array_equal(naca, jd["NACA"].to_numpy())
        jc = jax_curves.DailyNacaCurve(jd, VAL)
        for pc in (port_curves.DailyNacaCurve((dates, naca), VAL),
                   port_curves.DailyNacaCurve(jd, VAL),
                   port_curves.flat_curve(0.0731, VAL, start=VAL, end=dt.date(2026, 9, 1))):
            for d in _sweep(4, 20):
                if VAL <= d <= dt.date(2026, 9, 1):
                    assert pc.get_discount_factor(d) == jc.get_discount_factor(d)
        a = jax_curves.flat_curve(0.06, VAL)
        b = port_curves.flat_curve(0.06, VAL)
        assert b.get_forward_nacc_rate(VAL, dt.date(2030, 1, 1)) == \
            a.get_forward_nacc_rate(VAL, dt.date(2030, 1, 1))

    def test_load_curve_csv(self, tmp_path):
        p = tmp_path / "curve.csv"
        pd.DataFrame({"date": ["2025/07/28", "2025/08/28", "2025/09/28"], "tenor": ["0D", "1M", "2M"],
                      "value": [7.1, 7.2, 7.35]}).to_csv(p, index=False)
        want = jax_curves.load_curve_csv(str(p))
        got = port_curves.load_curve_csv(str(p))
        assert got["Date"] == list(want["Date"]) and got["Tenor"] == list(want["Tenor"])
        np.testing.assert_array_equal(got["NACA"], want["NACA"].to_numpy())
        a = jax_curves.DailyNacaCurve(want, VAL)
        b = port_curves.DailyNacaCurve(got, VAL)
        assert b.get_discount_factor(dt.date(2025, 9, 10)) == a.get_discount_factor(dt.date(2025, 9, 10))


class TestZeroCurve:
    CURVES = {
        "three_nodes": ([0.05, 0.06, 0.07], [dt.date(2026, 7, 28), dt.date(2027, 7, 28), dt.date(2030, 7, 28)]),
        "unsorted_from_valuation": ([0.061, 0.058, 0.064, 0.07],
                                    ["2027-01-28", dt.date(2025, 7, 28), dt.date(2025, 10, 28), "2035-07-28"]),
    }

    @pytest.mark.parametrize("name", list(CURVES))
    @pytest.mark.parametrize("day_count", [365.0, 360.0])
    def test_matches_jax(self, name, day_count):
        rates, mats = self.CURVES[name]
        a = jax_zc.ZeroCurve(rates, mats, VAL, day_count=day_count)
        b = port_zc.ZeroCurve(rates, mats, VAL, day_count=day_count)
        for d in _sweep(7, 40) + [VAL, VAL - dt.timedelta(days=3)]:
            assert b.get_discount_factor(d) == a.get_discount_factor(d)
            assert b.get_zero_rate(d) == a.get_zero_rate(d)
            assert b.year_fraction(VAL, d) == a.year_fraction(VAL, d)
            if d > VAL:
                assert b.forward_rate(VAL, d) == a.forward_rate(VAL, d)
        with pytest.raises(ValueError, match="end_date"):
            b.forward_rate(VAL, VAL)
        for bad, exc in ((([0.05], [VAL, VAL]), ValueError), ((["0.05"], [VAL]), TypeError)):
            with pytest.raises(exc):
                port_zc.ZeroCurve(*bad, VAL)

    @pytest.mark.parametrize("method", ["continuous", "simple", "compounded", "discount"])
    @pytest.mark.parametrize("day_count", [360, 365, 365.25])
    def test_discount_factor_methods(self, method, day_count):
        from finite_difference_tpu_torch.utils import discount_factor_methods

        for d in _sweep(8, 10):
            want = jax_zc.discount_factor(0.07, VAL, d, method, 2, day_count)
            assert discount_factor_methods(0.07, VAL, d, method, 2, day_count) == want
        with pytest.raises(ValueError, match="Unsupported"):
            discount_factor_methods(0.07, VAL, dt.date(2026, 1, 1), "bogus")
        with pytest.raises(ValueError, match="day count"):
            discount_factor_methods(0.07, VAL, dt.date(2026, 1, 1), method, day_count=364)


class TestProfiling:
    @pytest.mark.parametrize("out", ["tensor", "tuple", "dict", "none"])
    def test_throughput_harness(self, out):
        import torch

        from finite_difference_tpu_torch.utils import throughput

        x = torch.ones(16, dtype=torch.float64)
        fn = {"tensor": lambda: x * 2.0, "tuple": lambda: (1, [x * 2.0]),
              "dict": lambda: {"a": x * 2.0}, "none": lambda: None}[out]
        res = throughput(fn, items_per_call=16, iters=3, warmup=1)
        assert set(res) == {"seconds_per_call", "items_per_sec", "iters"}
        assert res["seconds_per_call"] > 0 and res["items_per_sec"] > 0 and res["iters"] == 3.0

    def test_trace_context(self, tmp_path):
        import os

        import torch

        from finite_difference_tpu_torch.utils import trace

        logdir = str(tmp_path / "trace")
        with trace(logdir) as d:
            (torch.arange(8) * 2).sum()
        assert d == logdir
        assert os.path.isdir(logdir) and os.listdir(logdir)


class TestPlotting:
    def test_exposure_profile_plot(self, tmp_path):
        from finite_difference_tpu.xva.exposure_engine import ExposureProfile
        from finite_difference_tpu_torch.utils import plot_exposure_profile

        rng = np.random.default_rng(0)
        mtm = rng.normal(100.0, 30.0, (50, 12)).cumsum(axis=1)
        profile = ExposureProfile(
            netting_set_id="NS-1", dates=tuple(VAL + dt.timedelta(days=30 * i) for i in range(12)),
            mtm=mtm, collateral=np.zeros_like(mtm), exposure=np.maximum(mtm, 0.0),
            neg_exposure=np.minimum(mtm, 0.0), currency="ZAR")
        out = tmp_path / "profile.png"
        assert plot_exposure_profile(profile, save_path=str(out)) is not None
        assert out.exists() and out.stat().st_size > 5_000

    def test_fan_convergence_and_ee_pfe_plots(self, tmp_path):
        from finite_difference_tpu_torch.utils import plot_convergence, plot_path_fan
        from finite_difference_tpu_torch.utils.plotting import plot_ee_pfe

        rng = np.random.default_rng(1)
        paths = 100.0 * np.exp(rng.normal(0, 0.02, (200, 50)).cumsum(axis=1))
        plot_path_fan(np.arange(50) / 365.0, paths, save_path=str(tmp_path / "fan.png"))
        rows = [{"M": m, "price": 10.0 + 3.0 / m**2} for m in (50, 100, 200, 400)]
        plot_convergence(rows, save_path=str(tmp_path / "conv.png"), reference_value=10.0)
        plot_convergence(rows[:2], save_path=str(tmp_path / "conv2.png"))
        plot_ee_pfe(np.arange(12), paths[:12, 0], paths[:12, 1], save_path=str(tmp_path / "ee.png"))
        for name in ("fan.png", "conv.png", "ee.png"):
            assert (tmp_path / name).stat().st_size > 5_000
        assert (tmp_path / "conv2.png").exists()
