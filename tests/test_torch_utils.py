"""Port host utilities (finite_difference_tpu_torch.utils) against the JAX
package's: the South African calendar and monitoring dates, day counts,
rate conversions, and the daily NACA curves (discount factors and forward
NACC rates) built from the same (dates, naca) arrays. The code is the
same, so every value must be equal; the curve's floats are held exactly.
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
from finite_difference_tpu_torch.utils import calendars as port_cal
from finite_difference_tpu_torch.utils import curves as port_curves
from finite_difference_tpu_torch.utils import daycount as port_dc
from finite_difference_tpu_torch.utils import dates as port_dates
from finite_difference_tpu_torch.utils import rates as port_rates

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
