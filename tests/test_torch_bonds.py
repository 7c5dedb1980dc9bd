"""The port's bond, rates and inflation pricers (``finite_difference_tpu_torch.bonds``)
against the JAX package on the CPU, and tests/test_bonds.py's 18 checks on
the port.

Each package gets its own curve (``utils.curves.DailyNacaCurve``, flat or
a seeded sloped one) and its own ``HistoricalCPI`` from the same numbers.
Every price, accrued amount, YTM, val01, gamma, forward price, NPV and
fair rate is held to JAX's within 1e-12 relative (an NPV that should be
zero against its notional instead); on these inputs the two packages
agree bit for bit, since both run the same float arithmetic in Python.
"""
import datetime as dt
import math

import numpy as np
import pytest

import finite_difference_tpu.bonds as jax_bonds
import finite_difference_tpu_torch.bonds as port_bonds
from finite_difference_tpu.instruments.schedule import get_calendar as jax_get_calendar
from finite_difference_tpu.market_data import HistoricalCPI as JaxHistoricalCPI
from finite_difference_tpu.utils.curves import DailyNacaCurve as JaxDailyNacaCurve
from finite_difference_tpu_torch.bonds import (
    FixedRateBond,
    FixedRateBondPricer,
    ForwardInflationBondPricer,
    ForwardRateAgreement,
    ForwardRateAgreementPricer,
    InflationLinkedBondPricer,
    InflationLinkedSwap,
    InflationLinkedSwapPricer,
    ZeroCouponBond,
    ZeroCouponBondPricer,
)
from finite_difference_tpu_torch.instruments.schedule import get_calendar
from finite_difference_tpu_torch.market_data import HistoricalCPI
from finite_difference_tpu_torch.utils.curves import DailyNacaCurve, flat_curve

VAL = dt.date(2025, 7, 28)
BOND_GAP = 1e-12


def _curve(naca=0.07):
    return flat_curve(naca, VAL)


# ---------------------------------------------------------------------------
# tests/test_bonds.py on the port


class TestZeroCoupon:
    def test_pv(self):
        curve = _curve(np.exp(0.06) - 1.0)  # 6% NACC
        bond = ZeroCouponBond(1_000_000, dt.date(2027, 7, 28))
        pv = ZeroCouponBondPricer(bond, curve).present_value()
        t = curve.year_fraction(VAL, bond.maturity_date)
        assert pv == pytest.approx(1_000_000 * math.exp(-0.06 * t), rel=1e-9)

    def test_pv01_sign_and_magnitude(self):
        curve = _curve()
        bond = ZeroCouponBond(1_000_000, dt.date(2030, 7, 28))
        p = ZeroCouponBondPricer(bond, curve)
        t = curve.year_fraction(VAL, bond.maturity_date)
        assert p.pv01() == pytest.approx(t * p.present_value() * 1e-4, rel=1e-3)

    def test_validation(self):
        with pytest.raises(ValueError):
            ZeroCouponBond(-1, dt.date(2026, 1, 1))
        with pytest.raises(TypeError):
            ZeroCouponBond(100, "2026-01-01")


def _frb(coupon=0.08):
    return FixedRateBond(
        notional=100.0,
        issue_date=dt.date(2020, 1, 28),
        value_date=VAL,
        last_coupon_date=dt.date(2025, 7, 15),
        next_coupon_date=dt.date(2026, 1, 15),
        maturity_date=dt.date(2030, 1, 15),
        coupon_rate=coupon,
    )


class TestFixedRateBond:
    def test_schedule_semiannual(self):
        b = _frb()
        assert b.schedule[0] == dt.date(2026, 1, 15)
        assert b.schedule[-1] == dt.date(2030, 1, 15)
        assert len(b.schedule) == 9

    def test_dirty_clean_accrued(self):
        pr = FixedRateBondPricer(_frb(), _curve())
        dirty = pr.dirty_price()
        accrued = pr.accrued_amount()
        assert dirty > 0
        days = (VAL - dt.date(2025, 7, 15)).days
        assert accrued == pytest.approx(days * 0.08 * 100 / 365)
        assert pr.clean_price() == pytest.approx(dirty - accrued)

    def test_ytm_round_trip(self):
        pr = FixedRateBondPricer(_frb(), _curve())
        ytm = pr.yield_to_maturity()
        assert pr._dirty_from_yield(ytm) == pytest.approx(pr.dirty_price(), abs=1e-8)
        assert 0.03 < ytm < 0.12

    def test_val01_gamma_signs(self):
        pr = FixedRateBondPricer(_frb(), _curve())
        assert pr.val01() > 0
        assert pr.gamma() > 0

    def test_ex_coupon_accrued_negative(self):
        b = FixedRateBond(
            notional=100.0,
            issue_date=dt.date(2020, 1, 28),
            value_date=dt.date(2026, 1, 10),  # within 10 bd of NCD
            last_coupon_date=dt.date(2025, 7, 15),
            next_coupon_date=dt.date(2026, 1, 15),
            maturity_date=dt.date(2030, 1, 15),
            coupon_rate=0.08,
        )
        pr = FixedRateBondPricer(b, flat_curve(0.07, b.value_date))
        assert pr.accrued_amount() < 0


_FRA = dict(settle_date=dt.date(2025, 10, 28), maturity_date=dt.date(2026, 1, 28), notional=1_000_000)


class TestFRA:
    def test_forward_matches_curve(self):
        curve = _curve(np.exp(0.06) - 1.0)
        pr = ForwardRateAgreementPricer(ForwardRateAgreement(position="long", strike_rate=0.05, **_FRA), curve)
        tau = curve.year_fraction(_FRA["settle_date"], _FRA["maturity_date"])
        assert pr.forward_rate() == pytest.approx((math.exp(0.06 * tau) - 1.0) / tau, rel=1e-9)

    def test_npv_zero_at_fair_strike(self):
        curve = _curve()
        fair = ForwardRateAgreementPricer(ForwardRateAgreement(position="long", strike_rate=0.05, **_FRA),
                                          curve).forward_rate()
        fra2 = ForwardRateAgreement(position="long", strike_rate=fair, **_FRA)
        assert ForwardRateAgreementPricer(fra2, curve).npv() == pytest.approx(0.0, abs=1e-9)

    def test_long_short_antisymmetry(self):
        curve = _curve()
        long_npv = ForwardRateAgreementPricer(ForwardRateAgreement(position="long", strike_rate=0.05, **_FRA),
                                              curve).npv()
        short_npv = ForwardRateAgreementPricer(ForwardRateAgreement(position="short", strike_rate=0.05, **_FRA),
                                               curve).npv()
        assert long_npv == pytest.approx(-short_npv)
        assert long_npv > 0  # fwd (~7%) above 5% strike


def _cpi_args(infl=0.05, value_date=VAL):
    df = lambda d: math.exp(-infl * (d - value_date).days / 365.0)
    hist = {dt.date(2025, m, 1): 100.0 * math.exp(infl * (m - 6) / 12) for m in range(1, 8)}
    return (value_date, hist), dict(discount_factor_fn=df, extend_cpi=120)


def _cpi(infl=0.05):
    args, kw = _cpi_args(infl)
    return HistoricalCPI(*args, **kw)


_ILB = dict(issue_date=dt.date(2020, 1, 15), maturity_date=dt.date(2030, 1, 15), notional=1_000_000,
            coupon_rate=0.025, value_date=VAL, base_cpi=80.0)


class TestInflationBond:
    def _bond(self, infl=0.05):
        return InflationLinkedBondPricer(discount_curve=_curve(), historical_cpi=_cpi(infl), **_ILB)

    def test_prices_and_accrued(self):
        b = self._bond()
        dirty, clean, accrued = b.dirty_price(), b.clean_price(), b.accrued_interest()
        assert dirty > clean and accrued > 0
        assert b.index_ratio() > 1.0
        assert b.pv() == pytest.approx(dirty / 100 * 1_000_000)

    def test_higher_inflation_raises_price(self):
        assert self._bond(0.08).dirty_price() > self._bond(0.02).dirty_price()

    def test_forward_pricer(self):
        s = ForwardInflationBondPricer(underlying_bond=self._bond(), forward_date=dt.date(2026, 7, 28)).summary()
        assert s["forward_dirty_price"] > 0
        assert s["forward_dirty_price"] == pytest.approx(s["forward_clean_price"] + s["forward_accrued"])
        assert s["npv"] == pytest.approx(0.0, abs=1e-9)  # strike defaulted to forward clean

    def test_forward_npv_long_short(self):
        bond = self._bond()
        long, short = (ForwardInflationBondPricer(underlying_bond=bond, forward_date=dt.date(2026, 7, 28),
                                                  strike_price=50.0, position=p).npv() for p in ("long", "short"))
        assert long == pytest.approx(-short) and long > 0

    def test_forward_date_validation(self):
        with pytest.raises(ValueError):
            ForwardInflationBondPricer(underlying_bond=self._bond(), forward_date=VAL)


class TestInflationSwap:
    def _swap(self, fixed=0.05, pay_fixed=True):
        return InflationLinkedSwap(issue_date=dt.date(2025, 1, 28), maturity_date=dt.date(2030, 7, 28),
                                   notional=1_000_000, fixed_rate=fixed, historical_cpi=_cpi(), yield_curve=_curve(),
                                   value_date=VAL, pay_fixed_leg=pay_fixed)

    def test_fair_rate_zeroes_npv(self):
        fair = InflationLinkedSwapPricer(self._swap()).fair_fixed_rate()
        assert InflationLinkedSwapPricer(self._swap(fixed=fair)).npv() == pytest.approx(0.0, abs=1e-6)

    def test_pay_receive_antisymmetry(self):
        a = InflationLinkedSwapPricer(self._swap(pay_fixed=True)).npv()
        b = InflationLinkedSwapPricer(self._swap(pay_fixed=False)).npv()
        assert a == pytest.approx(-b)


# ---------------------------------------------------------------------------
# port = JAX

# each package's own bonds module, CPI store and curve class
PKG = {"jax": (jax_bonds, JaxHistoricalCPI, JaxDailyNacaCurve), "port": (port_bonds, HistoricalCPI, DailyNacaCurve)}


def _curve_points(value_date, seed, years=31):
    """A seeded sloped NACA curve: a knot every 30 days from a month before
    ``value_date``, forward-filled daily by the curve."""
    rng = np.random.default_rng(seed)
    n = years * 365 // 30 + 2
    dates = [value_date - dt.timedelta(days=30) + dt.timedelta(days=30 * i) for i in range(n)]
    rates = 0.065 + 0.02 * (1.0 - np.exp(-np.arange(n) / 40.0)) + rng.normal(0.0, 5e-4, n)
    return dates, rates


def _make_curve(pkg, value_date, seed):
    dates, rates = _curve_points(value_date, seed)
    return PKG[pkg][2]((dates, rates), value_date)


def _make_cpi(pkg, infl=0.05, value_date=VAL):
    args, kw = _cpi_args(infl, value_date)
    return PKG[pkg][1](*args, **kw)


def _same(got: dict, want: dict, scale: dict = None):
    """Every value within BOND_GAP of JAX's, relative to itself (or to
    ``scale[k]`` where one is given: an NPV near zero)."""
    assert list(got) == list(want)
    for k, w in want.items():
        ref = (scale or {}).get(k, abs(w))
        assert abs(got[k] - w) <= BOND_GAP * max(ref, 1e-300), (k, got[k], w)


class TestBondsEqualJax:
    @pytest.mark.parametrize("years,seed", [(1, 0), (5, 1), (12, 2), (30, 3)])
    def test_zero_coupon(self, years, seed):
        def run(pkg):
            curve = _make_curve(pkg, VAL, seed)
            p = PKG[pkg][0].ZeroCouponBondPricer(PKG[pkg][0].ZeroCouponBond(1e6, VAL.replace(year=VAL.year + years)),
                                                 curve)
            return {"pv": p.present_value(), "pv01": p.pv01(), "pv01_10bp": p.pv01(1e-3)}

        _same(run("port"), run("jax"))

    @pytest.mark.parametrize("ncd", [dt.date(2026, 1, 15), dt.date(2026, 5, 5), dt.date(2026, 1, 2),
                                     dt.date(2026, 4, 10)])
    def test_book_close(self, ncd):
        """The book-close date, NCD less 10 business days, across a month
        end, a year end and South African public holidays."""
        want = jax_get_calendar("SouthAfrica").add_working_days(ncd, -10)
        assert get_calendar("SouthAfrica").add_working_days(ncd, -10) == want
        pinned = {dt.date(2026, 1, 15): dt.date(2025, 12, 31), dt.date(2026, 5, 5): dt.date(2026, 4, 17),
                  dt.date(2026, 1, 2): dt.date(2025, 12, 15), dt.date(2026, 4, 10): dt.date(2026, 3, 25)}
        assert want == pinned[ncd]

    @pytest.mark.parametrize("offset", [-1, 0, 1])
    @pytest.mark.parametrize("ncd,frequency,years", [(dt.date(2026, 1, 15), "semi-annual", 5),
                                                     (dt.date(2026, 5, 5), "semi-annual", 30),
                                                     (dt.date(2026, 1, 2), "quarterly", 8),
                                                     (dt.date(2026, 4, 10), "annual", 12)])
    def test_fixed_rate(self, ncd, frequency, years, offset):
        """Dirty, accrued, clean, YTM, val01 and gamma (at the bond's value
        date and a later one), with the value date a day before, on and a
        day after book close."""
        book_close = get_calendar("SouthAfrica").add_working_days(ncd, -10)
        value_date = book_close + dt.timedelta(days=offset)
        months = {"semi-annual": 6, "quarterly": 3, "annual": 12}[frequency]
        lcd = dt.date(ncd.year - (1 if ncd.month <= months else 0), (ncd.month - months - 1) % 12 + 1, ncd.day)

        def run(pkg):
            bonds = PKG[pkg][0]
            b = bonds.FixedRateBond(notional=100.0, issue_date=dt.date(2019, 3, 1), value_date=value_date,
                                    last_coupon_date=lcd, next_coupon_date=ncd,
                                    maturity_date=ncd.replace(year=ncd.year + years), coupon_rate=0.0875,
                                    frequency=frequency)
            pr = bonds.FixedRateBondPricer(b, _make_curve(pkg, value_date, seed=years))
            ytm = pr.yield_to_maturity()
            later = value_date + dt.timedelta(days=45)
            return {"dirty": pr.dirty_price(), "accrued": pr.accrued_amount(), "clean": pr.clean_price(), "ytm": ytm,
                    "val01": pr.val01(), "gamma": pr.gamma(), "val01_later": pr.val01(later, yield_to_maturity=ytm),
                    "gamma_later": pr.gamma(later, bump=1e-3), "schedule": len(b.schedule)}

        got, want = run("port"), run("jax")
        _same(got, want)
        assert (got["accrued"] >= 0) == (offset < 0)  # cum before book close, ex from it

    @pytest.mark.parametrize("position", ["long", "short"])
    @pytest.mark.parametrize("start_months,frequency", [(3, "quarterly"), (6, "semi-annual"), (24, "quarterly")])
    def test_fra(self, start_months, frequency, position):
        settle = dt.date(2025 + (7 + start_months - 1) // 12, (7 + start_months - 1) % 12 + 1, 28)
        months = 3 if frequency == "quarterly" else 6
        maturity = dt.date(settle.year + (settle.month + months - 1) // 12, (settle.month + months - 1) % 12 + 1, 28)

        def run(pkg):
            bonds, curve = PKG[pkg][0], _make_curve(pkg, VAL, seed=start_months)
            fra = bonds.ForwardRateAgreement(settle, maturity, position, 0.071, 5e6, frequency)
            pr = bonds.ForwardRateAgreementPricer(fra, curve)
            fair = bonds.ForwardRateAgreementPricer(
                bonds.ForwardRateAgreement(settle, maturity, position, pr.forward_rate(), 5e6, frequency), curve)
            return {"forward": pr.forward_rate(), "npv": pr.npv(), "npv_at_fair": fair.npv(),
                    "index_months": fra.index_months}

        got, want = run("port"), run("jax")
        _same(got, want, scale={"npv_at_fair": 5e6})
        assert abs(got["npv_at_fair"]) <= 1e-8 * 5e6

    @pytest.mark.parametrize("value_date,forward_date,settlement", [
        (VAL, dt.date(2025, 10, 28), None),
        (dt.date(2026, 1, 14), dt.date(2026, 4, 14), dt.date(2026, 4, 16)),  # a coupon inside (spot, forward]
        (dt.date(2026, 1, 15), dt.date(2026, 7, 28), None),  # on a coupon date
    ])
    def test_inflation_bond(self, value_date, forward_date, settlement):
        def run(pkg):
            bonds = PKG[pkg][0]
            bond = bonds.InflationLinkedBondPricer(discount_curve=_make_curve(pkg, value_date, seed=7),
                                                   historical_cpi=_make_cpi(pkg, 0.055, value_date),
                                                   **{**_ILB, "value_date": value_date})
            out = {f"spot_{k}": v for k, v in bond.summary().items()}
            for position in ("long", "short"):
                for strike in (None, 97.5):
                    fwd = bonds.ForwardInflationBondPricer(bond, forward_date, settlement_date=settlement,
                                                           strike_price=strike, position=position,
                                                           contract_notional=2.5e6)
                    out.update({f"{position}_{strike}_{k}": v for k, v in fwd.summary().items()})
            return out

        got, want = run("port"), run("jax")
        _same(got, want, scale={k: 2.5e6 for k in want if k.endswith("_None_npv")})

    @pytest.mark.parametrize("pay_fixed", [True, False])
    @pytest.mark.parametrize("value_date,frequency", [(VAL, 6), (dt.date(2026, 3, 2), 3), (dt.date(2027, 9, 30), 6)])
    def test_inflation_swap(self, value_date, frequency, pay_fixed):
        def run(pkg):
            bonds = PKG[pkg][0]
            kw = dict(issue_date=dt.date(2025, 1, 28), maturity_date=dt.date(2032, 7, 28), notional=1e7,
                      historical_cpi=_make_cpi(pkg, 0.045, value_date),
                      yield_curve=_make_curve(pkg, value_date, seed=11), value_date=value_date,
                      pay_fixed_leg=pay_fixed, float_frequency_months=frequency)
            pr = bonds.InflationLinkedSwapPricer(bonds.InflationLinkedSwap(fixed_rate=0.03, **kw))
            fair = pr.fair_fixed_rate()
            swap = pr.instrument
            at_fair = bonds.InflationLinkedSwapPricer(bonds.InflationLinkedSwap(fixed_rate=fair, **kw))
            out = {"npv": pr.npv(), "fair": fair, "npv_at_fair": at_fair.npv(), "base_cpi": swap.base_cpi}
            for name, flows in (("cpi", swap.cpi_leg_cashflows()), ("float", swap.float_leg_cashflows())):
                out.update({f"{name}_{i}": cf for i, (_, cf) in enumerate(flows)})
            return out

        got, want = run("port"), run("jax")
        _same(got, want, scale={"npv_at_fair": 1e7})
        assert abs(got["npv_at_fair"]) <= 1e-8 * 1e7
