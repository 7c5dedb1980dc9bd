"""The port's FA-validation analytics against the JAX package, on the CPU at
float64: implied vol (``models.analytic.implied_vol``), the
Bjerksund–Stensland forward pricer (``bs_forward``) and the BGK
discrete-barrier pricer with its Monte Carlo route (``bgk_pricer``).

The same numpy inputs go through both packages. Tolerances:

- implied vol on test_implied_vol.py's chain (B = 2000, seed 0): the same
  NaN lanes, and each finite sigma within 1e-12 relative or within 16 times
  the quote's rounding noise (:func:`iv_noise`), whichever is larger. The
  noise bound is eps times the magnitudes that meet in the normalized
  premium (its two Black terms, and the intrinsic an in-the-money quote
  sheds) over dc/dln(v): on the few lanes where it exceeds 1e-12 (deep in
  the money, time value a few ulps of the intrinsic), a last-bit difference
  of ``exp`` between the two packages moves sigma by up to 0.7 of it;
- prices: 1e-12 relative; the MC route's normals bit for bit;
- bump greeks: 1e-12 relative (1e-8 for gamma) plus the rounding a
  difference quotient amplifies, 64 eps |price| / h (h^2 for gamma) for the
  bump h: a last-digit difference of the closed form's ~2000 ops, divided
  by a 1e-4 relative bump (1e-6 absolute for rho).
"""
import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.analytic import bgk_pricer as jax_bgk
from finite_difference_tpu.models.analytic import bs_forward as jax_bsf
from finite_difference_tpu.models.analytic import black_scholes as jax_bs
from finite_difference_tpu.models.analytic import implied_vol as jax_iv
from finite_difference_tpu.utils.calendars import build_monitoring_dates
from finite_difference_tpu.utils.curves import flat_naca_dataframe
from finite_difference_tpu_torch.models.analytic import bgk_pricer as port_bgk
from finite_difference_tpu_torch.models.analytic import bs_forward as port_bsf
from finite_difference_tpu_torch.models.analytic import implied_vol as port_iv

EPS = np.finfo(np.float64).eps
T = lambda a: torch.as_tensor(np.array(a))
VAL = dt.date(2025, 7, 28)
MAT = dt.date(2025, 8, 28)


def _chain(seed=0, B=2000):
    """test_implied_vol.py's chain (its draws, priced by the JAX package)."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(50, 400, B)
    k = f * np.exp(rng.uniform(-3.0, 3.0, B))
    t = rng.uniform(0.02, 10.0, B)
    sigma = rng.uniform(0.02, 1.5, B)
    r = rng.uniform(0.0, 0.1, B)
    df = np.exp(-r * t)
    is_call = rng.integers(0, 2, B).astype(bool)
    price = np.asarray(df * jax_bs.generalized_bs_price(f, k, sigma, t, 0.0, 0.0, is_call))
    return price, f, k, t, df, is_call, sigma


def iv_noise(price, f, k, df, is_call, v):
    """Relative sigma error that the roundings of each quote's normalized
    premium imply (see the module docstring); ``v`` = sigma sqrt(t)."""
    from scipy.special import ndtr

    x = np.log(f / k)
    xm = -np.abs(x)
    c_in = price / df / np.sqrt(f * k)
    itm = np.where(is_call, x > 0, x < 0)
    d1 = xm / v + 0.5 * v
    terms = np.exp(0.5 * xm) * ndtr(d1) + np.exp(-0.5 * xm) * ndtr(d1 - v)
    noise = EPS * (c_in + terms + np.where(itm, np.exp(0.5 * x) + np.exp(-0.5 * x), 0.0))
    vega = np.exp(0.5 * xm) * np.exp(-0.5 * d1 * d1) / math.sqrt(2 * math.pi)
    return noise / (vega * v)


def _close_greek(got, want, price, h, order=1, rel=1e-12):
    assert abs(got - want) <= rel * abs(want) + 64 * EPS * abs(price) / h**order, (got, want)


class TestImpliedVol:
    def test_chain_matches_jax(self):
        price, f, k, t, df, is_call, _ = _chain()
        want = np.asarray(jax_iv.implied_vol_black76(price, f, k, t, df, is_call))
        got = port_iv.implied_vol_black76(*(T(a) for a in (price, f, k, t, df, is_call)))
        assert got.dtype == torch.float64
        got = got.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isfinite(want)
        assert ok.mean() > 0.9
        rel = np.abs(got[ok] - want[ok]) / want[ok]
        noise = iv_noise(price[ok], f[ok], k[ok], df[ok], is_call[ok], want[ok] * np.sqrt(t[ok]))
        assert (rel <= np.maximum(1e-12, 16.0 * noise)).all()
        assert np.median(rel) < 1e-14

    def test_round_trip_gates(self):
        """test_implied_vol.py's own gates, on the port."""
        price, f, k, t, df, is_call, sigma = _chain(seed=0, B=20000)
        iv = port_iv.implied_vol_black76(*(T(a) for a in (price, f, k, t, df, is_call))).numpy()
        ok = np.isfinite(iv)
        assert ok.mean() > 0.9
        err = np.abs(iv[ok] - sigma[ok]) / sigma[ok]
        assert np.median(err) < 1e-14 and np.quantile(err, 0.99) < 1e-6

    @pytest.mark.parametrize("args", [
        (0.95 * 101.0, 100.0, 100.0, 1.0, 0.95, True),  # above the v -> inf bound
        (0.95 * 9.0, 100.0, 90.0, 1.0, 0.95, True),  # below intrinsic
        (0.0, 100.0, 100.0, 1.0, 0.95, True),  # zero price
        (5.0, 100.0, 100.0, 0.0, 0.95, True),  # t = 0
        (100.0 - np.exp(-2.8) * 100.0, 100.0, np.exp(-2.8) * 100.0, 0.25, 1.0, True),  # time value lost
    ])
    def test_arbitrage_violations_are_nan(self, args):
        assert np.isnan(float(jax_iv.implied_vol_black76(*args)))
        price = torch.tensor(args[0], dtype=torch.float64)
        assert math.isnan(float(port_iv.implied_vol_black76(price, *args[1:])))

    def test_put_symmetry_and_spot_form(self):
        price, f, k, t, df, is_call, sigma = _chain(seed=2, B=512)
        x = np.log(f / k)
        keep = (np.abs(x) < 1.0) & (sigma * np.sqrt(t) > 0.1)
        f, k, t, df, sigma = (a[keep] for a in (f, k, t, df, sigma))
        ivs = {}
        for call in (True, False):
            p = np.asarray(df * jax_bs.generalized_bs_price(f, k, sigma, t, 0.0, 0.0, call))
            ivs[call] = port_iv.implied_vol_black76(T(p), T(f), T(k), T(t), T(df), call).numpy()
        both = np.isfinite(ivs[True]) & np.isfinite(ivs[False])
        np.testing.assert_allclose(ivs[True][both], ivs[False][both], rtol=1e-7)
        s, kk, tt, r, q, sig = 120.0, 100.0, 2.0, 0.06, 0.02, 0.33
        p = float(jax_bs.bs_price(s, kk, sig, tt, r, q, True))
        want = float(jax_iv.implied_vol_bs(p, s, kk, tt, r, q, True))
        got = float(port_iv.implied_vol_bs(torch.tensor(p, dtype=torch.float64), s, kk, tt, r, q, True))
        assert got == pytest.approx(sig, rel=1e-12) and got == pytest.approx(want, rel=1e-12)

    def test_jvp_through_the_solver(self):
        """d(sigma)/d(price) by forward AD equals 1/vega, and JAX's jvp."""
        s, kk, t, r, sig = 100.0, 110.0, 1.5, 0.05, 0.3
        p = float(jax_bs.bs_price(s, kk, sig, t, r, 0.0, True))
        f, df = s * np.exp(r * t), np.exp(-r * t)
        _, want = jax.jvp(lambda p_: jax_iv.implied_vol_black76(p_, f, kk, t, df, True),
                          (jnp.asarray(p),), (jnp.ones(()),))
        _, got = torch.func.jvp(lambda p_: port_iv.implied_vol_black76(p_, f, kk, t, df, True),
                                (torch.tensor(p, dtype=torch.float64),),
                                (torch.ones((), dtype=torch.float64),))
        vega = float(jax_bs.bs_greeks(s, kk, sig, t, r, 0.0, True)["vega"])
        assert float(got) == pytest.approx(1.0 / vega, rel=1e-6)
        assert float(got) == pytest.approx(float(want), rel=1e-12)

    @pytest.mark.parametrize("dtypes, want", [
        ((np.float64, np.float64), torch.float64),
        ((np.float32, np.float32), torch.float32),
        ((np.float32, float), torch.float64),  # a Python number is float64, as under x64
        ((np.float64, float), torch.float64),
    ])
    def test_working_dtype_follows_jax(self, dtypes, want):
        price_t, f_t = dtypes
        price = np.asarray([5.0, 12.0], dtype=price_t)
        f = 100.0 if f_t is float else np.asarray([100.0, 100.0], dtype=f_t)
        k = np.asarray([100.0, 95.0], dtype=price_t)
        jax_out = jax_iv.implied_vol_black76(price, f, k, np.asarray([1.0, 1.0], price_t), 1.0, True)
        got = port_iv.implied_vol_black76(T(price), f if f_t is float else T(f), T(k),
                                          T(np.asarray([1.0, 1.0], price_t)), 1.0, True)
        assert got.dtype == want and str(jax_out.dtype) == str(want).split(".")[1]
        tol = 1e-12 if want == torch.float64 else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=tol)


class TestBSForward:
    CURVE = flat_naca_dataframe(0.0731)
    CURVE_ARGS = [
        dict(S=176.39, K=170.0, sigma=0.2968, option_type="put", underlying_spot_days=3),
        dict(S=176.39, K=170.0, sigma=0.2968, option_type="call", underlying_spot_days=3,
             option_days=1, option_settlement_days=2,
             dividend_schedule=[(dt.date(2025, 11, 3), 2.0)]),
        dict(S=95.0, K=100.0, sigma=0.25, option_type="put",
             forward_curve=flat_naca_dataframe(0.09)),
    ]

    @pytest.mark.parametrize("case", range(len(CURVE_ARGS)))
    def test_curve_path_matches_jax(self, case):
        kw = dict(self.CURVE_ARGS[case])
        S, K, sigma, opt = (kw.pop(x) for x in ("S", "K", "sigma", "option_type"))
        mat = dt.date(2026, 7, 28)
        args = (S, K, VAL, mat, sigma, opt)
        jp, pp = jax_bsf.BjerksundStenslandForwardPricer(), port_bsf.BjerksundStenslandForwardPricer(device="cpu")
        want = jp.price_from_curves(*args, discount_curve=self.CURVE, **kw)
        got = pp.price_from_curves(*args, discount_curve=self.CURVE, **kw)
        assert set(got) == set(want)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-300), key
        wg = jp.greeks_from_curves(*args, discount_curve=self.CURVE, **kw)
        gg = pp.greeks_from_curves(*args, discount_curve=self.CURVE, **kw)
        assert gg["price"] == pytest.approx(wg["price"], rel=1e-12)
        _close_greek(gg["delta"], wg["delta"], wg["price"], 1e-4 * S)
        _close_greek(gg["vega"], wg["vega"], wg["price"], 1e-4 * sigma)
        _close_greek(gg["gamma"], wg["gamma"], wg["price"], 1e-4 * S, order=2, rel=1e-8)

    @pytest.mark.parametrize("kw", [
        dict(), dict(q=0.02), dict(F=99.5), dict(dividends=[(0.25, 1.0), (0.6, 1.5)]),
    ])
    @pytest.mark.parametrize("opt", ["call", "put"])
    def test_simple_path_matches_jax(self, kw, opt):
        args = (100.0, 95.0, 0.75, 0.065, 0.28, opt)
        jp, pp = jax_bsf.BjerksundStenslandForwardPricer(), port_bsf.BjerksundStenslandForwardPricer(device="cpu")
        want, got = jp.price(*args, **kw), pp.price(*args, **kw)
        assert got["early_exercise"] == want["early_exercise"]
        assert got["price"] == pytest.approx(want["price"], rel=1e-12)
        wg, gg = jp.greeks(*args, **kw), pp.greeks(*args, **kw)
        p = want["price"]
        _close_greek(gg["delta"], wg["delta"], p, 1e-4 * 100.0)
        _close_greek(gg["vega"], wg["vega"], p, 1e-4 * 0.28)
        _close_greek(gg["rho"], wg["rho"], p, 1e-6)
        _close_greek(gg["gamma"], wg["gamma"], p, 1e-4 * 100.0, order=2, rel=1e-8)

    def test_expired_trade_is_intrinsic(self):
        pp = port_bsf.BjerksundStenslandForwardPricer(device="cpu")
        assert pp.price(110.0, 100.0, 0.0, 0.05, 0.2, "call")["price"] == 10.0
        g = pp.greeks(110.0, 100.0, 0.0, 0.05, 0.2, "put")
        want = jax_bsf.BjerksundStenslandForwardPricer().greeks(110.0, 100.0, 0.0, 0.05, 0.2, "put")
        assert g == want


def _bgk(mod, extra=None, **kw):
    base = dict(
        spot=229.74, strike=190.0, valuation_date=VAL, maturity_date=MAT,
        option_type="call", volatility=0.28790,
        discount_curve=flat_naca_dataframe(0.073085649282),
        monitor_dates=build_monitoring_dates(VAL, MAT, "daily"),
    )
    base.update(kw)
    return mod.DiscreteBarrierBGKPricer(**base, **(extra or {}))


BGK_CASES = {
    "vanilla": dict(barrier_type="none"),
    "uo": dict(barrier_type="up-and-out", upper_barrier=260.0),
    "ui": dict(barrier_type="up-and-in", upper_barrier=260.0),
    "do_put_mean_sqrt": dict(barrier_type="down-and-out", lower_barrier=200.0, option_type="put",
                             strike=240.0, use_mean_sqrt_dt=True),
    "double_out_rebate": dict(barrier_type="double-out", lower_barrier=200.0, upper_barrier=260.0,
                              rebate_amount=2.0),
    "double_in": dict(barrier_type="double-in", lower_barrier=200.0, upper_barrier=260.0),
    "rebate_at_hit": dict(barrier_type="up-and-out", upper_barrier=250.0, rebate_amount=5.0,
                          rebate_at_hit=True),
    "lags_dividends_short": dict(barrier_type="up-and-out", upper_barrier=260.0,
                                 underlying_spot_days=3, option_days=1, option_settlement_days=2,
                                 dividend_schedule=[(dt.date(2025, 8, 12), 3.0)], direction="short",
                                 quantity=3, theta_from_forward=True),
    "already_hit_at_hit": dict(barrier_type="up-and-out", upper_barrier=260.0, already_hit=True,
                               rebate_amount=3.0, rebate_at_hit=True,
                               barrier_hit_date=dt.date(2025, 8, 1)),
    "already_hit_in": dict(barrier_type="up-and-in", upper_barrier=260.0, already_hit=True),
    "mc_sparse": dict(barrier_type="up-and-out", upper_barrier=260.0,
                      monitor_dates=[dt.date(2025, 8, 14), dt.date(2025, 8, 28)]),
    "mc_rebate_expiry": dict(barrier_type="down-and-out", lower_barrier=215.0, pricing_method="mc",
                             rebate_amount=1.5, monitor_dates=[dt.date(2025, 8, 7), dt.date(2025, 8, 21)]),
    "mc_hard_numpy_at_hit": dict(barrier_type="double-out", lower_barrier=200.0, upper_barrier=270.0,
                                 pricing_method="mc", mc_smooth_barrier_eps=0.0,
                                 mc_smooth_payoff_eps=0.0, mc_use_torch_rng=False,
                                 rebate_amount=2.0, rebate_at_hit=True),
    "mc_double_in": dict(barrier_type="double-in", lower_barrier=200.0, upper_barrier=260.0,
                         pricing_method="mc", mc_use_antithetic=False),
}


class TestBGK:
    @pytest.mark.parametrize("name", list(BGK_CASES))
    def test_price_and_greeks_match_jax(self, name):
        kw = dict(BGK_CASES[name], mc_n_paths=4096)
        j, p = _bgk(jax_bgk, **kw), _bgk(port_bgk, dict(device="cpu"), **kw)
        assert p._select_method() == j._select_method()
        want, got = j.price(), p.price()
        assert got == pytest.approx(want, rel=1e-12, abs=1e-300)
        assert p._last_mc_std_error == pytest.approx(j._last_mc_std_error, rel=1e-10)
        wg, gg = j.greeks(), p.greeks()
        ds = 1e-4 * j.spot_price
        _close_greek(gg["delta"], wg["delta"], want, ds)
        _close_greek(gg["vega"], wg["vega"], want, 1e-4)
        _close_greek(gg["gamma"], wg["gamma"], want, ds, order=2, rel=1e-8)

    def test_mc_normals_are_jax_normals(self):
        """The MC route draws its normals on the host from torch's CPU stream
        seeded with mc_seed (or numpy's default_rng), as the JAX package does."""
        p = _bgk(port_bgk, dict(device="cpu"), barrier_type="up-and-out", upper_barrier=260.0,
                 pricing_method="mc", mc_seed=7)
        torch.manual_seed(7)
        want = torch.randn(2048, 23, dtype=torch.float64)
        torch.manual_seed(1234)  # the port does not read the global generator
        assert torch.equal(p._mc_normals(2048, 23), want)
        p.mc_use_torch_rng = False
        np.testing.assert_array_equal(p._mc_normals(16, 3).numpy(),
                                      np.random.default_rng(7).standard_normal((16, 3)))

    def test_barrier_hit_metrics_match_jax(self):
        kw = dict(barrier_type="up-and-out", upper_barrier=250.0, rebate_amount=5.0, rebate_at_hit=True)
        want = _bgk(jax_bgk, **kw).barrier_hit_metrics()
        got = _bgk(port_bgk, dict(device="cpu"), **kw).barrier_hit_metrics()
        for key in ("P_hit", "survival_to_T", "rebate_pv_at_hit"):
            assert got[key] == pytest.approx(want[key], rel=1e-12)
        assert got["expected_hit_date"] == want["expected_hit_date"]
        assert got["mode_hit_date"] == want["mode_hit_date"]
        assert [h[0] for h in got["hazard"]] == [h[0] for h in want["hazard"]]
        np.testing.assert_allclose([h[1:] for h in got["hazard"]], [h[1:] for h in want["hazard"]],
                                   rtol=1e-12, atol=1e-14)
        assert got["P_hit"] + got["survival_to_T"] == pytest.approx(1.0, abs=1e-9)

    def test_in_out_parity_and_smooth_functions(self):
        ko = _bgk(port_bgk, dict(device="cpu"), barrier_type="up-and-out", upper_barrier=260.0).price()
        ki = _bgk(port_bgk, dict(device="cpu"), barrier_type="up-and-in", upper_barrier=260.0).price()
        van = _bgk(port_bgk, dict(device="cpu"), barrier_type="none").price()
        assert ko + ki == pytest.approx(van, rel=1e-10)
        x = np.linspace(-0.02, 0.02, 41) + 100.0
        for name, args in (("smooth_relu", (x - 100.0, 0.005)), ("smooth_heaviside_up", (x, 100.0, 0.01)),
                           ("smooth_heaviside_down", (x, 100.0, 0.01))):
            np.testing.assert_array_equal(getattr(port_bgk, name)(*args).numpy(),
                                          getattr(jax_bgk, name)(*args))

    def test_validation_and_report(self):
        with pytest.raises(ValueError, match="positive"):
            _bgk(port_bgk, dict(device="cpu"), spot=-1.0)
        with pytest.raises(ValueError, match="maturity_date"):
            _bgk(port_bgk, dict(device="cpu"), maturity_date=VAL)
        text = _bgk(port_bgk, dict(device="cpu"), barrier_type="up-and-out", upper_barrier=260.0).report()
        assert "BGK" in text and "Price" in text


def test_pricers_default_to_the_card(monkeypatch):
    """Without a card the default device raises; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bsf.BjerksundStenslandForwardPricer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _bgk(port_bgk)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_iv.implied_vol_black76(5.0, 100.0, 100.0, 1.0)
