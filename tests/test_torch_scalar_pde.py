"""Port scalar PDE pricers (finite_difference_tpu_torch.models.pde: american,
american_black76, barrier, vanilla_fis, cn_log, hybrid, risk) against the
JAX package's on the same trades, at float64 on the CPU.

Each case prices one trade through both packages at a pinned small grid
(about 100 nodes, 40-120 steps) and holds every output (price and greeks)
within 1e-10 of the largest magnitude among the outputs compared; the
cases mirror test_pde_pricers.py and test_pde_extensions.py
(TestAmericanBlack76, TestCnLogPricer, TestHybridPricer,
TestRiskFunctions). Knock-out plus knock-in equals the vanilla through the
port alone. Two of test_xlsx_golden.py's model-block rows (co1, pi3) run
through the port at full width (500 steps, the chooser's 2134 nodes) and
meet that test's own limits.
"""
import datetime as dt

import numpy as np
import pytest

from finite_difference_tpu.models import pde as jax_pde
from finite_difference_tpu.utils.curves import flat_curve as jax_flat_curve
from finite_difference_tpu.utils.curves import flat_naca_dataframe as jax_flat_df
from finite_difference_tpu_torch.models import pde as port_pde
from finite_difference_tpu_torch.models.analytic import generalized_bs_price
from finite_difference_tpu_torch.utils.curves import flat_curve as port_flat_curve
from finite_difference_tpu_torch.utils.curves import flat_naca_dataframe as port_flat_df

VAL = dt.date(2025, 7, 28)
MAT_1M = dt.date(2025, 8, 28)
MAT_6M = dt.date(2026, 1, 28)
TOL = 1e-10


def _close(got, want, tol=TOL):
    """Dicts (or single numbers) equal within ``tol`` of their largest |value|."""
    if not isinstance(want, dict):
        got, want = {"value": got}, {"value": want}
    assert set(got) == set(want)
    scale = max(abs(float(v)) for v in want.values())
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= tol * scale, (k, got[k], want[k])


def _both(jax_cls, port_cls, curve_kw="discount_curve", rate=0.06, flat=True, **kw):
    """The same trade in both packages, each with its own flat curve."""
    jc = jax_flat_curve(rate, VAL) if flat else jax_flat_df(rate)
    pc = port_flat_curve(rate, VAL) if flat else port_flat_df(rate)
    return jax_cls(**{curve_kw: jc}, **kw), port_cls(**{curve_kw: pc}, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# American (equity and Black-76 forward)                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("opt,strike,divs", [
    ("put", 110.0, None),
    ("call", 95.0, None),
    ("put", 100.0, [(dt.date(2025, 10, 15), 5.0)]),
    ("call", 100.0, [(dt.date(2025, 9, 15), 2.0), (dt.date(2025, 12, 1), 2.0)]),
])
def test_american_pricer_matches_jax(opt, strike, divs):
    j, p = _both(jax_pde.AmericanFDMPricer, port_pde.AmericanFDMPricer,
                 spot=100.0, strike=strike, valuation_date=VAL, maturity_date=MAT_6M,
                 sigma=0.3, option_type=opt, dividend_schedule=divs,
                 num_space_nodes=100, num_time_steps=60, underlying_spot_days=2)
    assert p.spot_snapped == j.spot_snapped and p.strike_snapped == j.strike_snapped
    _close(p.price_log2(), j.price_log2())
    _close(p.greeks_log2(), j.greeks_log2())
    if divs is None and opt == "put":
        _close(p.price_log(), j.price_log())
        _close(p.greeks_log2(use_richardson=False), j.greeks_log2(use_richardson=False))


@pytest.mark.parametrize("opt,strike", [("call", 100.0), ("put", 110.0)])
def test_american_black76_matches_jax(opt, strike):
    j, p = _both(jax_pde.AmericanFwdFDMPricer, port_pde.AmericanFwdFDMPricer,
                 forward=100.0, strike=strike, valuation_date=VAL, maturity_date=MAT_6M,
                 sigma=0.25, option_type=opt, num_space_nodes=100, num_time_steps=60)
    assert p.carry_rate_nacc == 0.0 and p.forward == 100.0
    _close(p.price_log2(), j.price_log2())
    _close(p.greeks_log2(), j.greeks_log2())


# --------------------------------------------------------------------------- #
# FA-exact vanilla (the FIS harness)                                           #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("opt,exercise,settle,spot,divs", [
    ("put", "american", "cash", 100.0, None),
    ("put", "european", "cash", 100.0, None),
    ("call", "american", "cash", 110.0, [(dt.date(2025, 10, 15), 2.0)]),  # the jump path
    ("put", "american", "physical", 100.0, [(dt.date(2025, 10, 15), 2.0)]),
])
def test_vanilla_fis_matches_jax(opt, exercise, settle, spot, divs):
    kw = dict(spot_price=spot, strike_price=105.0, volatility=0.28, valuation_date=VAL,
              maturity_date=MAT_6M, option_type=opt, exercise_type=exercise,
              settlement_type=settle, dividend_schedule=divs, underlying_spot_days=3,
              contracts=3, side="sell")
    j = jax_pde.VanillaOptionPricerFIS(discount_curve=jax_flat_df(np.exp(0.0705) - 1.0), **kw)
    p = port_pde.VanillaOptionPricerFIS(discount_curve=port_flat_df(np.exp(0.0705) - 1.0),
                                        device="cpu", **kw)
    _close(p.price(40), j.price(40))
    if exercise == "european":
        _close(p.batch_price([30, 50]), j.batch_price([30, 50]))
    got, want = p.calculate_greeks(30), j.calculate_greeks(30)
    first = ("Price", "Delta", "Vega")
    _close({k: got[k] for k in first}, {k: want[k] for k in first})
    # Gamma and theta are second differences over ds = 1e-3 S: a price's
    # rounding (2e-14 of it between the packages here) times 4/ds^2, and
    # theta times 0.5 sigma^2 S^2 more; measured 1.3e-8 on theta (2e-9 of
    # max|value|)
    second = ("Gamma", "Theta (Annual)", "Theta (Daily)")
    _close({k: got[k] for k in second}, {k: want[k] for k in second}, 1e-7)


# --------------------------------------------------------------------------- #
# Discrete barrier (production pricer)                                         #
# --------------------------------------------------------------------------- #
MONS = [VAL + dt.timedelta(days=7 * k) for k in range(1, 5)]


def _barrier_pair(**kw):
    base = dict(spot=229.74, strike=190.0, valuation_date=VAL, maturity_date=MAT_1M,
                sigma=0.2879, option_type="call", monitor_dates=MONS, num_time_steps=60,
                fixed_num_space_nodes=100)
    base.update(kw)
    return _both(jax_pde.DiscreteBarrierFDMPricer, port_pde.DiscreteBarrierFDMPricer,
                 rate=0.073086, flat=False, **base)


@pytest.mark.parametrize("kw", [
    dict(barrier_type="up-and-out", upper_barrier=260.0),
    dict(barrier_type="up-and-in", upper_barrier=260.0, rebate_amount=3.0),
    dict(barrier_type="down-and-out", lower_barrier=210.0, rebate_amount=2.0, rebate_at_hit=True),
    dict(barrier_type="down-and-in", lower_barrier=210.0, option_type="put", strike=240.0),
    dict(barrier_type="double-out", lower_barrier=200.0, upper_barrier=255.0,
         use_one_sided_greeks_near_barrier=True),
    dict(barrier_type="up-and-out", upper_barrier=235.0, use_one_sided_greeks_near_barrier=True,
         dividend_schedule=[(dt.date(2025, 8, 12), 3.0)]),
    dict(barrier_type="none"),
], ids=["uo", "ui_rebate", "do_rebate_hit", "di_put", "dko_one_sided", "uo_near_divs", "none"])
def test_barrier_pricer_matches_jax(kw):
    j, p = _barrier_pair(**kw)
    assert (p.grid.x_min, p.grid.dx, p.grid.n_nodes) == (j.grid.x_min, j.grid.dx, j.grid.n_nodes)
    assert p.monitor_times == j.monitor_times
    _close(p.price_log2(), j.price_log2())
    _close(p.greeks_log2(), j.greeks_log2())
    _close(p.price_log2(use_richardson=True), j.price_log2(use_richardson=True))
    _close(p.greeks_log2(use_richardson=True), j.greeks_log2(use_richardson=True))
    _close(p.price_log(apply_KO=False), j.price_log(apply_KO=False))


def test_barrier_states_and_diagnostics_match_jax(capsys):
    for kw in (dict(barrier_type="up-and-out", upper_barrier=260.0, already_hit=True, rebate_amount=4.0),
               dict(barrier_type="up-and-in", upper_barrier=260.0, already_in=True)):
        j, p = _barrier_pair(**kw)
        _close(p.price_log2(), j.price_log2())
        _close(p.greeks_log2(), j.greeks_log2())
    j, p = _barrier_pair(barrier_type="up-and-out", upper_barrier=260.0)
    want, got = j.validate_convergence([60, 80], [40]), p.validate_convergence([60, 80], [40])
    assert [(r["N"], r["M"]) for r in got] == [(r["N"], r["M"]) for r in want]
    for g, w in zip(got, want):
        _close({k: g[k] for k in w if k not in ("N", "M")}, {k: w[k] for k in w if k not in ("N", "M")})
    p.print_details()
    assert f"{p.price_log2():.9f}" in capsys.readouterr().out


@pytest.mark.parametrize("ko_type,ki_type,opt,lo,up", [
    ("up-and-out", "up-and-in", "call", None, 260.0),
    ("down-and-out", "down-and-in", "put", 205.0, None),
    ("double-out", "double-in", "call", 205.0, 255.0),
])
def test_barrier_in_out_parity(ko_type, ki_type, opt, lo, up):
    """KO(R at expiry) + KI(R) = vanilla + R·DF through the port alone, the
    vanilla leg equal to the generalized Black–Scholes price (no lags)."""
    import torch

    curve = port_flat_curve(0.0731, VAL)
    kw = dict(spot=229.74, strike=230.0, valuation_date=VAL, maturity_date=MAT_1M, sigma=0.25,
              option_type=opt, lower_barrier=lo, upper_barrier=up, monitor_dates=MONS,
              discount_curve=curve, underlying_spot_days=0, num_time_steps=60,
              fixed_num_space_nodes=100, rebate_amount=1.5, device="cpu")
    ko = port_pde.DiscreteBarrierFDMPricer(barrier_type=ko_type, **kw)
    ki = port_pde.DiscreteBarrierFDMPricer(barrier_type=ki_type, **kw)
    vanilla = ko._vanilla_black76_price()
    assert ko.price_log2() + ki.price_log2() == pytest.approx(vanilla + ki._ki_rebate_leg(), rel=1e-12)
    g_ko, g_ki, g_van = ko.greeks_log2(), ki.greeks_log2(), ko._vanilla_black76_greeks_fd()
    for k in ("delta", "gamma", "vega"):
        assert g_ko[k] + g_ki[k] == pytest.approx(g_van[k], rel=1e-9, abs=1e-12), k
    bs = generalized_bs_price(torch.tensor(229.74, dtype=torch.float64), 230.0, 0.25,
                              ko.time_to_expiry, ko.discount_rate_nacc, ko.carry_rate_nacc,
                              opt == "call")
    assert vanilla == pytest.approx(float(bs), rel=1e-12)


# --------------------------------------------------------------------------- #
# Year-fraction CN pricer and the hybrid analytic / CN pricer                  #
# --------------------------------------------------------------------------- #
def _cn_log_pair(**kw):
    base = dict(S0=100.0, K=100.0, T=0.5, sigma=0.25, r_disc=0.06, b_carry=0.04,
                option_type="call", barrier_type="none", N_space=100, N_time=80)
    base.update(kw)
    return jax_pde.DiscreteBarrierCrankNicolsonLog(**base), \
        port_pde.DiscreteBarrierCrankNicolsonLog(device="cpu", **base)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(barrier_type="up-and-out", upper_barrier=130.0, monitor_times=[0.1, 0.2, 0.3, 0.4, 0.5]),
    dict(barrier_type="up-and-in", upper_barrier=130.0, monitor_times=[0.1, 0.2, 0.3, 0.4, 0.5]),
    dict(barrier_type="double-out", option_type="put", lower_barrier=80.0, upper_barrier=125.0,
         monitor_times=[0.25, 0.5], rebate=1.0),
])
def test_cn_log_matches_jax(kw):
    j, p = _cn_log_pair(**kw)
    _close(p.price(), j.price())
    _close(p.greeks(), j.greeks())
    _close(p._vanilla_bs_price_and_greeks(), j._vanilla_bs_price_and_greeks(), 1e-12)


def test_cn_log_auto_grid_matches_jax():
    j, p = _cn_log_pair(N_space=None, N_time=None, monitor_times=[0.1, 0.2, 0.3, 0.4])
    j.configure_grid()
    p.configure_grid()
    assert (p.N_space, p.N_time, p._S_min, p._S_max) == (j.N_space, j.N_time, j._S_min, j._S_max)


def _hybrid_pair(**kw):
    n_days = (MAT_1M - VAL).days
    base = dict(option_type="call", barrier_type="up-and-out", strike=190.0, upper_barrier=260.0,
                spot=229.74, volatility=0.2879, valuation_date=VAL, maturity_date=MAT_1M,
                monitoring_dates=[VAL + dt.timedelta(days=k) for k in range(1, n_days + 1)],
                time_steps=60, space_nodes=100)
    base.update(kw)
    return _both(jax_pde.DiscreteBarrierFDMPricerAnalytic, port_pde.DiscreteBarrierFDMPricerAnalytic,
                 rate=0.0731, **base)


@pytest.mark.parametrize("kw", [
    dict(monitoring_dates=MONS),  # discrete branch
    dict(monitoring_dates=MONS, barrier_type="up-and-in", rebate_amount=5.0),
    dict(n_desired_for_decision=2, n_lim_multiplier=1),  # continuous: Reiner-Rubinstein
    dict(n_desired_for_decision=2, n_lim_multiplier=1, barrier_type="up-and-in"),
    dict(n_desired_for_decision=2, n_lim_multiplier=1, barrier_type="double-out",
         lower_barrier=200.0),  # continuous: the double-barrier series
    dict(n_desired_for_decision=2, n_lim_multiplier=1, barrier_type="double-in",
         lower_barrier=200.0, quantity=10, direction="short"),
    dict(n_desired_for_decision=2, n_lim_multiplier=1, barrier_status="crossed"),  # CN window
], ids=["discrete", "discrete_ki_rebate", "rr", "rr_in", "double", "double_in_short", "cn_window"])
def test_hybrid_matches_jax(kw):
    j, p = _hybrid_pair(**kw)
    assert p.use_continuous_window == j.use_continuous_window
    assert (p.bgk_lower_barrier, p.bgk_upper_barrier) == (j.bgk_lower_barrier, j.bgk_upper_barrier)
    _close(p.price(), j.price())
    _close(p.greeks(), j.greeks())


# --------------------------------------------------------------------------- #
# FIS risk functions                                                           #
# --------------------------------------------------------------------------- #
def test_risk_functions_match_jax():
    j, p = _barrier_pair(barrier_type="up-and-out", upper_barrier=260.0)
    for m, force in ((1.005, False), (1.005, True), (1.10, False)):
        want = jax_pde.risk_reprice_spot(j, j.spot * m, force_full_revaluation=force)
        got = port_pde.risk_reprice_spot(p, p.spot * m, force_full_revaluation=force)
        assert got["used_taylor_approx"] == want["used_taylor_approx"]
        _close(got["result"], want["result"])
    for m in (1.002, 1.2):
        _close(port_pde.risk_spot_scenario(p, p.spot * m), jax_pde.risk_spot_scenario(j, j.spot * m))
    grid = [p.spot * m for m in (0.99, 1.0, 1.01, 1.2)]
    want = jax_pde.front_arena_style_spot_curve(j, grid)
    got = port_pde.front_arena_style_spot_curve(p, grid)
    assert got["used_taylor"] == want["used_taylor"] == [True, True, True, False]
    for k in ("price", "delta", "gamma"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL * np.abs(want[k]).max())


# --------------------------------------------------------------------------- #
# xlsx golden rows at full width                                               #
# --------------------------------------------------------------------------- #
GOLDEN_MONITORS = [VAL + dt.timedelta(days=d) for d in range(32)
                   if (VAL + dt.timedelta(days=d)).weekday() < 5]
# (name, opt, btype, K, sigma, lower, upper, model_price, model_delta,
#  model_gamma, model_vega): tests/test_xlsx_golden.py's rows co1 and pi3
GOLDEN = [
    ("co1", "call", "up-and-out", 190.0, 0.287899981643, None, 260.0,
     32.464174906875897, 0.122330501269814, -0.065045360125054602, -0.80200735270210499),
    ("pi3", "put", "up-and-in", 260.0, 0.234882165755, None, 240.0,
     8.1943135233874003, 0.66870484702124999, 0.030729494870976402, 0.255926580705434),
]


@pytest.mark.parametrize("name,opt,btype,K,sigma,lower,upper,p,d,g,v", GOLDEN,
                         ids=[row[0] for row in GOLDEN])
def test_xlsx_golden_rows_full_width(name, opt, btype, K, sigma, lower, upper, p, d, g, v):
    assert len(GOLDEN_MONITORS) == 24  # the golden schedule: 24 ZA business days
    curve = port_flat_curve(0.073085649282, VAL)
    pricer = port_pde.DiscreteBarrierFDMPricer(
        spot=229.74, strike=K, valuation_date=VAL, maturity_date=MAT_1M,
        sigma=sigma, option_type=opt, barrier_type=btype,
        lower_barrier=lower, upper_barrier=upper, monitor_dates=GOLDEN_MONITORS,
        discount_curve=curve, forward_curve=curve,
        underlying_spot_days=0, option_days=0, option_settlement_days=0,
        num_space_nodes=500, num_time_steps=500, device="cpu",
    )
    assert pricer.grid.n_nodes == 2134
    price, greeks = pricer.price_log2(), pricer.greeks_log2()
    # test_xlsx_golden.py's limits for |price| > 1e-3
    assert price == pytest.approx(p, rel=5e-6), "price"
    assert greeks["delta"] == pytest.approx(d, rel=5e-6, abs=1e-7), "delta"
    assert greeks["gamma"] == pytest.approx(g, rel=5e-4, abs=1e-7), "gamma"
    assert greeks["vega"] == pytest.approx(v, rel=2e-4, abs=1e-7), "vega"
