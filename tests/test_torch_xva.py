"""The port's XVA exposure path (``finite_difference_tpu_torch``: the yield
curve, schedules, IRSwap, the PDE-surface exotics, CSA, the generic and
device exposure engines, EE/PFE/CVA and ``hw1f_cva_pipeline``) against the
JAX package, on the CPU at float64, on the same numpy inputs.

Tolerances, with the largest gap measured on these inputs in brackets:

- ``_hermite_rt_weights``, ``_tangent_matrix``, the interpolators, the
  ``YieldCurve`` queries and the schedules: equal (the same numpy code)
  [0];
- ``leg_pv`` and the generic ``ExposureEngine`` on swaps (MTM, collateral,
  exposure): 1e-12 relative to the largest |value| [0: the same numpy
  code on the same cube];
- the generic engine on the surface exotics: 1e-12 of max|MTM| [6.0e-14,
  the knock-in]. Their surfaces come from the batched CN solves of either
  package;
- ``_leg_mtm``'s equity-notional branch on JAX's own TRS leg tensors:
  1e-12 of max|MTM| [2.3e-15] (the TRS family as a whole is held in
  tests/test_torch_xva_families.py);
- a float32 cube against float64 in the port: 1e-4 of max|MTM| [1.5e-5];
- the device engine against JAX's device engine: 1e-12 of max|value|
  [4.6e-14] (the contractions sum in another order), and against the
  port's generic engine at JAX's own gates (rtol 1e-10 with JAX's atol;
  [8.6e-14 of max|MTM|]);
- ``hw1f_cva_pipeline`` at 128 paths and the same seed: MTM within 1e-10
  of max|MTM|, CVA within 1e-10 relative [1.2e-14, 2.3e-15]: the HW1F
  normals differ from JAX's by erfinv's last bits (tests/test_torch_mc.py);
- ``exposure_profile``: EE and PFE within 1e-13 relative of JAX's
  [5.5e-16]. One input of 3 x 5.6M > 2^24 elements (which
  ``torch.quantile`` refuses) is held against numpy's ``linear`` quantile,
  the definition ``jnp.quantile`` uses [1.1e-15]: JAX's own sort of it
  took 8.6 s on the CPU where these tests were written, numpy's well
  under one.
"""
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finite_difference_tpu.instruments as jax_inst
import finite_difference_tpu.market_data.scenario_cube as jax_sc
import finite_difference_tpu.market_data.yield_curve as jax_yc
import finite_difference_tpu.models.mc.hw1f as jax_hw
import finite_difference_tpu.portfolio as jax_pf
import finite_difference_tpu.xva.config as jax_cfg
import finite_difference_tpu.xva.cva as jax_cva
import finite_difference_tpu.xva.device_exposure as jax_dx
import finite_difference_tpu.xva.exposure_engine as jax_ee
import finite_difference_tpu_torch.instruments as port_inst
import finite_difference_tpu_torch.market_data.scenario_cube as port_sc
import finite_difference_tpu_torch.market_data.yield_curve as port_yc
import finite_difference_tpu_torch.models.mc.hw1f as port_hw
import finite_difference_tpu_torch.portfolio as port_pf
import finite_difference_tpu_torch.xva.config as port_cfg
import finite_difference_tpu_torch.xva.cva as port_cva
import finite_difference_tpu_torch.xva.device_exposure as port_dx
import finite_difference_tpu_torch.xva.exposure_engine as port_ee
from finite_difference_tpu.market_data.risk_factor import CurveSlice as JaxCurveSlice
from finite_difference_tpu_torch.market_data.risk_factor import CurveSlice as PortCurveSlice
from finite_difference_tpu_torch.ops.interp import linear_interp

VAL = dt.date(2025, 7, 28)
TENORS = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])

JAX = dict(inst=jax_inst, sc=jax_sc, pf=jax_pf, ee=jax_ee, dx=jax_dx, kw={})
PORT = dict(inst=port_inst, sc=port_sc, pf=port_pf, ee=port_ee, dx=port_dx, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CN surface solves step in Python; under the suite's xdist workers
    # torch's thread per core made such loops far slower (tests/test_torch_mc.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# --------------------------------------------------------------------------
# market data and schedules
# --------------------------------------------------------------------------


class TestYieldCurve:
    def test_weights_equal(self):
        tq = np.array([0.0, 0.1, 0.25, 0.7, 1.3, 4.0, 9.9, 10.0, 12.0])
        for x in (TENORS, TENORS[:2], np.array([0.5, 1.0, 2.0])):
            np.testing.assert_array_equal(port_yc._tangent_matrix(x), jax_yc._tangent_matrix(x))
            np.testing.assert_array_equal(port_yc._hermite_rt_weights(x, tq),
                                          jax_yc._hermite_rt_weights(x, tq))
            for hermite in (False, True):
                np.testing.assert_array_equal(port_yc._interp_weight_matrix(x, tq, hermite),
                                              jax_yc._interp_weight_matrix(x, tq, hermite))

    def test_curve_queries_equal(self):
        rates = 0.07 + np.random.default_rng(3).normal(0, 0.004, (5, TENORS.size))
        tq = np.array([0.0, 0.3, 1.7, 6.0, 11.0])
        for interp in ("hermite_rt_interp", "linear_interp"):
            np.testing.assert_array_equal(getattr(port_yc, interp)(TENORS, rates, tq),
                                          getattr(jax_yc, interp)(TENORS, rates, tq))
        p = port_yc.YieldCurve(TENORS, rates)
        j = jax_yc.YieldCurve(TENORS, rates)
        np.testing.assert_array_equal(p.zero_rate(tq), j.zero_rate(tq))
        np.testing.assert_array_equal(p.discount_factor(tq), j.discount_factor(tq))
        np.testing.assert_array_equal(p.forward_rate(0.5, 1.5), j.forward_rate(0.5, 1.5))
        np.testing.assert_array_equal(p.forward_rate(0.5, 1.5, tau=0.9), j.forward_rate(0.5, 1.5, tau=0.9))
        np.testing.assert_array_equal(p.forward_nacc_rate(0.2, 3.0), j.forward_nacc_rate(0.2, 3.0))


def test_schedules_equal():
    for cfg in ({}, {"date_generation": "Forward", "payment_lag_days": 2, "calendar": "WEEKENDSONLY"},
                {"business_convention": "Following", "day_count": "ACT/360"}):
        p = port_inst.ScheduleConfig(**cfg).build(VAL, dt.date(2028, 1, 31), 3)
        j = jax_inst.ScheduleConfig(**cfg).build(VAL, dt.date(2028, 1, 31), 3)
        assert p == j
    cal_p, cal_j = port_inst.get_calendar("ZAR"), jax_inst.get_calendar("ZAR")
    for conv in ("Following", "ModifiedFollowing", "Preceding", "ModifiedPreceding", "Unadjusted"):
        for day in (dt.date(2025, 8, 9), dt.date(2025, 11, 30), dt.date(2025, 12, 25)):
            assert port_inst.adjust(day, cal_p, conv) == jax_inst.adjust(day, cal_j, conv)
    assert port_inst.add_months(dt.date(2024, 1, 31), 1) == jax_inst.add_months(dt.date(2024, 1, 31), 1)
    assert (port_inst.generate_sub_periods(VAL, dt.date(2026, 1, 28), 1, cal_p, "ModifiedFollowing", "ACT/365")
            == jax_inst.generate_sub_periods(VAL, dt.date(2026, 1, 28), 1, cal_j, "ModifiedFollowing", "ACT/365"))
    np.testing.assert_array_equal(
        port_inst.build_overnight_tenors(VAL, dt.date(2025, 9, 1), VAL, cal_p),
        jax_inst.build_overnight_tenors(VAL, dt.date(2025, 9, 1), VAL, cal_j))


# --------------------------------------------------------------------------
# swaps: the same trade in either package
# --------------------------------------------------------------------------


def _swap(pkg, kind="plain", n_years=2, fixed_rate=0.08, curve="ZAR-SWAP"):
    inst = pkg["inst"]
    eff, freq, seeds = VAL, 3, None
    leg = dict(frequency=3, curve_name=curve)
    if kind == "tenor_spread":
        leg.update(fixing_tenor_months=3, spread=0.015)
    elif kind in ("ois", "ois_seeded"):
        freq, n_years, fixed_rate = 6, 1, 0.075
        leg.update(frequency=6, overnight_compounding=True)
        if kind == "ois_seeded":
            # effective date between scenario rows; the first period is
            # already accruing, with an old_resets-style seed factor
            eff = VAL - dt.timedelta(days=45)
    elif kind == "compounded":
        freq, fixed_rate = 6, 0.075
        leg.update(frequency=6, reset_frequency_months=3)
    mat = dt.date(eff.year + n_years, eff.month, eff.day)
    if kind == "ois_seeded":
        sched = inst.ScheduleConfig().build(eff, mat, freq)
        seeds = {(curve, ps): 1.004 for ps, _, _, _ in sched}
    return inst.IRSwap(
        name=f"irs-{kind}", effective_date=eff, maturity_date=mat, notional=1_000_000,
        receive_leg=inst.SwapLeg(inst.LegType.FLOATING, **leg),
        pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=freq, fixed_rate=fixed_rate),
        discount_curve_name=curve, ois_initial_cfs=seeds,
    )


SWAP_KINDS = ("plain", "tenor_spread", "ois", "ois_seeded", "compounded")


def test_leg_pv_equal():
    rng = np.random.default_rng(1)
    rates = 0.07 + rng.normal(0, 0.003, (6, TENORS.size))
    for kind in SWAP_KINDS:
        sw_p, sw_j = _swap(PORT, kind), _swap(JAX, kind)
        fix = {("ZAR-SWAP", sw_p.receive_schedule[0][0]): np.full(6, 0.071)}
        for val in (VAL, VAL + dt.timedelta(days=100)):
            out = []
            for pkg, sw, cs in ((PORT, sw_p, PortCurveSlice), (JAX, sw_j, JaxCurveSlice)):
                state = {"ZAR-SWAP": cs(rates, TENORS)}
                out.append((
                    pkg["inst"].leg_pv(sw.receive_schedule, sw.receive_leg, notional=sw.notional,
                                       val_date=val, market_state=state,
                                       discount_curve=(port_yc if pkg is PORT else jax_yc).YieldCurve(TENORS, rates),
                                       n_paths=6, schedule_config=sw.schedule_config, fixings=fix),
                    sw.scenario_npvs(val, state, fixings=fix),
                ))
            for a, b in zip(*out):
                assert _rel(a, b) <= 1e-12, kind


# --------------------------------------------------------------------------
# the four engines on one netting set
# --------------------------------------------------------------------------


def _cube_arrays(n_times=26, n_paths=64, seed=0):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    t = np.arange(n_times)[:, None, None]
    swap = 0.075 + 0.0005 * t + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    return dates, {"ZAR-SWAP": swap}


def _engines(pkg, dates, curves, scalars, make_trades, csa=None, scales=None, fx=None,
             currencies=None, reporting="ZAR"):
    """(generic profile, device profile) of one package on one netting set."""
    trades = make_trades(pkg)
    n = len(trades)
    factors = {k: ("curve", v, TENORS) for k, v in curves.items()}
    factors.update({k: ("scalar", v) for k, v in scalars.items()})
    ns = pkg["pf"].NettingSet(
        "NS",
        [pkg["pf"].Trade(t, f"T{i}", currency=(currencies or [reporting] * n)[i],
                         fx_rate_factor=(fx or [None] * n)[i],
                         notional_scale=(scales or [1.0] * n)[i])
         for i, t in enumerate(trades)],
        reporting_currency=reporting, csa=csa(pkg) if csa else None,
    )
    generic = pkg["ee"].ExposureEngine(pkg["sc"].ScenarioCube(dates, factors)).compute(ns)
    dev = pkg["dx"].DeviceExposureEngine(dates, curves, TENORS, scalars=scalars, **pkg["kw"]).compute(
        trades, notional_scales=scales, fx_factors=fx, csa=ns.csa, currencies=currencies,
    )
    return generic, dev


def _hold(port_g, port_d, jax_g, jax_d, rtol=1e-10, atol=1e-6, fields=("mtm",)):
    for f in fields:
        pg, pd, jg, jd = (getattr(p, f) for p in (port_g, port_d, jax_g, jax_d))
        assert _rel(pg, jg) <= 1e-12, f"generic {f}: {_rel(pg, jg):.3e}"
        assert _rel(pd, jd) <= 1e-12, f"device {f}: {_rel(pd, jd):.3e}"
        np.testing.assert_allclose(pd, pg, rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("kind", SWAP_KINDS)
def test_swap_engines_match_jax(kind):
    n_times, n_paths = (16, 16) if kind.startswith("ois") else (26, 64)
    dates, curves = _cube_arrays(n_times, n_paths)
    res = [_engines(pkg, dates, curves, {}, lambda p: [_swap(p, kind)]) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1], atol=1e-5 if kind.startswith(("ois", "comp")) else 1e-6)


def test_netting_and_scales_match_jax():
    dates, curves = _cube_arrays()
    res = [_engines(pkg, dates, curves, {},
                    lambda p: [_swap(p, fixed_rate=0.08), _swap(p, n_years=1, fixed_rate=0.06)],
                    scales=[1.0, -0.5]) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1])
    np.testing.assert_allclose(res[0][1].ee(), res[0][0].ee(), rtol=1e-10, atol=1e-6)


def _equity_market(n_times=16, n_paths=24, seed=13):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=7 * i) for i in range(n_times)]
    return dates, 100.0 * np.exp(rng.normal(0.0, 0.04, (n_times, n_paths)).cumsum(axis=0))


def _surface_trade(kind, dates):
    def make(pkg):
        inst = pkg["inst"]
        if kind == "american":
            return [inst.AmericanOptionPosition(
                "am", "EQ.SPOT", 100.0, dates[-1], 0.3, 0.06, option_type="put", quantity=10.0,
                n_time_steps=64, num_space_nodes=127, **pkg["kw"])]
        if kind == "ko":
            return [inst.EquityBarrierOption(
                "ko", "EQ.SPOT", 100.0, dates[-1], 0.3, 0.06,
                monitor_dates=[dates[3], dates[6], dates[9], dates[12]], barrier_type="up-and-out",
                upper_barrier=115.0, rebate=1.5, quantity=100.0, n_time_steps=64,
                num_space_nodes=127, **pkg["kw"])]
        return [inst.EquityBarrierOption(
            "ki", "EQ.SPOT", 100.0, dates[-1], 0.3, 0.06,
            monitor_dates=[dates[4], dates[8], dates[12]], barrier_type="down-and-in",
            lower_barrier=88.0, rebate=0.5, quantity=50.0, n_time_steps=64,
            num_space_nodes=127, **pkg["kw"])]
    return make


@pytest.mark.parametrize("kind,seed", [("ko", 13), ("ki", 17), ("american", 19)])
def test_surface_exotics_match_jax(kind, seed):
    dates, eq = _equity_market(seed=seed)
    res = [_engines(pkg, dates, {}, {"EQ.SPOT": eq}, _surface_trade(kind, dates)) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1], atol=1e-8)


BARRIER_CASES = {
    "ko_rebate_at_hit": dict(rebate=2.0, rebate_at_hit=True),
    "double_out": dict(barrier_type="double-out", lower_barrier=85.0, upper_barrier=125.0, rebate=1.0),
    "down_and_out_put": dict(option_type="put", barrier_type="down-and-out", lower_barrier=88.0),
    "up_and_in_rebate": dict(barrier_type="up-and-in", upper_barrier=118.0, rebate=0.75),
    "double_in_already_hit": dict(barrier_type="double-in", lower_barrier=85.0, upper_barrier=125.0,
                                  already_hit=True),
}


@pytest.mark.parametrize("case", list(BARRIER_CASES))
def test_barrier_types_match_jax(case):
    """The rest of EquityBarrierOption's space (test_equity_barrier.py's
    types, rebates and an already-hit trade) through both engines of both
    packages."""
    dates, eq = _equity_market(n_times=12, n_paths=16, seed=23)

    def make(pkg):
        kw = dict(dict(upper_barrier=120.0), **BARRIER_CASES[case])
        return [pkg["inst"].EquityBarrierOption(
            "b", "EQ.SPOT", 100.0, dates[-1], 0.25, 0.05, monitor_dates=dates[2::3],
            quantity=10.0, n_time_steps=48, num_space_nodes=127, **kw, **pkg["kw"])]

    res = [_engines(pkg, dates, {}, {"EQ.SPOT": eq}, make) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1], atol=1e-8)


def test_equity_notional_leg_matches_jax():
    """``_leg_mtm``'s equity-notional branch (the TRS interest leg under
    'Price' scaling), on JAX's own leg tensors."""
    from finite_difference_tpu.instruments.equity_trs import EquityTRS

    rng = np.random.default_rng(3)
    n_times, n_paths = 14, 12
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    curves = {"ZAR-SWAP": 0.075 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0),
              "EQ.DIV": np.full((n_times, n_paths, TENORS.size), 0.02)}
    scalars = {"EQ.SPOT": 100.0 * np.exp(rng.normal(0.002, 0.05, (n_times, n_paths)).cumsum(axis=0))}
    trs = EquityTRS(
        name="trs", effective_date=VAL - dt.timedelta(days=100), maturity_date=dt.date(2026, 7, 28),
        quantity=1000.0, notional=100_000.0,
        interest_leg=jax_inst.SwapLeg(jax_inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP",
                                      spread=0.01),
        spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
        discount_curve_name="ZAR-SWAP", initial_price=100.0,
    )
    trs.interest_nominal_scaling = "Price"
    jleg = jax_dx.build_trs_tensors(trs, dates, TENORS)[1]
    assert jleg.eq_spot_name == "EQ.SPOT" and jleg.eq_stamped.any() and not jleg.eq_stamped.all()
    leg = port_dx._on_device(
        port_dx.DeviceLegTensors(**{f: getattr(jleg, f) for f in port_dx.DeviceLegTensors.__dataclass_fields__}),
        torch.device("cpu"), torch.float64)
    got = port_dx._leg_mtm(leg, {k: torch.as_tensor(v) for k, v in curves.items()},
                           {k: torch.as_tensor(v) for k, v in scalars.items()})
    want = np.asarray(jax_dx._leg_mtm(jleg, curves, scalars))
    assert _rel(got.numpy(), want) <= 1e-12


def test_float32_cube_and_the_leg_cache():
    """Float32 cubes price at float32, near float64; the leg tensors are
    built once and their device copies kept per (device, dtype)."""
    dates, curves = _cube_arrays(14, 16)
    swaps = [_swap(PORT), _swap(PORT, "ois")]
    eng64 = port_dx.DeviceExposureEngine(dates, curves, TENORS, device="cpu")
    eng32 = port_dx.DeviceExposureEngine(
        dates, {k: torch.as_tensor(v, dtype=torch.float32) for k, v in curves.items()}, TENORS, device="cpu")
    m64, m32 = eng64.mtm(swaps), eng32.mtm(swaps)
    assert m64.dtype == torch.float64 and m32.dtype == torch.float32
    # float32 rates (7 digits) through exp and the legs' cancellation
    assert float((m32.double() - m64).abs().max() / m64.abs().max()) <= 1e-4
    legs64, _ = port_dx._legs_for(tuple(swaps), dates, TENORS, torch.device("cpu"), torch.float64)
    legs32, _ = port_dx._legs_for(tuple(swaps), dates, TENORS, torch.device("cpu"), torch.float32)
    again, _ = port_dx._legs_for(tuple(swaps), dates, TENORS, torch.device("cpu"), torch.float64)
    assert again is legs64 and legs32 is not legs64
    assert legs32[0].W_disc.dtype == torch.float32 and legs64[0].W_disc.dtype == torch.float64


def test_fx_conversion_matches_jax():
    rng = np.random.default_rng(9)
    n_times, n_paths = 14, 16
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    curves = {"ZAR-SWAP": 0.07 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)}
    fx = {"USDZAR": 18.0 * np.exp(rng.normal(0, 0.01, (n_times, n_paths)).cumsum(axis=0))}
    res = [_engines(pkg, dates, curves, fx, lambda p: [_swap(p, n_years=1)], fx=["USDZAR"],
                    currencies=["USD"]) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1])


def _csa(**kw):
    def make(pkg):
        pf = pkg["pf"]
        args = dict(kw)
        for key, enum in (("im_method", pf.InitialMarginMethod), ("close_out_method", pf.CloseOutMethod)):
            if key in args:
                args[key] = enum[args[key]]
        return pf.CSA(**args)
    return make


@pytest.mark.parametrize("case", ["vm", "fixed_im", "schedule_im", "forward_string", "forward_dict"])
def test_csa_matches_jax(case):
    rng = np.random.default_rng(21)
    n_times, n_paths = 14, 16
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    swap_arr = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    curves = {"ZAR-SWAP": swap_arr, "RISKY-ZAR": swap_arr + 0.02, "RISKY-USD": swap_arr + 0.035}
    scalars = {"USDZAR": 18.0 * np.exp(rng.normal(0, 0.01, (n_times, n_paths)).cumsum(axis=0))}
    trades = lambda p: [_swap(p, n_years=1), _swap(p, n_years=1, fixed_rate=0.07),
                        _swap(p, n_years=1, fixed_rate=0.06)]
    kw = dict(scales=[1.0, -0.5, 2.0])
    vm = dict(mpor_days=10, vm_threshold=500.0, vm_threshold_post=800.0)
    if case == "vm":
        csa = _csa(**vm)
    elif case in ("fixed_im", "schedule_im"):
        csa = _csa(**vm, im_method=case.split("_")[0].upper(), im_amount=2500.0)
    elif case == "forward_string":
        csa = _csa(close_out_method="FORWARD", risky_curve_name="RISKY-ZAR")
    else:
        csa = _csa(close_out_method="FORWARD", risky_curve_name={"ZAR": "RISKY-ZAR", "USD": "RISKY-USD"})
        # GBP is absent from the dict: that trade stays unsubstituted
        kw.update(fx=[None, "USDZAR", "USDZAR"], currencies=["ZAR", "USD", "GBP"])
    res = [_engines(pkg, dates, curves, scalars, trades, csa=csa, **kw) for pkg in (PORT, JAX)]
    _hold(*res[0], *res[1], fields=("mtm", "collateral", "exposure"))
    if case.startswith("forward"):
        base = _engines(PORT, dates, curves, scalars, trades, **kw)[1]
        assert np.abs(res[0][1].mtm - base.mtm).max() > 1.0  # the substitution bites
    else:
        assert np.abs(res[0][1].collateral).max() > 0


# --------------------------------------------------------------------------
# the HW1F pipeline and the profile
# --------------------------------------------------------------------------


def test_hw1f_cva_pipeline_matches_jax():
    scen_days = list(range(30, 780, 30))
    out = {}
    for pkg, hw in ((PORT, port_hw), (JAX, jax_hw)):
        sim = hw.HW1FCurveSimulator(hw.HW1FParams.flat(alpha=0.05, sigma=0.01),
                                    curve_tenors=TENORS, curve_rates=np.full(TENORS.size, 0.075),
                                    **pkg["kw"])
        out[id(pkg)] = pkg["dx"].hw1f_cva_pipeline(
            sim, VAL, scen_days, TENORS, n_paths=128,
            instruments=[_swap(pkg, n_years=2), _swap(pkg, n_years=1, fixed_rate=0.07)],
            hazard_rate=0.02, recovery=0.4, flat_discount_rate=0.07, notional_scales=[1.0, -0.5],
        )
    p, j = out[id(PORT)], out[id(JAX)]
    assert torch.is_tensor(p["mtm"]) and p["mtm"].shape == (128, len(scen_days) + 1)
    assert _rel(p["mtm"].numpy(), np.asarray(j["mtm"])) <= 1e-10
    assert abs(p["cva"] - j["cva"]) <= 1e-10 * abs(j["cva"]) and p["cva"] > 0
    assert _rel(p["profile"].ee, j["profile"].ee) <= 1e-10
    assert p["profile"].pfe.max() >= p["profile"].ee.max()

    # the device MTM against the port's generic engine on the same host cube
    sim = port_hw.HW1FCurveSimulator(port_hw.HW1FParams.flat(alpha=0.05, sigma=0.01),
                                     curve_tenors=TENORS, curve_rates=np.full(TENORS.size, 0.075),
                                     device="cpu")
    cube = sim.to_scenario_cube(VAL, scen_days, TENORS, 128, factor_name="ZAR-SWAP",
                                days_in_year=365.25)
    swaps = [_swap(PORT, n_years=2), _swap(PORT, n_years=1, fixed_rate=0.07)]
    generic = port_ee.ExposureEngine(cube).compute(port_pf.NettingSet(
        "NS", [port_pf.Trade(swaps[0], "T1"), port_pf.Trade(swaps[1], "T2", notional_scale=-0.5)]))
    np.testing.assert_allclose(p["mtm"].numpy(), generic.mtm, rtol=1e-9, atol=1e-5)


@pytest.mark.parametrize("shape,q,deflate", [((5, 1), 0.95, False), ((26, 64), 0.95, True),
                                             ((12, 1001), 0.5, True), ((7, 333), 0.99, False)])
def test_exposure_profile_matches_jax(shape, q, deflate):
    rng = np.random.default_rng(shape[1])
    mtm = rng.normal(0.2, 1.0, shape) * 1e4
    times = np.arange(shape[0]) * 30.0
    df0 = np.exp(-0.07 * times / 365.0) if deflate else None
    p = port_cva.exposure_profile(times, mtm, pfe_quantile=q, df0=df0)
    j = jax_cva.exposure_profile(times, mtm, pfe_quantile=q, df0=df0)
    np.testing.assert_allclose(p.ee, j.ee, rtol=1e-13, atol=0)
    np.testing.assert_allclose(p.pfe, j.pfe, rtol=1e-13, atol=0)
    cp = port_cva.XvaCalculator(port_cfg.CounterpartyConfig(0.02), 365.0, pfe_quantile=q)
    cj = jax_cva.XvaCalculator(jax_cfg.CounterpartyConfig(0.02), 365.0, pfe_quantile=q)
    pp, pj = cp.build_exposure_profile(times, mtm), cj.build_exposure_profile(times, mtm)
    np.testing.assert_allclose(pp.pfe, pj.pfe, rtol=1e-13, atol=0)
    assert abs(cp.cva_from_ee(times, pp.ee) - cj.cva_from_ee(times, pj.ee)) <= 1e-13 * pj.ee.max()


def test_exposure_profile_above_torch_quantile_limit():
    n_steps, n_sims = 3, 5_600_000
    assert n_steps * n_sims > 2 ** 24
    mtm = torch.as_tensor(np.random.default_rng(0).normal(0.1, 1.0, (n_steps, n_sims)))
    p = port_cva.exposure_profile(np.arange(n_steps) * 30.0, mtm, pfe_quantile=0.95)
    pos = np.maximum(mtm.numpy(), 0.0)
    np.testing.assert_allclose(p.ee, pos.mean(axis=1), rtol=1e-13)
    np.testing.assert_allclose(p.pfe, np.quantile(pos, 0.95, axis=1, method="linear"), rtol=1e-13)


def test_row_interp_matches_vmapped_jnp_interp():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(50, 150, (6, 40)), axis=1)
    y = rng.normal(size=(6, 40))
    xq = rng.uniform(40, 160, (6, 25))
    want = np.asarray(jax.vmap(jnp.interp)(xq, x, y))
    got = linear_interp(*(torch.as_tensor(a) for a in (xq, x, y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------


class TestReviewHardening:
    """JAX's TestSimmReviewHardening cases that need no SIMM."""

    def _engine_and_swap(self):
        rng = np.random.default_rng(5)
        n_times, n_paths = 6, 8
        dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
        arr = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        eng = port_dx.DeviceExposureEngine(dates, {"C": arr}, TENORS, device="cpu")
        swap = port_inst.IRSwap(
            name="s1", effective_date=VAL, maturity_date=VAL + dt.timedelta(days=150), notional=1e6,
            receive_leg=port_inst.SwapLeg(port_inst.LegType.FLOATING, frequency=3, curve_name="C"),
            pay_leg=port_inst.SwapLeg(port_inst.LegType.FIXED, frequency=3, fixed_rate=0.075),
            discount_curve_name="C",
        )
        return eng, swap

    def test_short_risky_curve_list_raises(self):
        eng, swap = self._engine_and_swap()
        with pytest.raises(ValueError, match="risky_curve has 1 entries"):
            eng.mtm([swap, swap, swap], risky_curve=["C"])

    def test_short_currencies_raises(self):
        eng, swap = self._engine_and_swap()
        csa = port_pf.CSA(close_out_method=port_pf.CloseOutMethod.FORWARD, risky_curve_name={"ZAR": "C"})
        with pytest.raises(ValueError, match="currencies has 1 entries"):
            eng.compute([swap, swap], csa=csa, currencies=["ZAR"])

    def test_short_notional_scales_raises(self):
        eng, swap = self._engine_and_swap()
        with pytest.raises(ValueError, match="notional_scales"):
            eng.mtm([swap, swap], notional_scales=[1.0])

    def test_missing_risky_curve_warns(self):
        eng, swap = self._engine_and_swap()
        csa = port_pf.CSA(close_out_method=port_pf.CloseOutMethod.FORWARD, risky_curve_name="RISKY-TYPO")
        with pytest.warns(UserWarning, match="RISKY-TYPO"):
            out = eng.compute([swap], csa=csa)
        np.testing.assert_allclose(out.mtm, eng.compute([swap]).mtm, rtol=0)


def test_unknown_instrument_raises():
    """An instrument outside the device engine's families (here a bare
    Instrument subclass) still raises NotImplementedError on the device
    path, naming its type."""

    class Other(port_inst.Instrument):
        def scenario_npvs(self, val_date, market_state, fixings=None, rng=None):
            return np.zeros(1)

    eng, swap = TestReviewHardening()._engine_and_swap()
    with pytest.raises(NotImplementedError, match="does not support Other"):
        port_dx._build_instrument_tensors(Other("x"), eng.dates, TENORS)
    with pytest.raises(NotImplementedError, match="does not support Other"):
        eng.mtm([swap, Other("x")])


def test_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(3)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_dx.DeviceExposureEngine(dates, {}, TENORS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_inst.EquityBarrierOption("ko", "EQ.SPOT", 100.0, dates[-1], 0.3, 0.06,
                                      monitor_dates=dates[1:], upper_barrier=120.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_inst.AmericanOptionPosition("am", "EQ.SPOT", 100.0, dates[-1], 0.3, 0.06)
    # hw1f_cva_pipeline runs on its simulator's device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_hw.HW1FCurveSimulator(port_hw.HW1FParams.flat(0.05, 0.01), TENORS, np.full(8, 0.07))
    port_dx.DeviceExposureEngine(dates, {}, TENORS, device="cpu")
