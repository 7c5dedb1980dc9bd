"""The JAX package's own statistical checks of its Monte Carlo layer
(tests/test_mc.py, test_lsm.py, and test_hw1f.py's TestHW1FParams and
TestHW1FSimulator) run again on the port, on the CPU, at the JAX tests'
sizes, seeds and limits, with the port's own closed forms, CN pricers and
BGK pricer as the references.

Where a JAX check reaches a module of a later slice of the port it stays
with the JAX package: the XVA engine's and the scenario generator's Sobol
backends (test_mc.py::TestDeviceSobol::test_engine_backend,
TestMultiDimDeviceSobol::test_scenario_backend_correlation), and the HW1F
exposure loop and joint cube (test_hw1f.py::TestHW1FExposureLoop,
TestJointCube). test_hw1f.py's calibration-pipeline check feeds the JAX
package's calibration output (a plain dict) to the port's ``HW1FParams``.
"""
import datetime as dt

import numpy as np
import pytest
import torch

from finite_difference_tpu_torch.models.analytic import (
    DiscreteBarrierBGKPricer,
    bs_price,
    generalized_bs_price,
)
from finite_difference_tpu_torch.models.mc import (
    CSForwardCurveSimulator,
    CSParams,
    GBMParams,
    GBMSimulator,
    MCConfig,
    SobolNormalRng,
    price_american_lsm,
    price_discrete_barrier_mc,
)
from finite_difference_tpu_torch.models.mc.discrete_barrier import BarrierSpec, RebateSpec
from finite_difference_tpu_torch.models.mc.hw1f import HW1FCurveSimulator, HW1FParams
from finite_difference_tpu_torch.models.mc.rng import (
    prng_key,
    sobol1d_normals,
    sobol1d_uniforms,
    sobol_uniforms,
    threefry_normals,
)
from finite_difference_tpu_torch.models.pde import DiscreteBarrierFDMPricer
from finite_difference_tpu_torch.models.pde.batch import build_trade_batch, price_american_batch
from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates
from finite_difference_tpu_torch.utils.curves import flat_curve, flat_naca_dataframe

CPU = "cpu"
VAL = dt.date(2025, 7, 28)
MAT = dt.date(2025, 8, 28)
NACA = 0.073085649282
TENORS0 = np.array([0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
RATES0 = np.array([0.070, 0.071, 0.072, 0.074, 0.077, 0.079, 0.080])



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread, restored afterwards. The
    suite runs in several pytest-xdist workers, and torch's default of one
    intra-op thread per core in each of them oversubscribes the cores: the
    per-step MC loops here then ran about a hundred times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _normals(seed, shape):
    return threefry_normals(prng_key(seed), shape, device=CPU)


class TestSobol:
    def test_moments_and_shape(self):
        z = SobolNormalRng(seed=7, device=CPU).draw_normals(2, 4096)
        assert z.shape == (2, 4096)
        assert abs(z.mean()) < 0.02
        assert abs(z.std() - 1.0) < 0.02

    def test_torch_parity_backend(self):
        z_ours = SobolNormalRng(seed=3, backend="torch", device=CPU).draw_normals(1, 64)
        engine = torch.quasirandom.SobolEngine(dimension=1, scramble=True, seed=3)
        sob = engine.draw(64, dtype=torch.float64)
        eps = torch.finfo(torch.float64).eps
        u = 0.5 + (1.0 - eps) * (sob - 0.5)
        z_ref = (1.4142135623730951 * torch.erfinv(2.0 * u - 1.0)).numpy().T
        np.testing.assert_allclose(z_ours, z_ref, rtol=1e-12)

    def test_fast_forward(self):
        full = SobolNormalRng(seed=5, device=CPU).draw_normals(1, 32)
        tail = SobolNormalRng(seed=5, fast_forward=16, device=CPU).draw_normals(1, 16)
        np.testing.assert_allclose(full[:, 16:], tail, rtol=1e-12)


class TestGBM:
    def test_martingale_and_lognormal(self):
        sim = GBMSimulator(GBMParams(mu=0.05, sigma=0.2), days_in_year=365.0, device=CPU)
        days = np.arange(0, 366, 5)
        paths = sim.simulate(100.0, days, _normals(0, (len(days), 100_000))).numpy()
        t = days[-1] / 365.0
        assert paths[-1].mean() == pytest.approx(100.0 * np.exp(0.05 * t), rel=5e-3)
        assert np.log(paths[-1]).std() == pytest.approx(0.2 * np.sqrt(t), rel=1e-2)
        assert sim.sanity_check_mean(paths, 100.0, days)["max_abs_rel_err"] < 5e-3

    def test_sanity_check_z(self):
        z = np.random.default_rng(0).standard_normal((50, 10000))
        d = GBMSimulator.sanity_check_z(z)
        assert abs(d["mean"]) < 0.01 and abs(d["std"] - 1) < 0.01
        assert abs(d["kurtosis"] - 3.0) < 0.1


class TestClewlowStrickland:
    def test_martingale_risk_neutral(self):
        sim = CSForwardCurveSimulator(CSParams(alpha=1.2, sigma=0.35, mu=0.08), 365.25, device=CPU)
        tenors = np.array([30.0, 90.0, 180.0, 365.0])
        scen = np.array([0.0, 5.0, 10.0, 30.0, 60.0, 90.0])
        f0 = np.array([50.0, 52.0, 55.0, 60.0])
        paths = sim.simulate(f0, tenors, scen, _normals(1, (len(scen), 200_000)), risk_neutral=True)
        assert paths.shape == (6, 4, 200_000)
        np.testing.assert_allclose(paths[-1].mean(dim=1).numpy(), f0, rtol=5e-3)

    def test_variance_stops_at_delivery(self):
        sim = CSForwardCurveSimulator(CSParams(alpha=0.8, sigma=0.4, mu=0.0), 365.25, device=CPU)
        tenors = np.array([10.0, 365.0])
        scen = np.array([0.0, 5.0, 10.0, 50.0, 100.0])
        paths = sim.simulate(np.array([50.0, 50.0]), tenors, scen, _normals(2, (5, 50_000))).numpy()
        var_short = np.log(paths[:, 0, :]).var(axis=1)
        assert var_short[2] == pytest.approx(var_short[4], rel=1e-9)
        var_long = np.log(paths[:, 1, :]).var(axis=1)
        assert var_long[4] > var_long[2] > 0

    def test_drift_matches_theory(self):
        params = CSParams(alpha=1.0, sigma=0.2, mu=0.1)
        sim = CSForwardCurveSimulator(params, 365.25, device=CPU)
        scen = np.array([0.0, 60.0, 120.0, 182.0])
        paths = sim.simulate(np.array([40.0]), np.array([365.0]), scen, _normals(3, (4, 200_000)))
        t = 182.0 / 365.25
        assert float(paths[-1, 0].mean()) == pytest.approx(40.0 * np.exp(params.mu * t), rel=5e-3)


def _cn_barrier(bt, level, rebate=0.0, at_hit=False, steps=500, **kw):
    kw.setdefault("spot", 229.74)
    kw.setdefault("strike", 190.0)
    kw.setdefault("sigma", 0.28790)
    side = "upper_barrier" if bt.startswith("up") else "lower_barrier"
    return DiscreteBarrierFDMPricer(
        valuation_date=VAL, maturity_date=MAT, option_type="call", barrier_type=bt,
        monitor_dates=build_monitoring_dates(VAL, MAT, "daily"),
        discount_curve=flat_naca_dataframe(NACA), underlying_spot_days=0, num_time_steps=steps,
        rebate_amount=rebate, rebate_at_hit=at_hit, device=CPU, **{side: level}, **kw,
    ).price_log2()


class TestDiscreteBarrierMC:
    def _price(self, **kw):
        base = dict(
            spot=229.74, strike=190.0, vol=0.28790, option_type="call",
            valuation=VAL, maturity=MAT, discount_curve=flat_curve(NACA, VAL),
            monitor_dates=build_monitoring_dates(VAL, MAT, "daily"),
            cfg=MCConfig(n_paths=200_000, seed=42), device=CPU,
        )
        base.update(kw)
        return price_discrete_barrier_mc(**base)

    def test_vanilla_matches_closed_form(self):
        res = self._price(barrier=BarrierSpec("none"), monitor_dates=[])
        curve = flat_curve(NACA, VAL)
        t = curve.year_fraction(VAL, MAT)
        r = curve.get_forward_nacc_rate(VAL, MAT)
        spot = torch.tensor(229.74, dtype=torch.float64)
        expected = float(generalized_bs_price(spot, 190.0, 0.28790, t, r, r, True))
        assert res["price"] == pytest.approx(expected, abs=4 * res["stderr"])

    def test_ko_matches_pde(self):
        res = self._price(barrier=BarrierSpec("up-and-out", level=260.0),
                          cfg=MCConfig(n_paths=400_000, seed=11))
        assert res["price"] == pytest.approx(_cn_barrier("up-and-out", 260.0), abs=4 * res["stderr"] + 0.02)

    def test_in_out_parity(self):
        ko = self._price(barrier=BarrierSpec("up-and-out", level=260.0))
        ki = self._price(barrier=BarrierSpec("up-and-in", level=260.0))
        van = self._price(barrier=BarrierSpec("none"))
        assert ko["price"] + ki["price"] == pytest.approx(van["price"], rel=1e-10)

    def test_rebate_at_hit(self):
        p0 = self._price(barrier=BarrierSpec("up-and-out", level=250.0))
        p_reb = self._price(barrier=BarrierSpec("up-and-out", level=250.0),
                            rebate=RebateSpec(amount=5.0, rebate_at_hit=True))
        assert p_reb["price"] > p0["price"]

    @pytest.mark.parametrize("bt, at_hit", [("up-and-out", False), ("up-and-out", True),
                                            ("up-and-in", False)])
    def test_rebated_barriers_mc_vs_pde_cross_engine(self, bt, at_hit):
        res = self._price(barrier=BarrierSpec(bt, level=260.0),
                          rebate=RebateSpec(amount=5.0, rebate_at_hit=at_hit),
                          cfg=MCConfig(n_paths=400_000, seed=11))
        pde = _cn_barrier(bt, 260.0, rebate=5.0, at_hit=at_hit)
        assert res["price"] == pytest.approx(pde, abs=4 * res["stderr"] + 0.05), (res["price"], pde)

    def test_ki_rebate_pays_iff_never_hit(self):
        spec = BarrierSpec("up-and-in", level=260.0)
        p0 = self._price(barrier=spec)
        p5 = self._price(barrier=spec, rebate=RebateSpec(amount=5.0))
        df_t = float(flat_curve(NACA, VAL).get_discount_factor(MAT))
        assert 0.0 < p5["price"] - p0["price"] < 5.0 * df_t
        far = self._price(barrier=BarrierSpec("up-and-in", level=900.0), rebate=RebateSpec(amount=5.0))
        assert far["price"] == pytest.approx(5.0 * df_t, rel=1e-6)

    def test_dividend_reduces_call(self):
        res0 = self._price(barrier=BarrierSpec("none"), monitor_dates=[])
        res_div = self._price(barrier=BarrierSpec("none"), monitor_dates=[],
                              dividends=[(dt.date(2025, 8, 14), 8.0)])
        assert res_div["price"] < res0["price"] - 2.0

    def test_barrier_band(self):
        tight = self._price(barrier=BarrierSpec("up-and-out", level=260.0))
        banded = self._price(barrier=BarrierSpec("up-and-out", level=260.0, tol_bps=100.0))
        assert banded["price"] < tight["price"]


class TestDeviceSobol:
    def test_matches_unscrambled_scipy_sobol(self):
        from scipy.stats import qmc

        want = qmc.Sobol(d=1, scramble=False).random(64)[:, 0]
        np.testing.assert_allclose(sobol1d_uniforms(64, device=CPU).numpy(), want, atol=1e-12)

    def test_fast_forward_is_an_offset(self):
        full = sobol1d_uniforms(32, device=CPU).numpy()
        np.testing.assert_array_equal(full[8:], sobol1d_uniforms(24, fast_forward=8, device=CPU).numpy())

    def test_normals_low_discrepancy(self):
        z = sobol1d_normals(1 << 14, device=CPU).numpy()
        assert abs(z.mean()) < 1e-3
        assert abs(z.std() - 1.0) < 1e-2


class TestMultiDimDeviceSobol:
    @pytest.mark.parametrize("d", (1, 2, 5, 13))
    def test_matches_scipy_all_dims(self, d):
        from scipy.stats import qmc

        want = qmc.Sobol(d=d, scramble=False).random(128)
        np.testing.assert_allclose(sobol_uniforms(128, d, device=CPU).numpy(), want, atol=1e-12)

    def test_fast_forward_offset(self):
        full = sobol_uniforms(64, 3, device=CPU).numpy()
        np.testing.assert_array_equal(sobol_uniforms(24, 3, fast_forward=40, device=CPU).numpy(), full[40:])


class TestCrossEngineBarrierFuzz:
    @pytest.mark.parametrize("trial", range(6))
    def test_random_configs_cn_vs_bgk_vs_mc(self, trial):
        """test_mc.py's randomized three-engine check, one case per trial
        (the same draws: the generator replays the earlier trials)."""
        rng = np.random.default_rng(17)
        for _ in range(trial + 1):
            is_up = bool(rng.integers(0, 2))
            is_in = bool(rng.integers(0, 2))
            bt = ("up-" if is_up else "down-") + ("and-in" if is_in else "and-out")
            s0 = float(rng.uniform(90.0, 110.0))
            k = float(rng.uniform(85.0, 115.0))
            sigma = float(rng.uniform(0.18, 0.4))
            h = s0 * (float(rng.uniform(1.08, 1.3)) if is_up else float(rng.uniform(0.75, 0.93)))
        kw_cn = dict(upper_barrier=h) if is_up else dict(lower_barrier=h)
        monitors = build_monitoring_dates(VAL, MAT, "daily")
        mc_curve = flat_curve(NACA, VAL)
        cn = _cn_barrier(bt, h, steps=400, spot=s0, strike=k, sigma=sigma)
        bgk = DiscreteBarrierBGKPricer(
            spot=s0, strike=k, volatility=sigma, valuation_date=VAL, maturity_date=MAT,
            monitor_dates=monitors, option_type="call", barrier_type=bt, pricing_method="bgk",
            discount_curve=mc_curve, device=CPU, **kw_cn,
        ).price()
        res = price_discrete_barrier_mc(
            spot=s0, strike=k, vol=sigma, option_type="call", valuation=VAL, maturity=MAT,
            discount_curve=mc_curve, monitor_dates=monitors, barrier=BarrierSpec(bt, level=h),
            cfg=MCConfig(n_paths=200_000, seed=100 + trial), device=CPU,
        )
        msg = f"trial {trial}: {bt} s0={s0:.2f} k={k:.2f} h={h:.2f} sigma={sigma:.2f}"
        assert res["price"] == pytest.approx(cn, abs=4 * res["stderr"] + 0.03), (
            f"{msg} cn={cn} mc={res['price']}")
        assert bgk == pytest.approx(cn, rel=6e-2, abs=0.15), f"{msg} cn={cn} bgk={bgk}"


def _cn_american(s0, k, sigma, t, r, q, is_call, n=800):
    tb = build_trade_batch(
        spots=[s0], strikes=[k], sigmas=[sigma], t_expiry=[t], r=[r], b=[r - q], is_call=[is_call],
        n_time_steps=n, monitor_times=[[]], num_space_nodes=n - 1, device=CPU,
    )
    return float(price_american_batch(tb, n_nodes=n, with_greeks=False, device=CPU)["price"][0])


def _bs(*args):
    return float(bs_price(torch.tensor(args[0], dtype=torch.float64), *args[1:]))


class TestLSM:
    def test_american_call_no_dividends_equals_european(self):
        c, se = price_american_lsm(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, True,
                                   n_paths=200_000, n_steps=50, seed=1, device=CPU)
        assert c == pytest.approx(_bs(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, True), abs=4.0 * se)

    def test_put_cross_checks_cn_engine(self):
        s0, k, sigma, t, r = 100.0, 100.0, 0.25, 1.0, 0.05
        lsm, se = price_american_lsm(s0, k, sigma, t, r, 0.0, False, n_paths=200_000, n_steps=50,
                                     seed=2, device=CPU)
        cn = _cn_american(s0, k, sigma, t, r, 0.0, False)
        assert lsm == pytest.approx(cn, rel=5e-3)
        assert abs(lsm - cn) < max(4.0 * se, 5e-3 * cn)

    def test_itm_put_with_dividend_yield(self):
        s0, k, sigma, t, r, q = 90.0, 100.0, 0.3, 2.0, 0.06, 0.03
        lsm, _ = price_american_lsm(s0, k, sigma, t, r, q, False, n_paths=200_000, n_steps=50,
                                    seed=3, device=CPU)
        assert lsm == pytest.approx(_cn_american(s0, k, sigma, t, r, q, False), rel=6e-3)

    def test_early_exercise_premium_positive(self):
        p, _ = price_american_lsm(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, False, n_paths=100_000,
                                  seed=4, device=CPU)
        assert p > _bs(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, False)

    def test_deterministic_for_fixed_seed(self):
        args = (100.0, 95.0, 0.2, 0.5, 0.04, 0.0, False)
        a = price_american_lsm(*args, n_paths=50_000, seed=7, device=CPU)
        assert a == price_american_lsm(*args, n_paths=50_000, seed=7, device=CPU)

    def test_deep_itm_put_floor(self):
        p, _ = price_american_lsm(60.0, 100.0, 0.2, 1.0, 0.08, 0.0, False, n_paths=50_000, seed=5,
                                  device=CPU)
        assert p >= 40.0 - 1e-9


def _sim(alpha=0.1, sigma=0.012):
    return HW1FCurveSimulator(HW1FParams.flat(alpha, sigma), TENORS0, RATES0, device=CPU)


class TestHW1FParams:
    def test_from_calibration_dot_curve_packing(self):
        params = {"Alpha": 0.15, "Sigma": {".Curve": {"meta": [], "data": [(1.0, 0.01), (0.25, 0.02)]}}}
        p = HW1FParams.from_calibration(params)
        assert p.alpha == 0.15
        np.testing.assert_allclose(p.sigma_tenors, [0.25, 1.0])
        np.testing.assert_allclose(p.sigma_at(np.array([0.25, 0.625, 2.0])), [0.02, 0.015, 0.01])

    def test_from_calibration_pipeline_output(self):
        import pandas as pd

        from finite_difference_tpu.calibration import calibrate_hw1f_interest_rate

        rng = np.random.default_rng(0)
        panel = pd.DataFrame(0.07 + 0.002 * rng.standard_normal((300, 4)).cumsum(axis=0) / 50.0,
                             columns=[0.25, 1.0, 5.0, 10.0])
        param, _, _ = calibrate_hw1f_interest_rate(panel)
        p = HW1FParams.from_calibration(param)
        assert p.alpha > 0
        assert (p.sigma_values >= 0).all()


class TestHW1FSimulator:
    def test_zero_vol_reconstitutes_forward_curve(self):
        t_grid = np.linspace(0.1, 2.0, 20)
        taus = [0.25, 1.0, 5.0]
        out = _sim(sigma=1e-14).simulate(t_grid, taus, n_paths=3, seed=1)
        z0t = np.interp(t_grid, TENORS0, RATES0)
        for j, tau in enumerate(taus):
            zf = (np.interp(t_grid + tau, TENORS0, RATES0) * (t_grid + tau) - z0t * t_grid) / tau
            np.testing.assert_allclose(out[:, 0, j], zf, atol=1e-9)

    def test_state_moments_match_closed_form(self):
        sim = _sim()
        t_grid = np.linspace(1 / 52, 2.0, 52)
        xs = sim.simulate_state(t_grid, n_paths=40_000, seed=7)
        m_cl, y_cl = sim.moments(t_grid)
        np.testing.assert_allclose(xs.mean(axis=1), m_cl, atol=1e-14)
        np.testing.assert_allclose(xs.var(axis=1), y_cl, rtol=0.05)

    def test_martingale_discounted_bond(self):
        sim = _sim()
        t_grid = np.linspace(1 / 52, 1.0, 52)
        tau_T, n_paths, eps = 5.0, 100_000, 1e-4
        out = sim.simulate(t_grid, [tau_T], n_paths=n_paths, seed=7)
        r = sim.simulate(t_grid, [eps], n_paths=n_paths, seed=7)[:, :, 0]
        dts = np.diff(np.concatenate([[0.0], t_grid]))
        r0 = np.interp(eps, TENORS0, RATES0)
        r_prev = np.vstack([np.full((1, n_paths), r0), r[:-1]])
        integ = np.cumsum(0.5 * (r + r_prev) * dts[:, None], axis=0)
        i = len(t_grid) - 1
        lhs = (np.exp(-integ[i]) * np.exp(-out[i, :, 0] * tau_T)).mean()
        T = t_grid[i] + tau_T
        assert abs(lhs / np.exp(-np.interp(T, TENORS0, RATES0) * T) - 1.0) < 5e-4

    def test_piecewise_sigma_moments(self):
        p = HW1FParams(alpha=0.3, sigma_tenors=np.array([0.0, 1.0]), sigma_values=np.array([0.02, 0.005]))
        sim = HW1FCurveSimulator(p, TENORS0, RATES0, device=CPU)
        t_grid = np.linspace(0.25, 2.0, 8)
        xs = sim.simulate_state(t_grid, n_paths=60_000, seed=3)
        np.testing.assert_allclose(xs.var(axis=1), sim.moments(t_grid)[1], rtol=0.05)

    def test_validation(self):
        sim = _sim()
        with pytest.raises(ValueError, match="ascending"):
            sim.simulate([0.5, 0.25], [1.0], 4)
        with pytest.raises(ValueError, match="tenors"):
            sim.simulate([0.25, 0.5], [0.0, 1.0], 4)
        with pytest.raises(ValueError, match="normals"):
            sim.simulate([0.25], [1.0], 4, normals=np.zeros((2, 4)))
