"""The port's commodity CVA stack (``finite_difference_tpu_torch.xva``: the
time grid, the reference price, the commodity forward, the commodity XVA
engine, and ``runners.run_asset``) against the JAX package, on the CPU at
float64, on the same inputs.

Tolerances, with the largest gap measured on these inputs in brackets:

- the time grid, the fixing schedules and the interpolation plan: equal
  (the same numpy code) [0];
- ``ReferencePrice.compute_all`` and ``CommodityForward.mtm_all`` on one
  curve cube: 1e-13 of max|value| [7.6e-15];
- the engine's normals, per draw backend: 1e-12 relative to the largest
  |z| [1.2e-13]: the threefry normals differ from JAX's by erfinv's last
  bits (tests/test_torch_mc.py), the Sobol points not at all, their
  inverse CDFs by a few ulps;
- the engine and ``run_asset`` at 2,000 simulations and the same seed,
  per draw backend: CVA within 1e-12 relative, MTM, EE and PFE within
  1e-12 of their largest |value| [threefry 3.6e-14, sobol 6.8e-15,
  sobol_device 1.5e-15];
- JAX's own checks of the engine (test_xva.py::TestCommodityXvaEngine)
  on the port alone, at JAX's sizes: the engine is a few torch ops over
  (19 dates, 4 tenors, 50,000 paths), well under a second here.
"""
import numpy as np
import pytest
import torch

import finite_difference_tpu.models.mc as jax_mc
import finite_difference_tpu.runners as jax_runners
import finite_difference_tpu.xva as jax_xva
import finite_difference_tpu.xva.reference_price as jax_rp
import finite_difference_tpu_torch.models.mc as port_mc
import finite_difference_tpu_torch.runners as port_runners
import finite_difference_tpu_torch.xva as port_xva
import finite_difference_tpu_torch.xva.reference_price as port_rp

CPU = {"device": "cpu"}
JAX_SIMS = 2_000  # the size at which the port is held against JAX


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b) -> float:
    a, b = np.asarray(_np(a), dtype=float), np.asarray(_np(b), dtype=float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class TestTimeGrid:
    @pytest.mark.parametrize("dt_days,horizon", [(5, 17), (1, 365), (10, 180), (30, 90), (7, 7)])
    def test_matches_jax(self, dt_days, horizon):
        p, j = port_xva.TimeGrid.regular(dt_days, horizon), jax_xva.TimeGrid.regular(dt_days, horizon)
        np.testing.assert_array_equal(p.scen_days, j.scen_days)
        assert p.n_steps == j.n_steps == len(p)
        np.testing.assert_array_equal(p.year_fractions(365.0), j.year_fractions(365.0))
        cfg = port_xva.SimulationConfig(dt_days=dt_days, horizon_days=horizon)
        np.testing.assert_array_equal(cfg.time_grid().scen_days, p.scen_days)

    def test_regular_and_validation(self):
        tg = port_xva.TimeGrid.regular(dt_days=5, horizon_days=17)
        assert tg.scen_days[0] == 0 and tg.scen_days[-1] == 17 and tg.n_steps == 5
        for bad in ((0, 10), (1, 0)):
            with pytest.raises(ValueError):
                port_xva.TimeGrid.regular(*bad)
        assert port_xva.SimulationConfig().time_grid().n_steps == 366


class TestFixingSchedule:
    CASES = [(10, 30, "BULLET", 0), (10, 12, "DAILY", 0), (0, 21, "WEEKLY", 0), (0, 90, "MONTHLY", 0),
             (10, 12, "DAILY", 2), (3, 40, "WEEKLY", 5)]

    @pytest.mark.parametrize("start,end,conv,offset", CASES)
    def test_matches_jax(self, start, end, conv, offset):
        p = port_xva.FixingSchedule(start, end, port_xva.SamplingConvention[conv], offset)
        j = jax_xva.FixingSchedule(start, end, jax_xva.SamplingConvention[conv], offset)
        np.testing.assert_array_equal(p.sample_days(), j.sample_days())

    def test_conventions_and_validation(self):
        S = port_xva.SamplingConvention
        assert port_xva.FixingSchedule(10, 30, S.BULLET).sample_days().tolist() == [30.0]
        np.testing.assert_array_equal(port_xva.FixingSchedule(0, 90, S.MONTHLY).sample_days(), [0, 30, 60, 90])
        np.testing.assert_array_equal(port_xva.FixingSchedule(10, 12, S.DAILY, 2).sample_days(), [12, 13, 14])
        with pytest.raises(ValueError):
            port_xva.FixingSchedule(10, 5).sample_days()


class TestReferencePrice:
    def _curves(self, n_steps=3, n_sims=4):
        # flat-in-tenor curves with known level per step: level = 100 + step
        tenor_days = np.array([0.0, 100.0, 200.0])
        curves = np.broadcast_to((100.0 + np.arange(n_steps))[:, None, None], (n_steps, 3, n_sims)).copy()
        return tenor_days, torch.as_tensor(curves)

    def test_future_only_average(self):
        tenor_days, curves = self._curves()
        rp = port_xva.ReferencePrice(port_xva.FixingSchedule(50, 52), settlement_lag_days=0)
        out = rp.compute_all(np.array([0.0, 1.0, 2.0]), curves, tenor_days)
        np.testing.assert_allclose(out[:, 0].numpy(), [100.0, 101.0, 102.0])

    def test_realised_mix(self):
        tenor_days, curves = self._curves()
        rp = port_xva.ReferencePrice(port_xva.FixingSchedule(0, 2), settlement_lag_days=0,
                                     realised_fixings={0: 90.0, 1: 80.0})
        out = rp.compute_all(np.array([0.0, 1.0, 2.0]), curves, tenor_days).numpy()
        np.testing.assert_allclose(out[0, 0], (90.0 + 2 * 100.0) / 3.0)
        np.testing.assert_allclose(out[1, 0], (90.0 + 80.0 + 101.0) / 3.0)

    def test_tenor_interpolation_lag_and_extrapolation(self):
        S = port_xva.SamplingConvention
        rp = port_xva.ReferencePrice(port_xva.FixingSchedule(40, 40, S.BULLET), settlement_lag_days=10)
        out = rp.compute_all(np.array([0.0]), torch.as_tensor([[[0.0], [100.0]]]), np.array([0.0, 100.0]))
        np.testing.assert_allclose(out[0, 0].item(), 50.0)  # query at 40+10
        rp = port_xva.ReferencePrice(port_xva.FixingSchedule(90, 90, S.BULLET), settlement_lag_days=0)
        out = rp.compute_all(np.array([0.0]), torch.as_tensor([[[5.0], [7.0]]]), np.array([10.0, 20.0]))
        np.testing.assert_allclose(out[0, 0].item(), 7.0)

    def test_single_date_api(self):
        tenor_days, curves = self._curves()
        rp = port_xva.ReferencePrice(port_xva.FixingSchedule(50, 52), settlement_lag_days=0)
        np.testing.assert_allclose(rp.compute(1, 1.0, curves[1], tenor_days).numpy(), 101.0)

    @pytest.mark.parametrize("conv,lag,realised", [("DAILY", 2, None), ("WEEKLY", 0, {14: 98.0, 21: 101.5}),
                                                   ("MONTHLY", 5, {0: 97.0}), ("BULLET", 2, None)])
    def test_matches_jax_on_a_cube(self, conv, lag, realised):
        rng = np.random.default_rng(7)
        tenor_days = np.array([30.0, 90.0, 180.0, 270.0])
        scen_days = np.arange(0.0, 181.0, 10.0)
        curves = 100.0 * np.exp(rng.normal(0, 0.02, (scen_days.size, tenor_days.size, 64)).cumsum(axis=0))
        for i, j in zip(port_rp._interp_plan(tenor_days, [0.0, 45.0, 300.0]),
                        jax_rp._interp_plan(tenor_days, [0.0, 45.0, 300.0])):
            np.testing.assert_array_equal(i, j)
        rp = [pkg.ReferencePrice(pkg.FixingSchedule(7, 60, pkg.SamplingConvention[conv]),
                                 settlement_lag_days=lag, realised_fixings=realised)
              for pkg in (port_xva, jax_xva)]
        got = rp[0].compute_all(scen_days, torch.as_tensor(curves), tenor_days)
        assert got.shape == (scen_days.size, 64) and got.dtype == torch.float64
        assert _rel(got, rp[1].compute_all(scen_days, curves, tenor_days)) <= 1e-13
        fwd = [pkg.CommodityForward(185, 101.0, 3.0, r, pkg.DiscountingConfig(0.05))
               for pkg, r in ((port_xva, rp[0]), (jax_xva, rp[1]))]
        assert _rel(fwd[0].mtm_all(scen_days, torch.as_tensor(curves), tenor_days, 365.0),
                    fwd[1].mtm_all(scen_days, curves, tenor_days, 365.0)) <= 1e-13
        assert _rel(fwd[0].mtm(3, 30.0, torch.as_tensor(curves[3]), tenor_days, 365.0),
                    fwd[1].mtm(3, 30.0, curves[3], tenor_days, 365.0)) <= 1e-13


def _engine(pkg, n_sims=20_000, hazard=0.03, backend="threefry", **kw):
    sim_cfg = pkg["xva"].SimulationConfig(num_sims=n_sims, seed=1, dt_days=10, horizon_days=180,
                                          days_in_year=365.0)
    return pkg["xva"].CommodityXvaEngine(
        sim_cfg=sim_cfg, cs_params=pkg["mc"].CSParams(alpha=1.0, sigma=0.3, mu=0.0),
        initial_curve=np.array([100.0, 102.0, 104.0, 106.0]), tenor_days=np.array([30.0, 90.0, 180.0, 270.0]),
        discounting=pkg["xva"].DiscountingConfig(rate=0.05),
        counterparty=pkg["xva"].CounterpartyConfig(hazard_rate=hazard, recovery=0.4),
        rng_backend=backend, **pkg["kw"], **kw)


def _trade(pkg, strike=100.0):
    x = pkg["xva"]
    rp = x.ReferencePrice(x.FixingSchedule(170, 180, x.SamplingConvention.DAILY), settlement_lag_days=2)
    return x.CommodityForward(maturity_day=185, strike=strike, notional=1.0, reference_price=rp,
                              discounting=x.DiscountingConfig(rate=0.05))


PORT = {"xva": port_xva, "mc": port_mc, "kw": CPU}
JAX = {"xva": jax_xva, "mc": jax_mc, "kw": {}}


class TestCommodityXvaEngine:
    @pytest.mark.parametrize("backend", ["threefry", "sobol", "sobol_device"])
    @pytest.mark.parametrize("strike", [100.0, 50.0])
    def test_matches_jax(self, backend, strike):
        res = [_engine(pkg, n_sims=JAX_SIMS, backend=backend).run_forward_cva(_trade(pkg, strike))
               for pkg in (PORT, JAX)]
        p, j = res
        assert torch.is_tensor(p.mtm_paths) and p.mtm_paths.shape == (19, JAX_SIMS)
        np.testing.assert_array_equal(p.times_days, j.times_days)
        assert abs(p.cva - j.cva) <= 1e-12 * abs(j.cva)
        assert _rel(p.exposure_profile.ee, j.exposure_profile.ee) <= 1e-12
        assert _rel(p.exposure_profile.pfe, j.exposure_profile.pfe) <= 1e-12
        assert _rel(p.mtm_paths, j.mtm_paths) <= 1e-12

    def test_draws_match_jax(self):
        """Each backend's (n_steps, n_sims) normals against JAX's."""
        for backend in ("threefry", "sobol", "sobol_device"):
            z = [_engine(pkg, n_sims=JAX_SIMS, backend=backend)._draw_normals(19, JAX_SIMS) for pkg in (PORT, JAX)]
            assert z[0].shape == (19, JAX_SIMS) and z[0].dtype == torch.float64
            assert _rel(z[0], z[1]) <= 1e-12, backend

    def test_atm_forward_cva_positive_and_bounded(self):
        res = _engine(PORT).run_forward_cva(_trade(PORT))
        assert res.cva > 0.0 and res.cva < 0.6 * res.exposure_profile.ee.max() * 1.01
        assert res.mtm_paths.shape == (res.times_days.size, 20_000)
        assert np.all(res.exposure_profile.pfe >= res.exposure_profile.ee - 1e-12)

    def test_martingale_mtm_expectation(self):
        mtm = _engine(PORT, n_sims=50_000).run_forward_cva(_trade(PORT, strike=102.0)).mtm_paths.numpy()
        assert mtm[-1].mean() == pytest.approx(mtm[0].mean(), abs=0.25)

    def test_deep_itm_forward_cva_scales_with_hazard(self):
        low = _engine(PORT, hazard=0.01).run_forward_cva(_trade(PORT, strike=50.0)).cva
        high = _engine(PORT, hazard=0.05).run_forward_cva(_trade(PORT, strike=50.0)).cva
        assert high > low > 0

    def test_engine_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _engine({"xva": port_xva, "mc": port_mc, "kw": {}})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_runners.run_asset("X", initial_curve=np.array([1.0, 1.0]), tenor_days=np.array([30.0, 60.0]),
                                   cs_params=port_mc.CSParams(1.0, 0.2, 0.0))


class TestXvaRunner:
    KW = dict(initial_curve=np.array([100.0, 102.0, 104.0]), tenor_days=np.array([90.0, 180.0, 365.0]))

    def test_run_asset(self):
        out = port_runners.run_asset(
            "BRENT", cs_params=port_mc.CSParams(alpha=1.0, sigma=0.3, mu=0.0),
            sim_cfg=port_xva.SimulationConfig(num_sims=5000, dt_days=10, horizon_days=180),
            rng_backend="threefry", device="cpu", **self.KW)
        assert out["asset_code"] == "BRENT"
        assert out["cva"] > 0 and out["peak_pfe"] >= out["peak_ee"]

    @pytest.mark.parametrize("backend", ["threefry", "sobol"])
    def test_matches_jax(self, backend, tmp_path):
        out = []
        for pkg, runners, kw in ((PORT, port_runners, CPU), (JAX, jax_runners, {})):
            out.append(runners.run_asset(
                "GOLD", cs_params=pkg["mc"].CSParams(alpha=0.4, sigma=0.14, mu=0.0),
                sim_cfg=pkg["xva"].SimulationConfig(num_sims=JAX_SIMS, dt_days=5, horizon_days=300),
                discount_rate=0.05, hazard_rate=0.02, recovery=0.4, realised_fixings={280: 103.0},
                rng_backend=backend, **self.KW, **kw))
        p, j = out
        assert p.keys() == j.keys()
        assert abs(p["cva"] - j["cva"]) <= 1e-12 * abs(j["cva"])
        for key in ("strike", "maturity_day"):
            assert p[key] == j[key]
        for key in ("peak_ee", "peak_pfe"):
            assert abs(p[key] - j[key]) <= 1e-12 * abs(j[key])
        np.testing.assert_array_equal(p["times_days"], j["times_days"])

    def test_plot_path(self, tmp_path):
        pytest.importorskip("matplotlib")
        path = tmp_path / "ee.png"
        port_runners.run_asset(
            "BRENT", cs_params=port_mc.CSParams(alpha=1.0, sigma=0.3, mu=0.0),
            sim_cfg=port_xva.SimulationConfig(num_sims=256, dt_days=30, horizon_days=180),
            rng_backend="threefry", plot_path=str(path), device="cpu", **self.KW)
        assert path.stat().st_size > 0
