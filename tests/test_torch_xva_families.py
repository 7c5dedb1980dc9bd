"""The rest of the port's XVA engine, the exposure families and SIMM
(``finite_difference_tpu_torch``: the CPI market data, the equity TRS,
index-linked swap and commodity instruments, their tensors on the device
exposure engine, and SIMM initial margin in both engines) against the JAX
package, on the CPU at float64, on the same numpy inputs.

Tolerances, with the largest gap measured on these inputs in brackets:

- the CPI conventions, ``get_cpi_level``, the TRS, ILS and commodity
  instruments' NPVs and the generic ``ExposureEngine`` on them: equal, or
  within 1e-12 of max|value| (the same numpy code) [0];
- the device engine against JAX's device engine: MTM within 1e-12 of
  max|value| [4.0e-14, the mixed-family fuzz] (the contractions sum in
  another order);
- the port's device engine against its generic engine at JAX's own gates:
  MTM rtol 1e-10 (the fuzz 1e-9) with JAX's atol [5.7e-14 of max|MTM|],
  and SIMM collateral and exposure rtol 1e-7 [1.6e-12], the
  finite-difference noise floor JAX states for it;
- the SIMM aggregation on tensors against JAX's numpy: 1e-12 relative
  [3.9e-16]; the device engines' SIMM collateral and exposure, port
  against JAX: 1e-9 of max|value| [3.7e-11], since a 1bp finite
  difference amplifies the MTMs' last-bit gap (``SIMM_VS_JAX``).
"""
import datetime as dt
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import finite_difference_tpu.instruments as jax_inst
import finite_difference_tpu.market_data as jax_md
import finite_difference_tpu.market_data.scenario_cube as jax_sc
import finite_difference_tpu.portfolio as jax_pf
import finite_difference_tpu.portfolio.simm as jax_simm
import finite_difference_tpu.xva.device_exposure as jax_dx
import finite_difference_tpu.xva.exposure_engine as jax_ee
import finite_difference_tpu_torch.instruments as port_inst
import finite_difference_tpu_torch.market_data as port_md
import finite_difference_tpu_torch.market_data.scenario_cube as port_sc
import finite_difference_tpu_torch.portfolio as port_pf
import finite_difference_tpu_torch.portfolio.simm as port_simm
import finite_difference_tpu_torch.xva.device_exposure as port_dx
import finite_difference_tpu_torch.xva.exposure_engine as port_ee
from finite_difference_tpu.instruments.instrument import Instrument as JaxInstrument
from finite_difference_tpu_torch.instruments.instrument import Instrument as PortInstrument

VAL = dt.date(2025, 7, 28)
TENORS = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
INST_TENORS = np.array([0.25, 0.5, 1.0, 2.0, 5.0, 10.0])  # test_instruments.py's grid

PORT = SimpleNamespace(inst=port_inst, md=port_md, sc=port_sc, pf=port_pf, ee=port_ee, dx=port_dx,
                       simm=port_simm, Instrument=PortInstrument, kw={"device": "cpu"})
JAX = SimpleNamespace(inst=jax_inst, md=jax_md, sc=jax_sc, pf=jax_pf, ee=jax_ee, dx=jax_dx,
                      simm=jax_simm, Instrument=JaxInstrument, kw={})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CN surface solves step in Python; under the suite's xdist workers
    # torch's thread per core made such loops far slower (tests/test_torch_mc.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b) -> float:
    a, b = np.asarray(_np(a), dtype=float), np.asarray(_np(b), dtype=float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _both(fn):
    """fn(pkg) for the port and for JAX."""
    return fn(PORT), fn(JAX)


# --------------------------------------------------------------------------
# CPI market data (test_instruments.py::TestCPIConventions, TestGetCpiLevel)
# --------------------------------------------------------------------------


class TestCPIConventions:
    def test_besa_bracket_and_shift_months(self):
        for d in (dt.date(2025, 7, 15), dt.date(2025, 7, 1), dt.date(2024, 1, 31), dt.date(2026, 3, 2)):
            for lag in (3, 4):
                assert port_md.besa_bracket(d, lag) == jax_md.besa_bracket(d, lag)
        assert port_md.besa_bracket(dt.date(2025, 7, 15)) == (dt.date(2025, 3, 1), dt.date(2025, 4, 1))
        assert port_md.besa_bracket(dt.date(2025, 7, 1)) == (dt.date(2025, 3, 1),) * 2
        for k in (-13, -1, 0, 5, 30):
            assert port_md.shift_months(dt.date(2025, 1, 15), k) == jax_md.shift_months(dt.date(2025, 1, 15), k)
        assert port_md.first_of_month(VAL) == dt.date(2025, 7, 1)

    def test_publication_interp(self):
        fix = {dt.date(2025, 3, 1): 100.0, dt.date(2025, 4, 1): 103.1}
        p, j = _both(lambda k: k.md.CPIPublication(fix))
        for d in (dt.date(2025, 7, 16), dt.date(2025, 7, 1), dt.date(2025, 7, 31)):
            assert p.published_cpi(d) == j.published_cpi(d)
        assert p.published_cpi(dt.date(2025, 7, 16)) == pytest.approx(100.0 + (15 / 31) * 3.1)

    def test_historical_cpi_extension(self):
        df = lambda d: np.exp(-0.06 * (d - VAL).days / 365.0)
        p, j = _both(lambda k: k.md.HistoricalCPI(VAL, {dt.date(2025, 6, 1): 100.0},
                                                  discount_factor_fn=df, extend_cpi=24))
        assert p.monthly_cpi == j.monthly_cpi
        assert p.monthly_cpi[dt.date(2026, 6, 1)] == pytest.approx(100.0 * np.exp(0.06), rel=5e-3)
        assert p.cpi_value(dt.date(2027, 12, 15)) == j.cpi_value(dt.date(2027, 12, 15))
        assert p.monthly_cpi == j.monthly_cpi

    def test_on_demand_extension_continues_the_same_ladder(self):
        df = lambda d: np.exp(-(0.02 + 0.08 * min((d - VAL).days / 3650.0, 1.0)) * (d - VAL).days / 365.0)
        short = port_md.HistoricalCPI(VAL, {dt.date(2025, 6, 1): 100.0}, discount_factor_fn=df, extend_cpi=3)
        full = port_md.HistoricalCPI(VAL, {dt.date(2025, 6, 1): 100.0}, discount_factor_fn=df, extend_cpi=60)
        probe = dt.date(2029, 8, 15)
        assert short.cpi_value(probe) == pytest.approx(full.cpi_value(probe), rel=1e-12)
        for m, v in short.monthly_cpi.items():
            assert v == pytest.approx(full.monthly_cpi[m], rel=1e-12), m
        jshort = jax_md.HistoricalCPI(VAL, {dt.date(2025, 6, 1): 100.0}, discount_factor_fn=df, extend_cpi=3)
        assert jshort.cpi_value(probe) == short.cpi_value(probe)

    def test_table_input_without_pandas(self):
        """A table with Date and Value columns (here a dict of columns with
        a ``columns`` attribute, the duck type of a DataFrame) gives the
        same map as JAX's DataFrame path."""
        import pandas as pd

        dates = [dt.date(2025, 3, 1), "2025-04-01", np.datetime64("2025-05-01")]
        frame = pd.DataFrame({"Date": dates, "Value": [100.0, 100.5, 101.2]})

        class Table(dict):
            columns = ("Date", "Value")

        table = Table(Date=dates, Value=[100.0, 100.5, 101.2])
        want = jax_md.HistoricalCPI(VAL, frame).monthly_cpi
        assert port_md.HistoricalCPI(VAL, table).monthly_cpi == want
        assert port_md.HistoricalCPI(VAL, frame).monthly_cpi == want

    def test_cpi_term_structure(self):
        hist = {port_md.shift_months(dt.date(2025, 7, 1), -k): 100.0 + 0.4 * (10 - k) for k in range(10)}
        quotes = [(dt.date(2026, 7, 28), 4.5), (dt.date(2028, 7, 28), 4.8), (dt.date(2030, 7, 28), 5.1)]
        p, j = _both(lambda k: k.md.CPITermStructure(hist, quotes, VAL))
        for d in (dt.date(2025, 5, 15), dt.date(2025, 9, 1), dt.date(2027, 1, 20), dt.date(2032, 2, 2)):
            assert p.cpi(d) == j.cpi(d)
            assert p.zero_rate(d) == j.zero_rate(d)
            assert p.index_ratio(d, dt.date(2025, 6, 1)) == j.index_ratio(d, dt.date(2025, 6, 1))


class TestGetCpiLevel:
    def _curve(self, pkg, n):
        return pkg.md.YieldCurve(INST_TENORS, np.full((n, INST_TENORS.size), 0.05))

    def test_riskflow_projection_from_anchor(self):
        ref = dt.date(2026, 6, 1)
        p, j = _both(lambda k: k.inst.get_cpi_level(
            ref, VAL, {dt.date(2025, 6, 1): 100.0}, 4, inflation_rate_curve=self._curve(k, 4),
            last_pub_date=dt.date(2025, 6, 1)))
        np.testing.assert_array_equal(p, j)
        t = (ref - dt.date(2025, 6, 1)).days / 365.0
        np.testing.assert_allclose(p, 100.0 * np.exp(0.05 * t), rtol=1e-12)

    def test_published_requires_fixing(self):
        with pytest.raises(ValueError, match="Missing published CPI fixing"):
            port_inst.get_cpi_level(dt.date(2025, 5, 1), VAL, {}, 1, inflation_rate_curve=self._curve(PORT, 1),
                                    last_pub_date=dt.date(2025, 6, 1))

    def test_fixing_priority_and_unpublished_projection(self):
        fix = {dt.date(2025, 5, 1): np.array([101.0, 102.0])}
        p, j = _both(lambda k: k.inst.get_cpi_level(
            dt.date(2025, 5, 1), VAL, {dt.date(2025, 5, 1): 99.0}, 2, cpi_fixings=fix,
            inflation_rate_curve=self._curve(k, 2), last_pub_date=dt.date(2025, 6, 1)))
        np.testing.assert_array_equal(p, j)
        np.testing.assert_allclose(p, [101.0, 102.0])
        ref = dt.date(2025, 7, 1)
        fix = {ref: np.array([555.0]), dt.date(2025, 6, 1): np.array([100.0])}
        p, j = _both(lambda k: k.inst.get_cpi_level(
            ref, VAL, {}, 1, cpi_fixings=fix, inflation_rate_curve=self._curve(k, 1),
            last_pub_date=dt.date(2025, 6, 1)))
        np.testing.assert_array_equal(p, j)
        assert p[0] != 555.0 and 100.0 < p[0] < 101.0


# --------------------------------------------------------------------------
# the instruments on one market state (test_instruments.py)
# --------------------------------------------------------------------------


def _inst_ils(pkg, n_years=3):
    inst, md = pkg.inst, pkg.md
    hist = {md.shift_months(md.first_of_month(VAL), -k): 100.0 for k in range(0, 8)}
    return inst.IndexLinkedSwap(
        name="ils", effective_date=VAL, maturity_date=dt.date(VAL.year + n_years, VAL.month, VAL.day),
        notional=1_000_000,
        inflation_leg=inst.InflationLeg(real_rate=0.025, base_cpi=100.0, cpi_curve_name="CPI.ZA",
                                        frequency=6, inflation_rate_curve_name="INFL.ZA"),
        nominal_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=6, fixed_rate=0.08),
        discount_curve_name="ZAR-SWAP", inflation_index=hist,
    )


def _ils_state(pkg, n_paths=4, disc=0.08, infl=0.05, cpi_spot=100.0):
    from finite_difference_tpu.market_data.risk_factor import CurveSlice as JC, ScalarSlice as JS
    from finite_difference_tpu_torch.market_data.risk_factor import CurveSlice as PC, ScalarSlice as PS

    C, S = (PC, PS) if pkg is PORT else (JC, JS)
    return {
        "ZAR-SWAP": C(np.full((n_paths, INST_TENORS.size), disc), INST_TENORS),
        "INFL.ZA": C(np.full((n_paths, INST_TENORS.size), infl), INST_TENORS),
        "CPI.ZA": S(np.full(n_paths, cpi_spot)),
    }


class TestIndexLinkedSwap:
    def test_reference_dates_and_t_last_pub(self):
        p, j = _both(_inst_ils)
        assert p.get_cpi_reference_dates() == j.get_cpi_reference_dates()
        dates = [d for d, _ in p.get_cpi_reference_dates()]
        assert dates == sorted(dates) and len(set(dates)) == len(dates)
        for d in (VAL, dt.date(2026, 2, 14), dt.date(2027, 12, 1)):
            assert p.get_cpi_last_pub_date(d) == j.get_cpi_last_pub_date(d)
        assert p.get_cpi_last_pub_date(VAL) == dt.date(2025, 6, 1)

    @pytest.mark.parametrize("infl,receiver", [(0.05, True), (0.05, False), (0.03, True), (0.07, True)])
    def test_npvs_match_jax(self, infl, receiver):
        out = []
        for pkg in (PORT, JAX):
            ils = _inst_ils(pkg)
            ils.inflation_receiver = receiver
            out.append(ils.scenario_npvs(VAL, _ils_state(pkg, infl=infl)))
        np.testing.assert_array_equal(*out)
        assert np.isfinite(out[0]).all()

    def test_in_engine_with_cpi_stamping(self):
        n_times, n_paths = 8, 4
        dates = [VAL + dt.timedelta(days=91 * i) for i in range(n_times)]
        t_years = np.array([(d - VAL).days / 365.0 for d in dates])
        cpi = np.broadcast_to(100.0 * np.exp(0.05 * t_years)[:, None], (n_times, n_paths)).copy()
        cpi_bumped = cpi.copy()
        cpi_bumped[1, :] *= 1.02
        mtm = {}
        for name, cpi_arr in (("base", cpi), ("bumped", cpi_bumped)):
            def run(pkg):
                cube = pkg.sc.ScenarioCube(dates, {
                    "ZAR-SWAP": ("curve", np.full((n_times, n_paths, INST_TENORS.size), 0.08), INST_TENORS),
                    "INFL.ZA": ("curve", np.full((n_times, n_paths, INST_TENORS.size), 0.05), INST_TENORS),
                    "CPI.ZA": ("scalar", cpi_arr)})
                return pkg.ee.ExposureEngine(cube).compute(
                    pkg.pf.NettingSet("NS", [pkg.pf.Trade(_inst_ils(pkg, 1), "T")])).mtm
            mtm[name] = _both(run)
            np.testing.assert_array_equal(*mtm[name])
        base = mtm["base"][0]
        np.testing.assert_allclose(base, np.broadcast_to(base[:1, :], base.shape), rtol=1e-12)
        assert np.abs(mtm["bumped"][0][0, 2:] - base[0, 2:]).max() > 1e-6


def _inst_trs(pkg, scaling="Price", interest_scaling="Initial Price", spot_lag=0, mat=dt.date(2026, 7, 28)):
    inst = pkg.inst
    return inst.EquityTRS(
        name="trs", effective_date=VAL, maturity_date=mat, quantity=1000.0, notional=100_000.0,
        interest_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP", spread=0.01),
        spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
        discount_curve_name="ZAR-SWAP", initial_price=100.0, return_nominal_scaling=scaling,
        interest_nominal_scaling=interest_scaling, spot_lag=spot_lag,
    )


def _trs_state(pkg, n_paths=4, spot=100.0, r=0.07, q=0.02):
    from finite_difference_tpu.market_data.risk_factor import CurveSlice as JC, ScalarSlice as JS
    from finite_difference_tpu_torch.market_data.risk_factor import CurveSlice as PC, ScalarSlice as PS

    C, S = (PC, PS) if pkg is PORT else (JC, JS)
    return {
        "EQ.SPOT": S(np.full(n_paths, spot)),
        "ZAR-SWAP": C(np.full((n_paths, INST_TENORS.size), r), INST_TENORS),
        "EQ.DIV": C(np.full((n_paths, INST_TENORS.size), q), INST_TENORS),
    }


class TestEquityForward:
    def test_cost_of_carry_and_anchor(self):
        spot = np.array([100.0, 200.0])
        for t0 in (0.0, 0.5):
            p, j = _both(lambda k: k.inst.equity_forward_price(
                spot, k.md.YieldCurve(INST_TENORS, np.full((2, INST_TENORS.size), 0.06)),
                k.md.YieldCurve(INST_TENORS, np.full((2, INST_TENORS.size), 0.02)), 1.0, t0=t0))
            for a, b in zip(p, j):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(p[0], spot * np.exp(0.04 * 0.5), rtol=1e-12)


class TestEquityTRS:
    def test_schedules_and_resets_match_jax(self):
        p, j = _both(_inst_trs)
        assert p.return_schedule == j.return_schedule and p.interest_schedule == j.interest_schedule
        assert p.get_equity_reset_schedule() == j.get_equity_reset_schedule()
        assert p.get_reset_dates() == j.get_reset_dates()
        for val in (VAL, VAL + dt.timedelta(days=120)):
            assert (port_inst.filter_future_periods(p.return_schedule, val)
                    == jax_inst.filter_future_periods(j.return_schedule, val))
        starts = {s for s, _, _, _ in p.return_schedule} | {e for _, e, _, _ in p.return_schedule}
        assert starts <= set(p.get_equity_reset_schedule())

    @pytest.mark.parametrize("case", ["price", "initial_price", "payer", "price_interest", "spot_lag"])
    def test_npvs_match_jax(self, case):
        kw = {"initial_price": dict(scaling="Initial Price"), "price_interest": dict(interest_scaling="Price"),
              "spot_lag": dict(spot_lag=3)}.get(case, {})
        out = []
        for pkg in (PORT, JAX):
            trs = _inst_trs(pkg, **kw)
            trs.is_receiver = case != "payer"
            out.append([trs.scenario_npvs(v, _trs_state(pkg, spot=s))
                        for v in (VAL, VAL + dt.timedelta(days=100)) for s in (100.0, 110.0)])
        for a, b in zip(*out):
            assert _rel(a, b) <= 1e-12
        assert (out[0][1] > out[0][0]).all() == (case != "payer")  # the return leg tracks the spot

    def test_price_vs_initial_price_single_period(self):
        def npv(scaling):
            return _inst_trs(PORT, scaling, mat=dt.date(2025, 10, 28)).scenario_npvs(VAL, _trs_state(PORT))
        np.testing.assert_allclose(npv("Price"), npv("Initial Price"), rtol=1e-9)

    def test_in_engine_stamps_equity_fixings(self):
        n_times, n_paths = 10, 8
        dates = [VAL + dt.timedelta(days=45 * i) for i in range(n_times)]
        spot = 100.0 * np.exp(np.cumsum(np.random.default_rng(1).normal(0, 0.05, (n_times, n_paths)), axis=0))

        def run(pkg):
            cube = pkg.sc.ScenarioCube(dates, {
                "EQ.SPOT": ("scalar", spot),
                "ZAR-SWAP": ("curve", np.full((n_times, n_paths, INST_TENORS.size), 0.07), INST_TENORS),
                "EQ.DIV": ("curve", np.full((n_times, n_paths, INST_TENORS.size), 0.02), INST_TENORS)})
            trs = _inst_trs(pkg, mat=dates[-2])
            return pkg.ee.ExposureEngine(cube).compute(pkg.pf.NettingSet("NS", [pkg.pf.Trade(trs, "T")])).mtm
        p, j = _both(run)
        assert _rel(p, j) <= 1e-12 and np.isfinite(p).all() and p[:, 5].std() > 0


class TestCommodityInstruments:
    def _cube(self, pkg, n_times=8, n_paths=6):
        dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
        fwd_tenors = np.array([0.0, 0.5, 1.0, 2.0])
        fwd = np.broadcast_to((100.0 + np.arange(n_times))[:, None, None],
                              (n_times, n_paths, fwd_tenors.size)).copy()
        return pkg.sc.ScenarioCube(dates, {"FWD.OIL": ("curve", fwd, fwd_tenors),
                                           "ZAR-SWAP": ("curve", np.full((n_times, n_paths, INST_TENORS.size), 0.06),
                                                        INST_TENORS)})

    def test_forward_instrument_stamps_fixing(self):
        def run(pkg):
            cube = self._cube(pkg)
            inst = pkg.inst.CommodityForwardInstrument(
                "fwd", delivery_date=cube.dates[3], strike=100.0, notional=1.0,
                forward_curve_name="FWD.OIL", discount_curve_name="ZAR-SWAP")
            return pkg.ee.ExposureEngine(cube).compute(pkg.pf.NettingSet("NS", [pkg.pf.Trade(inst, "T")])).mtm
        p, j = _both(run)
        np.testing.assert_array_equal(p, j)
        np.testing.assert_allclose(p[:, 4:], 0.0)
        assert p[0, 3] == pytest.approx(3.0, rel=1e-6)

    def test_average_forward_uses_stamped_history(self):
        def run(pkg):
            cube = self._cube(pkg)
            inst = pkg.inst.CommodityAverageForwardInstrument(
                "avg", averaging_dates=cube.dates[2:5], payment_date=cube.dates[5], strike=100.0,
                notional=1.0, forward_curve_name="FWD.OIL", discount_curve_name="ZAR-SWAP")
            return pkg.ee.ExposureEngine(cube).compute(pkg.pf.NettingSet("NS", [pkg.pf.Trade(inst, "T")])).mtm
        p, j = _both(run)
        np.testing.assert_array_equal(p, j)
        assert p[0, 5] == pytest.approx(3.0, rel=1e-6)
        np.testing.assert_allclose(p[:, 6:], 0.0)


# --------------------------------------------------------------------------
# the families on both engines of both packages (test_device_exposure.py)
# --------------------------------------------------------------------------


def _engines(pkg, dates, curves, scalars, make_trades, csa=None, generic=True):
    """(generic profile or None, device profile) of one package."""
    trades = make_trades(pkg)
    factors = {k: ("curve", v, TENORS) for k, v in curves.items()}
    factors.update({k: ("scalar", v) for k, v in scalars.items()})
    gen = None
    if generic:
        ns = pkg.pf.NettingSet("NS", [pkg.pf.Trade(t, f"T{i}") for i, t in enumerate(trades)],
                               csa=csa(pkg) if csa else None)
        gen = pkg.ee.ExposureEngine(pkg.sc.ScenarioCube(dates, factors)).compute(ns)
    dev = pkg.dx.DeviceExposureEngine(dates, curves, TENORS, scalars=scalars, **pkg.kw).compute(
        trades, csa=csa(pkg) if csa else None)
    return gen, dev


def _hold(dates, curves, scalars, make_trades, csa=None, rtol=1e-10, atol=1e-5, fields=("mtm",),
          device_collateral_vs_jax=1e-12):
    """Port = JAX (1e-12 of max|value|) on both engines, and the port's
    device engine = its generic engine at JAX's gate (rtol, atol).
    ``device_collateral_vs_jax``: the device engines' collateral and
    exposure, port against JAX, where a SIMM margin amplifies their MTMs'
    last-bit differences (see ``SIMM_VS_JAX``)."""
    (pg, pd), (jg, jd) = _both(lambda k: _engines(k, dates, curves, scalars, make_trades, csa))
    for f in fields:
        assert _rel(getattr(pg, f), getattr(jg, f)) <= 1e-12, f"generic {f}"
        tol = 1e-12 if f == "mtm" else device_collateral_vs_jax
        assert _rel(getattr(pd, f), getattr(jd, f)) <= tol, f"device {f}: {_rel(getattr(pd, f), getattr(jd, f)):.3e}"
        np.testing.assert_allclose(getattr(pd, f), getattr(pg, f), rtol=rtol, atol=atol, err_msg=f)
    return pg, pd


def _trs_market(n_times=26, n_paths=16, seed=3):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    t = np.arange(n_times)[:, None, None]
    swap = 0.075 + 0.0005 * t + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    div = np.full((n_times, n_paths, TENORS.size), 0.02)
    eq = 100.0 * np.exp(rng.normal(0.002, 0.05, (n_times, n_paths)).cumsum(axis=0))
    return dates, {"ZAR-SWAP": swap, "EQ.DIV": div}, {"EQ.SPOT": eq}


def _trs(pkg, scaling="Price", lag=0, receiver=True, effective=VAL, maturity=dt.date(2027, 7, 28),
         interest_scaling="Initial Price", schedule_config=None):
    inst = pkg.inst
    trs = inst.EquityTRS(
        name="trs", effective_date=effective, maturity_date=maturity, quantity=1000.0, notional=100_000.0,
        interest_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP", spread=0.01),
        spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
        discount_curve_name="ZAR-SWAP", initial_price=100.0, return_nominal_scaling=scaling,
        spot_lag=lag, is_receiver=receiver, schedule_config=schedule_config,
    )
    trs.interest_nominal_scaling = interest_scaling
    return trs


TRS_CASES = {
    "price": {}, "initial_price": dict(scaling="Initial Price"), "payer": dict(receiver=False),
    "spot_lag": dict(lag=3), "price_interest": dict(interest_scaling="Price"),
    "price_interest_seasoned": dict(interest_scaling="Price", effective=VAL - dt.timedelta(days=100)),
    "in_flight_price": dict(effective=VAL - dt.timedelta(days=100), maturity=dt.date(2026, 4, 19)),
    "in_flight_initial_price": dict(effective=VAL - dt.timedelta(days=100), maturity=dt.date(2026, 4, 19),
                                    scaling="Initial Price"),
}


class TestDeviceTRS:
    @pytest.mark.parametrize("case", list(TRS_CASES))
    def test_matches_generic_and_jax(self, case):
        dates, curves, scalars = _trs_market()
        _hold(dates, curves, scalars, lambda k: [_trs(k, **TRS_CASES[case])])

    def test_payment_lag_outstanding_after_maturity(self):
        dates, curves, scalars = _trs_market()
        make = lambda k: [_trs(k, maturity=dates[20], schedule_config=k.inst.ScheduleConfig(payment_lag_days=10))]
        trs = make(PORT)[0]
        assert trs._effective_maturity > dates[20]
        gen, _ = _hold(dates, curves, scalars, make)
        window = [i for i, d in enumerate(dates) if dates[20] <= d <= trs._effective_maturity]
        assert window and np.any(np.abs(gen.mtm[:, window]) > 1e-6)

    def test_leg_tensors_keep_masks_and_indices(self):
        dates, curves, scalars = _trs_market(n_times=8, n_paths=4)
        eng = port_dx.DeviceExposureEngine(dates, curves, TENORS, scalars=scalars, device="cpu")
        trs = _trs(PORT, interest_scaling="Price", effective=VAL - dt.timedelta(days=100))
        legs, _ = port_dx._legs_for((trs,), eng.dates, TENORS, torch.device("cpu"), torch.float64)
        ret, interest = legs
        for f in ("live", "first_live", "start_future", "end_future"):
            assert getattr(ret, f).dtype == torch.bool, f
        for f in ("s_row0", "s_row1", "e_row0", "e_row1"):
            assert getattr(ret, f).dtype == torch.int64, f
        assert interest.eq_stamped.dtype == torch.bool and interest.eq_row0.dtype == torch.int64
        assert ret.W_disc.dtype == torch.float64 and ret.t0.dtype == torch.float64


def _ils(pkg, n_years=3, receiver=True, pay_notional=True, legacy=False):
    inst, md = pkg.inst, pkg.md
    hist = {md.shift_months(md.first_of_month(VAL), -k): 100.0 + 0.3 * (8 - k) for k in range(0, 9)}
    return inst.IndexLinkedSwap(
        name="ils", effective_date=VAL, maturity_date=dt.date(VAL.year + n_years, VAL.month, VAL.day),
        notional=1_000_000,
        inflation_leg=inst.InflationLeg(
            real_rate=0.025, base_cpi=100.0, cpi_curve_name="CPI.ZA", frequency=6,
            inflation_rate_curve_name="" if legacy else "INFL.ZA", pay_notional_at_maturity=pay_notional),
        nominal_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=6, fixed_rate=0.08),
        discount_curve_name="ZAR-SWAP", inflation_index=hist, inflation_receiver=receiver,
    )


def _ils_market(n_times=40, n_paths=16, seed=5, legacy=False):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    swap = 0.078 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    if legacy:
        base = 102.4 * np.exp(0.004 * np.arange(n_times)[:, None]
                              + rng.normal(0, 0.002, (n_times, n_paths)).cumsum(axis=0))
        return dates, {"ZAR-SWAP": swap, "CPI.ZA": base[:, :, None] * np.exp(0.05 * TENORS)[None, None, :]}, {}
    infl = 0.05 + rng.normal(0, 0.001, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    cpi = 102.4 * np.exp(0.004 * np.arange(n_times)[:, None] + rng.normal(0, 0.002, (n_times, n_paths)).cumsum(axis=0))
    return dates, {"ZAR-SWAP": swap, "INFL.ZA": infl}, {"CPI.ZA": cpi}


class TestDeviceILS:
    @pytest.mark.parametrize("case", ["riskflow", "payer_no_notional", "legacy"])
    def test_matches_generic_and_jax(self, case):
        kw = {"payer_no_notional": dict(receiver=False, pay_notional=False), "legacy": dict(legacy=True)}
        dates, curves, scalars = _ils_market(legacy=case == "legacy")
        _hold(dates, curves, scalars, lambda k: [_ils(k, **kw.get(case, {}))])

    def test_leg_tensors_keep_masks_and_indices(self):
        dates, curves, scalars = _ils_market(n_times=12, n_paths=4)
        legs, _ = port_dx._legs_for((_ils(PORT),), dates, TENORS, torch.device("cpu"), torch.float64)
        infl = legs[0]
        for f in ("live", "is_last_pay", "ref_hist", "pub_mask"):
            assert getattr(infl, f).dtype == torch.bool, f
        for f in ("ref_row0", "ref_row1", "anchor_idx", "j_idx", "j1_idx"):
            assert getattr(infl, f).dtype == torch.int64, f


def _commodity_market(n_times=20, n_paths=16, seed=11):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=14 * i) for i in range(n_times)]
    swap = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    fwd = 70.0 * np.exp(rng.normal(0.001, 0.02, (n_times, n_paths, TENORS.size)).cumsum(axis=0))
    return dates, {"ZAR-SWAP": swap, "BRENT": fwd}


def _swap(pkg, n_years=1, fixed_rate=0.08, ois=False):
    inst = pkg.inst
    return inst.IRSwap(
        name="irs", effective_date=VAL, maturity_date=dt.date(VAL.year + n_years, VAL.month, VAL.day),
        notional=1_000_000,
        receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP",
                                 overnight_compounding=ois),
        pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=3, fixed_rate=fixed_rate),
        discount_curve_name="ZAR-SWAP",
    )


def _commodity(pkg, kind):
    inst = pkg.inst
    if kind == "forward":
        return inst.CommodityForwardInstrument(
            "cf", delivery_date=VAL + dt.timedelta(days=180), strike=72.0, notional=1000.0,
            forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP", pricing_lag_days=2)
    if kind == "average":
        return inst.CommodityAverageForwardInstrument(
            "caf", averaging_dates=[VAL + dt.timedelta(days=30 * k) for k in range(1, 7)],
            payment_date=VAL + dt.timedelta(days=200), strike=71.0, notional=500.0,
            forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP", pricing_lag_days=1)
    return inst.CommodityForwardInstrument(
        "cf", delivery_date=VAL + dt.timedelta(days=150), strike=70.0, notional=1000.0,
        forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP")


class TestDeviceCommodity:
    @pytest.mark.parametrize("kind", ["forward", "average"])
    def test_matches_generic_and_jax(self, kind):
        dates, curves = _commodity_market()
        _hold(dates, curves, {}, lambda k: [_commodity(k, kind)], atol=1e-8)

    def test_mixed_netting_with_swap(self):
        dates, curves = _commodity_market(n_times=28)
        _hold(dates, curves, {}, lambda k: [_commodity(k, "mixed"), _swap(k)], atol=1e-6)

    def test_forward_closeout_moves_live_reads_only(self):
        """FORWARD close-out on a commodity forward discounted on the curve
        it projects from: the live forward and the discounting move to the
        risky curve, the stamped fixings keep the base curve — on both
        engines of both packages."""
        dates, curves = _commodity_market(n_times=20, n_paths=8)
        curves = {"BRENT": curves["BRENT"], "RISKY": curves["BRENT"] * 1.01}

        def make(pkg):
            return [pkg.inst.CommodityForwardInstrument(
                "cf", delivery_date=VAL + dt.timedelta(days=150), strike=70.0, notional=1000.0,
                forward_curve_name="BRENT", discount_curve_name="BRENT")]

        def csa(pkg):
            return pkg.pf.CSA(close_out_method=pkg.pf.CloseOutMethod.FORWARD, risky_curve_name="RISKY")
        gen, dev = _hold(dates, curves, {}, make, csa=csa, atol=1e-8)
        base = _engines(PORT, dates, curves, {}, make, generic=False)[1]
        assert np.abs(dev.mtm - base.mtm).max() > 1.0


# --------------------------------------------------------------------------
# SIMM: the aggregation (test_exposure_engine.py) and both engines
# --------------------------------------------------------------------------


class TestSimmAggregation:
    def test_ir_margin_matches_jax_and_hand_values(self):
        ws = np.zeros(12)
        ws[7] = -3.5
        assert float(port_simm.ir_delta_margin(ws)) == pytest.approx(3.5)
        ws[6], ws[8] = 2.0, 5.0
        rng = np.random.default_rng(0)
        for x in (ws, rng.normal(0, 3, (7, 12)), rng.normal(0, 3, (4, 5, 12))):
            assert _rel(port_simm.ir_delta_margin(x), jax_simm.ir_delta_margin(x)) <= 1e-12
        w2 = np.zeros(12)
        w2[6], w2[8] = 2.0, 5.0
        rho = port_simm.DEFAULT_SIMM.ir_corr()[6, 8]
        assert float(port_simm.ir_delta_margin(w2)) == pytest.approx(np.sqrt(29.0 + 20.0 * rho), rel=1e-12)

    def test_scalar_and_cross_class(self):
        k = port_simm.scalar_delta_margin([np.array(3.0), np.array(-4.0)], 0.24)
        assert float(k) == pytest.approx(np.sqrt(9 + 16 + 2 * 0.24 * -12.0))
        ws = np.zeros(12)
        ws[7] = 10.0
        im = port_simm.simm_im(ir_ws=ws, scalar_ws={"equity": [np.array(5.0)]})
        psi = port_simm.DEFAULT_SIMM.cross_class_corr[0][1]
        assert float(im) == pytest.approx(np.sqrt(100 + 25 + 2 * psi * 50.0), rel=1e-12)
        rng = np.random.default_rng(1)
        ir = rng.normal(0, 2, (6, 9, 12))
        scal = {"equity": [rng.normal(0, 1, (6, 9)), rng.normal(0, 1, (6, 9))], "fx": [rng.normal(0, 1, (6, 9))],
                "commodity": [rng.normal(0, 1, (6, 9))]}
        for ir_ws, sws in ((ir, scal), (None, scal), (ir, None), (None, {"fx": scal["fx"]})):
            got = port_simm.simm_im(ir_ws, sws)
            assert torch.is_tensor(got)
            assert _rel(got, jax_simm.simm_im(ir_ws, sws)) <= 1e-12
        # tensors in: the device and dtype of the sensitivities
        t = torch.as_tensor(ir)
        assert port_simm.simm_im(port_simm.weight_ir_sensitivities(t)).dtype == torch.float64
        assert _rel(port_simm.weight_ir_sensitivities(t), jax_simm.weight_ir_sensitivities(ir)) == 0.0

    def test_bucket_assignment_and_pathwise_shapes(self):
        np.testing.assert_array_equal(port_simm.assign_ir_buckets([0.25, 5.0, 30.0, 0.04]), [2, 7, 11, 0])
        np.testing.assert_array_equal(port_simm.assign_ir_buckets(TENORS), jax_simm.assign_ir_buckets(TENORS))
        ws = np.zeros((7, 12))
        ws[:, 3] = np.arange(7.0)
        np.testing.assert_allclose(port_simm.simm_im(ir_ws=ws).numpy(), np.arange(7.0))
        assert float(port_simm.simm_im()) == 0.0

    def test_review_hardening(self):
        assert port_simm.infer_scalar_class("USDZAR") == "fx"
        assert port_simm.infer_scalar_class("eurusd") == "fx"
        assert port_simm.infer_scalar_class("EQ.SPOT") == "equity"
        assert port_simm.infer_scalar_class("COPPER") == "equity"
        for name in ("BRENT.OIL", "GOLD", "fxvol", "XYZ"):
            assert port_simm.infer_scalar_class(name) == jax_simm.infer_scalar_class(name)
        with pytest.raises(ValueError, match="no scalar risk weight"):
            port_simm.SimmConfig(factor_classes={"EQ.SPOT": "interest_rate"}).scalar_class("EQ.SPOT")
        with pytest.raises(ValueError, match="ir_ws"):
            port_simm.simm_im(None, {"interest_rate": [np.ones(3)]})


def _flat_cube(pkg, n_times=6, n_paths=8, rate=0.07, names=("ZAR-SWAP",)):
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    tenors = np.array([0.25, 1.0, 2.0, 5.0, 10.0])
    factors = {n: ("curve", np.full((n_times, n_paths, tenors.size), rate), tenors) for n in names}
    return pkg.sc.ScenarioCube(dates, factors), tenors


def _simm_minus_none(pkg, trades, cube, **simm_kw):
    csa = pkg.pf.CSA(mpor_days=0, im_method=pkg.pf.InitialMarginMethod.SIMM, **simm_kw)
    none = pkg.pf.CSA(mpor_days=0, im_method=pkg.pf.InitialMarginMethod.NONE)
    prof = [pkg.ee.ExposureEngine(cube).compute(pkg.pf.NettingSet("NS", trades, csa=c)) for c in (csa, none)]
    return prof[0].collateral - prof[1].collateral


class TestSimmEngine:
    """SIMM IM through the generic engine's pricing pass, both packages."""

    @staticmethod
    def _linear(pkg, name, factor, node, scale, maturity):
        class CurveLinear(pkg.Instrument):
            def __init__(self):
                super().__init__(name)
                self.maturity_date = maturity

            def scenario_npvs(self, val_date, market_state, fixings=None, rng=None):
                return scale * market_state[factor].values[:, node]
        return CurveLinear()

    def test_linear_instrument_exact_pv01(self):
        def im(pkg):
            cube, tenors = _flat_cube(pkg, n_times=2)
            return _simm_minus_none(pkg, [pkg.pf.Trade(self._linear(pkg, "lin", "ZAR-SWAP", 4, 2.0e6,
                                                                    cube.dates[-1]), "T1")], cube)
        p, j = _both(im)
        assert _rel(p, j) <= 1e-12
        bucket = int(port_simm.assign_ir_buckets(np.array([0.25, 1.0, 2.0, 5.0, 10.0]))[4])
        np.testing.assert_allclose(p[:, 0], port_simm.DEFAULT_SIMM.ir_risk_weights[bucket] * 2.0e6 * 1e-4,
                                   rtol=1e-9)

    def test_im_scales_with_notional(self):
        def im(pkg, scale):
            cube, _ = _flat_cube(pkg, n_times=3)
            swap = pkg.inst.IRSwap(
                name="irs", effective_date=VAL, maturity_date=cube.dates[-1], notional=1e6,
                receive_leg=pkg.inst.SwapLeg(pkg.inst.LegType.FLOATING, frequency=1, curve_name="ZAR-SWAP"),
                pay_leg=pkg.inst.SwapLeg(pkg.inst.LegType.FIXED, frequency=1, fixed_rate=0.075),
                discount_curve_name="ZAR-SWAP")
            return _simm_minus_none(pkg, [pkg.pf.Trade(swap, "T1", notional_scale=scale)], cube)
        im1, im2 = im(PORT, 1.0), im(PORT, 2.0)
        assert im1[0, 0] > 0.0
        np.testing.assert_allclose(im2, 2.0 * im1, rtol=1e-9)
        assert _rel(im1, im(JAX, 1.0)) <= 1e-12

    def test_scalar_factor_class_and_netting(self):
        def im(pkg, ws):
            dates = [VAL + dt.timedelta(days=30 * i) for i in range(2)]
            cube = pkg.sc.ScenarioCube(dates, {"EQ-SPOT": ("scalar", np.full((2, 4), 150.0))})

            class SpotLinear(pkg.Instrument):
                def __init__(self, name, w):
                    super().__init__(name)
                    self.w, self.maturity_date = w, dates[-1]

                def scenario_npvs(self, val_date, market_state, fixings=None, rng=None):
                    return self.w * market_state["EQ-SPOT"].values
            return _simm_minus_none(pkg, [pkg.pf.Trade(SpotLinear(f"e{i}", w), f"T{i}")
                                          for i, w in enumerate(ws)], cube)
        p, j = _both(lambda k: im(k, [100.0]))
        assert _rel(p, j) <= 1e-12
        np.testing.assert_allclose(p[:, 0], port_simm.DEFAULT_SIMM.scalar_risk_weights["equity"] * 150.0, rtol=1e-9)
        np.testing.assert_allclose(im(PORT, [100.0, -100.0]), 0.0, atol=1e-12)

    def test_factor_restriction_and_state_independent_trade(self):
        cube, _ = _flat_cube(PORT, n_times=2, names=("ZAR-SWAP", "OTHER"))
        inst = self._linear(PORT, "lin", "ZAR-SWAP", 2, 1e6, cube.dates[-1])
        im = _simm_minus_none(PORT, [port_pf.Trade(inst, "T1")], cube,
                              simm_config=port_simm.SimmConfig(factors=("OTHER",)))
        np.testing.assert_allclose(im, 0.0, atol=1e-12)
        # a state-independent NPV has zero sensitivities -> zero SIMM IM
        const = self._linear(PORT, "c", "ZAR-SWAP", 0, 0.0, cube.dates[-1])
        np.testing.assert_allclose(_simm_minus_none(PORT, [port_pf.Trade(const, "T1")], cube), 0.0)


# the device SIMM margins, port against JAX: each sensitivity is a 1bp
# difference of two netting MTMs that agree to ~4e-15 relative, so the
# margin carries that gap times |MTM| / |dMTM| (~1e3 here; the reason JAX
# holds its two engines' SIMM at 1e-7). Measured 3.7e-11 of max|collateral|.
SIMM_VS_JAX = 1e-9


def _simm_csa(pkg, **kw):
    return pkg.pf.CSA(mpor_days=10, vm_threshold=500.0, vm_threshold_post=800.0,
                      im_method=pkg.pf.InitialMarginMethod.SIMM, **kw)


def test_device_csa_simm_matches_generic():
    """The SIMM case of JAX's test_device_csa_initial_margin_matches_generic."""
    rng = np.random.default_rng(4)
    n_times, n_paths = 14, 16
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    t = np.arange(n_times)[:, None, None]
    curves = {"ZAR-SWAP": 0.075 + 0.0005 * t + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)}
    csa = lambda k: k.pf.CSA(mpor_days=10, vm_threshold=500.0, vm_threshold_post=800.0,
                             im_method=k.pf.InitialMarginMethod.SIMM, im_amount=2500.0)
    gen, dev = _hold(dates, curves, {}, lambda k: [_swap(k)], csa=csa, rtol=1e-7, atol=1e-6,
                     fields=("mtm", "collateral", "exposure"), device_collateral_vs_jax=SIMM_VS_JAX)
    assert np.abs(dev.collateral).max() > 0


def _simm_market(seed=11, n_times=14, n_paths=12):
    rng = np.random.default_rng(seed)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    swap = 0.075 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
    div = np.full((n_times, n_paths, TENORS.size), 0.02)
    eq = 100.0 * np.exp(rng.normal(0.002, 0.05, (n_times, n_paths)).cumsum(axis=0))
    return dates, {"ZAR-SWAP": swap, "EQ.DIV": div}, {"EQ.SPOT": eq}


def test_device_simm_mixed_factors_matches_generic():
    """SIMM on the device over a curve factor and an equity scalar, with a
    seasoned TRS whose stamped spot fixings must stay at base under the
    equity bump."""
    dates, curves, scalars = _simm_market()
    make = lambda k: [_swap(k), _trs(k, effective=VAL - dt.timedelta(days=100), maturity=dt.date(2026, 6, 28))]
    gen, dev = _hold(dates, curves, scalars, make, csa=_simm_csa, rtol=1e-7, atol=1e-6,
                     fields=("mtm", "collateral", "exposure"), device_collateral_vs_jax=SIMM_VS_JAX)
    assert np.abs(dev.collateral).max() > 0


def test_simm_leaves_the_cached_legs_alone():
    """The SIMM pass pins stamped reads onto '#base' aliases in copies of
    the cached legs: a plain MTM after a SIMM call equals the one before
    it bit for bit, and the cached legs keep their own names."""
    dates, curves, scalars = _simm_market(n_times=10, n_paths=6)
    trades = [_swap(PORT), _trs(PORT, effective=VAL - dt.timedelta(days=100), maturity=dt.date(2026, 4, 28)),
              _trs(PORT, interest_scaling="Price", maturity=dt.date(2026, 4, 28))]
    eng = port_dx.DeviceExposureEngine(dates, curves, TENORS, scalars=scalars, device="cpu")
    before = eng.mtm(trades)
    legs, _ = port_dx._legs_for(tuple(trades), dates, TENORS, torch.device("cpu"), torch.float64)
    eng.compute(trades, csa=_simm_csa(PORT))
    assert eng.simm_runs == 1 + 7 * 2 + 1  # base, 7 buckets x 2 curves, the equity spot
    again, _ = port_dx._legs_for(tuple(trades), dates, TENORS, torch.device("cpu"), torch.float64)
    assert again is legs
    assert not any(isinstance(v, str) and v.endswith("#base") for leg in legs for v in vars(leg).values())
    assert torch.equal(eng.mtm(trades), before)


class TestDeviceFuzz:
    def test_random_simm_netting_sets_match_generic(self):
        """JAX's fuzz of the device SIMM path (seed 41, six trials of a
        random swap + TRS under a SIMM CSA): the port's device collateral
        and exposure = its generic engine's at the 1e-7 noise floor, and
        the generic engine = JAX's."""
        rng = np.random.default_rng(41)
        n_times, n_paths = 10, 6
        dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
        swap_arr = 0.073 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        div = np.full((n_times, n_paths, TENORS.size), 0.02)
        eq = 100.0 * np.exp(rng.normal(0.002, 0.04, (n_times, n_paths)).cumsum(axis=0))
        curves, scalars = {"ZAR-SWAP": swap_arr, "EQ.DIV": div}, {"EQ.SPOT": eq}
        csa = lambda k: k.pf.CSA(mpor_days=10, vm_threshold=300.0, vm_threshold_post=500.0,
                                 im_method=k.pf.InitialMarginMethod.SIMM)
        n_checked = 0
        for trial in range(6):
            freq = int(rng.choice([3, 6]))
            eff = VAL + dt.timedelta(days=int(rng.integers(-200, 60)))
            mat = min(eff + dt.timedelta(days=int(rng.integers(200, 400))), dates[-1])
            if mat <= max(eff, dates[0]):
                continue
            notional = float(rng.uniform(2e5, 2e6))
            spread = float(rng.uniform(-0.005, 0.01))
            fixed = float(rng.uniform(0.06, 0.09))
            trs_eff = VAL + dt.timedelta(days=int(rng.integers(-90, 30)))
            qty = float(rng.uniform(100, 2000))
            scaling = str(rng.choice(["Price", "Initial Price"]))

            def make(pkg):
                inst = pkg.inst
                swap = inst.IRSwap(
                    name=f"s{trial}", effective_date=eff, maturity_date=mat, notional=notional,
                    receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=freq, curve_name="ZAR-SWAP",
                                             spread=spread),
                    pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=freq, fixed_rate=fixed),
                    discount_curve_name="ZAR-SWAP")
                trs = inst.EquityTRS(
                    name=f"t{trial}", effective_date=trs_eff, maturity_date=dates[-1], quantity=qty,
                    notional=100_000.0,
                    interest_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP",
                                              spread=0.01),
                    spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
                    discount_curve_name="ZAR-SWAP", initial_price=100.0, return_nominal_scaling=scaling)
                return [swap, trs]

            pg, pd = _engines(PORT, dates, curves, scalars, make, csa=csa)
            jg, _ = _engines(JAX, dates, curves, scalars, make, csa=csa)
            for f in ("collateral", "exposure"):
                assert _rel(getattr(pg, f), getattr(jg, f)) <= 1e-12, f"trial {trial} {f}"
                np.testing.assert_allclose(getattr(pd, f), getattr(pg, f), rtol=1e-7, atol=1e-6,
                                           err_msg=f"trial {trial}: freq={freq} eff={eff} mat={mat}")
            n_checked += 1
        assert n_checked >= 3

    def test_random_mixed_families_match_generic(self):
        """JAX's fuzz across families (seed 31, four trials of a swap, a
        commodity average forward and a surface exotic): the port's device
        MTM = its generic engine's, and = JAX's device MTM."""
        rng = np.random.default_rng(31)
        n_times, n_paths = 18, 8
        dates = [VAL + dt.timedelta(days=14 * i) for i in range(n_times)]
        t = np.arange(n_times)[:, None, None]
        swap_arr = 0.07 + 0.0004 * t + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        oil = 70.0 * np.exp(rng.normal(0, 0.02, (n_times, n_paths, TENORS.size)).cumsum(axis=0))
        eq = 100.0 * np.exp(rng.normal(0, 0.04, (n_times, n_paths)).cumsum(axis=0))
        curves, scalars = {"ZAR-SWAP": swap_arr, "OIL": oil}, {"EQ.SPOT": eq}
        for trial in range(4):
            mat_days = int(rng.integers(90, 200))
            notional = float(rng.uniform(1e5, 1e6))
            ois = bool(rng.integers(0, 2))
            fixed = float(rng.uniform(0.05, 0.1))
            avg_days = sorted(rng.integers(10, mat_days, 4))
            strike = float(rng.uniform(65, 80))
            exotic_mat = dates[int(rng.integers(8, n_times - 1))]
            barrier = bool(rng.integers(0, 2))
            if barrier:
                btype = str(rng.choice(["up-and-out", "down-and-in"]))
                rebate = float(rng.choice([0.0, 2.0]))

            def make(pkg):
                inst = pkg.inst
                swap = inst.IRSwap(
                    name=f"s{trial}", effective_date=VAL, maturity_date=VAL + dt.timedelta(days=mat_days),
                    notional=notional,
                    receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP",
                                             overnight_compounding=ois),
                    pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=3, fixed_rate=fixed),
                    discount_curve_name="ZAR-SWAP")
                caf = inst.CommodityAverageForwardInstrument(
                    f"c{trial}", averaging_dates=[VAL + dt.timedelta(days=int(d)) for d in avg_days],
                    payment_date=VAL + dt.timedelta(days=mat_days), strike=strike, notional=500.0,
                    forward_curve_name="OIL", discount_curve_name="ZAR-SWAP")
                if barrier:
                    exo = inst.EquityBarrierOption(
                        f"b{trial}", "EQ.SPOT", 100.0, exotic_mat, 0.3, 0.06, monitor_dates=[dates[4], dates[7]],
                        barrier_type=btype, lower_barrier=85.0, upper_barrier=120.0, rebate=rebate,
                        quantity=100.0, n_time_steps=48, num_space_nodes=127, **pkg.kw)
                else:
                    exo = inst.AmericanOptionPosition(
                        f"a{trial}", "EQ.SPOT", 100.0, exotic_mat, 0.3, 0.06, quantity=10.0,
                        n_time_steps=48, num_space_nodes=127, **pkg.kw)
                return [swap, caf, exo]

            pg, pd = _engines(PORT, dates, curves, scalars, make)
            _, jd = _engines(JAX, dates, curves, scalars, make, generic=False)
            assert _rel(pd.mtm, jd.mtm) <= 1e-12, f"trial {trial}"
            np.testing.assert_allclose(pd.mtm, pg.mtm, rtol=1e-9, atol=1e-4, err_msg=f"trial {trial}")

    def test_random_swap_configs_match_generic(self):
        """JAX's fuzz of swap configurations (seed 21, 16 trials: random
        frequencies, spreads, fixing tenors, OIS and sub-period compounding,
        seasoned effective dates and maturities): the port's device MTM =
        its generic engine's at JAX's gate, and = JAX's device MTM."""
        rng = np.random.default_rng(21)
        n_times, n_paths = 20, 8
        dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
        t = np.arange(n_times)[:, None, None]
        cube_arr = 0.07 + 0.0004 * t + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        port_dev, jax_dev = _both(lambda k: k.dx.DeviceExposureEngine(dates, {"ZAR-SWAP": cube_arr}, TENORS,
                                                                       **k.kw))
        cube = port_sc.ScenarioCube(dates, {"ZAR-SWAP": ("curve", cube_arr, TENORS)})
        n_checked = 0
        for trial in range(16):
            freq = int(rng.choice([1, 3, 6, 12]))
            fixing = rng.choice([None, 1, 3, 6])
            fixing = None if fixing is None else int(fixing)
            spread = float(rng.uniform(-0.01, 0.02))
            eff = VAL + dt.timedelta(days=int(rng.integers(-400, 90)))
            mat = min(eff + dt.timedelta(days=int(rng.integers(360, 900))), dates[-1])
            if mat <= eff:
                continue
            kind = int(rng.integers(0, 3))  # simple forward, OIS, sub-period compounded
            ois = kind == 1
            reset_freq = 0
            if kind == 2:
                fixing = None
                sub = [s for s in (1, 3, 6) if s < freq]
                reset_freq = int(rng.choice(sub)) if sub else 0
            notional = float(rng.uniform(1e5, 5e6))
            fixed = float(rng.uniform(0.05, 0.1))

            def make(pkg):
                inst = pkg.inst
                return inst.IRSwap(
                    name=f"f{trial}", effective_date=eff, maturity_date=mat, notional=notional,
                    receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=freq, curve_name="ZAR-SWAP",
                                             spread=spread, fixing_tenor_months=None if ois else fixing,
                                             overnight_compounding=ois, reset_frequency_months=reset_freq),
                    pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=freq, fixed_rate=fixed),
                    discount_curve_name="ZAR-SWAP")

            swap = make(PORT)
            generic = port_ee.ExposureEngine(cube).compute(port_pf.NettingSet("NS", [port_pf.Trade(swap, "T")]))
            got = _np(port_dev.mtm([swap]))
            msg = f"trial {trial}: freq={freq} fixing={fixing} kind={kind} reset={reset_freq} eff={eff} mat={mat}"
            np.testing.assert_allclose(got, generic.mtm, rtol=1e-9, atol=1e-4, err_msg=msg)
            assert _rel(got, _np(jax_dev.mtm([make(JAX)]))) <= 1e-12, msg
            n_checked += 1
        assert n_checked >= 12

    def test_random_csa_space_matches_generic(self):
        """JAX's fuzz of the CSA space (seed 53, ten trials: MPOR, VM
        thresholds, IM none/fixed/schedule/SIMM, standard or forward
        close-out with a string or per-currency risky curve, over swaps,
        TRS and index-linked swaps whose windows overlap the cube's
        variously; the TRS initial-price case once went wrong in JAX): the
        port's device compute() = its generic engine's (mtm, collateral,
        exposure) at JAX's gates, and = JAX's device compute() (SIMM at
        ``SIMM_VS_JAX``)."""
        rng = np.random.default_rng(53)
        n_times, n_paths = 16, 6
        dates = [VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
        swap_arr = 0.073 + rng.normal(0, 0.002, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        infl = 0.05 + rng.normal(0, 0.001, (n_times, n_paths, TENORS.size)).cumsum(axis=0)
        eq = 100.0 * np.exp(rng.normal(0.001, 0.04, (n_times, n_paths)).cumsum(axis=0))
        cpi = 102.4 * np.exp(0.004 * np.arange(n_times)[:, None]
                             + rng.normal(0, 0.002, (n_times, n_paths)).cumsum(axis=0))
        curves = {"ZAR-SWAP": swap_arr, "ZAR-RISKY": swap_arr + 0.015, "USD-RISKY": swap_arr + 0.025,
                  "INFL.ZA": infl, "EQ.DIV": np.full((n_times, n_paths, TENORS.size), 0.02)}
        scalars = {"EQ.SPOT": eq, "CPI.ZA": cpi}
        factors = {**{k: ("curve", v, TENORS) for k, v in curves.items()},
                   **{k: ("scalar", v) for k, v in scalars.items()}}
        cube = port_sc.ScenarioCube(dates, factors)
        port_dev, jax_dev = _both(lambda k: k.dx.DeviceExposureEngine(dates, curves, TENORS, scalars=scalars,
                                                                       **k.kw))
        n_checked = 0
        for trial in range(10):
            swap_eff = VAL + dt.timedelta(days=int(rng.integers(-300, 60)))
            swap_mat = min(swap_eff + dt.timedelta(days=int(rng.integers(180, 700))), dates[-1])
            if swap_mat <= max(swap_eff, dates[0]):
                continue
            swap_kw = dict(notional=float(rng.uniform(2e5, 2e6)), freq=int(rng.choice([3, 6])),
                           spread=float(rng.uniform(-0.005, 0.01)), fixed=float(rng.uniform(0.06, 0.09)))
            trs_kw = None
            if rng.integers(0, 2):
                trs_kw = dict(eff=VAL + dt.timedelta(days=int(rng.integers(-200, 30))),
                              mat=dates[int(rng.integers(6, n_times))], qty=float(rng.uniform(100, 1500)),
                              scaling=str(rng.choice(["Price", "Initial Price"])))
            ils_kw = dict(pay=bool(rng.integers(0, 2)), receiver=bool(rng.integers(0, 2))) if rng.integers(0, 2) else None
            im = str(rng.choice(["none", "fixed", "schedule", "simm"]))
            close_out = str(rng.choice(["standard", "forward"]))
            risky = None
            if close_out == "forward":
                risky = {"ZAR": "ZAR-RISKY", "USD": "USD-RISKY"} if rng.integers(0, 2) else "ZAR-RISKY"
            csa_kw = dict(mpor_days=int(rng.choice([0, 5, 10, 22])), vm_threshold=float(rng.choice([0.0, 5e3, 5e4])),
                          vm_threshold_post=float(rng.choice([0.0, 1e4])))
            im_amount = float(rng.uniform(0, 2e4)) if im == "fixed" else 0.0

            def make(pkg):
                inst = pkg.inst
                trades = [inst.IRSwap(
                    name=f"s{trial}", effective_date=swap_eff, maturity_date=swap_mat,
                    notional=swap_kw["notional"],
                    receive_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=swap_kw["freq"],
                                             curve_name="ZAR-SWAP", spread=swap_kw["spread"]),
                    pay_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=3, fixed_rate=swap_kw["fixed"]),
                    discount_curve_name="ZAR-SWAP")]
                if trs_kw:
                    trades.append(inst.EquityTRS(
                        name=f"t{trial}", effective_date=trs_kw["eff"], maturity_date=trs_kw["mat"],
                        quantity=trs_kw["qty"], notional=100_000.0,
                        interest_leg=inst.SwapLeg(inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP",
                                                  spread=0.01),
                        spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV",
                        discount_curve_name="ZAR-SWAP", initial_price=100.0,
                        return_nominal_scaling=trs_kw["scaling"]))
                if ils_kw:
                    hist = {pkg.md.shift_months(pkg.md.first_of_month(VAL), -k): 100.0 + 0.3 * (8 - k)
                            for k in range(0, 9)}
                    trades.append(inst.IndexLinkedSwap(
                        name=f"i{trial}", effective_date=VAL,
                        maturity_date=dt.date(VAL.year + 1, VAL.month, VAL.day), notional=500_000.0,
                        inflation_leg=inst.InflationLeg(
                            real_rate=0.025, base_cpi=100.0, cpi_curve_name="CPI.ZA", frequency=6,
                            inflation_rate_curve_name="INFL.ZA", pay_notional_at_maturity=ils_kw["pay"]),
                        nominal_leg=inst.SwapLeg(inst.LegType.FIXED, frequency=6, fixed_rate=0.08),
                        discount_curve_name="ZAR-SWAP", inflation_index=hist,
                        inflation_receiver=ils_kw["receiver"]))
                pf = pkg.pf
                csa = pf.CSA(**csa_kw, im_method=pf.InitialMarginMethod(im), im_amount=im_amount,
                             close_out_method=pf.CloseOutMethod(close_out), risky_curve_name=risky)
                return trades, csa

            trades, csa = make(PORT)
            ccys = ["ZAR"] * len(trades)
            generic = port_ee.ExposureEngine(cube).compute(port_pf.NettingSet(
                "NS", [port_pf.Trade(x, f"T{i}", currency=c) for i, (x, c) in enumerate(zip(trades, ccys))],
                csa=csa))
            prof = port_dev.compute(trades, csa=csa, currencies=ccys)
            jax_trades, jax_csa = make(JAX)
            jax_prof = jax_dev.compute(jax_trades, csa=jax_csa, currencies=ccys)
            simm = im == "simm"
            tol = dict(rtol=1e-7, atol=1e-5) if simm else dict(rtol=1e-9, atol=1e-6)
            msg = f"trial {trial}: im={im} close={close_out} risky={risky!r} n_trades={len(trades)}"
            for f in ("mtm", "collateral", "exposure"):
                np.testing.assert_allclose(getattr(prof, f), getattr(generic, f), err_msg=f"{msg} {f}", **tol)
                limit = SIMM_VS_JAX if simm and f != "mtm" else 1e-12
                assert _rel(getattr(prof, f), getattr(jax_prof, f)) <= limit, f"{msg} {f} vs JAX"
            n_checked += 1
        assert n_checked >= 8
