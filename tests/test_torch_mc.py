"""The port's Monte Carlo layer (``finite_difference_tpu_torch.models.mc``
and ``market_data``) against the JAX package, on the CPU at float64, draw
for draw: the same seed (or the same numpy inputs) goes through both.

Tolerances, with the largest gap measured on these inputs in brackets:

- threefry: ``threefry_bits`` at 32 and 64 bits equal ``jax.random.bits``
  exactly, and the uniforms (``rng._uniforms``) equal ``jax.random.uniform``
  bit for bit. ``threefry_normals`` is ``sqrt(2) * erfinv(u)`` of those uniforms,
  and torch's ``erfinv`` rounds differently from XLA's ``erf_inv``: 1e-13
  relative at float64 [3.7e-14], 5e-5 absolute at float32 [2.2e-5, at
  |z| near 4];
- Sobol: the device uniforms equal JAX's exactly (fast-forward too);
  ``sobol_normals`` / ``sobol1d_normals`` (``ndtri``) 1e-15 relative
  [5.0e-16]; ``SobolNormalRng`` (the erfinv inverse CDF) 1e-13 relative,
  the erfinv gap above [3.6e-15];
- GBM and Clewlow–Strickland paths on the same z: 1e-13 relative (the
  cumulative sums run in another order; [2e-16]);
- ``price_discrete_barrier_mc``, price and stderr: 1e-10 relative at 2,000
  paths [1.2e-14]. The paths differ by the normals' last bits; a breach
  that flipped on one would move the price by about a payoff over the path
  count, far above 1e-10, and the assertion message names that cause;
- ``price_american_lsm``, price and stderr: 1e-9 relative at 4,000 paths x
  20 steps [1.7e-14] (an exercise decision that flipped would show the
  same way);
- HW1F: the state, the cube (numpy and device tensor), ``values_with_today``
  and the scenario cube within 1e-12 of max|value| [7e-17 absolute on
  values near 0.1]; ``moments`` and the host-side numpy are exact.
"""
import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.market_data import risk_factor as jax_rf
from finite_difference_tpu.market_data import scenario_cube as jax_sc
from finite_difference_tpu.models.mc import clewlow_strickland as jax_cs
from finite_difference_tpu.models.mc import discrete_barrier as jax_db
from finite_difference_tpu.models.mc import gbm as jax_gbm
from finite_difference_tpu.models.mc import hw1f as jax_hw
from finite_difference_tpu.models.mc import lsm as jax_lsm
from finite_difference_tpu.models.mc import rng as jax_rng
from finite_difference_tpu.utils.curves import flat_curve as jax_flat_curve
from finite_difference_tpu_torch.market_data import risk_factor as port_rf
from finite_difference_tpu_torch.market_data import scenario_cube as port_sc
from finite_difference_tpu_torch.models.mc import clewlow_strickland as port_cs
from finite_difference_tpu_torch.models.mc import discrete_barrier as port_db
from finite_difference_tpu_torch.models.mc import gbm as port_gbm
from finite_difference_tpu_torch.models.mc import hw1f as port_hw
from finite_difference_tpu_torch.models.mc import lsm as port_lsm
from finite_difference_tpu_torch.models.mc import rng as port_rng
from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates
from finite_difference_tpu_torch.utils.curves import flat_curve as port_flat_curve

VAL = dt.date(2025, 7, 28)
MAT = dt.date(2025, 8, 28)
SEEDS = (0, 42, 2**31 + 7)
SHAPES = ((7,), (300, 70), (5, 3, 11), (4097,))
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

def _jax_normal_bounds(dtype):
    return np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype)), 1.0


# ---------------------------------------------------------------------------
# threefry


@pytest.mark.parametrize("seed", (0, 42, 2**31 + 7, 2**40 + 3, -5))
def test_prng_key_is_jax_key(seed):
    np.testing.assert_array_equal(port_rng.prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_equal_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    port_key = port_rng.prng_key(seed)
    b32 = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(port_rng.threefry_bits(port_key, shape, 32, device="cpu").numpy(), b32)
    b64 = np.asarray(jax.random.bits(key, shape, jnp.uint64)).view(np.int64)
    np.testing.assert_array_equal(port_rng.threefry_bits(port_key, shape, 64, device="cpu").numpy(), b64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_uniforms_and_normals_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    port_key = port_rng.prng_key(seed)
    for jdt, tdt, normal_atol, normal_rtol in ((jnp.float64, torch.float64, 0.0, 1e-13),
                                               (jnp.float32, torch.float32, 5e-5, 0.0)):
        for lo, hi in ((0.0, 1.0), _jax_normal_bounds(jdt)):
            want = np.asarray(jax.random.uniform(key, shape, jdt, lo, hi))
            got = port_rng._uniforms(port_key, port_rng._counts(shape, "cpu"), tdt, float(lo), hi).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        want = np.asarray(jax.random.normal(key, shape, jdt))
        got = port_rng.threefry_normals(port_key, shape, tdt, device="cpu").numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=normal_rtol, atol=normal_atol)


def test_threefry_rejects_bad_inputs():
    with pytest.raises(ValueError, match="bit_width"):
        port_rng.threefry_bits(port_rng.prng_key(0), (4,), 16, device="cpu")
    with pytest.raises(ValueError, match="pair"):
        port_rng.threefry_normals(np.zeros(3, np.uint32), (4,), device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        port_rng.threefry_normals(port_rng.prng_key(0), (4,), torch.float16, device="cpu")


# ---------------------------------------------------------------------------
# Sobol


@pytest.mark.parametrize("dimension", (1, 2, 5, 13))
def test_sobol_uniforms_and_normals_match_jax(dimension):
    for n, ff in ((128, 0), (24, 40)):
        want = np.asarray(jax_rng.sobol_uniforms(n, dimension, fast_forward=ff))
        np.testing.assert_array_equal(port_rng.sobol_uniforms(n, dimension, ff, device="cpu").numpy(), want)
        want = np.asarray(jax_rng.sobol_normals(n, dimension, fast_forward=ff))
        np.testing.assert_allclose(port_rng.sobol_normals(n, dimension, ff, device="cpu").numpy(), want,
                                   rtol=1e-15, atol=0.0)
    np.testing.assert_array_equal(port_rng.sobol_direction_matrix(dimension),
                                  jax_rng.sobol_direction_matrix(dimension))


@pytest.mark.parametrize("ff", (0, 8, 1000))
def test_sobol1d_matches_jax(ff):
    np.testing.assert_array_equal(port_rng.sobol1d_uniforms(4096, ff, device="cpu").numpy(),
                                  np.asarray(jax_rng.sobol1d_uniforms(4096, ff)))
    np.testing.assert_allclose(port_rng.sobol1d_normals(4096, ff, device="cpu").numpy(),
                               np.asarray(jax_rng.sobol1d_normals(4096, ff)), rtol=1e-15, atol=0.0)
    x = np.arange(ff, ff + 300, dtype=np.uint32)
    np.testing.assert_array_equal(
        port_rng._bit_reverse_u32(torch.as_tensor(x.astype(np.int64))).numpy(),
        np.asarray(jax_rng._bit_reverse_u32(jnp.asarray(x))).astype(np.int64))


@pytest.mark.parametrize("backend", ("scipy", "torch"))
@pytest.mark.parametrize("ff", (0, 16))
def test_sobol_normal_rng_matches_jax(backend, ff):
    want = jax_rng.SobolNormalRng(seed=5, fast_forward=ff, backend=backend).draw_normals(3, 256)
    port = port_rng.SobolNormalRng(seed=5, fast_forward=ff, backend=backend, device="cpu")
    np.testing.assert_array_equal(
        port.draw_uniforms(3, 256),
        jax_rng.SobolNormalRng(seed=5, fast_forward=ff, backend=backend).draw_uniforms(3, 256))
    got = port.draw_normals(3, 256)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0)


# ---------------------------------------------------------------------------
# GBM and Clewlow–Strickland


def _normals(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def test_gbm_paths_match_jax():
    days = np.array([0, 5, 9, 30, 31, 90, 200, 365], dtype=float)
    z = _normals((days.size, 500))
    params = dict(mu=0.05, sigma=0.2)
    want = np.asarray(jax_gbm.GBMSimulator(jax_gbm.GBMParams(**params)).simulate(100.0, days, z))
    sim = port_gbm.GBMSimulator(port_gbm.GBMParams(**params), device="cpu")
    got = sim.simulate(100.0, days, z)
    assert torch.is_tensor(got) and got.shape == (days.size, 500)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0.0)
    paths = port_gbm.gbm_simulate_paths(100.0, days, torch.as_tensor(z), 0.05, 0.2)
    np.testing.assert_allclose(paths.numpy(), want, rtol=1e-13, atol=0.0)
    jsim = jax_gbm.GBMSimulator(jax_gbm.GBMParams(**params))
    for name in ("sanity_check_mean", "sanity_check_variance"):
        a, b = getattr(jsim, name)(want, 100.0, days), getattr(sim, name)(got, 100.0, days)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-10, atol=1e-14)
    a, b = jax_gbm.GBMSimulator.sanity_check_z(z), port_gbm.GBMSimulator.sanity_check_z(torch.as_tensor(z))
    assert a == b


def test_gbm_validation():
    sim = port_gbm.GBMSimulator(port_gbm.GBMParams(0.0, 0.2), device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        sim.simulate(100.0, [0.0, 10.0, 5.0], _normals((3, 4)))
    with pytest.raises(ValueError, match="aligned"):
        sim.simulate(100.0, [0.0, 10.0], _normals((3, 4)))


@pytest.mark.parametrize("risk_neutral", (False, True))
def test_cs_paths_match_jax(risk_neutral):
    params = dict(alpha=1.2, sigma=0.35, mu=0.08)
    tenors = np.array([10.0, 30.0, 90.0, 180.0, 365.0])
    scen = np.array([0.0, 5.0, 10.0, 30.0, 60.0, 90.0, 200.0])
    f0 = np.array([50.0, 52.0, 55.0, 60.0, 61.0])
    z = _normals((scen.size, 400), seed=1)
    want = np.asarray(jax_cs.CSForwardCurveSimulator(jax_cs.CSParams(**params), 365.25).simulate(
        f0, tenors, scen, z, risk_neutral=risk_neutral))
    sim = port_cs.CSForwardCurveSimulator(port_cs.CSParams(**params), 365.25, device="cpu")
    got = sim.simulate(f0, tenors, scen, z, risk_neutral=risk_neutral)
    assert torch.is_tensor(got) and got.shape == (scen.size, tenors.size, 400)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0.0)
    for a, b in zip(jax_cs.cs_precalculate(jax_cs.CSParams(**params), tenors, scen, 365.25, risk_neutral),
                    port_cs.cs_precalculate(port_cs.CSParams(**params), tenors, scen, 365.25, risk_neutral)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(sim._riskflow_dt_matrix_days(scen, tenors),
                                  jax_cs.riskflow_dt_matrix_days(scen, tenors))
    with pytest.raises(ValueError, match="aligned"):
        sim.simulate(f0, tenors, scen, z[:-1])


# ---------------------------------------------------------------------------
# the discrete-barrier MC

BARRIERS = {"none": None, "up-and-out": 250.0, "down-and-out": 215.0,
            "up-and-in": 250.0, "down-and-in": 215.0}


@pytest.mark.parametrize("antithetic", (True, False))
@pytest.mark.parametrize("dividend_before_monitor", (True, False))
@pytest.mark.parametrize("rebate_at_hit", (False, True))
@pytest.mark.parametrize("barrier_type", list(BARRIERS))
def test_discrete_barrier_mc_matches_jax(barrier_type, rebate_at_hit, dividend_before_monitor,
                                         antithetic):
    kw = dict(spot=229.74, strike=190.0, vol=0.2879, option_type="call", valuation=VAL,
              maturity=MAT, monitor_dates=build_monitoring_dates(VAL, MAT, "daily"),
              dividends=[(dt.date(2025, 8, 14), 3.0)])
    cfg = dict(n_paths=2000, seed=3, antithetic=antithetic,
               dividend_before_monitor=dividend_before_monitor)
    level = BARRIERS[barrier_type]
    want = jax_db.price_discrete_barrier_mc(
        discount_curve=jax_flat_curve(0.073, VAL), barrier=jax_db.BarrierSpec(barrier_type, level),
        rebate=jax_db.RebateSpec(2.0, rebate_at_hit), cfg=jax_db.MCConfig(**cfg), **kw)
    got = port_db.price_discrete_barrier_mc(
        discount_curve=port_flat_curve(0.073, VAL), barrier=port_db.BarrierSpec(barrier_type, level),
        rebate=port_db.RebateSpec(2.0, rebate_at_hit), cfg=port_db.MCConfig(**cfg), device="cpu", **kw)
    assert got.keys() == want.keys()
    for k in ("n_obs", "n_observations", "steps", "barrier_type", "barrier_band", "antithetic",
              "grid_points"):
        assert got[k] == want[k], k
    assert isinstance(got["price"], float) and isinstance(got["stderr"], float)
    for k in ("price", "stderr"):
        gap = abs(got[k] - want[k]) / abs(want[k])
        assert gap <= 1e-10, (
            f"{k}: {got[k]!r} vs JAX {want[k]!r} ({gap:.2e} relative): a gap of this size means a "
            "breach decision flipped on a last-bit difference of the normals (the erfinv gap)")
    np.testing.assert_allclose(got["ci95"], want["ci95"], rtol=1e-10)
    assert got["ci_95"] == got["ci95"]


def test_discrete_barrier_host_grid_and_errors():
    divs = [(dt.date(2025, 8, 4), 1.0), (dt.date(2025, 8, 4), 0.5), (dt.date(2025, 9, 30), 2.0),
            (dt.date(2025, 8, 8), 0.0)]
    mons = [dt.date(2025, 7, 28), dt.date(2025, 8, 1), dt.date(2025, 8, 20)]
    for inc in (True, False):
        assert (port_db.build_event_grid(VAL, MAT, divs, mons, inc)
                == jax_db.build_event_grid(VAL, MAT, divs, mons, inc))
    assert port_db._barrier_band(100.0, 25.0, 0.01) == jax_db._barrier_band(100.0, 25.0, 0.01)
    with pytest.raises(ValueError, match="maturity"):
        port_db.build_event_grid(MAT, VAL, [], [])
    with pytest.raises(ValueError, match="level"):
        port_db.price_discrete_barrier_mc(
            spot=100.0, strike=100.0, vol=0.2, option_type="put", valuation=VAL, maturity=MAT,
            discount_curve=port_flat_curve(0.07, VAL), barrier=port_db.BarrierSpec("up-and-out"),
            device="cpu")
    assert dataclasses.asdict(port_db.MCConfig()) == dataclasses.asdict(jax_db.MCConfig())


# ---------------------------------------------------------------------------
# Longstaff–Schwartz


@pytest.mark.parametrize("antithetic", (True, False))
@pytest.mark.parametrize("degree", (2, 3))
@pytest.mark.parametrize("is_call", (False, True))
def test_lsm_matches_jax(is_call, degree, antithetic):
    args = (100.0, 105.0, 0.25, 1.0, 0.05, 0.02, is_call)
    kw = dict(n_paths=4000, n_steps=20, degree=degree, antithetic=antithetic, seed=5)
    want = jax_lsm.price_american_lsm(*args, **kw)
    got = port_lsm.price_american_lsm(*args, **kw, device="cpu")
    assert all(isinstance(x, float) for x in got)
    for g, w, name in zip(got, want, ("price", "stderr")):
        assert abs(g - w) <= 1e-9 * abs(w), (
            f"{name}: {g!r} vs JAX {w!r}: a gap of this size means an exercise decision flipped "
            "on a last-bit difference of the normals (the erfinv gap)")


def test_lsm_key_argument_and_odd_paths():
    kw = dict(n_paths=1001, n_steps=12, seed=0)
    want = jax_lsm.price_american_lsm(90.0, 100.0, 0.3, 0.5, 0.04, 0.0, False,
                                      key=jax.random.PRNGKey(77), **kw)
    got = port_lsm.price_american_lsm(90.0, 100.0, 0.3, 0.5, 0.04, 0.0, False,
                                      key=port_rng.prng_key(77), device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    basis = port_lsm._basis(torch.linspace(0.5, 1.5, 7, dtype=torch.float64), 3)
    np.testing.assert_allclose(basis.numpy(), np.asarray(jax_lsm._basis(jnp.linspace(0.5, 1.5, 7), 3)),
                               rtol=1e-15)


# ---------------------------------------------------------------------------
# Hull–White one factor


def _close(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12 * np.abs(want).max())


def _hw1f_pair(alpha=0.3, tenors=(0.0, 1.0), vols=(0.02, 0.005)):
    jp = jax_hw.HW1FParams(alpha, np.array(tenors), np.array(vols))
    pp = port_hw.HW1FParams(alpha, np.array(tenors), np.array(vols))
    return (jax_hw.HW1FCurveSimulator(jp, TENORS0, RATES0),
            port_hw.HW1FCurveSimulator(pp, TENORS0, RATES0, device="cpu"))


@pytest.mark.parametrize("n_paths", (7, 64))
@pytest.mark.parametrize("antithetic", (True, False))
def test_hw1f_state_and_cube_match_jax(antithetic, n_paths):
    js, ps = _hw1f_pair()
    t_grid = np.linspace(0.25, 3.0, 12)
    taus = [0.25, 1.0, 5.0]
    kw = dict(seed=3, antithetic=antithetic)
    xs = ps.simulate_state(t_grid, n_paths, **kw)
    assert isinstance(xs, np.ndarray)
    _close(xs, js.simulate_state(t_grid, n_paths, **kw))
    dev = ps.simulate_state(t_grid, n_paths, as_jax=True, **kw)
    assert torch.is_tensor(dev) and dev.device.type == "cpu"
    _close(dev, js.simulate_state(t_grid, n_paths, as_jax=True, **kw))
    for as_jax in (False, True):
        got = ps.simulate(t_grid, taus, n_paths, as_jax=as_jax, **kw)
        assert torch.is_tensor(got) == as_jax
        _close(got, js.simulate(t_grid, taus, n_paths, as_jax=as_jax, **kw))
        rates = js.simulate(t_grid, taus, n_paths, **kw)
        _close(ps.values_with_today(got, taus, n_paths, as_jax=as_jax),
               js.values_with_today(rates, taus, n_paths, as_jax=as_jax))
    for a, b in zip(ps.moments(t_grid), js.moments(t_grid)):
        np.testing.assert_array_equal(a, b)


def test_hw1f_normals_override_matches_jax():
    js, ps = _hw1f_pair(alpha=0.1, tenors=(0.0,), vols=(0.012,))
    t_grid = np.linspace(1 / 12, 2.0, 24)
    z = _normals((t_grid.size, 33), seed=4)
    _close(ps.simulate(t_grid, [0.5, 2.0], 33, normals=z), js.simulate(t_grid, [0.5, 2.0], 33, normals=z))
    _close(ps.simulate_state(t_grid, 33, normals=torch.as_tensor(z)),
           js.simulate_state(t_grid, 33, normals=z))


def test_hw1f_scenario_cube_matches_jax():
    js, ps = _hw1f_pair(alpha=0.1, tenors=(0.0,), vols=(0.012,))
    kw = dict(base_date=VAL, scen_days=[0, 60, 30, 90, 735], tenors=TENORS0, n_paths=16,
              factor_name="ZAR-SWAP", seed=11)
    want, got = js.to_scenario_cube(**kw), ps.to_scenario_cube(**kw)
    assert isinstance(got, port_sc.ScenarioCube)
    assert got.dates == want.dates and (got.n_times, got.n_paths) == (want.n_times, want.n_paths)
    _close(got.factor_array("ZAR-SWAP"), want.factor_array("ZAR-SWAP"))
    for t in range(got.n_times):
        a, b = got.get_time_slice(t)["ZAR-SWAP"], want.get_time_slice(t)["ZAR-SWAP"]
        assert type(a).__name__ == type(b).__name__ == "CurveSlice"
        _close(a.values, b.values)
        np.testing.assert_array_equal(a.tenors, b.tenors)


@pytest.mark.parametrize("packing", ("dot_curve", "dict", "pairs"))
def test_hw1f_params_from_calibration(packing):
    pairs = [(1.0, 0.01), (0.25, 0.02), (5.0, 0.008)]
    sigma = {"dot_curve": {".Curve": {"meta": [], "data": pairs}},
             "dict": dict(pairs), "pairs": pairs}[packing]
    want = jax_hw.HW1FParams.from_calibration({"Alpha": 0.15, "Sigma": sigma})
    got = port_hw.HW1FParams.from_calibration({"Alpha": 0.15, "Sigma": sigma})
    assert got.alpha == want.alpha
    np.testing.assert_array_equal(got.sigma_tenors, want.sigma_tenors)
    np.testing.assert_array_equal(got.sigma_values, want.sigma_values)
    t = np.array([0.0, 0.25, 0.6, 2.0, 9.0])
    np.testing.assert_array_equal(got.sigma_at(t), want.sigma_at(t))
    flat_j, flat_p = jax_hw.HW1FParams.flat(0.2, 0.01), port_hw.HW1FParams.flat(0.2, 0.01)
    np.testing.assert_array_equal(flat_p.sigma_values, flat_j.sigma_values)


def test_hw1f_validation_errors_as_jax():
    for alpha in (0.0, -0.1, float("nan")):
        for mod in (jax_hw, port_hw):
            with pytest.raises(ValueError, match="alpha must be positive"):
                mod.HW1FParams.flat(alpha, 0.01)
    js, ps = _hw1f_pair()
    for args, kw, match in (
        (([0.5, 0.25], [1.0], 4), {}, "ascending"),
        (([0.0, 0.5], [1.0], 4), {}, "ascending"),
        (([0.25, 0.5], [0.0, 1.0], 4), {}, "tenors"),
        (([0.25], [1.0], 4), {"normals": np.zeros((2, 4))}, "normals"),
    ):
        for sim in (js, ps):
            with pytest.raises(ValueError, match=match):
                sim.simulate(*args, **kw)
    for mod, extra in ((jax_hw, {}), (port_hw, {"device": "cpu"})):
        with pytest.raises(ValueError, match="1-D grid"):
            mod.HW1FCurveSimulator(mod.HW1FParams.flat(0.1, 0.01), [1.0], [0.07], **extra)


# ---------------------------------------------------------------------------
# the scenario cube and the risk-factor slices


def test_slices_normalise_as_jax():
    curve = np.array([0.07, 0.071, 0.072])
    for mod in (jax_rf, port_rf):
        with pytest.raises(ValueError, match="do not match"):
            mod.CurveSlice(values=curve, tenors=[1.0, 2.0])
    pairs = [
        (port_rf.ScalarSlice(3.5), jax_rf.ScalarSlice(3.5)),
        (port_rf.CurveSlice(curve, [0.5, 1.0, 2.0]), jax_rf.CurveSlice(curve, [0.5, 1.0, 2.0])),
        (port_rf.SurfaceSlice(np.ones((2, 3)), [1.0, 2.0], [90.0, 100.0, 110.0]),
         jax_rf.SurfaceSlice(np.ones((2, 3)), [1.0, 2.0], [90.0, 100.0, 110.0])),
    ]
    for got, want in pairs:
        assert got.n_paths == want.n_paths
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
            assert getattr(got, f.name).dtype == getattr(want, f.name).dtype
    assert len(port_rf.RiskFactorSlice) == 3


def test_scenario_cube_views_as_jax():
    rng = np.random.default_rng(8)
    dates = [VAL + dt.timedelta(days=30 * i) for i in range(4)]
    rng_vals = {"FX": rng.random((4, 5)), "ZAR": rng.random((4, 5, 3)), "VOL": rng.random((4, 5, 2, 2))}
    spec = {
        "FX": ("scalar", rng_vals["FX"]),
        "ZAR": ("curve", rng_vals["ZAR"], np.array([0.5, 1.0, 2.0])),
        "VOL": ("surface", rng_vals["VOL"], np.array([1.0, 2.0]), np.array([90.0, 110.0])),
    }
    got, want = port_sc.ScenarioCube(dates, spec), jax_sc.ScenarioCube(dates, spec)
    assert (got.n_times, got.n_paths, got.dates) == (want.n_times, want.n_paths, want.dates)
    for t in range(4):
        a, b = got.get_time_slice(t), want.get_time_slice(t)
        assert a.keys() == b.keys()
        for name in a:
            assert type(a[name]).__name__ == type(b[name]).__name__
            np.testing.assert_array_equal(a[name].values, b[name].values)
    rebuilt = port_sc.ScenarioCube.from_slices(dates, [got.get_time_slice(t) for t in range(4)])
    for name in ("FX", "ZAR", "VOL"):
        np.testing.assert_array_equal(rebuilt.factor_array(name), want.factor_array(name))
    for mod in (port_sc, jax_sc):
        with pytest.raises(ValueError, match="time steps"):
            mod.ScenarioCube(dates[:3], {"FX": ("scalar", rng_vals["FX"])})
        with pytest.raises(ValueError, match="path count"):
            mod.ScenarioCube(dates, {"FX": ("scalar", rng_vals["FX"]),
                                     "Y": ("scalar", rng_vals["FX"][:, :2])})
    assert port_sc.StaticMarketData().factors == jax_sc.StaticMarketData().factors == {}


# ---------------------------------------------------------------------------
# the default device

ENTRY_POINTS = {
    "threefry_normals": lambda: port_rng.threefry_normals(port_rng.prng_key(0), (4,)),
    "threefry_bits": lambda: port_rng.threefry_bits(port_rng.prng_key(0), (4,)),
    "sobol1d_uniforms": lambda: port_rng.sobol1d_uniforms(8),
    "sobol1d_normals": lambda: port_rng.sobol1d_normals(8),
    "sobol_uniforms": lambda: port_rng.sobol_uniforms(8, 2),
    "sobol_normals": lambda: port_rng.sobol_normals(8, 2),
    "SobolNormalRng": lambda: port_rng.SobolNormalRng(seed=1).draw_normals(2, 8),
    "GBMSimulator": lambda: port_gbm.GBMSimulator(port_gbm.GBMParams(0.0, 0.2)),
    "gbm_simulate_paths": lambda: port_gbm.gbm_simulate_paths(1.0, [0.0, 1.0], np.zeros((2, 3)), 0.0, 0.2),
    "CSForwardCurveSimulator": lambda: port_cs.CSForwardCurveSimulator(
        port_cs.CSParams(1.0, 0.2, 0.0), 365.0),
    "cs_simulate_paths": lambda: port_cs.cs_simulate_paths(np.ones(1), np.zeros((2, 1)), np.zeros((2, 1)),
                                                           np.zeros((2, 3))),
    "price_discrete_barrier_mc": lambda: port_db.price_discrete_barrier_mc(
        spot=100.0, strike=100.0, vol=0.2, option_type="call", valuation=VAL, maturity=MAT,
        discount_curve=port_flat_curve(0.07, VAL), cfg=port_db.MCConfig(n_paths=64)),
    "price_american_lsm": lambda: port_lsm.price_american_lsm(100.0, 100.0, 0.2, 1.0, 0.05, n_paths=64),
    "HW1FCurveSimulator": lambda: port_hw.HW1FCurveSimulator(port_hw.HW1FParams.flat(0.1, 0.01),
                                                             TENORS0, RATES0),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
