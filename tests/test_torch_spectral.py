"""The port's spectral propagator (models/pde/spectral.py) against the JAX package.

On the CPU at float64, on the same numpy inputs:

- the host helpers (``spectral_intervals``, ``symmetrizer_exponent``,
  ``channel_conditioning``, ``dst_matrix``) equal the JAX package's
  (exactly, or within 1e-14);
- ``spectral_solve`` on every case of the JAX package's TestSpectralVsScan
  and on the per-interval-dt batches of its TestMonitorAlignedSchedules is
  within 1e-10 of the JAX package's ``spectral_solve`` and within 1e-9 of
  the port's scan (of max(1, max|V|), as tests/test_spectral.py holds it);
- the layout verdict (``_spectral_layout``) is the JAX package's on those
  batches and on the guard cases;
- ``price_barrier_batch`` under each solver name is within 1e-9 of the JAX
  package's on all five outputs (``spectral_mixed``, whose state is
  float32 by design, within that state's floor);
- float32 batches (TestX64DstRescue's, and the first 256 trades of
  chip_smoke.py's barrier set) on ``spectral`` and ``spectral_x64dst``
  reach the JAX package's float32 floor against the float64 scan;
- ``solve_value_surfaces`` is within 1e-10 of the JAX package's on (B, N).
"""
import functools

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu.models.pde import spectral as jax_spectral
from finite_difference_tpu.models.pde import stepper as jax_stepper
from finite_difference_tpu.models.pde.grid import uniform_schedule
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import spectral, stepper
from finite_difference_tpu_torch.ops import interp as port_interp

import chip_smoke

KEYS = ("price", "vega", "delta", "gamma", "theta")


# --------------------------------------------------------------------------- #
# host helpers                                                                #
# --------------------------------------------------------------------------- #
def _monitor_patterns():
    rng = np.random.default_rng(4)
    n = 24
    ragged = rng.random((5, n)) < 0.2
    ragged[1, :] = False  # a trade with no monitor
    ragged[2, -1] = True  # a monitor on the last step
    shared = np.zeros((3, n), bool)
    shared[:, 5::6] = True
    return {"ragged": ragged, "shared": shared, "one_row": ragged[2]}


@pytest.mark.parametrize("name", sorted(_monitor_patterns()))
def test_spectral_intervals_match_jax(name):
    mon = _monitor_patterns()[name]
    want = jax_spectral.spectral_intervals(mon)
    got = spectral.spectral_intervals(mon)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # the layout's device form gives the same intervals
    mon2 = np.atleast_2d(mon)
    n_iv = want[0].shape[1]
    k_end, apply_proj = port_batch._interval_layout(torch.as_tensor(mon2), n_iv)
    np.testing.assert_array_equal(k_end.numpy(), want[0])
    np.testing.assert_array_equal(apply_proj.numpy(), want[1])


def _trade_params(seed=0, B=64):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.02, 0.6, B)
    b = rng.uniform(-0.1, 0.4, B)
    q = rng.uniform(0.0, 0.05, B)
    r = rng.uniform(0.0, 0.12, B)
    dx = rng.uniform(0.002, 0.08, B)
    dt = rng.uniform(1e-4, 0.05, B)
    return sigma, b, q, r, dx, dt


@pytest.mark.parametrize("n_nodes", [65, 128, 1024])
def test_symmetrizer_exponent_matches_jax(n_nodes):
    sigma, b, q, _, dx, _ = _trade_params()
    want = jax_spectral.symmetrizer_exponent(sigma, b, q, dx, n_nodes)
    got = spectral.symmetrizer_exponent(sigma, b, q, dx, n_nodes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_nodes", [65, 128, 1024])
def test_channel_conditioning_matches_jax(n_nodes):
    sigma, b, q, r, dx, dt = _trade_params(seed=1)
    with np.errstate(all="ignore"):
        want = jax_spectral.channel_conditioning(sigma, b, q, r, dx, dt, n_nodes)
    got = spectral.channel_conditioning(sigma, b, q, r, dx, dt, n_nodes)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_nodes", [34, 129])
def test_dst_matrix_matches_jax_and_is_cached(dtype, n_nodes):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jax_spectral.dst_matrix(n_nodes, jdt))
    got = spectral.dst_matrix(n_nodes, dtype, torch.device("cpu"))
    assert got.dtype == dtype and got.shape == (n_nodes - 2, n_nodes - 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert spectral.dst_matrix(n_nodes, dtype, torch.device("cpu")) is got
    # orthonormal and symmetric (its own inverse)
    if dtype == torch.float64:
        eye = got @ got
        np.testing.assert_allclose(eye.numpy(), np.eye(n_nodes - 2), atol=1e-13)


# --------------------------------------------------------------------------- #
# spectral_solve: TestSpectralVsScan's cases, one trade each                  #
# --------------------------------------------------------------------------- #
def _case(*, S0=229.74, K=190.0, sig=0.2879, r=0.0705, b=None, q=0.0,
          is_call=True, T=1.0 / 12, n=64, R=2, n_nodes=129, monitors=6,
          lower=None, upper=260.0, rebate=0.0, rebate_at_hit=False,
          euro_put_lower=True, dx=2.0 / 128, mon=None):
    """One trade of tests/test_spectral.py's _solve_both, as numpy scalars
    and its uniform schedule."""
    b = r if b is None else b
    if mon is None:
        mon = [T * (k + 1) / monitors for k in range(monitors)] if monitors else []
    sch = uniform_schedule(T, n, R, mon)
    return dict(
        x_min=np.log(S0) - 1.0, dx=dx, strike=K, is_call=is_call, sigma=sig, r=r, b=b,
        q=q, lower=lower if lower is not None else 0.0,
        upper=upper if upper is not None else 1e12, has_lower=lower is not None,
        has_upper=upper is not None, rebate=rebate, rebate_at_hit=rebate_at_hit,
        rebate_rate=b, dt=T / n, R=R, n_nodes=n_nodes, euro=euro_put_lower, sch=sch,
    )


def _fuzz_cases():
    """TestSpectralVsScan.test_fuzz_random_configs' ten configurations."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(10):
        is_call = bool(rng.integers(0, 2))
        K = float(rng.uniform(80, 120))
        out.append(dict(
            S0=float(rng.uniform(80, 120)), K=K, sig=float(rng.uniform(0.15, 0.5)),
            r=float(rng.uniform(0.0, 0.1)), b=float(rng.uniform(-0.02, 0.1)),
            q=float(rng.uniform(0.0, 0.03)), is_call=is_call, T=float(rng.uniform(0.05, 1.5)),
            n=int(rng.integers(16, 100)), R=int(rng.integers(0, 4)),
            monitors=int(rng.integers(0, 12)), rebate=float(rng.uniform(0.0, 3.0)),
            rebate_at_hit=bool(rng.integers(0, 2)), upper=float(rng.uniform(125, 200)),
            lower=float(rng.uniform(40, 75)) if rng.integers(0, 2) else None,
            dx=float(rng.uniform(0.01, 0.03)),
        ))
    return out


CASES = {
    "up_out_call_with_rebate": dict(rebate=1.5),
    "up_out_call_rebate_at_hit": dict(rebate=2.0, rebate_at_hit=True),
    "down_out_put": dict(is_call=False, K=260.0, lower=200.0, upper=None),
    "down_out_put_american_lower_boundary": dict(
        is_call=False, K=260.0, lower=200.0, upper=None, euro_put_lower=False),
    "double_barrier_call": dict(lower=180.0, upper=280.0, rebate=0.5),
    "carry_not_discount_with_yield": dict(b=0.03, q=0.015),
    "no_barrier_european": dict(upper=None, monitors=0),
    "put_no_barrier": dict(is_call=False, K=260.0, upper=None, monitors=0),
    # a monitor inside the Rannacher window: intervals mix theta=1/0.5
    "monitor_at_first_step_splits_rannacher": dict(
        S0=100.0, K=100.0, sig=0.3, r=0.05, b=0.05, T=0.5, n=40, R=3,
        n_nodes=65, dx=2.0 / 64, upper=130.0,
        mon=[0.5 - 1.5 * 0.5 / 40, 0.25, 0.125]),
    **{f"fuzz_{i}": kw for i, kw in enumerate(_fuzz_cases())},
}


def _jax_trade(c):
    f = jnp.float64
    grid = jax_stepper.CNGrid(f(c["x_min"]), f(c["dx"]))
    dyn = jax_stepper.CNDynamics(f(c["strike"]), jnp.bool_(c["is_call"]), f(c["sigma"]),
                                 f(c["r"]), f(c["b"]), f(c["q"]))
    bar = jax_stepper.BarrierSpec(f(c["lower"]), f(c["upper"]), jnp.bool_(c["has_lower"]),
                                  jnp.bool_(c["has_upper"]), f(c["rebate"]),
                                  jnp.bool_(c["rebate_at_hit"]), f(c["rebate_rate"]))
    return grid, dyn, bar


def _port_trade(c):
    t = lambda v, dt=torch.float64: torch.tensor([v], dtype=dt)
    tb = lambda v: torch.tensor([bool(v)])
    grid = stepper.CNGrid(t(c["x_min"]), t(c["dx"]))
    dyn = stepper.CNDynamics(t(c["strike"]), tb(c["is_call"]), t(c["sigma"]), t(c["r"]),
                             t(c["b"]), t(c["q"]))
    bar = stepper.BarrierSpec(t(c["lower"]), t(c["upper"]), tb(c["has_lower"]),
                              tb(c["has_upper"]), t(c["rebate"]), tb(c["rebate_at_hit"]),
                              t(c["rebate_rate"]))
    return grid, dyn, bar


def _rel(a, b):
    scale = max(1.0, float(np.max(np.abs(b))))
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) / scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_spectral_solve_matches_jax_and_the_scan(name):
    c = _case(**CASES[name])
    sch, n_nodes = c["sch"], c["n_nodes"]
    k_end, ap = jax_spectral.spectral_intervals(sch.monitor)
    grid, dyn, bar = _jax_trade(c)
    want, _ = jax_spectral.spectral_solve(
        grid, dyn, jnp.float64(c["dt"]), jnp.asarray(k_end[0]), jnp.asarray(ap[0]), n_nodes,
        c["R"], barrier=bar, euro_put_lower_boundary=c["euro"],
    )
    pgrid, pdyn, pbar = _port_trade(c)
    got, s = spectral.spectral_solve(
        pgrid, pdyn, torch.tensor([c["dt"]], dtype=torch.float64), torch.as_tensor(k_end),
        torch.as_tensor(ap), n_nodes, torch.tensor([c["R"]]), barrier=pbar,
        euro_put_lower_boundary=c["euro"],
    )
    assert got.shape == s.shape == (1, n_nodes)
    assert _rel(got[0].numpy(), np.asarray(want)) < 1e-10
    psch = stepper.CNSchedule(*[torch.as_tensor(np.asarray(getattr(sch, f)))[None] for f in (
        "dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda")])
    v_scan, _ = stepper.cn_solve(pgrid, pdyn, psch, n_nodes, barrier=pbar,
                                 euro_put_lower_boundary=c["euro"])
    assert _rel(got[0].numpy(), v_scan[0].numpy()) < 1e-9


# --------------------------------------------------------------------------- #
# batches: the layout, per-interval dt, the driver                            #
# --------------------------------------------------------------------------- #
T_MONTH = 31.0 / 365.0


def _uniform_kwargs(B=6):
    """TestBatchDriverRouting's batch."""
    rng = np.random.default_rng(3)
    T = T_MONTH
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[T] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=48,
        monitor_times=[[T * (k + 1) / 8.0 for k in range(8)]] * B, upper=[260.0] * B,
        rebate=[1.0] * B, num_space_nodes=127,
    )


def _aligned_kwargs(B=6, mons=(0.13, 0.29, 0.55, 0.62, 0.91), lower=None, rebate=None,
                    rebate_at_hit=None):
    """TestMonitorAlignedSchedules' batch: irregular monitors, so
    per-interval dt."""
    rng = np.random.default_rng(5)
    T = T_MONTH
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[T] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=48,
        monitor_times=[[T * f for f in mons]] * B, upper=[260.0] * B, lower=lower,
        rebate=rebate, rebate_at_hit=rebate_at_hit, num_space_nodes=127,
        monitor_aligned=True, steps_per_interval=7,
    )


def _double_barrier_aligned():
    B = 6
    return _aligned_kwargs(B=B, lower=[150.0] * B, rebate=[1.5] * B,
                           rebate_at_hit=[True, False] * (B // 2))


BATCHES = {
    "uniform": _uniform_kwargs,
    "aligned": _aligned_kwargs,
    "aligned_double_barrier": _double_barrier_aligned,
    "aligned_equal_intervals": lambda: _aligned_kwargs(mons=(1 / 6, 2 / 6, 3 / 6, 4 / 6, 5 / 6)),
}


def _both(kw, dtype=np.float64):
    jb = jax_batch.build_trade_batch(dtype=dtype, **kw)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return jb, port_batch.build_trade_batch(dtype=tdt, device="cpu", **kw)


def _fields(jb):
    return {k: np.asarray(v).copy() for k, v in jb.__dict__.items() if v is not None}


def _assert_same_layout(jb, pb, n_nodes, dtype=None):
    want = jax_batch._spectral_layout_impl(jb, n_nodes, dtype)
    got = port_batch._spectral_layout(pb, n_nodes)
    assert (got is None) == (want is None)
    if want is None:
        return
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        np.testing.assert_array_equal(got[3].double().numpy(), want[3])


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_layout_matches_jax(name):
    jb, pb = _both(BATCHES[name]())
    _assert_same_layout(jb, pb, 128)
    assert port_batch._spectral_layout(pb, 128) is not None
    assert (port_batch._spectral_layout(pb, 128)[3] is None) == (name in ("uniform", "aligned_equal_intervals"))


def _guard_batch(case):
    """A batch that one guard refuses (the f32/f64 symmetrizer cases pass
    at one dtype and not the other)."""
    if case.startswith("symmetrizer"):
        # |ln g| (N-2) between 15 and 200: a low-vol, high-carry trade set
        B = 4
        kw = dict(spots=[100.0] * B, strikes=[100.0] * B, sigmas=[0.12, 0.15, 0.13, 0.14],
                  t_expiry=[1.0] * B, r=[0.02] * B, b=[0.3] * B, is_call=[True] * B,
                  n_time_steps=32, monitor_times=[[0.5, 1.0]] * B, upper=[400.0] * B,
                  num_space_nodes=127)
        return kw, (np.float32 if case.endswith("f32") else np.float64), None
    kw = _uniform_kwargs(B=4)
    edit = {
        "dividends": lambda f: f["div_amount"].__setitem__((slice(None), 10), 1.0),
        "theta_not_prefix": lambda f: f["theta"].__setitem__((slice(None), 5), 1.0),
        "theta_value": lambda f: f["theta"].__setitem__((1, 7), 0.6),
        "all_implicit_row": lambda f: f["theta"].__setitem__((2, slice(None)), 1.0),
        "dt_within_interval": lambda f: f["dt"].__setitem__((slice(None), 1), f["dt"][0, 1] * 1.5),
        "drift_dominated": lambda f: f["b"].__setitem__(slice(None), 60.0),
    }[case]
    return kw, np.float64, edit


GUARDS = ("dividends", "theta_not_prefix", "theta_value", "all_implicit_row",
          "dt_within_interval", "drift_dominated", "symmetrizer_f32", "symmetrizer_f64")


@pytest.mark.parametrize("case", GUARDS)
def test_layout_verdict_matches_jax_on_the_guards(case):
    kw, dtype, edit = _guard_batch(case)
    if case == "dt_within_interval":
        kw = _aligned_kwargs(B=4)
    jb, _ = _both(kw, dtype)
    fields = _fields(jb)
    if edit is not None:
        edit(fields)
    jb = jax_batch.BarrierTradeBatch(**fields)
    pb = port_batch.batch_from_numpy(fields, device="cpu")
    _assert_same_layout(jb, pb, 128, dtype)
    want_refused = case != "symmetrizer_f64"
    assert (port_batch._spectral_layout(pb, 128) is None) == want_refused
    expo = spectral.symmetrizer_exponent(fields["sigma"], fields["b"], fields["q"], fields["dx"], 128)
    if case.startswith("symmetrizer"):
        assert 15.0 < expo.max() < 200.0


@pytest.mark.parametrize("name", ["aligned", "aligned_double_barrier"])
def test_per_interval_dt_solve_matches_jax_and_the_scan(name):
    jb, pb = _both(BATCHES[name]())
    lay = jax_batch._spectral_layout_impl(jb, 128)
    assert lay[3] is not None
    from dataclasses import replace

    jb = replace(jb, sp_k_end=lay[0], sp_apply=lay[1], sp_rann=lay[2], sp_dt=lay[3])
    want = jax.vmap(lambda bt: jax_batch._spectral_solve_one(bt, bt.sigma, 128))(
        jax.tree.map(jnp.asarray, jb))[0]
    pb = replace(pb, **dict(zip(port_batch.SP_FIELDS, port_batch._spectral_layout(pb, 128))))
    got, _ = port_batch._solve_spectral(pb, pb.sigma, 128, "spectral")
    assert _rel(got.numpy(), np.asarray(want)) < 1e-10
    v_scan, _ = port_batch._solve_scan(pb, pb.sigma, 128)
    assert _rel(got.numpy(), v_scan.numpy()) < 1e-9


def _assert_outputs(got, ref, tol):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].double().numpy(), np.asarray(ref[k], np.float64),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("solver", ["auto", "spectral", "spectral_x64dst", "spike_df64"])
@pytest.mark.parametrize("name", ["uniform", "aligned"])
def test_price_barrier_batch_matches_jax_under_each_solver(name, solver):
    """``spike_df64`` (the SPIKE march at float64) is held, as the port's
    ``spike``, against the JAX scan (tests/test_torch_batch.py)."""
    jb, pb = _both(BATCHES[name]())
    ref = jax_batch.price_barrier_batch(jb, 128, solver="scan" if solver == "spike_df64" else solver)
    got = port_batch.price_barrier_batch(pb, 128, solver=solver, device="cpu")
    _assert_outputs(got, ref, 1e-9)


def test_spectral_mixed_matches_jax_at_its_float32_state():
    """The mixed solve carries float32 state by design (the JAX package pins
    it at 1e-3 against the f64 oracle); the two implementations agree to
    that state's rounding: price and delta within 1e-5 of their largest
    value, gamma within 1e-4 (the second difference amplifies the state's
    node noise), and the vol-point bump and theta within 1e-3."""
    jb, pb = _both(BATCHES["uniform"]())
    ref = jax_batch.price_barrier_batch(jb, 128, solver="spectral_mixed", dv_sigma=1e-2)
    got = port_batch.price_barrier_batch(pb, 128, solver="spectral_mixed", dv_sigma=1e-2, device="cpu")
    assert set(got) == set(ref)
    for k, lim in (("price", 1e-5), ("delta", 1e-5), ("gamma", 1e-4), ("vega", 1e-3), ("theta", 1e-3)):
        r = np.asarray(ref[k], np.float64)
        assert float(np.max(np.abs(got[k].numpy() - r))) <= lim * float(np.max(np.abs(r))), k
    oracle = port_batch.price_barrier_batch(pb, 128, solver="scan", with_greeks=False, device="cpu")
    rel = (got["price"] - oracle["price"]).abs() / oracle["price"].abs()
    assert float(rel.max()) < 1e-3


def test_float32_spectral_batch_within_its_floor():
    """A float32 batch on the spectral route against the float64 one: the
    TestX64DstRescue floor, and the f32 symmetrizer limit applies."""
    jb, pb = _both(BATCHES["uniform"]())
    pb32 = pb.astype(torch.float32)
    out32 = port_batch.price_barrier_batch(pb32, 128, solver="spectral", with_greeks=False, device="cpu")
    out64 = port_batch.price_barrier_batch(pb, 128, solver="spectral", with_greeks=False, device="cpu")
    assert out32["price"].dtype == torch.float32
    rel = (out32["price"].double() - out64["price"]).abs() / out64["price"].abs()
    assert float(rel.max()) < 1e-3


def _rescue_kwargs():
    """tests/test_spectral.py TestX64DstRescue's batch: 32 one-month
    up-and-out calls (H=420), N=512, 256 steps, 24 monitors."""
    B, T = 32, 31.0 / 365.0
    rng = np.random.default_rng(0)
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[T] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=256,
        monitor_times=[[T * (k + 1) / 24.0 for k in range(24)]] * B,
        upper=[420.0] * B, num_space_nodes=511,
    )


def _benchmark_kwargs():
    """The first 256 trades of chip_smoke.py's barrier set (bench.py's):
    N=1024, 512 steps, 24 monitors."""
    return chip_smoke.bench_trades(256)[0]


# case: (batch, n_nodes, per-trade limit of each solve against the f64 scan
# and of the port against the JAX package). TestX64DstRescue's batch is held
# at that test's 1e-3; on the benchmark's cheapest trades (price about 1.6)
# the JAX package's float32 floor is above it, the reason auto keeps float32
# batches off the spectral route on a card.
FLOAT32_FLOOR_CASES = {
    "rescue": (_rescue_kwargs, 512, 1e-3),
    "benchmark": (_benchmark_kwargs, 1024, 3e-3),
}


@functools.lru_cache(maxsize=2)
def _float32_floor_oracle(case):
    make, n_nodes = FLOAT32_FLOOR_CASES[case][:2]
    tb = port_batch.build_trade_batch(device="cpu", **make())
    return port_batch.price_barrier_batch(tb, n_nodes, with_greeks=False, solver="scan",
                                          device="cpu")["price"].numpy()


def float32_floor_errors(case, solver):
    """(port, JAX, port against JAX): the largest per-trade error of a
    float32 batch on ``solver``, the port's and the JAX package's each
    against the float64 scan, and the port's against the JAX package's."""
    from dataclasses import replace

    make, n_nodes = FLOAT32_FLOOR_CASES[case][:2]
    kw = make()
    jb = jax_batch.build_trade_batch(dtype=np.float32, **kw)
    lay = jax_batch._spectral_layout(jb, n_nodes, np.float32)
    jb = replace(jb, sp_k_end=lay[0], sp_apply=lay[1], sp_rann=lay[2], sp_dt=lay[3])
    jax_p = np.asarray(jax_batch.price_batch_kernel(
        jax.tree.map(jnp.asarray, jb), n_nodes=n_nodes, with_greeks=False, solver=solver)["price"])
    pb = port_batch.build_trade_batch(dtype=torch.float32, device="cpu", **kw)
    out = port_batch.price_barrier_batch(pb, n_nodes, with_greeks=False, solver=solver, device="cpu")
    assert jax_p.dtype == np.float32 and out["price"].dtype == torch.float32
    port_p, jax_p = out["price"].double().numpy(), jax_p.astype(np.float64)
    oracle = _float32_floor_oracle(case)
    rel = lambda p, ref: float(np.max(np.abs(p - ref) / oracle))
    return rel(port_p, oracle), rel(jax_p, oracle), rel(port_p, jax_p)


@pytest.mark.parametrize("solver", ["spectral", "spectral_x64dst"])
@pytest.mark.parametrize("case", sorted(FLOAT32_FLOOR_CASES))
def test_float32_spectral_floor_matches_jax(case, solver):
    """Float32 batches on the port's and the JAX package's solve, each
    against the float64 scan (per trade): both within the case's limit,
    their errors within a factor of 3 of each other (the same floor: the
    DSTs' float32 accumulation, summed in another order, which on the CPU
    also moves with the matmul's threading), and the two within the case's
    limit of each other. The readings:
    ``python -c "import tests.conftest, tests.test_torch_spectral as t;
    print(t.float32_floor_errors('benchmark', 'spectral'))"``."""
    limit = FLOAT32_FLOOR_CASES[case][2]
    port_err, jax_err, port_vs_jax = float32_floor_errors(case, solver)
    assert port_err < limit and jax_err < limit, (port_err, jax_err)
    assert jax_err / 3.0 <= port_err <= 3.0 * jax_err, (port_err, jax_err)
    assert port_vs_jax < limit


class TestErrors:
    def test_spectral_on_a_refused_layout_raises(self):
        kw, dtype, edit = _guard_batch("dividends")
        jb, _ = _both(kw, dtype)
        fields = _fields(jb)
        edit(fields)
        pb = port_batch.batch_from_numpy(fields, device="cpu")
        for solver in ("spectral", "spectral_x64dst", "spectral_mixed"):
            with pytest.raises(ValueError, match="not spectral-eligible"):
                port_batch.price_barrier_batch(pb, 128, solver=solver, device="cpu")
        with pytest.raises(ValueError):
            jax_batch.price_barrier_batch(jax_batch.BarrierTradeBatch(**fields), 128, solver="spectral")
        out = port_batch.price_barrier_batch(pb, 128, solver="auto", with_greeks=False, device="cpu")
        assert bool(torch.isfinite(out["price"]).all())

    def test_spectral_mixed_rejects_per_interval_dt(self):
        _, pb = _both(_aligned_kwargs())
        with pytest.raises(ValueError, match="uniform dt"):
            port_batch.price_barrier_batch(pb, 128, solver="spectral_mixed", device="cpu")

    def test_spectral_names_refuse_an_american_batch(self):
        pb = port_batch.build_american_batch(
            spots=[100.0, 95.0], strikes=[100.0] * 2, sigmas=[0.3, 0.25], t_expiry=[1.0] * 2,
            r=[0.05] * 2, b=[0.05] * 2, is_call=[False] * 2, n_time_steps=16,
            num_space_nodes=126, device="cpu")
        with pytest.raises(ValueError, match="European barrier batches only"):
            port_batch.price_american_batch(pb, 128, solver="spectral", device="cpu")
        with pytest.raises(ValueError, match="American surface"):
            port_batch.solve_value_surfaces(pb, 128, solver="spectral", american=True, device="cpu")

    def test_unknown_solver_raises(self):
        _, pb = _both(_uniform_kwargs(B=2))
        with pytest.raises(ValueError, match="unknown solver"):
            port_batch.price_barrier_batch(pb, 128, solver="spectral64", device="cpu")


def test_batch_from_numpy_carries_the_jax_layout():
    jb, _ = _both(_aligned_kwargs())
    lay = jax_batch._spectral_layout_impl(jb, 128)
    fields = _fields(jb)
    fields.update(sp_k_end=lay[0], sp_apply=lay[1], sp_rann=lay[2], sp_dt=lay[3])
    pb = port_batch.batch_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(pb.sp_k_end.numpy(), lay[0])
    np.testing.assert_array_equal(pb.sp_dt.numpy(), lay[3])
    assert port_batch.batch_from_numpy(_fields(jb), device="cpu").sp_k_end is None
    assert pb[1:3].sp_k_end.shape[0] == 2


# --------------------------------------------------------------------------- #
# solve_value_surfaces                                                        #
# --------------------------------------------------------------------------- #
def _american_kwargs(dividends=False):
    B = 4
    return dict(
        spots=[90.0, 97.0, 104.0, 111.0], strikes=[100.0] * B, sigmas=[0.2, 0.25, 0.3, 0.35],
        t_expiry=[0.5, 1.0, 0.75, 1.0], r=[0.06] * B, b=[0.02] * B,
        is_call=[False, True, False, True], n_time_steps=32, num_space_nodes=126,
        dividends_tau=[[(0.3, 1.0)]] * B if dividends else None,
    )


@pytest.mark.parametrize("case", ["barrier_auto", "barrier_scan", "barrier_spectral_aligned",
                                  "american", "american_dividends"])
def test_solve_value_surfaces_matches_jax(case):
    if case.startswith("american"):
        kw = _american_kwargs(dividends=case.endswith("dividends"))
        jb = jax_batch.build_american_batch(**kw)
        pb = port_batch.build_american_batch(device="cpu", **kw)
        american, solver = True, "auto"
    else:
        kw = _aligned_kwargs() if case.endswith("aligned") else _uniform_kwargs()
        jb, pb = _both(kw)
        american, solver = False, case.split("_")[1]
    v_want, s_want = jax_batch.solve_value_surfaces(jb, 128, solver=solver, american=american)
    v, s = port_batch.solve_value_surfaces(pb, 128, solver=solver, american=american, device="cpu")
    assert v.shape == s.shape == (pb.batch_size, 128)
    np.testing.assert_allclose(s.numpy(), s_want, rtol=1e-14, atol=0.0)
    assert float(np.max(np.abs(v.numpy() - v_want))) <= 1e-10 * max(1.0, float(np.max(np.abs(v_want))))
    # the surface is the price path's own V: its interpolation at the spot is the price
    price = port_batch.price_american_batch if american else port_batch.price_barrier_batch
    out = price(pb, 128, solver=solver, with_greeks=False, device="cpu")
    np.testing.assert_allclose(port_interp.linear_interp(pb.s_eff, s, v).numpy(), out["price"].numpy(),
                               rtol=1e-12, atol=1e-12)
