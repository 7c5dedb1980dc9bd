"""Port ops (tridiagonal solves, stencils, interpolation, cubic spline) and
the CN stepper, dividend jump included, against the JAX package at float64:
solves and the stepper within 1e-12, stencils and linear_interp within
1e-13 of max|value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import stepper as jax_stepper
from finite_difference_tpu.ops import interp as jax_interp
from finite_difference_tpu.ops import stencils as jax_stencils
from finite_difference_tpu.ops import tridiag as jax_tridiag
from finite_difference_tpu_torch.models.pde import stepper as port_stepper
from finite_difference_tpu_torch.ops import interp as port_interp
from finite_difference_tpu_torch.ops import stencils as port_stencils
from finite_difference_tpu_torch.ops import tridiag as port_tridiag

T = lambda a: torch.as_tensor(np.asarray(a))


class TestTridiag:
    @pytest.mark.parametrize("n", [1, 2, 7, 64, 130])
    def test_affine_scan_matches_loop(self, n):
        rng = np.random.default_rng(n)
        a, b = rng.uniform(-0.9, 0.9, (3, n)), rng.normal(size=(3, n))
        for reverse in (False, True):
            want = np.zeros_like(b)
            prev = np.zeros(3)
            order = range(n - 1, -1, -1) if reverse else range(n)
            for i in order:
                prev = a[:, i] * prev + b[:, i]
                want[:, i] = prev
            got = port_tridiag._affine_scan(T(a), T(b), reverse=reverse).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_thomas_solve_const_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        B, n = 5, 126
        a_c = rng.uniform(1.5, 40.0, B)
        a_l = -rng.uniform(0.0, 0.45, B) * a_c
        a_u = -rng.uniform(0.0, 0.45, B) * a_c
        a_u[0] = 0.3 * a_c[0]  # rho < 0: the advection-dominated sign split
        rhs = rng.normal(size=(B, n))
        want = np.asarray(jax.vmap(jax_tridiag.thomas_solve_const)(a_l, a_c, a_u, rhs))
        got = port_tridiag.thomas_solve_const(T(a_l), T(a_c), T(a_u), T(rhs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


    @pytest.mark.parametrize("n", [1, 2, 5, 64, 1022])
    def test_thomas_solve_pscan_matches_jax(self, n):
        """General diagonally dominant coefficients, arbitrary ignored corners."""
        rng = np.random.default_rng(n)
        B = 4
        dl, du = rng.uniform(-1.0, 1.0, (B, n)), rng.uniform(-1.0, 1.0, (B, n))
        d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 2.0, (B, n))
        rhs = rng.normal(size=(B, n))
        want = np.asarray(jax.jit(jax_tridiag.thomas_solve_pscan)(dl, d, du, rhs))
        got = port_tridiag.thomas_solve_pscan(T(dl), T(d), T(du), T(rhs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


    @pytest.mark.parametrize("n", [3, 8, 64, 513, 1024])
    def test_thomas_solve_matches_jax(self, n):
        """test_tridiag.py's diagonally dominant systems, JAX's sequential
        Thomas against the port's log-depth scan; and the matvec round trip."""
        rng = np.random.default_rng(4)
        dl = rng.uniform(-1.0, 1.0, (6, n))
        du = rng.uniform(-1.0, 1.0, (6, n))
        d = np.abs(dl) + np.abs(du) + rng.uniform(1.0, 2.0, (6, n))
        rhs = rng.standard_normal((6, n))
        want = np.asarray(jax_tridiag.thomas_solve(dl, d, du, rhs))
        got = port_tridiag.thomas_solve(T(dl), T(d), T(du), T(rhs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        back_j = np.asarray(jax_tridiag.tridiag_matvec(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
                                                       jnp.asarray(want)))
        back_p = port_tridiag.tridiag_matvec(T(dl), T(d), T(du), got).numpy()
        np.testing.assert_allclose(back_p, back_j, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(back_p, rhs, rtol=1e-9, atol=1e-12)

    def test_thomas_solve_const_broadcast_and_factored(self):
        """A scalar system on a 1-D rhs (test_tridiag.py's broadcast case),
        and the factored solve equal to the one-shot one bit for bit."""
        x = port_tridiag.thomas_solve_const(-0.2, 1.5, -0.2, torch.ones(16, dtype=torch.float64))
        want = np.asarray(jax_tridiag.thomas_solve_const(-0.2, 1.5, -0.2, np.ones(16)))
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-12, atol=1e-12)
        rng = np.random.default_rng(9)
        a_c = T(rng.uniform(1.5, 4.0, 3))
        a_l, a_u = -0.4 * a_c, -0.3 * a_c
        f = port_tridiag.const_factor(a_l, a_c, a_u, 77, torch.float64, "cpu")
        for _ in range(2):
            rhs = T(rng.normal(size=(3, 77)))
            assert torch.equal(port_tridiag.const_solve(f, rhs),
                               port_tridiag.thomas_solve_const(a_l, a_c, a_u, rhs))


class TestSpline:
    def _knots(self, seed, B=5, n=40):
        rng = np.random.default_rng(seed)
        x = np.exp(np.log(rng.uniform(20.0, 60.0, (B, 1))) + 0.04 * np.arange(n))
        y = np.maximum(100.0 - x, 0.0) + rng.normal(scale=0.1, size=(B, n))
        return x, y

    def test_coefficients_match_jax(self):
        x, y = self._knots(0)
        want = jax.jit(jax.vmap(jax_interp.natural_cubic_spline))(x, y)
        got = port_interp.natural_cubic_spline(T(x), T(y))
        for name in ("x", "y", "b", "c", "d"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=1e-12, atol=1e-12, err_msg=name)

    @pytest.mark.parametrize("with_idx", [False, True])
    def test_eval_matches_jax(self, with_idx):
        """Queries inside the span, on knots and beyond both ends (clamped);
        with the closed-form log-grid bracket as ``idx``."""
        x, y = self._knots(1)
        rng = np.random.default_rng(2)
        xq = np.concatenate([x - rng.uniform(0.0, 3.0, x.shape), x[:, :3] - 50.0, x[:, -3:] + 9.0], 1)
        xq[:, 5] = x[:, 7]
        idx = None
        if with_idx:
            x_min, dx = np.log(x[:, :1]), 0.04
            idx = np.floor((np.log(np.maximum(xq, x[:, :1])) - x_min) / dx).astype(np.int64)
        spline = jax.jit(jax.vmap(jax_interp.natural_cubic_spline))(x, y)
        if with_idx:
            want = jax.jit(jax.vmap(jax_interp.cubic_spline_eval))(spline, xq, idx)
        else:
            want = jax.jit(jax.vmap(jax_interp.cubic_spline_eval))(spline, xq)
        got = port_interp.cubic_spline_eval(
            port_interp.natural_cubic_spline(T(x), T(y)), T(xq), None if idx is None else T(idx)
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _grids(seed, B=6, N=40):
    rng = np.random.default_rng(seed)
    s = np.exp(np.cumsum(rng.uniform(0.01, 0.05, (B, N)), axis=1) + 4.0)
    v = rng.normal(size=(B, N)).cumsum(axis=1)
    return rng, s, v


def _close(got, want, rtol=1e-13):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rtol * np.abs(w).max())


def test_nonuniform_central_matches_jax():
    rng, s, v = _grids(4)
    idx = rng.integers(1, s.shape[1] - 1, s.shape[0])
    want = jax.vmap(jax_stencils.nonuniform_central)(s, v, idx)
    got = port_stencils.nonuniform_central(T(s), T(v), T(idx))
    _close(got, want, 1e-12)


def test_one_sided_and_cubic_stencils_match_jax():
    rng, s, v = _grids(5)
    N = s.shape[1]
    idx_f = rng.integers(0, N - 2, s.shape[0])
    idx_b = rng.integers(2, N, s.shape[0])
    _close(port_stencils.nonuniform_forward(T(s), T(v), T(idx_f)),
           jax.vmap(jax_stencils.nonuniform_forward)(s, v, idx_f))
    _close(port_stencils.nonuniform_backward(T(s), T(v), T(idx_b)),
           jax.vmap(jax_stencils.nonuniform_backward)(s, v, idx_b))
    idx_c = rng.integers(1, N - 2, s.shape[0])
    s0 = s[np.arange(s.shape[0]), idx_c] * rng.uniform(0.999, 1.001, s.shape[0])
    _close(port_stencils.local_cubic_fit(T(s), T(v), T(s0), T(idx_c)),
           jax.vmap(jax_stencils.local_cubic_fit)(s, v, s0, idx_c))
    lo, hi = rng.integers(0, 3, s.shape[0]), rng.integers(0, 3, s.shape[0])
    for a, b in zip(lo, hi):
        got = port_stencils.nearest_index(T(s), T(s0), lo=int(a), hi_offset=int(b))
        want = jax.vmap(lambda x, y: jax_stencils.nearest_index(x, y, int(a), int(b)))(s, s0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lower,upper,band,one_sided", [
    (None, None, 2, True), (None, 90.0, 2, True), (70.0, None, 3, True),
    (70.0, 90.0, 2, True), (None, 90.0, 2, False),
])
def test_barrier_aware_delta_gamma_matches_jax(lower, upper, band, one_sided):
    """Spots near and far from the barrier, so both stencils are taken."""
    rng = np.random.default_rng(6)
    B, N = 8, 60
    s = np.exp(np.log(60.0) + 0.0075 * np.arange(N))[None].repeat(B, 0)
    v = np.maximum(s - 75.0, 0.0) + rng.normal(scale=0.01, size=(B, N))
    s0 = np.linspace(62.0, 92.0, B)
    want = jax.vmap(lambda x, y, z: jax_stencils.barrier_aware_delta_gamma(
        x, y, z, lower, upper, band, one_sided))(s, v, s0)
    got = port_stencils.barrier_aware_delta_gamma(T(s), T(v), T(s0), lower, upper, band, one_sided)
    _close(got, want)


def test_linear_interp_matches_jax():
    """Inside, on nodes and beyond both ends (clamped): the row form of the
    batch drivers, and JAX's own 1-D form (``x``, ``y`` (N,), ``xq`` of any
    shape), which the port once refused with an IndexError."""
    rng, s, v = _grids(7)
    xq = np.concatenate([s[:, [0]] - 1.0, s[:, [5]], 0.5 * (s[:, [9]] + s[:, [10]]),
                         s[:, [-1]] + 2.0], axis=1)
    for j in range(xq.shape[1]):
        want = np.array([np.asarray(jax_interp.linear_interp(xq[i, j], s[i], v[i]))
                         for i in range(s.shape[0])])
        got = port_interp.linear_interp(T(np.ascontiguousarray(xq[:, j])), T(s), T(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    one_d = [
        (np.array([-1.0, 0.0, 0.5, 1.0, 3.0, 4.0, 6.0]), np.array([0.0, 1.0, 2.0, 4.0]),
         np.array([1.0, 3.0, 2.0, 5.0])),
        (np.float64(2.5), s[0], v[0]),
        (rng.uniform(s[1, 0] - 1.0, s[1, -1] + 1.0, (3, 5)), s[1], v[1]),
        (np.concatenate([s[2], s[2] + 1e-3]), s[2], v[2]),
    ]
    for q, x, y in one_d:
        want = np.asarray(jax_interp.linear_interp(q, x, y))
        got = port_interp.linear_interp(T(q), T(x), T(y)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    np.testing.assert_array_equal(
        port_interp.linear_interp(T(one_d[0][0]), T(one_d[0][1]), T(one_d[0][2])).numpy(),
        [1.0, 1.0, 2.0, 3.0, 3.5, 5.0, 5.0])


def _stepper_inputs(seed, B=6, N=66, n_steps=40):
    rng = np.random.default_rng(seed)
    t = float(rng.uniform(0.1, 1.0))
    spot = rng.uniform(85.0, 115.0, B)
    width = rng.uniform(1.5, 2.5, B)
    x_min = np.log(spot) - 0.5 * width
    dx = width / (N - 1)
    dt = np.full((B, n_steps), t / n_steps)
    theta = np.where(np.arange(n_steps) < 2, 1.0, 0.5)[None].repeat(B, 0)
    mon = np.zeros((B, n_steps), bool)
    mon[:, ::7] = True
    reset = np.zeros((B, n_steps), bool)
    reset[:, 20] = True
    fields = dict(
        x_min=x_min, dx=dx, strike=rng.uniform(90.0, 110.0, B),
        is_call=rng.integers(0, 2, B) == 1, sigma=rng.uniform(0.15, 0.45, B),
        r=rng.uniform(0.0, 0.1, B), b=rng.uniform(-0.02, 0.1, B),
        q=rng.uniform(0.0, 0.03, B),
        lower=np.full(B, 75.0), upper=np.full(B, 135.0),
        has_lower=np.arange(B) % 2 == 0, has_upper=np.arange(B) % 3 != 0,
        rebate=rng.uniform(0.0, 2.0, B), rebate_at_hit=np.arange(B) % 2 == 1,
        rebate_rate=rng.uniform(0.0, 0.1, B),
        dt=dt, theta=theta, tau_next=np.cumsum(dt, axis=1), monitor=mon,
        div_amount=np.zeros((B, n_steps)), reset_lambda=reset,
    )
    return fields, N


def _run_both(fields, N, american, euro_put_lower, with_barrier=True, with_dividends=False):
    f = fields
    def jax_one(x_min, dx, strike, is_call, sigma, r, b, q, lower, upper, has_lower,
                has_upper, rebate, at_hit, rebate_rate, dt, theta, tau, mon, div, reset):
        bar = jax_stepper.BarrierSpec(lower, upper, has_lower, has_upper, rebate,
                                      at_hit, rebate_rate) if with_barrier else None
        return jax_stepper.cn_solve(
            jax_stepper.CNGrid(x_min, dx),
            jax_stepper.CNDynamics(strike, is_call, sigma, r, b, q),
            jax_stepper.CNSchedule(dt, theta, tau, mon, div, reset),
            N, barrier=bar, american=american, with_dividends=with_dividends,
            euro_put_lower_boundary=euro_put_lower,
        )
    names = ("x_min", "dx", "strike", "is_call", "sigma", "r", "b", "q", "lower",
             "upper", "has_lower", "has_upper", "rebate", "rebate_at_hit",
             "rebate_rate", "dt", "theta", "tau_next", "monitor", "div_amount",
             "reset_lambda")
    v_j, s_j = jax.vmap(jax_one)(*(jnp.asarray(f[k]) for k in names))
    t = {k: T(v) for k, v in f.items()}
    bar = port_stepper.BarrierSpec(
        t["lower"], t["upper"], t["has_lower"], t["has_upper"], t["rebate"],
        t["rebate_at_hit"], t["rebate_rate"],
    ) if with_barrier else None
    v_p, s_p = port_stepper.cn_solve(
        port_stepper.CNGrid(t["x_min"], t["dx"]),
        port_stepper.CNDynamics(t["strike"], t["is_call"], t["sigma"], t["r"], t["b"], t["q"]),
        port_stepper.CNSchedule(t["dt"], t["theta"], t["tau_next"], t["monitor"],
                                t["div_amount"], t["reset_lambda"]),
        N, barrier=bar, american=american, with_dividends=with_dividends,
        euro_put_lower_boundary=euro_put_lower,
    )
    return (v_p.numpy(), s_p.numpy()), (np.asarray(v_j), np.asarray(s_j))


@pytest.mark.parametrize(
    "american,euro_put_lower,with_barrier",
    [(False, True, True), (True, False, False), (True, True, True), (False, False, False)],
)
def test_cn_solve_matches_jax(american, euro_put_lower, with_barrier):
    fields, N = _stepper_inputs(seed=int(american) + 2 * int(euro_put_lower))
    (v_p, s_p), (v_j, s_j) = _run_both(fields, N, american, euro_put_lower, with_barrier)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-14, atol=0)
    np.testing.assert_allclose(v_p, v_j, rtol=1e-12, atol=1e-12)


def test_cn_solve_runs_of_theta_and_dt_match_jax():
    """A schedule whose (theta, dt) changes in runs per trade (Rannacher
    restarts, piecewise dt): the systems are factored once per run. And the
    plan given beforehand gives the same grids as the one read inside."""
    fields, N = _stepper_inputs(seed=8)
    B, S = fields["dt"].shape
    dt = np.where(np.arange(S) < 17, 0.6, 1.3)[None] * fields["dt"]
    dt[1::2, 25:] *= 0.9  # a run boundary for half the trades only
    theta = fields["theta"].copy()
    theta[:, 30:32] = 1.0
    fields.update(dt=dt, theta=theta, tau_next=np.cumsum(dt, axis=1))
    (v_p, _), (v_j, _) = _run_both(fields, N, True, False, with_barrier=True)
    np.testing.assert_allclose(v_p, v_j, rtol=1e-12, atol=1e-12)
    sch = port_stepper.CNSchedule(*(T(fields[k]) for k in (
        "dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda")))
    plan = port_stepper.scan_plan(sch, with_dividends=False)
    assert plan.runs == (0, 2, 17, 25, 30, 32) and plan.reset_cols == (20,)
    t = {k: T(v) for k, v in fields.items()}
    v_plan, _ = port_stepper.cn_solve(
        port_stepper.CNGrid(t["x_min"], t["dx"]),
        port_stepper.CNDynamics(t["strike"], t["is_call"], t["sigma"], t["r"], t["b"], t["q"]),
        sch, N, barrier=port_stepper.BarrierSpec(
            t["lower"], t["upper"], t["has_lower"], t["has_upper"], t["rebate"],
            t["rebate_at_hit"], t["rebate_rate"]),
        american=True, euro_put_lower_boundary=False, plan=plan,
    )
    np.testing.assert_array_equal(v_plan.numpy(), v_p)


def test_cn_solve_with_dividends_matches_jax():
    """American calls and puts with cash dividends on two steps (one trade
    without), lambda resets after each: the spline jump and the call's
    exercise check at ex-div."""
    fields, N = _stepper_inputs(seed=5)
    div = np.zeros_like(fields["dt"])
    div[:, 12] = np.linspace(0.5, 2.0, div.shape[0])
    div[:, 27] = 1.2
    div[0] = 0.0
    fields["div_amount"] = div
    fields["reset_lambda"] = np.zeros_like(fields["reset_lambda"])
    fields["reset_lambda"][:, [0, 13, 28]] = True
    (v_p, _), (v_j, _) = _run_both(fields, N, True, False, with_barrier=False, with_dividends=True)
    (v_nodiv, _), _ = _run_both({**fields, "div_amount": 0.0 * div}, N, True, False, with_barrier=False)
    assert np.abs(v_p - v_nodiv)[1:].max() > 1e-2  # the jumps moved the prices
    np.testing.assert_allclose(v_p, v_j, rtol=1e-12, atol=1e-12)
