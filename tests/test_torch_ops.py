"""Port ops and CN stepper against the JAX package at float64 (<= 1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import stepper as jax_stepper
from finite_difference_tpu.ops import stencils as jax_stencils
from finite_difference_tpu.ops import tridiag as jax_tridiag
from finite_difference_tpu_torch.models.pde import stepper as port_stepper
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


def test_nonuniform_central_matches_jax():
    rng = np.random.default_rng(4)
    B, N = 6, 40
    s = np.exp(np.cumsum(rng.uniform(0.01, 0.05, (B, N)), axis=1) + 4.0)
    v = rng.normal(size=(B, N)).cumsum(axis=1)
    idx = rng.integers(1, N - 1, B)
    want = jax.vmap(jax_stencils.nonuniform_central)(s, v, idx)
    got = port_stencils.nonuniform_central(T(s), T(v), T(idx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


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


def _run_both(fields, N, american, euro_put_lower, with_barrier=True):
    f = fields
    def jax_one(x_min, dx, strike, is_call, sigma, r, b, q, lower, upper, has_lower,
                has_upper, rebate, at_hit, rebate_rate, dt, theta, tau, mon, div, reset):
        bar = jax_stepper.BarrierSpec(lower, upper, has_lower, has_upper, rebate,
                                      at_hit, rebate_rate) if with_barrier else None
        return jax_stepper.cn_solve(
            jax_stepper.CNGrid(x_min, dx),
            jax_stepper.CNDynamics(strike, is_call, sigma, r, b, q),
            jax_stepper.CNSchedule(dt, theta, tau, mon, div, reset),
            N, barrier=bar, american=american,
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
        port_stepper.CNSchedule(t["dt"], t["theta"], t["tau_next"], t["monitor"], t["reset_lambda"]),
        N, barrier=bar, american=american, euro_put_lower_boundary=euro_put_lower,
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
