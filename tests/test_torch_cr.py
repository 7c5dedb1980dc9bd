"""Port fused march with cyclic reduction (models/pde/cr.py, kernel K4).

The level scalars against the JAX package's ``cr_level_coeffs`` (1e-13
relative) and, solving through them, against the port's
``thomas_solve_const`` (1e-10, as TestPallasCRKernel); on the CPU the march
runs its plain version (``cr.cr_march_reference``), held at float64 against
the JAX Pallas kernel ``_cr_kernel`` in interpret mode within 1e-11 of
max|V| and against the port's own scan. The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_gpu.py.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import pallas_cr as jax_cr
from finite_difference_tpu.models.pde.batch import build_trade_batch as jax_build
from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import cr
from finite_difference_tpu_torch.models.pde.batch import _solve_scan
from finite_difference_tpu_torch.models.pde.batch import build_trade_batch as port_build
from finite_difference_tpu_torch.ops.tridiag import thomas_solve_const


def mixed_kwargs(seed=1, B=8, n_steps=32, num_space_nodes=129, **over):
    """Calls and puts; up, down and double barriers; rebates at hit and at expiry."""
    rng = np.random.default_rng(seed)
    t = 0.25
    kw = dict(
        spots=list(rng.uniform(90.0, 110.0, B)), strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.4, B)), t_expiry=[t] * B, r=[0.05] * B,
        b=list(rng.uniform(0.0, 0.05, B)), is_call=[i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps, monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        lower=[80.0 if i % 4 < 2 else None for i in range(B)],
        upper=[125.0 if i % 4 != 1 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 3.0, B)), rebate_at_hit=[i % 3 == 0 for i in range(B)],
        num_space_nodes=num_space_nodes,
    )
    kw.update(over)
    return kw


def _up_and_out_calls(n_nodes):
    """TestPallasCRKernel's batch: 1-month up-and-out calls."""
    rng = np.random.default_rng(0)
    B, t = 8, 31.0 / 365.0
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[t] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=32,
        monitor_times=[[t * (k + 1) / 8.0 for k in range(8)]] * B,
        upper=[260.0] * B, num_space_nodes=n_nodes - 1,
    )


CASES = {
    ("double_mixed", 10): lambda: mixed_kwargs(seed=3, num_space_nodes=9),
    ("double_mixed", 130): lambda: mixed_kwargs(seed=4, num_space_nodes=129),
    ("up_and_out_calls", 130): lambda: _up_and_out_calls(130),
}


@functools.lru_cache(maxsize=None)
def _jax_values(case):
    kw = CASES[case]()
    dev = jax.tree.map(jnp.asarray, jax_build(**kw))
    v, _ = jax_cr.cn_barrier_solve_pallas_cr(
        dev, dev.sigma, n_nodes=case[1], n_steps=kw["n_time_steps"], trade_block=8,
        interpret=True,
    )
    return np.asarray(v)


def _diagonals(seed, B=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, -0.3, B), rng.uniform(1.8, 2.2, B), rng.uniform(-0.5, -0.3, B)


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
def test_level_coeffs_match_jax(n):
    a_l, a_c, a_u = _diagonals(n)
    want = np.asarray(jax_cr.cr_level_coeffs(jnp.asarray(a_l), jnp.asarray(a_c), jnp.asarray(a_u), n))
    got = cr.cr_level_coeffs(*(torch.as_tensor(x) for x in (a_l, a_c, a_u)), n).numpy()
    assert got.shape == (int(math.log2(n)), cr.N_SLOTS, 4)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("rows", [1, 2, 5])
def test_class_vec_matches_jax(rows):
    first, interior, last = (np.arange(3.0) + c for c in (1.0, 10.0, 100.0))
    want = np.asarray(jax_cr._class_vec(
        rows, jnp.asarray(first)[None], jnp.asarray(interior)[None], jnp.asarray(last)[None],
        jnp.float64,
    ))
    got = cr.class_vec(rows, *(torch.as_tensor(x) for x in (first, interior, last)))
    np.testing.assert_array_equal(got.numpy().T, want)


def test_level_coeffs_solve_matches_thomas():
    """Cyclic reduction through the packed scalar classes reproduces the
    port's thomas_solve_const, as TestPallasCRKernel holds JAX's."""
    n, S = 64, cr._SLOTS
    a_l, a_c, a_u = (torch.as_tensor(x) for x in _diagonals(0))
    d = torch.as_tensor(np.random.default_rng(1).normal(size=(4, n)))
    want = thomas_solve_const(a_l, a_c, a_u, d)
    lv = cr.cr_level_coeffs(a_l, a_c, a_u, n).permute(2, 0, 1)  # (B, n_levels, 16)
    cls = lambda lev, rows, name: cr.class_vec(
        rows, lv[:, lev, S[name + "_f"]], lv[:, lev, S[name + "_i"]], lv[:, lev, S[name + "_l"]]
    )
    x, stack = d, []
    for lev in range(int(math.log2(n))):
        evens, odds = x[:, 0::2], x[:, 1::2]
        stack.append(evens)
        ev_up = torch.nn.functional.pad(evens[:, 1:], (0, 1))
        x = odds - cls(lev, evens.shape[1], "alpha") * evens - cls(lev, evens.shape[1], "gamma") * ev_up
    x = x / lv[:, 0, S["b_final"], None]
    for lev in range(int(math.log2(n)) - 1, -1, -1):
        evens = stack.pop()
        half = evens.shape[1]
        x_lo = torch.nn.functional.pad(x[:, :-1], (1, 0))
        x_even = (evens - cls(lev, half, "ae") * x_lo - cls(lev, half, "ce") * x) / cls(lev, half, "be")
        x = torch.stack([x_even, x], dim=2).reshape(4, 2 * half)
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_cr_interpret(case):
    kw = CASES[case]()
    tb = port_build(device="cpu", **kw)
    kernels.reset_launch_counts()
    v = cr.cn_barrier_solve_cr(tb, tb.sigma, case[1], kw["n_time_steps"])
    assert not any(kernels.launch_counts.values())  # CPU: the plain version
    want = _jax_values(case)
    assert float(np.abs(v.numpy() - want).max()) <= 1e-11 * float(np.abs(want).max())


@pytest.mark.parametrize("n", [2, 8, 128, 256])
def test_plain_version_matches_port_scan(n):
    tb = port_build(device="cpu", **mixed_kwargs(seed=n, num_space_nodes=n + 1))
    v_ref, _ = _solve_scan(tb, tb.sigma, n + 2)
    v = cr.cn_barrier_solve_cr(tb, tb.sigma, n + 2, tb.n_steps)
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n_nodes", [100, 3, 2])
def test_requires_power_of_two_interior(n_nodes):
    tb = port_build(device="cpu", **mixed_kwargs(B=2, num_space_nodes=99))
    with pytest.raises(ValueError, match="power of two"):
        cr.cn_barrier_solve_cr(tb, tb.sigma, n_nodes, tb.n_steps)


def test_schedule_guard_raises_on_monitor_aligned_batch():
    tb = port_build(device="cpu", **mixed_kwargs(
        B=2, num_space_nodes=129, monitor_aligned=True, monitor_times=[[0.03, 0.11, 0.25]] * 2,
    ))
    with pytest.raises(ValueError, match="globally-uniform"):
        cr.cn_barrier_solve_cr(tb, tb.sigma, 130, tb.n_steps)


class TestDispatch:
    def test_cuda_wrapper_refuses_cpu_tensors(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2, num_space_nodes=129))
        prep = cr.prepare_cr(tb, tb.sigma, 130)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.cr_march_cuda(prep)

    def test_shared_memory_limit(self):
        # f64 at N = 8194: (8194 + 2.5 * 8192 + 416) values of 8 bytes > 227 KB
        assert kernels.cr_smem_bytes(8194, 8) > kernels.MAX_SMEM
        assert kernels.cr_smem_bytes(1026, 8) < 48 * 1024

    def test_other_devices_raise(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2, num_space_nodes=129))
        prep = cr.prepare_cr(tb, tb.sigma, 130)
        prep.v0 = prep.v0.to("meta")
        with pytest.raises(ValueError, match="unsupported device"):
            cr.cr_march(prep)
