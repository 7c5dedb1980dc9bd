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
from fractions import Fraction

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
        # one trade: about 2 n values; f64 at N = 16386 takes 260 KB >
        # 227 KB, N = 8194 fits one trade per block
        assert kernels.cr_smem_bytes(16386, 8) > kernels.MAX_SMEM
        assert kernels.cr_block(16386, 8) is None
        assert kernels.cr_block(8194, 8) == (1, 134528)
        assert kernels.cr_smem_bytes(1026, 8) < 48 * 1024

    # (N, bytes per value) -> (trades per block, shared bytes per block):
    # 4 trades of one warp each while the block fits in 227 KB
    @pytest.mark.parametrize(
        "n_nodes,item,want",
        [(1026, 4, (4, 37856)), (1026, 8, (4, 75712)), (2050, 8, (4, 142464)),
         (4098, 8, (2, 137376)), (10, 4, (4, 1984))],
    )
    def test_launch_config_mirror(self, n_nodes, item, want):
        assert kernels.cr_block(n_nodes, item) == want
        # the value row, the buffers of the levels of more than 32 rows but
        # the first (none at n <= 64), 32 level scalars and 3 reciprocals
        # per level and set, and 1/b_final per set
        n = n_nodes - 2
        levels = int(math.log2(n))
        buffers = n - 64 if n > 64 else 0
        assert kernels.cr_smem_bytes(n_nodes, item) == (n + buffers + 38 * levels + 2) * item

    def test_resident_trades_from_shared_memory(self):
        # at N=1026 f32 a block of 4 trades takes 37 KB; an SM's 228 KB,
        # with 1 KB reserved per block, holds 6 such blocks: 24 trades
        # where registers allow, above the 16 the design aims for (the
        # card's occupancy API reports what it gets); f64 holds 3 blocks
        for item, want in ((4, 24), (8, 12)):
            per_block, smem = kernels.cr_block(1026, item)
            assert 228 * 1024 // (smem + 1024) * per_block == want

    def test_other_devices_raise(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2, num_space_nodes=129))
        prep = cr.prepare_cr(tb, tb.sigma, 130)
        prep.v0 = prep.v0.to("meta")
        with pytest.raises(ValueError, match="unsupported device"):
            cr.cr_march(prep)


def _rn32(x):
    """The float32 nearest to the Fraction x (ties to even)."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.int32)) & 1))


def _div_fast32(a, b):
    """csrc/cr_march.cu div_fast at float32, each FMA rounded once exactly:
    q0 = a*y, y = RN(1/b), one correction with the exact remainder; |a| <
    2^-90 scaled by 2^100 first, and a scaled quotient on a midpoint of the
    subnormal grid stepped one ulp to the exact quotient's side."""
    F = lambda x: Fraction(float(x))
    fma = lambda x, y, z: _rn32(F(x) * F(y) + F(z))
    y = np.float32(1) / b
    small = abs(a) < np.float32(2.0**-90)
    a_s = np.float32(a * np.float32(2.0**100)) if small else a
    q0 = np.float32(a_s * y)
    qs = fma(y, fma(-b, q0, a_s), q0)
    rs = fma(-b, qs, a_s)
    gap = np.float32(qs - np.float32(np.float32(qs * np.float32(2.0**-100)) * np.float32(2.0**100)))
    if small and abs(gap) == np.float32(2.0**-50) and rs != 0:
        up = (rs > 0) == (b > 0)
        qs = (qs.view(np.int32) + (1 if up == (qs > 0) else -1)).astype(np.int32).view(np.float32)
    return np.float32(qs * np.float32(2.0**-100)) if small else qs


@pytest.mark.parametrize("kind", ["normal", "subnormal", "midpoint"])
def test_kernel_division_is_correctly_rounded(kind):
    """The CR kernel's branch-free division gives IEEE a / b bit for bit in
    float32: random operands in its range, subnormal dividends, and
    quotients built to land on a midpoint of the subnormal grid."""
    rng = np.random.default_rng({"normal": 0, "subnormal": 1, "midpoint": 2}[kind])
    with np.errstate(all="ignore"):
        for _ in range(300):
            if kind == "normal":
                a = np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-90, 90))
                b = np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-20, 20))
            elif kind == "subnormal":
                a = np.float32(rng.integers(1, 2**20)) * np.float32(2.0**-149)
                b = np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-3, 10))
            else:
                m, k = int(rng.integers(2**10, 2**20)), int(rng.integers(1, 2**9))
                a, b = np.float32(m) * np.float32(2.0**-149), np.float32(2 * m / (2 * k + 1))
            a = a * np.float32(rng.choice([-1, 1]))
            assert _div_fast32(a, b).view(np.int32) == np.float32(a / b).view(np.int32), (a, b)
