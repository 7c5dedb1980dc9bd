"""Port fused march with Hillis–Steele scans (models/pde/fused.py, kernel K3).

On the CPU the march runs its plain version (``fused.hs_march_reference``),
held at float64 against the JAX package's Pallas kernel ``_kernel`` in
interpret mode (``cn_barrier_solve_pallas(interpret=True)``) and against its
XLA twin ``cn_barrier_solve_hoisted``, both within 1e-12 of max|V|; the
entry point ``price_barrier_batch_fused`` against
``price_barrier_batch_pallas`` on all five outputs at 1e-9, the bar of the
JAX package's TestPallasCNKernel. The CUDA kernel itself is held against
the plain version on the card in tests/test_torch_gpu.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import pallas_kernel as jax_pk
from finite_difference_tpu.models.pde.batch import build_trade_batch as jax_build
from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import fused
from finite_difference_tpu_torch.models.pde.batch import _solve_scan, build_american_batch
from finite_difference_tpu_torch.models.pde.batch import build_trade_batch as port_build

KEYS = ("price", "vega", "delta", "gamma", "theta")


def _up_and_out_calls():
    """The ``small_batch`` of tests/test_pallas_kernel.py."""
    rng = np.random.default_rng(0)
    B, t = 8, 31.0 / 365.0
    return dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[t] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=64,
        monitor_times=[[t * (k + 1) / 8.0 for k in range(8)]] * B,
        upper=[260.0] * B, num_space_nodes=255,
    ), 256


def mixed_kwargs(seed=1, B=8, n_steps=32, num_space_nodes=127, **over):
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


def _double_mixed():
    return mixed_kwargs(), 128


def _rebate_at_expiry():
    """TestPallasCNKernel.test_rebate_at_expiry's batch: a rebate of 5 paid at expiry."""
    B, t = 8, 0.25
    return dict(
        spots=[100.0] * B, strikes=[100.0] * B, sigmas=[0.3] * B, t_expiry=[t] * B,
        r=[0.05] * B, b=[0.05] * B, is_call=[True] * B, n_time_steps=32,
        monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        upper=[120.0] * B, rebate=[5.0] * B, num_space_nodes=127,
    ), 128


CASES = {
    "up_and_out_calls": _up_and_out_calls,
    "double_mixed": _double_mixed,
    "rebate_at_expiry": _rebate_at_expiry,
}


@functools.lru_cache(maxsize=None)
def _jax_values(name):
    """The JAX package's V from the Pallas kernel (interpret) and its XLA
    twin, built once per case."""
    kw, n_nodes = CASES[name]()
    dev = jax.tree.map(jnp.asarray, jax_build(**kw))
    n_steps = kw["n_time_steps"]
    v_k, _ = jax_pk.cn_barrier_solve_pallas(
        dev, dev.sigma, n_nodes=n_nodes, n_steps=n_steps, trade_block=8, interpret=True
    )
    v_h, _ = jax_pk.cn_barrier_solve_hoisted(dev, dev.sigma, n_nodes=n_nodes, n_steps=n_steps)
    return np.asarray(v_k), np.asarray(v_h)


def _assert_rel(got, want, tol):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("n_int", [1, 62, 1022])
def test_solver_vectors_match_jax(n_int):
    rng = np.random.default_rng(n_int)
    a_l, a_u = rng.uniform(-30.0, -0.1, 6), rng.uniform(-30.0, -0.1, 6)
    a_c = 1.0 - a_l - a_u + rng.uniform(0.0, 0.1, 6)
    want = np.asarray(jax_pk._solver_vectors(
        jnp.asarray(a_l), jnp.asarray(a_c), jnp.asarray(a_u), n_int, jnp.float64
    )).T
    got = fused.solver_vectors(*(torch.as_tensor(x) for x in (a_l, a_c, a_u)), n_int).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_interpret(name):
    kw, n_nodes = CASES[name]()
    tb = port_build(device="cpu", **kw)
    kernels.reset_launch_counts()
    v = fused.cn_barrier_solve_fused(tb, tb.sigma, n_nodes, kw["n_time_steps"])
    assert not any(kernels.launch_counts.values())  # CPU: the plain version
    _assert_rel(v.numpy(), _jax_values(name)[0], 1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_hoisted_matches_jax_hoisted(name):
    kw, n_nodes = CASES[name]()
    tb = port_build(device="cpu", **kw)
    v = fused.cn_barrier_solve_hoisted(tb, tb.sigma, n_nodes, kw["n_time_steps"])
    _assert_rel(v.numpy(), _jax_values(name)[1], 1e-12)


@pytest.mark.parametrize("name", ["up_and_out_calls", "double_mixed"])
def test_price_matches_price_barrier_batch_pallas(name):
    kw, n_nodes = CASES[name]()
    ref = jax_pk.price_barrier_batch_pallas(
        jax_build(**kw), n_nodes=n_nodes, with_greeks=True, trade_block=8, interpret=True
    )
    got = fused.price_barrier_batch_fused(port_build(device="cpu", **kw), n_nodes, device="cpu")
    assert set(got) == set(ref)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-9, atol=1e-9, err_msg=k)


def test_price_only_has_price_and_a_rebate_floor():
    kw, n_nodes = _rebate_at_expiry()
    got = fused.price_barrier_batch_fused(
        port_build(device="cpu", **kw), n_nodes, with_greeks=False, device="cpu"
    )
    assert set(got) == {"price"}
    assert bool((got["price"] > 0).all())  # knock-out near-certain trades keep ~PV(rebate)


# n_nodes 127, 128, 129: the phantom rows of the kernel's last threads differ
@pytest.mark.parametrize("n_nodes", [127, 128, 129])
def test_plain_version_matches_port_scan(n_nodes):
    tb = port_build(device="cpu", **mixed_kwargs(seed=n_nodes, num_space_nodes=n_nodes - 1))
    v_ref, _ = _solve_scan(tb, tb.sigma, n_nodes)
    v = fused.cn_barrier_solve_fused(tb, tb.sigma, n_nodes, tb.n_steps)
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-9, atol=1e-9)


class TestGuards:
    def test_monitor_aligned_batch_raises(self):
        tb = port_build(device="cpu", **mixed_kwargs(
            B=2, monitor_aligned=True, monitor_times=[[0.03, 0.11, 0.25]] * 2,
        ))
        with pytest.raises(ValueError, match="globally-uniform"):
            fused.cn_barrier_solve_fused(tb, tb.sigma, 128, tb.n_steps)
        with pytest.raises(ValueError, match="globally-uniform"):
            fused.price_barrier_batch_fused(tb, 128, device="cpu")

    def test_dividend_batch_raises(self):
        tb = build_american_batch(
            spots=[100.0] * 2, strikes=[100.0] * 2, sigmas=[0.3] * 2, t_expiry=[1.0] * 2,
            r=[0.05] * 2, b=[0.03] * 2, is_call=[False] * 2, n_time_steps=20,
            dividends_tau=[[(0.5, 1.0)]] * 2, num_space_nodes=126, device="cpu",
        )
        with pytest.raises(ValueError, match="no dividends"):
            fused.cn_barrier_solve_fused(tb, tb.sigma, 128, tb.n_steps)

    def test_rannacher_pattern_must_match(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2))
        with pytest.raises(ValueError, match="3-step Rannacher"):
            fused.cn_barrier_solve_fused(tb, tb.sigma, 128, tb.n_steps, rannacher_steps=3)


class TestDispatch:
    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tb = port_build(device="cpu", **mixed_kwargs(B=2))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fused.price_barrier_batch_fused(tb, 128)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2))
        prep = fused.prepare_fused(tb, tb.sigma, 128)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.hs_march_cuda(prep)

    @pytest.mark.parametrize("n_nodes,want", [
        (3, ("warp", 1, 128)), (33, ("warp", 2, 128)), (1024, ("warp", 32, 128)),
        (1025, ("block", 4, 288)), (4096, ("block", 4, 1024)),
    ])
    def test_launch_rule_picks_the_design_by_nodes(self, n_nodes, want):
        """One warp per trade (4 per block of 128 threads) up to 1024 nodes,
        R the least power of two with 32 R >= N; one block per trade above."""
        assert kernels.hs_block(n_nodes) == want

    def test_cuda_wrapper_refuses_too_many_nodes(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=1, n_steps=4, num_space_nodes=4096))
        prep = fused.prepare_fused(tb, tb.sigma, 4097)
        with pytest.raises(ValueError, match="4096"):
            kernels.hs_march_cuda(prep)

    def test_other_devices_raise(self):
        tb = port_build(device="cpu", **mixed_kwargs(B=2))
        prep = fused.prepare_fused(tb, tb.sigma, 128)
        prep.v0 = prep.v0.to("meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fused.hs_march(prep)


@pytest.mark.parametrize("n_nodes,extra_per_lane", [(1024, 5 * 32 + 15), (128, 5 * 4 + 15)])
def test_chip_smoke_counts_the_warp_design(n_nodes, extra_per_lane):
    """What chip_smoke.py reports for K3 from the main path's shapes (B=4096,
    512 steps, f32): each input once and V out once, 9 + 10 + 6N + N +
    2 steps + 2N words per trade (about 0.168 GB at N=1024), and per step
    and scan 32 lanes composing, scanning and applying their R rows."""
    import types

    import chip_smoke

    prep = types.SimpleNamespace(
        v0=torch.empty(4096, n_nodes, device="meta"), n_steps=512,
        trade=torch.empty(4096, 9, device="meta"), coef=torch.empty(2, 4096, 5, device="meta"),
        solver=torch.empty(2, 3, 4096, n_nodes, device="meta"),
        omask=torch.empty(4096, n_nodes, device="meta"), tau=torch.empty(4096, 512, device="meta"),
        mon=torch.empty(4096, 512, device="meta"),
    )
    words = 4096 * (9 + 10 + 6 * n_nodes + n_nodes + 2 * 512 + 2 * n_nodes)
    assert chip_smoke.hs_design_bytes(prep) == 4 * words
    if n_nodes == 1024:
        assert 4 * words == pytest.approx(0.168e9, rel=1e-2)
    bound = chip_smoke.fused_bound(prep, "hs")
    assert bound["bytes"] == 4 * words  # the bound's bytes: the same inputs, once each
    assert bound["extra_flops"] == 4096 * 512 * 2 * 32 * extra_per_lane
