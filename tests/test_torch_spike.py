"""Port SPIKE march (models/pde/spike.py and its CUDA kernel), both branches.

On the CPU the march runs its plain version, held against the JAX Pallas
kernel in interpret mode at the JAX P=8 (<= 1e-11) and against the port's
own scan at the port's P (<= 1e-9); the American branch with dividend
jumps and lambda resets between launches. The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu.models.pde.batch import build_trade_batch as jax_build
from finite_difference_tpu.models.pde.pallas_kernel import cn_barrier_solve_spike as jax_spike
from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import spike
from finite_difference_tpu_torch.models.pde.batch import (
    _solve_scan,
    _solve_scan_american,
    _spike_schedule_impl,
    build_american_batch,
)
from finite_difference_tpu_torch.models.pde.batch import build_trade_batch as port_build


def _kwargs(seed=0, B=8, n_steps=32, num_space_nodes=127, **over):
    rng = np.random.default_rng(seed)
    t = 0.25
    kw = dict(
        spots=list(rng.uniform(90.0, 110.0, B)),
        strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.4, B)),
        t_expiry=[t] * B,
        r=[0.05] * B,
        b=list(rng.uniform(0.0, 0.05, B)),
        is_call=[i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps,
        monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        lower=[80.0 if i % 4 < 2 else None for i in range(B)],
        upper=[125.0 if i % 4 != 1 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 3.0, B)),
        rebate_at_hit=[i % 3 == 0 for i in range(B)],
        num_space_nodes=num_space_nodes,
    )
    kw.update(over)
    return kw


class TestShape:
    def test_port_p(self):
        assert spike.spike_p(1024, 4096) == 32  # the main path: one warp per trade
        assert spike.spike_p(128, 8) == 32
        assert spike.spike_p(200, 8) == 16
        assert spike.spike_p(152, 8) == 8
        assert spike.spike_p(6, 8) is None

    # at most 2048 trades take P=64 where its chunks keep >= 8 rows (not at
    # N=400 or 257); N=1026 leaves too many pad rows for 64
    @pytest.mark.parametrize(
        "n_nodes,batch_size,P",
        [(1024, 4096, 32), (1024, 2049, 32), (1024, 2048, 64), (1024, 256, 64),
         (1024, 1, 64), (2048, 256, 64), (513, 256, 64), (512, 256, 64), (400, 256, 16),
         (257, 8, 32), (1026, 256, 32), (200, 8, 16), (6, 8, None)],
    )
    def test_batch_size_rule(self, n_nodes, batch_size, P):
        assert spike.spike_p(n_nodes, batch_size) == P
        if P is not None:
            _, m, _ = spike.spike_shape(n_nodes, P)  # the grid admits it
            assert P <= 32 or m >= spike.WIDE_MIN_ROWS

    # a P of several warps comes first, the one-warp P last (the prep's
    # choice where the interface guard refuses the first)
    @pytest.mark.parametrize(
        "n_nodes,batch_size,choices",
        [(1024, 256, (64, 32)), (1024, 4096, (32,)), (513, 256, (64, 32)),
         (400, 256, (16,)), (6, 8, ())],
    )
    def test_choices(self, n_nodes, batch_size, choices):
        assert spike.spike_p_choices(n_nodes, batch_size) == choices

    @pytest.mark.parametrize(
        "n_nodes,P,match",
        [(40, 32, "too small"), (128, 33, r"\[1, 32\]"), (14, 8, "too small"),
         (1024, 96, "or 64 or 128"), (1024, 256, "P/32 warps"), (200, 64, "too small")],
    )
    def test_shape_checks_raise(self, n_nodes, P, match):
        with pytest.raises(ValueError, match=match):
            spike.spike_shape(n_nodes, P)

    def test_segments_must_tile(self):
        tb = port_build(device="cpu", **_kwargs(B=2))
        with pytest.raises(ValueError, match="must tile"):
            spike.cn_barrier_solve_spike(
                tb, tb.sigma, 128, 32, segments=((0, 2, 0), (3, 32, 1)),
                set_defs=((1.0, 0), (0.5, 0)),
            )

    def test_default_segments_reject_piecewise_dt(self):
        tb = port_build(device="cpu", **_kwargs(
            B=2, monitor_aligned=True, monitor_times=[[0.03, 0.11, 0.25]] * 2,
        ))
        with pytest.raises(ValueError, match="globally-uniform"):
            spike.cn_barrier_solve_spike(tb, tb.sigma, 128, tb.n_steps)


class TestTwinParity:
    def test_twin_matches_jax_pallas_interpret_p8(self):
        kw = _kwargs(seed=1)
        dev = jax.tree.map(jnp.asarray, jax_build(**kw))
        v_ref, _ = jax_spike(
            dev, dev.sigma, n_nodes=128, n_steps=32, trade_block=8, p_chunks=8,
            interpret=True,
        )
        tb = port_build(device="cpu", **kw)
        v = spike.cn_barrier_solve_spike(tb, tb.sigma, 128, 32, p_chunks=8)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-11, atol=1e-11)

    # n_int + 1 = 126, 127, 128: pad rows 3, 2, 1 (a multiple of P at 129)
    @pytest.mark.parametrize("n_nodes", [127, 128, 129])
    def test_twin_at_port_p_matches_port_scan(self, n_nodes):
        assert spike.spike_p(n_nodes, 8) == 32
        tb = port_build(device="cpu", **_kwargs(seed=n_nodes, num_space_nodes=n_nodes - 1))
        v_ref, _ = _solve_scan(tb, tb.sigma, n_nodes)
        v = spike.cn_barrier_solve_spike(tb, tb.sigma, n_nodes, 32)
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-9, atol=1e-9)

    def test_monitor_aligned_segments_match_port_scan(self):
        tb = port_build(device="cpu", **_kwargs(
            seed=4, monitor_aligned=True, n_steps=40,
            monitor_times=[[0.02, 0.09, 0.13, 0.25]] * 8,
        ))
        segments, set_defs, _, _ = _spike_schedule_impl(tb, 128)
        assert len(segments) >= 4 and len(set_defs) >= 4
        v_ref, _ = _solve_scan(tb, tb.sigma, 128)
        v = spike.cn_barrier_solve_spike(
            tb, tb.sigma, 128, tb.n_steps, segments=segments, set_defs=set_defs
        )
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-9, atol=1e-9)


def _american_kwargs(seed=0, B=6, n_steps=40, num_space_nodes=127, is_call=None):
    """Two cash dividends per trade (so lambda resets at each segment start)."""
    rng = np.random.default_rng(seed)
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)),
        strikes=[100.0] * B,
        sigmas=list(rng.uniform(0.15, 0.4, B)),
        t_expiry=[1.0] * B,
        r=[0.06] * B,
        b=list(rng.uniform(0.0, 0.06, B)),
        is_call=[is_call] * B if is_call is not None else [i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps,
        dividends_tau=[[(0.3, 1.5), (0.7, 1.0)]] * B,
        num_space_nodes=num_space_nodes,
    )


class TestAmerican:
    def test_twin_matches_jax_pallas_interpret_p8(self):
        """American puts with dividends and resets, P=8: the port's plain
        march with its between-launch jumps against the JAX kernel."""
        kw = _american_kwargs(seed=1, B=8, n_steps=16, num_space_nodes=65, is_call=False)
        jb = jax_batch.build_american_batch(**kw)
        segments, set_defs, div_steps, reset_steps = jax_batch._spike_schedule_impl(jb, 66, 64)
        assert div_steps and reset_steps
        dev = jax.tree.map(jnp.asarray, jb)
        v_ref, _ = jax_spike(
            dev, dev.sigma, n_nodes=66, n_steps=16, trade_block=8, p_chunks=8,
            interpret=True, segments=segments, set_defs=set_defs, american=True,
            div_steps=div_steps, reset_steps=reset_steps,
        )
        tb = build_american_batch(device="cpu", **kw)
        v = spike.cn_barrier_solve_spike(
            tb, tb.sigma, 66, 16, p_chunks=8, segments=segments, set_defs=set_defs,
            american=True, div_steps=div_steps, reset_steps=reset_steps,
        )
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-11, atol=1e-11)

    # pad rows 3, 2, 1 at P=32 (N = 127, 128, 129) and P=8 at N=152
    @pytest.mark.parametrize("n_nodes", [127, 128, 129, 152])
    @pytest.mark.parametrize("is_call", [False, True])
    def test_twin_matches_port_scan_and_keeps_pads_zero(self, n_nodes, is_call):
        """Calls restart Rannacher after each dividend, puts do not, so the
        two have different segmentations."""
        tb = build_american_batch(device="cpu", **_american_kwargs(
            seed=n_nodes, num_space_nodes=n_nodes - 1, is_call=is_call
        ))
        segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, n_nodes)
        assert len(div_steps) == 2 and len(reset_steps) == 2
        prep = spike.prepare_spike(
            tb, tb.sigma, n_nodes, spike.spike_p(n_nodes, tb.batch_size), set_defs, american=True
        )
        pads = torch.arange(prep.v0.shape[1]).view(prep.m, prep.P).T.reshape(-1)[prep.n_int:]
        v, e, lam = prep.v0, prep.edge0, torch.zeros_like(prep.v0)
        for k0, k1, t in segments:
            v, e, lam = spike.spike_march_reference(prep, t, v, e, k0, k1, lam)
            assert torch.all(v[:, pads] == 0) and torch.all(lam[:, pads] == 0)
            assert float(lam.min()) >= 0.0
        v_ref, _ = _solve_scan_american(tb, tb.sigma, n_nodes, with_dividends=True)
        v = spike.cn_barrier_solve_spike(
            tb, tb.sigma, n_nodes, tb.n_steps, segments=segments, set_defs=set_defs,
            american=True, div_steps=div_steps, reset_steps=reset_steps,
        )
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-9, atol=1e-9)

    def test_lam_must_match_the_branch(self):
        tb = build_american_batch(device="cpu", **_american_kwargs(B=2))
        prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),), american=True)
        with pytest.raises(ValueError, match="lam is required"):
            spike.spike_march_reference(prep, 0, prep.v0, prep.edge0, 0, 2)
        with pytest.raises(ValueError, match="American prep"):
            kernels.spike_march_cuda(prep, 0, prep.v0, prep.edge0, 0, 2)
        with pytest.raises(ValueError, match="American batches only"):
            spike.cn_barrier_solve_spike(
                tb, tb.sigma, 128, 2, segments=((0, 2, 0),), set_defs=((1.0, 0),), div_steps=(1,)
            )


def _port_outputs_at_p(tb, n_nodes, P, american):
    """The port's price and greeks through the plain SPIKE march at P chunks."""
    segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, n_nodes)
    if not american:
        div_steps, reset_steps = (), ()
    dv_sigma, sigmas = port_batch._vol_points(tb, None, True)
    values = [
        spike.cn_barrier_solve_spike(
            tb, sig, n_nodes, tb.n_steps, p_chunks=P, segments=segments, set_defs=set_defs,
            american=american, div_steps=div_steps, reset_steps=reset_steps,
        )
        for sig in sigmas
    ]
    return port_batch._outputs_of(tb, n_nodes, values, dv_sigma, with_theta=not american)


class TestSeveralWarpsPerTrade:
    """P = 64 and 128 (chunk j = 32*warp + lane; the interface scans run
    per 32 chunks, then the carry across them) against the JAX package's
    scan route at float64 (1e-9), on N=257 grids: m = 4 and 2 rows per
    chunk."""

    @pytest.mark.parametrize("P", [64, 128])
    def test_barrier_matches_jax_scan(self, P):
        kw = _kwargs(seed=P, num_space_nodes=256)
        ref = jax_batch.price_barrier_batch(jax_build(**kw), n_nodes=257, solver="scan")
        got = _port_outputs_at_p(port_build(device="cpu", **kw), 257, P, american=False)
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("P", [64, 128])
    @pytest.mark.parametrize("is_call", [False, True])
    def test_american_matches_jax_scan(self, P, is_call):
        kw = _american_kwargs(seed=P, n_steps=32, num_space_nodes=256, is_call=is_call)
        ref = jax_batch.price_american_batch(
            jax_batch.build_american_batch(**kw), n_nodes=257, solver="scan"
        )
        got = _port_outputs_at_p(build_american_batch(device="cpu", **kw), 257, P, american=True)
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-9, atol=1e-9)

    def test_guard_refusing_the_wide_p_gives_the_one_warp_p(self):
        """A small drift-dominated batch (sigma 1% against a carry of 30%,
        8 steps) at N=1024: the rule's first choice, P=64, makes chunks of
        16 rows whose tips break the interface system's dominance (row sum
        1.25), while P=32 keeps it (0.93). The route prices at P=32 and
        matches the JAX scan (1e-9); an explicit P=64 raises."""
        B, n_nodes = 2, 1024
        kw = dict(
            spots=[100.0, 104.0], strikes=[100.0] * B, sigmas=[0.01] * B, t_expiry=[1.0] * B,
            r=[0.05] * B, b=[0.3] * B, is_call=[True] * B, n_time_steps=8,
            num_space_nodes=n_nodes - 1, upper=[400.0] * B, monitor_times=[[0.5, 1.0]] * B,
        )
        tb = port_build(device="cpu", **kw)
        set_defs = spike.default_segments(tb.n_steps)[1]
        assert spike.spike_p_choices(n_nodes, B) == (64, 32)
        with pytest.raises(ValueError, match="unsafe .* at P=64"):
            spike.prepare_spike(tb, tb.sigma, n_nodes, 64, set_defs)
        assert spike.prepare_spike(tb, tb.sigma, n_nodes, None, set_defs).P == 32
        ref = jax_batch.price_barrier_batch(jax_build(**kw), n_nodes=n_nodes, solver="scan")
        got = port_batch.price_barrier_batch(tb, n_nodes, solver="spike", device="cpu")
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-9, atol=1e-9)


class TestDispatch:
    def test_cpu_runs_the_plain_version_and_launches_nothing(self):
        tb = port_build(device="cpu", **_kwargs(B=3))
        prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),))
        kernels.reset_launch_counts()
        got = spike.spike_march(prep, 0, prep.v0, prep.edge0, 0, 2)
        want = spike.spike_march_reference(prep, 0, prep.v0, prep.edge0, 0, 2)
        assert not any(kernels.launch_counts.values())
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        tb = port_build(device="cpu", **_kwargs(B=2))
        prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),))
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.spike_march_cuda(prep, 0, prep.v0, prep.edge0, 0, 2)
        am = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),), american=True)
        lam = torch.zeros_like(am.v0)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.spike_march_american_cuda(am, 0, am.v0, am.edge0, lam, 0, 2)
        with pytest.raises(ValueError, match="needs an American prep"):
            kernels.spike_march_american_cuda(prep, 0, prep.v0, prep.edge0, lam, 0, 2)

    def test_other_devices_raise(self):
        tb = port_build(device="cpu", **_kwargs(B=2))
        prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),))
        with pytest.raises(ValueError, match="unsupported device"):
            spike.spike_march(prep, 0, prep.v0.to("meta"), prep.edge0, 0, 2)

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
        monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build()
