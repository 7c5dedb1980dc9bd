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
        assert spike.spike_p(1024) == 32  # the main path: one warp per trade
        assert spike.spike_p(128) == 32
        assert spike.spike_p(200) == 16
        assert spike.spike_p(152) == 8
        assert spike.spike_p(6) is None

    @pytest.mark.parametrize(
        "n_nodes,P,match",
        [(40, 32, "too small"), (128, 33, r"\[1, 32\]"), (14, 8, "too small")],
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
        assert spike.spike_p(n_nodes) == 32
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
        prep = spike.prepare_spike(tb, tb.sigma, n_nodes, spike.spike_p(n_nodes), set_defs, american=True)
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
