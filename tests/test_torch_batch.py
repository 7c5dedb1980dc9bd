"""The port's main path, price_barrier_batch, against the JAX package.

Both routes of the port on the CPU at float64 (``solver="spike"``, the
SPIKE march's plain version, and ``solver="scan"``) are held against the
JAX package's ``solver="spike_interpret"`` (the Pallas kernel in interpret
mode) and ``solver="scan"`` on all five outputs at 1e-9, as the JAX
package's own TestSpikeRouting / TestSpikeFuzz hold its routes.
"""
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import batch as port_batch

KEYS = ("price", "vega", "delta", "gamma", "theta")


def _uniform_calls():
    rng = np.random.default_rng(1)
    B, t = 8, 0.25
    return dict(
        spots=list(rng.uniform(90.0, 110.0, B)), strikes=[100.0] * B,
        sigmas=list(rng.uniform(0.2, 0.4, B)), t_expiry=[t] * B, r=[0.05] * B,
        b=[0.05] * B, is_call=[True] * B, n_time_steps=32,
        monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        upper=[130.0] * B, num_space_nodes=127,
    ), 128


def _monitor_aligned():
    kw, n = _uniform_calls()
    kw.update(monitor_aligned=True, n_time_steps=24, steps_per_interval=5,
              monitor_times=[[0.02, 0.09, 0.13, 0.25]] * 8)
    return kw, n


def _puts_lower_barrier():
    """Down-and-out puts (and two double barriers) with rebates, one paid at hit."""
    rng = np.random.default_rng(2)
    B, t = 6, 0.4
    return dict(
        spots=list(rng.uniform(95.0, 110.0, B)), strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[t] * B,
        r=list(rng.uniform(0.01, 0.06, B)), b=list(rng.uniform(0.0, 0.04, B)),
        q=list(rng.uniform(0.0, 0.02, B)),
        is_call=[False] * B, n_time_steps=24,
        monitor_times=[[t * (k + 1) / 6.0 for k in range(6)]] * B,
        lower=[80.0] * B, upper=[None] * 4 + [135.0] * 2,
        rebate=[1.5] * B, rebate_at_hit=[True, False] * 3,
        num_space_nodes=127,
    ), 128


BATCHES = {
    "uniform_calls": _uniform_calls,
    "monitor_aligned": _monitor_aligned,
    "puts_lower_barrier": _puts_lower_barrier,
}


def _assert_close(got, ref, tol=1e-9):
    assert set(got) == set(ref)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_slice_matches_jax(name):
    kw, n_nodes = BATCHES[name]()
    jb = jax_batch.build_trade_batch(**kw)
    pb = port_batch.build_trade_batch(device="cpu", **kw)
    ref_scan = jax_batch.price_barrier_batch(jb, n_nodes=n_nodes, solver="scan")
    ref_spike = jax_batch.price_barrier_batch(jb, n_nodes=n_nodes, solver="spike_interpret")
    kernels.reset_launch_counts()
    got_scan = port_batch.price_barrier_batch(pb, n_nodes, solver="scan", device="cpu")
    got_spike = port_batch.price_barrier_batch(pb, n_nodes, solver="spike", device="cpu")
    assert not any(kernels.launch_counts.values())  # CPU: the plain version
    _assert_close(got_scan, ref_scan)
    _assert_close(got_spike, ref_spike)


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_spike_schedule_matches_jax(name, events):
    """The segmentation (and the dividend / lambda-reset break columns it
    reports) equals the JAX package's on the same batch."""
    kw, n_nodes = BATCHES[name]()
    jb = jax_batch.build_trade_batch(**kw)
    fields = {k: np.asarray(v).copy() for k, v in jb.__dict__.items() if v is not None}
    if events:
        fields["div_amount"][:, 5] = 1.0
        fields["reset_lambda"][:3, 9] = True
        jb = jax_batch.BarrierTradeBatch(**fields)
    pb = port_batch.batch_from_numpy(fields, device="cpu")
    want = jax_batch._spike_schedule_impl(jb, n_nodes, 64)
    assert want is not None
    assert port_batch._spike_schedule_impl(pb, n_nodes) == want


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fuzz_random_barrier_batches(seed):
    """Random barrier sides, rebates, calls and puts and grid sizes; the
    port's spike route against the JAX scan (the JAX package pins its
    spike_interpret to that scan in TestSpikeFuzz)."""
    rng = np.random.default_rng(seed)
    B = 8
    t = float(rng.uniform(0.1, 1.5))
    n_mon = int(rng.integers(2, 9))
    lower, upper = [], []
    for _ in range(B):
        kind = rng.integers(0, 4)
        lower.append(float(rng.uniform(60.0, 80.0)) if kind in (1, 3) else None)
        upper.append(float(rng.uniform(125.0, 160.0)) if kind in (2, 3) else None)
    kw = dict(
        spots=list(rng.uniform(85.0, 115.0, B)),
        strikes=list(rng.uniform(90.0, 110.0, B)),
        sigmas=list(rng.uniform(0.15, 0.5, B)),
        t_expiry=[t] * B,
        r=list(rng.uniform(0.0, 0.1, B)),
        b=list(rng.uniform(-0.02, 0.1, B)),
        is_call=list(rng.integers(0, 2, B) == 1),
        n_time_steps=int(rng.integers(24, 64)),
        monitor_times=[[t * (k + 1) / n_mon for k in range(n_mon)]] * B,
        lower=lower, upper=upper,
        rebate=list(rng.uniform(0.0, 3.0, B)),
        rebate_at_hit=list(rng.integers(0, 2, B) == 1),
        num_space_nodes=int(rng.choice([127, 150, 202])),
    )
    n_nodes = int(rng.choice([128, 152, 204]))
    ref = jax_batch.price_barrier_batch(
        jax_batch.build_trade_batch(**kw), n_nodes=n_nodes, solver="scan"
    )
    got = port_batch.price_barrier_batch(
        port_batch.build_trade_batch(device="cpu", **kw), n_nodes,
        solver="spike", device="cpu",
    )
    _assert_close(got, ref, tol=1e-8)


class TestRouting:
    def _batch(self, **over):
        kw, n_nodes = _uniform_calls()
        kw.update(over)
        return port_batch.build_trade_batch(device="cpu", **kw), n_nodes

    def test_auto_on_cpu_takes_the_scan(self, monkeypatch):
        """The JAX package's rule on the CPU: the scan where the spectral
        layout refuses the batch (here a theta pattern that is not a
        Rannacher prefix), the spectral propagator where it admits it."""
        pb, n = self._batch()
        seen = []
        real = port_batch._run_batch_driver
        monkeypatch.setattr(
            port_batch, "_run_batch_driver",
            lambda *a, **k: seen.append(a[6]) or real(*a, **k),
        )
        refused = pb._map(lambda x: x)
        refused.theta = refused.theta.clone()
        refused.theta[:, 5] = 1.0
        assert port_batch._spectral_layout(refused, n) is None
        auto = port_batch.price_barrier_batch(refused, n, with_greeks=False, device="cpu")
        scan = port_batch.price_barrier_batch(refused, n, with_greeks=False, solver="scan", device="cpu")
        assert torch.equal(auto["price"], scan["price"])
        auto = port_batch.price_barrier_batch(pb, n, with_greeks=False, device="cpu")
        spectral = port_batch.price_barrier_batch(pb, n, with_greeks=False, solver="spectral", device="cpu")
        assert torch.equal(auto["price"], spectral["price"])
        assert seen == ["scan", "scan", "spectral", "spectral"]

    def test_chunking_matches_one_pass(self):
        pb, n = self._batch()
        one = port_batch.price_barrier_batch(pb, n, solver="scan", max_chunk=None, device="cpu")
        chunked = port_batch.price_barrier_batch(pb, n, solver="scan", max_chunk=3, device="cpu")
        for k in KEYS:
            np.testing.assert_allclose(chunked[k].numpy(), one[k].numpy(), rtol=1e-13, atol=1e-13)

    def test_ineligible_and_unported_modes_raise(self):
        pb, n = self._batch()
        bad = pb._map(lambda x: x)
        bad.theta = bad.theta * 0.0 + 0.7
        assert not port_batch._spike_eligible(bad, n)
        assert port_batch._spike_eligible(pb, n)
        with pytest.raises(ValueError, match="spike-eligible"):
            port_batch.price_barrier_batch(bad, n, solver="spike", device="cpu")
        # every JAX solver name and greeks_mode is ported; SPIKE has no AD rule
        with pytest.raises(ValueError, match="no AD rule"):
            port_batch.price_barrier_batch(pb, n, solver="spike", greeks_mode="ad", device="cpu")
        with pytest.raises(ValueError, match="unknown greeks_mode"):
            port_batch.price_barrier_batch(pb, n, greeks_mode="fd", device="cpu")
        with pytest.raises(ValueError, match="unknown solver"):
            port_batch.price_barrier_batch(pb, n, solver="spectral64", device="cpu")

    def test_float32_dtype_and_vega_bump(self):
        pb, n = self._batch()
        assert port_batch._resolve_dv_sigma(None, pb.sigma) == 1e-4
        assert port_batch._resolve_dv_sigma(None, pb.sigma.float()) == 1e-2
        out32 = port_batch.price_barrier_batch(pb, n, solver="spike", dtype=torch.float32, device="cpu")
        out64 = port_batch.price_barrier_batch(pb, n, solver="spike", dv_sigma=1e-2, device="cpu")
        assert out32["price"].dtype == torch.float32
        rel = (out32["price"].double() - out64["price"]).abs() / out64["price"].abs()
        assert float(rel.max()) < 1e-3
