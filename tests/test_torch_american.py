"""The port's American path, price_american_batch, against the JAX package.

Both routes of the port on the CPU at float64 (``solver="scan"`` and
``solver="spike"``, the American SPIKE march's plain version with its
dividend jumps and lambda resets between launches) are held against the
JAX package's ``price_american_batch(solver="scan")`` on price, delta,
gamma and vega at 1e-9, on the cases of the JAX package's own
TestAmericanSpike (tests/test_pallas_kernel.py).
"""
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import batch as port_batch

KEYS = ("price", "delta", "gamma", "vega")
TOL = 1e-9


def _kwargs(**over):
    """TestAmericanSpike's batch: mixed calls and puts, per-trade maturities
    and carries."""
    B = 8
    kw = dict(
        spots=[90.0 + 2 * i for i in range(B)],
        strikes=[100.0] * B,
        sigmas=[0.15 + 0.02 * i for i in range(B)],
        t_expiry=[0.25, 0.5, 1.0, 1.5, 0.75, 1.0, 2.0, 0.3],
        r=[0.06] * B,
        b=[0.06, 0.04, 0.06, 0.02, 0.06, 0.05, 0.06, 0.03],
        is_call=[True, False] * 4,
        n_time_steps=64,
        num_space_nodes=202,
    )
    kw.update(over)
    return kw


def _dividends(is_call):
    return dict(dividends_tau=[[(0.1, 1.5), (0.6, 1.0)]] * 8, t_expiry=[1.0] * 8, is_call=[is_call] * 8)


def _assert_close(got, ref, tol=TOL):
    assert set(got) == set(ref) == set(KEYS)  # no theta
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=tol, atol=tol, err_msg=k)


def _both_routes(kw, n_nodes=202, **price_kw):
    ref = jax_batch.price_american_batch(
        jax_batch.build_american_batch(**kw), n_nodes=n_nodes, solver="scan"
    )
    pb = port_batch.build_american_batch(device="cpu", **kw)
    kernels.reset_launch_counts()
    got = {
        solver: port_batch.price_american_batch(pb, n_nodes, solver=solver, device="cpu", **price_kw)
        for solver in ("scan", "spike")
    }
    assert not any(kernels.launch_counts.values())  # CPU: the plain version
    return got, ref


@pytest.mark.parametrize(
    "case,over,price_kw",
    [
        ("mixed", {}, {}),
        ("dividend_puts", _dividends(False), {}),
        ("dividend_calls", _dividends(True), {}),
        ("max_chunk", {}, {"max_chunk": 3}),
    ],
)
def test_price_american_batch_matches_jax(case, over, price_kw):
    got, ref = _both_routes(_kwargs(**over), **price_kw)
    for solver in ("scan", "spike"):
        _assert_close(got[solver], ref)
    if case == "mixed":
        # the early-exercise premium is real: the deep ITM put >= intrinsic
        assert float(got["spike"]["price"][1]) >= 100.0 - 92.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_random_batches(seed):
    """Random moneyness, vol, carry and maturity mixes, step counts, calls
    and puts; solve widths 152/202/256 drawn apart from the grid's, so the
    pad path and the exact fit both run."""
    rng = np.random.default_rng(seed)
    B = 8
    kw = dict(
        spots=list(rng.uniform(60.0, 160.0, B)),
        strikes=list(rng.uniform(80.0, 120.0, B)),
        sigmas=list(rng.uniform(0.1, 0.6, B)),
        t_expiry=list(rng.uniform(0.1, 2.5, B)),
        r=list(rng.uniform(0.0, 0.12, B)),
        b=list(rng.uniform(-0.05, 0.12, B)),
        is_call=list(rng.integers(0, 2, B) == 1),
        n_time_steps=int(rng.integers(16, 96)),
        num_space_nodes=int(rng.choice([150, 202, 254])),
    )
    n_nodes = int(rng.choice([152, 202, 256]))
    got, ref = _both_routes(kw, n_nodes=n_nodes)
    for solver in ("scan", "spike"):
        _assert_close(got[solver], ref)


def test_richardson_matches_jax():
    kw = _kwargs(n_time_steps=16, num_space_nodes=126)
    ref = jax_batch.price_american_batch_richardson(n_nodes=128, **kw)
    got = port_batch.price_american_batch_richardson(n_nodes=128, device="cpu", **kw)
    _assert_close(got, ref)


class TestRouting:
    def _seen_solvers(self, monkeypatch):
        seen = []
        real = port_batch._run_batch_driver
        monkeypatch.setattr(
            port_batch, "_run_batch_driver",
            lambda *a, **k: seen.append(a[6]) or real(*a, **k),
        )
        return seen

    def test_mixed_call_put_dividends_take_the_scan(self, monkeypatch):
        """Calls restart Rannacher after each dividend and puts do not, so a
        mixed dividend batch has no shared theta pattern: not SPIKE-eligible,
        as in the JAX package."""
        kw = _kwargs(**_dividends(False))
        kw["is_call"] = [True, False] * 4
        pb = port_batch.build_american_batch(device="cpu", **kw)
        assert port_batch._spike_schedule_impl(pb, 202) is None
        assert jax_batch._spike_schedule_impl(jax_batch.build_american_batch(**kw), 202, 64) is None
        with pytest.raises(ValueError, match="spike-eligible"):
            port_batch.price_american_batch(pb, 202, solver="spike", device="cpu")
        seen = self._seen_solvers(monkeypatch)
        port_batch.price_american_batch(pb, 202, with_greeks=False, device="cpu")
        assert seen == ["scan"]

    def test_auto_on_cpu_takes_the_scan_and_ad_raises(self, monkeypatch):
        """auto takes the scan on the CPU; greeks_mode="ad" is ported (it
        raised before), so it is held against the bump: the same price,
        delta and gamma, and the vega within the one-sided bump's
        truncation (1e-3 of max|vega| at dv = 1e-4). It raises on SPIKE."""
        pb = port_batch.build_american_batch(device="cpu", **_kwargs(n_time_steps=16))
        assert port_batch._spike_eligible(pb, 202)
        seen = self._seen_solvers(monkeypatch)
        port_batch.price_american_batch(pb, 202, with_greeks=False, device="cpu")
        assert seen == ["scan"]
        ad = port_batch.price_american_batch(pb, 202, greeks_mode="ad", device="cpu")
        bump = port_batch.price_american_batch(pb, 202, device="cpu")
        assert seen == ["scan"] * 3
        for k in ("price", "delta", "gamma"):
            torch.testing.assert_close(ad[k], bump[k], rtol=0.0, atol=1e-12 * float(bump[k].abs().max()))
        assert float((ad["vega"] - bump["vega"]).abs().max()) <= 1e-3 * float(bump["vega"].abs().max())
        with pytest.raises(ValueError, match="no AD rule"):
            port_batch.price_american_batch(pb, 202, solver="spike", greeks_mode="ad", device="cpu")

    def test_float32_spike_route(self):
        pb = port_batch.build_american_batch(device="cpu", **_kwargs(n_time_steps=32, **_dividends(False)))
        out32 = port_batch.price_american_batch(pb, 202, solver="spike", dtype=torch.float32, device="cpu")
        out64 = port_batch.price_american_batch(pb, 202, solver="spike", dv_sigma=1e-2, device="cpu")
        assert all(v.dtype == torch.float32 for v in out32.values())
        rel = (out32["price"].double() - out64["price"]).abs() / out64["price"].abs()
        assert float(rel.max()) < 1e-3
