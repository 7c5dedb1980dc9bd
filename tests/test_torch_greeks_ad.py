"""``greeks_mode="ad"`` in the port against the JAX package, on the CPU at float64.

Vega comes from one ``torch.func.jvp`` with respect to sigma through the
scan (barrier and American, dividends included) or the spectral solve;
price, delta, gamma and theta from the primal V. Each is held against the
JAX package's ``jax.jvp`` on the same numpy inputs at 1e-10, and against
the port's own bump call: the non-vega outputs within 1e-12, the vega
within the bump's truncation (a central difference at dv = 1e-4 within
1e-6 of max|vega|). ``solver="spike"`` with ``ad`` raises, as the JAX
package's does, and ``"auto"`` keeps ``ad`` off the SPIKE march.
"""
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu_torch.models.pde import batch as port_batch

T_MONTH = 31.0 / 365.0


def _barrier_kwargs(aligned=False, B=6):
    rng = np.random.default_rng(5 if aligned else 3)
    T = T_MONTH
    mons = [T * f for f in (0.13, 0.29, 0.55, 0.62, 0.91)] if aligned else [
        T * (k + 1) / 8.0 for k in range(8)]
    kw = dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[T] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=48, monitor_times=[mons] * B,
        upper=[260.0] * B, lower=[150.0, None] * (B // 2), rebate=[1.0] * B,
        rebate_at_hit=[True, False, False] * (B // 3), num_space_nodes=127,
    )
    if aligned:
        kw.update(monitor_aligned=True, steps_per_interval=7)
    return kw


def _american_kwargs(dividends=False):
    B = 6
    return dict(
        spots=[88.0, 94.0, 100.0, 106.0, 112.0, 97.0], strikes=[100.0] * B,
        sigmas=[0.18, 0.22, 0.26, 0.3, 0.34, 0.38], t_expiry=[0.5, 1.0, 0.75, 1.0, 0.25, 0.6],
        r=[0.06] * B, b=[0.02, 0.06, 0.03, 0.05, 0.01, 0.04],
        is_call=[False, True] * 3, n_time_steps=24, num_space_nodes=126,
        dividends_tau=[[(0.2, 1.0)]] * B if dividends else None,
    )


CASES = {
    "barrier_scan": ("barrier", False, "scan"),
    "barrier_spectral": ("barrier", False, "spectral"),
    "barrier_spectral_aligned": ("barrier", True, "spectral"),
    "barrier_auto": ("barrier", False, "auto"),
    "american_scan": ("american", False, "scan"),
    "american_dividends": ("american", True, "scan"),
}


def _batches(case):
    kind, flag, solver = CASES[case]
    if kind == "barrier":
        kw = _barrier_kwargs(aligned=flag)
        return (jax_batch.build_trade_batch(**kw), port_batch.build_trade_batch(device="cpu", **kw),
                jax_batch.price_barrier_batch, port_batch.price_barrier_batch, solver)
    kw = _american_kwargs(dividends=flag)
    return (jax_batch.build_american_batch(**kw), port_batch.build_american_batch(device="cpu", **kw),
            jax_batch.price_american_batch, port_batch.price_american_batch, solver)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ad_matches_jax_ad(case):
    jb, pb, jax_price, port_price, solver = _batches(case)
    ref = jax_price(jb, 128, greeks_mode="ad", solver=solver)
    got = port_price(pb, 128, greeks_mode="ad", solver=solver, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-10, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ad_against_the_bump(case):
    _, pb, _, port_price, solver = _batches(case)
    ad = port_price(pb, 128, greeks_mode="ad", solver=solver, device="cpu")
    bump = port_price(pb, 128, solver=solver, device="cpu")
    for k in ad:
        if k != "vega":
            np.testing.assert_allclose(ad[k].numpy(), bump[k].numpy(), rtol=0.0,
                                       atol=1e-12 * float(bump[k].abs().max()), err_msg=k)
    h = 1e-4
    lo_b, hi_b = (pb._map(lambda x: x) for _ in range(2))
    lo_b.sigma, hi_b.sigma = pb.sigma - h, pb.sigma + h
    p_lo = port_price(lo_b, 128, solver=solver, with_greeks=False, device="cpu")["price"]
    p_hi = port_price(hi_b, 128, solver=solver, with_greeks=False, device="cpu")["price"]
    central = (p_hi - p_lo) / (2 * h * 100.0)
    scale = float(ad["vega"].abs().max())
    assert float((ad["vega"] - central).abs().max()) <= 1e-6 * scale


def test_explicit_spike_with_ad_raises():
    _, pb, _, _, _ = _batches("barrier_scan")
    for solver in ("spike", "spike_df64"):
        with pytest.raises(ValueError, match="no AD rule"):
            port_batch.price_barrier_batch(pb, 128, solver=solver, greeks_mode="ad", device="cpu")
    _, pa, _, _, _ = _batches("american_scan")
    with pytest.raises(ValueError, match="no AD rule"):
        port_batch.price_american_batch(pa, 128, solver="spike", greeks_mode="ad", device="cpu")
    # price only, the mode is unread (as in the JAX package)
    out = port_batch.price_barrier_batch(pb, 128, solver="spike", greeks_mode="ad",
                                         with_greeks=False, device="cpu")
    assert set(out) == {"price"}
    with pytest.raises(ValueError, match="unknown greeks_mode"):
        port_batch.price_barrier_batch(pb, 128, greeks_mode="fd", device="cpu")


@pytest.mark.parametrize("american", [False, True])
def test_auto_keeps_ad_off_spike_on_a_card(monkeypatch, american):
    """With the CPU read as CUDA (the rule's card branch), ``ad`` takes the
    spectral route or the scan and makes no SPIKE prep."""
    case = "american_scan" if american else "barrier_scan"
    _, pb, _, port_price, _ = _batches(case)
    real = port_batch.auto_solver
    seen = []
    monkeypatch.setattr(port_batch, "auto_solver",
                        lambda dev, *a, **k: seen.append(real("cuda", *a, **k)) or seen[-1])
    monkeypatch.setattr(port_batch, "prepare_spike",
                        lambda *a, **k: pytest.fail("a SPIKE prep under ad"))
    port_price(pb, 128, greeks_mode="ad", device="cpu")
    assert seen == (["scan"] if american else ["spectral"])
