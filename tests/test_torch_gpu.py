"""The port's CUDA kernels on the card (marker ``gpu``; skips without a card).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

It holds each kernel against its plain version on the same prepared
inputs, at float64 within 1e-11 and float32 within 2e-4 of max|V|
(float32: FMA contraction and a different rounding order): the SPIKE march
(csrc/spike_march.cu, European and American branches, against
spike.spike_march_reference), the fused march with Hillis–Steele scans
(csrc/hs_march.cu, against fused.hs_march_reference) and the fused march
with cyclic reduction (csrc/cr_march.cu, against cr.cr_march_reference);
and it shows that each path launches its kernel. The spectral propagator
and greeks_mode="ad" (no hand-written kernel) are held on the card against
the port on the CPU at float64 within 1e-12, and a float32 spectral call
under TF32 raises rather than lose the sine reconstruction. On the
serving path, a float64 service over a mesh of every visible card (two or
more; it skips on one) captures each card's spectral graph on that card and
equals the one-card service (price 1e-12 of max|price|, greeks 1e-9). On the
FA-validation path, the scalar pricers on the card equal the port on the
CPU within 1e-10, a replayed scan (a CUDA graph) equals its eager run
within 1e-12, and the batched American runner at float64 launches K2. The
rest of that layer (no kernel of ours): the Bjerksund–Stensland forward
pricer, the BGK pricer on its BGK and Monte Carlo routes and the FIS
stencil pricer on the card equal the port on the CPU (prices, delta, vega
within 1e-10 of max|value|, gamma 1e-7), implied vol within 1e-12
relative (or 16 times a quote's rounding noise, as on the CPU against
JAX), a replayed FIS march equals its eager run within 1e-12, and
``utils.profiling.trace`` writes a non-empty trace. The Monte Carlo layer
(no kernel of ours): threefry's bits and uniforms on the card equal the
CPU's exactly (normals within the two erfinvs' rounding, as against JAX),
and the discrete-barrier MC (1e-12), LSM (1e-10), GBM and CS paths (1e-13)
and the HW1F cube (1e-12 of max|z|) equal the port on the CPU. The XVA
exposure path (no kernel of ours unless a surface takes K2):
``hw1f_cva_pipeline`` (MTM 1e-10 of max|MTM|, CVA 1e-10 relative), the
device engine's MTM of a netting set with a knock-out barrier, an
American put and a swap (1e-10 of max|MTM|), and ``exposure_profile``
(1e-13 relative) equal the port on the CPU; a float32 exposure call under
TF32 raises. The rest of the XVA engine (no kernel of ours): the device
engine's TRS, ILS and commodity families (MTM 1e-10 of max|MTM|), a SIMM
CSA (MTM, collateral and exposure 1e-9 of max|value|; a plain MTM after
it unchanged bit for bit) and ``run_asset`` under each draw backend (CVA,
peak EE and PFE 1e-12 relative) equal the port on the CPU. The scenario
layer (no kernel of ours): the CS draws (threefry and sobol_device within
1e-12 of max|z|, the torch backend bit for bit) and the paths on them
(1e-12 of max|F|) equal the port on the CPU. Knock-in parity
(csrc/ki_parity.cu) equals its plain version on the card bit for bit, the
barrier service launches it once a request with knock-in rows and never
without, and a service over every card (two or more) prices the knock-in
rows as one card does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.pde import cr, fused, spike
from finite_difference_tpu_torch.models.pde.batch import (
    _spike_schedule_impl,
    build_american_batch,
    build_trade_batch,
    price_american_batch,
    price_barrier_batch,
    solve_value_surfaces,
)

pytestmark = pytest.mark.gpu

KEYS = ("price", "vega", "delta", "gamma", "theta")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kwargs(seed=0, B=8, n_steps=32, num_space_nodes=127):
    """Mixed calls and puts, up/down/double barriers, rebates at hit and at expiry."""
    rng = np.random.default_rng(seed)
    t = 0.25
    return dict(
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


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
@pytest.mark.parametrize("n_nodes", [127, 128, 129, 152])  # P = 32, 32, 32, 8
def test_kernel_matches_plain_version(cuda, dtype, limit, n_nodes):
    B = 13  # a ragged last block of the 4-trade blocks
    tb = build_trade_batch(
        dtype=dtype, device=cuda, **_kwargs(seed=n_nodes, B=B, num_space_nodes=n_nodes - 1)
    )
    segments, set_defs = spike.default_segments(tb.n_steps)
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, None, set_defs)
    v_k, e_k = v_r, e_r = prep.v0, prep.edge0
    kernels.reset_launch_counts()
    for k0, k1, t in segments:
        v_k, e_k = kernels.spike_march_cuda(prep, t, v_k, e_k, k0, k1)
        v_r, e_r = spike.spike_march_reference(prep, t, v_r, e_r, k0, k1)
    torch.cuda.synchronize()
    tag = "f64" if dtype == torch.float64 else "f32"
    assert kernels.launch_counts[f"spike_march_{tag}"] == len(segments)
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= limit * scale
    assert float((e_k - e_r).abs().max()) <= limit * scale


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
@pytest.mark.parametrize("n_nodes", [257, 1024])  # m = 4 and 2, 16 and 8 rows per chunk
@pytest.mark.parametrize("P", [64, 128])
def test_wide_kernel_matches_plain_version(cuda, dtype, limit, n_nodes, P):
    """P/32 warps per trade, one trade per block: the European march, and
    an American segment from a nonzero lambda, against the plain version."""
    tb = build_trade_batch(
        dtype=dtype, device=cuda, **_kwargs(seed=n_nodes, B=5, num_space_nodes=n_nodes - 1)
    )
    segments, set_defs = spike.default_segments(tb.n_steps)
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, P, set_defs)
    kernels.reset_launch_counts()
    v_k, e_k = spike.march_segments(tb, prep, segments, step=kernels.spike_march_cuda)
    v_r, e_r = spike.march_segments(tb, prep, segments, step=spike.spike_march_reference)
    torch.cuda.synchronize()
    tag = "f64" if dtype == torch.float64 else "f32"
    assert kernels.launch_counts[f"spike_march_{tag}"] == len(segments)
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= limit * scale
    assert float((e_k - e_r).abs().max()) <= limit * scale

    ta = build_american_batch(dtype=dtype, device=cuda, **_american_kwargs(
        seed=n_nodes, B=5, num_space_nodes=n_nodes - 1))
    segments, set_defs, _, _ = _spike_schedule_impl(ta, n_nodes)
    prep = spike.prepare_spike(ta, ta.sigma, n_nodes, P, set_defs, american=True)
    k0, k1, t = segments[1]
    lam0 = torch.rand(prep.v0.shape, dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    pads = torch.arange(prep.v0.shape[1], device=cuda).view(prep.m, prep.P).T.reshape(-1)[prep.n_int:]
    lam0[:, pads] = 0.0
    got = kernels.spike_march_american_cuda(prep, t, prep.v0, prep.edge0, lam0, k0, k1)
    want = spike.spike_march_reference(prep, t, prep.v0, prep.edge0, k0, k1, lam0)
    torch.cuda.synchronize()
    assert kernels.launch_counts[f"spike_march_american_{tag}"] == 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= limit * float(w.abs().max())


def test_small_batch_path_runs_several_warps_per_trade(cuda):
    """B=8 at N=1024: the batch-size rule's P=64 on price_american_batch,
    against the scan on the CPU."""
    tb = build_american_batch(device=cuda, **_american_kwargs(seed=8, B=8, num_space_nodes=1023))
    assert spike.spike_p(1024, tb.batch_size) == 64
    kernels.reset_launch_counts()
    got = price_american_batch(tb, 1024)
    n_seg = len(_spike_schedule_impl(tb, 1024)[0])
    assert kernels.launch_counts["spike_march_american_f64"] == 2 * n_seg
    ref = price_american_batch(tb, 1024, solver="scan", device="cpu")
    for k in got:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)


def test_auto_route_takes_one_warp_where_the_guard_refuses_the_wide_p(cuda):
    """A drift-dominated batch of 2 trades at N=1024 (sigma 1%, carry 30%,
    8 steps), whose tips the interface guard refuses at P=64: solver="auto"
    prices it at P=32 on the kernel, within 1e-9 of the scan on the CPU."""
    B = 2
    tb = build_trade_batch(
        device=cuda, spots=[100.0, 104.0], strikes=[100.0] * B, sigmas=[0.01] * B,
        t_expiry=[1.0] * B, r=[0.05] * B, b=[0.3] * B, is_call=[True] * B, n_time_steps=8,
        num_space_nodes=1023, upper=[400.0] * B, monitor_times=[[0.5, 1.0]] * B,
    )
    assert spike.prepare_spike(tb, tb.sigma, 1024, None, spike.default_segments(8)[1]).P == 32
    kernels.reset_launch_counts()
    got = price_barrier_batch(tb, 1024)
    assert kernels.launch_counts["spike_march_f64"] == 4  # two segments, two solves
    ref = price_barrier_batch(tb, 1024, solver="scan", device="cpu")
    for k in got:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("american", [False, True])
def test_auto_route_takes_the_scan_where_the_guard_refuses_every_p(cuda, american):
    """The drift-dominated batch of tests/test_torch_spike_prep.py (sigma 1%
    against a carry of 50% on four steps), whose interface system the guard
    refuses at every P: solver="auto" prices it with greeks on the scan,
    with no SPIKE launch, within 1e-9 of the scan on the CPU."""
    B = 4
    kw = dict(spots=[100.0] * B, strikes=[100.0] * B, sigmas=[0.01] * B, t_expiry=[1.0] * B,
              r=[0.05] * B, b=[0.5] * B, is_call=[True] * B, n_time_steps=4,
              num_space_nodes=127)
    if american:
        tb, price = build_american_batch(device=cuda, **kw), price_american_batch
    else:
        tb = build_trade_batch(device=cuda, upper=[130.0] * B, monitor_times=[[0.5, 1.0]] * B, **kw)
        price = price_barrier_batch
    assert _spike_schedule_impl(tb, 128) is not None
    kernels.reset_launch_counts()
    got = price(tb, 128)
    torch.cuda.synchronize()
    assert not any(n for k, n in kernels.launch_counts.items() if k.startswith("spike_march"))
    ref = price(tb.to("cpu"), 128, solver="scan", device="cpu")
    assert set(got) == set(ref) and "vega" in got
    for k in got:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="without pivoting is unsafe"):
        price(tb, 128, solver="spike")


def test_wrapper_refuses_the_old_prep_layout(cuda):
    """The dense-inverse layout (fields (5, B, n_pad), a (B, 2P, 2P)
    inverse in place of the factors) no longer launches."""
    tb = build_trade_batch(device=cuda, **_kwargs(B=4))
    prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),))
    B, n_pad = prep.v0.shape
    old_fields = prep.fields.new_zeros(1, 5, B, n_pad)
    with pytest.raises(ValueError, match="fields has shape"):
        kernels.spike_march_cuda(dataclasses.replace(prep, fields=old_fields), 0, prep.v0, prep.edge0, 0, 2)
    old_inv = prep.iface.new_zeros(1, B, 64, 64)
    with pytest.raises(ValueError, match="iface has shape"):
        kernels.spike_march_cuda(dataclasses.replace(prep, iface=old_inv), 0, prep.v0, prep.edge0, 0, 2)
    with pytest.raises(ValueError, match="trade has shape"):
        kernels.spike_march_cuda(dataclasses.replace(prep, trade=prep.trade[:, :11].contiguous()),
                                 0, prep.v0, prep.edge0, 0, 2)


@pytest.mark.parametrize("P", [32, 64, 128])
@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_trades_query(cuda, american, dtype, P):
    """One warp per trade and 4 trades per block at P=32; one trade per
    block of P/32 warps at P=64 and 128. At most 64 warps per SM."""
    tb = build_trade_batch(dtype=dtype, device=cuda, **_kwargs(B=4, num_space_nodes=1023))
    prep = spike.prepare_spike(tb, tb.sigma, 1024, P, ((1.0, 0),), american=american)
    kernels.reset_launch_counts()
    resident = kernels.spike_resident_trades(prep)
    warps = max(1, P // 32)
    assert 1 <= resident and resident * warps <= 64
    assert resident % (4 if P == 32 else 1) == 0
    assert not any(kernels.launch_counts.values())


def test_cuda_solve_matches_cpu_solve(cuda):
    tb = build_trade_batch(device="cpu", **_kwargs(seed=9))
    v_cpu = spike.cn_barrier_solve_spike(tb, tb.sigma, 128, 32)
    tbg = tb.to(cuda)
    v_gpu = spike.cn_barrier_solve_spike(tbg, tbg.sigma, 128, 32)
    np.testing.assert_allclose(v_gpu.cpu().numpy(), v_cpu.numpy(), rtol=1e-11, atol=1e-11)


def test_wrapper_checks_dtype_and_contiguity(cuda):
    tb = build_trade_batch(device=cuda, **_kwargs(B=4))
    prep = spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0),))
    with pytest.raises(ValueError, match="expected torch.float64"):
        kernels.spike_march_cuda(prep, 0, prep.v0, prep.edge0.float(), 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spike_march_cuda(prep, 0, prep.v0, prep.edge0.t().contiguous().t(), 0, 2)


def test_main_path_goes_through_the_kernel(cuda):
    kw = _kwargs(seed=3)
    tb = build_trade_batch(device=cuda, **kw)
    kernels.reset_launch_counts()
    # the SPIKE route asked for by name: at float64 auto's measured rule
    # may take the spectral propagator (batch.AUTO_CUDA_RULE)
    got = price_barrier_batch(tb, 128, solver="spike")
    assert kernels.launch_counts["spike_march_f64"] == 4  # 2 segments x (base + vega bump)
    ref = price_barrier_batch(tb, 128, solver="scan", device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)


def test_large_grid_opts_into_more_shared_memory(cuda):
    """f64 at N=2048: 4 trades x 2048 rows x 8 bytes = 64 KB per block (with
    the solver data more), above the 48 KB default, so the launch first
    raises the kernel's limit."""
    n_nodes = 2048
    tb = build_trade_batch(device=cuda, **_kwargs(seed=5, B=6, n_steps=8, num_space_nodes=n_nodes - 1))
    segments, set_defs = spike.default_segments(tb.n_steps)
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, 32, set_defs)  # one warp per trade
    assert 4 * prep.v0.shape[1] * prep.v0.element_size() > 48 * 1024
    v_k, e_k = v_r, e_r = prep.v0, prep.edge0
    for k0, k1, t in segments:
        v_k, e_k = kernels.spike_march_cuda(prep, t, v_k, e_k, k0, k1)
        v_r, e_r = spike.spike_march_reference(prep, t, v_r, e_r, k0, k1)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= 1e-11 * scale
    assert float((e_k - e_r).abs().max()) <= 1e-11 * scale


def _march_vs_plain(prep, kernel, plain, tag_name, dtype, limit):
    kernels.reset_launch_counts()
    v_k = kernel(prep)
    v_r = plain(prep)
    torch.cuda.synchronize()
    tag = "f64" if dtype == torch.float64 else "f32"
    assert kernels.launch_counts[f"{tag_name}_{tag}"] == 1
    assert float((v_k - v_r).abs().max()) <= limit * float(v_r.abs().max())


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
# one warp per trade up to 1024 nodes: R = 2, 4, 4, 4, 8, 32, 32 rows per
# lane at 33 ... 1024 (33, 65, 127, 129 and 1000 leave phantom rows in the
# last lanes); one block per trade at 1025 (the first such grid, 4 rows on
# 288 threads) and 2048 (512 threads)
@pytest.mark.parametrize("n_nodes", [33, 65, 127, 128, 129, 1000, 1024, 1025, 2048])
def test_hs_kernel_matches_plain_version(cuda, dtype, limit, n_nodes):
    tb = build_trade_batch(
        dtype=dtype, device=cuda, **_kwargs(seed=n_nodes, B=5, num_space_nodes=n_nodes - 1)
    )
    prep = fused.prepare_fused(tb, tb.sigma, n_nodes)
    _march_vs_plain(prep, kernels.hs_march_cuda, fused.hs_march_reference, "hs_march", dtype, limit)


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4), (torch.float64, 8)])
@pytest.mark.parametrize("n_nodes", [128, 1024])
def test_hs_resident_trades_query(cuda, dtype, elem, n_nodes):
    """The occupancy API against the launch mirror: whole blocks of
    kernels.HS_TRADES_PER_BLOCK trades within the SM's shared memory
    (3 * 32 * (R | 1) values per trade), at least 16 per SM at N=1024 in
    f32 and 8 in f64. The block design above 1024 nodes has no query."""
    tb = build_trade_batch(dtype=dtype, device=cuda, **_kwargs(B=4, num_space_nodes=n_nodes - 1))
    prep = fused.prepare_fused(tb, tb.sigma, n_nodes)
    kernels.reset_launch_counts()
    resident = kernels.hs_resident_trades(prep)
    design, rows, _ = kernels.hs_block(n_nodes)
    assert design == "warp" and resident % kernels.HS_TRADES_PER_BLOCK == 0
    assert resident * 3 * 32 * (rows | 1) * elem <= 228 * 1024
    if n_nodes == 1024:
        assert resident >= (16 if dtype == torch.float32 else 8)
    assert not any(kernels.launch_counts.values())
    wide = fused.prepare_fused(tb, tb.sigma, 1025)
    with pytest.raises(ValueError, match="N <= 1024"):
        kernels.hs_resident_trades(wide)


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
# one warp per trade: 2 to 32 rows per lane at level 0; n=2048 at f64 takes
# 35 KB of shared memory per trade, 139 KB per block of 4
@pytest.mark.parametrize("n", [8, 128, 1024, 2048])
def test_cr_kernel_matches_plain_version(cuda, dtype, limit, n):
    tb = build_trade_batch(
        dtype=dtype, device=cuda, **_kwargs(seed=n, B=5, num_space_nodes=n + 1)
    )
    prep = cr.prepare_cr(tb, tb.sigma, n + 2)
    _march_vs_plain(prep, kernels.cr_march_cuda, cr.cr_march_reference, "cr_march", dtype, limit)


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4), (torch.float64, 8)])
def test_cr_resident_trades_query(cuda, dtype, elem):
    """The occupancy API against the launch mirror: whole blocks of
    kernels.cr_block's trades, at least 16 per SM at N=1026 in f32."""
    tb = build_trade_batch(dtype=dtype, device=cuda, **_kwargs(B=4, num_space_nodes=1025))
    prep = cr.prepare_cr(tb, tb.sigma, 1026)
    kernels.reset_launch_counts()
    resident = kernels.cr_resident_trades(prep)
    per_block, smem = kernels.cr_block(1026, elem)
    assert resident % per_block == 0 and resident * smem // per_block <= 228 * 1024
    assert resident >= (16 if dtype == torch.float32 else 8)
    assert not any(kernels.launch_counts.values())


def test_fused_wrappers_check_dtype_device_and_contiguity(cuda):
    tb = build_trade_batch(device=cuda, **_kwargs(B=4, num_space_nodes=129))
    for prepare, launch in ((fused.prepare_fused, kernels.hs_march_cuda),
                            (cr.prepare_cr, kernels.cr_march_cuda)):
        prep = prepare(tb, tb.sigma, 130)
        bad = dataclasses.replace(prep, tau=prep.tau.float())
        with pytest.raises(ValueError, match="expected torch.float64"):
            launch(bad)
        bad = dataclasses.replace(prep, omask=prep.omask.cpu())
        with pytest.raises(ValueError, match="expected torch.float64 on cuda"):
            launch(bad)
        bad = dataclasses.replace(prep, trade=prep.trade.t().contiguous().t())
        with pytest.raises(ValueError, match="contiguous"):
            launch(bad)
        with pytest.raises(TypeError, match="float32 and float64"):
            launch(dataclasses.replace(prep, v0=prep.v0.half()))


def test_fused_path_goes_through_the_kernel(cuda):
    kw = _kwargs(seed=3)
    tb = build_trade_batch(device=cuda, **kw)
    kernels.reset_launch_counts()
    got = fused.price_barrier_batch_fused(tb, 128)
    assert kernels.launch_counts["hs_march_f64"] == 2  # base + vega bump
    ref = fused.price_barrier_batch_fused(tb, 128, device="cpu")
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)


def test_cr_path_goes_through_the_kernel(cuda):
    tb = build_trade_batch(device=cuda, **_kwargs(seed=4, num_space_nodes=129))
    kernels.reset_launch_counts()
    got = cr.cn_barrier_solve_cr(tb, tb.sigma, 130, tb.n_steps)
    assert kernels.launch_counts["cr_march_f64"] == 1
    tb_cpu = tb.to("cpu")
    ref = cr.cn_barrier_solve_cr(tb_cpu, tb_cpu.sigma, 130, tb.n_steps)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-11, atol=1e-11)


def _american_kwargs(seed=0, B=13, n_steps=40, num_space_nodes=127, is_call=False):
    """Two cash dividends per trade: jumps between launches, lambda resets."""
    rng = np.random.default_rng(seed)
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)), strikes=[100.0] * B,
        sigmas=list(rng.uniform(0.15, 0.4, B)), t_expiry=[1.0] * B, r=[0.06] * B,
        b=list(rng.uniform(0.0, 0.06, B)), is_call=[is_call] * B, n_time_steps=n_steps,
        dividends_tau=[[(0.3, 1.5), (0.7, 1.0)]] * B, num_space_nodes=num_space_nodes,
    )


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
@pytest.mark.parametrize("n_nodes", [127, 128, 129, 152])  # P = 32, 32, 32, 8
@pytest.mark.parametrize("is_call", [False, True])
def test_american_kernel_matches_plain_version(cuda, dtype, limit, n_nodes, is_call):
    tb = build_american_batch(dtype=dtype, device=cuda, **_american_kwargs(
        seed=n_nodes, num_space_nodes=n_nodes - 1, is_call=is_call))
    segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, n_nodes)
    assert div_steps and reset_steps
    prep = spike.prepare_spike(
        tb, tb.sigma, n_nodes, spike.spike_p(n_nodes, tb.batch_size), set_defs, american=True
    )
    # one segment from a nonzero lambda: lambda out, and pad rows that stay 0
    k0, k1, t = segments[1]
    lam0 = torch.rand(prep.v0.shape, dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    pads = torch.arange(prep.v0.shape[1], device=cuda).view(prep.m, prep.P).T.reshape(-1)[prep.n_int:]
    lam0[:, pads] = 0.0
    kernels.reset_launch_counts()
    got = kernels.spike_march_american_cuda(prep, t, prep.v0, prep.edge0, lam0, k0, k1)
    want = spike.spike_march_reference(prep, t, prep.v0, prep.edge0, k0, k1, lam0)
    torch.cuda.synchronize()
    tag = "f64" if dtype == torch.float64 else "f32"
    assert kernels.launch_counts[f"spike_march_american_{tag}"] == 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= limit * float(w.abs().max())
    assert torch.all(got[0][:, pads] == 0) and torch.all(got[2][:, pads] == 0)
    # the whole march, with its resets and dividend jumps between launches
    v_k, e_k = spike.march_segments(tb, prep, segments, div_steps, reset_steps)
    v_r, e_r = spike.march_segments(
        tb, prep, segments, div_steps, reset_steps, step=spike.spike_march_reference
    )
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= limit * scale
    assert float((e_k - e_r).abs().max()) <= limit * scale


def test_american_path_goes_through_the_kernel(cuda):
    tb = build_american_batch(device=cuda, **_american_kwargs(seed=4, B=8))
    kernels.reset_launch_counts()
    got = price_american_batch(tb, 128)  # solver="auto" -> spike on CUDA
    n_seg = len(_spike_schedule_impl(tb, 128)[0])
    assert kernels.launch_counts["spike_march_american_f64"] == 2 * n_seg  # base + vega bump
    ref = price_american_batch(tb, 128, solver="scan", device="cpu")
    assert set(got) == {"price", "vega", "delta", "gamma"}
    for k in got:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9)


def test_american_f64_opts_into_more_shared_memory(cuda):
    """American f64 at N=1024: 4 trades x 2 rows x 1024 x 8 bytes = 64 KB
    per block, above the 48 KB default."""
    n_nodes = 1024
    tb = build_american_batch(device=cuda, **_american_kwargs(
        seed=6, B=6, n_steps=12, num_space_nodes=n_nodes - 1))
    segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, n_nodes)
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, 32, set_defs, american=True)  # one warp per trade
    assert 4 * 2 * prep.v0.shape[1] * prep.v0.element_size() > 48 * 1024
    v_k, e_k = spike.march_segments(tb, prep, segments, div_steps, reset_steps)
    v_r, e_r = spike.march_segments(
        tb, prep, segments, div_steps, reset_steps, step=spike.spike_march_reference
    )
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= 1e-11 * scale
    assert float((e_k - e_r).abs().max()) <= 1e-11 * scale


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-11), (torch.float32, 2e-4)])
def test_american_kernel_matches_plain_version_at_main_width(cuda, dtype, limit):
    """N=1024 (P=32, m=32, the main path's shape) at a small batch, with
    dividends: the whole march against the plain version."""
    n_nodes = 1024
    tb = build_american_batch(dtype=dtype, device=cuda, **_american_kwargs(
        seed=11, B=5, n_steps=24, num_space_nodes=n_nodes - 1))
    segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, n_nodes)
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, 32, set_defs, american=True)
    assert (prep.m, prep.P) == (32, 32)
    kernels.reset_launch_counts()
    v_k, e_k = spike.march_segments(tb, prep, segments, div_steps, reset_steps)
    tag = "f64" if dtype == torch.float64 else "f32"
    assert kernels.launch_counts[f"spike_march_american_{tag}"] == len(segments)
    v_r, e_r = spike.march_segments(
        tb, prep, segments, div_steps, reset_steps, step=spike.spike_march_reference
    )
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    assert float((v_k - v_r).abs().max()) <= limit * scale
    assert float((e_k - e_r).abs().max()) <= limit * scale


# the spectral propagator and greeks_mode="ad" on the card --------------------

def _spectral_kwargs(B=8, aligned=False):
    """Up-and-out calls with rebates, 8 monitors (uniform dt) or irregular
    monitors on a monitor-aligned schedule (per-interval dt)."""
    rng = np.random.default_rng(5)
    t = 31.0 / 365.0
    mons = [t * f for f in (0.13, 0.29, 0.55, 0.62, 0.91)] if aligned else [
        t * (k + 1) / 8.0 for k in range(8)]
    kw = dict(
        spots=list(rng.uniform(180.0, 250.0, B)), strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)), t_expiry=[t] * B, r=[0.0705] * B,
        b=[0.0705] * B, is_call=[True] * B, n_time_steps=48, monitor_times=[mons] * B,
        upper=[260.0] * B, lower=[150.0, None] * (B // 2), rebate=[1.0] * B,
        num_space_nodes=127,
    )
    if aligned:
        kw.update(monitor_aligned=True, steps_per_interval=7)
    return kw


@pytest.mark.parametrize("solver", ["spectral", "spectral_x64dst"])
@pytest.mark.parametrize("aligned", [False, True])
def test_spectral_on_the_card_matches_the_cpu(cuda, solver, aligned):
    """V within 1e-12 of max|V|; the greeks, whose bump and second
    difference amplify V's roundings (the DSTs sum in another order on the
    card), within 1e-9, as the other card tests hold them."""
    tb = build_trade_batch(device="cpu", **_spectral_kwargs(aligned=aligned))
    v_ref, s_ref = solve_value_surfaces(tb, 128, solver=solver, device="cpu")
    v, s = solve_value_surfaces(tb.to(cuda), 128, solver=solver)
    assert v.is_cuda
    scale = float(v_ref.abs().max())
    assert float((v.cpu() - v_ref).abs().max()) <= 1e-12 * scale
    ref = price_barrier_batch(tb, 128, solver=solver, device="cpu")
    got = price_barrier_batch(tb.to(cuda), 128, solver=solver)
    for k in KEYS:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9, err_msg=k)


def test_float32_spectral_refuses_tf32(cuda):
    """TF32's 10-bit mantissa would destroy the sine reconstruction: with
    TF32 on, a float32 DST raises; with it off the call runs at full
    float32 (and the float64 DSTs of spectral_x64dst are unaffected)."""
    tb = build_trade_batch(dtype=torch.float32, device=cuda, **_spectral_kwargs())
    plain = price_barrier_batch(tb, 128, with_greeks=False, solver="spectral")
    x64 = price_barrier_batch(tb, 128, with_greeks=False, solver="spectral_x64dst")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            price_barrier_batch(tb, 128, with_greeks=False, solver="spectral")
        again = price_barrier_batch(tb, 128, with_greeks=False, solver="spectral_x64dst")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(again["price"], x64["price"])
    assert torch.equal(price_barrier_batch(tb, 128, with_greeks=False, solver="spectral")["price"],
                       plain["price"])


@pytest.mark.parametrize("route", ["barrier_scan", "barrier_spectral", "american_scan"])
def test_ad_on_the_card_matches_the_cpu(cuda, route):
    if route.startswith("american"):
        tb = build_american_batch(device="cpu", **_american_kwargs(seed=6, B=8))
        price = price_american_batch
    else:
        tb = build_trade_batch(device="cpu", **_spectral_kwargs())
        price = price_barrier_batch
    solver = route.split("_")[1]
    ref = price(tb, 128, greeks_mode="ad", solver=solver, device="cpu")
    kernels.reset_launch_counts()
    got = price(tb.to(cuda), 128, greeks_mode="ad", solver=solver)
    assert not any(kernels.launch_counts.values())
    for k in ref:  # the jvp's vega has no bump to amplify V's roundings
        tol = 1e-11 * float(ref[k].abs().max()) if k in ("price", "vega") else 1e-9
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), rtol=0.0, atol=tol, err_msg=k)
    with pytest.raises(ValueError, match="no AD rule"):
        price(tb.to(cuda), 128, greeks_mode="ad", solver="spike")


def test_auto_sends_a_refused_float32_batch_to_the_scan(cuda, monkeypatch):
    """A float32 batch whose spectral layout is admitted, with the interface
    guard's verdict forced to a refusal (a batch the guard refuses for real
    is drift dominated, and the layout refuses it too): auto prices it on
    the scan, with no SPIKE launch, never on the float32 spectral route."""
    from finite_difference_tpu_torch.models.pde import batch as port_batch

    tb = build_trade_batch(dtype=torch.float32, device=cuda, **_spectral_kwargs())
    assert port_batch._spectral_layout(tb, 128) is not None
    monkeypatch.setattr(port_batch, "prepare_spike", lambda *a, **k: None)
    kernels.reset_launch_counts()
    got = price_barrier_batch(tb, 128)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts.values())
    monkeypatch.undo()
    ref = price_barrier_batch(tb, 128, solver="scan")
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], msg=k)


def test_auto_sends_a_float32_ad_call_to_the_scan(cuda):
    """greeks_mode="ad" under auto on a float32 batch that SPIKE and the
    spectral layout both admit: the scan (SPIKE has no AD rule, and float32
    never takes the spectral route on a card)."""
    tb = build_trade_batch(dtype=torch.float32, device=cuda, **_spectral_kwargs())
    kernels.reset_launch_counts()
    got = price_barrier_batch(tb, 128, greeks_mode="ad")
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts.values())
    ref = price_barrier_batch(tb, 128, greeks_mode="ad", solver="scan")
    spectral = price_barrier_batch(tb, 128, greeks_mode="ad", solver="spectral")
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], msg=k)
    assert not torch.equal(got["price"], spectral["price"])


def _service_trades(seed, n, n_mon=None):
    """Mixed barrier trades as a desk sends them: expiries, monitor counts
    (or ``n_mon`` each), barrier types and rebates drawn per trade."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = float(rng.uniform(0.05, 0.3))
        m = n_mon or int(rng.integers(2, 9))
        kind = ("up-and-out", "up-and-in", "down-and-out", "none")[i % 4]
        out.append(dict(
            spot=float(rng.uniform(90.0, 110.0)), strike=float(rng.uniform(95.0, 105.0)),
            sigma=float(rng.uniform(0.2, 0.4)), t_expiry=t, r=0.05, is_call=kind != "down-and-out",
            monitor_times=[t * (k + 1) / m for k in range(m)], barrier_type=kind,
            upper=130.0, lower=80.0, rebate=1.0 if i % 3 == 0 else 0.0,
        ))
    return out


def test_float32_barrier_service_launches_the_kernel(cuda):
    from finite_difference_tpu_torch.serving import BarrierPricingService

    kw = dict(n_time_steps=32, num_space_nodes=127, with_greeks=False, dtype=np.float32,
              min_bucket=8)
    trades = _service_trades(1, 5)
    kernels.reset_launch_counts()
    got = BarrierPricingService(device=cuda, **kw).price(trades)
    assert kernels.launch_counts["spike_march_f32"] > 0
    want = BarrierPricingService(device="cpu", **kw).price(trades)
    scale = max(abs(w["price"]) for w in want)
    assert max(abs(g["price"] - w["price"]) for g, w in zip(got, want)) <= 2e-4 * scale


def test_float64_american_service_launches_the_kernel(cuda):
    from finite_difference_tpu_torch.serving import AmericanPricingService

    kw = dict(n_time_steps=40, num_space_nodes=126, min_bucket=8)
    rng = np.random.default_rng(2)
    trades = [dict(spot=float(s), strike=100.0, sigma=float(v), t_expiry=float(t), r=0.06, b=0.02)
              for s, v, t in zip(rng.uniform(85, 115, 6), rng.uniform(0.15, 0.4, 6),
                                 rng.uniform(0.25, 1.5, 6))]
    kernels.reset_launch_counts()
    got = AmericanPricingService(device=cuda, **kw).price(trades)
    assert kernels.launch_counts["spike_march_american_f64"] > 0
    want = AmericanPricingService(device="cpu", solver="spike", **kw).price(trades)
    for k in want[0]:
        scale = max(abs(w[k]) for w in want)
        assert max(abs(g[k] - w[k]) for g, w in zip(got, want)) <= 1e-9 * scale, k


def test_mixed_service_stream_captures_no_graph_after_warm_up(cuda):
    """The float64 barrier service takes the spectral route, whose graphs
    are keyed on the trades' monitor layout. A stream of new mixes (each
    its own layout) runs eagerly and captures nothing; the stream's second
    pass captures each layout once (the vega bump's solve replays it); the
    third pass only replays, with the eager pass's results."""
    from finite_difference_tpu_torch.models.pde import spectral
    from finite_difference_tpu_torch.serving import BarrierPricingService

    svc = BarrierPricingService(n_time_steps=32, num_space_nodes=127, device=cuda, min_bucket=8)
    svc.price(_service_trades(3, 5, n_mon=9))  # warm-up: the DST matrix, cuBLAS's state
    stream = [_service_trades(10 + i, 1 + i % 6, n_mon=2 + i) for i in range(6)]
    counts = []
    passes = []
    with_ki = sum(any(t["barrier_type"] == "up-and-in" for t in req) for req in stream)
    for _ in range(3):
        spectral.reset_graph_counts()
        kernels.reset_launch_counts()
        passes.append([svc.price(req) for req in stream])
        counts.append(dict(spectral.graph_counts))
        launches = dict(kernels.launch_counts)
        # no march of ours; knock-in parity once a request that has knock-ins
        assert launches.pop("ki_parity_f64") == with_ki
        assert not any(launches.values())
    assert counts[0] == {"eager": 2 * len(stream), "captures": 0, "replays": 0}
    assert counts[1] == {"eager": 0, "captures": len(stream), "replays": 2 * len(stream)}
    assert counts[2] == {"eager": 0, "captures": 0, "replays": 2 * len(stream)}
    for rows_eager, rows_replayed in zip(passes[0], passes[2]):
        for g, w in zip(rows_replayed, rows_eager):
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-12), k
    want = BarrierPricingService(n_time_steps=32, num_space_nodes=127, device="cpu",
                                 min_bucket=8).price(stream[1])
    for g, w in zip(passes[0][1], want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-12), k


def test_service_over_every_card_captures_each_cards_graph_there(cuda, monkeypatch):
    """A float64 barrier service over a mesh of every visible card, named by
    their count, on the spectral route: the same request three times runs
    eagerly, then captures one graph a card on that card's own stream, then
    replays; every pass equals the one-card service, the price within 1e-12
    of max|price| and the greeks within 1e-9 (a shard's DSTs are products
    of another shape, whose last bits the bump and the second difference
    amplify, as the other card tests hold them). Skips with fewer than two
    cards. The graph cache starts empty, since an earlier test's graph of
    the same key would be replayed, not captured."""
    from collections import OrderedDict

    from finite_difference_tpu_torch.models.pde import spectral
    from finite_difference_tpu_torch.serving import BarrierPricingService

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    kw = dict(n_time_steps=32, num_space_nodes=127, solver="spectral", device=cuda, min_bucket=8)
    trades = _service_trades(21, 8 * n, n_mon=5)
    want = BarrierPricingService(**kw).price(trades)
    svc = BarrierPricingService(mesh=n, **kw)
    assert [d.index for d in svc.mesh.devices.flat] == list(range(n))
    monkeypatch.setattr(spectral, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(spectral, "_SEEN", OrderedDict())
    spectral.reset_graph_counts()
    passes = [svc.price(trades) for _ in range(3)]
    assert spectral.graph_counts["captures"] == n
    assert sorted(hit[3].index for hit in spectral._GRAPHS.values()) == list(range(n))
    scale = max(abs(r["price"]) for r in want)
    for rows in passes:
        for g, w in zip(rows, want):
            assert abs(g["price"] - w["price"]) <= 1e-12 * scale
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-9), k


def _ki_inputs(n, B, device, seed=0):
    """A (5, B) float64 stack of knock-out legs, n distinct knock-in rows
    and their (8, n) vanilla fields (service.KI_FIELDS): calls and puts,
    rebates, b != r, expiries down to 1e-6 (theta's half-expiry bump) and
    deep in- and out-of-the-money rows (the normal CDF's tail and its cut)."""
    rng = np.random.default_rng(seed)
    te = rng.uniform(0.02, 2.0, n)
    te[::7] = 1e-6
    sig = rng.uniform(0.1, 0.5, n)
    sig[3::11] = 0.01
    fields = np.stack([
        rng.uniform(60.0, 160.0, n), rng.uniform(90.0, 110.0, n), sig, te,
        rng.uniform(0.0, 0.08, n), rng.uniform(-0.03, 0.08, n),
        (rng.random(n) < 0.5).astype(np.float64),
        np.where(rng.random(n) < 0.5, rng.uniform(0.0, 3.0, n), 0.0),
    ])
    rows = np.sort(rng.choice(B, n, replace=False))
    stack = rng.normal(size=(5, B))
    as_dev = lambda a: torch.as_tensor(a, device=device)
    return as_dev(stack), as_dev(rows.astype(np.int64)), as_dev(fields)


@pytest.mark.parametrize("n", [0, 1, 960, 1001])
@pytest.mark.parametrize("keys", [KEYS, ("price",)])
def test_ki_parity_kernel_equals_its_plain_version_bit_for_bit(cuda, n, keys):
    from finite_difference_tpu_torch.serving.service import ki_parity_reference

    stack, rows, fields = _ki_inputs(n, n + 37, cuda)
    stack = stack[: len(keys)].contiguous()
    want = stack.clone()
    ki_parity_reference(want, keys, rows, fields)
    got = stack.clone()
    kernels.reset_launch_counts()
    kernels.ki_parity_cuda(got, keys, rows, fields)
    assert kernels.launch_counts["ki_parity_f64"] == (1 if n else 0)
    assert torch.equal(got, want)
    if n:
        assert not torch.equal(got, stack)


def test_barrier_service_launches_ki_parity_once_a_request_with_knock_ins(cuda):
    from finite_difference_tpu_torch.serving import BarrierPricingService

    kw = dict(n_time_steps=32, num_space_nodes=127, min_bucket=8)
    svc = BarrierPricingService(device=cuda, **kw)
    trades = _service_trades(4, 9)
    assert trades[1]["barrier_type"] == "up-and-in"
    knock_outs = [t for t in trades if t["barrier_type"] != "up-and-in"]
    svc.price(trades)  # warm-up
    for request, launches in ((trades, 1), (knock_outs, 0), (trades, 1)):
        kernels.reset_launch_counts()
        got = svc.price(request)
        assert kernels.launch_counts["ki_parity_f64"] == launches
    want = BarrierPricingService(device="cpu", **kw).price(trades)
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-12), k


def test_service_over_every_card_prices_knock_ins_as_one_card(cuda):
    """The knock-in rows of a service over every visible card (two or more;
    skips on one) equal the one-card service's bit for bit, on the scan
    route, whose rows do not depend on the batch's size."""
    from finite_difference_tpu_torch.serving import BarrierPricingService

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    kw = dict(n_time_steps=32, num_space_nodes=127, solver="scan", device=cuda, min_bucket=8)
    trades = _service_trades(23, 8 * n, n_mon=5)
    want = BarrierPricingService(**kw).price(trades)
    kernels.reset_launch_counts()
    got = BarrierPricingService(mesh=n, **kw).price(trades)
    assert kernels.launch_counts["ki_parity_f64"] == 1
    ki = [i for i, t in enumerate(trades) if t["barrier_type"] == "up-and-in"]
    assert ki and [got[i] for i in ki] == [want[i] for i in ki]


# --------------------------------------------------------------------------- #
# The FA-validation path: scalar pricers (the graphed scan) and the runners    #
# --------------------------------------------------------------------------- #
def _scalar_pricers(device):
    import datetime as dt

    from finite_difference_tpu_torch.models.pde import AmericanFDMPricer, DiscreteBarrierFDMPricer
    from finite_difference_tpu_torch.utils.curves import flat_curve

    val = dt.date(2025, 7, 28)
    curve = flat_curve(0.0731, val)
    barrier = DiscreteBarrierFDMPricer(
        spot=229.74, strike=190.0, valuation_date=val, maturity_date=dt.date(2025, 8, 28),
        sigma=0.2879, option_type="call", barrier_type="up-and-in", upper_barrier=260.0,
        monitor_dates=[val + dt.timedelta(days=7 * k) for k in range(1, 5)],
        discount_curve=curve, num_time_steps=100, fixed_num_space_nodes=200,
        rebate_amount=2.0, device=device,
    )
    american = AmericanFDMPricer(
        100.0, 100.0, val, dt.date(2026, 7, 28), 0.3, "put", curve,
        dividend_schedule=[(dt.date(2026, 1, 15), 2.0)], num_space_nodes=150,
        num_time_steps=80, device=device,
    )
    return barrier, american


def test_scalar_pricers_on_the_card_equal_the_cpu(cuda):
    """Price and greeks of a knock-in (KO leg by the scan, the Black-76
    vanilla on the card) and of an American put with a cash dividend, within
    1e-10 of max|value|; each run twice so the second replays its graphs."""
    want = [(p.price_log2(), p.greeks_log2()) for p in _scalar_pricers("cpu")]
    for _ in range(2):
        got = [(p.price_log2(), p.greeks_log2()) for p in _scalar_pricers(cuda)]
        for (pg, gg), (pw, gw) in zip(got, want):
            scale = max(abs(v) for v in (pw, *gw.values()))
            assert abs(pg - pw) <= 1e-10 * scale
            for k in gw:
                assert abs(gg[k] - gw[k]) <= 1e-10 * scale, k


def test_replayed_scan_equals_its_eager_run(cuda):
    """One key's first solve runs eagerly, its second is captured, the third
    replays: the replay with the first solve's inputs gives its values
    (<= 1e-12 of max|V|), and new inputs replay without a capture."""
    from finite_difference_tpu_torch.models.pde import spectral
    from finite_difference_tpu_torch.models.pde.american import _dynamics, _solve_batch
    from finite_difference_tpu_torch.models.pde.grid import uniform_schedule

    barrier, _ = _scalar_pricers(cuda)
    grid, n = barrier.grid, barrier.grid.n_nodes
    sch = uniform_schedule(barrier.time_to_expiry, 100, 2, barrier.monitor_times)
    spec = barrier._barrier_spec("up-and-out")
    solve = lambda sigmas: _solve_batch(
        grid, _dynamics(cuda, 190.0, True, sigmas, 0.07, 0.07), sch, n, False,
        american=False, barrier=spec)
    spectral.reset_graph_counts()
    eager = solve([0.25, 0.3, 0.27])  # three rows: a key no other test uses
    solve([0.35, 0.2, 0.22])
    replayed = solve([0.25, 0.3, 0.27])
    torch.cuda.synchronize()
    assert spectral.graph_counts == {"eager": 1, "captures": 1, "replays": 2}
    scale = float(eager.abs().max())
    assert float((replayed - eager).abs().max()) <= 1e-12 * scale


def test_american_batched_runner_launches_k2(cuda, tmp_path):
    """The batched American runner at float64 takes the double SPIKE march
    (K2) on the card, Richardson's two calls with their vega bumps; it
    agrees with the scan on the CPU within 1e-6 of max|value|."""
    import datetime as dt
    import math

    from finite_difference_tpu_torch.runners.american_scenarios import (
        run_all_american_scenarios_batched,
    )

    cfg = tmp_path / "am.csv"
    lines = ["scenario_name,S0,K,sigma,rate,FA_price,FA_delta,FA_gamma,FA_vega"]
    rng = np.random.default_rng(7)
    for i, (s, v) in enumerate(zip(rng.uniform(80, 120, 12), rng.uniform(0.15, 0.4, 12))):
        lines.append(f"a{i},{s},100.0,{v},{math.exp(0.06) - 1.0},,,,")
    cfg.write_text("\n".join(lines) + "\n")
    base = dict(valuation=dt.date(2025, 7, 28), maturity=dt.date(2026, 7, 28), opt_type="put",
                num_space_nodes=200, num_time_steps=100)
    kernels.reset_launch_counts()
    got = run_all_american_scenarios_batched(str(cfg), None, base, device=cuda)
    assert kernels.launch_counts["spike_march_american_f64"] > 0
    want = run_all_american_scenarios_batched(str(cfg), None, base, device="cpu")
    for k in ("model_price", "model_delta", "model_gamma", "model_vega"):
        scale = max(abs(w[k]) for w in want)
        assert max(abs(g[k] - w[k]) for g, w in zip(got, want)) <= 1e-6 * scale, k


def _fa_analytic_outputs(device):
    """A curve-path BS row, BGK rows on both routes and the FIS stencil's
    price and greeks, each a dict of floats."""
    import datetime as dt

    from finite_difference_tpu_torch.models.analytic import (
        BjerksundStenslandForwardPricer,
        DiscreteBarrierBGKPricer,
    )
    from finite_difference_tpu_torch.models.pde import DiscreteBarrierFDMPricer2
    from finite_difference_tpu_torch.utils import flat_naca_dataframe
    from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates

    val, mat = dt.date(2025, 7, 28), dt.date(2026, 7, 28)
    curve = flat_naca_dataframe(0.0731)
    bs = BjerksundStenslandForwardPricer(device=device).greeks_from_curves(
        95.0, 100.0, val, mat, 0.3, "put", discount_curve=curve, underlying_spot_days=3)
    out = {f"bs_{k}": v for k, v in bs.items()}
    for route, freq in (("bgk", "daily"), ("mc", "monthly")):
        pr = DiscreteBarrierBGKPricer(
            spot=100.0, strike=100.0, valuation_date=val, maturity_date=mat, option_type="call",
            barrier_type="up-and-out", upper_barrier=130.0, rebate_amount=1.0,
            monitor_dates=build_monitoring_dates(val, mat, freq), discount_curve=curve,
            volatility=0.25, mc_n_paths=20000, device=device)
        assert pr._select_method() == route
        out.update({f"{route}_price": pr.price(), **{f"{route}_{k}": v for k, v in pr.greeks().items()}})
    fis = DiscreteBarrierFDMPricer2(
        spot=229.74, strike=190.0, valuation_date=val, maturity_date=dt.date(2025, 8, 28),
        volatility=0.2879, option_type="call", barrier_type="up-and-in", upper_barrier=260.0,
        monitoring_dates=[val + dt.timedelta(days=7 * k) for k in range(1, 5)],
        flat_rate_nacc=0.0705, num_space_nodes=200, num_time_steps=150, device=device)
    out.update({"fis_price": fis.price(), **{f"fis_{k}": v for k, v in fis.greeks().items()}})
    return out


def test_fa_analytics_on_the_card_equal_the_cpu(cuda):
    want = _fa_analytic_outputs("cpu")
    got = _fa_analytic_outputs(cuda)
    for prefix in ("bs", "bgk", "mc", "fis"):
        keys = [k for k in want if k.startswith(prefix + "_")]
        scale = max(abs(want[k]) for k in keys)
        for k in keys:
            limit = 1e-7 if k.endswith("gamma") else 1e-10
            assert abs(got[k] - want[k]) <= limit * scale, k


def test_implied_vol_on_the_card_equals_the_cpu(cuda):
    """A chain like test_implied_vol.py's, inverted on both devices."""
    from scipy.special import ndtr

    from finite_difference_tpu_torch.models.analytic import generalized_bs_price, implied_vol_black76

    rng = np.random.default_rng(5)
    B = 4096
    f = rng.uniform(50, 400, B)
    k = f * np.exp(rng.uniform(-3.0, 3.0, B))
    t = rng.uniform(0.02, 10.0, B)
    sigma = rng.uniform(0.02, 1.5, B)
    df = np.exp(-rng.uniform(0.0, 0.1, B) * t)
    is_call = rng.integers(0, 2, B).astype(bool)
    args = [torch.as_tensor(a) for a in (f, k, t, df, is_call)]
    price = (args[3] * generalized_bs_price(args[0], args[1], torch.as_tensor(sigma), args[2],
                                            0.0, 0.0, args[4])).numpy()
    want = implied_vol_black76(torch.as_tensor(price), *args).numpy()
    got = implied_vol_black76(torch.as_tensor(price, device=cuda), *(a.to(cuda) for a in args))
    assert got.dtype == torch.float64 and got.device.type == cuda.type
    got = got.cpu().numpy()
    # the rounding noise of each normalized premium (test_torch_fa_analytic.iv_noise):
    # quotes within it of the band's edges may fall either side; sigma may move by
    # it over dc/dln(v)
    eps = np.finfo(np.float64).eps
    x = np.log(f / k)
    xm, v = -np.abs(x), np.where(np.isfinite(want), want, sigma) * np.sqrt(t)
    c_in = price / df / np.sqrt(f * k)
    d1 = xm / v + 0.5 * v
    itm = np.where(is_call, x > 0, x < 0)
    noise_c = eps * (c_in + np.exp(0.5 * xm) * ndtr(d1) + np.exp(-0.5 * xm) * ndtr(d1 - v)
                     + np.where(itm, np.exp(0.5 * x) + np.exp(-0.5 * x), 0.0))
    intr = np.abs(np.exp(0.5 * x) - np.exp(-0.5 * x))
    c_otm = c_in - np.where(itm, intr, 0.0)
    floor = np.where(itm, 8.0 * eps * intr, 0.0)
    edge = ((np.abs(c_otm - floor) <= 4 * noise_c) | (np.abs(np.exp(0.5 * xm) - c_otm) <= 4 * noise_c)
            | (c_otm < 1e-290))
    assert ((np.isnan(got) != np.isnan(want)) & ~edge).sum() == 0
    with np.errstate(divide="ignore", over="ignore"):  # vega underflows in the far wings
        noise = noise_c / (np.exp(0.5 * xm) * np.exp(-0.5 * d1 * d1) / np.sqrt(2 * np.pi) * v)
    ok = np.isfinite(got) & np.isfinite(want) & ~edge
    rel = np.abs(got[ok] - want[ok]) / want[ok]
    assert (rel <= np.maximum(1e-12, 16.0 * noise[ok])).all()


def test_fis_replay_equals_its_eager_run(cuda):
    """The FIS march's first solve of a key runs eagerly, its second is
    captured, the third replays: all three give the same grid (1e-12)."""
    import datetime as dt

    from finite_difference_tpu_torch.models.pde import DiscreteBarrierFDMPricer2, spectral

    val = dt.date(2025, 7, 28)
    pr = DiscreteBarrierFDMPricer2(
        spot=229.74, strike=190.0, valuation_date=val, maturity_date=dt.date(2025, 8, 28),
        volatility=0.2879, option_type="put", barrier_type="up-and-out", upper_barrier=260.0,
        monitoring_dates=[val + dt.timedelta(days=7 * k) for k in range(1, 5)],
        flat_rate_nacc=0.0705, num_space_nodes=230, num_time_steps=111, device=cuda)
    spectral.reset_graph_counts()
    grids = [pr._solve_grid_once()[1] for _ in range(3)]
    assert spectral.graph_counts == {"eager": 1, "captures": 1, "replays": 2}
    scale = np.abs(grids[0]).max()
    for g in grids[1:]:
        assert np.abs(g - grids[0]).max() <= 1e-12 * scale


def test_trace_writes_a_trace(cuda, tmp_path):
    import os

    from finite_difference_tpu_torch.utils import throughput, trace

    x = torch.ones(1 << 16, dtype=torch.float64, device=cuda)
    with trace(str(tmp_path / "trace")) as logdir:
        (x * 2.0).sum()
        torch.cuda.synchronize()
    files = [os.path.join(d, f) for d, _, fs in os.walk(logdir) for f in fs]
    assert files and sum(os.path.getsize(f) for f in files) > 0
    res = throughput(lambda: x * 2.0, items_per_call=1 << 16, iters=3)
    assert res["items_per_sec"] > 0


# ---------------------------------------------------------------------------
# the Monte Carlo layer (no kernel of ours): the card against the CPU


@pytest.mark.parametrize("shape", [(7,), (300, 70), (4097, 3)])
def test_mc_threefry_on_the_card_equals_the_cpu(cuda, shape):
    """threefry bits and uniforms bit for bit; normals within the two
    erfinvs' rounding (1e-13 relative at float64, 5e-5 absolute at float32)."""
    from finite_difference_tpu_torch.models.mc import rng

    key = rng.prng_key(2**31 + 7)
    for bits in (32, 64):
        assert torch.equal(rng.threefry_bits(key, shape, bits, device=cuda).cpu(),
                           rng.threefry_bits(key, shape, bits, device="cpu"))
    for dtype, rtol, atol in ((torch.float64, 1e-13, 0.0), (torch.float32, 0.0, 5e-5)):
        assert torch.equal(rng._uniforms(key, rng._counts(shape, cuda), dtype, 0.0, 1.0).cpu(),
                           rng._uniforms(key, rng._counts(shape, "cpu"), dtype, 0.0, 1.0))
        torch.testing.assert_close(rng.threefry_normals(key, shape, dtype, device=cuda).cpu(),
                                   rng.threefry_normals(key, shape, dtype, device="cpu"),
                                   rtol=rtol, atol=atol)
    assert torch.equal(rng.sobol_uniforms(512, 5, 40, device=cuda).cpu(),
                       rng.sobol_uniforms(512, 5, 40, device="cpu"))


@pytest.mark.parametrize("barrier_type, level", [("up-and-out", 250.0), ("down-and-in", 215.0)])
def test_mc_discrete_barrier_on_the_card_equals_the_cpu(cuda, barrier_type, level):
    import datetime as dt

    from finite_difference_tpu_torch.models.mc import discrete_barrier as db
    from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates
    from finite_difference_tpu_torch.utils.curves import flat_curve

    val, mat = dt.date(2025, 7, 28), dt.date(2025, 8, 28)
    kw = dict(spot=229.74, strike=190.0, vol=0.2879, option_type="call", valuation=val,
              maturity=mat, discount_curve=flat_curve(0.073, val),
              monitor_dates=build_monitoring_dates(val, mat, "daily"),
              dividends=[(dt.date(2025, 8, 14), 3.0)], barrier=db.BarrierSpec(barrier_type, level),
              rebate=db.RebateSpec(2.0, True), cfg=db.MCConfig(n_paths=8192, seed=42))
    got, want = db.price_discrete_barrier_mc(device=cuda, **kw), db.price_discrete_barrier_mc(device="cpu", **kw)
    for k in ("price", "stderr"):
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k])


def test_mc_lsm_gbm_cs_on_the_card_equal_the_cpu(cuda):
    import numpy as np

    from finite_difference_tpu_torch.models.mc import (
        CSForwardCurveSimulator, CSParams, GBMParams, GBMSimulator, price_american_lsm)

    args = (100.0, 105.0, 0.25, 1.0, 0.05, 0.02, False)
    got = price_american_lsm(*args, n_paths=8192, n_steps=50, seed=2, device=cuda)
    want = price_american_lsm(*args, n_paths=8192, n_steps=50, seed=2, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10)
    z = np.random.default_rng(0).standard_normal((12, 1000))
    days = np.arange(0, 360, 30)
    gbm = lambda dev: GBMSimulator(GBMParams(0.05, 0.2), device=dev).simulate(100.0, days, z).cpu()
    torch.testing.assert_close(gbm(cuda), gbm("cpu"), rtol=1e-13, atol=0.0)
    cs = lambda dev: CSForwardCurveSimulator(CSParams(1.2, 0.35, 0.08), 365.25, device=dev).simulate(
        np.array([50.0, 52.0, 55.0]), np.array([30.0, 180.0, 365.0]), days, z).cpu()
    torch.testing.assert_close(cs(cuda), cs("cpu"), rtol=1e-13, atol=0.0)


def test_mc_hw1f_on_the_card_equals_the_cpu(cuda):
    import datetime as dt

    import numpy as np

    from finite_difference_tpu_torch.models.mc import HW1FCurveSimulator, HW1FParams

    tenors0 = np.array([0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
    rates0 = np.array([0.070, 0.071, 0.072, 0.074, 0.077, 0.079, 0.080])
    sim = lambda dev: HW1FCurveSimulator(HW1FParams(0.3, np.array([0.0, 1.0]), np.array([0.02, 0.005])),
                                         tenors0, rates0, device=dev)
    t_grid = np.linspace(1 / 12, 10.0, 120)
    got = sim(cuda).simulate(t_grid, tenors0, 513, seed=7, as_jax=True)
    assert got.device.type == "cuda"
    want = sim("cpu").simulate(t_grid, tenors0, 513, seed=7)
    assert np.abs(got.cpu().numpy() - want).max() <= 1e-12 * np.abs(want).max()
    cube = sim(cuda).to_scenario_cube(dt.date(2025, 7, 28), [30 * i for i in range(1, 13)], tenors0, 64)
    ref = sim("cpu").to_scenario_cube(dt.date(2025, 7, 28), [30 * i for i in range(1, 13)], tenors0, 64)
    name = "InterestRate.ZAR-SWAP"
    assert np.abs(cube.factor_array(name) - ref.factor_array(name)).max() <= 1e-12 * np.abs(
        ref.factor_array(name)).max()


def _xva_swaps(n, pkg_inst):
    import datetime as dt

    val = dt.date(2025, 7, 28)
    return [pkg_inst.IRSwap(
        name=f"irs{k}", effective_date=val, maturity_date=dt.date(2027, 7, 28), notional=1_000_000,
        receive_leg=pkg_inst.SwapLeg(pkg_inst.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
        pay_leg=pkg_inst.SwapLeg(pkg_inst.LegType.FIXED, frequency=3, fixed_rate=0.07 + 0.002 * k),
        discount_curve_name="ZAR-SWAP") for k in range(n)]


def test_xva_hw1f_pipeline_on_the_card_equals_the_cpu(cuda):
    import datetime as dt

    from finite_difference_tpu_torch import instruments
    from finite_difference_tpu_torch.models.mc import HW1FCurveSimulator, HW1FParams
    from finite_difference_tpu_torch.xva import hw1f_cva_pipeline

    tenors = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    def run(dev):
        sim = HW1FCurveSimulator(HW1FParams.flat(0.05, 0.01), tenors, np.full(8, 0.075), device=dev)
        return hw1f_cva_pipeline(sim, dt.date(2025, 7, 28), list(range(30, 780, 30)), tenors,
                                 1000, _xva_swaps(3, instruments), flat_discount_rate=0.075)

    got, want = run(cuda), run("cpu")
    assert got["mtm"].device.type == "cuda"
    m, w = got["mtm"].cpu().numpy(), want["mtm"].numpy()
    assert np.abs(m - w).max() <= 1e-10 * np.abs(w).max()
    assert abs(got["cva"] - want["cva"]) <= 1e-10 * abs(want["cva"])


def test_xva_device_engine_with_surfaces_on_the_card_equals_the_cpu(cuda):
    import datetime as dt

    from finite_difference_tpu_torch import instruments
    from finite_difference_tpu_torch.xva import DeviceExposureEngine

    val = dt.date(2025, 7, 28)
    rng = np.random.default_rng(7)
    dates = [val + dt.timedelta(days=14 * i) for i in range(12)]
    eq = 100.0 * np.exp(rng.normal(0.0, 0.035, (12, 500)).cumsum(axis=0))
    rates = 0.07 + rng.normal(0, 0.002, (12, 500, 5)).cumsum(axis=0)
    tenors = np.array([0.25, 0.5, 1.0, 2.0, 5.0])
    def run(dev):
        mat = dates[-1]
        ko = instruments.EquityBarrierOption(
            "uoc", "EQ.SPOT", 100.0, mat, 0.3, 0.07, monitor_dates=dates[2::2],
            upper_barrier=135.0, rebate=1.0, quantity=50.0, n_time_steps=64, num_space_nodes=255,
            device=dev)
        am = instruments.AmericanOptionPosition("amp", "EQ.SPOT", 95.0, mat, 0.3, 0.07, quantity=50.0,
                                                n_time_steps=64, num_space_nodes=200, device=dev)
        eng = DeviceExposureEngine(dates, {"ZAR-SWAP": rates}, tenors, scalars={"EQ.SPOT": eq}, device=dev)
        return eng.mtm([ko, am, _xva_swaps(1, instruments)[0]])

    got, want = run(cuda), run("cpu")
    assert got.device.type == "cuda"
    m, w = got.cpu().numpy(), want.numpy()
    assert np.abs(m - w).max() <= 1e-10 * np.abs(w).max()


def test_xva_exposure_profile_on_the_card_equals_the_cpu(cuda):
    from finite_difference_tpu_torch.xva.cva import exposure_profile

    mtm = np.random.default_rng(3).normal(0.1, 1.0, (61, 200_000)) * 1e5
    times = np.arange(61) * 30.0
    df0 = np.exp(-0.075 * times / 365.25)
    got = exposure_profile(times, torch.as_tensor(mtm, device=cuda), df0=df0)
    want = exposure_profile(times, mtm, df0=df0)
    np.testing.assert_allclose(got.ee, want.ee, rtol=1e-13)
    np.testing.assert_allclose(got.pfe, want.pfe, rtol=1e-13)


def test_xva_float32_under_tf32_raises(cuda):
    import datetime as dt

    from finite_difference_tpu_torch import instruments
    from finite_difference_tpu_torch.xva import DeviceExposureEngine

    dates = [dt.date(2025, 7, 28) + dt.timedelta(days=30 * i) for i in range(4)]
    cube = torch.full((4, 8, 8), 0.07, dtype=torch.float32)
    eng = DeviceExposureEngine(dates, {"ZAR-SWAP": cube}, np.array([0.25, 0.5, 1, 2, 3, 5, 7, 10.0]),
                               device=cuda)
    swap = _xva_swaps(1, instruments)[0]
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ValueError, match="TF32"):
            eng.mtm([swap])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _xva_family_market(n_times=26, n_paths=400, seed=3):
    """A monthly cube of a swap curve, a dividend curve, an inflation curve,
    a CPI level curve and a Brent forward curve, with equity and CPI
    scalars (test_torch_xva_families.py's markets in one)."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    val = dt.date(2025, 7, 28)
    dates = [val + dt.timedelta(days=30 * i) for i in range(n_times)]
    shape = (n_times, n_paths, 8)
    cpi = 102.4 * np.exp(0.004 * np.arange(n_times)[:, None]
                         + rng.normal(0, 0.002, (n_times, n_paths)).cumsum(axis=0))
    tenors = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    curves = {"ZAR-SWAP": 0.075 + rng.normal(0, 0.002, shape).cumsum(axis=0),
              "EQ.DIV": np.full(shape, 0.02), "INFL.ZA": 0.05 + rng.normal(0, 0.001, shape).cumsum(axis=0),
              "CPI.CURVE": cpi[:, :, None] * np.exp(0.05 * tenors)[None, None, :],
              "BRENT": 70.0 * np.exp(rng.normal(0.001, 0.02, shape).cumsum(axis=0))}
    scalars = {"EQ.SPOT": 100.0 * np.exp(rng.normal(0.002, 0.05, (n_times, n_paths)).cumsum(axis=0)),
               "CPI.ZA": cpi}
    return val, dates, tenors, curves, scalars


def _xva_family_trades(kind, val):
    import datetime as dt

    from finite_difference_tpu_torch import instruments as I
    from finite_difference_tpu_torch.market_data import first_of_month, shift_months

    float_leg = I.SwapLeg(I.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP", spread=0.01)
    if kind == "trs":
        return [I.EquityTRS(name=f"trs-{s}", effective_date=val - dt.timedelta(days=100),
                            maturity_date=dt.date(2027, 7, 28), quantity=1000.0, notional=100_000.0,
                            interest_leg=float_leg, spot_name="EQ.SPOT", carry_curve_name="ZAR-SWAP",
                            dividend_curve_name="EQ.DIV", discount_curve_name="ZAR-SWAP", initial_price=100.0,
                            interest_nominal_scaling=s) for s in ("Initial Price", "Price")]
    if kind == "ils":
        hist = {shift_months(first_of_month(val), -k): 100.0 + 0.3 * (8 - k) for k in range(9)}
        return [I.IndexLinkedSwap(
            name=f"ils-{c}", effective_date=val, maturity_date=dt.date(2027, 7, 28), notional=1_000_000,
            inflation_leg=I.InflationLeg(real_rate=0.025, base_cpi=100.0, cpi_curve_name=c, frequency=6,
                                         inflation_rate_curve_name=r),
            nominal_leg=I.SwapLeg(I.LegType.FIXED, frequency=6, fixed_rate=0.08),
            discount_curve_name="ZAR-SWAP", inflation_index=hist)
            for c, r in (("CPI.ZA", "INFL.ZA"), ("CPI.CURVE", ""))]
    return [I.CommodityForwardInstrument("cf", delivery_date=val + dt.timedelta(days=180), strike=72.0,
                                         notional=1000.0, forward_curve_name="BRENT",
                                         discount_curve_name="ZAR-SWAP", pricing_lag_days=2),
            I.CommodityAverageForwardInstrument(
                "caf", averaging_dates=[val + dt.timedelta(days=30 * k) for k in range(1, 7)],
                payment_date=val + dt.timedelta(days=200), strike=71.0, notional=500.0,
                forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP", pricing_lag_days=1)]


@pytest.mark.parametrize("kind", ["trs", "ils", "commodity"])
def test_xva_families_on_the_card_equal_the_cpu(cuda, kind):
    from finite_difference_tpu_torch.xva import DeviceExposureEngine

    val, dates, tenors, curves, scalars = _xva_family_market()
    trades = _xva_family_trades(kind, val)
    got, want = (DeviceExposureEngine(dates, curves, tenors, scalars=scalars, device=d).mtm(trades)
                 for d in (cuda, "cpu"))
    assert got.device.type == "cuda"
    m, w = got.cpu().numpy(), want.numpy()
    assert np.abs(w).max() > 0 and np.abs(m - w).max() <= 1e-10 * np.abs(w).max()


def test_xva_simm_on_the_card_equals_the_cpu(cuda):
    from finite_difference_tpu_torch import instruments as I
    from finite_difference_tpu_torch.portfolio import CSA, InitialMarginMethod
    from finite_difference_tpu_torch.xva import DeviceExposureEngine

    val, dates, tenors, curves, scalars = _xva_family_market(n_times=14, n_paths=200)
    swap = I.IRSwap(name="irs", effective_date=val, maturity_date=dates[-1], notional=1_000_000,
                    receive_leg=I.SwapLeg(I.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
                    pay_leg=I.SwapLeg(I.LegType.FIXED, frequency=3, fixed_rate=0.08),
                    discount_curve_name="ZAR-SWAP")
    trades = [swap] + _xva_family_trades("trs", val)[:1] + _xva_family_trades("ils", val)[:1]
    csa = CSA(mpor_days=10, vm_threshold=500.0, vm_threshold_post=800.0, im_method=InitialMarginMethod.SIMM)
    out = []
    for d in (cuda, "cpu"):
        eng = DeviceExposureEngine(dates, curves, tenors, scalars=scalars, device=d)
        before = eng.mtm(trades)
        out.append(eng.compute(trades, csa=csa))
        assert torch.equal(eng.mtm(trades), before)  # the SIMM pass leaves the cached legs alone
    got, want = out
    for f in ("mtm", "collateral", "exposure"):
        g, w = getattr(got, f), getattr(want, f)
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), f


@pytest.mark.parametrize("backend", ["threefry", "sobol", "sobol_device"])
def test_xva_run_asset_on_the_card_equals_the_cpu(cuda, backend):
    from finite_difference_tpu_torch.models.mc import CSParams
    from finite_difference_tpu_torch.runners import run_asset
    from finite_difference_tpu_torch.xva import SimulationConfig

    got, want = (run_asset("BRENT", initial_curve=np.array([78.0, 79.5, 80.2, 81.0, 81.5]),
                           tenor_days=np.array([30.0, 90.0, 180.0, 270.0, 365.0]),
                           cs_params=CSParams(alpha=1.1, sigma=0.35, mu=0.0),
                           sim_cfg=SimulationConfig(num_sims=2000), rng_backend=backend, device=d)
                 for d in (cuda, "cpu"))
    assert got["cva"] > 0 and abs(got["cva"] - want["cva"]) <= 1e-12 * abs(want["cva"])
    for key in ("peak_ee", "peak_pfe"):
        assert abs(got[key] - want[key]) <= 1e-12 * abs(want[key])


# ---------------------------------------------------------------------------
# the scenario layer (no kernel of ours): the card against the CPU


@pytest.mark.parametrize("backend", ["threefry", "sobol_device", "torch"])
def test_scenarios_draws_and_paths_on_the_card_equal_the_cpu(cuda, backend):
    """generate_random_numbers on 25a's two correlated factors (rho 0.6) at
    a small batch and generate_paths on them: threefry and sobol_device
    within 1e-12 of max|z| (the two erfinvs' and ndtri's rounding), the
    torch backend bit for bit (its draws come from the CPU); the paths
    within 1e-12 of max|F|."""
    from finite_difference_tpu_torch.models.mc import rng
    from finite_difference_tpu_torch.scenarios import build_cholesky, generate_paths, generate_random_numbers, precalculate

    L = build_cholesky({("A", "B"): 0.6}, ["A", "B"])
    key = rng.threefry_fold_in(rng.prng_key(42), 3)
    z = {d: generate_random_numbers(L, 30, 256, use_antithetic=True, rng_backend=backend, key=key, seed=42,
                                    sobol_offset=384, device=d) for d in (cuda, "cpu")}
    got, want = z[cuda].cpu(), z["cpu"]
    if backend == "torch":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    tenor_days = 45000.0 + 30.0 * np.arange(1, 25)
    pre = precalculate(80.0 + np.arange(24.0), tenor_days, np.arange(0, 720, 24), 0.35, 1.1, 0.04, 45000)
    paths = {d: generate_paths(pre, z[d], factor_index=1) for d in (cuda, "cpu")}
    assert np.abs(paths[cuda] - paths["cpu"]).max() <= 1e-12 * np.abs(paths["cpu"]).max()
