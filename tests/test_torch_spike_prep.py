"""The SPIKE prep's compressed layout (models/pde/spike.py), on the CPU at float64.

The prep keeps each per-row solver vector as two columns (chunks 0..P-2
share one), the interface system as the factors of its banded block LU,
and the knock-out mask as two row indices per trade. Each is held against
the form it replaces, built here the direct way: the (B, m, P) per-row
vectors (<= 1e-14), a dense solve of the 2P x 2P interface system
(<= 1e-13), and the per-row mask (bit for bit). The block pivots of the
elimination, which runs without pivoting, are checked on the barrier and
American trade sets that chip_smoke.py drives, at a reduced batch, and the
prep refuses a batch on which that elimination would be unsafe. Where it
refuses, ``solver="auto"`` takes the scan for the whole call, from the
prep's verdict and without a second prep; an explicit ``solver="spike"``
raises.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import spike
from finite_difference_tpu_torch.models.pde.batch import (
    _spike_schedule_impl,
    build_american_batch,
    build_trade_batch,
)

import chip_smoke


def _kwargs(seed=0, B=8, n_steps=16, num_space_nodes=127):
    """Calls and puts; up-and-out, down-and-out and double barriers."""
    rng = np.random.default_rng(seed)
    t = 0.25
    return dict(
        spots=list(rng.uniform(90.0, 110.0, B)), strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.4, B)), t_expiry=[t] * B, r=[0.05] * B,
        b=list(rng.uniform(0.0, 0.05, B)), is_call=[i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps, monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        lower=[80.0 if i % 4 < 2 else None for i in range(B)],
        upper=[125.0 if i % 4 != 1 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 3.0, B)), rebate_at_hit=[i % 3 == 0 for i in range(B)],
        num_space_nodes=num_space_nodes,
    )


def _prep(n_nodes, seed=0, B=8, P=None):
    """A prep at ``P`` chunks, by default the one-warp P that the rule
    gives the main path's batch size."""
    tb = build_trade_batch(device="cpu", **_kwargs(seed=seed, B=B, num_space_nodes=n_nodes - 1))
    P = P or spike.spike_p(n_nodes, chip_smoke.B_MAIN)
    return tb, spike.prepare_spike(tb, tb.sigma, n_nodes, P, ((1.0, 0), (0.5, 0)))


def _direct_rows(tb, n_nodes, P, theta):
    """The per-row (B, m, P) vectors w, af, ab, vsp, wsp, every chunk solved on its own."""
    n_int, m, _ = spike.spike_shape(n_nodes, P)
    r, b, q, dx, dt = (x.double() for x in (tb.r, tb.b, tb.q, tb.dx, tb.dt[:, 0]))
    sig2 = tb.sigma.double() ** 2
    alpha_c = 0.5 * sig2 / (dx * dx)
    beta_adv = ((b - q) - 0.5 * sig2) / (2.0 * dx)
    a_l = -theta * dt * (alpha_c - beta_adv)
    a_u = -theta * dt * (alpha_c + beta_adv)
    a_c = 1.0 - theta * dt * (-2.0 * alpha_c - r)
    ii = torch.arange(m)[:, None]
    g = torch.arange(P)[None, :] * m + ii
    real = g < n_int
    col = lambda x: x[:, None, None]
    l = torch.where(real & (ii > 0), col(a_l), 0.0)
    c = torch.where(real, col(a_c), 1.0)
    u = torch.where(real & (ii < m - 1) & (g < n_int - 1), col(a_u), 0.0)
    w, af, ab = spike._per_row_thomas(l, c, u)
    e0, em = torch.zeros_like(c), torch.zeros_like(c)
    e0[:, 0] = 1.0
    em[:, m - 1] = 1.0
    vsp = col(a_l) * spike._chunk_solve(w, af, ab, e0)
    vsp[:, :, 0] = 0.0
    wsp = col(a_u) * spike._chunk_solve(w, af, ab, em)
    wsp[:, :, P - 1] = 0.0
    return w, af, ab, vsp, wsp


def _dense_interface(p, q, r, s):
    """R (B, 2P, 2P) over u = [t_0..t_{P-1}, b_0..b_{P-1}]:
    t_j + p_j b_{j-1} + q_j t_{j+1} = y_top_j, b_j + r_j b_{j-1} + s_j t_{j+1} = y_bot_j."""
    B, P = p.shape
    R = torch.eye(2 * P, dtype=p.dtype).repeat(B, 1, 1)
    j = torch.arange(1, P)
    R[:, j, P + j - 1] = p[:, 1:]
    R[:, P + j, P + j - 1] = r[:, 1:]
    j = torch.arange(P - 1)
    R[:, j, j + 1] = q[:, : P - 1]
    R[:, P + j, j + 1] = s[:, : P - 1]
    return R


# pad rows 3, 2, 1 at P=32 (N = 127, 128, 129), P=8 at N=152, P=16 at N=200
@pytest.mark.parametrize("n_nodes", [127, 128, 129, 152, 200])
def test_compressed_columns_expand_to_the_per_row_vectors(n_nodes):
    tb, prep = _prep(n_nodes, seed=n_nodes)
    assert prep.P == {127: 32, 128: 32, 129: 32, 152: 8, 200: 16}[n_nodes]
    assert prep.fields.shape == (2, 8, 5, 2, prep.m)
    for t, theta in enumerate((1.0, 0.5)):
        got = spike.expand_fields(prep.fields[t], prep.P)
        want = _direct_rows(tb, n_nodes, prep.P, theta)
        for name, g, w in zip(spike.FIELD_ROWS, got, want):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-14, name


@pytest.mark.parametrize("n_nodes", [128, 152, 200, 1024])
def test_banded_interface_solve_matches_a_dense_solve(n_nodes):
    _, prep = _prep(n_nodes, seed=n_nodes + 1)
    P = prep.P
    rng = np.random.default_rng(n_nodes)
    for t in range(2):
        tips = spike.interface_tips(prep.fields[t], P)
        iface, det = spike.interface_factors(*tips)
        assert torch.equal(iface, prep.iface[t])
        y_top, y_bot = (torch.from_numpy(rng.standard_normal((8, P))) for _ in range(2))
        u = torch.linalg.solve(_dense_interface(*tips), torch.cat([y_top, y_bot], dim=1))
        t_ref, b_ref = u[:, :P], u[:, P:]
        bprev, tnext = spike.interface_solve(iface, y_top, y_bot)
        assert float((bprev[:, 1:] - b_ref[:, :-1]).abs().max()) <= 1e-13
        assert float((tnext[:, :-1] - t_ref[:, 1:]).abs().max()) <= 1e-13
        assert torch.all(bprev[:, 0] == 0) and torch.all(tnext[:, -1] == 0)


@pytest.mark.parametrize("P", [32, 64, 128])
def test_banded_interface_solve_matches_a_dense_solve_at_main_width(P):
    """N=1024 at one warp's 32 chunks, and at 64 and 128, whose scans run
    per 32 chunks and then carry across the warps."""
    _, prep = _prep(1024, seed=P, P=P)
    rng = np.random.default_rng(P)
    for t in range(2):
        tips = spike.interface_tips(prep.fields[t], P)
        y_top, y_bot = (torch.from_numpy(rng.standard_normal((8, P))) for _ in range(2))
        u = torch.linalg.solve(_dense_interface(*tips), torch.cat([y_top, y_bot], dim=1))
        bprev, tnext = spike.interface_solve(prep.iface[t], y_top, y_bot)
        assert float((bprev[:, 1:] - u[:, P:-1]).abs().max()) <= 1e-12
        assert float((tnext[:, :-1] - u[:, 1:P]).abs().max()) <= 1e-12
        assert torch.all(bprev[:, 0] == 0) and torch.all(tnext[:, -1] == 0)


def _direct_mask(tb, n_nodes, prep):
    """The per-row knock-out mask (B, m, P) built node by node."""
    i = torch.arange(n_nodes, dtype=torch.float64)
    s = torch.exp(tb.x_min.double()[:, None] + i[None, :] * tb.dx.double()[:, None])
    full = (tb.has_lower[:, None] & (s <= tb.lower.double()[:, None])) | (
        tb.has_upper[:, None] & (s >= tb.upper.double()[:, None])
    )
    g = torch.arange(prep.P)[None, :] * prep.m + torch.arange(prep.m)[:, None]
    real = g < prep.n_int
    return real & full[:, 1:-1][:, g.clamp(max=prep.n_int - 1)], full


@pytest.mark.parametrize("n_nodes", [127, 128, 129, 152, 1024])
def test_knock_out_indices_reproduce_the_mask(n_nodes):
    # spots near the barriers so that both ends knock out rows
    tb, prep = _prep(n_nodes, seed=n_nodes + 2, B=12)
    want, full = _direct_mask(tb, n_nodes, prep)
    got = spike.ko_rows(prep)
    assert torch.equal(got, want)
    assert bool(want.any())
    col = spike.TRADE_COLS.index
    assert torch.equal(prep.trade[:, col("omask_lo")] != 0, full[:, 0])
    assert torch.equal(prep.trade[:, col("omask_hi")] != 0, full[:, -1])


def test_knock_out_indices_on_the_benchmark_barrier_set():
    tb = build_trade_batch(device="cpu", **chip_smoke.bench_trades(16)[0])
    prep = spike.prepare_spike(tb, tb.sigma, 1024, 32, ((1.0, 0),))
    want, _ = _direct_mask(tb, 1024, prep)
    assert torch.equal(spike.ko_rows(prep), want)
    assert bool(want.any())  # H=420 lies inside the grid


def _pivots(tb, n_nodes, set_defs, american, P=32):
    """(least det, largest det, largest |factor| of the two recurrences,
    largest tip row sum) per solver set."""
    prep = spike.prepare_spike(tb, tb.sigma, n_nodes, P, set_defs, american=american)
    out = []
    for t in range(len(set_defs)):
        p, q, r, s = spike.interface_tips(prep.fields[t], prep.P)
        iface, det = spike.interface_factors(p, q, r, s)
        rows = [spike.IFACE_ROWS.index(k) for k in ("hb_h", "zt_z")]
        row_sum = torch.maximum(p.abs() + q.abs(), r.abs() + s.abs())
        out.append((float(det.min()), float(det.max()), float(iface[:, rows].abs().max()),
                    float(row_sum.max())))
    return out


def test_block_pivots_on_the_chip_smoke_trade_sets():
    """No pivoting is needed: A is diagonally dominant (|mu| dx <= sigma^2),
    the eliminated 2x2 blocks stay away from singular, and both
    recurrences contract, so rounding errors do not grow across the pairs.
    On these sets (float64): determinants 1 - s'_j p_{j+1} in [0.73, 0.95]
    for the barrier set and [0.245, 0.57] for the American set (its
    dt/dx^2 is ~47, so the spike tips reach 0.87); recurrence factors
    <= 7e-10 and <= 1.2e-2."""
    tb = build_trade_batch(device="cpu", **chip_smoke.bench_trades(64)[0])
    mu = (tb.b - tb.q) - 0.5 * tb.sigma**2
    assert bool((mu.abs() * tb.dx <= tb.sigma**2).all())
    for lo, hi, factor, _ in _pivots(tb, chip_smoke.N_NODES, spike.default_segments(tb.n_steps)[1], False):
        assert 0.7 <= lo and hi <= 1.0 and factor <= 1e-9
    for dividends in (False, True):
        ta = build_american_batch(device="cpu", **chip_smoke.american_trades(64, dividends)[0])
        mu = (ta.b - ta.q) - 0.5 * ta.sigma**2
        assert bool((mu.abs() * ta.dx <= ta.sigma**2).all())
        set_defs = _spike_schedule_impl(ta, chip_smoke.N_NODES)[1]
        for lo, hi, factor, _ in _pivots(ta, chip_smoke.N_NODES, set_defs, True):
            assert 0.2 <= lo and hi <= 1.0 and factor <= 0.05


@pytest.mark.parametrize("P,row_sum_max", [(32, 0.88), (64, 0.90), (128, 0.94)])
def test_guard_passes_on_the_rung_trade_set_at_several_warps(P, row_sum_max):
    """The float64 rung's 256 trades (chip_smoke.american_trades) and the
    barrier set at one, two and four warps per trade: the interface guard
    passes (row sums < 1, block pivots >= 1e-3), with margins measured at
    float64: determinants >= 0.24 and recurrence factors <= 0.33 on the
    American set, >= 0.7 and <= 6e-3 on the barrier set. The shorter the
    chunk, the more the tips couple the system: the American set's largest
    tip row sum is below 0.88, 0.90 and 0.94 at P = 32, 64 and 128."""
    ta = build_american_batch(device="cpu", **chip_smoke.american_trades(chip_smoke.B_AM64)[0])
    assert spike.spike_p(chip_smoke.N_NODES, ta.batch_size) == 64
    set_defs = _spike_schedule_impl(ta, chip_smoke.N_NODES)[1]
    for lo, hi, factor, row_sum in _pivots(ta, chip_smoke.N_NODES, set_defs, True, P=P):
        assert 0.24 <= lo and hi <= 1.0 and factor <= 0.33 and row_sum <= row_sum_max
    tb = build_trade_batch(device="cpu", **chip_smoke.bench_trades(chip_smoke.B_CHECK)[0])
    set_defs = spike.default_segments(tb.n_steps)[1]
    for lo, hi, factor, _ in _pivots(tb, chip_smoke.N_NODES, set_defs, False, P=P):
        assert 0.7 <= lo and hi <= 1.0 and factor <= 6e-3


def test_plain_march_uses_the_compressed_prep():
    """The plain version against a march written with the direct per-row
    vectors, the dense interface solve and the per-row mask (one segment)."""
    n_nodes = 128
    tb, prep = _prep(n_nodes, seed=5)
    t, k0, k1 = 1, 2, 10
    m, P = prep.m, prep.P
    w, af, ab, vsp, wsp = _direct_rows(tb, n_nodes, P, 0.5)
    R = _dense_interface(*spike.interface_tips(prep.fields[t], P))
    mask, _ = _direct_mask(tb, n_nodes, prep)
    got, _ = spike.spike_march_reference(prep, t, prep.v0, prep.edge0, k0, k1)

    # the same march, spelled out with the direct forms
    tr = dict(zip(spike.TRADE_COLS, prep.trade.unbind(1)))
    bl, bc, bu, al, au = (x[:, None] for x in prep.coef[t].unbind(1)[:5])
    v = prep.v0.view(-1, m, P).clone()
    v_lo, v_hi = prep.edge0[:, 0], prep.edge0[:, 1]
    for k in range(k0, k1):
        tau = prep.tau[:, k]
        growth, disc = torch.exp(tr["growth_rate"] * tau), torch.exp(-tr["r"] * tau)
        call = tr["is_call"] != 0
        v_min = torch.where(call, 0.0, tr["strike"] * disc - tr["s_min"] * growth)
        v_max = torch.where(call, tr["s_max"] * growth - tr["strike"] * disc, 0.0)
        full = torch.cat([v_lo[:, None], v.transpose(1, 2).reshape(-1, m * P)[:, : prep.n_int],
                          v_hi[:, None]], dim=1)
        rhs_g = bc * full[:, 1:-1] + bl * full[:, :-2] + bu * full[:, 2:]
        rhs_g[:, 0] -= al[:, 0] * v_min
        rhs_g[:, -1] -= au[:, 0] * v_max
        rhs = torch.zeros(v.shape[0], P * m, dtype=v.dtype)
        rhs[:, : prep.n_int] = rhs_g
        y = spike._chunk_solve(w, af, ab, rhs.view(-1, P, m).transpose(1, 2))
        u = torch.linalg.solve(R, torch.cat([y[:, 0], y[:, m - 1]], dim=1))
        zero = torch.zeros_like(u[:, :1])
        bprev = torch.cat([zero, u[:, P : 2 * P - 1]], dim=1)
        tnext = torch.cat([u[:, 1:P], zero], dim=1)
        x = y - bprev[:, None] * vsp - tnext[:, None] * wsp
        mon = prep.mon[:, k] != 0
        pv = torch.where(tr["rebate_at_hit"] != 0, tr["rebate"],
                         tr["rebate"] * torch.exp(-tr["rebate_rate"] * tau))
        v = torch.where(mon[:, None, None] & mask, pv[:, None, None], x)
        v_lo = torch.where(mon & (tr["omask_lo"] != 0), pv, v_min)
        v_hi = torch.where(mon & (tr["omask_hi"] != 0), pv, v_max)
    want = v.reshape(-1, m * P)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _drift_dominated_kwargs():
    """sigma=1% against a carry of 50% on four coarse steps: |mu|*dx is 65x
    sigma^2, and A is not diagonally dominant."""
    B = 4
    return dict(
        spots=[100.0] * B, strikes=[100.0] * B, sigmas=[0.01] * B, t_expiry=[1.0] * B,
        r=[0.05] * B, b=[0.5] * B, is_call=[True] * B, n_time_steps=4, num_space_nodes=127,
        upper=[130.0] * B, monitor_times=[[0.5, 1.0]] * B,
    )


def test_prep_refuses_a_batch_that_needs_pivoting():
    tb = build_trade_batch(device="cpu", **_drift_dominated_kwargs())
    mu = (tb.b - tb.q) - 0.5 * tb.sigma**2
    assert bool((mu.abs() * tb.dx > tb.sigma**2).all())
    with pytest.raises(ValueError, match="without pivoting is unsafe"):
        spike.prepare_spike(tb, tb.sigma, 128, 32, ((1.0, 0), (0.5, 0)))
    with pytest.raises(ValueError, match="without pivoting is unsafe"):
        spike.cn_barrier_solve_spike(tb, tb.sigma, 128, tb.n_steps)


@pytest.mark.parametrize("tip,refused", [(0.9999, True), (0.999, False)])
def test_interface_guard_holds_the_block_pivot_floor(tip, refused):
    """Two chunks whose tips keep the reduced system dominant by rows
    (row sums tip < 1) but make the one block pivot's determinant
    1 - tip^2: 2.0e-4 is refused, 2.0e-3 passes."""
    p = torch.tensor([[0.0, tip]], dtype=torch.float64)  # t_1's coupling to b_0
    s = torch.tensor([[tip, 0.0]], dtype=torch.float64)  # b_0's coupling to t_1
    q, r = torch.zeros_like(p), torch.zeros_like(p)
    _, det = spike.interface_factors(p, q, r, s)
    assert float(det[0, 0]) == pytest.approx(1.0 - tip * tip)
    refusal = spike.interface_refusal(p, q, r, s, det)
    if refused:
        assert "least block pivot determinant" in refusal
    else:
        assert refusal is None


# solver="auto" on a batch that the guard refuses: a choice of route ---------

# (device, SPIKE-eligible, guard passed, layout admitted, american, float64,
# ad) -> the route; every combination whose answer differs, written out
_AUTO_ROUTES = {
    # off CUDA, the JAX package's CPU rule: spectral wherever the layout admits
    "cpu-f32-spectral": (("cpu", True, True, True, False, False, False), "spectral"),
    "cpu-f64-ad-spectral": (("cpu", False, False, True, False, True, True), "spectral"),
    "cpu-no-layout": (("cpu", True, True, False, False, True, False), "scan"),
    "cpu-american": (("cpu", True, True, True, True, False, False), "scan"),
    "cpu-f32-no-layout": (("cpu", True, True, False, False, False, False), "scan"),
    "cpu-ineligible": (("cpu", False, True, False, False, False, False), "scan"),
    "cpu-refused": (("cpu", True, False, False, False, False, False), "scan"),
    "cpu-ineligible-refused": (("cpu", False, False, False, False, False, False), "scan"),
    # on CUDA, float32: SPIKE, else the scan, never spectral
    "cuda-f32-spike": (("cuda", True, True, True, False, False, False), "spike"),
    "cuda-f32-no-layout-spike": (("cuda", True, True, False, False, False, False), "spike"),
    "cuda-f32-refused": (("cuda", True, False, True, False, False, False), "scan"),
    "cuda-f32-ad": (("cuda", True, True, True, False, False, True), "scan"),
    "cuda-f32-ineligible": (("cuda", False, True, True, False, False, False), "scan"),
    "cuda-f32-no-layout-refused": (("cuda", True, False, False, False, False, False), "scan"),
    "cuda-f32-no-layout-ineligible": (("cuda", False, True, False, False, False, False), "scan"),
    "cuda-f32-none": (("cuda", False, False, False, False, False, False), "scan"),
    # on CUDA, float64: spectral, else SPIKE, else the scan
    "cuda-f64-spectral": (("cuda", True, True, True, False, True, False), "spectral"),
    "cuda-f64-ad-spectral": (("cuda", True, True, True, False, True, True), "spectral"),
    "cuda-f64-refused-spectral": (("cuda", True, False, True, False, True, False), "spectral"),
    "cuda-f64-no-layout-spike": (("cuda", True, True, False, False, True, False), "spike"),
    "cuda-f64-no-layout-refused": (("cuda", True, False, False, False, True, False), "scan"),
    "cuda-f64-no-layout-ad": (("cuda", True, True, False, False, True, True), "scan"),
    "cuda-f64-no-layout-ineligible": (("cuda", False, True, False, False, True, False), "scan"),
    # the American path: SPIKE, else the scan
    "cuda-american-f64-spike": (("cuda", True, True, True, True, True, False), "spike"),
    "cuda-american-f32-spike": (("cuda", True, True, False, True, False, False), "spike"),
    "cuda-american-refused": (("cuda", True, False, False, True, True, False), "scan"),
    "cuda-american-ad": (("cuda", True, True, False, True, False, True), "scan"),
    "cuda-american-ineligible": (("cuda", False, True, False, True, False, False), "scan"),
}


@pytest.mark.parametrize("case", sorted(_AUTO_ROUTES))
def test_auto_route_reads_device_schedule_and_guard(case):
    """Off CUDA the JAX package's CPU rule; on CUDA its accelerator rule:
    float64 spectral where the layout admits, else SPIKE where it is
    eligible, the guard passed and no jvp is asked, else the scan; float32
    SPIKE or the scan; American SPIKE or the scan."""
    (device_type, eligible, guard_passed, spectral_ok, american, float64, ad), want = _AUTO_ROUTES[case]
    sched = ((0, 4, 0),) if eligible else None
    got = port_batch.auto_solver(device_type, sched, guard_passed, spectral_ok=spectral_ok,
                                 american=american, float64=float64, ad=ad)
    assert got == want


def _drift_dominated_batch(american: bool):
    kw = _drift_dominated_kwargs()
    if american:
        kw = {k: v for k, v in kw.items() if k not in ("upper", "monitor_times")}
        return build_american_batch(device="cpu", **kw)
    return build_trade_batch(device="cpu", **kw)


@pytest.mark.parametrize("american", [False, True])
def test_guard_verdict_without_raising(american):
    """Not strict, the prep returns None where the guard refuses every P of
    the rule, and at an explicit P; strict, it raises as before."""
    tb = _drift_dominated_batch(american)
    set_defs = _spike_schedule_impl(tb, 128)[1]
    for P in (None, 32, 16):
        assert spike.prepare_spike(tb, tb.sigma, 128, P, set_defs, american, strict=False) is None
    with pytest.raises(ValueError, match="without pivoting is unsafe"):
        spike.prepare_spike(tb, tb.sigma, 128, None, set_defs, american)


@pytest.mark.parametrize("american", [False, True])
def test_explicit_spike_still_raises_where_the_guard_refuses(american):
    tb = _drift_dominated_batch(american)
    price = port_batch.price_american_batch if american else port_batch.price_barrier_batch
    with pytest.raises(ValueError, match="without pivoting is unsafe"):
        price(tb, 128, solver="spike", device="cpu")


def _auto_as_on_a_card(monkeypatch, refuse: bool = False):
    """The driver's auto route with the CPU read as CUDA (the march then
    runs its plain version), and a count of the SPIKE preps it makes;
    ``refuse`` makes the interface guard refuse every prep."""
    real = port_batch.auto_solver
    monkeypatch.setattr(port_batch, "auto_solver",
                        lambda dev, sched, passed, **kw: real("cuda", sched, passed, **kw))
    preps = []

    def counted(*a, _fn, **k):
        preps.append(a[3])
        return None if refuse else _fn(*a, **k)

    for module in (port_batch, spike):
        monkeypatch.setattr(module, "prepare_spike",
                            lambda *a, _fn=module.prepare_spike, **k: counted(*a, _fn=_fn, **k))
    return preps


@pytest.mark.parametrize("american", [False, True])
def test_auto_route_prices_a_refused_batch_on_the_scan(monkeypatch, american):
    """With greeks both sigmas take the scan once the first prep is refused."""
    tb = _drift_dominated_batch(american)
    sched = _spike_schedule_impl(tb, 128)
    kw = dict(american=True, with_dividends=False) if american else {}
    preps = _auto_as_on_a_card(monkeypatch)
    got = port_batch._run_batch_driver(tb, 128, None, True, 1024, "bump", "auto", sched, **kw)
    assert len(preps) == 1
    price = port_batch.price_american_batch if american else port_batch.price_barrier_batch
    ref = price(tb, 128, solver="scan", device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0.0, atol=0.0)


@pytest.mark.parametrize("american", [False, True])
def test_auto_route_preps_each_sigma_once_where_the_guard_passes(monkeypatch, american):
    """A guard-passing batch: one prep per sigma (the price and the vega
    bump), marched as made, and the explicit spike route's outputs."""
    if american:
        barrier_keys = ("monitor_times", "lower", "upper", "rebate", "rebate_at_hit")
        kw = {k: v for k, v in _kwargs(B=4).items() if k not in barrier_keys}
        tb = build_american_batch(device="cpu", **kw)
    else:
        tb = build_trade_batch(device="cpu", **_kwargs(B=4))
    sched = _spike_schedule_impl(tb, 128)
    price = port_batch.price_american_batch if american else port_batch.price_barrier_batch
    ref = price(tb, 128, solver="spike", device="cpu")
    kw = dict(american=True, with_dividends=False) if american else {}
    preps = _auto_as_on_a_card(monkeypatch)
    got = port_batch._run_batch_driver(tb, 128, None, True, 1024, "bump", "auto", sched, **kw)
    assert preps == [None, None]  # at the rule's P, one per sigma
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0.0, atol=0.0)


def _layout_batch(dtype):
    """A SPIKE-eligible batch whose spectral layout is admitted at ``dtype``,
    with the layout attached (as ``_route`` attaches it)."""
    tb = build_trade_batch(device="cpu", dtype=dtype, **_kwargs(B=4))
    layout = port_batch._spectral_layout(tb, 128)
    assert layout is not None and _spike_schedule_impl(tb, 128) is not None
    return replace(tb, **dict(zip(port_batch.SP_FIELDS, layout)))


@pytest.mark.parametrize("dtype,route", [(torch.float32, "scan"), (torch.float64, "spectral")])
def test_auto_route_after_a_guard_refusal_keeps_float32_off_spectral(monkeypatch, dtype, route):
    """The guard refuses (forced here: a batch it refuses for real is drift
    dominated, |mu|*dx > sigma^2, and then the layout refuses it too) a
    batch whose spectral layout is admitted: on a card a float32 call then
    takes the scan, never the float32 spectral propagator, which misses the
    f32 limits; a float64 call the spectral propagator (the JAX package's
    accelerator rule: f32 SPIKE or the scan, f64 spectral)."""
    tb = _layout_batch(dtype)
    sched = _spike_schedule_impl(tb, 128)
    preps = _auto_as_on_a_card(monkeypatch, refuse=True)
    got = port_batch._run_batch_driver(tb, 128, None, True, 1024, "bump", "auto", sched)
    assert len(preps) == 1
    monkeypatch.undo()
    ref = port_batch.price_barrier_batch(tb, 128, solver=route, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0.0, atol=0.0)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "scan"), (torch.float64, "spectral")])
def test_auto_route_of_an_ad_call_on_a_card(monkeypatch, dtype, route):
    """greeks_mode="ad" under auto on a card, on a batch that SPIKE and the
    spectral layout both admit: float32 takes the scan (SPIKE has no AD
    rule, and float32 never takes spectral), float64 the spectral route."""
    tb = build_trade_batch(device="cpu", dtype=dtype, **_kwargs(B=4))
    preps = _auto_as_on_a_card(monkeypatch)
    got = port_batch.price_barrier_batch(tb, 128, greeks_mode="ad", device="cpu")
    assert preps == []
    monkeypatch.undo()
    ref = port_batch.price_barrier_batch(tb, 128, greeks_mode="ad", solver=route, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0.0, atol=0.0)
