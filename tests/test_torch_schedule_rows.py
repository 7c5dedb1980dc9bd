"""The batch builders' distinct schedules: each distinct schedule is built
once and the device expands its row to the trades that share it.

Every field of a built batch is held bit for bit (its bytes, so 0.0 and
-0.0 differ) against the JAX package's same builder and route at float64
and float32, for shared and unshared schedules; keys that differ in one ulp
or in ``is_call`` stay apart; the ``batch.build_grids`` span counts the
rows and the schedules, ``batch.upload`` the bytes that crossed, and a
batch in which no two trades share a schedule takes no gather.
"""
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from finite_difference_tpu import native as jax_native
from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu_torch import native as port_native
from finite_difference_tpu_torch import tracing
from finite_difference_tpu_torch.models.pde import batch as port_batch

DTYPES = ["float64", "float32"]
# each trade's key, unsorted and interleaved: B = 12, U = 3
LAYOUTS = {
    "interleaved": [2, 0, 1, 0, 2, 2, 1, 0, 1, 2, 0, 1],
    "one": [0] * 5,
    "distinct": list(range(6)),
}


def _same_bits(have: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert have.is_contiguous()
    assert have.numpy().dtype == want.dtype and have.shape == want.shape
    assert have.numpy().tobytes() == want.tobytes()


def _profiled(fn):
    """``fn()`` under the profiler: its result, the span records and the
    profiler's operator names."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = list(tracing.records)
    tracing.clear()
    return out, recs, {e.key for e in prof.key_averages()}


def _build(builder, **kw):
    """A port batch under the profiler, with its build_grids and upload
    records and whether it gathered."""
    tb, recs, ops = _profiled(lambda: builder(device="cpu", **kw))
    (grids,) = [r for r in recs if r.name == "batch.build_grids"]
    (upload,) = [r for r in recs if r.name == "batch.upload"]
    return tb, grids, upload, "aten::index_select" in ops


def _check_against_jax(jax_builder, port_builder, dtype, **kw):
    ref = jax_builder(dtype=getattr(np, dtype), **kw)
    got, grids, upload, gathered = _build(port_builder, dtype=getattr(torch, dtype), **kw)
    for name in port_batch.FIELD_NAMES:
        _same_bits(getattr(got, name), getattr(ref, name))
    return got, grids, upload, gathered


def _barrier_kwargs(expiries, monitors, route="native"):
    """Trades of their own spot, strike and vol; trade i has expiry
    ``expiries[i]`` and monitors ``monitors[i]``."""
    B = len(expiries)
    rng = np.random.default_rng(B)
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)), strikes=list(rng.uniform(90.0, 110.0, B)),
        sigmas=list(rng.uniform(0.15, 0.45, B)), t_expiry=list(expiries),
        r=list(rng.uniform(0.0, 0.1, B)), b=list(rng.uniform(-0.02, 0.1, B)),
        is_call=list(rng.integers(0, 2, B) == 1), n_time_steps=24, monitor_times=monitors,
        lower=[None if i % 3 else 70.0 for i in range(B)],
        upper=[130.0 if i % 2 == 0 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 2.0, B)), num_space_nodes=63,
        monitor_aligned=route == "monitor_aligned", use_native=route == "native",
    )


def _barrier_layout(keys, route="native"):
    # monitors proportional to the expiry: a monitor-aligned batch keeps one
    # interval structure
    te = [0.25 * (k + 1) for k in keys]
    return _barrier_kwargs(te, [[t * (j + 1) / 4 for j in range(4)] for t in te], route)


def _american_kwargs(expiries, calls, dividends, route="native"):
    B = len(expiries)
    rng = np.random.default_rng(B + 1)
    return dict(
        spots=list(rng.uniform(80.0, 120.0, B)), strikes=list(rng.uniform(80.0, 120.0, B)),
        sigmas=list(rng.uniform(0.15, 0.4, B)), t_expiry=list(expiries),
        r=list(rng.uniform(0.01, 0.1, B)), b=list(rng.uniform(0.0, 0.1, B)), is_call=list(calls),
        n_time_steps=48, dividends_tau=dividends, num_space_nodes=101,
        use_native=route != "loop",
    )


# the American keys of the layouts: expiry, is_call, dividends
AMERICAN_KEYS = [
    (0.5, False, [(0.25, 1.2)]),
    (1.0, False, [(0.25, 1.2), (0.75, 1.2)]),
    (0.5, True, [(0.25, 1.2)]),  # key 0 but a call: Rannacher restarts at the dividend
]


def _american_layout(keys, route):
    if route == "vectorised":
        return _american_kwargs([0.3 + 0.1 * k for k in keys], [k % 2 == 1 for k in keys], None, route)
    if len(set(keys)) > len(AMERICAN_KEYS):  # distinct: an expiry each
        ks = [(0.3 + 0.1 * k, bool(k % 2), [(0.2, 1.0 + k)]) for k in keys]
    else:
        ks = [AMERICAN_KEYS[k] for k in keys]
    te, calls, divs = zip(*ks)
    return _american_kwargs(te, calls, [list(d) for d in divs], route)


class TestBarrier:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("route", ["native", "numpy", "monitor_aligned"])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_bit_identical_to_jax(self, layout, route, dtype):
        if route == "native":
            assert port_native.available() and jax_native.available()
        keys = LAYOUTS[layout]
        _, grids, _, gathered = _check_against_jax(
            jax_batch.build_trade_batch, port_batch.build_trade_batch, dtype,
            **_barrier_layout(keys, route))
        U = len(set(keys))
        assert grids.attrs["rows"] == len(keys) and grids.attrs["schedules"] == U
        assert gathered == (U < len(keys))

    @pytest.mark.parametrize("route", ["native", "numpy"])
    def test_keys_one_ulp_apart_stay_apart(self, route):
        te = 0.7
        mons = [0.1, 0.3, 0.5, te]
        nudged = list(mons)
        nudged[1] = np.nextafter(0.3, 1.0)
        cases = [
            ([te, np.nextafter(te, 1.0), te, te], [mons] * 4, 2),
            ([te] * 4, [mons, nudged, mons, nudged], 2),
        ]
        for expiries, monitors, U in cases:
            for dtype in DTYPES:
                _, grids, _, _ = _check_against_jax(
                    jax_batch.build_trade_batch, port_batch.build_trade_batch, dtype,
                    **_barrier_kwargs(expiries, monitors, route))
                assert grids.attrs["schedules"] == U

    def test_equal_monitor_lists_held_as_different_objects_share(self):
        mons = [0.1, 0.2, 0.3, 0.4]
        shared = _barrier_kwargs([0.4] * 6, [mons] * 6)
        copies = _barrier_kwargs([0.4] * 6, [list(mons) for _ in range(6)])
        copies["monitor_times"][3] = tuple(mons)
        a, ga, _, _ = _build(port_batch.build_trade_batch, **shared)
        b, gb, _, _ = _build(port_batch.build_trade_batch, **copies)
        assert ga.attrs["schedules"] == gb.attrs["schedules"] == 1
        for name in port_batch.FIELD_NAMES:
            _same_bits(getattr(b, name), getattr(a, name).numpy())


class TestAmerican:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("route", ["vectorised", "native", "loop"])
    @pytest.mark.parametrize("snap", [False, True])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_bit_identical_to_jax(self, layout, route, snap, dtype):
        if route == "native":
            assert port_native.available() and jax_native.available()
        keys = LAYOUTS[layout]
        _, grids, _, gathered = _check_against_jax(
            jax_batch.build_american_batch, port_batch.build_american_batch, dtype,
            snap_to_grid=snap, **_american_layout(keys, route))
        U = len(set(keys))
        assert grids.attrs["rows"] == len(keys) and grids.attrs["schedules"] == U
        assert gathered == (U < len(keys))

    @pytest.mark.parametrize("route", ["native", "loop"])
    def test_keys_one_ulp_or_is_call_apart_stay_apart(self, route):
        d = [(0.25, 1.2)]
        cases = [
            ([0.5, np.nextafter(0.5, 1.0), 0.5], [False] * 3, [d] * 3, 2),
            ([0.5] * 4, [False, True, True, False], [d] * 4, 2),
            ([0.5] * 3, [False] * 3, [d, [(np.nextafter(0.25, 0.0), 1.2)], d], 2),
            # amounts 0.0 and -0.0: equal values, rows of their own
            ([0.5] * 4, [False] * 4, [[(0.25, 0.0)], [(0.25, -0.0)], [(0.25, 0.0)], d], 3),
        ]
        for expiries, calls, divs, U in cases:
            for dtype in DTYPES:
                _, grids, _, _ = _check_against_jax(
                    jax_batch.build_american_batch, port_batch.build_american_batch, dtype,
                    **_american_kwargs(expiries, calls, divs, route))
                assert grids.attrs["schedules"] == U

    @pytest.mark.parametrize("use_native", [True, False])
    def test_too_many_dividends_raises(self, use_native):
        bad = [(0.01 * (k + 1), 1.0) for k in range(8)]
        kw = dict(
            spots=[100.0, 101.0, 102.0], strikes=[100.0] * 3, sigmas=[0.3] * 3,
            t_expiry=[1.0] * 3, r=[0.05] * 3, b=[0.05] * 3, is_call=[False] * 3, n_time_steps=4,
            dividends_tau=[[(0.5, 1.0)], list(bad), list(bad)],
        )
        match = r"exceeded n_time_steps \(trade 1\)" if use_native else "exceeded n_time_steps"
        with pytest.raises(ValueError, match=match):
            port_batch.build_american_batch(use_native=use_native, device="cpu", **kw)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind,route", [("barrier", "native"), ("barrier", "numpy"),
                                        ("american", "vectorised"), ("american", "native"),
                                        ("american", "loop")])
def test_upload_counts_the_bytes_that_crossed(layout, kind, route):
    keys = LAYOUTS[layout]
    if kind == "barrier":
        tb, _, upload, _ = _build(port_batch.build_trade_batch, **_barrier_layout(keys, route))
    else:
        tb, _, upload, _ = _build(port_batch.build_american_batch, **_american_layout(keys, route))
    B, U = len(keys), len(set(keys))
    per_trade = sum(getattr(tb, k).nbytes for k in port_batch.FIELD_NAMES
                    if k not in port_batch.SCHEDULE_FIELDS)
    schedules = sum(getattr(tb, k).nbytes for k in port_batch.SCHEDULE_FIELDS) // B * U
    index = 8 * B if U < B else 0
    assert upload.attrs["bytes"] == per_trade + schedules + index


def test_native_halves_refuse_inputs_of_other_lengths():
    assert port_native.available()
    with pytest.raises(ValueError, match="one value per trade"):
        port_native.american_grids([100.0, 90.0], [100.0], [0.3, 0.3], [1.0, 1.0], 64, 4.5, False)
    with pytest.raises(ValueError, match="one entry per trade"):
        port_native.american_schedules([1.0, 1.0], [False, False], [[(0.5, 1.0)]], 16, 2)
