"""Knock-in parity of the port's barrier service, on the CPU.

A knock-in trade is served as vanilla − knock-out + R·DF, its greeks from
bumped vanilla prices. The service gathers the knock-in rows' float64
fields from ``build_batch``'s own pass over the trade dicts, and applies
parity on the device to the stack of the request's outputs before the one
host copy (``serving/service.py`` ``_apply_ki_parity``; on a card one
launch of ``csrc/ki_parity.cu``, here ``ki_parity_reference``). Each
request below is held to an oracle kept here, the earlier per-bump
formula: six ``generalized_bs_price`` calls on the trades' fields and host
arithmetic over the knock-out legs, which the test prices through the same
batch and driver. Price within 1e-12 relative, greeks within 1e-9 relative
or 1e-12 absolute; the rows of other trades are left as the driver priced
them, bit for bit.
"""
import numpy as np
import pytest
import torch

from finite_difference_tpu_torch import kernels
from finite_difference_tpu_torch.models.analytic import generalized_bs_price
from finite_difference_tpu_torch.models.pde.batch import price_barrier_batch
from finite_difference_tpu_torch.serving import BarrierPricingService
from finite_difference_tpu_torch.serving import service as service_module

GRID = dict(n_time_steps=32, num_space_nodes=63)
KEYS = ("price", "delta", "gamma", "vega", "theta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the small grids' step loops run in Python (tests/test_torch_parallel.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _service(**kw):
    return BarrierPricingService(min_bucket=4, max_bucket=64, device="cpu", **{**GRID, **kw})


def _trade(rng, kind, is_call, rebate):
    t = float(rng.uniform(0.05, 0.4))
    m = int(rng.integers(2, 6))
    return dict(
        spot=float(rng.uniform(90.0, 110.0)), strike=float(rng.uniform(95.0, 105.0)),
        sigma=float(rng.uniform(0.15, 0.4)), t_expiry=t, r=0.05, b=float(rng.uniform(0.0, 0.04)),
        q=float(rng.uniform(0.0, 0.03)), is_call=is_call, barrier_type=kind, upper=125.0,
        lower=80.0, rebate=rebate, monitor_times=[t * (k + 1) / m for k in range(m)],
    )


def _mixed(seed=0):
    """Up-, down- and double-in, with and without rebates, calls and puts,
    b != r and q != 0, between knock-outs and vanillas; knock-ins first and
    last."""
    rng = np.random.default_rng(seed)
    plan = [
        ("up-and-in", True, 1.5), ("up-and-out", True, 0.0), ("down-and-in", False, 0.0),
        ("none", False, 0.0), ("double-in", True, 2.0), ("double-out", False, 1.0),
        ("down-and-in", True, 0.5), ("double-in", False, 0.0), ("up-and-in", False, 0.0),
    ]
    return [_trade(rng, *p) for p in plan]


def _build(svc, trades):
    bucket = service_module._next_bucket(len(trades), svc.min_bucket, svc.max_bucket)
    return svc.build_batch(trades, bucket)


def _knock_out_legs(svc, trades):
    """The request's outputs as the driver prices them, before parity."""
    out = price_barrier_batch(
        _build(svc, trades), n_nodes=svc.num_space_nodes + 1,
        with_greeks=svc.with_greeks, max_chunk=svc.max_chunk, greeks_mode=svc.greeks_mode,
        solver=svc.solver, device=svc.device, mesh=svc.mesh)
    return service_module._columns(out, len(trades))


def _oracle(trades, cols):
    """The earlier parity: six generalized_bs_price calls, one per bump."""
    in_idx = np.array([i for i, t in enumerate(trades) if "in" in t["barrier_type"]])
    cols = {k: v.copy() for k, v in cols.items()}
    col = lambda f: np.array([f(trades[i]) for i in in_idx], np.float64)
    s, k, sig = col(lambda t: t["spot"]), col(lambda t: t["strike"]), col(lambda t: t["sigma"])
    te, r = col(lambda t: t["t_expiry"]), col(lambda t: t["r"])
    b = col(lambda t: t.get("b", t["r"])) - col(lambda t: t.get("q", 0.0))
    is_call = np.array([bool(trades[i].get("is_call", True)) for i in in_idx])
    rebate = col(lambda t: t.get("rebate", 0.0))
    df = np.exp(-r * te)

    def v(s_=s, sig_=sig, te_=te):
        args = [torch.as_tensor(a) for a in (s_, k, sig_, te_, r, b, is_call)]
        return generalized_bs_price(*args).numpy()

    van = v()
    cols["price"][in_idx] = van - cols["price"][in_idx] + rebate * df
    if "delta" in cols:
        ds = s * 1e-4
        v_up, v_dn = v(s_=s + ds), v(s_=s - ds)
        cols["delta"][in_idx] = (v_up - v_dn) / (2 * ds) - cols["delta"][in_idx]
        cols["gamma"][in_idx] = (v_up - 2 * van + v_dn) / ds**2 - cols["gamma"][in_idx]
    if "vega" in cols:
        cols["vega"][in_idx] = (v(sig_=sig + 1e-4) - van) / (100.0 * 1e-4) - cols["vega"][in_idx]
    if "theta" in cols:
        dte = np.minimum(1e-5, 0.5 * te)
        v_theta = -(v(te_=te + dte) - v(te_=te - dte)) / (2 * dte)
        cols["theta"][in_idx] = v_theta - cols["theta"][in_idx] + r * rebate * df
    return cols, in_idx


def _check(got, want_cols, in_idx, keys):
    assert [sorted(row) for row in got] == [sorted(keys)] * len(got)
    for key in keys:
        g = np.array([row[key] for row in got])
        w = want_cols[key]
        rel, atol = (1e-12, 0.0) if key == "price" else (1e-9, 1e-12)
        np.testing.assert_allclose(g[in_idx], w[in_idx], rtol=rel, atol=atol, err_msg=key)
        rest = np.setdiff1d(np.arange(len(got)), in_idx)
        assert np.array_equal(g[rest], w[rest]), key


@pytest.mark.parametrize("layout", ["mixed", "one_knock_in"])
def test_mixed_request_matches_the_per_bump_oracle(layout):
    trades = _mixed()
    if layout == "one_knock_in":  # the last trade alone knocks in
        trades = [t for t in trades if "in" not in t["barrier_type"]] + trades[-1:]
    svc = _service()
    want, in_idx = _oracle(trades, _knock_out_legs(svc, trades))
    assert in_idx[-1] == len(trades) - 1 and (layout != "mixed" or in_idx[0] == 0)
    kernels.reset_launch_counts()
    got = svc.price(trades)
    _check(got, want, in_idx, KEYS)
    assert not any(kernels.launch_counts.values())  # CPU: the plain version


def test_request_without_a_knock_in_runs_no_parity(monkeypatch):
    trades = [t for t in _mixed(1) if "in" not in t["barrier_type"]]
    svc = _service()
    want = _knock_out_legs(svc, trades)
    assert svc._knock_ins_of(_build(svc, trades)) is None

    def refuse(*a, **kw):
        raise AssertionError("parity ran on a request without a knock-in")

    monkeypatch.setattr(svc, "_apply_ki_parity", refuse)
    got = svc.price(trades)
    _check(got, want, np.array([], int), KEYS)


def test_price_only_service():
    trades = _mixed(2)
    svc = _service(with_greeks=False)
    want, in_idx = _oracle(trades, _knock_out_legs(svc, trades))
    _check(svc.price(trades), want, in_idx, ("price",))


def test_float32_service_prices_the_vanilla_leg_from_float64_fields():
    """A float32 solve (``greeks_dtype=float32``): the knock-out legs at
    float32, the vanilla leg from the trades' own float64 values."""
    trades = _mixed(3)
    svc = _service(dtype=np.float32, greeks_dtype=np.float32)
    assert svc.dtype == torch.float32
    cols = _knock_out_legs(svc, trades)
    fields = svc._knock_ins_of(_build(svc, trades)).fields
    in_idx = [i for i, t in enumerate(trades) if "in" in t["barrier_type"]]
    assert fields.dtype == torch.float64
    assert fields[0].tolist() == [trades[i]["spot"] for i in in_idx]
    assert fields[0].tolist() != fields[0].to(torch.float32).double().tolist()
    want, in_idx = _oracle(trades, cols)
    _check(svc.price(trades), want, in_idx, KEYS)


def test_request_over_a_mesh_of_four_cpus():
    trades = _mixed(4)
    one = _service(solver="scan")
    meshed = _service(solver="scan", mesh=["cpu"] * 4)
    want, in_idx = _oracle(trades, _knock_out_legs(one, trades))
    got = meshed.price(trades)
    _check(got, want, in_idx, KEYS)
    assert got == one.price(trades)


def test_another_threads_build_cannot_reach_a_request(monkeypatch):
    """A ``build_batch`` on another thread, between a request's build and
    its parity, leaves the request's knock-ins as they were; a batch that
    is not the thread's last build is refused."""
    import threading

    trades, other = _mixed(8), _mixed(9)[::-1]
    svc = _service()
    want, in_idx = _oracle(trades, _knock_out_legs(svc, trades))
    driver = service_module.price_barrier_batch

    def interleaved(*a, **kw):
        worker = threading.Thread(target=_build, args=(svc, other))
        worker.start()
        worker.join()
        return driver(*a, **kw)

    monkeypatch.setattr(service_module, "price_barrier_batch", interleaved)
    _check(svc.price(trades), want, in_idx, KEYS)
    stale = _build(svc, trades)
    _build(svc, other)
    with pytest.raises(RuntimeError, match="last build_batch"):
        svc._knock_ins_of(stale)


class _CountingDict(dict):
    """A trade dict that counts its key reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reads = 0

    def __getitem__(self, key):
        self.reads += 1
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.reads += 1
        return super().get(key, default)


def test_each_trade_dict_is_read_in_one_pass():
    """A request reads each trade dict no more than its build does."""
    trades = [_CountingDict(t) for t in _mixed(5)]
    svc = _service()
    bucket = service_module._next_bucket(len(trades), svc.min_bucket, svc.max_bucket)
    svc.build_batch(trades, bucket)
    build_reads = [t.reads for t in trades]
    assert min(build_reads) > 0
    for t in trades:
        t.reads = 0
    svc.price(trades)
    assert [t.reads for t in trades] == build_reads


@pytest.mark.parametrize("keys", [KEYS, ("price",), ("price", "delta", "gamma"),
                                  ("vega", "price"), ("theta", "price")])
def test_reference_over_any_set_of_outputs(keys):
    """``ki_parity_reference`` on a stack of any present outputs, in any
    order of rows, against the oracle on the same knock-out legs; the
    columns of other rows untouched."""
    trades = _mixed(6)
    rng = np.random.default_rng(7)
    ko = {k: rng.normal(size=len(trades)) for k in keys}
    want, in_idx = _oracle(trades, ko)
    is_in = ["in" in t["barrier_type"] for t in trades]
    fields = {key: [float(t.get(name, default)) for t in trades]
              for key, name, default in (("spots", "spot", None), ("strikes", "strike", None),
                                         ("sigmas", "sigma", None), ("t_expiry", "t_expiry", None),
                                         ("r", "r", None), ("b", "b", None), ("q", "q", 0.0),
                                         ("rebate", "rebate", 0.0))}
    fields["is_call"] = [t["is_call"] for t in trades]
    knock_ins = service_module._knock_ins(fields, is_in, "cpu")
    assert knock_ins.rows.tolist() == in_idx.tolist()
    stack = torch.tensor(np.stack([ko[k] for k in keys]))
    service_module.ki_parity_reference(stack, list(keys), *knock_ins)
    got = [dict(zip(keys, col)) for col in stack.numpy().T.tolist()]
    _check(got, want, in_idx, keys)


@pytest.mark.parametrize("cell, size, knock_ins", [
    (0, 4096, 960), (1, 16384, 3840),
])
def test_chip_smoke_reads_the_barrier_cells_own_requests(cell, size, knock_ins):
    """chip_smoke.py holds K5 on the barrier cells' first requests, made
    by the benchmark's generator from the cells' own files."""
    import chip_smoke

    service, trades = chip_smoke.ki_parity_request(*chip_smoke.KI_CELLS[cell])
    assert len(trades) == size and service["max_bucket"] >= size
    assert service["dtype"] == np.float64 and service["with_greeks"]
    assert sum("in" in t["barrier_type"] for t in trades) == knock_ins
    bound = chip_smoke.ki_parity_bound(knock_ins, 5, 6)
    assert bound["flops"] == knock_ins * (6 * 197 + 20)
    assert bound["bytes"] == knock_ins * 19 * 8
    assert bound["bound_by"] == "bytes"


def test_chip_smoke_watches_the_main_paths_parity():
    """``chip_smoke.ki_parity_check`` keeps the stack the request hands to
    parity before and after, redoes parity on a copy with the plain
    version, and leaves the service as it was; its rows are the request's."""
    import chip_smoke

    _, trades = chip_smoke.ki_parity_request(*chip_smoke.KI_CELLS[0])
    trades = trades[:24]
    svc = _service()
    got = chip_smoke.ki_parity_check(svc, trades)
    assert "_apply_ki_parity" not in vars(svc)
    in_idx = [i for i, t in enumerate(trades) if "in" in t["barrier_type"]]
    assert got["knock_ins"].rows.tolist() == in_idx and in_idx
    assert all(got["same"].values()) and not any(got["gap"].values())
    assert got["keys"] == list(KEYS) and torch.equal(got["after"], got["plain"])
    assert not torch.equal(got["after"], got["before"])
    assert got["rows"] == svc.price(trades)
    assert np.array_equal(np.array([[r[k] for k in KEYS] for r in got["rows"]]).T,
                          got["after"].numpy())
