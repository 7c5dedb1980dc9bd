"""`correct` on the CPU at a tiny size: the plain reference agrees with the
port; the lower-precision control, and each fault the cells can have planted
under the timed path, come out not correct."""
import numpy as np
import pytest
import torch

import portbench_tiny
from benchmark import check, drive, reference

CELLS = ("fa_barrier_f64.sweep", "fa_american_div_f64.sweep")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.make(tmp_path_factory.mktemp("tiny"))


def test_reference_agrees_with_the_port(root):
    from finite_difference_tpu_torch.serving import AmericanPricingService, BarrierPricingService

    from benchmark.traffic import ClosedLoop

    s = portbench_tiny.spec(root)
    for cell, cls in (("fa_barrier_f64.sweep", BarrierPricingService),
                      ("fa_american_div_f64.sweep", AmericanPricingService)):
        cfg = s.config(s.cell(cell)["config"])
        svc_kw = {k: v for k, v in cfg["service"].items() if k not in ("kind", "dtype")}
        trades = ClosedLoop(cfg["trades"], s.traffic(s.cell(cell)["traffic"]), 3).request(0)
        got = cls(device="cpu", **svc_kw).price(trades)
        kw = dict(richardson=True) if "american" in cell else {}
        want = reference.ROWS[cfg["service"]["kind"]](
            trades, cfg["service"]["n_time_steps"], cfg["service"]["num_space_nodes"], "cpu", **kw)
        gaps = check.gaps(got, want)
        assert gaps["price"] < 1e-11 and max(gaps.values()) < 1e-7, gaps


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = portbench_tiny.run(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    out = portbench_tiny.run(root, cell, control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items() if k != "requests_in_error")


def _unmarched(batch, n_nodes, solver, american, sigmas, *a, **kw):
    """A march that returns its state unchanged: the payoff at every sigma."""
    i = torch.arange(n_nodes, dtype=batch.x_min.dtype)
    s = torch.exp(batch.x_min[:, None] + i * batch.dx[:, None])
    k = batch.strike[:, None]
    v = torch.where(batch.is_call[:, None], (s - k).clamp(min=0.0), (k - s).clamp(min=0.0))
    return [v.clone() for _ in sigmas]


def _half_left_out(driver):
    def run(batch, *a, **kw):
        out = driver(batch, *a, **kw)
        half = batch.batch_size // 2
        return {k: torch.cat([v[:half], v[:half].mean().expand(v.shape[0] - half)]) for k, v in out.items()}
    return run


def _altered(driver):
    def run(batch, *a, **kw):
        out = dict(driver(batch, *a, **kw))
        price = out["price"].clone()
        price[::8] *= 1.0 + 1e-4
        out["price"] = price
        return out
    return run


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out", "answer_altered"])
def test_fault_under_the_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    from finite_difference_tpu_torch.models.pde import batch as batch_module
    from finite_difference_tpu_torch.serving import service as service_module

    if fault == "state_unchanged":
        monkeypatch.setattr(batch_module, "_solve_values", _unmarched)
    else:
        wrap = _half_left_out if fault == "half_batch_left_out" else _altered
        for name in ("price_barrier_batch", "price_american_batch"):
            monkeypatch.setattr(service_module, name, wrap(getattr(service_module, name)))
    out = portbench_tiny.run(root, cell, seconds=0.3)
    assert not out["correct"], out["checks"]


def test_check_counts_requests_in_error():
    records = [drive.Record(trades=[], due=0.0), drive.Record(trades=[], due=0.0, error="ValueError()")]
    cfg = {"service": {"kind": "barrier"}, "check": {"rows": 4, "limits": {}}}
    ok, checks = check.judge(cfg, records, check.Sample(4, 1), "cpu")
    assert not ok and checks["requests_in_error"]["value"] == 1
    assert check.gaps([{"price": np.nan}], [{"price": 1.0}])["price"] == float("inf")


def test_sample_is_uniform_over_rows_and_set_by_the_seed():
    requests = [list(range(n)) for n in (3, 200, 1, 50)]  # 254 rows
    offsets = np.cumsum([0] + [len(r) for r in requests])

    def draw(seed):
        s = check.Sample(16, seed)
        for off, req in zip(offsets, requests):
            s.offer([off + i for i in req], [{"row": off + i} for i in req])
        return [t for t, _ in s.items]

    assert draw(5) == draw(5) and draw(5) != draw(6)
    counts = np.zeros(offsets[-1])
    for seed in range(400):
        picked = draw(seed)
        assert len(set(picked)) == 16
        counts[picked] += 1
    # each row is kept with probability 16/254: 25.2 times in 400 draws
    assert abs(counts.mean() - 400 * 16 / 254) < 1e-9
    assert counts.min() > 8 and counts.max() < 48
