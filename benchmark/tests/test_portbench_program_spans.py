"""The program's spans, read by the per-layer metrics of ``program_spans``:
a traced run of each cell at the tiny size reports every metric its cell
lists, the four build shares add up to the build's share, and an untraced
run or a program without the recorder reads nothing."""
import json
import sys

import pytest

import portbench_tiny

BUILD_PARTS = ("service.trade_fields_share.sweep", "batch.build_grids_share.sweep",
               "batch.build_arrays_share.sweep", "batch.upload_share.sweep")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["fa_barrier_f64.sweep", "fa_american_div_f64.sweep"])
def test_a_traced_run_reports_the_program_span_metrics(root, cell):
    spec = portbench_tiny.spec(root)
    out = portbench_tiny.run(root, cell, seconds=1.0, traced=True)
    assert out["correct"] and out["failed"] == 0
    listed = {m["name"] for m in spec.metrics(cell, traced=True)}
    # the device's metrics need a card; every other listed metric is there
    assert listed - set(out["metrics"]) <= {"pde_roofline", "device.idle_share.sweep"}
    new = {m["name"] for m in json.loads((root / "BENCHMARK.json").read_text())["per_layer"]
           if m["source"] in ("program_span", "program_counter") and cell in m["workloads"]}
    assert len(new) == (11 if cell.startswith("fa_barrier") else 10)
    assert new <= set(out["metrics"])
    value = lambda name: out["metrics"][name]["value"]
    parts = sum(value(n) for n in BUILD_PARTS)
    assert 0.0 < parts <= value("service.build_share.sweep") + 1e-9
    assert value("service.build_share.sweep") - parts < 3.0
    assert value("batch.upload_mb_per_request.sweep") > 0.0
    # the CPU's auto rule takes no SPIKE prep
    assert value("batch.spike_prep_share.sweep") == 0.0
    for name in new:
        if name.endswith("_share.sweep"):
            assert 0.0 <= value(name) <= 100.0


def test_an_untraced_run_or_a_program_without_spans_reads_nothing(root, monkeypatch):
    import finite_difference_tpu_torch
    from benchmark import program_spans

    out = portbench_tiny.run(root, "fa_american_div_f64.sweep", seconds=0.3)
    assert set(out["metrics"]) == {"trades_per_s", "setup_s"}

    class Later:  # a window after every record kept so far
        t0, t_end, window_s = 1e12, 1e12 + 1.0, 1.0

    readers = (lambda c: program_spans.share(c, "batch.upload"), program_spans.upload_mb_per_request,
               program_spans.guard_refused_share)
    assert [read(Later) for read in readers] == [None] * 3
    # the parent commit's program has no recorder: the import fails
    monkeypatch.delattr(finite_difference_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "finite_difference_tpu_torch.tracing", None)

    class All:
        t0, t_end, window_s = 0.0, 1e12, 1e12

    assert [read(All) for read in readers] == [None] * 3
