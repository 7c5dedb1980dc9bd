"""``batch.schedule_rows_share.sweep``: the schedule rows the program's
builders made over the trade rows they built, read from the records of the
window's ``batch.build_grids`` spans. Hand-made records give a known share;
a window without a request, or builds that do not count their schedules,
read nothing; a traced run of the tiny American cell reads one schedule a
build."""
import sys
from collections import deque

import pytest

import portbench_tiny
from benchmark.spec import HERE, Spec

READ = Spec(HERE.parent, HERE).reader("batch.schedule_rows_share.sweep")


class Window:
    t0, t_end, window_s = 1.0, 2.0, 1.0


def _record(name, start_s, end_s, **attrs):
    from finite_difference_tpu_torch import tracing

    rec = tracing.Record(name, attrs)
    rec.start_ns, rec.end_ns = int(start_s * 1e9), int(end_s * 1e9)
    return rec


@pytest.fixture
def records(monkeypatch):
    from finite_difference_tpu_torch import tracing

    kept = deque()
    monkeypatch.setattr(tracing, "records", kept)
    return kept


def test_the_share_is_the_schedules_over_the_rows_of_the_window(records):
    records.extend([
        _record("service.price", 1.1, 1.4, trades=4096, bucket=4096),
        _record("batch.build_grids", 1.1, 1.2, native=True, rows=4096, schedules=64),
        _record("batch.build_grids", 1.5, 1.6, native=True, rows=1024, schedules=1024),
        # before the window: not counted
        _record("batch.build_grids", 0.5, 0.6, native=True, rows=8, schedules=8),
    ])
    assert READ(Window) == pytest.approx(100.0 * (64 + 1024) / (4096 + 1024))


def test_a_window_without_a_request_or_without_counted_builds_reads_nothing(records):
    # an untraced run records nothing
    assert READ(Window) is None
    # the parent commit's builders count no schedules
    records.extend([
        _record("service.price", 1.1, 1.4, trades=4096, bucket=4096),
        _record("batch.build_grids", 1.1, 1.2, native=True),
    ])
    assert READ(Window) is None
    # builds, but no request in the window
    records.popleft()
    records.append(_record("batch.build_grids", 1.3, 1.4, native=True, rows=16, schedules=2))
    assert READ(Window) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import finite_difference_tpu_torch
    from finite_difference_tpu_torch import tracing  # noqa: F401  (an attribute to take away)

    monkeypatch.delattr(finite_difference_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "finite_difference_tpu_torch.tracing", None)
    assert READ(Window) is None


def test_a_traced_american_run_reads_one_schedule_a_build(tmp_path):
    from finite_difference_tpu_torch import tracing

    root = portbench_tiny.make(tmp_path)
    tracing.clear()  # records that earlier traced runs of this process left
    out = portbench_tiny.run(root, "fa_american_div_f64.sweep", seconds=1.0, traced=True)
    assert out["correct"] and out["failed"] == 0
    # each request is one put chain at one expiry: one schedule a build
    builds = [r for r in tracing.records if r.name == "batch.build_grids"]
    assert builds and all(r.attrs["schedules"] == 1 < r.attrs["rows"] for r in builds)
    rows = {r.attrs["rows"] for r in builds}
    assert len(rows) == 1
    share = out["metrics"]["batch.schedule_rows_share.sweep"]["value"]
    assert share == pytest.approx(100.0 / rows.pop())
