"""A later cell, configuration, traffic mix and metric are new files and new
entries: the harness finds them by name and runs them, with no edit to a
file that is there."""
import json

import portbench_tiny


def test_new_config_mix_and_metric_are_found_and_run(tmp_path):
    root = portbench_tiny.make(tmp_path)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "fa_barrier_f64.json").read_text())
    cfg["trades"]["fields"]["sigma"] = 0.25
    (bench / "configs" / "dummy_desk.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"book": {"size": 3, "redraw": "per_request"}, "pool": 2, "warmup_requests": 1}))
    (bench / "metrics" / "dummy.trades_per_request.py").write_text(
        '"""Trades per request of the window."""\n\n\n'
        "def read(ctx):\n"
        "    return sum(len(r.trades) for r in ctx.done) / len(ctx.done) if ctx.done else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_desk", "source": "a test", "file": "benchmark/configs/dummy_desk.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_desk.run", "config": "dummy_desk", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dummy_desk.run")
    spec["per_layer"].append({"name": "dummy.trades_per_request", "unit": "trades", "better": "higher",
                              "source": "program_counter", "layer": "serving/service.py",
                              "moves": "trades_per_s", "workloads": ["dummy_desk.run"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing there was edited

    s = portbench_tiny.spec(root)
    assert "dummy_desk.run" in s.cells()
    assert [m["name"] for m in s.metrics("dummy_desk.run", traced=True)] == ["dummy.trades_per_request"]
    out = portbench_tiny.run(root, "dummy_desk.run")
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"trades_per_s", "setup_s"}
    traced = portbench_tiny.run(root, "dummy_desk.run", traced=True)
    assert traced["metrics"]["dummy.trades_per_request"]["value"] == 3.0
