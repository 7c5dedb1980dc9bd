"""BENCHMARK.json against the benchmark's contract: names, units, files,
bounds, and what each cell reports."""
import json
import re

from benchmark.run import ROOT
from benchmark.spec import HERE, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_to_the_contract():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"] and 1 <= data["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in data["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in data[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file() and len(w["why"]) <= 200
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    spec = Spec(ROOT)
    for cell in spec.cells():
        reported = {m["name"] for m in spec.metrics(cell, traced=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics(cell, traced=True)


def test_configs_state_their_checks():
    for path in (HERE / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        kind = c["service"]["kind"]
        keys = {"price", "delta", "gamma", "vega"} | ({"theta"} if kind == "barrier" else set())
        assert set(c["check"]["limits"]) == keys and c["check"]["rows"] >= 64
        assert c["service"]["dtype"] == "float64" and c["control"]["dtype"] == "float32"
