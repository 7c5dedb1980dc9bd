"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration ``<config>`` in ``benchmark/configs/<config>.json``;
- a traffic mix ``<mix>`` in ``benchmark/traffic/<mix>.json``;
- a metric ``<name>`` (end-to-end or per-layer) read by
  ``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns the value or
  None where the run holds nothing to read.

A later cell, configuration, mix or metric is a new entry and a new file.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cells(self) -> List[str]:
        return [w["name"] for w in self.data["workloads"]]

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {self.cells()}")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, traced: bool) -> List[Dict[str, Any]]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
