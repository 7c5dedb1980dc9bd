"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with each configuration's grid, buckets and books cut down, for the
tests of this folder. Only the copy's data files differ from the real ones."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from benchmark.run import run_cell
from benchmark.spec import HERE, Spec

REPO = HERE.parent
GRID = {"barrier": dict(n_time_steps=32, num_space_nodes=63),
        "american": dict(n_time_steps=32, num_space_nodes=62)}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def make(root: Path) -> Path:
    """The tiny copy under ``root``: ``BENCHMARK.json`` and ``benchmark/``."""
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")

    def config(c):
        c["service"].update(GRID[c["service"]["kind"]], max_bucket=64)
        c["check"]["rows"] = 16
        strike = c["trades"]["fields"]["strike"]
        if isinstance(strike, dict):
            strike["linspace"][2] = 2

    def ladder(t):
        t["book"]["size"] = 2
        t["ladder"]["spot_rel"]["linspace"][2] = 2
        t["ladder"]["vol_abs"]["linspace"][2] = 2
        t["pool"] = min(t["pool"], 4)
        t["warmup_requests"] = min(t["warmup_requests"], 4)

    for p in (root / "benchmark" / "configs").glob("*.json"):
        _edit(p, config)
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        _edit(p, ladder)
    return root


def spec(root: Path) -> Spec:
    return Spec(root, root / "benchmark")


def run(root: Path, cell: str, seed: int = 2**31 + 7, seconds: float = 0.5, traced: bool = False,
        control: bool = False):
    return run_cell(spec(root), cell, seed, seconds, traced, "cpu", control=control,
                    t_start=time.perf_counter())[0]
