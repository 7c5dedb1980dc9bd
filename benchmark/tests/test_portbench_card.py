"""On a card: each cell at its real size for a short window is correct and
reports its metrics, and the control is not correct. Skips without a card."""
import subprocess
import sys
import json

import pytest

from benchmark.run import ROOT
from benchmark.spec import Spec


def _run(cell, *extra):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                          str(2**31 + 99), "--seconds", "2", *extra],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", Spec(ROOT).cells())
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = Spec(ROOT)
    for traced in (0, 1):
        res = _run(cell, "--trace", str(traced))
        assert res["correct"], res["checks"]
        assert {m["name"] for m in spec.metrics(cell, bool(traced))} == set(res["metrics"])
    assert not _run(cell, "--trace", "0", "--control")["correct"]
