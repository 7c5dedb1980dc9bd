"""No run loads JAX, jaxlib, flax or the JAX package: the check compares each
module's top-level name whole, since the port's name begins with the JAX
package's."""
import json
import subprocess
import sys
import textwrap

from benchmark import run


def test_names_compare_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"finite_difference_tpu_torch": None,
                                         "finite_difference_tpu_torch.serving": None,
                                         "jaxtyping": None, "numpy": None})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"finite_difference_tpu.models": None, "jax.numpy": None,
                                         "jaxlib": None, "flax.linen": None})
    assert run.forbidden_modules() == ["finite_difference_tpu", "flax", "jax", "jaxlib"]


def test_a_run_of_each_cell_loads_none_of_them(tmp_path):
    import portbench_tiny

    root = portbench_tiny.make(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(portbench_tiny.HERE.parent)!r})
        sys.path.insert(0, {str(portbench_tiny.HERE / "tests")!r})
        import portbench_tiny
        from pathlib import Path
        from benchmark.run import forbidden_modules
        root = Path({str(root)!r})
        ok = [portbench_tiny.run(root, c, traced=t)["correct"] for c in portbench_tiny.spec(root).cells()
              for t in (False, True)]
        print(json.dumps(dict(ok=ok, forbidden=forbidden_modules())))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(res["ok"]) and res["forbidden"] == []


def test_the_command_fails_without_the_port(tmp_path):
    import shutil

    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fa_barrier_f64.sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()
