"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. Set-up
builds the configured service, makes the pool of requests from the seed and
prices the cell's warm-up requests of it, which meet every shape the window
does; the window then runs for ``--seconds``; afterwards a sample
of the rows returned is held against the plain reference (:mod:`check`).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end untraced, per-layer with
``--trace 1``), ``device`` and, traced, ``breakdown``, then ``checks``: each
number compared with its limit, which also end standard error.

``--control`` runs the configuration's lower-precision path of the program
(its ``control`` section) in the program's place; its rows must fail the
comparison. The benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "finite_difference_tpu")


@dataclass
class Context:
    """What a metric reader reads (see ``metrics/``)."""

    config: Dict[str, Any]
    records: list
    t0: float
    t_end: float
    setup_s: float
    counters: Dict[str, Dict[str, float]]
    spans: Any
    trace: Optional[Dict[str, Any]] = None
    peak: Optional[Dict[str, float]] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    @property
    def done(self) -> list:
        return [r for r in self.records if r.ok]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _peak(name: str):
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    return table.get(name)


def run_cell(spec, name: str, seed: int, seconds: float, traced: bool, device: str,
             control: bool = False, t_start: Optional[float] = None) -> Tuple[Dict[str, Any], Context]:
    """One run of cell ``name``: the result dict that the line prints, and
    the context its metrics were read from."""
    import torch

    from . import check, drive, system, trace
    from .traffic import ClosedLoop

    t_start = T_START if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}
    mark = lambda key: phases.__setitem__(key, time.perf_counter() - t_start - sum(phases.values()))
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = system.Spans()
    svc = system.build_service(config["service"], device, spans,
                               config.get("control") if control else None)
    mark("service")
    try:
        gen = ClosedLoop(config["trades"], mix, seed)
        mark("requests")
        for trades in gen.warmup:
            svc.price(trades)
        mark("warm_up")
        sample = check.Sample(int(config["check"]["rows"]), seed)
        sync()
        before = system.counters(svc)
        prof = trace.profile() if traced else None
        if prof is not None:
            prof.__enter__()
        try:
            with spans.span(trace.WINDOW):
                t0 = time.perf_counter()
                records = drive.closed_loop(svc.price, gen.request, seconds, sample.offer)
                sync()
                t_end = max([t0] + [r.done for r in records])
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        counts = system.delta(system.counters(svc), before)
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        system.unwrap_drivers()
    t_read = time.perf_counter()
    summary = trace.summarize(prof) if prof is not None else None
    phases["trace_read"] = time.perf_counter() - t_read
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = Context(config=config, records=records, t0=t0, t_end=t_end,
                  setup_s=t0 - t_start, counters=counts, spans=spans,
                  trace=summary, peak=_peak(kind))
    metrics = {}
    for m in spec.metrics(name, traced):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    # the program's state goes before the reference runs on the same card
    del svc
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, checks = check.judge(config, records, sample, device)
    phases["check_after_window"] = time.perf_counter() - t_check
    dev = dict(platform="gpu" if cuda else "cpu", kind=kind, count=int(cell["chips"]),
               memory_peak_bytes=int(memory_peak))
    out = dict(correct=bool(correct), attempted=len(records),
               failed=sum(1 for r in records if not r.ok), metrics=metrics, device=dev)
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = dict(device_ops=summary["device_ops"], idle_gaps=summary["idle_gaps"])
    out["counters"] = counts
    out["phases_s"] = phases
    out["checks"] = checks
    return out, ctx


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the configuration's lower-precision path in the program's place")
    args = p.parse_args(argv)

    from .spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, _ = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         control=args.control)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    result["device"]["power"] = _power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
