"""Where the American march's float32 error comes from: a CPU accuracy budget.

    python -m finite_difference_tpu_torch.f32_budget [--batch 16]

On the benchmark's American trade set (bench.py make_american_batch:
1-year puts, spots U(80, 120), sigma U(0.15, 0.40), seed 7, K=100, r=0.06,
b=0.02, 1024 nodes, 512 steps) it marches at float64 with one group of
the prepared tensors rounded to float32 at a time, then the whole march at
float32, and reports each against the float64 march: max |dV| and the
gamma error (the 3-point stencil at spot) over max |gamma|. Last it holds
the float32 route of ``price_american_batch`` against the float64 route,
both at dv = 1e-2, as ``chip_smoke.py`` does on the card. It runs the
plain version on the CPU: accuracy only, no timing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .models.pde import spike
from .models.pde.batch import _spike_schedule_impl, build_american_batch, price_american_batch
from .ops.stencils import nonuniform_central

N_NODES, N_STEPS = 1024, 512


def _batch(B: int, dtype: torch.dtype):
    rng = np.random.default_rng(7)
    spots = rng.uniform(80.0, 120.0, 4096)[:B]
    sigmas = rng.uniform(0.15, 0.4, 4096)[:B]
    return build_american_batch(
        spots=list(spots), strikes=[100.0] * B, sigmas=list(sigmas), t_expiry=[1.0] * B,
        r=[0.06] * B, b=[0.02] * B, is_call=[False] * B, n_time_steps=N_STEPS,
        num_space_nodes=N_NODES - 2, dtype=dtype, device="cpu",
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    B = ap.parse_args(argv).batch

    t64, t32 = _batch(B, torch.float64), _batch(B, torch.float32)
    segments, set_defs, _, _ = _spike_schedule_impl(t64, N_NODES)
    i = torch.arange(N_NODES, dtype=torch.float64)
    s = torch.exp(t64.x_min[:, None] + i[None, :] * t64.dx[:, None])
    idx = torch.argmin((s - t64.spot[:, None]).abs(), dim=1).clamp(1, N_NODES - 2)
    gamma = lambda v: nonuniform_central(s, v.double(), idx)[1]
    march = lambda batch, prep: spike.assemble(prep, *spike.march_segments(batch, prep, segments))

    prep = spike.prepare_spike(t64, t64.sigma, N_NODES, None, set_defs, american=True)
    P = prep.P
    v_ref = march(t64, prep)
    g_ref = gamma(v_ref)
    scale = float(g_ref.abs().max())
    report = lambda v: {"max_abs_dv": float((v.double() - v_ref).abs().max()),
                        "gamma_err": float((gamma(v) - g_ref).abs().max()) / scale}
    r32 = lambda x: x.float().double()
    out = {}
    for name in ("coef", "fields", "iface", "v0"):
        out[f"f64 march, {name} rounded"] = report(
            march(t64, dataclasses.replace(prep, **{name: r32(getattr(prep, name))}))
        )
    p32 = spike.prepare_spike(t32, t32.sigma, N_NODES, P, set_defs, american=True)
    out["f32 march"] = report(march(t32, p32))
    out["f64 values rounded to f32"] = report(v_ref.float())
    for key, val in out.items():
        print(json.dumps({"case": key, "B": B, "P": P, **val}))

    o32 = price_american_batch(t32, N_NODES, solver="spike", device="cpu")
    o64 = price_american_batch(t64, N_NODES, solver="spike", dv_sigma=1e-2, device="cpu")
    route = {}
    for key, ref in o64.items():
        d = (o32[key].double() - ref).abs()
        route[key] = float((d / ref.abs()).max()) if key == "price" else float(d.max() / ref.abs().max())
    print(json.dumps({"case": "f32 route vs f64 route", "B": B, **route}))


if __name__ == "__main__":
    main()
