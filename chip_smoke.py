#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (finite_difference_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, drives the port's main
path (``price_barrier_batch`` on the benchmark trade set: B=4096 barrier
trades, 1024-node grids, 512 Crank–Nicolson steps, float32) and checks its
output, times it, and prints one JSON line per phase. The last three lines
are the kernels' summary (JSON), the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when ``torch.cuda.is_available()``
is false or when the port is not beside it; any failed check raises.
It imports no JAX and nothing of the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the benchmark trade set (bench.py make_batch): 1-month up-and-out calls,
# 24 daily monitors, far barrier H=420, seed 0
N_NODES = 1024
N_STEPS = 512
T_EXP = 31.0 / 365.0
STRIKE, RATE, BARRIER = 190.0, 0.0705, 420.0
B_MAIN = 4096
B_CHECK = 256  # the prefix held against the float64 route and the plain version

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_trades(B: int):
    rng = np.random.default_rng(0)
    spots = rng.uniform(180.0, 250.0, 4096)[:B]
    sigmas = rng.uniform(0.2, 0.35, 4096)[:B]
    kw = dict(
        spots=spots, strikes=[STRIKE] * B, sigmas=list(sigmas),
        t_expiry=[T_EXP] * B, r=[RATE] * B, b=[RATE] * B, is_call=[True] * B,
        n_time_steps=N_STEPS,
        monitor_times=[[T_EXP * (k + 1) / 24.0 for k in range(24)]] * B,
        upper=[BARRIER] * B, num_space_nodes=N_NODES - 1,
    )
    return kw, spots, sigmas


def mixed_trades(B: int, n_steps: int, num_space_nodes: int):
    """Calls and puts, up/down/double barriers, rebates at hit and at expiry."""
    rng = np.random.default_rng(1)
    t = 0.25
    return dict(
        spots=list(rng.uniform(90.0, 110.0, B)), strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.4, B)), t_expiry=[t] * B, r=[0.05] * B,
        b=list(rng.uniform(0.0, 0.05, B)), is_call=[i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps, monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        lower=[80.0 if i % 4 < 2 else None for i in range(B)],
        upper=[125.0 if i % 4 != 1 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 3.0, B)), rebate_at_hit=[i % 3 == 0 for i in range(B)],
        num_space_nodes=num_space_nodes,
    )


def black_scholes_call(spots, sigmas):
    """Generalized Black–Scholes call (carry b = r): the far-barrier limit."""
    n = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    out = []
    for s, sg in zip(spots, sigmas):
        vol = sg * math.sqrt(T_EXP)
        d1 = (math.log(s / STRIKE) + (RATE + 0.5 * sg * sg) * T_EXP) / vol
        out.append(s * n(d1) - STRIKE * math.exp(-RATE * T_EXP) * n(d1 - vol))
    return np.asarray(out)


def march(prep, segments, step):
    v, e = prep.v0, prep.edge0
    for k0, k1, t in segments:
        v, e = step(prep, t, v, e, k0, k1)
    return v, e


def march_cost(prep, segments):
    """(flops, bytes, matvec_flops) of one march.

    The bound counts the work the march itself needs: about 14 flops per
    interior node and step (rhs 5, forward 3, backward 2, correction 4),
    plus the reduced interface system, which couples each of its 2P
    unknowns only to b_{j-1} and t_{j+1} and so is banded: a solve with
    precomputed factors takes about 9 flops per unknown. Bytes: each input
    read once and each output written once, per launch; the interface
    system's entries are the tips of the spike vectors, already in
    ``fields``. ``matvec_flops`` is what this design spends instead on the
    dense 2P x 2P inverse matvec, 2*(2P)^2 per trade and step: overhead of
    the design, not part of the bound.
    """
    B, n_pad = prep.v0.shape
    P, n_int = prep.P, prep.n_int
    item = prep.v0.element_size()
    flops = nbytes = matvec_flops = 0
    for k0, k1, _ in segments:
        ns = k1 - k0
        flops += ns * B * (14 * n_int + 9 * 2 * P)
        matvec_flops += ns * B * 2 * (2 * P) ** 2
        words = (
            B * 11 + B * 5 + 5 * B * n_pad  # trade, coef, fields
            + B * n_pad + 2 * B * ns  # knock-out mask, tau and monitor slices
            + 2 * (B * n_pad + 2 * B)  # v and edges in, v and edges out
        )
        nbytes += words * item
    return flops, nbytes, matvec_flops


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import spike
    from finite_difference_tpu_torch.models.pde.batch import (
        _spike_schedule_impl,
        build_trade_batch,
        price_barrier_batch,
    )

    # the plain versions and the references use no reduced precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = {"name": name, "nvidia_smi": smi}
    t0 = time.perf_counter()
    log = kernels.build()
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    emit("device", name=name, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0, ptxas=ptxas)

    # 2. kernel against its plain version on the card -----------------------
    limits = {torch.float64: 1e-11, torch.float32: 2e-4}
    for label, kw_fn, n_nodes in (
        ("small", lambda: mixed_trades(8, 32, 127), 128),
        ("main_width", lambda: bench_trades(B_CHECK)[0], N_NODES),
    ):
        for dtype, limit in limits.items():
            tb = build_trade_batch(dtype=dtype, device=dev, **kw_fn())
            segments, set_defs = spike.default_segments(tb.n_steps)
            prep = spike.prepare_spike(tb, tb.sigma, n_nodes, spike.spike_p(n_nodes), set_defs)
            v_k, e_k = march(prep, segments, kernels.spike_march_cuda)
            v_r, e_r = march(prep, segments, spike.spike_march_reference)
            torch.cuda.synchronize()
            scale = float(v_r.abs().max())
            err = max(float((v_k - v_r).abs().max()), float((e_k - e_r).abs().max()))
            emit("kernel_vs_plain", size=label, dtype=str(dtype), B=tb.batch_size,
                 N=n_nodes, steps=tb.n_steps, P=prep.P, max_abs_err=err, max_abs_v=scale,
                 ratio=err / scale, limit=limit)
            check(math.isfinite(err) and err <= limit * scale,
                  f"kernel vs plain {label} {dtype}: {err / scale:.3e} > {limit}")

    # 3. the main path ------------------------------------------------------
    kw, spots, sigmas = bench_trades(B_MAIN)
    tb = build_trade_batch(dtype=torch.float32, device=dev, **kw)
    kernels.reset_launch_counts()
    out_p = price_barrier_batch(tb, N_NODES, with_greeks=False)
    out_g = price_barrier_batch(tb, N_NODES, with_greeks=True)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    check(launches["spike_march"] > 0, "the main path launched no spike_march kernel")
    for key, val in {**out_p, **out_g}.items():
        check(val.shape == (B_MAIN,) and bool(torch.isfinite(val).all()), f"{key} not finite")
    price = out_p["price"].double().cpu().numpy()
    bs = black_scholes_call(spots, sigmas)
    bs_err = float(np.max(np.abs(price - bs) / np.maximum(bs, 1e-8)))

    tb64 = build_trade_batch(dtype=torch.float64, device=dev, **bench_trades(B_CHECK)[0])
    out64 = price_barrier_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-2)
    f32_vs_f64 = {}
    for key, val in out64.items():
        ref = val.cpu().numpy()
        got = out_g[key][:B_CHECK].double().cpu().numpy()
        if key == "price":
            f32_vs_f64[key] = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-8)))
        else:
            f32_vs_f64[key] = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    limits_f64 = {"price": 1e-3, "delta": 1e-2, "gamma": 1e-2, "theta": 1e-2, "vega": 5e-2}
    emit("main_path", B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float32", solver="auto",
         launches=launches, far_barrier_max_rel_err_vs_bs=bs_err,
         f32_vs_f64_first_256=f32_vs_f64, limits=limits_f64, **card)
    check(bs_err <= 1e-3, f"far-barrier price vs Black–Scholes {bs_err:.3e} > 1e-3")
    for key, lim in limits_f64.items():
        check(f32_vs_f64[key] <= lim, f"f32 vs f64 {key}: {f32_vs_f64[key]:.3e} > {lim}")

    # 4. timing -------------------------------------------------------------
    def grids_per_s(with_greeks: bool, iters: int) -> float:
        price_barrier_batch(tb, N_NODES, with_greeks=with_greeks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            price_barrier_batch(tb, N_NODES, with_greeks=with_greeks)
        torch.cuda.synchronize()
        return B_MAIN * iters / (time.perf_counter() - t0)

    gps = grids_per_s(False, 10)
    gps_greeks = grids_per_s(True, 5)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # where one price-only call's time goes: schedule inspection, host prep,
    # the kernel, the rest; on the main path's own segments and prep
    sched, sched_ms = host_ms(lambda: _spike_schedule_impl(tb, N_NODES))
    check(sched is not None, "the main path's batch is not SPIKE-eligible")
    segments, set_defs = sched[:2]
    prep, prep_ms = host_ms(
        lambda: spike.prepare_spike(tb, tb.sigma, N_NODES, spike.spike_p(N_NODES), set_defs)
    )
    ms = cuda_ms(lambda: march(prep, segments, kernels.spike_march_cuda), reps=10)
    k0, k1, t_cn = segments[-1]
    ms_cn_launch = cuda_ms(
        lambda: kernels.spike_march_cuda(prep, t_cn, prep.v0, prep.edge0, k0, k1), reps=10
    )
    (v_r, e_r), plain_ms = host_ms(lambda: march(prep, segments, spike.spike_march_reference))

    # the kernel against its plain version at the main path's own shapes
    v_k, e_k = march(prep, segments, kernels.spike_march_cuda)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    main_err = max(float((v_k - v_r).abs().max()), float((e_k - e_r).abs().max()))
    emit("kernel_vs_plain", size="main_path", dtype=str(torch.float32), B=B_MAIN, N=N_NODES,
         steps=N_STEPS, P=prep.P, max_abs_err=main_err, max_abs_v=scale,
         ratio=main_err / scale, limit=limits[torch.float32])
    check(math.isfinite(main_err) and main_err <= limits[torch.float32] * scale,
          f"kernel vs plain main path: {main_err / scale:.3e} > {limits[torch.float32]}")
    del v_r, e_r, v_k, e_k

    flops, nbytes, matvec_flops = march_cost(prep, segments)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    call_ms = B_MAIN / gps * 1e3
    emit("timing", grids_per_s=gps, greeks_grids_per_s=gps_greeks, call_ms=call_ms,
         schedule_ms=sched_ms, prep_ms=prep_ms,
         rest_ms=call_ms - sched_ms - prep_ms - ms, kernel_ms_per_march=ms,
         launches_per_march=len(segments), kernel_ms_per_cn_launch=ms_cn_launch,
         cn_launch_steps=k1 - k0, plain_ms_per_march=plain_ms, flops=flops, bytes=nbytes,
         dense_matvec_flops=matvec_flops, ops_ms=t_ops, bytes_ms=t_bytes, bound_ms=bound_ms,
         B=B_MAIN, N=N_NODES, steps=N_STEPS, P=prep.P, **card)

    # device time of one price-only call by kernel, and the busy share of
    # the unprofiled call time (the profiler's own overhead inflates wall time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        price_barrier_batch(tb, N_NODES, with_greeks=False)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    check(device_ms > 0, "the profiler saw no device time")
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", call_ms=call_ms, device_ms=device_ms, busy_share=device_ms / call_ms,
         device_kernels=sum(e.count for e in rows),
         top=[{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
              for e in top], **card)

    # 5. summary ------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "spike_march",
        "route": "cuda",
        "source": "finite_difference_tpu_torch/csrc/spike_march.cu",
        "replaces": "finite_difference_tpu/models/pde/pallas_kernel.py:589",
        "launches": launches["spike_march"],
        "max_abs_err": main_err,
        "max_abs_err_over_max_abs_v": main_err / scale,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
