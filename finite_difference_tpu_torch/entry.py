"""Driver entry points of the port (counterpart of the repository root's
``__graft_entry__.py``, which drives the JAX package).

- :func:`entry`: the forward pricing step on the flagship model, the
  batched discrete-barrier CN pricer with its greeks, and example args.
- :func:`dryrun_multichip`: every step of the JAX package's multi-chip dry
  run on an ``n_devices`` mesh (:func:`parallel.make_mesh`), each sharded
  result held against its unsharded call. It runs in process: torch has no
  platform flag to set before start-up, and a mesh may repeat a device
  (``devices=["cpu"] * n`` or ``["cuda:0"] * n``).

    python -c "from finite_difference_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4, devices=['cuda:0'] * 4)"
"""
from __future__ import annotations

import datetime as _dt
import time
from dataclasses import replace
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import DEFAULT_DEVICE

# the benchmark trade set's grid: 1-month up-and-out calls on 1024 x 512
BENCH_NODES = 1024
BENCH_STEPS = 512
BENCH_T = 31.0 / 365.0


def _tiny_batch(B: int, n_steps: int, num_space_nodes: int, dtype=torch.float32, device=DEFAULT_DEVICE):
    from .models.pde.batch import build_trade_batch

    rng = np.random.default_rng(0)
    t = 31.0 / 365.0
    return build_trade_batch(
        spots=list(rng.uniform(180.0, 250.0, B)),
        strikes=[190.0] * B,
        sigmas=list(rng.uniform(0.2, 0.35, B)),
        t_expiry=[t] * B,
        r=[0.0705] * B,
        b=[0.0705] * B,
        is_call=[True] * B,
        n_time_steps=n_steps,
        monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        upper=[300.0] * B,
        num_space_nodes=num_space_nodes,
        dtype=dtype,
        device=device,
    )


def _bench_batch(B: int, dtype, device=DEFAULT_DEVICE):
    """The benchmark trade set (the repository root's ``bench.py``
    ``make_batch``, seeded): 1-month up-and-out calls, 24 daily monitors,
    the far barrier H=420, with the spectral interval layout attached. The
    draws are taken at 4096 trades and sliced, so any B is a prefix of one
    trade set."""
    from .models.pde.batch import SP_FIELDS, _spectral_layout, build_trade_batch

    rng = np.random.default_rng(0)
    spots = rng.uniform(180.0, 250.0, 4096)[:B]
    sigmas = rng.uniform(0.2, 0.35, 4096)[:B]
    tb = build_trade_batch(
        spots=spots,
        strikes=[190.0] * B,
        sigmas=list(sigmas),
        t_expiry=[BENCH_T] * B,
        r=[0.0705] * B,
        b=[0.0705] * B,
        is_call=[True] * B,
        n_time_steps=BENCH_STEPS,
        monitor_times=[[BENCH_T * (k + 1) / 24.0 for k in range(24)]] * B,
        upper=[420.0] * B,
        num_space_nodes=BENCH_NODES - 1,
        dtype=dtype,
        device=device,
    )
    layout = _spectral_layout(tb, BENCH_NODES)
    if layout is None:
        raise RuntimeError("the benchmark trade set must be spectral-eligible")
    return replace(tb, **dict(zip(SP_FIELDS, layout)))


def entry(device=DEFAULT_DEVICE):
    """``(fn, example_args)``: ``fn(batch)`` prices a batch with its greeks
    (``price_batch_kernel``, the scan) on the batch's device; the example is
    the JAX entry's tiny batch (B=8, 16 steps, 64 nodes) on ``device``."""
    from .models.pde.batch import price_batch_kernel

    B, n_steps, n_nodes = 8, 16, 64
    tb = _tiny_batch(B, n_steps, n_nodes - 1, device=device)

    def fn(batch):
        return price_batch_kernel(batch, n_nodes=n_nodes, with_greeks=True)

    return fn, (tb,)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _finite(out: Dict[str, torch.Tensor]) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in out.values())


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> Dict[str, float]:
    """The JAX package's multi-chip dry run (``__graft_entry__.
    _dryrun_multichip_impl``) on ``make_mesh(n_devices, devices=devices)``
    (the visible cards by default), in this process. Raises RuntimeError at
    the first step that fails; returns each step's wall seconds and the
    production step's largest price gap over max|price|.

    1. The batched price-and-greeks step, the trade axis sharded, with its
       mean summary by ``sharded_mean_stderr`` (the all-reduce).
    2. The ``auto`` route sharded.
    3. ``sharded_mean_stderr`` of 4n values.
    4. The device exposure over a cube whose path axis is sharded (at least
       1024 paths), equal to the unsharded MTM within 1e-12.
    5. The American sweep sharded, its prices above the intrinsic value.
    6. The SPIKE march sharded, barrier and American, equal to the
       unsharded march bit for bit.
    7. The production shape: the benchmark trades at float64, 1024 nodes,
       512 steps, B = 64 n, ``auto``, sharded against the unsharded call
       chunked in four, within 1e-12 of max|price|. (JAX holds its
       partitioned program at rtol = atol = 1e-12. Here the spectral
       route's DST matmuls run per shard, and a BLAS may sum a product of
       64 rows in another order than one of 64 n, which moves small
       prices by a few 1e-12: 3.9e-12 on four CPU shards.)
    """
    from .instruments.cashflow import LegType, SwapLeg
    from .instruments.ir_swap import IRSwap
    from .models.pde.batch import build_american_batch, price_american_batch, price_barrier_batch
    from .parallel import make_mesh, shard_batch, sharded_mean_stderr
    from .xva.device_exposure import DeviceExposureEngine

    mesh = make_mesh(n_devices, axis_names=("data",), devices=devices)
    n = mesh.size
    dev = mesh.devices.flat[0]
    wall: Dict[str, float] = {}
    clock = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal clock
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        wall[name] = now - clock
        clock = now

    B, n_steps, n_nodes = 2 * n, 8, 32
    tb = _tiny_batch(B, n_steps, n_nodes - 1, device=dev)
    out = price_barrier_batch(tb, n_nodes, with_greeks=True, mesh=mesh, solver="scan", device=dev)
    summary = {k: sharded_mean_stderr(v, mesh)[0] for k, v in out.items()}
    _check(_finite(out) and _finite(summary), "the sharded step's outputs are not finite")
    lap("sharded_step")

    out_auto = price_barrier_batch(tb, n_nodes, mesh=mesh, solver="auto", device=dev)
    _check(_finite(out_auto), "the sharded auto call is not finite")
    lap("auto")

    vals = torch.arange(4 * n, dtype=torch.float32, device=dev)
    mean, stderr = sharded_mean_stderr(vals, mesh)
    _check(abs(float(mean) - float(np.mean(np.arange(4 * n)))) <= 1e-6 and bool(torch.isfinite(stderr)),
           f"sharded_mean_stderr gave ({float(mean)}, {float(stderr)})")
    lap("mean_stderr")

    val = _dt.date(2025, 7, 28)
    tenors = np.array([0.25, 1.0, 2.0, 5.0])
    n_times = 6
    n_paths = max(1024, 128 * n)
    n_paths -= n_paths % n
    dates = [val + _dt.timedelta(days=30 * i) for i in range(n_times)]
    rng = np.random.default_rng(1)
    cube = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, tenors.size)).cumsum(0)
    swap = IRSwap(
        name="irs", effective_date=val, maturity_date=_dt.date(2025, 12, 28), notional=1e6,
        receive_leg=SwapLeg(LegType.FLOATING, frequency=3, curve_name="C"),
        pay_leg=SwapLeg(LegType.FIXED, frequency=3, fixed_rate=0.075),
        discount_curve_name="C",
    )
    mtm = DeviceExposureEngine(dates, {"C": shard_batch(cube, mesh, dim=1)}, tenors, device=dev).mtm([swap])
    plain = DeviceExposureEngine(dates, {"C": cube}, tenors, device=dev).mtm([swap])
    gap = float((mtm - plain).abs().max()) / float(plain.abs().max())
    _check(tuple(mtm.shape) == (n_paths, n_times) and bool(torch.isfinite(mtm).all()) and gap <= 1e-12,
           f"the path-sharded MTM: shape {tuple(mtm.shape)}, {gap:.3e} of max|MTM| from the unsharded")
    lap("device_exposure")

    B_am = 2 * n
    tb_am = build_american_batch(
        spots=[95.0 + i for i in range(B_am)], strikes=[100.0] * B_am, sigmas=[0.3] * B_am,
        t_expiry=[0.5] * B_am, r=[0.06] * B_am, b=[0.02] * B_am, is_call=[False] * B_am,
        n_time_steps=8, num_space_nodes=n_nodes - 1, dtype=torch.float32, device=dev,
    )
    out_am = price_american_batch(tb_am, n_nodes, mesh=mesh, device=dev)
    intrinsic = torch.clamp_min(100.0 - tb_am.spot, 0.0)
    _check(_finite(out_am) and bool((out_am["price"] >= intrinsic - 1e-6).all()),
           "the sharded American prices are not finite or fall below the intrinsic value")
    lap("american")

    tb32 = _tiny_batch(2 * n, n_steps, n_nodes - 1, device=dev)
    for label, price, batch in (("barrier", price_barrier_batch, tb32), ("american", price_american_batch, tb_am)):
        sharded = price(batch, n_nodes, mesh=mesh, solver="spike", device=dev)
        single = price(batch, n_nodes, solver="spike", device=dev)
        _check(all(torch.equal(sharded[k], single[k]) for k in single),
               f"the sharded {label} SPIKE march differs from the unsharded one")
    lap("spike")

    B_prod = 64 * n
    tb_prod = _bench_batch(B_prod, torch.float64, device=dev)
    sharded = price_barrier_batch(tb_prod, BENCH_NODES, with_greeks=False, mesh=mesh, solver="auto", device=dev)
    unsharded = price_barrier_batch(tb_prod, BENCH_NODES, with_greeks=False, max_chunk=max(1, B_prod // 4),
                                    solver="auto", device=dev)
    prod_gap = float((sharded["price"] - unsharded["price"]).abs().max() / unsharded["price"].abs().max())
    _check(prod_gap <= 1e-12, f"the production shape sharded vs unsharded: {prod_gap:.3e} of max|price|")
    lap("production")
    wall["production_rel_gap"] = prod_gap
    return wall
