"""Batched barrier and American PDE pricing — the port's main paths.

Counterpart of ``finite_difference_tpu.models.pde.batch`` for the barrier
and American sweeps: a struct-of-arrays batch of trades (each with its own
grid, dynamics, barrier or dividend schedule) priced in one pass, with the
price and bump greeks on the device.

    build_trade_batch -> price_barrier_batch -> _run_batch_driver
        -> price_batch_kernel -> spike.cn_barrier_solve_spike (CUDA kernel)
                              or stepper.cn_solve (solver="scan")
                              or spectral.spectral_solve (solver="spectral")
    build_american_batch -> price_american_batch -> _run_batch_driver
        -> american_batch_kernel -> spike.cn_barrier_solve_spike(american=True)
                                 or stepper.cn_solve(american=True)
    solve_value_surfaces -> the same routes, V (B, N) and the nodes

``solver`` takes the JAX package's names: ``"auto"``, ``"scan"``,
``"spike"``, ``"spike_df64"``, ``"spectral"``, ``"spectral_x64dst"`` and
``"spectral_mixed"`` (:func:`auto_solver` is the rule of ``"auto"``);
``greeks_mode`` ``"bump"`` or ``"ad"`` (vega from one ``torch.func.jvp``).
``mesh=`` (a :class:`finite_difference_tpu_torch.parallel.Mesh`, or a device
count or a list of device names: ``parallel.mesh.check_mesh``) splits the
trade axis over the mesh's ``axis_name``: the route and every static
choice are made once on the whole batch, then each shard runs on its
device (the SPIKE march as one launch per segment per shard) and the
outputs are gathered in trade order on the batch's device
(:func:`_run_batch_driver`). Differences from the JAX package: no packed
transfers; no ``B % 128`` padding rule (a mesh pads to a multiple of its
axis only); the spectral names on an American batch raise (the JAX package
silently runs the scan there).
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass, fields as dc_fields, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import native, tracing
from ...device import DEFAULT_DEVICE, resolve_device
from ...parallel.mesh import check_mesh, on_device, pad_to_multiple
from ...ops.interp import linear_interp
from ...ops.stencils import nearest_index, nonuniform_central
from .grid import (
    _PPF_99999,
    american_log_grid,
    barrier_log_grid,
    monitor_aligned_schedule,
    segmented_schedule,
    uniform_schedule,
)
from .spectral import (
    channel_conditioning,
    interval_plan,
    require_full_float32,
    run_graphed,
    spectral_solve,
    spectral_solve_mixed,
    symmetrizer_exponent,
)
from .spike import cn_barrier_solve_spike, prepare_spike, spike_p
from .stepper import BarrierSpec, CNDynamics, CNGrid, CNSchedule, cn_solve

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
# the most (theta, dt) runs a schedule may have and still take the SPIKE
# route: one kernel launch per run
SPIKE_MAX_SEGMENTS = 64


@dataclass
class BarrierTradeBatch:
    """Struct-of-arrays batch of discretely monitored barrier trades.

    Every field is a torch tensor with leading dim B; schedule fields are
    (B, n_steps). Build with :func:`build_trade_batch` or, from another
    batch's numpy arrays, :func:`batch_from_numpy`.
    """

    x_min: torch.Tensor
    dx: torch.Tensor
    strike: torch.Tensor
    is_call: torch.Tensor
    sigma: torch.Tensor
    r: torch.Tensor
    b: torch.Tensor
    q: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    has_lower: torch.Tensor
    has_upper: torch.Tensor
    rebate: torch.Tensor
    rebate_at_hit: torch.Tensor
    rebate_rate: torch.Tensor
    s_eff: torch.Tensor  # spot for price interpolation (escrowed)
    spot: torch.Tensor  # spot for greek stencils
    # schedule
    dt: torch.Tensor
    theta: torch.Tensor
    tau_next: torch.Tensor
    monitor: torch.Tensor
    div_amount: torch.Tensor
    reset_lambda: torch.Tensor
    # the spectral propagator's interval layout (attached by the driver on
    # the spectral route, from _spectral_layout; None otherwise)
    sp_k_end: Optional[torch.Tensor] = None  # (B, n_intervals) integer
    sp_apply: Optional[torch.Tensor] = None  # (B, n_intervals) bool
    sp_rann: Optional[torch.Tensor] = None  # (B,) Rannacher step count
    # per-interval dt of a monitor-aligned (piecewise-constant) schedule;
    # None when dt is globally uniform (the hoisted branch)
    sp_dt: Optional[torch.Tensor] = None  # (B, n_intervals)

    @property
    def batch_size(self) -> int:
        return self.x_min.shape[0]

    @property
    def n_steps(self) -> int:
        return self.dt.shape[1]

    def _map(self, fn) -> "BarrierTradeBatch":
        return BarrierTradeBatch(**{
            f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
            for f in dc_fields(self)
        })

    def to(self, device) -> "BarrierTradeBatch":
        return self._map(lambda x: x.to(device))

    def astype(self, dtype: torch.dtype) -> "BarrierTradeBatch":
        """Floating fields cast to ``dtype``; bool fields unchanged."""
        return self._map(lambda x: x.to(dtype) if x.is_floating_point() else x)

    def __getitem__(self, sl: slice) -> "BarrierTradeBatch":
        return self._map(lambda x: x[sl])


SP_FIELDS = ("sp_k_end", "sp_apply", "sp_rann", "sp_dt")
FIELD_NAMES = tuple(f.name for f in dc_fields(BarrierTradeBatch) if f.name not in SP_FIELDS)
SCHEDULE_FIELDS = ("dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda")


def batch_from_numpy(fields: Dict[str, np.ndarray], device=DEFAULT_DEVICE) -> BarrierTradeBatch:
    """The port's batch from numpy arrays keyed by field name.

    Carries state across from the JAX package: pass a JAX
    ``BarrierTradeBatch``'s fields (a barrier or an American batch) as
    numpy arrays, its spectral ``sp_*`` layout too where it has one (a
    missing or None ``sp_*`` key stays None).
    """
    return _upload(fields, None, resolve_device(device))


def _upload(fields: Dict[str, np.ndarray], rows: Optional[np.ndarray], dev) -> BarrierTradeBatch:
    """The batch on ``dev`` from numpy ``fields``.

    ``rows`` None: every field holds a row per trade. Otherwise the
    :data:`SCHEDULE_FIELDS` hold one row per distinct schedule and ``rows``
    (B,) names each trade's: those rows and the index cross to the device,
    which expands each field to (B, n_steps) with one gather. The span's
    ``bytes`` counts what crossed.
    """
    with tracing.span("batch.upload") as rec:
        tensors = {k: torch.as_tensor(np.asarray(fields[k])).to(dev) for k in FIELD_NAMES}
        for k in SP_FIELDS:
            if fields.get(k) is not None:
                tensors[k] = torch.as_tensor(np.asarray(fields[k])).to(dev)
        moved = list(tensors.values())
        if rows is not None:
            index = torch.as_tensor(rows).to(dev)
            moved.append(index)
            for k in SCHEDULE_FIELDS:
                tensors[k] = tensors[k].index_select(0, index)
        if rec is not None:
            rec.attrs["bytes"] = sum(t.nbytes for t in moved)
    return BarrierTradeBatch(**tensors)


def _distinct(keys: Sequence) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Trades grouped by the key of their schedule: ``(reps, rows)``, the
    first trade of each distinct key in order of first appearance and each
    trade's row among those ((B,) int64); ``(None, None)`` when no two
    trades share a key, so each keeps a row of its own."""
    seen: Dict = {}
    rows = [seen.setdefault(k, len(seen)) for k in keys]
    if len(seen) == len(rows):
        return None, None
    rows = np.asarray(rows, dtype=np.int64)
    return np.unique(rows, return_index=True)[1], rows


def _float_bits(v: Sequence[float]) -> List[int]:
    """Float64 values as their bit patterns: keys that tell 0.0 from -0.0."""
    return np.asarray(v, dtype=np.float64).view(np.int64).tolist()


def _pad_rows(x: torch.Tensor, pad: int, dim: int = 0) -> torch.Tensor:
    """``x`` with ``pad`` clones of its first row along ``dim`` appended."""
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.narrow(dim, 0, 1).expand(shape)], dim)


def pad_batch(tb: BarrierTradeBatch, pad: int) -> BarrierTradeBatch:
    """Append ``pad`` clones of the first trade to every per-trade tensor
    (the ``sp_*`` layout too, where it is set). The services pad a request
    to its bucket with it, and the driver a batch to a multiple of its
    mesh's axis; the padded rows' outputs are dropped."""
    return tb._map(lambda v: _pad_rows(v, pad)) if pad > 0 else tb


def build_trade_batch(
    spots: Sequence[float],
    strikes: Sequence[float],
    sigmas: Sequence[float],
    t_expiry: Sequence[float],
    r: Sequence[float],
    b: Sequence[float],
    is_call: Sequence[bool],
    n_time_steps: int,
    monitor_times: Sequence[Sequence[float]],
    lower: Optional[Sequence[Optional[float]]] = None,
    upper: Optional[Sequence[Optional[float]]] = None,
    q: Optional[Sequence[float]] = None,
    rebate: Optional[Sequence[float]] = None,
    rebate_at_hit: Optional[Sequence[bool]] = None,
    rannacher_steps: int = 2,
    num_space_nodes: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    use_native: bool = True,
    monitor_aligned: bool = False,
    steps_per_interval: int = 10,
    device=DEFAULT_DEVICE,
) -> BarrierTradeBatch:
    """Host-side canonicalisation: per-trade grids (production barrier grid
    policy) + per-trade monitor schedules into fixed-shape tensors on ``device``.

    ``num_space_nodes``: static node-count bucket; defaults to the
    reference's ~4.265*N_time rule evaluated once (it is trade-independent).
    ``use_native``: build grids and schedules with the C++ builder
    (:mod:`finite_difference_tpu_torch.native`) when it is available, as the
    JAX package does by default; the numpy loop is the reference and the
    fallback. The two differ only in ``tau_next`` (the C++ builder's
    dt*(k+1) against the loop's running sum), by a few roundings on a
    non-dyadic dt; each is bit-identical to the JAX package's same route.
    ``monitor_aligned``: use :func:`grid.monitor_aligned_schedule`
    (per-interval constant dt, monitors exactly on step boundaries) instead
    of :func:`grid.uniform_schedule`; ``n_time_steps`` then acts as the
    target-dt divisor T/n. Trades must share a monitor-interval structure.

    A schedule is a function of the trade's expiry and monitor times alone:
    every route builds each distinct one once and the device expands the
    rows to the trades (:func:`_upload`), unless no two trades share one.
    """
    dev = resolve_device(device)
    np_dtype = _NP_DTYPES[dtype]
    B = len(spots)
    if num_space_nodes is None:
        num_space_nodes = math.ceil(2.0 * _PPF_99999 * n_time_steps / 2.0)
    use_native = use_native and not monitor_aligned and native.available()

    with tracing.span("batch.build_grids", native=use_native, rows=B) as rec:
        z = lambda v, d: np.asarray(v if v is not None else [d] * B)
        lower = z(lower, None)
        upper = z(upper, None)
        has_lower = np.asarray([x is not None for x in lower])
        has_upper = np.asarray([x is not None for x in upper])
        lower_v = [x if x is not None else 0.0 for x in lower]
        upper_v = [x if x is not None else 0.0 for x in upper]
        te_bits = _float_bits(t_expiry)
        if len(set(te_bits)) == B:  # the expiry alone tells every schedule apart
            reps = rows = None
        else:
            reps, rows = _distinct(list(zip(te_bits, map(tuple, monitor_times))))
        if reps is not None:
            t_expiry_s = [t_expiry[i] for i in reps]
            monitor_times = [monitor_times[i] for i in reps]
        else:
            t_expiry_s = t_expiry
        if rec is not None:
            rec.attrs["schedules"] = len(t_expiry_s)
        if use_native:
            x_min, dx = native.barrier_log_grids(
                spots, strikes, sigmas, t_expiry, lower_v, upper_v,
                has_lower, has_upper, num_space_nodes,
            )
            dt, theta, tau_next, monitor = native.uniform_schedules(
                t_expiry_s, n_time_steps, rannacher_steps, monitor_times
            )
        else:
            x_min, dx = [], []
            for i in range(B):
                g = barrier_log_grid(
                    spot_eff=float(spots[i]),
                    strike=float(strikes[i]),
                    sigma=float(sigmas[i]),
                    t_expiry=float(t_expiry[i]),
                    num_time_steps=n_time_steps,
                    lower_barrier=lower[i],
                    upper_barrier=upper[i],
                    num_space_nodes=num_space_nodes,
                )
                x_min.append(g.x_min)
                dx.append(g.dx)
            cols: Dict[str, List] = {k: [] for k in SCHEDULE_FIELDS}
            for te, mons in zip(t_expiry_s, monitor_times):
                if monitor_aligned:
                    sch = monitor_aligned_schedule(
                        float(te), mons,
                        steps_per_interval=steps_per_interval,
                        target_dt=float(te) / n_time_steps,
                        rannacher_steps=rannacher_steps,
                    )
                else:
                    sch = uniform_schedule(float(te), n_time_steps, rannacher_steps, mons)
                for name in SCHEDULE_FIELDS:
                    cols[name].append(getattr(sch, name))

    # the builder reads none of these: the trade columns and its outputs in
    # the working dtype
    with tracing.span("batch.build_arrays"):
        f = lambda v: np.asarray(v, dtype=np_dtype)
        arrays = dict(
            strike=f(strikes),
            is_call=np.asarray(is_call, dtype=bool),
            sigma=f(sigmas),
            r=f(r),
            b=f(b),
            q=np.asarray(q if q is not None else np.zeros(B), dtype=np_dtype),
            lower=f(lower_v),
            upper=f(upper_v),
            has_lower=has_lower,
            has_upper=has_upper,
            rebate=np.asarray(rebate if rebate is not None else np.zeros(B), dtype=np_dtype),
            rebate_at_hit=np.asarray(
                rebate_at_hit if rebate_at_hit is not None else np.zeros(B, dtype=bool)
            ),
            rebate_rate=f(b),
            s_eff=f(spots),
            spot=f(spots),
            x_min=f(x_min),
            dx=f(dx),
        )
        if use_native:
            arrays.update(
                dt=dt.astype(np_dtype), theta=theta.astype(np_dtype),
                tau_next=tau_next.astype(np_dtype), monitor=monitor.astype(bool),
                div_amount=np.zeros(dt.shape, dtype=np_dtype),
                reset_lambda=np.zeros(dt.shape, dtype=bool),
            )
        else:
            arrays.update(_stack_schedules(cols, np_dtype))
    return _upload(arrays, rows, dev)


def _stack_schedules(cols: Dict[str, List], np_dtype) -> Dict[str, np.ndarray]:
    """The (U, n_steps) schedule fields from their rows."""
    return dict(
        dt=np.stack(cols["dt"]).astype(np_dtype),
        theta=np.stack(cols["theta"]).astype(np_dtype),
        tau_next=np.stack(cols["tau_next"]).astype(np_dtype),
        monitor=np.stack(cols["monitor"]),
        div_amount=np.stack(cols["div_amount"]).astype(np_dtype),
        reset_lambda=np.stack(cols["reset_lambda"]),
    )


def build_american_batch(
    spots: Sequence[float],
    strikes: Sequence[float],
    sigmas: Sequence[float],
    t_expiry: Sequence[float],
    r: Sequence[float],
    b: Sequence[float],
    is_call: Sequence[bool],
    n_time_steps: int,
    dividends_tau: Optional[Sequence[Sequence]] = None,
    rannacher_steps: int = 2,
    num_space_nodes: int = 400,
    s_max_mult: float = 4.5,
    dtype: torch.dtype = torch.float64,
    snap_to_grid: bool = False,
    use_native: bool = True,
    device=DEFAULT_DEVICE,
) -> BarrierTradeBatch:
    """Struct-of-arrays batch of American trades on ``device``.

    Same container as the barrier batch (barriers disabled); grids use the
    American policy (:func:`grid.american_log_grid`) and schedules the
    segmented layout with dividend jumps and IT resets
    (:func:`grid.segmented_schedule`). ``dividends_tau``: per trade, a list
    of (tau_from_expiry, amount). ``snap_to_grid`` applies the scalar
    pricer's spot/strike node snapping (fd_american_equity.py:386).
    Dividend-free batches take a vectorised numpy path; dividend batches
    take the C++ builder when ``use_native`` and it is available, else the
    per-trade loop. All three routes are bit-identical to the JAX package's.
    A schedule is a function of the trade's expiry, its dividends and, at a
    dividend, whether Rannacher restarts (``is_call``): every route builds
    each distinct one once and the device expands the rows to the trades
    (:func:`_upload`), unless no two trades share one.
    """
    dev = resolve_device(device)
    np_dtype = _NP_DTYPES[dtype]
    B = len(spots)
    dividends_tau = dividends_tau or [[] for _ in range(B)]
    n = int(n_time_steps)
    dividend_free = not any(len(d) for d in dividends_tau)
    use_native = not dividend_free and use_native and native.available()

    with tracing.span("batch.build_grids", native=use_native, rows=B) as rec:
        spots = [float(x) for x in spots]
        strikes = [float(k) for k in strikes]
        te_bits = _float_bits(t_expiry)
        if dividend_free:
            reps, rows = _distinct(te_bits)
        elif len(set(te_bits)) == B:  # the expiry alone tells every schedule apart
            reps = rows = None
        else:
            divs = [tuple(map(tuple, d)) for d in dividends_tau]
            keys = list(zip(te_bits, map(bool, is_call), divs))
            reps, rows = _distinct(keys)
            if reps is not None and any(a == 0.0 for i in reps for _, a in divs[i]):
                # amounts 0.0 and -0.0 are equal keys but different rows
                reps, rows = _distinct([
                    (*k, tuple(math.copysign(1.0, a) for _, a in d)) for k, d in zip(keys, divs)
                ])
        pick = (lambda v: v) if reps is None else (lambda v: [v[i] for i in reps])
        U = B if reps is None else len(reps)
        if rec is not None:
            rec.attrs["schedules"] = U
        if dividend_free:
            # dividend-free schedules are one uniform segment, so the per-trade
            # loop collapses to array expressions (bit-identical: the same grid
            # formulas, np.round and round() both half-to-even, np.cumsum the
            # sequential tau accumulation)
            sp = np.asarray(spots, float)
            st = np.asarray(strikes, float)
            sg = np.asarray(sigmas, float)
            te = np.asarray(t_expiry, float)
            s_low, s_high = np.minimum(sp, st), np.maximum(sp, st)
            s_c = np.sqrt(np.maximum(s_low * s_high, 1e-12))
            band = s_max_mult * sg * np.sqrt(np.maximum(te, 1e-12))
            x_c = np.log(s_c)
            s_min = np.maximum(np.minimum(np.exp(x_c - 0.5 * band), 0.5 * s_low), 1e-8)
            s_max = np.maximum(np.exp(x_c + 0.5 * band), 2.0 * s_high)
            x_min = np.log(s_min)
            dx = (np.log(s_max) - x_min) / float(int(num_space_nodes))
            if snap_to_grid:
                # scalar math.exp/log: numpy's vectorised exp differs by 1 ulp
                # on some inputs, and the snapped levels must equal the scalar
                # pricer's bit for bit (the payoff kink on a node)
                snap1 = lambda lvl, xm, d: math.exp(xm + round((math.log(lvl) - xm) / d) * d)
                sp = np.array([snap1(sp[i], x_min[i], dx[i]) for i in range(B)])
                st = np.array([snap1(st[i], x_min[i], dx[i]) for i in range(B)])
            dt = np.repeat((te if reps is None else te[reps])[:, None] / float(n), n, axis=1)
            reset = np.zeros((U, n), dtype=bool)
            reset[:, 0] = True
            theta = np.broadcast_to(np.where(np.arange(n) < rannacher_steps, 1.0, 0.5), (U, n))
            tau_next = np.cumsum(dt, axis=1)
            grids = dict(x_min=x_min, dx=dx, strike=st, spot=sp)
        elif use_native:
            grids = native.american_grids(
                spots, strikes, sigmas, t_expiry, num_space_nodes, s_max_mult, snap_to_grid,
            )
            grids.update(native.american_schedules(
                pick(t_expiry), [bool(c) for c in pick(is_call)], pick(dividends_tau),
                n_time_steps, rannacher_steps,
            ))
            bad = np.nonzero(grids.pop("status"))[0]
            if bad.size:
                first = int(bad[0]) if reps is None else int(reps[bad[0]])
                raise ValueError(f"segment steps exceeded n_time_steps (trade {first})")
        else:
            x_min, dx = [], []
            for i in range(B):
                g = american_log_grid(
                    spots[i], strikes[i], float(sigmas[i]), float(t_expiry[i]),
                    num_space_nodes, s_max_mult,
                )
                if snap_to_grid:
                    snap = lambda lvl: math.exp(g.x_min + round((math.log(lvl) - g.x_min) / g.dx) * g.dx)
                    spots[i] = snap(spots[i])
                    strikes[i] = snap(strikes[i])
                x_min.append(g.x_min)
                dx.append(g.dx)
            cols: Dict[str, List] = {k: [] for k in SCHEDULE_FIELDS}
            for te_i, divs_i, call in zip(pick(t_expiry), pick(dividends_tau), pick(is_call)):
                sch = segmented_schedule(
                    float(te_i), n_time_steps, divs_i,
                    rannacher_steps=rannacher_steps,
                    restart_rannacher_at_div=bool(call),
                )
                # segmented schedules share length n_time_steps by construction;
                # guard against per-trade drift from the remainder rule
                pad = n_time_steps - len(sch.dt)
                if pad < 0:
                    raise ValueError("segment steps exceeded n_time_steps")
                z = np.zeros(pad)
                cols["dt"].append(np.concatenate([sch.dt, z]))
                cols["theta"].append(np.concatenate([sch.theta, np.full(pad, 0.5)]))
                cols["tau_next"].append(np.concatenate([sch.tau_next, np.full(pad, sch.tau_next[-1])]))
                cols["monitor"].append(np.concatenate([sch.monitor, np.zeros(pad, bool)]))
                cols["div_amount"].append(np.concatenate([sch.div_amount, z]))
                cols["reset_lambda"].append(np.concatenate([sch.reset_lambda, np.zeros(pad, bool)]))
            grids = dict(x_min=x_min, dx=dx, strike=strikes, spot=spots)

    # the builder reads none of these: the trade columns and its outputs in
    # the working dtype
    with tracing.span("batch.build_arrays"):
        f = lambda v: np.asarray(v, dtype=np_dtype)
        zB = np.zeros(B, dtype=np_dtype)
        fB = np.zeros(B, dtype=bool)
        arrays = dict(
            is_call=np.asarray(is_call, dtype=bool), sigma=f(sigmas), r=f(r), b=f(b),
            q=zB, lower=zB, upper=zB, has_lower=fB, has_upper=fB, rebate=zB,
            rebate_at_hit=fB, rebate_rate=f(b), monitor=np.zeros((U, n), dtype=bool),
            x_min=f(grids["x_min"]), dx=f(grids["dx"]), strike=f(grids["strike"]),
            s_eff=f(grids["spot"]), spot=f(grids["spot"]),
        )
        if dividend_free:
            arrays.update(
                sigma=f(sg), dt=dt.astype(np_dtype), theta=np.ascontiguousarray(theta, dtype=np_dtype),
                tau_next=tau_next.astype(np_dtype),
                div_amount=np.zeros((U, n), dtype=np_dtype), reset_lambda=reset,
            )
        elif use_native:
            arrays.update(
                dt=grids["dt"].astype(np_dtype), theta=grids["theta"].astype(np_dtype),
                tau_next=grids["tau_next"].astype(np_dtype),
                div_amount=grids["div_amount"].astype(np_dtype),
                reset_lambda=grids["reset_lambda"],
            )
        else:
            arrays.update(_stack_schedules(cols, np_dtype))
    return _upload(arrays, rows, dev)


def _dynamics(batch: BarrierTradeBatch, sigma) -> CNDynamics:
    return CNDynamics(
        strike=batch.strike, is_call=batch.is_call, sigma=sigma,
        r=batch.r, b=batch.b, q=batch.q,
    )


def _barrier_spec(batch: BarrierTradeBatch) -> BarrierSpec:
    return BarrierSpec(
        lower=batch.lower, upper=batch.upper,
        has_lower=batch.has_lower, has_upper=batch.has_upper,
        rebate=batch.rebate, rebate_at_hit=batch.rebate_at_hit,
        rebate_rate=batch.rebate_rate,
    )


def _schedule(batch: BarrierTradeBatch) -> CNSchedule:
    return CNSchedule(
        dt=batch.dt, theta=batch.theta, tau_next=batch.tau_next,
        monitor=batch.monitor, div_amount=batch.div_amount,
        reset_lambda=batch.reset_lambda,
    )


def _solve_scan(batch: BarrierTradeBatch, sigma, n_nodes: int):
    """The CN scan over the whole batch; ``sigma`` may be bumped."""
    grid = CNGrid(batch.x_min, batch.dx)
    return cn_solve(grid, _dynamics(batch, sigma), _schedule(batch), n_nodes, barrier=_barrier_spec(batch))


def _solve_scan_american(batch: BarrierTradeBatch, sigma, n_nodes: int, with_dividends: bool):
    """The American CN scan (Ikonen–Toivanen, American put edge) over the
    whole batch; ``sigma`` may be bumped."""
    grid = CNGrid(batch.x_min, batch.dx)
    return cn_solve(
        grid, _dynamics(batch, sigma), _schedule(batch), n_nodes, barrier=None, american=True,
        with_dividends=with_dividends, euro_put_lower_boundary=False,
    )


def _solve_spectral(batch: BarrierTradeBatch, sigma, n_nodes: int, solver: str, graph: bool = False,
                    graph_keys: Optional[set] = None):
    """The spectral propagator over the whole batch at ``sigma``, on the
    batch's ``sp_*`` layout (:func:`_spectral_layout`):

    - ``"spectral"``: the state and the DSTs in the batch's dtype;
    - ``"spectral_x64dst"``: the DSTs at float64, the state in the batch's
      dtype;
    - ``"spectral_mixed"``: float64 transcendentals and DSTs, float32
      state (uniform dt only).

    ``graph``: run the solve by ``spectral.run_graphed``'s capture rule
    (eager in a key's first driver call, from a CUDA graph after; a CUDA
    batch, and not under ``torch.func.jvp``); ``graph_keys``: the keys the
    driver call has sighted so far (a solve sights its key once per call:
    the vega bump's solve, and a mesh's further shards of one shape on one
    device, follow the first). The key holds the device, so each device of
    a mesh has its own graphs.
    """
    mixed = solver == "spectral_mixed"
    dt = batch.dt[:, 0] if mixed or batch.sp_dt is None else batch.sp_dt
    b = _barrier_spec(batch)
    tensors = [batch.x_min, batch.dx, batch.strike, batch.is_call, sigma, batch.r, batch.b,
               batch.q, *b, dt, batch.sp_k_end, batch.sp_apply, batch.sp_rann]
    plan = interval_plan(batch.sp_k_end, batch.sp_apply, batch.sp_rann)

    def solve(*t):
        grid, dyn, bar = CNGrid(*t[:2]), CNDynamics(*t[2:8]), BarrierSpec(*t[8:15])
        if mixed:
            return spectral_solve_mixed(grid, dyn, *t[15:18], n_nodes, t[18], barrier=bar, plan=plan)
        return spectral_solve(
            grid, dyn, *t[15:18], n_nodes, t[18], barrier=bar, plan=plan,
            mm_dtype=torch.float64 if solver == "spectral_x64dst" else None,
        )

    if not graph:
        return solve(*tensors)
    if solver == "spectral":  # a replay launches no matmul from here: check first
        require_full_float32(batch.x_min.dtype, batch.x_min.device)
    key = (solver, n_nodes, tuple(plan), tuple((t.shape, t.dtype, t.device) for t in tensors))
    graph_keys = set() if graph_keys is None else graph_keys
    new_call = key not in graph_keys
    graph_keys.add(key)
    return run_graphed(key, solve, tensors, new_call)


def _resolve_dv_sigma(dv_sigma, sigma: torch.Tensor) -> float:
    """Dtype-aware one-sided vega bump step (used when ``dv_sigma=None``).

    The bump differences two full solves, so the step must clear the
    solver's own noise floor: 1e-4 at f64 (solve noise ~1e-12); one full
    vol point, 1e-2, at f32, whose solve carries ~1e-4 relative price
    noise that a 1e-4 bump would amplify 1e4x into the vega."""
    if dv_sigma is not None:
        return dv_sigma
    return 1e-4 if sigma.dtype == torch.float64 else 1e-2


_SPIKE_SOLVERS = ("spike", "spike_df64")
_SPECTRAL_SOLVERS = ("spectral", "spectral_x64dst", "spectral_mixed")
SOLVERS = ("auto", "scan") + _SPIKE_SOLVERS + _SPECTRAL_SOLVERS


def _check_greeks_mode(greeks_mode: str) -> None:
    if greeks_mode not in ("bump", "ad"):
        raise ValueError(f"unknown greeks_mode {greeks_mode!r}")


def _spike_values(batch: BarrierTradeBatch, n_nodes: int, spike_segments, american: bool,
                  sigmas, preps=None) -> List[torch.Tensor]:
    """V (B, N) of the SPIKE solve (``spike.cn_barrier_solve_spike``) at
    each of ``sigmas``. ``spike_segments`` is the tuple from
    :func:`_spike_schedule_impl`, None meaning the uniform-dt default; the
    barrier march ignores its dividend and reset columns, as the barrier
    scan does. ``preps`` are the driver's, one per sigma
    (:func:`_guarded_spike_preps`); without them each solve makes its own
    prep, which raises where the interface guard refuses it."""
    seg, sd, div_steps, reset_steps = (
        spike_segments if spike_segments is not None else (None, None, (), ())
    )
    if not american:
        div_steps, reset_steps = (), ()
    preps = preps if preps is not None else [None] * len(sigmas)
    return [
        cn_barrier_solve_spike(
            batch, sig, n_nodes=n_nodes, n_steps=batch.n_steps, segments=seg, set_defs=sd,
            american=american, div_steps=div_steps, reset_steps=reset_steps, prep=prep,
        )
        for sig, prep in zip(sigmas, preps)
    ]


def _guarded_spike_preps(batch: BarrierTradeBatch, n_nodes: int, spike_segments,
                         american: bool, sigmas, strict: bool = False):
    """The SPIKE prep at each of ``sigmas`` (``spike.prepare_spike`` at the
    rule's P), or None as soon as the interface guard refuses one (with
    ``strict``, ValueError instead): then the call's solves all take another
    route, so that the price and its vega come from one discretisation."""
    preps = []
    for sig in sigmas:
        prep = prepare_spike(batch, sig, n_nodes, None, spike_segments[1], american, strict=strict)
        if prep is None:
            return None
        preps.append(prep)
    return preps


def _march_inputs(batch: BarrierTradeBatch, sigmas, solver: str):
    """The batch and sigmas a SPIKE route marches: ``"spike_df64"`` marches
    a float32 batch as its float64 cast (the K2 kernel)."""
    if solver == "spike_df64":
        return batch.astype(torch.float64), [s.to(torch.float64) for s in sigmas]
    return batch, sigmas


def _no_ad_rule(solver: str) -> ValueError:
    return ValueError(
        f"solver={solver!r} has no AD rule (the SPIKE march is a hand-written "
        "kernel); use greeks_mode='bump'"
    )


def _solve_values(batch: BarrierTradeBatch, n_nodes: int, solver: str, american: bool, sigmas,
                  spike_segments=None, spike_preps=None, with_dividends: bool = True,
                  ad: bool = False, graph_keys: Optional[set] = None) -> List[torch.Tensor]:
    """V (B, N) at each of ``sigmas`` on ``solver``'s route; with ``ad``,
    ``[V, dV/dsigma]`` at ``sigmas[0]`` instead, from one ``torch.func.jvp``
    through the scan or the spectral solve (the tangent flows through the
    dynamics coefficients only, as the bump's does: the grid is fixed).

    ``"spike_df64"`` is the SPIKE march at float64 whatever the batch's
    dtype: a float32 batch is solved as its float64 cast (the K2 kernel),
    and its outputs are cast back to float32 by :func:`_outputs_of`.
    ``graph_keys``: see :func:`_solve_spectral`."""
    if solver in _SPIKE_SOLVERS:
        if ad:
            raise _no_ad_rule(solver)
        batch, sigmas = _march_inputs(batch, sigmas, solver)
        return _spike_values(batch, n_nodes, spike_segments, american, sigmas, spike_preps)
    if american:
        solve = lambda sg: _solve_scan_american(batch, sg, n_nodes, with_dividends)[0]
    elif solver == "scan":
        solve = lambda sg: _solve_scan(batch, sg, n_nodes)[0]
    elif ad:
        solve = lambda sg: _solve_spectral(batch, sg, n_nodes, solver)[0]
    else:
        # the call's first solve is its sighting of the graph key; the vega
        # bump's solve follows it (spectral.run_graphed)
        graph_keys = set() if graph_keys is None else graph_keys
        return [_solve_spectral(batch, sg, n_nodes, solver, batch.x_min.is_cuda, graph_keys)[0]
                for sg in sigmas]
    if ad:
        return list(torch.func.jvp(solve, (sigmas[0],), (torch.ones_like(sigmas[0]),)))
    return [solve(sg) for sg in sigmas]


def _vol_points(batch: BarrierTradeBatch, dv_sigma, with_greeks: bool, greeks_mode: str = "bump"):
    """(the vega bump, the sigmas a call solves at): the batch's, and with
    bump greeks the bumped copy. The driver makes them once per call and
    passes them to every kernel call."""
    dv_sigma = _resolve_dv_sigma(dv_sigma, batch.sigma)
    bump = with_greeks and greeks_mode == "bump"
    return dv_sigma, [batch.sigma] + ([batch.sigma + dv_sigma] if bump else [])


def _outputs_of(batch: BarrierTradeBatch, n_nodes: int, values, dv_sigma: float,
                with_theta: bool, tangent: bool = False) -> Dict[str, torch.Tensor]:
    """Price and greeks from ``values``: V (B, N) at the sigmas of
    :func:`_vol_points`, or with ``tangent`` ``[V, dV/dsigma]``.

    Delta/gamma come from the non-uniform central stencil at spot; theta
    (``with_theta``) from the BS PDE identity
    (discrete_barrier_fdm_pricer.py:843-870); vega from the reference's
    one-sided sigma bump, a second full solve at sigma+dv
    (fd_american_equity.py:1014-1035), or with ``tangent`` from the exact
    derivative (the price's interpolation weights do not depend on sigma).

    The post-processing (interpolation, stencil, theta identity, vega
    difference) runs at float64 on node positions recomputed at float64 from
    the grid parameters, whatever the solve's dtype, and the outputs are cast
    back to the batch's. At float32 the rounded nodes (about 1.3e-5 at S ~ 220, with
    node spacing ~0.4 at N=1024) are otherwise amplified by the second
    difference to ~1e-2 of gamma and theta. At float64 this is the JAX
    package's arithmetic unchanged: the nodes are the solver's own.
    """
    dtype = batch.sigma.dtype
    f64 = lambda x: x.to(torch.float64)
    i = torch.arange(n_nodes, dtype=torch.float64, device=batch.x_min.device)
    s = torch.exp(f64(batch.x_min)[:, None] + i[None, :] * f64(batch.dx)[:, None])
    spot = f64(batch.spot)

    v = f64(values[0])
    price = linear_interp(f64(batch.s_eff), s, v)
    out = {"price": price}
    if len(values) > 1:
        second = linear_interp(f64(batch.s_eff), s, f64(values[1]))
        out["vega"] = second / 100.0 if tangent else (second - price) / (dv_sigma * 100.0)
        delta, gamma = nonuniform_central(s, v, nearest_index(s, spot, lo=1, hi_offset=1))
        out["delta"] = delta
        out["gamma"] = gamma
        if with_theta:
            out["theta"] = -(
                0.5 * f64(batch.sigma) ** 2 * spot**2 * gamma
                + (f64(batch.b) - f64(batch.q)) * spot * delta
                - f64(batch.r) * price
            )
    return {k: x.to(dtype) for k, x in out.items()}


def price_batch_kernel(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    greeks_mode: str = "bump",
    solver: str = "scan",
    spike_segments=None,
    spike_preps=None,
    vol_points=None,
    graph_keys: Optional[set] = None,
) -> Dict[str, torch.Tensor]:
    """Barrier batch on one device -> dict of (B,) tensors on that device:
    price, and with greeks vega, delta, gamma and theta (see :func:`_outputs_of`).

    ``solver``: ``"scan"``, ``"spike"`` / ``"spike_df64"`` (the SPIKE march,
    the CUDA kernel on a card; ``spike_segments`` the ``(segments, set_defs,
    ...)`` tuple from :func:`_spike_schedule_impl`, None meaning the
    uniform-dt default; ``spike_preps`` the auto route's preps), or one of
    the spectral names (needs the batch's ``sp_*`` layout; see
    :func:`_solve_spectral`). ``greeks_mode="ad"`` takes vega from one jvp
    through the scan or the spectral solve, and raises ValueError on the
    SPIKE route. ``vol_points``: the driver's :func:`_vol_points`;
    ``graph_keys``: the driver call's (:func:`_solve_spectral`).
    """
    _check_greeks_mode(greeks_mode)
    ad = with_greeks and greeks_mode == "ad"
    dv_sigma, sigmas = vol_points or _vol_points(batch, dv_sigma, with_greeks, greeks_mode)
    with tracing.span("batch.march"):
        values = _solve_values(batch, n_nodes, solver, False, sigmas, spike_segments, spike_preps,
                               ad=ad, graph_keys=graph_keys)
    with tracing.span("batch.greeks"):
        return _outputs_of(batch, n_nodes, values, dv_sigma, with_theta=True, tangent=ad)


def american_batch_kernel(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    greeks_mode: str = "bump",
    solver: str = "scan",
    spike_segments=None,
    with_dividends: bool = True,
    spike_preps=None,
    vol_points=None,
) -> Dict[str, torch.Tensor]:
    """American batch on one device -> dict of (B,) tensors: price, and
    with greeks vega, delta and gamma (no theta, as in the JAX package).

    ``solver="spike"`` / ``"spike_df64"`` runs the American SPIKE march (the
    CUDA kernel on a card), with the dividend jumps and lambda resets between
    launches from ``spike_segments``; ``with_dividends`` affects only the
    scan, which then applies the spline jump inside its step loop.
    ``greeks_mode="ad"`` takes vega from one jvp through the scan (the
    Ikonen–Toivanen projection's ``where`` carries the subgradient).
    """
    _check_greeks_mode(greeks_mode)
    ad = with_greeks and greeks_mode == "ad"
    dv_sigma, sigmas = vol_points or _vol_points(batch, dv_sigma, with_greeks, greeks_mode)
    with tracing.span("batch.march"):
        values = _solve_values(batch, n_nodes, solver, True, sigmas, spike_segments, spike_preps,
                               with_dividends, ad=ad)
    with tracing.span("batch.greeks"):
        return _outputs_of(batch, n_nodes, values, dv_sigma, with_theta=False, tangent=ad)


def _interval_layout(monitor: torch.Tensor, n_iv: int):
    """(k_end (B, n_iv), apply_proj (B, n_iv)) of :func:`spectral.spectral_intervals`,
    made where ``monitor`` lives: the j-th monitor step of a trade ends its
    interval j; the rest of the row repeats n_steps with no projection."""
    B, n = monitor.shape
    rank = torch.cumsum(monitor.long(), dim=1) - 1
    cols = torch.where(monitor, rank, torch.full_like(rank, n_iv))  # column n_iv is dropped
    steps = torch.arange(1, n + 1, device=monitor.device).expand(B, n)
    k_end = torch.full((B, n_iv + 1), n, dtype=torch.long, device=monitor.device)
    k_end = k_end.scatter(1, cols, steps)[:, :n_iv]
    apply_proj = torch.arange(n_iv, device=monitor.device)[None, :] < monitor.sum(dim=1, keepdim=True)
    return k_end, apply_proj


def _spectral_layout(batch: BarrierTradeBatch, n_nodes: int):
    """(sp_k_end, sp_apply, sp_rann, sp_dt) on the batch's device if the
    batch is spectral-eligible, else None (:func:`_spectral_verdict`)."""
    return _spectral_verdict(batch, n_nodes)[0]


def _spectral_verdict(batch: BarrierTradeBatch, n_nodes: int):
    """(the layout of :func:`_spectral_layout` or None, guarded): the JAX
    package's ``_spectral_layout_impl`` with its verdicts and thresholds;
    ``guarded`` is True where one of the numerical guards (a and c
    positive, the symmetrizer exponent, the channels' conditioning) refused
    a batch whose schedule the closed form fits.

    Eligibility is the schedule shape the closed form assumes (dt constant
    within each monitor interval: globally uniform or monitor-aligned;
    thetas 1.0 or 0.5 with the 1.0 steps a prefix; no dividend jumps),
    |dx mu / sigma^2| < 0.999 (a and c positive), a symmetrizer exponent
    within 200 at float64 and 15 at float32 (the batch's dtype is the
    working dtype) and boundary channels conditioned above 1e-9.
    ``sp_dt`` is None for globally uniform dt (the hoisted branch), also
    where every interval's dt is within 1e-12 of the first step's.

    The (B, n_steps) reductions run where the batch lives; only flags, the
    interval count and (B,) vectors come to the host (pulling the whole
    schedule costs tens of ms per call on a card). Not memoized: torch
    tensors are mutable.
    """
    dt, th, mon = batch.dt.double(), batch.theta.double(), batch.monitor
    n = dt.shape[1]
    is_one = th == 1.0
    R = is_one.sum(dim=1)
    any_one = is_one.any(dim=1)
    # the theta=1 steps form a prefix (argmax of the first theta != 1; a
    # row of theta=1 only fails, as in the JAX package)
    first_half = torch.where(any_one, torch.argmax((~is_one).to(torch.uint8), dim=1), 0)
    flags = torch.stack([
        (batch.div_amount != 0).any(),
        ((th == 1.0) | (th == 0.5)).all(),
        ((~any_one) | (first_half == R)).all(),
        (dt == dt[:, :1]).all(),
        # steps k-1 and k share an interval unless a monitor ends step k-1
        ((dt[:, 1:] == dt[:, :-1]) | mon[:, :-1]).all(),
    ]).long()
    n_iv = (mon.sum(dim=1) + (~mon[:, -1]).long()).max()
    has_div, theta_ok, prefix_ok, uniform, within, n_iv = torch.cat([flags, n_iv[None]]).tolist()
    if has_div or not theta_ok or not prefix_ok:
        return None, False
    sigma, b, q, r, dx, dt0 = (
        torch.stack([batch.sigma, batch.b, batch.q, batch.r, batch.dx, batch.dt[:, 0]])
        .double().cpu().numpy()
    )
    mu_x = b - q - 0.5 * sigma**2
    if np.any(np.abs(dx * mu_x / sigma**2) >= 0.999):  # a, c > 0 (sine diagonalization)
        return None, True
    limit = 200.0 if batch.sigma.dtype == torch.float64 else 15.0
    if np.any(symmetrizer_exponent(sigma, b, q, dx, n_nodes) > limit):
        return None, True
    k_end, apply_proj = _interval_layout(mon, n_iv)
    sp_dt = None
    if not uniform:
        if not within:
            return None, False
        k_start = torch.cat([torch.zeros_like(k_end[:, :1]), k_end[:, :-1]], dim=1)
        # a padded interval starts at n_steps and repeats the last dt
        per_iv = torch.gather(dt, 1, k_start.clamp(max=n - 1))
        if not bool(((per_iv - dt[:, :1]).abs() <= 1e-12 * dt[:, :1].abs()).all()):
            sp_dt = per_iv
    cond_dts = dt0[:, None] if sp_dt is None else sp_dt.cpu().numpy()
    for col in range(cond_dts.shape[1]):
        if np.any(channel_conditioning(sigma, b, q, r, dx, cond_dts[:, col], n_nodes) < 1e-9):
            return None, True
    return (k_end, apply_proj, R, None if sp_dt is None else sp_dt.to(batch.dt.dtype)), False


def _spike_schedule_impl(batch: BarrierTradeBatch, n_nodes: int):
    """Static SPIKE segmentation of the batch, or None if ineligible.

    The march runs one launch per run of steps sharing a (theta, dt) pair,
    so any piecewise-constant schedule fits: uniform layouts, the
    monitor-aligned per-interval-dt layouts and the American dividend
    segments. Eligibility:

    - theta pattern shared across trades with values in {1.0, 0.5} (dt
      values may differ per trade; only the step indices where any trade's
      dt changes must be shared),
    - at most :data:`SPIKE_MAX_SEGMENTS` runs,
    - a grid the port's SPIKE partitioning admits for some P
      (:func:`spike.spike_p`, whose choice of P also depends on the batch
      size; eligibility does not).

    Returns ``(segments, set_defs, div_steps, reset_steps)``: segments
    ``((k0, k1, set_idx), ...)``, set_defs ``((theta, k_col), ...)``
    deduplicated by (theta, dt-column); the dividend and lambda-reset break
    columns as the JAX package reports them (the American march applies its
    jumps and resets there; the barrier march ignores them, as the barrier
    scan does).
    """
    if spike_p(n_nodes, batch.batch_size) is None:
        return None
    # the (B, n_steps) comparisons run where the batch lives; only
    # (n_steps,) reductions come to the host (pulling the whole schedule
    # cost ~50 ms per call at B=4096 x 512 steps with the batch on an H100)
    host = lambda x: x.detach().cpu().numpy()
    th, dt = batch.theta, batch.dt
    if not bool((th == th[:1]).all()):
        return None
    th0 = host(th[0]).astype(float)
    if not np.all((th0 == 1.0) | (th0 == 0.5)):
        return None
    n = dt.shape[1]
    # dividend jumps fire at the END of their step -> the step after is a
    # segment start; lambda resets apply BEFORE their step
    div_steps = tuple(int(k) for k in np.flatnonzero(host((batch.div_amount != 0).any(dim=0))))
    reset_cols = host(batch.reset_lambda.any(dim=0))
    reset_steps = tuple(int(k) for k in np.flatnonzero(reset_cols) if k > 0)
    event_breaks = {k + 1 for k in div_steps if k + 1 < n}
    event_breaks.update(reset_steps)
    col_change = th0[1:] != th0[:-1]
    if dt.shape[0] > 0:
        col_change = col_change | host((dt[:, 1:] != dt[:, :-1]).any(dim=0))
    break_set = set((np.flatnonzero(col_change) + 1).tolist())
    break_set |= event_breaks
    breaks = [0] + sorted(break_set - {0})
    if len(breaks) > SPIKE_MAX_SEGMENTS:
        return None
    breaks.append(n)
    set_defs: List[Tuple[float, int]] = []
    segments = []
    for k0, k1 in zip(breaks[:-1], breaks[1:]):
        idx = None
        for i, (t_i, kc_i) in enumerate(set_defs):
            if t_i == th0[k0] and torch.equal(dt[:, kc_i], dt[:, k0]):
                idx = i
                break
        if idx is None:
            set_defs.append((float(th0[k0]), int(k0)))
            idx = len(set_defs) - 1
        segments.append((int(k0), int(k1), idx))
    return tuple(segments), tuple(set_defs), div_steps, reset_steps


def _spike_eligible(batch: BarrierTradeBatch, n_nodes: int) -> bool:
    """True when the batch fits the SPIKE march's schedule family."""
    return _spike_schedule_impl(batch, n_nodes) is not None


def _auto_inputs(batch: BarrierTradeBatch, american: bool, with_greeks: bool, greeks_mode: str):
    """What :func:`auto_solver` reads of a call besides the device and the
    SPIKE verdicts."""
    return dict(
        spectral_ok=batch.sp_k_end is not None, american=american,
        float64=batch.sigma.dtype == torch.float64, ad=with_greeks and greeks_mode == "ad",
    )


def _run_batch_driver(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float],
    with_greeks: bool,
    max_chunk: Optional[int],
    greeks_mode: str = "bump",
    solver: str = "scan",
    spike_segments=None,
    american: bool = False,
    mesh=None,
    axis_name: str = "data",
    **kernel_kw,
) -> Dict[str, torch.Tensor]:
    """The driver: :func:`american_batch_kernel` (``american``) or
    :func:`price_batch_kernel` over the batch, on its device or split over
    axis ``axis_name`` of ``mesh``; ``kernel_kw`` goes to every call. The
    sigmas of the call (:func:`_vol_points`) are made once here and sliced
    per shard and chunk.

    Under a mesh the batch is padded to a multiple of the axis's size with
    clones of its first trade and split into equal shards, shard i copied
    to the axis's i-th device (the JAX package's ``shard_map`` rule without
    its 128-trade multiple). The route, the SPIKE segmentation and the
    spectral layout come from the whole batch (:func:`_route`), and so do
    the SPIKE preps (:func:`_guarded_spike_preps`, at the whole batch's P):
    a prep is per trade, so each shard marches its rows of them
    (``SpikePrep.map_trades``), bit for bit the unsharded march of its
    trades. Each shard's work is issued
    to its device in turn from this thread, and the outputs are gathered in
    trade order on the batch's device, the padding dropped: a caller sees
    the same dict of (B,) tensors with or without a mesh. Without one the
    batch is its one shard.

    Chunking bounds the scan's per-step working set (its (B, N) temporaries
    per doubling pass): the scan runs each shard in chunks of ``max_chunk``
    trades. The SPIKE march keeps each trade's grid in shared memory and
    streams its solver tensors, so the spike route runs a shard as one
    launch per segment; the spectral route also runs it in one pass (about
    30 (B, M) tensors: under 1 GB at B=4096, N=1024, float64), since each
    chunk would repeat its ~1000 launches per solve.

    The SPIKE routes make the preps of every sigma of the call first.
    ``solver="auto"`` (from :func:`_route`: the rule picked the SPIKE march
    on CUDA) leaves the route to the interface guard: the preps are not
    strict, and :func:`auto_solver` reads their verdict; where the guard
    refused one, the whole call takes the scan. An explicit SPIKE solver
    raises there.

    The caller's ``batch.driver`` span, while it records, gets the route
    taken (``route``) and ``guard_refused`` True where the interface guard
    refused the preps that ``"auto"`` asked for. One kernel call records
    its ``batch.march`` and ``batch.greeks``; a call split into chunks or
    shards is one ``batch.solve`` span over all of them, in which no kernel
    call records. A call over more than one shard records the split's own
    layer inside it (:func:`tracing.inside`): all shards' copies first, one
    ``batch.shard_copy`` a shard (``device``: its index, ``rows``, and
    ``bytes``: what crossed from the batch's device to another), then one
    ``batch.shard`` a shard (the host issuing its kernel calls;
    ``device``), then one ``batch.gather`` (``bytes``: the outputs that
    crossed to the batch's device). A call in chunks records nothing inside.
    """
    kernel = american_batch_kernel if american else price_batch_kernel
    rec = tracing.current("batch.driver")
    dv_sigma, sigmas = _vol_points(batch, dv_sigma, with_greeks, greeks_mode)
    B, home = batch.batch_size, batch.x_min.device
    preps = None
    if solver in ("auto",) + _SPIKE_SOLVERS:
        march_batch, march_sigmas = _march_inputs(batch, sigmas, solver)
        with tracing.span("batch.spike_prep"):
            preps = _guarded_spike_preps(march_batch, n_nodes, spike_segments, american,
                                         march_sigmas, strict=solver != "auto")
        if solver == "auto":
            solver = auto_solver(home.type, spike_segments, preps is not None,
                                 **_auto_inputs(batch, american, with_greeks, greeks_mode))
            if rec is not None and preps is None:
                rec.attrs["guard_refused"] = True
    if rec is not None:
        rec.attrs["route"] = solver
        rec.attrs.setdefault("guard_refused", False)
    if not american:
        kernel_kw["graph_keys"] = set()
    devices = (home,) if mesh is None else mesh.axis_devices(axis_name)
    pad = pad_to_multiple(B, len(devices)) - B
    n = (B + pad) // len(devices)
    padded = pad_batch(batch, pad)
    padded_sigmas = [_pad_rows(s, pad) for s in sigmas]
    padded_preps = preps and [p.map_trades(lambda x, dim: _pad_rows(x, pad, dim)) for p in preps]
    chunk = max_chunk if solver == "scan" else None
    sharded = len(devices) > 1
    split = sharded or (chunk is not None and n > chunk)
    shards, outs = [], []
    with tracing.covering("batch.solve") if split else nullcontext():
        # every shard's rows are queued before any shard's work: a copy runs
        # on the home card's stream, so one queued behind the home shard's
        # kernels would hold its card idle until they end
        for i, dev in enumerate(devices):
            with (tracing.inside("batch.shard_copy", device=dev.index, rows=n) if sharded
                  else nullcontext()) as part:
                shards.append(_shard_rows(padded, padded_sigmas, padded_preps, i * n, n, dev, part))
        for dev, (b, sg, prep) in zip(devices, shards):
            run = lambda sl: kernel(
                b[sl], n_nodes, dv_sigma=dv_sigma, with_greeks=with_greeks,
                greeks_mode=greeks_mode, solver=solver, spike_segments=spike_segments,
                spike_preps=prep, vol_points=(dv_sigma, [s[sl] for s in sg]), **kernel_kw,
            )
            with tracing.inside("batch.shard", device=dev.index) if sharded else nullcontext(), \
                    on_device(dev):
                if chunk is None or n <= chunk:
                    outs.append(run(slice(None)))
                else:
                    pieces = [run(slice(start, start + chunk)) for start in range(0, n, chunk)]
                    outs.append({k: torch.cat([p[k] for p in pieces]) for k in pieces[0]})
        if mesh is None:
            return outs[0]
        with (tracing.inside("batch.gather") if sharded else nullcontext()) as part:
            if part is not None:
                part.attrs["bytes"] = sum(v.nbytes for o in outs for v in o.values() if v.device != home)
            return {k: torch.cat([o[k].to(home) for o in outs])[:B] for k in outs[0]}


def _shard_rows(batch: BarrierTradeBatch, sigmas, preps, start: int, n: int, device, rec=None):
    """Rows ``start:start + n`` of ``batch``, of each of ``sigmas`` and of
    each SPIKE prep of ``preps`` (or None), copied to ``device``
    (contiguous). ``rec``, a ``batch.shard_copy`` record, gets ``bytes``:
    those of the copies that crossed to another device."""
    moved = []

    def rows(x, dim=0):
        y = x.narrow(dim, start, n).to(device).contiguous()
        if rec is not None and y.device != x.device:
            moved.append(y.nbytes)
        return y

    out = batch._map(rows), [rows(s) for s in sigmas], preps and [p.map_trades(rows) for p in preps]
    if rec is not None:
        rec.attrs["bytes"] = sum(moved)
    return out


def auto_solver(
    device_type: str,
    spike_segments,
    guard_passed: bool,
    *,
    spectral_ok: bool = False,
    american: bool = False,
    float64: bool = False,
    ad: bool = False,
) -> str:
    """The route of ``solver="auto"``.

    - Off CUDA, the JAX package's CPU rule: ``"spectral"`` where the layout
      admits the batch (``spectral_ok``, :func:`_spectral_layout`), at any
      dtype, else ``"scan"``; the American path takes the scan.
    - On CUDA, the JAX package's accelerator rule, which the card's timings
      bear out (``chip_smoke.py``'s ``route_sweep``, PERF.md): a float64
      barrier batch takes the spectral propagator where the layout admits
      it, else the SPIKE march (at ``double``), else the scan; a float32
      batch takes the SPIKE march, else the scan, never the spectral
      propagator (at float32 it misses the f32 limits: its DSTs round at
      the knocked-out region's residual norm). The SPIKE march is taken
      only where the batch is SPIKE-eligible (``spike_segments`` not None)
      and the interface guard passed (``guard_passed``, read from the
      float64 preps of every sigma of the call before any launch). The
      American path takes the SPIKE march where it may, else the scan.
      At float64 and 4096 trades the card's timings do not separate the
      SPIKE march from the spectral propagator (the SPIKE call's host-bound
      prep varies with the host), and the rule keeps the JAX package's
      spectral there; below, the spectral propagator is 1.4-3x faster.

    ``ad`` (``greeks_mode="ad"`` with greeks) keeps the call off SPIKE,
    which has no AD rule. A choice of route, like the JAX package's: an
    explicit ``solver`` still raises where its route refuses the batch.
    The fused K3 march is never the auto route, as the JAX package's auto
    never takes its fused Pallas kernel.
    """
    if device_type != "cuda":
        return "spectral" if spectral_ok and not american else "scan"
    if float64 and spectral_ok and not american:
        return "spectral"
    return "spike" if spike_segments is not None and guard_passed and not ad else "scan"


def _route(batch: BarrierTradeBatch, n_nodes: int, max_chunk, dtype, solver: str, device,
           american: bool = False, with_greeks: bool = False, greeks_mode: str = "bump"):
    """The batch on its device and dtype, with its spectral layout attached
    where it has one, and the route: ``(batch, max_chunk, solver,
    spike_segments, guarded)``, where ``guarded`` is True when a numerical
    guard of :func:`_spectral_verdict` refused the batch's spectral layout
    (:func:`_guard_refused` says whether ``"auto"`` lost the route it prefers).

    ``"auto"`` stays ``"auto"`` where :func:`auto_solver` picks the SPIKE
    march, whose verdict the interface guard gives in
    :func:`_run_batch_driver`, and becomes the rule's route otherwise. An
    explicit route that refuses the batch raises ValueError, as the JAX
    package's does: SPIKE on an ineligible schedule or with
    ``greeks_mode="ad"``, the spectral names on a layout that
    :func:`_spectral_layout` refuses or on an American batch, and
    ``"spectral_mixed"`` on a per-interval dt.
    ``dtype`` casts the batch's floating fields (float64 halves
    ``max_chunk``, the same working-set budget). The route is the whole
    batch's, under a mesh too.
    """
    dev = resolve_device(device)
    batch = batch.to(dev)
    if dtype is not None:
        batch = batch.astype(dtype)
        if max_chunk is not None and dtype.itemsize > 4:
            max_chunk = max(1, max_chunk // 2)
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of {SOLVERS}")
    _check_greeks_mode(greeks_mode)
    ad = with_greeks and greeks_mode == "ad"
    if ad and solver in _SPIKE_SOLVERS:
        raise _no_ad_rule(solver)
    if american and solver in _SPECTRAL_SOLVERS:
        raise ValueError(
            f"solver={solver!r} prices European barrier batches only (the "
            "Ikonen–Toivanen projection is not linear); use 'auto', 'scan' or 'spike'"
        )
    wants_spike = solver in _SPIKE_SOLVERS or (solver == "auto" and dev.type == "cuda" and not ad)
    sched = _spike_schedule_impl(batch, n_nodes) if wants_spike else None
    if solver in _SPIKE_SOLVERS and sched is None:
        raise ValueError(
            "batch is not spike-eligible (needs a piecewise-constant "
            "(theta, dt) schedule shared across trades — uniform, "
            "monitor-aligned or dividend-segmented layouts — and a grid the "
            "SPIKE partitioning admits); use solver='auto'"
        )
    layout, guarded = None, False
    if not american and solver in ("auto",) + _SPECTRAL_SOLVERS:
        layout, guarded = _spectral_verdict(batch, n_nodes)
        if layout is None and solver != "auto":
            raise ValueError(
                "batch is not spectral-eligible (needs per-interval-constant dt, "
                "Rannacher-prefix thetas, no dividend jumps, bounded symmetrizer "
                "exponent); use solver='auto' or 'scan'"
            )
        if solver == "spectral_mixed" and layout[3] is not None:
            raise ValueError(
                "spectral_mixed supports uniform dt only (the hoisted layout); "
                "use solver='auto'/'spectral' for monitor-aligned schedules"
            )
    batch = replace(batch, **dict(zip(SP_FIELDS, layout or (None,) * len(SP_FIELDS))))
    if solver == "auto":
        route = auto_solver(dev.type, sched, True,
                            **_auto_inputs(batch, american, with_greeks, greeks_mode))
        if route != "spike":
            solver = route
    return batch, max_chunk, solver, sched, guarded


def _guard_refused(batch: BarrierTradeBatch, sched, with_greeks: bool, greeks_mode: str) -> bool:
    """True where ``"auto"``'s rule would take the spectral route had the
    guard of :func:`_spectral_verdict` not refused the routed barrier batch."""
    inputs = dict(_auto_inputs(batch, False, with_greeks, greeks_mode), spectral_ok=True)
    return auto_solver(batch.x_min.device.type, sched, True, **inputs) == "spectral"


def price_barrier_batch(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    mesh=None,
    axis_name: str = "data",
    max_chunk: Optional[int] = 1024,
    dtype: Optional[torch.dtype] = None,
    greeks_mode: str = "bump",
    solver: str = "auto",
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Price a trade batch on ``device``: dict of (B,) tensors
    (price, and with greeks vega, delta, gamma, theta).

    ``solver``: ``"spike"`` the SPIKE march (the hand-written CUDA kernel
    on a card, its plain version on the CPU) and ``"spike_df64"`` the same
    march at float64 (see :func:`_solve_values`); ``"scan"`` the CN step
    loop; ``"spectral"``, ``"spectral_x64dst"``, ``"spectral_mixed"`` the
    sine-basis propagator (:func:`_solve_spectral`); ``"auto"`` (default)
    the rule of :func:`auto_solver` (the JAX package's CPU rule off CUDA,
    its accelerator rule on a card). ``greeks_mode="ad"`` takes vega from one jvp
    instead of the sigma bump (not on SPIKE). ``dtype`` casts the batch's
    floating fields first. ``max_chunk`` bounds the scan's chunks (float64
    halves it, the same working-set budget; None forces one pass); the
    SPIKE and spectral routes run the batch in one pass. ``mesh`` (a
    ``parallel.Mesh`` of ``device``'s type, from ``parallel.make_mesh``)
    splits the trades over its axis ``axis_name``, one shard per device,
    each shard chunked as the whole batch would be; the outputs come back
    on ``device`` (:func:`_run_batch_driver`). ``mesh`` may also be named as
    data, a device count or a list of device names
    (``parallel.mesh.check_mesh``); ValueError where its devices are not of
    ``device``'s type.
    """
    mesh = check_mesh(mesh, resolve_device(device))
    with tracing.span("batch.driver") as rec:
        with tracing.span("batch.route"):
            batch, max_chunk, solver, sched, guarded = _route(
                batch, n_nodes, max_chunk, dtype, solver, device,
                with_greeks=with_greeks, greeks_mode=greeks_mode,
            )
        if rec is not None and guarded:
            rec.attrs["guard_refused"] = _guard_refused(batch, sched, with_greeks, greeks_mode)
        return _run_batch_driver(
            batch, n_nodes, dv_sigma, with_greeks, max_chunk, greeks_mode,
            solver, sched, mesh=mesh, axis_name=axis_name,
        )


def price_american_batch(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    mesh=None,
    axis_name: str = "data",
    max_chunk: Optional[int] = 1024,
    dtype: Optional[torch.dtype] = None,
    greeks_mode: str = "bump",
    solver: str = "auto",
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Batched American sweep on ``device``: dict of (B,) tensors (price,
    and with greeks vega, delta, gamma).

    ``solver="auto"`` (default) takes the American SPIKE march — the
    hand-written CUDA kernel with the Ikonen–Toivanen projection fused into
    the step — for a SPIKE-eligible batch on CUDA, at float32 and at
    float64 alike, unless the interface guard refuses its SPIKE prep or
    ``greeks_mode="ad"`` asks for a jvp (:func:`auto_solver`), and the CN
    scan otherwise, as on the CPU. Dividend batches ride the march as extra
    segments, with the spline jump applied between launches. Mixed call/put
    dividend batches are not eligible (calls restart Rannacher after each
    dividend, so the theta pattern differs per trade) and take the scan, as
    in the JAX package. ``"spike_df64"`` is the march at float64
    (:func:`_solve_values`); the spectral names raise (European only).
    ``dtype``, ``max_chunk``, ``mesh``, ``axis_name``: as
    :func:`price_barrier_batch` (under a mesh the dividend jumps and
    lambda resets run per shard, between its launches).
    """
    mesh = check_mesh(mesh, resolve_device(device))
    with tracing.span("batch.driver"):
        with tracing.span("batch.route"):
            batch, max_chunk, solver, sched, _ = _route(
                batch, n_nodes, max_chunk, dtype, solver, device, american=True,
                with_greeks=with_greeks, greeks_mode=greeks_mode,
            )
        return _run_batch_driver(
            batch, n_nodes, dv_sigma, with_greeks, max_chunk, greeks_mode,
            solver, sched, american=True, mesh=mesh, axis_name=axis_name,
            with_dividends=_with_dividends(batch, sched),
        )


def _with_dividends(batch: BarrierTradeBatch, sched) -> bool:
    """Whether the American scan must apply the spline jump: read from the
    SPIKE segmentation's dividend columns where the route made one (no
    device work), else from the batch."""
    if sched is not None:
        return bool(sched[2])
    return bool((batch.div_amount != 0).any())


def _surface_route(batch: BarrierTradeBatch, n_nodes: int, solver: str, american: bool,
                   dtype, device):
    """The route of :func:`solve_value_surfaces`: ``(batch, solver,
    spike_segments, spike_preps)``, with ``"auto"`` resolved to the route
    it takes (the SPIKE march only where the interface guard passed)."""
    if american and solver not in ("auto", "scan"):
        raise ValueError("the American surface is the scan's; use solver='auto' or 'scan'")
    batch, _, solver, sched, _ = _route(
        batch, n_nodes, None, dtype, "scan" if american else solver, device, american=american,
    )
    preps = None
    if solver == "auto":
        preps = _guarded_spike_preps(batch, n_nodes, sched, False, [batch.sigma])
        solver = auto_solver(batch.x_min.device.type, sched, preps is not None,
                             **_auto_inputs(batch, False, False, "bump"))
    return batch, solver, sched, preps


def solve_value_surfaces(
    batch: BarrierTradeBatch,
    n_nodes: int,
    solver: str = "auto",
    american: bool = False,
    dtype: Optional[torch.dtype] = None,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, s): per-trade value functions over the grid, (B, n_nodes) each,
    on ``device``.

    The surface form of the batched solve, what an XVA engine's
    ``precompute`` hook wants (price an exotic once per scenario date,
    then interpolate simulated spots against the surface). A barrier batch
    takes the route :func:`price_barrier_batch` takes for a price-only call
    (``"auto"`` by :func:`auto_solver`, or any explicit solver name);
    ``american=True`` runs the Ikonen–Toivanen scan (``solver`` ``"auto"``
    or ``"scan"``: the per-step projection is inherently sequential, and
    the JAX package's surface takes the scan there too). V is in the
    batch's dtype (``"spectral_mixed"``'s float32 state excepted, as in the
    JAX package).
    """
    batch, solver, sched, preps = _surface_route(batch, n_nodes, solver, american, dtype, device)
    with_div = american and bool((batch.div_amount != 0).any())
    v = _solve_values(batch, n_nodes, solver, american, [batch.sigma], sched, preps, with_div)[0]
    i = torch.arange(n_nodes, dtype=batch.x_min.dtype, device=batch.x_min.device)
    s = torch.exp(batch.x_min[:, None] + i[None, :] * batch.dx[:, None])
    return (v if solver == "spectral_mixed" else v.to(batch.x_min.dtype)), s


def price_american_batch_richardson(
    *,
    n_nodes: int,
    n_time_steps: int,
    n_time_steps_fine: Optional[int] = None,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    mesh=None,
    axis_name: str = "data",
    max_chunk: Optional[int] = 1024,
    dtype: Optional[torch.dtype] = None,
    device=DEFAULT_DEVICE,
    **build_kwargs,
) -> Dict[str, torch.Tensor]:
    """Richardson-extrapolated batched American sweep: two batched solves,
    at ``n_time_steps`` and (default) twice that, combined as
    (4 P_fine - P_coarse)/3 per output, which cancels the leading O(dt^2)
    time-truncation term. ``build_kwargs`` go to :func:`build_american_batch`;
    ``mesh`` and ``axis_name`` to both solves (:func:`price_american_batch`).
    """
    fine = n_time_steps_fine or 2 * n_time_steps
    common = dict(
        n_nodes=n_nodes, dv_sigma=dv_sigma, with_greeks=with_greeks, mesh=mesh,
        axis_name=axis_name, max_chunk=max_chunk, dtype=dtype, device=device,
    )
    out_c = price_american_batch(
        build_american_batch(n_time_steps=n_time_steps, device=device, **build_kwargs), **common
    )
    out_f = price_american_batch(
        build_american_batch(n_time_steps=fine, device=device, **build_kwargs), **common
    )
    return {k: (4.0 * out_f[k] - out_c[k]) / 3.0 for k in out_f}
