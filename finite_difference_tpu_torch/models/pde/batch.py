"""Batched barrier and American PDE pricing — the port's main paths.

Counterpart of ``finite_difference_tpu.models.pde.batch`` for the barrier
and American sweeps: a struct-of-arrays batch of trades (each with its own
grid, dynamics, barrier or dividend schedule) priced in one pass, with the
price and bump greeks on the device.

    build_trade_batch -> price_barrier_batch -> _run_batch_driver
        -> price_batch_kernel -> spike.cn_barrier_solve_spike (CUDA kernel)
                              or stepper.cn_solve (solver="scan")
    build_american_batch -> price_american_batch -> _run_batch_driver
        -> american_batch_kernel -> spike.cn_barrier_solve_spike(american=True)
                                 or stepper.cn_solve(american=True)

Differences from the JAX package in this slice: single device only (no
mesh, no packed transfers); ``solver`` is ``"scan"`` or ``"spike"`` (the
spectral route comes later); ``greeks_mode="ad"`` raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields as dc_fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import native
from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.stencils import nonuniform_central
from .grid import (
    _PPF_99999,
    american_log_grid,
    barrier_log_grid,
    monitor_aligned_schedule,
    segmented_schedule,
    uniform_schedule,
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

    @property
    def batch_size(self) -> int:
        return self.x_min.shape[0]

    @property
    def n_steps(self) -> int:
        return self.dt.shape[1]

    def _map(self, fn) -> "BarrierTradeBatch":
        return BarrierTradeBatch(**{f.name: fn(getattr(self, f.name)) for f in dc_fields(self)})

    def to(self, device) -> "BarrierTradeBatch":
        return self._map(lambda x: x.to(device))

    def astype(self, dtype: torch.dtype) -> "BarrierTradeBatch":
        """Floating fields cast to ``dtype``; bool fields unchanged."""
        return self._map(lambda x: x.to(dtype) if x.is_floating_point() else x)

    def __getitem__(self, sl: slice) -> "BarrierTradeBatch":
        return self._map(lambda x: x[sl])


FIELD_NAMES = tuple(f.name for f in dc_fields(BarrierTradeBatch))


def batch_from_numpy(fields: Dict[str, np.ndarray], device=DEFAULT_DEVICE) -> BarrierTradeBatch:
    """The port's batch from numpy arrays keyed by field name.

    Carries state across from the JAX package: pass a JAX
    ``BarrierTradeBatch``'s fields (a barrier or an American batch) as
    numpy arrays. Keys the port's batch does not have (the JAX batch's
    spectral ``sp_*`` layout) are ignored.
    """
    dev = resolve_device(device)
    return BarrierTradeBatch(
        **{k: torch.as_tensor(np.asarray(fields[k])).to(dev) for k in FIELD_NAMES}
    )


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
    """
    dev = resolve_device(device)
    np_dtype = _NP_DTYPES[dtype]
    B = len(spots)
    if num_space_nodes is None:
        num_space_nodes = math.ceil(2.0 * _PPF_99999 * n_time_steps / 2.0)

    z = lambda v, d: np.asarray(v if v is not None else [d] * B)
    lower = z(lower, None)
    upper = z(upper, None)
    q = np.asarray(q if q is not None else np.zeros(B), dtype=np_dtype)
    rebate = np.asarray(rebate if rebate is not None else np.zeros(B), dtype=np_dtype)
    rebate_at_hit = np.asarray(
        rebate_at_hit if rebate_at_hit is not None else np.zeros(B, dtype=bool)
    )
    f = lambda v: np.asarray(v, dtype=np_dtype)
    has_lower = np.asarray([x is not None for x in lower])
    has_upper = np.asarray([x is not None for x in upper])
    lower_v = [x if x is not None else 0.0 for x in lower]
    upper_v = [x if x is not None else 0.0 for x in upper]
    arrays = dict(
        strike=f(strikes),
        is_call=np.asarray(is_call, dtype=bool),
        sigma=f(sigmas),
        r=f(r),
        b=f(b),
        q=q,
        lower=f(lower_v),
        upper=f(upper_v),
        has_lower=has_lower,
        has_upper=has_upper,
        rebate=rebate,
        rebate_at_hit=rebate_at_hit,
        rebate_rate=f(b),
        s_eff=f(spots),
        spot=f(spots),
    )

    if use_native and not monitor_aligned and native.available():
        x_min, dx = native.barrier_log_grids(
            spots, strikes, sigmas, t_expiry, lower_v, upper_v,
            has_lower, has_upper, num_space_nodes,
        )
        dt, theta, tau_next, monitor = native.uniform_schedules(
            t_expiry, n_time_steps, rannacher_steps, monitor_times
        )
        arrays.update(
            x_min=f(x_min), dx=f(dx), dt=dt.astype(np_dtype),
            theta=theta.astype(np_dtype), tau_next=tau_next.astype(np_dtype),
            monitor=monitor.astype(bool),
            div_amount=np.zeros((B, n_time_steps), dtype=np_dtype),
            reset_lambda=np.zeros((B, n_time_steps), dtype=bool),
        )
        return batch_from_numpy(arrays, dev)

    cols: Dict[str, List] = {k: [] for k in (
        "x_min", "dx", "dt", "theta", "tau_next", "monitor", "div_amount",
        "reset_lambda",
    )}
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
        cols["x_min"].append(g.x_min)
        cols["dx"].append(g.dx)
        if monitor_aligned:
            sch = monitor_aligned_schedule(
                float(t_expiry[i]), monitor_times[i],
                steps_per_interval=steps_per_interval,
                target_dt=float(t_expiry[i]) / n_time_steps,
                rannacher_steps=rannacher_steps,
            )
        else:
            sch = uniform_schedule(
                float(t_expiry[i]), n_time_steps, rannacher_steps,
                monitor_times[i],
            )
        for name in ("dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda"):
            cols[name].append(getattr(sch, name))

    arrays.update(x_min=f(cols["x_min"]), dx=f(cols["dx"]), **_stack_schedules(cols, np_dtype))
    return batch_from_numpy(arrays, dev)


def _stack_schedules(cols: Dict[str, List], np_dtype) -> Dict[str, np.ndarray]:
    """The (B, n_steps) schedule fields from per-trade rows."""
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
    """
    dev = resolve_device(device)
    np_dtype = _NP_DTYPES[dtype]
    f = lambda v: np.asarray(v, dtype=np_dtype)
    B = len(spots)
    dividends_tau = dividends_tau or [[] for _ in range(B)]
    spots = [float(x) for x in spots]
    strikes = [float(k) for k in strikes]
    n = int(n_time_steps)
    zB = np.zeros(B, dtype=np_dtype)
    fB = np.zeros(B, dtype=bool)
    arrays = dict(
        is_call=np.asarray(is_call, dtype=bool), sigma=f(sigmas), r=f(r), b=f(b),
        q=zB, lower=zB, upper=zB, has_lower=fB, has_upper=fB, rebate=zB,
        rebate_at_hit=fB, rebate_rate=f(b), monitor=np.zeros((B, n), dtype=bool),
    )

    if not any(len(d) for d in dividends_tau):
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
        dt = np.repeat((te / float(n))[:, None], n, axis=1)
        reset = np.zeros((B, n), dtype=bool)
        reset[:, 0] = True
        arrays.update(
            x_min=f(x_min), dx=f(dx), strike=f(st), sigma=f(sg), s_eff=f(sp), spot=f(sp),
            dt=dt.astype(np_dtype),
            theta=np.array(
                np.broadcast_to(np.where(np.arange(n) < rannacher_steps, 1.0, 0.5), (B, n)),
                dtype=np_dtype,
            ),
            tau_next=np.cumsum(dt, axis=1).astype(np_dtype),
            div_amount=np.zeros((B, n), dtype=np_dtype),
            reset_lambda=reset,
        )
        return batch_from_numpy(arrays, dev)

    if use_native and native.available():
        out = native.american_batches(
            spots, strikes, sigmas, t_expiry, [bool(c) for c in is_call],
            dividends_tau, n_time_steps, rannacher_steps, num_space_nodes,
            s_max_mult, snap_to_grid,
        )
        arrays.update(
            x_min=f(out["x_min"]), dx=f(out["dx"]), strike=f(out["strike"]),
            s_eff=f(out["spot"]), spot=f(out["spot"]),
            dt=out["dt"].astype(np_dtype), theta=out["theta"].astype(np_dtype),
            tau_next=out["tau_next"].astype(np_dtype),
            div_amount=out["div_amount"].astype(np_dtype),
            reset_lambda=out["reset_lambda"],
        )
        return batch_from_numpy(arrays, dev)

    cols: Dict[str, List] = {k: [] for k in (
        "x_min", "dx", "dt", "theta", "tau_next", "monitor", "div_amount",
        "reset_lambda",
    )}
    for i in range(B):
        g = american_log_grid(
            spots[i], strikes[i], float(sigmas[i]), float(t_expiry[i]),
            num_space_nodes, s_max_mult,
        )
        if snap_to_grid:
            snap = lambda lvl: math.exp(g.x_min + round((math.log(lvl) - g.x_min) / g.dx) * g.dx)
            spots[i] = snap(spots[i])
            strikes[i] = snap(strikes[i])
        cols["x_min"].append(g.x_min)
        cols["dx"].append(g.dx)
        sch = segmented_schedule(
            float(t_expiry[i]), n_time_steps, dividends_tau[i],
            rannacher_steps=rannacher_steps,
            restart_rannacher_at_div=bool(is_call[i]),
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

    arrays.update(
        x_min=f(cols["x_min"]), dx=f(cols["dx"]), strike=f(strikes),
        s_eff=f(spots), spot=f(spots), **_stack_schedules(cols, np_dtype),
    )
    return batch_from_numpy(arrays, dev)


def _solve_scan(batch: BarrierTradeBatch, sigma, n_nodes: int):
    """The CN scan over the whole batch; ``sigma`` may be bumped."""
    grid = CNGrid(batch.x_min, batch.dx)
    dyn = CNDynamics(
        strike=batch.strike, is_call=batch.is_call, sigma=sigma,
        r=batch.r, b=batch.b, q=batch.q,
    )
    bar = BarrierSpec(
        lower=batch.lower, upper=batch.upper,
        has_lower=batch.has_lower, has_upper=batch.has_upper,
        rebate=batch.rebate, rebate_at_hit=batch.rebate_at_hit,
        rebate_rate=batch.rebate_rate,
    )
    sch = CNSchedule(
        dt=batch.dt, theta=batch.theta, tau_next=batch.tau_next,
        monitor=batch.monitor, div_amount=batch.div_amount,
        reset_lambda=batch.reset_lambda,
    )
    return cn_solve(grid, dyn, sch, n_nodes, barrier=bar)


def _resolve_dv_sigma(dv_sigma, sigma: torch.Tensor) -> float:
    """Dtype-aware one-sided vega bump step (used when ``dv_sigma=None``).

    The bump differences two full solves, so the step must clear the
    solver's own noise floor: 1e-4 at f64 (solve noise ~1e-12); one full
    vol point, 1e-2, at f32, whose solve carries ~1e-4 relative price
    noise that a 1e-4 bump would amplify 1e4x into the vega."""
    if dv_sigma is not None:
        return dv_sigma
    return 1e-4 if sigma.dtype == torch.float64 else 1e-2


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Row-wise linear interpolation, ``jnp.interp`` semantics: x (B,),
    xp/fp (B, N) with xp ascending; values outside [xp0, xp_last] clamp
    to the end values."""
    n = xp.shape[1]
    i = torch.searchsorted(xp, x[:, None], right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(xp, 1, i - 1)[:, 0], torch.gather(xp, 1, i)[:, 0]
    f0, f1 = torch.gather(fp, 1, i - 1)[:, 0], torch.gather(fp, 1, i)[:, 0]
    f = f0 + ((x - x0) / (x1 - x0)) * (f1 - f0)
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def _solve_scan_american(batch: BarrierTradeBatch, sigma, n_nodes: int, with_dividends: bool):
    """The American CN scan (Ikonen–Toivanen, American put edge) over the
    whole batch; ``sigma`` may be bumped."""
    grid = CNGrid(batch.x_min, batch.dx)
    dyn = CNDynamics(
        strike=batch.strike, is_call=batch.is_call, sigma=sigma,
        r=batch.r, b=batch.b, q=batch.q,
    )
    sch = CNSchedule(
        dt=batch.dt, theta=batch.theta, tau_next=batch.tau_next,
        monitor=batch.monitor, div_amount=batch.div_amount,
        reset_lambda=batch.reset_lambda,
    )
    return cn_solve(
        grid, dyn, sch, n_nodes, barrier=None, american=True,
        with_dividends=with_dividends, euro_put_lower_boundary=False,
    )


def _check_greeks_mode(with_greeks: bool, greeks_mode: str) -> None:
    if with_greeks and greeks_mode == "ad":
        raise NotImplementedError("greeks_mode='ad' is not ported yet; use 'bump'")
    if greeks_mode not in ("bump", "ad"):
        raise ValueError(f"unknown greeks_mode {greeks_mode!r}")


def _spike_values(batch: BarrierTradeBatch, n_nodes: int, spike_segments, american: bool,
                  sigmas, preps=None) -> List[torch.Tensor]:
    """V (B, N) of the SPIKE solve (``spike.cn_barrier_solve_spike``) at
    each of ``sigmas``. ``spike_segments`` is the tuple from
    :func:`_spike_schedule_impl`, None meaning the uniform-dt default; the
    barrier march ignores its dividend and reset columns, as the barrier
    scan does. ``preps`` are the auto route's, one per sigma
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
                         american: bool, sigmas):
    """The SPIKE prep at each of ``sigmas`` (``spike.prepare_spike`` at the
    rule's P, not strict), or None as soon as the interface guard refuses
    one: then the call's solves all take another route, so that the price
    and its vega come from one discretisation."""
    preps = []
    for sig in sigmas:
        prep = prepare_spike(batch, sig, n_nodes, None, spike_segments[1], american, strict=False)
        if prep is None:
            return None
        preps.append(prep)
    return preps


def _vol_points(batch: BarrierTradeBatch, dv_sigma, with_greeks: bool):
    """(the vega bump, the sigmas a call solves at): the batch's, and with
    greeks the bumped copy."""
    dv_sigma = _resolve_dv_sigma(dv_sigma, batch.sigma)
    return dv_sigma, [batch.sigma] + ([batch.sigma + dv_sigma] if with_greeks else [])


def _outputs_of(batch: BarrierTradeBatch, n_nodes: int, values, dv_sigma: float,
                with_theta: bool) -> Dict[str, torch.Tensor]:
    """Price and bump greeks from ``values``, V (B, N) at the sigmas of
    :func:`_vol_points`.

    Delta/gamma come from the non-uniform central stencil at spot; theta
    (``with_theta``) from the BS PDE identity
    (discrete_barrier_fdm_pricer.py:843-870); vega from the reference's
    one-sided sigma bump, a second full solve at sigma+dv
    (fd_american_equity.py:1014-1035).

    The post-processing (interpolation, stencil, theta identity, vega
    difference) runs at float64 on node positions recomputed at float64 from
    the grid parameters, whatever the solve's dtype, and the outputs are cast
    back to it. At float32 the rounded nodes (about 1.3e-5 at S ~ 220, with
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
    price = _interp(f64(batch.s_eff), s, v)
    out = {"price": price}
    if len(values) > 1:
        v_up = f64(values[1])
        out["vega"] = (_interp(f64(batch.s_eff), s, v_up) - price) / (dv_sigma * 100.0)
        idx = torch.argmin(torch.abs(s - spot[:, None]), dim=1).clamp(1, n_nodes - 2)
        delta, gamma = nonuniform_central(s, v, idx)
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
) -> Dict[str, torch.Tensor]:
    """Barrier batch on one device -> dict of (B,) tensors on that device:
    price, and with greeks vega, delta, gamma and theta (see :func:`_outputs_of`).

    ``solver="spike"`` runs the SPIKE march (the CUDA kernel on a card);
    ``spike_segments`` is the ``(segments, set_defs, ...)`` tuple from
    :func:`_spike_schedule_impl`, None meaning the uniform-dt default;
    ``spike_preps`` the auto route's preps (:func:`_spike_values`).
    ``greeks_mode="ad"`` is not ported yet and raises NotImplementedError.
    """
    _check_greeks_mode(with_greeks, greeks_mode)
    dv_sigma, sigmas = _vol_points(batch, dv_sigma, with_greeks)
    if solver == "spike":
        values = _spike_values(batch, n_nodes, spike_segments, False, sigmas, spike_preps)
    elif solver == "scan":
        values = [_solve_scan(batch, sig, n_nodes)[0] for sig in sigmas]
    else:
        raise ValueError(f"unknown solver {solver!r}; expected 'scan' or 'spike'")
    return _outputs_of(batch, n_nodes, values, dv_sigma, with_theta=True)


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
) -> Dict[str, torch.Tensor]:
    """American batch on one device -> dict of (B,) tensors: price, and
    with greeks vega, delta and gamma (no theta, as in the JAX package).

    ``solver="spike"`` runs the American SPIKE march (the CUDA kernel on a
    card), with the dividend jumps and lambda resets between launches from
    ``spike_segments``; ``with_dividends`` affects only the scan, which
    then applies the spline jump inside its step loop.
    """
    _check_greeks_mode(with_greeks, greeks_mode)
    dv_sigma, sigmas = _vol_points(batch, dv_sigma, with_greeks)
    if solver == "spike":
        values = _spike_values(batch, n_nodes, spike_segments, True, sigmas, spike_preps)
    elif solver == "scan":
        values = [_solve_scan_american(batch, sig, n_nodes, with_dividends)[0] for sig in sigmas]
    else:
        raise ValueError(f"unknown solver {solver!r}; expected 'scan' or 'spike'")
    return _outputs_of(batch, n_nodes, values, dv_sigma, with_theta=False)


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
    **kernel_kw,
) -> Dict[str, torch.Tensor]:
    """Single-device driver: :func:`american_batch_kernel` (``american``) or
    :func:`price_batch_kernel` over the batch in chunks of ``max_chunk``
    trades; ``kernel_kw`` goes to every call.

    Chunking bounds the scan's per-step working set (its (B, N) temporaries
    per doubling pass). The SPIKE march keeps each trade's grid in shared
    memory and streams its solver tensors, so the spike route runs the
    whole batch as one launch per segment.

    ``solver="auto"`` (from :func:`_route`: a SPIKE-eligible batch on CUDA)
    leaves the route to the interface guard: the preps of every sigma of
    the call are made first, not strict, and :func:`auto_solver` reads
    their verdict. The spike route then marches those preps; the scan
    prices the whole call where the guard refused one.
    """
    kernel = american_batch_kernel if american else price_batch_kernel
    preps = None
    if solver == "auto":
        sigmas = _vol_points(batch, dv_sigma, with_greeks)[1]
        preps = _guarded_spike_preps(batch, n_nodes, spike_segments, american, sigmas)
        solver = auto_solver(batch.x_min.device.type, spike_segments, preps is not None)
    B = batch.batch_size
    chunk = None if solver == "spike" else max_chunk
    run = lambda piece: kernel(
        piece, n_nodes, dv_sigma=dv_sigma, with_greeks=with_greeks,
        greeks_mode=greeks_mode, solver=solver, spike_segments=spike_segments,
        spike_preps=preps, **kernel_kw,
    )
    if chunk is None or B <= chunk:
        return run(batch)
    pieces = [run(batch[start : start + chunk]) for start in range(0, B, chunk)]
    return {k: torch.cat([p[k] for p in pieces]) for k in pieces[0]}


def auto_solver(device_type: str, spike_segments, guard_passed: bool) -> str:
    """The route of ``solver="auto"``: ``"spike"`` for a SPIKE-eligible
    batch (``spike_segments`` from :func:`_spike_schedule_impl` not None) on
    CUDA whose SPIKE preps the interface guard passed at every sigma of the
    call (``spike.interface_refusal``, read from the float64 prep before any
    launch), else ``"scan"``. Like the JAX package's eligibility rule, a
    choice of route: an explicit ``solver="spike"`` still raises where the
    guard refuses."""
    spike = device_type == "cuda" and spike_segments is not None and guard_passed
    return "spike" if spike else "scan"


def _route(batch: BarrierTradeBatch, n_nodes: int, max_chunk, dtype, solver: str, device):
    """The batch on its device and dtype, and the route:
    ``(batch, max_chunk, solver, spike_segments)``.

    ``"auto"`` stays ``"auto"`` for a SPIKE-eligible batch on CUDA, whose
    route the interface guard decides in :func:`_run_batch_driver`, and is
    ``"scan"`` otherwise (:func:`auto_solver`); ``"spike"`` on an
    ineligible batch raises.
    ``dtype`` casts the batch's floating fields (float64 halves
    ``max_chunk``, the same working-set budget).
    """
    dev = resolve_device(device)
    batch = batch.to(dev)
    if dtype is not None:
        batch = batch.astype(dtype)
        if max_chunk is not None and dtype.itemsize > 4:
            max_chunk = max(1, max_chunk // 2)
    if solver not in ("auto", "scan", "spike"):
        raise ValueError(f"unknown solver {solver!r}; expected 'auto', 'scan' or 'spike'")
    sched = _spike_schedule_impl(batch, n_nodes) if solver != "scan" else None
    if solver == "auto" and auto_solver(dev.type, sched, guard_passed=True) == "scan":
        solver = "scan"
    if solver == "spike" and sched is None:
        raise ValueError(
            "batch is not spike-eligible (needs a piecewise-constant "
            "(theta, dt) schedule shared across trades — uniform, "
            "monitor-aligned or dividend-segmented layouts — and a grid the "
            "SPIKE partitioning admits); use solver='auto'"
        )
    return batch, max_chunk, solver, sched


def price_barrier_batch(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    max_chunk: Optional[int] = 1024,
    dtype: Optional[torch.dtype] = None,
    greeks_mode: str = "bump",
    solver: str = "auto",
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Price a trade batch on ``device``: dict of (B,) tensors
    (price, and with greeks vega, delta, gamma, theta).

    ``solver``: ``"spike"`` the SPIKE march (the hand-written CUDA kernel
    on a card, its plain version on the CPU); ``"scan"`` the CN step loop;
    ``"auto"`` (default) picks ``"spike"`` for an eligible batch on CUDA whose
    SPIKE prep the interface guard passes (:func:`auto_solver`) and
    ``"scan"`` otherwise. Unlike the JAX package, ``"auto"`` never routes to
    the spectral propagator (a later slice) and takes the spike route at
    float64 too: the H100 runs the kernel natively in double precision.
    ``dtype`` casts the batch's floating fields first (float64 halves
    ``max_chunk``, the same working-set budget); ``max_chunk=None`` forces
    one pass.
    """
    batch, max_chunk, solver, sched = _route(batch, n_nodes, max_chunk, dtype, solver, device)
    return _run_batch_driver(
        batch, n_nodes, dv_sigma, with_greeks, max_chunk, greeks_mode,
        solver, sched,
    )


def price_american_batch(
    batch: BarrierTradeBatch,
    n_nodes: int,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
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
    float64 alike, unless the interface guard refuses its SPIKE prep
    (:func:`auto_solver`), and the CN scan otherwise. Dividend batches ride the
    march as extra segments, with the spline jump applied between launches.
    Mixed call/put dividend batches are not eligible (calls restart
    Rannacher after each dividend, so the theta pattern differs per trade)
    and take the scan, as in the JAX package. Unlike the JAX package there
    is no ``"spike_df64"`` route: the float64 march is the same kernel
    compiled at ``double``, since the H100 has native float64.
    ``dtype``, ``max_chunk``: as :func:`price_barrier_batch`.
    """
    batch, max_chunk, solver, sched = _route(batch, n_nodes, max_chunk, dtype, solver, device)
    # the scan applies the spline jump only when asked (the spike route
    # places its jumps from the segmentation and ignores the flag)
    with_dividends = bool((batch.div_amount != 0).any())
    return _run_batch_driver(
        batch, n_nodes, dv_sigma, with_greeks, max_chunk, greeks_mode,
        solver, sched, american=True, with_dividends=with_dividends,
    )


def price_american_batch_richardson(
    *,
    n_nodes: int,
    n_time_steps: int,
    n_time_steps_fine: Optional[int] = None,
    dv_sigma: Optional[float] = None,
    with_greeks: bool = True,
    max_chunk: Optional[int] = 1024,
    dtype: Optional[torch.dtype] = None,
    device=DEFAULT_DEVICE,
    **build_kwargs,
) -> Dict[str, torch.Tensor]:
    """Richardson-extrapolated batched American sweep: two batched solves,
    at ``n_time_steps`` and (default) twice that, combined as
    (4 P_fine - P_coarse)/3 per output, which cancels the leading O(dt^2)
    time-truncation term. ``build_kwargs`` go to :func:`build_american_batch`.
    """
    fine = n_time_steps_fine or 2 * n_time_steps
    common = dict(
        n_nodes=n_nodes, dv_sigma=dv_sigma, with_greeks=with_greeks,
        max_chunk=max_chunk, dtype=dtype, device=device,
    )
    out_c = price_american_batch(
        build_american_batch(n_time_steps=n_time_steps, device=device, **build_kwargs), **common
    )
    out_f = price_american_batch(
        build_american_batch(n_time_steps=fine, device=device, **build_kwargs), **common
    )
    return {k: (4.0 * out_f[k] - out_c[k]) / 3.0 for k in out_f}
