"""Device-resident exposure fast path (the port of
``finite_difference_tpu.xva.device_exposure``: rates swaps, equity TRS,
index-linked swaps, commodity forwards, PDE-surface exotics, FX
conversion and the CSA, SIMM initial margin included).

The generic :class:`~finite_difference_tpu_torch.xva.exposure_engine.ExposureEngine`
is host-orchestrated per date x trade (faithful to the reference's
exposure_engine.py:166-201). For instruments whose pricing is a pure
function of the curve cube — IRSwap-style fixed/float legs (simple
forwards, OIS compounding, and sub-period compounded resets) — the whole
dates x paths x periods computation is ONE dense contraction:

    zero rates at every (date, query) = torch.bmm(cube, W)   # 'tpn,tnm->tpm'

where W is the (n_times, n_tenors, m) HermiteRT weight tensor built on
host from the tenor grid and the schedule alone (interpolation is linear
in the node values — see market_data/yield_curve.py). Forward fixings
frozen at reset follow the engine's convention exactly: the curve
snapshot is the nearest-prior scenario row (an ``index_select`` on the
device), with year-fractions measured from the reset date. The TRS return
leg, the inflation leg and the commodity references are the same
contractions plus two-row gathers of the stamped fixings. PDE-surface
exotics (EquityBarrierOption, AmericanOptionPosition) read their per-date
value surfaces, which stay on the device, with one row-wise linear
interpolation of the simulated spots.

Every contraction is a plain torch op on ``device`` (``cuda`` unless the
caller passes ``"cpu"``), in the dtype of the factor cubes; no kernel of
the port's own runs here. The leg tensors are built on the host once per
(instruments, dates, tenors) and cached together with their device copies
per (device, dtype), so a steady call moves no weight tensor to the card.
Under a SIMM CSA the bumped netting runs and the margin aggregation stay
on the device; only the (n_paths, n_times) IM comes back to the host.

A factor given as a ``parallel.mesh.Sharded`` cube, split along its path
axis (``shard_batch(cube, mesh, dim=1)``), runs the netting set on each
shard's device with that device's leg copies; every path is priced alone,
so the MTM is the unsharded one, gathered on the engine's device.
"""
from __future__ import annotations

import calendar as _cal
import dataclasses
import datetime as dt
import warnings
from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel.mesh import Sharded, on_device, split_rows
from ..instruments.cashflow import LegType, SwapLeg
from ..instruments.commodity import CommodityAverageForwardInstrument, CommodityForwardInstrument
from ..instruments.equity_trs import EquityTRS
from ..instruments.index_linked_swap import IndexLinkedSwap
from ..instruments.ir_swap import IRSwap
from ..instruments.schedule import (
    ScheduleConfig,
    add_months,
    adjust,
    generate_sub_periods,
)
from ..market_data.cpi import besa_bracket
from ..market_data.yield_curve import _hermite_rt_weights, _interp_weight_matrix, _tangent_matrix
from ..ops.interp import linear_interp
from ..portfolio.csa import CloseOutMethod, InitialMarginMethod
from ..portfolio.simm import IR_TENORS, SimmConfig, assign_ir_buckets, simm_im, weight_ir_sensitivities
from ..utils.daycount import year_fraction
from .exposure_engine import ExposureProfile, compute_im, simulate_collateral


@dataclass
class DeviceLegTensors:
    """Fixed-shape tensors for one swap leg: numpy arrays as built on the
    host, torch tensors on the engine's device once :func:`_on_device` has
    moved them."""

    curve_name: str                     # projection curve ("" for fixed legs)
    discount_name: str
    sign: float                         # +receive / -pay
    notional: float
    spread: float
    fixed_rate: float
    is_fixed: bool
    accrual: np.ndarray                 # (m,)
    live: np.ndarray                    # (n_times, m) bool
    W_disc: np.ndarray                  # (n_times, n_tenors, m)
    t_pay: np.ndarray                   # (n_times, m)
    # floating only (None for fixed legs):
    W_f0: Optional[np.ndarray] = None   # (n_times, n_tenors, m) fwd-start
    W_f1: Optional[np.ndarray] = None   # fwd-end
    t_f0: Optional[np.ndarray] = None   # (n_times, m)
    t_f1: Optional[np.ndarray] = None
    tau_fwd: Optional[np.ndarray] = None        # (m,)
    fixed_mask: Optional[np.ndarray] = None     # (n_times, m) bool
    fix_row: Optional[np.ndarray] = None        # (m,) int
    Wfz0: Optional[np.ndarray] = None   # (n_tenors, m) frozen-fixing weights
    Wfz1: Optional[np.ndarray] = None
    tfz0: Optional[np.ndarray] = None   # (m,)
    tfz1: Optional[np.ndarray] = None
    tau_frozen: Optional[np.ndarray] = None  # (m,)
    # OIS (overnight_compounding) only: the one-step compound factors
    # telescope (instruments/schedule.build_overnight_tenors starts at
    # yf=0), so each scenario segment contributes exp(r_j(tau_j)*tau_j) on
    # the row-j curve and the realized factor is a cumsum of log-increments
    W_inc: Optional[np.ndarray] = None      # (n_times-1, n_tenors)
    tau_seg: Optional[np.ndarray] = None    # (n_times-1,)
    j0: Optional[np.ndarray] = None         # (m,) first scen idx >= p_start
    ois_seed: Optional[np.ndarray] = None   # (m,) old_resets-style seed CF
    ois_stamped: Optional[np.ndarray] = None  # (n_times, m) reset < sim
    W_end: Optional[np.ndarray] = None      # (n_times, n_tenors, m)
    t_end: Optional[np.ndarray] = None      # (n_times, m) cyf(d, p_end)
    # forward-starting periods compound over [p_start, p_end] only:
    # cf_future = DF(t_ois_start)/DF(t_end), t_ois_start = cyf(d, max(p_start, d))
    W_ois_start: Optional[np.ndarray] = None  # (n_times, n_tenors, m)
    t_ois_start: Optional[np.ndarray] = None  # (n_times, m)
    # compounded-reset legs (reset_frequency_months > 0): float-window
    # fields above are at flattened (m*n_subs) sub-period granularity
    sub_tau: Optional[np.ndarray] = None    # (m, n_subs), 0-padded
    # equity-forward pathwise notionals (EquityTRS 'Price' interest
    # scaling, equity_trs.py:287-316): started periods use the stamped
    # spot (clamped two-row lerp at p_start), future periods
    # spot * exp((rc - rd)(t_s) * t_s); notional = quantity * that
    eq_quantity: Optional[float] = None
    eq_stamped: Optional[np.ndarray] = None  # (n_times, m) p_start <= d
    eq_row0: Optional[np.ndarray] = None     # (m,) int
    eq_row1: Optional[np.ndarray] = None
    eq_alpha: Optional[np.ndarray] = None    # (m,)
    eq_t_s: Optional[np.ndarray] = None      # (n_times, m) cyf(d, p_start)
    W_eq: Optional[np.ndarray] = None        # (n_times, n_tenors, m)
    is_ois: bool = False
    n_subs: int = 0
    eq_spot_name: str = ""
    eq_carry_name: str = ""
    eq_div_name: str = ""
    # FORWARD close-out: realized/stamped quantities keep the BASE curve
    # (the engine stamps fixings from the un-substituted states) while
    # live forwards/discounting move to the risky curve — "" = curve_name
    frozen_curve_name: str = ""
    # stamped equity-notional spots keep the base scalar under SIMM bumps
    # ("" = eq_spot_name); same split as frozen_curve_name but in the
    # scalars namespace
    frozen_eq_spot_name: str = ""


def _weights_for(tenors: np.ndarray, tq: np.ndarray, Tm) -> np.ndarray:
    """HermiteRT weight matrix (n_tenors, m) for one query row."""
    return _hermite_rt_weights(tenors, tq, tangent_mat=Tm)


def _fixing_window_end(leg: SwapLeg, sc: ScheduleConfig, w_start, w_end_default):
    """Window end: index tenor from the window start, else the period end."""
    if leg.fixing_tenor_months is not None:
        return adjust(
            add_months(w_start, leg.fixing_tenor_months), sc.cal,
            leg.forward_business_convention or "ModifiedFollowing",
        )
    return w_end_default


def _float_window_arrays(
    windows, leg: SwapLeg, sc: ScheduleConfig, dates, tenors, Tm
) -> Dict:
    """Fixing-or-forward tensors for one column per (w_start, w_end) window.

    Replicates the engine's simple-forward policy exactly (cashflow.py
    ``_period_rate`` / the batched leg_pv path): live forwards are measured
    from the sim date with the window start clamped to it; frozen fixings
    gather the nearest-prior scenario row to the window start and measure
    year-fractions from the start itself (exposure_engine.py:227-364).
    """
    n_times, mc = len(dates), len(windows)
    t_f0 = np.zeros((n_times, mc))
    t_f1 = np.zeros((n_times, mc))
    fixed_mask = np.zeros((n_times, mc), dtype=bool)
    for t_idx, d in enumerate(dates):
        for i, (w0, w1) in enumerate(windows):
            t_f0[t_idx, i] = sc.curve_year_fraction(d, max(w0, d))
            t_f1[t_idx, i] = sc.curve_year_fraction(d, w1)
            # the engine stamps the fixing once reset_date (= w0) <= sim
            # date; leg_pv then uses it for w0 <= val_date
            fixed_mask[t_idx, i] = w0 <= d
    tau_fwd = (
        np.array([sc.year_fraction(w0, w1) for w0, w1 in windows])
        if leg.fixing_tenor_months is not None
        else None  # computed per (t, i) on device as t1 - t0
    )
    # frozen fixings: curve snapshot at nearest-prior row to the reset
    # (w0), year-fractions measured from the reset date itself
    fix_row = np.array(
        [max(0, bisect_right(dates, w0) - 1) for w0, _ in windows],
        dtype=np.int64,
    )
    tfz0 = np.zeros(mc)
    tfz1 = np.array([sc.curve_year_fraction(w0, w1) for w0, w1 in windows])
    tauz = tau_fwd if tau_fwd is not None else tfz1 - tfz0
    return dict(
        W_f0=np.stack([_weights_for(tenors, t_f0[t], Tm) for t in range(n_times)]),
        W_f1=np.stack([_weights_for(tenors, t_f1[t], Tm) for t in range(n_times)]),
        t_f0=t_f0, t_f1=t_f1, tau_fwd=tau_fwd,
        fixed_mask=fixed_mask, fix_row=fix_row,
        Wfz0=_weights_for(tenors, tfz0, Tm),
        Wfz1=_weights_for(tenors, tfz1, Tm),
        tfz0=tfz0, tfz1=tfz1, tau_frozen=tauz,
    )


def _ois_arrays(
    schedule, leg: SwapLeg, sc: ScheduleConfig, dates, tenors, Tm,
    ois_seed_fn,
) -> Dict:
    """OIS compound-factor tensors (exposure_engine.py:273-296 on device).

    ``compute_cf_increment`` over one scenario segment [d_j, d_j+1] is a
    fully telescoping product of one-day DF ratios on the row-j curve —
    build_overnight_tenors measures from t_from, so it equals
    DF_j(0)/DF_j(tau_j) = exp(r_j(tau_j)*tau_j). The realized factor at sim
    row t for a period starting at p_start is then
    seed * exp(L[t] - L[j0]) with L the cumsum of segment log-increments
    and j0 the first scenario row >= p_start; the engine only stamps OIS
    fixings for reset_date < sim_date (strict), so unstamped (t, period)
    cells fall back to CF=1 exactly as ``_period_rate`` does.
    """
    n_times, m = len(dates), len(schedule)
    tau_seg = np.array(
        [sc.curve_year_fraction(d0, d1) for d0, d1 in zip(dates[:-1], dates[1:])]
    )
    W_inc = (
        np.stack([_weights_for(tenors, np.array([ts]), Tm)[:, 0] for ts in tau_seg])
        if n_times > 1
        else np.zeros((0, len(tenors)))
    )
    j0 = np.array(
        [min(bisect_left(dates, p_start), n_times - 1)
         for p_start, _, _, _ in schedule],
        dtype=np.int64,
    )
    seeds = np.ones(m)
    if ois_seed_fn is not None:
        for i, (p_start, _, _, _) in enumerate(schedule):
            s = ois_seed_fn(leg.curve_name, p_start)
            if s is not None:
                seeds[i] = float(s)
    stamped = np.zeros((n_times, m), dtype=bool)
    t_end = np.zeros((n_times, m))
    t_start = np.zeros((n_times, m))
    for t_idx, d in enumerate(dates):
        for i, (p_start, p_end, _, _) in enumerate(schedule):
            stamped[t_idx, i] = p_start < d
            t_end[t_idx, i] = sc.curve_year_fraction(d, p_end)
            # forward-starting periods compound over [p_start, p_end] only
            # (cashflow._period_rate's max(p_start, val_date) convention)
            t_start[t_idx, i] = sc.curve_year_fraction(d, max(p_start, d))
    W_end = np.stack(
        [_weights_for(tenors, np.maximum(t_end[t], 0.0), Tm)
         for t in range(n_times)]
    )
    if np.any(t_start > 0.0):
        W_start = np.stack(
            [_weights_for(tenors, np.maximum(t_start[t], 0.0), Tm)
             for t in range(n_times)]
        )
    else:
        # no forward-starting (date, period) cell anywhere: drop the
        # start-leg tensors, and with them the correction's contraction
        W_start, t_start = None, None
    return dict(
        W_inc=W_inc, tau_seg=tau_seg, j0=j0, ois_seed=seeds,
        ois_stamped=stamped, W_end=W_end, t_end=t_end,
        W_ois_start=W_start, t_ois_start=t_start, is_ois=True,
    )


def build_leg_tensors(
    schedule,
    leg: SwapLeg,
    sign: float,
    scenario_dates: Sequence[dt.date],
    tenors: np.ndarray,
    *,
    sc: ScheduleConfig,
    notional: float,
    discount_name: str,
    include_on,
    ois_seed_fn=None,
) -> DeviceLegTensors:
    """Precompute a swap leg's schedule/interpolation tensors (host).

    ``include_on(d)`` -> bool: whether pay_date == d cashflows count
    (instrument-specific: IRSwap includes the terminal date, EquityTRS
    follows its include_sim_date_cashflows flag only).
    ``ois_seed_fn(curve_name, p_start)``: the instrument's historical
    compound-factor seed hook (instrument.get_ois_initial_cf).
    """
    dates = list(scenario_dates)
    n_times = len(dates)
    m = len(schedule)
    Tm = _tangent_matrix(tenors) if tenors.size > 1 else None

    accrual = np.array([acc for _, _, _, acc in schedule])
    live = np.zeros((n_times, m), dtype=bool)
    t_pay = np.zeros((n_times, m))
    is_float = leg.leg_type == LegType.FLOATING
    is_ois = is_float and leg.overnight_compounding
    is_compounded = (
        is_float and not is_ois and leg.reset_frequency_months > 0
    )

    for t_idx, d in enumerate(dates):
        include = include_on(d)
        for i, (p_start, p_end, pay, acc) in enumerate(schedule):
            live[t_idx, i] = pay > d or (pay == d and include)
            t_pay[t_idx, i] = max(0.0, sc.curve_year_fraction(d, pay))

    W_disc = np.stack([_weights_for(tenors, t_pay[t], Tm) for t in range(n_times)])

    kw: Dict = {}
    if is_ois:
        kw = _ois_arrays(schedule, leg, sc, dates, tenors, Tm, ois_seed_fn)
    elif is_compounded:
        # flatten sub-periods to (m, S) columns padded with degenerate
        # (p_end, p_end) windows whose tau=0 growth factor is exactly 1
        subs_per = [
            generate_sub_periods(
                p_start, p_end, leg.reset_frequency_months,
                sc.cal, sc.business_convention, sc.day_count,
                direction="Backward",
            )
            for p_start, p_end, _, _ in schedule
        ]
        S = max(len(s) for s in subs_per)
        windows = []
        sub_tau = np.zeros((m, S))
        for i, ((p_start, p_end, _, _), subs) in enumerate(
            zip(schedule, subs_per)
        ):
            for s in range(S):
                if s < len(subs):
                    sub0, sub1, tau = subs[s]
                    windows.append(
                        (sub0, _fixing_window_end(leg, sc, sub0, sub1))
                    )
                    sub_tau[i, s] = tau
                else:
                    windows.append((p_end, p_end))
        kw = _float_window_arrays(windows, leg, sc, dates, tenors, Tm)
        kw.update(sub_tau=sub_tau, n_subs=S)
    elif is_float:
        windows = [
            (p_start, _fixing_window_end(leg, sc, p_start, p_end))
            for p_start, p_end, _, _ in schedule
        ]
        kw = _float_window_arrays(windows, leg, sc, dates, tenors, Tm)

    return DeviceLegTensors(
        curve_name=leg.curve_name or "",
        discount_name=discount_name,
        sign=sign,
        notional=float(notional),
        spread=float(leg.spread),
        fixed_rate=float(leg.fixed_rate),
        is_fixed=leg.leg_type == LegType.FIXED,
        accrual=accrual,
        live=live,
        W_disc=W_disc,
        t_pay=t_pay,
        **kw,
    )


def build_irswap_tensors(
    swap: IRSwap, scenario_dates: Sequence[dt.date], tenors: np.ndarray
) -> List[DeviceLegTensors]:
    common = dict(
        sc=swap.schedule_config,
        notional=swap.notional,
        discount_name=swap.discount_curve_name,
        include_on=lambda d: (
            swap.include_sim_date_cashflows or d == swap._effective_maturity
        ),
        ois_seed_fn=swap.get_ois_initial_cf,
    )
    return [
        build_leg_tensors(
            swap.receive_schedule, swap.receive_leg, +1.0,
            scenario_dates, tenors, **common,
        ),
        build_leg_tensors(
            swap.pay_schedule, swap.pay_leg, -1.0, scenario_dates, tenors,
            **common,
        ),
    ]


def _float_rate_cols(leg: DeviceLegTensors, fwd_cube, frozen_cube=None):
    """Fixing-or-forward simple rates, one column per fixing window.

    (n_times, n_paths, C) where C is m for plain floating legs and
    m*n_subs for compounded-reset legs. ``frozen_cube`` backs the stamped
    fixings (the base curve under FORWARD close-out); defaults to
    ``fwd_cube``.
    """
    if frozen_cube is None:
        frozen_cube = fwd_cube
    r0 = torch.bmm(fwd_cube, leg.W_f0)
    r1 = torch.bmm(fwd_cube, leg.W_f1)
    t0 = leg.t_f0[:, None, :]
    t1 = leg.t_f1[:, None, :]
    # the sign goes on the small time tensor (exact: a negation rounds
    # nothing), which spares a pass over the (t, p, m) rates
    df0 = torch.exp(r0 * -t0.clamp_min(0.0))
    df1 = torch.exp(r1 * -t1.clamp_min(0.0))
    tau = leg.tau_fwd[None, None, :] if leg.tau_fwd is not None else t1 - t0
    tau_safe = torch.where(tau <= 0.0, 1.0, tau)
    live_fwd = torch.where(tau <= 0.0, 0.0, (df0 / df1 - 1.0) / tau_safe)

    # frozen fixings: gather the reset-row curve snapshot per window
    snap = frozen_cube.index_select(0, leg.fix_row)  # (C, n_paths, n_tenors)
    rz0 = torch.einsum("mpn,nm->pm", snap, leg.Wfz0)
    rz1 = torch.einsum("mpn,nm->pm", snap, leg.Wfz1)
    dfz0 = torch.exp(rz0 * -leg.tfz0.clamp_min(0.0)[None, :])
    dfz1 = torch.exp(rz1 * -leg.tfz1.clamp_min(0.0)[None, :])
    tauz = leg.tau_frozen[None, :]
    tauz_safe = torch.where(tauz <= 0.0, 1.0, tauz)
    frozen = torch.where(tauz <= 0.0, 0.0, (dfz0 / dfz1 - 1.0) / tauz_safe)

    return torch.where(leg.fixed_mask[:, None, :], frozen[None, :, :], live_fwd)


def _ois_rate(leg: DeviceLegTensors, fwd_cube, frozen_cube=None):
    """OIS period rate (CF_realized * CF_future - 1)/accrual on device.

    The realized compound factor is seed * exp(L[t] - L[j0]) with L the
    time-axis cumsum of the telescoped per-segment log-increments
    r_j(tau_j)*tau_j (see _ois_arrays); it only applies once the engine
    has stamped the reset (reset_date < sim_date), otherwise CF=1.
    CF_future telescopes the remaining business days on the sim-date curve
    to DF(0)/DF(t_end) = exp(r(t_end)*t_end) (cashflow.py:69-83).
    """
    if frozen_cube is None:
        frozen_cube = fwd_cube
    n_paths = fwd_cube.shape[1]
    zero = torch.zeros((1, n_paths), dtype=fwd_cube.dtype, device=fwd_cube.device)
    if leg.tau_seg.shape[0]:
        # realized segment increments are STAMPED quantities -> base curve
        r_seg = torch.bmm(frozen_cube[:-1], leg.W_inc[:, :, None])[:, :, 0]
        loginc = r_seg * leg.tau_seg[:, None]
        L = torch.cat([zero, torch.cumsum(loginc, dim=0)])
    else:
        L = zero
    Lj0 = L.index_select(0, leg.j0)  # (m, n_paths)
    stamped = leg.ois_stamped[:, None, :]  # (t, 1, m)
    realized_log = torch.where(stamped, L[:, :, None] - Lj0.T[None, :, :], 0.0)
    cf_real = (
        torch.where(stamped, leg.ois_seed[None, None, :], 1.0)
        * torch.exp(realized_log)
    )
    r_end = torch.bmm(fwd_cube, leg.W_end)
    t_end = leg.t_end[:, None, :]
    # DF(t_start)/DF(t_end): t_start = 0 for in-progress periods (realized
    # part is the stamped cache), cyf(d, p_start) for forward-starting
    # ones. _ois_arrays drops these tensors when no (date, period) cell is
    # forward-starting, so the seasoned-book case skips the contraction.
    start_corr = 0.0
    if leg.t_ois_start is not None:
        r_start = torch.bmm(fwd_cube, leg.W_ois_start)
        start_corr = r_start * leg.t_ois_start[:, None, :].clamp_min(0.0)
    cf_fut = torch.where(
        t_end > 0.0,
        torch.exp(r_end * t_end.clamp_min(0.0) - start_corr),
        1.0,
    )
    acc = leg.accrual[None, None, :]
    acc_safe = torch.where(acc <= 0.0, 1.0, acc)
    return torch.where(acc <= 0.0, 0.0, (cf_real * cf_fut - 1.0) / acc_safe)


def _leg_mtm(
    leg: DeviceLegTensors,
    curves: Dict[str, torch.Tensor],
    scalars: Optional[Dict[str, torch.Tensor]] = None,
):
    """(n_times, n_paths) MTM of one leg on its tensors' device."""
    disc = curves[leg.discount_name]  # (n_times, n_paths, n_tenors)
    r_pay = torch.bmm(disc, leg.W_disc)
    df_pay = torch.exp(r_pay * -leg.t_pay[:, None, :])
    live = leg.live[:, None, :]

    if leg.is_fixed:
        coupon = (leg.fixed_rate + leg.spread) * live.to(df_pay.dtype)  # (t, 1, m)
    else:
        if leg.is_ois:
            rate = _ois_rate(
                leg, curves[leg.curve_name],
                curves[leg.frozen_curve_name or leg.curve_name],
            )
        else:
            rate = _float_rate_cols(
                leg, curves[leg.curve_name],
                curves[leg.frozen_curve_name or leg.curve_name],
            )
            if leg.n_subs:
                # compounded sub-period rates (cashflow.py:155-168): growth =
                # prod(1 + r_s tau_s) over the period's subs, padded factors 1
                t, p = rate.shape[0], rate.shape[1]
                r = rate.reshape(t, p, -1, leg.n_subs)
                growth = torch.prod(1.0 + r * leg.sub_tau[None, None, :, :], dim=-1)
                acc = leg.accrual
                acc_safe = torch.where(acc <= 0.0, 1.0, acc)
                rate = torch.where(
                    acc[None, None, :] <= 0.0,
                    0.0,
                    (growth - 1.0) / acc_safe[None, None, :],
                )
        coupon = (rate + leg.spread) * live

    if leg.eq_spot_name:
        # pathwise equity-forward notionals ('Price' interest scaling)
        spot = scalars[leg.eq_spot_name]                # (n_times, n_paths)
        r_eq = torch.bmm(curves[leg.eq_carry_name], leg.W_eq)
        if leg.eq_div_name:
            r_eq = r_eq - torch.bmm(curves[leg.eq_div_name], leg.W_eq)
        t_s = leg.eq_t_s[:, None, :]
        fwd = spot[:, :, None] * torch.exp(r_eq * t_s.clamp_min(0.0))
        # stamped notional spots are historical fixings -> base scalar
        spot_fz = scalars[leg.frozen_eq_spot_name or leg.eq_spot_name]
        s0 = spot_fz.index_select(0, leg.eq_row0)       # (m, n_paths)
        s1 = spot_fz.index_select(0, leg.eq_row1)
        a = leg.eq_alpha[:, None]
        stamped_spot = ((1.0 - a) * s0 + a * s1).T      # (n_paths, m)
        notional = leg.eq_quantity * torch.where(
            leg.eq_stamped[:, None, :], stamped_spot[None, :, :], fwd
        )
        return torch.matmul(df_pay * coupon * notional, leg.accrual) * leg.sign
    return torch.matmul(df_pay * coupon, leg.accrual) * (leg.sign * leg.notional)


def hw1f_cva_pipeline(
    simulator,
    base_date: dt.date,
    scen_days: Sequence[int],
    tenors: np.ndarray,
    n_paths: int,
    instruments: Sequence[IRSwap],
    *,
    curve_name: str = "ZAR-SWAP",
    hazard_rate: float = 0.02,
    recovery: float = 0.4,
    flat_discount_rate: float = 0.0,
    pfe_quantile: float = 0.95,
    seed: int = 42,
    notional_scales=None,
    days_in_year: float = 365.25,
) -> Dict:
    """Scenario generation -> exposure -> CVA with the cube on the device.

    The production shape (BASELINE.json config 5 closed fully on device):
    an exact HW1F yield-curve simulation (models.mc.hw1f) feeds the device
    exposure engine directly as a tensor on the simulator's device — the
    (n_times, n_paths, n_tenors) cube never leaves it; only the EE/PFE
    profile (n_times-sized) and the CVA scalar come back to the host.
    """
    from .cva import cva_trapezoid, exposure_profile

    scen_days = np.asarray(sorted(scen_days), dtype=np.int64)
    if scen_days.size == 0 or scen_days[0] <= 0:
        raise ValueError("scen_days must be strictly positive (t=0 implicit).")
    t_years = scen_days / float(days_in_year)
    tau = np.asarray(tenors, dtype=np.float64)

    rates = simulator.simulate(t_years, tau, n_paths, seed=seed, as_jax=True)
    cube = simulator.values_with_today(rates, tau, n_paths, as_jax=True)
    dates = [base_date] + [
        base_date + dt.timedelta(days=int(d)) for d in scen_days
    ]

    engine = DeviceExposureEngine(
        dates, {curve_name: cube}, tau, device=simulator.device
    )
    mtm = engine.mtm(instruments, notional_scales)  # device (n_paths, n_times)

    times_days = np.concatenate([[0], scen_days]).astype(float)
    df0 = np.exp(-flat_discount_rate * times_days / days_in_year)
    prof = exposure_profile(
        times_days, mtm.T, pfe_quantile=pfe_quantile, df0=df0
    )
    survival = np.exp(-hazard_rate * times_days / days_in_year)
    cva = cva_trapezoid(prof.ee, survival, lgd=1.0 - recovery)
    return {
        "profile": prof,
        "cva": cva,
        "mtm": mtm,  # still on the device; .cpu().numpy() to pull
        "dates": dates,
    }


@dataclass
class DeviceTRSTensors:
    """Host-precomputed tensors for an EquityTRS return leg.

    Mirrors instruments.equity_pv.trs_return_leg_pv period cases on the
    (n_times, m) grid: future periods use cost-of-carry forwards
    F = spot * exp((rc_q t_q - rc_0 t_0) - (rd_q t_q - rd_0 t_0)); started
    periods use the engine-stamped spot (linear state interpolation to the
    reset date = a two-row gather + lerp on device).
    """

    spot_name: str
    carry_name: str
    div_name: str
    discount_name: str
    sign: float                      # +receiver / -payer (return leg sign)
    quantity: float
    notional_fixed: float
    price_scaling: bool              # True: quantity*(Fe-Fs); False: N*(Fe/Fs-1)
    live: np.ndarray                 # (n_times, m)
    first_live: np.ndarray           # (n_times, m) one-hot first outstanding
    start_future: np.ndarray         # (n_times, m) settled start > d
    end_future: np.ndarray           # (n_times, m)
    t_pay: np.ndarray                # (n_times, m)
    W_disc: np.ndarray               # (n_times, n_tenors, m)
    # forward queries (anchor t0 = settle lag from each date)
    q_start: np.ndarray              # (n_times, m) query yf incl. settle
    q_end: np.ndarray                # (n_times, m)
    t0: np.ndarray                   # (n_times,) settle anchor yf
    Wc_start: np.ndarray             # (n_times, n_tenors, m) carry @ q_start
    Wc_end: np.ndarray
    Wd_start: np.ndarray             # dividend @ q_start
    Wd_end: np.ndarray
    Wc_t0: np.ndarray                # (n_times, n_tenors, 1) anchors
    Wd_t0: np.ndarray
    # stamped spot gathers: rows i0/i1 + lerp alpha per period start/end
    s_row0: np.ndarray               # (m,) int
    s_row1: np.ndarray
    s_alpha: np.ndarray              # (m,)
    e_row0: np.ndarray
    e_row1: np.ndarray
    e_alpha: np.ndarray
    # stamped start/end spots keep the base scalar under SIMM bumps
    # ("" = spot_name)
    frozen_spot_name: str = ""


def _interp_rows(dates, d):
    """(i0, i1, alpha) reproducing _interp_scenario_state at date d."""
    i0 = max(0, bisect_right(dates, d) - 1)
    i1 = min(i0 + 1, len(dates) - 1)
    if i1 == i0 or dates[i0] == d:
        return i0, i0, 0.0
    span = (dates[i1] - dates[i0]).days
    alpha = (d - dates[i0]).days / span if span else 0.0
    return i0, i1, float(min(max(alpha, 0.0), 1.0))


def build_trs_tensors(trs, scenario_dates: Sequence[dt.date], tenors: np.ndarray):
    """[return-leg DeviceTRSTensors, interest-leg DeviceLegTensors]."""
    sc = trs.schedule_config
    dates = list(scenario_dates)
    n_times = len(dates)
    schedule = trs.return_schedule
    m = len(schedule)
    Tm = _tangent_matrix(tenors) if tenors.size > 1 else None
    direction = 1.0 if trs.is_receiver else -1.0

    live = np.zeros((n_times, m), dtype=bool)
    t_pay = np.zeros((n_times, m))
    start_future = np.zeros((n_times, m), dtype=bool)
    end_future = np.zeros((n_times, m), dtype=bool)
    q_start = np.zeros((n_times, m))
    q_end = np.zeros((n_times, m))
    t0 = np.zeros(n_times)

    settled = [(trs._settled(st), trs._settled(en)) for st, en, _, _ in schedule]
    for t_idx, d in enumerate(dates):
        if d > trs._effective_maturity:
            continue  # scenario_npvs returns 0 past the last payment
        if trs.spot_lag > 0:
            vs = sc.cal.add_working_days(d, trs.spot_lag)
            t0[t_idx] = sc.curve_year_fraction(d, vs)
        include_on_val = (
            trs.include_sim_date_cashflows or d == trs._effective_maturity
        )
        for i, ((st, en, pay, acc), (st_s, en_s)) in enumerate(zip(schedule, settled)):
            live[t_idx, i] = pay > d or (pay == d and include_on_val)
            t_pay[t_idx, i] = max(0.0, sc.curve_year_fraction(d, pay))
            ts = (1 if st_s >= d else -1) * sc.curve_year_fraction(
                min(st_s, d), max(st_s, d)
            )
            te = (1 if en_s >= d else -1) * sc.curve_year_fraction(
                min(en_s, d), max(en_s, d)
            )
            start_future[t_idx, i] = ts > 0
            end_future[t_idx, i] = te > 0
            q_start[t_idx, i] = max(ts + t0[t_idx], t0[t_idx], 0.0)
            q_end[t_idx, i] = max(te + t0[t_idx], t0[t_idx], 0.0)

    first_live = np.zeros_like(live)
    for t_idx in range(n_times):
        idx = np.argmax(live[t_idx]) if live[t_idx].any() else None
        if idx is not None:
            first_live[t_idx, idx] = True

    stack_w = lambda tq: np.stack(
        [_weights_for(tenors, tq[t], Tm) for t in range(n_times)]
    )
    W_disc = stack_w(t_pay)
    Wc_start = stack_w(q_start)
    Wc_end = stack_w(q_end)
    Wt0 = np.stack(
        [_weights_for(tenors, np.array([t0[t]]), Tm) for t in range(n_times)]
    )

    s_row0 = np.zeros(m, dtype=np.int64)
    s_row1 = np.zeros(m, dtype=np.int64)
    s_alpha = np.zeros(m)
    e_row0 = np.zeros(m, dtype=np.int64)
    e_row1 = np.zeros(m, dtype=np.int64)
    e_alpha = np.zeros(m)
    for i, (st, en, _, _) in enumerate(schedule):
        s_row0[i], s_row1[i], s_alpha[i] = _interp_rows(dates, st)
        e_row0[i], e_row1[i], e_alpha[i] = _interp_rows(dates, en)

    ret = DeviceTRSTensors(
        spot_name=trs.spot_name,
        carry_name=trs.carry_curve_name,
        div_name=trs.dividend_curve_name,
        discount_name=trs.discount_curve_name,
        sign=direction,
        quantity=float(trs.quantity),
        notional_fixed=float(trs.notional),
        price_scaling=trs.return_nominal_scaling == "Price",
        live=live, first_live=first_live,
        start_future=start_future, end_future=end_future,
        t_pay=t_pay, W_disc=W_disc,
        q_start=q_start, q_end=q_end, t0=t0,
        Wc_start=Wc_start, Wc_end=Wc_end,
        Wd_start=Wc_start, Wd_end=Wc_end,  # same query times; dims via curve
        Wc_t0=Wt0, Wd_t0=Wt0,
        s_row0=s_row0, s_row1=s_row1, s_alpha=s_alpha,
        e_row0=e_row0, e_row1=e_row1, e_alpha=e_alpha,
    )

    # interest leg: fixed notional ("Initial Price" scaling) or pathwise
    # equity-forward notionals ("Price"); due-today flows count on the
    # terminal (last-payment) date like the host path
    price_scaled = trs.interest_nominal_scaling == "Price"
    interest = build_leg_tensors(
        trs.interest_schedule, trs.interest_leg, -direction,
        scenario_dates, tenors,
        sc=sc, notional=1.0 if price_scaled else trs.notional,
        discount_name=trs.discount_curve_name,
        include_on=lambda d: (
            trs.include_sim_date_cashflows or d == trs._effective_maturity
        ),
    )
    if price_scaled:
        mi = len(trs.interest_schedule)
        eq_stamped = np.zeros((n_times, mi), dtype=bool)
        eq_t_s = np.zeros((n_times, mi))
        eq_row0 = np.zeros(mi, dtype=np.int64)
        eq_row1 = np.zeros(mi, dtype=np.int64)
        eq_alpha = np.zeros(mi)
        for i, (p_start, _, _, _) in enumerate(trs.interest_schedule):
            eq_row0[i], eq_row1[i], eq_alpha[i] = _interp_rows(dates, p_start)
            for t_idx, d in enumerate(dates):
                eq_stamped[t_idx, i] = p_start <= d
                eq_t_s[t_idx, i] = sc.curve_year_fraction(d, max(p_start, d))
        interest.eq_quantity = float(trs.quantity)
        interest.eq_stamped = eq_stamped
        interest.eq_row0 = eq_row0
        interest.eq_row1 = eq_row1
        interest.eq_alpha = eq_alpha
        interest.eq_t_s = eq_t_s
        interest.W_eq = np.stack(
            [_weights_for(tenors, eq_t_s[t], Tm) for t in range(n_times)]
        )
        interest.eq_spot_name = trs.spot_name
        interest.eq_carry_name = trs.carry_curve_name
        interest.eq_div_name = (
            trs.dividend_curve_name if trs.dividend_curve_name else ""
        )
    # zero the interest leg past the last payment to match scenario_npvs
    mat_mask = np.array(
        [d <= trs._effective_maturity for d in dates], dtype=bool
    )
    interest.live = interest.live & mat_mask[:, None]
    return [ret, interest]


def _trs_mtm(trs_t: DeviceTRSTensors, curves, scalars):
    """(n_times, n_paths) return-leg MTM on its tensors' device."""
    spot = scalars[trs_t.spot_name]              # (n_times, n_paths)
    carry = curves[trs_t.carry_name]             # (n_times, n_paths, n_tenors)
    div = curves.get(trs_t.div_name)
    disc = curves[trs_t.discount_name]

    r_pay = torch.bmm(disc, trs_t.W_disc)
    df_pay = torch.exp(r_pay * -trs_t.t_pay[:, None, :])

    def log_growth(cube, W_q, q, W_0):
        r_q = torch.bmm(cube, W_q)
        r_0 = torch.bmm(cube, W_0)[:, :, :1]
        return r_q * q[:, None, :] - r_0 * trs_t.t0[:, None, None]

    g_start = log_growth(carry, trs_t.Wc_start, trs_t.q_start, trs_t.Wc_t0)
    g_end = log_growth(carry, trs_t.Wc_end, trs_t.q_end, trs_t.Wc_t0)
    if div is not None:
        g_start = g_start - log_growth(div, trs_t.Wd_start, trs_t.q_start, trs_t.Wd_t0)
        g_end = g_end - log_growth(div, trs_t.Wd_end, trs_t.q_end, trs_t.Wd_t0)
    f_start_fwd = spot[:, :, None] * torch.exp(g_start)
    f_end_fwd = spot[:, :, None] * torch.exp(g_end)

    # stamped reset spots are historical fixings -> base scalar
    spot_fz = scalars[trs_t.frozen_spot_name or trs_t.spot_name]

    def stamped(rows0, rows1, alpha):
        s0 = spot_fz.index_select(0, rows0)      # (m, n_paths)
        s1 = spot_fz.index_select(0, rows1)
        a = alpha[:, None]
        return ((1.0 - a) * s0 + a * s1).T       # (n_paths, m)

    stamped_start = stamped(trs_t.s_row0, trs_t.s_row1, trs_t.s_alpha)
    stamped_end = stamped(trs_t.e_row0, trs_t.e_row1, trs_t.e_alpha)

    # first outstanding started period: the engine-stamped spot at the
    # raw start (linear state interp, CLAMPED to the first cube row for
    # pre-window starts — _build_equity_fixings stamps every reset <=
    # sim date, and equity_trs.scenario_npvs lets the stamp win over the
    # contractual initial_price). Other started periods: today's spot
    # (trs_return_leg_pv:140-150).
    started_start = torch.where(
        trs_t.first_live[:, None, :], stamped_start[None, :, :], spot[:, :, None]
    )
    f_start = torch.where(trs_t.start_future[:, None, :], f_start_fwd, started_start)
    f_end = torch.where(trs_t.end_future[:, None, :], f_end_fwd, stamped_end[None, :, :])

    if trs_t.price_scaling:
        payoff = trs_t.quantity * (f_end - f_start)
    else:
        safe = torch.where(f_start == 0.0, 1.0, f_start)
        payoff = trs_t.notional_fixed * (f_end / safe - 1.0)

    live = trs_t.live[:, None, :]
    return torch.where(live, df_pay * payoff, 0.0).sum(dim=2) * trs_t.sign


@dataclass
class DeviceILSTensors:
    """Host-precomputed tensors for an IndexLinkedSwap inflation leg
    (RiskFlow mode: PriceIndex scalar + InflationRate curve).

    The engine's CPI stamping collapses to a per-reference-date rule: a
    non-historical ref k is stamped ONCE, either by the T_last_pub
    pre-seed (spot CPI at the first row d* >= k, when last_pub(d*) == k)
    or by due-stamping (state linearly interpolated to k) — both are a
    two-row gather + lerp of the CPI scalar cube. Unpublished refs project
    anchor_CPI(t) / DF_infl^t(yf(anchor(t), k)) with anchor(t) =
    T_last_pub(t), itself one of the stamped refs.
    """

    cpi_name: str
    infl_name: str
    discount_name: str
    sign: float
    notional: float
    real_rate: float
    base_cpi: float
    pay_notional_at_maturity: bool
    live: np.ndarray                 # (n_times, m)
    is_last_pay: np.ndarray          # (m,)
    accrual: np.ndarray              # (m,)
    t_pay: np.ndarray                # (n_times, m)
    W_disc: np.ndarray               # (n_times, n_tenors, m)
    # unique refs (brackets + anchors), K of them
    ref_row0: np.ndarray             # (K,) stamped-value gather rows
    ref_row1: np.ndarray
    ref_alpha: np.ndarray            # (K,)
    ref_hist: np.ndarray             # (K,) bool: value from hist_map
    ref_hist_val: np.ndarray         # (K,)
    pub_mask: np.ndarray             # (n_times, K) ref published/stamped at t
    anchor_idx: np.ndarray           # (n_times,) index into K of anchor(t)
    W_infl: np.ndarray               # (n_times, n_tenors, K) proj queries
    #   (RiskFlow: InflationRate DF queries; legacy: LINEAR CPI-level
    #    term-structure weights at yf(d_t, k) for unstamped refs)
    t_proj: np.ndarray               # (n_times, K) yf(anchor(t), k)
    j_idx: np.ndarray                # (m,) bracket j index into K
    j1_idx: np.ndarray               # (m,)
    frac: np.ndarray                 # (m,) intramonth weight
    legacy: bool = False             # CPI factor is a level term structure
    # stamped CPI refs keep the base factor under SIMM bumps
    # ("" = cpi_name; scalars namespace, or curves when legacy)
    frozen_cpi_name: str = ""


def build_ils_tensors(ils, scenario_dates: Sequence[dt.date], tenors: np.ndarray):
    """[inflation-leg DeviceILSTensors, nominal-leg DeviceLegTensors]."""
    leg = ils.inflation_leg
    legacy = not leg.inflation_rate_curve_name
    sc = ils.schedule_config
    dates = list(scenario_dates)
    n_times = len(dates)
    schedule = ils.inflation_schedule
    m = len(schedule)
    Tm = _tangent_matrix(tenors) if tenors.size > 1 else None
    sign = 1.0 if ils.inflation_receiver else -1.0
    hist = ils._historical_cpi_map

    live = np.zeros((n_times, m), dtype=bool)
    t_pay = np.zeros((n_times, m))
    last_pay = max(p for _, _, p, _ in schedule)
    is_last_pay = np.array([p == last_pay for _, _, p, _ in schedule])
    accrual = np.array([a for _, _, _, a in schedule])

    for t_idx, d in enumerate(dates):
        if d > ils._effective_maturity:
            continue
        for i, (p_start, p_end, pay, acc) in enumerate(schedule):
            live[t_idx, i] = pay > d or (
                pay == d and ils.include_sim_date_cashflows
            )
            t_pay[t_idx, i] = max(0.0, sc.curve_year_fraction(d, pay))
    W_disc = np.stack(
        [_weights_for(tenors, t_pay[t], Tm) for t in range(n_times)]
    )

    # unique refs: bracket dates + every anchor T_last_pub(t)
    anchors = [ils.get_cpi_last_pub_date(d) for d in dates]
    brackets = []
    frac = np.zeros(m)
    for i, (_, p_end, _, _) in enumerate(schedule):
        j, j1 = besa_bracket(p_end, leg.lag_months)
        brackets.append((j, j1))
        frac[i] = (p_end.day - 1) / _cal.monthrange(p_end.year, p_end.month)[1]
    bracket_refs = {k for j, j1 in brackets for k in (j, j1)}
    refs = sorted(bracket_refs | set(anchors))
    K = len(refs)
    ref_pos = {k: idx for idx, k in enumerate(refs)}

    # stamping rule per non-historical ref (mirrors _build_cpi_fixings'
    # per-date order: T_last_pub PRE-SEED first — spot at the stamping
    # row — then due-stamping of bracket refs with the state linearly
    # interpolated to the ref date). A ref is stamped exactly once, by
    # whichever fires at the EARLIER row (pre-seed wins same-row ties);
    # anchor-only refs are never in the due list, so only the pre-seed
    # applies to them.
    ref_row0 = np.zeros(K, dtype=np.int64)
    ref_row1 = np.zeros(K, dtype=np.int64)
    ref_alpha = np.zeros(K)
    ref_hist = np.zeros(K, dtype=bool)
    ref_hist_val = np.zeros(K)
    stamp_row = np.full(K, n_times, dtype=np.int64)  # sentinel: never stamped
    for idx, k in enumerate(refs):
        if k in hist:
            ref_hist[idx] = True
            ref_hist_val[idx] = hist[k]
            continue
        d_pre = next(
            (r for r, a in enumerate(anchors) if a == k), None
        )
        if k in bracket_refs:
            j = bisect_right(dates, k) - 1
            d_due = j if (0 <= j < n_times and dates[j] >= k) else j + 1
            d_due = min(max(d_due, 0), n_times - 1)
            due_eff = bisect_left(dates, k)  # unclamped: first row >= k
        else:
            d_due = None
            due_eff = n_times
        stamp_row[idx] = min(
            d_pre if d_pre is not None else n_times, due_eff
        )
        if d_pre is not None and (d_due is None or d_pre <= d_due):
            ref_row0[idx] = ref_row1[idx] = d_pre  # pre-seed: spot, no interp
            ref_alpha[idx] = 0.0
        else:
            ref_row0[idx], ref_row1[idx], ref_alpha[idx] = _interp_rows(dates, k)

    anchor_idx = np.zeros(n_times, dtype=np.int64)
    t_proj = np.zeros((n_times, K))
    if legacy:
        # fixing exists from its stamping row on; hist refs resolve from
        # the static map at every t (get_cpi_level legacy order). Future
        # refs read the pathwise CPI-level term structure LINEARLY at
        # yf(d_t, k) (inflation_pv.py cpi_interp).
        pub_mask = (
            np.arange(n_times)[:, None] >= stamp_row[None, :]
        ) | ref_hist[None, :]
        for t_idx, d in enumerate(dates):
            for idx, k in enumerate(refs):
                if not pub_mask[t_idx, idx]:
                    t_proj[t_idx, idx] = _yf(d, k, sc.curve_day_count)
        W_infl = np.stack(
            [
                _interp_weight_matrix(tenors, t_proj[t], hermite=False)
                for t in range(n_times)
            ]
        )
    else:
        pub_mask = np.zeros((n_times, K), dtype=bool)
        for t_idx, d in enumerate(dates):
            a = anchors[t_idx]
            anchor_idx[t_idx] = ref_pos[a]
            for idx, k in enumerate(refs):
                pub_mask[t_idx, idx] = k <= a
                if k > a:
                    t_proj[t_idx, idx] = _yf(a, k, sc.curve_day_count)
        W_infl = np.stack(
            [_weights_for(tenors, t_proj[t], Tm) for t in range(n_times)]
        )

    j_idx = np.array([ref_pos[j] for j, _ in brackets], dtype=np.int64)
    j1_idx = np.array([ref_pos[j1] for _, j1 in brackets], dtype=np.int64)

    infl = DeviceILSTensors(
        cpi_name=leg.cpi_curve_name,
        infl_name=leg.inflation_rate_curve_name or "",
        legacy=legacy,
        discount_name=ils.discount_curve_name,
        sign=sign,
        notional=float(ils.notional),
        real_rate=float(leg.real_rate),
        base_cpi=float(leg.base_cpi),
        pay_notional_at_maturity=bool(leg.pay_notional_at_maturity),
        live=live, is_last_pay=is_last_pay, accrual=accrual,
        t_pay=t_pay, W_disc=W_disc,
        ref_row0=ref_row0, ref_row1=ref_row1, ref_alpha=ref_alpha,
        ref_hist=ref_hist, ref_hist_val=ref_hist_val,
        pub_mask=pub_mask, anchor_idx=anchor_idx,
        W_infl=W_infl, t_proj=t_proj,
        j_idx=j_idx, j1_idx=j1_idx, frac=frac,
    )

    nominal = build_leg_tensors(
        ils.nominal_schedule, ils.nominal_leg, -sign,
        scenario_dates, tenors,
        sc=sc, notional=ils.notional, discount_name=ils.discount_curve_name,
        include_on=lambda d: ils.include_sim_date_cashflows,
    )
    mat_mask = np.array([d <= ils._effective_maturity for d in dates])
    nominal.live = nominal.live & mat_mask[:, None]
    return [infl, nominal]


def _yf(d0, d1, convention):
    return year_fraction(d0, d1, convention)


def _ils_mtm(ils_t: DeviceILSTensors, curves, scalars):
    """(n_times, n_paths) inflation-leg MTM on its tensors' device."""
    disc = curves[ils_t.discount_name]

    def published_refs(cpi):
        """(K, n_paths) stamped or historical CPI per reference month:
        a two-row gather + lerp of the (t, p) CPI fixings."""
        c0 = cpi.index_select(0, ils_t.ref_row0)
        c1 = cpi.index_select(0, ils_t.ref_row1)
        a = ils_t.ref_alpha[:, None]
        stamped = (1.0 - a) * c0 + a * c1
        return torch.where(ils_t.ref_hist[:, None], ils_t.ref_hist_val[:, None], stamped)

    if ils_t.legacy:
        # CPI factor IS a pathwise level term structure; stamped fixings
        # take its FIRST column (the spot level) at the stamping rows,
        # unstamped refs interpolate the sim-date curve linearly.
        cpi_cube = curves[ils_t.cpi_name]         # (n_times, n_paths, n_ten)
        # stamped fixings are historical -> base factor under SIMM bumps
        published = published_refs(curves[ils_t.frozen_cpi_name or ils_t.cpi_name][:, :, 0])
        future = torch.bmm(cpi_cube, ils_t.W_infl)                     # (t, p, K)
        cpi_tk = torch.where(ils_t.pub_mask[:, None, :], published.T[None, :, :], future)
    else:
        # stamped refs are historical fixings -> base scalar under bumps
        published = published_refs(scalars[ils_t.frozen_cpi_name or ils_t.cpi_name])
        infl = curves[ils_t.infl_name]            # (n_times, n_paths, n_ten)
        # projection: anchor CPI / DF_infl with the sim-date curve
        r_proj = torch.bmm(infl, ils_t.W_infl)
        df_infl = torch.exp(r_proj * -ils_t.t_proj[:, None, :])
        anchor_val = published.index_select(0, ils_t.anchor_idx)      # (t, n_paths)
        projected = anchor_val[:, :, None] / df_infl                   # (t, p, K)
        cpi_tk = torch.where(ils_t.pub_mask[:, None, :], published.T[None, :, :], projected)

    cpi_j = cpi_tk.index_select(2, ils_t.j_idx)
    cpi_j1 = cpi_tk.index_select(2, ils_t.j1_idx)
    fr = ils_t.frac[None, None, :]
    index_ratio = (cpi_j + fr * (cpi_j1 - cpi_j)) / ils_t.base_cpi

    coupon = ils_t.accrual * ils_t.real_rate                           # (m,)
    if ils_t.pay_notional_at_maturity:
        coupon = coupon + ils_t.is_last_pay.to(coupon.dtype)
    cf = ils_t.notional * index_ratio * coupon[None, None, :]
    r_pay = torch.bmm(disc, ils_t.W_disc)
    df_pay = torch.exp(r_pay * -ils_t.t_pay[:, None, :])
    live = ils_t.live[:, None, :]
    return torch.where(live, df_pay * cf, 0.0).sum(dim=2) * ils_t.sign


@dataclass
class DeviceSurfaceTensors:
    """PDE-surface exotics on the device path (instruments/equity_barrier,
    instruments/american_option): per-date value surfaces become a row
    gather + row-wise linear interpolation of the simulated spots; the
    barrier's survival state is the OR over stamped monitor-date spot
    crossings (the same two-row lerp the host engine's equity-fixing cache
    produces). ``s_nodes`` and the surfaces are the instrument's own
    device tensors."""

    spot_name: str
    kind: str                 # "ko" | "in" | "american"
    rebate_at_hit: bool
    quantity: float
    rate: float
    rebate: float
    already_hit: np.ndarray   # () bool
    lower: np.ndarray         # () — 0 when absent
    upper: np.ndarray
    has_lower: np.ndarray     # () bool
    has_upper: np.ndarray
    is_live: np.ndarray       # (n_times,) d < maturity
    live_idx: np.ndarray      # (n_times,) surface row (0 where dead)
    tau: np.ndarray           # (n_times,) yf(d, maturity)
    s_nodes: torch.Tensor     # (n_rows, N)
    v_main: torch.Tensor      # (n_rows, N) KO / American surface
    v_van: Optional[torch.Tensor] = None   # (n_rows, N), "in" only
    mon_row0: Optional[np.ndarray] = None  # (n_mon,) int
    mon_row1: Optional[np.ndarray] = None
    mon_alpha: Optional[np.ndarray] = None
    mon_active: Optional[np.ndarray] = None  # (n_times, n_mon) mon <= d
    # stamped monitor-date spots (barrier hit state) keep the base scalar
    # under SIMM bumps ("" = spot_name)
    frozen_spot_name: str = ""


def build_surface_tensors(inst, scenario_dates: Sequence[dt.date], tenors):
    """[DeviceSurfaceTensors] for EquityBarrierOption /
    AmericanOptionPosition. Surfaces must already exist (the engine calls
    ``build_surfaces`` before tensorizing)."""
    from ..instruments.equity_barrier import _IN_TYPES

    if getattr(inst, "_surfaces", None) is None:
        raise RuntimeError(
            f"{type(inst).__name__} {inst.name!r}: build_surfaces/precompute "
            "must run before the device exposure path tensorizes it"
        )
    dates = list(scenario_dates)
    n_times = len(dates)
    is_live = np.array([d < inst.maturity_date for d in dates])
    live_idx = np.zeros(n_times, dtype=np.int64)
    tau = np.zeros(n_times)
    for t_idx, d in enumerate(dates):
        if not is_live[t_idx]:
            continue
        live_idx[t_idx] = inst._surfaces[d]
        tau[t_idx] = year_fraction(d, inst.maturity_date, inst.day_count)

    is_american = not hasattr(inst, "barrier_type")
    if is_american:
        kind = "american"
        v_main = inst._v
        kw: Dict = {}
        lower = upper = 0.0
        has_lower = has_upper = False
        already = False
        rebate = 0.0
        rebate_at_hit = False
    else:
        kind = "in" if inst.barrier_type in _IN_TYPES else "ko"
        v_main = inst._v_ko
        has_lower = inst.barrier_type.startswith(("down", "double"))
        has_upper = inst.barrier_type.startswith(("up", "double"))
        lower = inst.lower_barrier if has_lower else 0.0
        upper = inst.upper_barrier if has_upper else 0.0
        already = inst.already_hit
        rebate = inst.rebate
        rebate_at_hit = inst.rebate_at_hit
        n_mon = len(inst.monitor_dates)
        mon_row0 = np.zeros(n_mon, dtype=np.int64)
        mon_row1 = np.zeros(n_mon, dtype=np.int64)
        mon_alpha = np.zeros(n_mon)
        mon_active = np.zeros((n_times, n_mon), dtype=bool)
        for j, m in enumerate(inst.monitor_dates):
            mon_row0[j], mon_row1[j], mon_alpha[j] = _interp_rows(dates, m)
            for t_idx, d in enumerate(dates):
                mon_active[t_idx, j] = m <= d
        kw = dict(
            mon_row0=mon_row0, mon_row1=mon_row1, mon_alpha=mon_alpha,
            mon_active=mon_active,
        )
        if kind == "in":
            kw.update(v_van=inst._v_van)

    return [
        DeviceSurfaceTensors(
            spot_name=inst.spot_name,
            kind=kind,
            rebate_at_hit=bool(rebate_at_hit),
            quantity=float(inst.quantity),
            rate=float(inst.rate),
            rebate=float(rebate),
            already_hit=np.asarray(already, dtype=bool),
            lower=np.asarray(float(lower)),
            upper=np.asarray(float(upper)),
            has_lower=np.asarray(bool(has_lower)),
            has_upper=np.asarray(bool(has_upper)),
            is_live=is_live, live_idx=live_idx, tau=tau,
            s_nodes=inst._s_nodes, v_main=v_main, **kw,
        )
    ]


def _surface_mtm(st: DeviceSurfaceTensors, curves, scalars):
    """(n_times, n_paths) surface-exotic MTM on its tensors' device."""
    spot = scalars[st.spot_name]                       # (t, p)
    rows = st.live_idx
    s_t = st.s_nodes.index_select(0, rows)             # (t, N)

    def interp(v):
        return linear_interp(spot, s_t, v.index_select(0, rows))

    main = interp(st.v_main)
    if st.kind == "american":
        val = main
    else:
        # stamped monitor spots (hit state) are historical -> base scalar
        spot_fz = scalars[st.frozen_spot_name or st.spot_name]
        sm0 = spot_fz.index_select(0, st.mon_row0)     # (n_mon, p)
        sm1 = spot_fz.index_select(0, st.mon_row1)
        a = st.mon_alpha[:, None]
        sm = (1.0 - a) * sm0 + a * sm1
        crossed = (st.has_lower & (sm <= st.lower)) | (
            st.has_upper & (sm >= st.upper)
        )                                              # (n_mon, p)
        hit = st.already_hit | torch.any(
            st.mon_active[:, :, None] & crossed[None, :, :], dim=1
        )                                              # (t, p)
        rebate_df = (st.rebate * torch.exp(-st.rate * st.tau))[:, None]  # (t, 1)
        if st.kind == "ko":
            dead = torch.zeros_like(main) if st.rebate_at_hit else rebate_df.expand_as(main)
            val = torch.where(hit, dead, main)
        else:  # knock-in: KI(R) = vanilla - KO(R at expiry) + R*DF
            # (equity_barrier.scenario_npvs parity form; the KI rebate
            # pays at expiry iff the barrier is never touched)
            van = interp(st.v_van)
            val = torch.where(hit, van, van - main + rebate_df)
    return st.quantity * val * st.is_live.to(val.dtype)[:, None]


@dataclass
class DeviceCommodityTensors:
    """Commodity (average-)forward tensors (instruments/commodity.py on
    device): each averaging ref is a stamped fixing once its pricing date
    passes (linear forward-curve interp at the FIXED tenor yf(pricing,
    avg), state lerped to the pricing date) or a live linear interp at
    yf(d_t, avg); NPV = DF(t_pay) * N * (mean_ref - K)."""

    fwd_name: str
    discount_name: str
    notional: float
    strike: float
    live: np.ndarray        # (n_times,) d <= payment
    t_pay: np.ndarray       # (n_times,)
    W_disc: np.ndarray      # (n_times, n_tenors) hermite-rt at t_pay
    stamped: np.ndarray     # (n_times, m) pricing_j <= d
    fix_row0: np.ndarray    # (m,) int
    fix_row1: np.ndarray
    fix_alpha: np.ndarray   # (m,)
    Wfz: np.ndarray         # (n_tenors, m) linear at yf(pricing_j, avg_j)
    W_fwd: np.ndarray       # (n_times, n_tenors, m) linear at yf(d, avg_j)
    frozen_fwd_name: str = ""  # base curve for stamped refs (close-out)


def build_commodity_tensors(inst, scenario_dates: Sequence[dt.date], tenors):
    """[DeviceCommodityTensors] for CommodityForwardInstrument /
    CommodityAverageForwardInstrument."""
    dates = list(scenario_dates)
    n_times = len(dates)
    Tm = _tangent_matrix(tenors) if tenors.size > 1 else None
    schedule = inst.get_commodity_fixing_schedule()
    m = len(schedule)
    pay = getattr(inst, "payment_date", None) or inst.delivery_date
    dc = inst.day_count

    live = np.array([d <= pay for d in dates])
    t_pay = np.array(
        [max(0.0, year_fraction(d, pay, dc)) for d in dates]
    )
    W_disc = np.stack(
        [_weights_for(tenors, np.array([t_pay[t]]), Tm)[:, 0]
         for t in range(n_times)]
    )

    stamped = np.zeros((n_times, m), dtype=bool)
    t_fwd = np.zeros((n_times, m))
    fix_row0 = np.zeros(m, dtype=np.int64)
    fix_row1 = np.zeros(m, dtype=np.int64)
    fix_alpha = np.zeros(m)
    tz = np.zeros(m)
    for j, (avg, pricing, _fx) in enumerate(schedule):
        fix_row0[j], fix_row1[j], fix_alpha[j] = _interp_rows(dates, pricing)
        tz[j] = year_fraction(pricing, avg, dc)
        for t_idx, d in enumerate(dates):
            stamped[t_idx, j] = pricing <= d
            t_fwd[t_idx, j] = year_fraction(d, avg, dc)
    Wfz = _interp_weight_matrix(tenors, tz, hermite=False)
    W_fwd = np.stack(
        [_interp_weight_matrix(tenors, t_fwd[t], hermite=False)
         for t in range(n_times)]
    )
    return [
        DeviceCommodityTensors(
            fwd_name=inst.forward_curve_name,
            discount_name=inst.discount_curve_name,
            notional=float(inst.notional),
            strike=float(inst.strike),
            live=live, t_pay=t_pay, W_disc=W_disc,
            stamped=stamped, fix_row0=fix_row0, fix_row1=fix_row1,
            fix_alpha=fix_alpha, Wfz=Wfz, W_fwd=W_fwd,
        )
    ]


def _commodity_mtm(ct: DeviceCommodityTensors, curves, scalars):
    """(n_times, n_paths) commodity (average-)forward MTM on its tensors'
    device."""
    fwd = curves[ct.fwd_name]                     # (t, p, n)
    frozen = curves[ct.frozen_fwd_name or ct.fwd_name]
    disc = curves[ct.discount_name]
    # stamped refs: lerp the pricing-date rows, fixed-tenor linear interp
    # (STAMPED -> base curve under FORWARD close-out)
    s0 = torch.einsum("mpn,nm->pm", frozen.index_select(0, ct.fix_row0), ct.Wfz)
    s1 = torch.einsum("mpn,nm->pm", frozen.index_select(0, ct.fix_row1), ct.Wfz)
    a = ct.fix_alpha[None, :]
    fixed = (1.0 - a) * s0 + a * s1               # (p, m)
    livefwd = torch.bmm(fwd, ct.W_fwd)            # (t, p, m)
    ref = torch.where(ct.stamped[:, None, :], fixed[None, :, :], livefwd).mean(dim=2)  # (t, p)
    r_pay = torch.bmm(disc, ct.W_disc[:, :, None])[:, :, 0]
    df = torch.exp(r_pay * -ct.t_pay[:, None])
    return df * ct.notional * (ref - ct.strike) * ct.live.to(df.dtype)[:, None]


def _on_device(leg, device: torch.device, dtype: torch.dtype):
    """``leg`` with every array field a tensor on ``device``: floating
    fields in ``dtype``, masks bool, row indices int64 (for
    ``index_select``)."""
    kw = {}
    for f in dataclasses.fields(leg):
        v = getattr(leg, f.name)
        if not (isinstance(v, np.ndarray) or torch.is_tensor(v)):
            continue
        t = torch.as_tensor(v)
        if t.is_floating_point():
            kw[f.name] = t.to(device=device, dtype=dtype)
        elif t.dtype == torch.bool:
            kw[f.name] = t.to(device=device)
        else:
            kw[f.name] = t.to(device=device, dtype=torch.int64)
    return dataclasses.replace(leg, **kw)


def _pin_frozen_sources(legs):
    """Pin every stamped-fixing read onto a ``<name>#base`` alias.

    The generic engine's SIMM pass re-prices the netting set under a
    bumped market state while historical fixings stay stamped from the
    UNBUMPED states (exposure_engine.py:224-241: ``price_all`` closes
    over fixings built once from ``all_states``). On the device path the
    stamped reads gather from the factor cubes themselves, so a bump of
    a live cube would (wrongly) move the history too. Redirecting each
    leg's ``frozen_*`` field to an alias entry that always holds the base
    cube makes bumps hit only the live reads.

    The pinned legs are ``dataclasses.replace`` copies: the cached legs
    (:func:`_legs_for`) are never changed, so a plain call after a SIMM
    call prices exactly as before it. Returns ``(pinned_legs,
    curve_aliases, scalar_aliases)`` where the alias dicts map
    ``<name>#base`` -> ``<name>`` for the caller to mirror into its curves
    / scalars dicts.
    """
    curve_alias: Dict[str, str] = {}
    scalar_alias: Dict[str, str] = {}

    def _curve(name: str) -> str:
        alias = name + "#base"
        curve_alias[alias] = name
        return alias

    def _scalar(name: str) -> str:
        alias = name + "#base"
        scalar_alias[alias] = name
        return alias

    pinned = []
    for leg in legs:
        kw = {}
        if isinstance(leg, DeviceTRSTensors):
            kw["frozen_spot_name"] = _scalar(leg.frozen_spot_name or leg.spot_name)
        elif isinstance(leg, DeviceILSTensors):
            tgt = leg.frozen_cpi_name or leg.cpi_name
            kw["frozen_cpi_name"] = _curve(tgt) if leg.legacy else _scalar(tgt)
        elif isinstance(leg, DeviceCommodityTensors):
            kw["frozen_fwd_name"] = _curve(leg.frozen_fwd_name or leg.fwd_name)
        elif isinstance(leg, DeviceSurfaceTensors):
            if leg.mon_row0 is not None:
                kw["frozen_spot_name"] = _scalar(leg.frozen_spot_name or leg.spot_name)
        else:  # DeviceLegTensors
            if not leg.is_fixed and leg.curve_name:
                kw["frozen_curve_name"] = _curve(leg.frozen_curve_name or leg.curve_name)
            if leg.eq_spot_name:
                kw["frozen_eq_spot_name"] = _scalar(leg.frozen_eq_spot_name or leg.eq_spot_name)
        pinned.append(dataclasses.replace(leg, **kw) if kw else leg)
    return tuple(pinned), curve_alias, scalar_alias


_MTM_OF = {
    DeviceTRSTensors: _trs_mtm,
    DeviceILSTensors: _ils_mtm,
    DeviceCommodityTensors: _commodity_mtm,
    DeviceSurfaceTensors: _surface_mtm,
    DeviceLegTensors: _leg_mtm,
}


def _netting_mtm(curves, scalars, legs, scales, fx_names):
    """(n_paths, n_times) netting-set MTM: the sum over legs of each leg's
    MTM times its notional scale, converted by its FX factor."""
    total = None
    for leg_t, scale, fx in zip(legs, scales, fx_names):
        piece = _MTM_OF[type(leg_t)](leg_t, curves, scalars) * scale
        if fx is not None:
            piece = piece * scalars[fx]  # (n_times, n_paths) FX conversion
        total = piece if total is None else total + piece
    return total.T  # (n_paths, n_times)


# leg tensors are pure functions of (instrument, dates, tenors): cache them,
# and their device copies per (device, dtype), so steady-state pipeline
# calls skip the host schedule/weight rebuild and the host-to-device copy.
_LEG_CACHE: Dict[tuple, dict] = {}


def _legs_for(instruments, dates, tenors, device: torch.device, dtype: torch.dtype):
    """(flat device legs tuple, per-instrument leg counts), cached."""
    key = (
        tuple(id(i) for i in instruments),
        tuple(dates),
        np.asarray(tenors).tobytes(),
    )
    hit = _LEG_CACHE.get(key)
    if hit is None or not all(a is b for a, b in zip(hit["instruments"], instruments)):
        per_inst = [
            _build_instrument_tensors(inst, list(dates), np.asarray(tenors))
            for inst in instruments
        ]
        hit = {
            "instruments": tuple(instruments),
            "legs": tuple(leg_t for ts in per_inst for leg_t in ts),
            "counts": tuple(len(ts) for ts in per_inst),
            "on_device": {},
        }
        _LEG_CACHE[key] = hit
        if len(_LEG_CACHE) > 64:
            _LEG_CACHE.pop(next(iter(_LEG_CACHE)))
    where = (str(device), dtype)
    if where not in hit["on_device"]:
        hit["on_device"][where] = tuple(_on_device(leg, device, dtype) for leg in hit["legs"])
    return hit["on_device"][where], hit["counts"]


def _build_instrument_tensors(inst, dates, tenors):
    # the families before the surface and swap tests: an EquityTRS carries
    # an interest leg, and the order is JAX's
    if isinstance(inst, EquityTRS):
        return build_trs_tensors(inst, dates, tenors)
    if isinstance(inst, IndexLinkedSwap):
        return build_ils_tensors(inst, dates, tenors)
    if isinstance(inst, (CommodityForwardInstrument, CommodityAverageForwardInstrument)):
        return build_commodity_tensors(inst, dates, tenors)
    if hasattr(inst, "build_surfaces"):
        return build_surface_tensors(inst, dates, tenors)
    if isinstance(inst, IRSwap):
        return build_irswap_tensors(inst, dates, tenors)
    raise NotImplementedError(
        f"device exposure path does not support {type(inst).__name__}; "
        "use the generic ExposureEngine"
    )


class DeviceExposureEngine:
    """All-dates exposure for device-expressible netting sets.

    ``curves``: dict name -> (n_times, n_paths, n_tenors) cube (numpy or a
    tensor); ``scalars``: dict name -> (n_times, n_paths) spot/FX factors.
    ``tenors``: shared tenor grid. The exposure runs on ``device`` (``cuda``
    unless the caller passes ``"cpu"``; without a card the default raises)
    in the cubes' dtype (float64 unless every cube is float32); factors
    are moved there on each call. After a SIMM :meth:`compute`,
    ``simm_runs`` holds the number of netting runs it made (the base run
    and one per bump).

    A factor may be a ``parallel.mesh.Sharded`` split along its path axis
    (dim 1; every sharded factor split alike): :meth:`mtm` (and
    :meth:`compute` through it) then runs each path shard on its device,
    the unsharded factors split the same way, and gathers the MTM on
    ``device``. A SIMM CSA gathers the factors on ``device`` first, since
    each bump re-prices the whole cube.
    """

    def __init__(
        self,
        scenario_dates: Sequence[dt.date],
        curves: Dict[str, np.ndarray],
        tenors: np.ndarray,
        scalars: Optional[Dict[str, np.ndarray]] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.dates = list(scenario_dates)
        self.curves = curves
        self.scalars = scalars or {}
        self.tenors = np.asarray(tenors, dtype=np.float64)
        self.device = resolve_device(device)
        self.simm_runs = 0

    def _factors(self, gather: bool = False):
        """([(device, curves, scalars), ...], dtype): the factor cubes as
        tensors in one dtype, one entry per path shard, on its device. With
        no sharded factor, or with ``gather``, one entry on the engine's
        device (a sharded factor gathered there); else the sharded factors'
        own shards, and every other factor split along its path axis into
        the same sizes and devices."""
        factors = [dict(self.curves), dict(self.scalars)]
        sharded = [v for f in factors for v in f.values() if isinstance(v, Sharded)]
        if gather or not sharded:
            devices, sizes = (self.device,), None
            factors = [{k: v.gather(self.device) if isinstance(v, Sharded) else v for k, v in f.items()}
                       for f in factors]
        else:
            devices, sizes = sharded[0].devices, sharded[0].sizes
            if any(v.dim != 1 or v.devices != devices or v.sizes != sizes for v in sharded):
                raise ValueError("sharded factors must all be split along their path axis "
                                 "(dim 1) into the same shards on the same devices")
        dtypes = {v.dtype if isinstance(v, Sharded) else torch.as_tensor(v).dtype
                  for f in factors for v in f.values()}
        dtype = torch.float32 if dtypes == {torch.float32} else torch.float64
        if dtype == torch.float32 and "cuda" in {d.type for d in devices}:
            from ..models.pde.spectral import tf32_enabled

            if tf32_enabled():
                raise ValueError(
                    "the float32 exposure contractions need full float32 "
                    "matmuls, but TF32 is enabled (torch.backends.cuda.matmul); "
                    "disable it or pass float64 cubes"
                )

        def shards(v):
            if isinstance(v, Sharded):
                return tuple(t.to(dtype) for t in v.shards)
            t = torch.as_tensor(v, device=devices[0]).to(dtype)
            return (t,) if sizes is None else split_rows(t, sizes, devices, dim=1)

        split = [{k: shards(v) for k, v in f.items()} for f in factors]
        parts = [(d, *({k: t[i] for k, t in f.items()} for f in split)) for i, d in enumerate(devices)]
        return parts, dtype

    def _prepare(
        self,
        instruments: Sequence[IRSwap],
        notional_scales=None,
        fx_factors: Optional[Sequence[Optional[str]]] = None,
        risky_curve=None,
        dtype: torch.dtype = torch.float64,
        device: Optional[torch.device] = None,
    ):
        """(legs, scales, fx_names) ready for :func:`_netting_mtm`, the legs
        on ``device`` (default: the engine's).

        ``risky_curve``: FORWARD close-out substitution — a single curve
        name applied to every trade, or a per-instrument sequence (the
        per-currency dict form of ``CSA.risky_curve_name`` resolved by
        :meth:`compute`); ``None`` entries leave that trade unsubstituted.
        """
        # surface exotics: build their per-date value surfaces first (the
        # generic engine does this via the precompute hook; here the grid
        # center comes from the scalar spot cube's first row, averaged on
        # the host as the generic engine averages it)
        for inst in instruments:
            if (
                hasattr(inst, "build_surfaces")
                and getattr(inst, "_surfaces", None) is None
            ):
                spot = self.scalars[inst.spot_name]
                row0 = (spot.gather() if isinstance(spot, Sharded) else spot)[0]
                row0 = row0.cpu().numpy() if torch.is_tensor(row0) else np.asarray(row0)
                inst.build_surfaces(float(np.mean(row0)), self.dates)
        legs, counts = _legs_for(
            tuple(instruments), self.dates, self.tenors, device or self.device, dtype
        )
        if risky_curve is None or isinstance(risky_curve, str):
            risky_list = [risky_curve] * len(instruments)
        else:
            risky_list = list(risky_curve)
            if len(risky_list) != len(instruments):
                # zip truncation below would silently drop instruments
                raise ValueError(
                    f"risky_curve has {len(risky_list)} entries for "
                    f"{len(instruments)} instruments"
                )
        if any(r is not None for r in risky_list):
            # FORWARD close-out: the generic engine rebinds the market
            # state entry under each trade's discount-curve NAME to the
            # risky curve (exposure_engine._pricing_market_state), which
            # also redirects same-named projection lookups — replicate by
            # renaming every matching curve field on the trade's tensors.
            swapped: List = []
            it = iter(legs)
            for inst, c, risky in zip(instruments, counts, risky_list):
                disc = getattr(inst, "discount_curve_name", None)
                for leg_t in (next(it) for _ in range(c)):
                    if risky is None or disc is None or disc == risky:
                        swapped.append(leg_t)
                        continue
                    kw = {
                        f: risky
                        for f in (
                            "curve_name", "discount_name", "carry_name",
                            "div_name", "infl_name", "fwd_name", "cpi_name",
                            "eq_carry_name", "eq_div_name",
                        )
                        if getattr(leg_t, f, None) == disc
                    }
                    # stamped/realized quantities keep the base curve
                    if "curve_name" in kw and hasattr(leg_t, "frozen_curve_name"):
                        kw["frozen_curve_name"] = leg_t.frozen_curve_name or disc
                    if "fwd_name" in kw and hasattr(leg_t, "frozen_fwd_name"):
                        kw["frozen_fwd_name"] = leg_t.frozen_fwd_name or disc
                    if "cpi_name" in kw and hasattr(leg_t, "frozen_cpi_name"):
                        kw["frozen_cpi_name"] = leg_t.frozen_cpi_name or disc
                    swapped.append(
                        dataclasses.replace(leg_t, **kw) if kw else leg_t
                    )
            legs = tuple(swapped)
        notional_scales = notional_scales or [1.0] * len(instruments)
        fx_factors = fx_factors or [None] * len(instruments)
        if len(notional_scales) != len(instruments) or len(fx_factors) != len(
            instruments
        ):
            raise ValueError(
                f"notional_scales ({len(notional_scales)}) and fx_factors "
                f"({len(fx_factors)}) must match {len(instruments)} "
                "instruments"
            )
        scales = tuple(
            float(s) for s, c in zip(notional_scales, counts) for _ in range(c)
        )
        fx_names = tuple(
            f for f, c in zip(fx_factors, counts) for _ in range(c)
        )
        return legs, scales, fx_names

    def mtm(
        self,
        instruments: Sequence[IRSwap],
        notional_scales=None,
        fx_factors: Optional[Sequence[Optional[str]]] = None,
        risky_curve=None,
    ) -> torch.Tensor:
        """(n_paths, n_times) netting-set MTM, a tensor on the engine's device.

        Leg tensors are cached per (instruments, dates, tenors) with their
        device copies, so repeated calls (a pricing service, the CVA
        pipeline) pay the host cost and the copy once.
        ``fx_factors``: per-instrument scalar-factor name converting the
        trade currency to the reporting currency (None = same currency),
        mirroring the generic engine's fx_rate_factor handling. Over
        path-sharded factors each shard runs on its device (the work issued
        shard by shard from this thread) and the MTM is gathered here.
        """
        parts, dtype = self._factors()
        out = []
        for device, curves, scalars in parts:
            with on_device(device):
                legs, scales, fx_names = self._prepare(
                    instruments, notional_scales, fx_factors, risky_curve, dtype, device
                )
                out.append(_netting_mtm(curves, scalars, legs, scales, fx_names))
        if len(out) == 1:
            return out[0].to(self.device)
        return torch.cat([m.to(self.device) for m in out], dim=0)

    def compute(
        self, instruments: Sequence[IRSwap], netting_set_id: str = "NS",
        currency: str = "ZAR", notional_scales=None, fx_factors=None,
        csa=None, currencies: Optional[Sequence[Optional[str]]] = None,
    ) -> ExposureProfile:
        """ExposureProfile (numpy fields) with CSA support on the device path.

        ``currencies``: per-instrument trade currency (None entries fall
        back to the reporting ``currency``) — only consulted to key the
        per-currency dict form of ``CSA.risky_curve_name``, mirroring the
        generic engine's per-trade resolution
        (exposure_engine._pricing_market_state; ref
        exposure_engine.py:552-587). The collateral simulation runs on the
        host on the (n_paths, n_times) MTM, shared with the generic engine;
        under a SIMM CSA the pathwise IM comes from :meth:`_simm_im_paths`.
        """
        from types import SimpleNamespace

        risky = None
        if csa is not None:
            if csa.close_out_method is CloseOutMethod.FORWARD and (
                csa.risky_curve_name is not None
            ):
                rn = csa.risky_curve_name
                if isinstance(rn, dict):
                    # unknown currencies / absent curves leave the trade
                    # unsubstituted, exactly like the generic engine
                    ccys = (
                        list(currencies)
                        if currencies is not None
                        else [None] * len(instruments)
                    )
                    if len(ccys) != len(instruments):
                        raise ValueError(
                            f"currencies has {len(ccys)} entries for "
                            f"{len(instruments)} instruments"
                        )
                    risky = [
                        r if r in self.curves else None
                        for r in (rn.get(c or currency) for c in ccys)
                    ]
                    missing = sorted(
                        {
                            r
                            for r in (rn.get(c or currency) for c in ccys)
                            if r is not None and r not in self.curves
                        }
                    )
                    if all(r is None for r in risky):
                        risky = None
                else:
                    risky = rn if rn in self.curves else None
                    missing = [] if risky is not None else [rn]
                if missing:
                    # generic-engine semantics (absent curve -> riskless),
                    # but a typo'd name on a close-out path deserves noise
                    warnings.warn(
                        f"FORWARD close-out risky curve(s) {missing} not in "
                        "engine curves; affected trades price on the "
                        "riskless curve",
                        stacklevel=2,
                    )
        is_simm = csa is not None and csa.im_method is InitialMarginMethod.SIMM
        im_fn = None
        if is_simm:
            # the SIMM base run IS the profile MTM: reuse it
            im_paths, mtm = self._simm_im_paths(
                instruments, notional_scales, fx_factors, csa, risky
            )
            date_idx = {d: i for i, d in enumerate(self.dates)}
            im_fn = lambda n, d: im_paths[:, date_idx[d]]
        else:
            mtm = self.mtm(
                instruments, notional_scales, fx_factors, risky_curve=risky
            ).cpu().numpy()
        if (
            csa is not None
            and not is_simm
            and csa.im_method is not None
            and csa.im_method is not InitialMarginMethod.NONE
        ):
            scales = notional_scales or [1.0] * len(instruments)
            ns_shim = SimpleNamespace(
                trades=[
                    SimpleNamespace(instrument=i, notional_scale=s)
                    for i, s in zip(instruments, scales)
                ]
            )
            im_fn = lambda n, d: compute_im(n, csa, d, ns_shim)
        collateral = (
            simulate_collateral(mtm, self.dates, csa, im_fn=im_fn)
            if csa is not None
            else np.zeros_like(mtm)
        )
        net = mtm - collateral
        return ExposureProfile(
            netting_set_id=netting_set_id,
            dates=tuple(self.dates),
            mtm=mtm,
            collateral=collateral,
            exposure=np.maximum(net, 0.0),
            neg_exposure=np.minimum(net, 0.0),
            currency=currency,
        )

    def _simm_im_paths(
        self, instruments, notional_scales, fx_factors, csa, risky_curve,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """((n_paths, n_times) pathwise SIMM delta margin, base MTM), both
        host arrays.

        Mirrors ``ExposureEngine._simm_im_paths``: every curve cube a leg
        reads live gets +1bp-per-SIMM-bucket bumps, every such scalar
        factor a +1%% relative bump, and the finite-difference netting-set
        sensitivities aggregate through ``portfolio.simm``. Historical
        fixings stay at base through the :func:`_pin_frozen_sources`
        aliases, and each output column t of the netting MTM reads live
        factors only at row t, so bumping the WHOLE cube gives the per-date
        sensitivities of every simulation date in one netting run:
        (n_buckets + n_scalars) runs in all instead of n_times x that. The
        bumped differences and the aggregation stay on the engine's
        device; the IM and the base MTM come back to the host once each.
        Path-sharded factors are gathered on the engine's device first: a
        bump moves a factor's whole cube.
        """
        cfg = csa.simm_config or SimmConfig()
        p = cfg.params
        [(_, curves, scalars)], dtype = self._factors(gather=True)
        legs, scales, fx_names = self._prepare(
            instruments, notional_scales, fx_factors, risky_curve, dtype
        )
        legs, curve_alias, scalar_alias = _pin_frozen_sources(legs)
        for alias, live in curve_alias.items():
            curves[alias] = curves[live]
        for alias, live in scalar_alias.items():
            scalars[alias] = scalars[live]

        def run():
            return _netting_mtm(curves, scalars, legs, scales, fx_names)

        base = run()                                  # (n_paths, n_times)
        n_paths, n_times = base.shape
        self.simm_runs = 1

        # only bump factors some leg reads LIVE (the plain-name string
        # fields after pinning; '#base' aliases are frozen reads a bump
        # cannot move; tensor fields are no names) plus FX conversion
        # factors — an engine holding extra cubes (risky close-out curves,
        # unused currencies) would otherwise pay a run per bucket of every
        # unreferenced curve for sensitivities that are zero
        referenced = {f for f in fx_names if f}
        for leg_t in legs:
            for v in vars(leg_t).values():
                if isinstance(v, str) and not v.endswith("#base"):
                    referenced.add(v)

        buckets = assign_ir_buckets(self.tenors)
        shift = p.bump_bp * 1e-4
        ir_s = torch.zeros((n_paths, n_times, len(IR_TENORS)), dtype=dtype, device=self.device)
        has_ir = False
        for name in self.curves:
            if cfg.factors is not None and name not in cfg.factors:
                continue
            if name not in referenced:
                continue
            has_ir = True
            cube0 = curves[name]
            for k in np.unique(buckets):
                mask = torch.as_tensor(buckets == k, device=self.device).to(dtype)
                curves[name] = cube0 + shift * mask
                ir_s[:, :, int(k)] += (run() - base) / p.bump_bp
                self.simm_runs += 1
            curves[name] = cube0
        scalar_ws: Dict[str, list] = {}
        for name in self.scalars:
            if cfg.factors is not None and name not in cfg.factors:
                continue
            if name not in referenced:
                continue
            s0 = scalars[name]
            scalars[name] = s0 * (1.0 + p.bump_rel)
            s = (run() - base) * (0.01 / p.bump_rel)
            self.simm_runs += 1
            scalars[name] = s0
            if not bool(torch.any(s)):
                continue  # factor not referenced by any trade
            cls = cfg.scalar_class(name)
            scalar_ws.setdefault(cls, []).append(p.scalar_risk_weights[cls] * s)
        ws_ir = weight_ir_sensitivities(ir_s, p) if has_ir else None
        im = simm_im(ws_ir, scalar_ws or None, p).to(device=base.device, dtype=base.dtype)
        im = torch.broadcast_to(im, (n_paths, n_times))
        return im.cpu().numpy().copy(), base.cpu().numpy()
