"""Device-resident exposure fast path (the port of
``finite_difference_tpu.xva.device_exposure``: rates swaps, PDE-surface
exotics, FX conversion and the CSA).

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
device), with year-fractions measured from the reset date. PDE-surface
exotics (EquityBarrierOption, AmericanOptionPosition) read their per-date
value surfaces, which stay on the device, with one row-wise linear
interpolation of the simulated spots.

Every contraction is a plain torch op on ``device`` (``cuda`` unless the
caller passes ``"cpu"``), in the dtype of the factor cubes; no kernel of
the port's own runs here. The leg tensors are built on the host once per
(instruments, dates, tenors) and cached together with their device copies
per (device, dtype), so a steady call moves no weight tensor to the card.
The TRS, ILS and commodity families are not ported yet (ROADMAP.md queue
1 item 4b): the engine raises NotImplementedError for them, and for SIMM.
"""
from __future__ import annotations

import dataclasses
import datetime as dt
import warnings
from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..instruments.cashflow import LegType, SwapLeg
from ..instruments.ir_swap import IRSwap
from ..instruments.schedule import (
    ScheduleConfig,
    add_months,
    adjust,
    generate_sub_periods,
)
from ..market_data.yield_curve import _hermite_rt_weights, _tangent_matrix
from ..ops.interp import linear_interp
from ..portfolio.csa import SIMM_NOT_PORTED, CloseOutMethod, InitialMarginMethod
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
    # spot * exp((rc - rd)(t_s) * t_s); notional = quantity * that. The
    # TRS tensors that fill them come with the TRS family.
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


def _interp_rows(dates, d):
    """(i0, i1, alpha) reproducing _interp_scenario_state at date d."""
    i0 = max(0, bisect_right(dates, d) - 1)
    i1 = min(i0 + 1, len(dates) - 1)
    if i1 == i0 or dates[i0] == d:
        return i0, i0, 0.0
    span = (dates[i1] - dates[i0]).days
    alpha = (d - dates[i0]).days / span if span else 0.0
    return i0, i1, float(min(max(alpha, 0.0), 1.0))


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
    from ..utils.daycount import year_fraction as _yfd

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
        tau[t_idx] = _yfd(d, inst.maturity_date, inst.day_count)

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


def _netting_mtm(curves, scalars, legs, scales, fx_names):
    """(n_paths, n_times) netting-set MTM: the sum over legs of each leg's
    MTM times its notional scale, converted by its FX factor."""
    total = None
    for leg_t, scale, fx in zip(legs, scales, fx_names):
        if isinstance(leg_t, DeviceSurfaceTensors):
            piece = _surface_mtm(leg_t, curves, scalars) * scale
        else:
            piece = _leg_mtm(leg_t, curves, scalars) * scale
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
    if hasattr(inst, "build_surfaces"):
        return build_surface_tensors(inst, dates, tenors)
    if isinstance(inst, IRSwap):
        return build_irswap_tensors(inst, dates, tenors)
    # the TRS, ILS and commodity families wait for ROADMAP.md queue 1 item 4b
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
    are moved there on each call.
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

    def _factors(self):
        """(curves, scalars, dtype): the factor cubes as tensors on the
        engine's device in one dtype."""
        curves = {k: torch.as_tensor(v, device=self.device) for k, v in self.curves.items()}
        scalars = {k: torch.as_tensor(v, device=self.device) for k, v in self.scalars.items()}
        factors = [*curves.values(), *scalars.values()]
        float32 = bool(factors) and all(t.dtype == torch.float32 for t in factors)
        dtype = torch.float32 if float32 else torch.float64
        if dtype == torch.float32 and self.device.type == "cuda":
            from ..models.pde.spectral import tf32_enabled

            if tf32_enabled():
                raise ValueError(
                    "the float32 exposure contractions need full float32 "
                    "matmuls, but TF32 is enabled (torch.backends.cuda.matmul); "
                    "disable it or pass float64 cubes"
                )
        curves = {k: v.to(dtype) for k, v in curves.items()}
        scalars = {k: v.to(dtype) for k, v in scalars.items()}
        return curves, scalars, dtype

    def _prepare(
        self,
        instruments: Sequence[IRSwap],
        notional_scales=None,
        fx_factors: Optional[Sequence[Optional[str]]] = None,
        risky_curve=None,
        dtype: torch.dtype = torch.float64,
    ):
        """(legs, scales, fx_names) ready for :func:`_netting_mtm`.

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
                row0 = self.scalars[inst.spot_name][0]
                row0 = row0.cpu().numpy() if torch.is_tensor(row0) else np.asarray(row0)
                inst.build_surfaces(float(np.mean(row0)), self.dates)
        legs, counts = _legs_for(
            tuple(instruments), self.dates, self.tenors, self.device, dtype
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
                            "curve_name", "discount_name", "eq_carry_name",
                            "eq_div_name",
                        )
                        if getattr(leg_t, f, None) == disc
                    }
                    # stamped/realized quantities keep the base curve
                    if "curve_name" in kw:
                        kw["frozen_curve_name"] = leg_t.frozen_curve_name or disc
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
        mirroring the generic engine's fx_rate_factor handling.
        """
        curves, scalars, dtype = self._factors()
        legs, scales, fx_names = self._prepare(
            instruments, notional_scales, fx_factors, risky_curve, dtype
        )
        return _netting_mtm(curves, scalars, legs, scales, fx_names)

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
        host on the (n_paths, n_times) MTM, shared with the generic engine.
        """
        from types import SimpleNamespace

        if csa is not None and csa.im_method is InitialMarginMethod.SIMM:
            raise NotImplementedError(SIMM_NOT_PORTED)
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
        mtm = self.mtm(
            instruments, notional_scales, fx_factors, risky_curve=risky
        ).cpu().numpy()
        im_fn = None
        if (
            csa is not None
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
