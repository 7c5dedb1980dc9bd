"""Batched analytic sweeps: the closed forms over whole trade tables.

Counterpart of ``finite_difference_tpu.models.analytic.batch``:

- :func:`continuous_barrier_sweep` — Reiner-Rubinstein singles, image-series
  doubles and vanillas in one pass, selected per trade by masks (the
  unselected branch lanes are sanitized, so no NaN leaks through
  ``torch.where``, nor into its gradient);
- :func:`continuous_barrier_sweep_greeks` — batched greeks: bumps (the
  reference's convention: central spot bumps, one-sided vol bump per
  vol-POINT, the PDE driver's vega scale) or ``torch.func`` derivatives;
- :func:`bgk_discrete_sweep` — BGK/Hörfelt discretely monitored barrier
  prices (single and double OUT closed forms, IN via Black-76 parity,
  ``already_hit`` short-circuits, rebate legs with the per-monitor hazard
  PV) over trade arrays (discrete_barrier_bgk.py:248-336, 929-1016);
- :func:`bs93_sweep`, :func:`bs93_sweep_greeks`, :func:`bs2002_sweep` —
  American-approximation sweeps;
- :func:`monitoring_decision` — the host-side FIS n_lim rule
  (discrete_barrier_analytic_pricer.py:278-342) over trades (numpy), so a
  caller can route continuous-regime trades here and the rest to the CN
  batch (``models.pde.batch``).

The sweeps take numpy arrays or tensors and return tensors on ``device``
(default CUDA; pass ``device="cpu"`` on a machine without a card). Where
the JAX package vmaps (the hazard PV, the BS2002 quadrature), these
broadcast along a trailing axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, as_tensors
from ...ops.special import norm_cdf as N
from .bgk_horfelt import (
    BETA_BGK,
    bgk_shift_mag,
    double_barrier_out_price,
    hazard_rebate_pv,
    single_barrier_out_price,
)
from .bjerksund_stensland import american_price_bs93
from .bjerksund_stensland_2002 import american_call_two_step_2002
from .black_scholes import generalized_bs_price
from .double_barrier import double_barrier_ko_price
from .reiner_rubinstein import barrier_price


def _one_side(side, B):
    if side is None:
        return np.full(B, np.nan)
    arr = np.asarray(side)
    if arr.dtype == object or arr.dtype.kind not in "fiu":
        # None-padded python list: replace None lane-wise (slow path)
        arr = np.asarray(
            [np.nan if x is None else x for x in np.atleast_1d(arr)],
            dtype=np.float64,
        )
    return np.atleast_1d(arr.astype(np.float64, copy=False))


def _mask_arrays(lower, upper, B=None):
    """(lower, upper, has_lower, has_upper) from optional/NaN-padded input.

    Numeric arrays (NaN marking absent barriers) take a zero-copy fast
    path; Python lists with ``None`` entries are converted lane-wise."""
    lo = _one_side(lower, B)
    up = _one_side(upper, B)
    has_lo = np.isfinite(lo)
    has_up = np.isfinite(up)
    return np.where(has_lo, lo, 0.0), np.where(has_up, up, 0.0), has_lo, has_up


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _continuous_sweep_kernel(
    s, k, t, r, b, sigma, lower, upper, has_lower, has_upper,
    is_call, is_in, rebate, crossed,
    rebate_timing_in: str, rebate_timing_out: str, double_m: int,
):
    s, k, t, r, b, sigma, lower, upper, rebate = torch.broadcast_tensors(
        s, k, t, r, b, sigma, lower, upper, rebate
    )
    has_lower, has_upper, is_call, is_in, crossed = (
        torch.broadcast_to(v, s.shape) for v in (has_lower, has_upper, is_call, is_in, crossed)
    )
    single = has_lower ^ has_upper
    double = has_lower & has_upper

    # single barrier: sanitize unselected lanes to h=s (finite logs)
    h = torch.where(has_upper, upper, lower)
    h_safe = torch.where(single, h, s)
    p_single = barrier_price(
        s, k, h_safe, t, r, b, sigma, is_call,
        is_up=has_upper, is_in=is_in, rebate=rebate,
        rebate_timing_in=rebate_timing_in,
        rebate_timing_out=rebate_timing_out,
        crossed=crossed,
    )

    lo_safe = torch.where(double, lower, 0.5 * s)
    up_safe = torch.where(double, upper, 2.0 * s)
    ko_double = double_barrier_ko_price(s, k, lo_safe, up_safe, t, r, b, sigma, is_call, m=double_m)
    vanilla = generalized_bs_price(s, k, sigma, t, r, b, is_call)
    p_double = torch.where(is_in, vanilla - ko_double, ko_double)
    # crossed double: IN -> vanilla, OUT -> 0 (+rebate at expiry if timed so)
    p_double = torch.where(crossed, torch.where(is_in, vanilla, 0.0), p_double)

    return torch.where(single, p_single, torch.where(double, p_double, vanilla))


def _continuous_inputs(s, k, t, r, b, sigma, lower, upper, is_call, is_in, rebate, crossed,
                       device):
    """The sweep's tensors on ``device``: the trade columns, then the masks."""
    B = np.shape(np.atleast_1d(_host(s)))[0]
    lo, up, has_lo, has_up = _mask_arrays(lower, upper, B)
    return as_tensors(
        s, k, t, r, b, sigma, lo, up, has_lo, has_up, np.asarray(is_call), np.asarray(is_in),
        np.asarray(rebate, dtype=np.float64), np.asarray(crossed), device=device,
    )


def continuous_barrier_sweep(
    s, k, t, r, b, sigma,
    lower=None, upper=None,
    is_call=True, is_in=False, rebate=0.0, crossed=False,
    rebate_timing_in: str = "expiry", rebate_timing_out: str = "hit",
    double_m: int = 5,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Continuous-barrier prices for a mixed trade table in one pass.

    ``lower``/``upper``: arrays with None/NaN marking absent barriers —
    exactly one set => Reiner-Rubinstein single (up if ``upper``); both =>
    image-series double KO (KI via parity; rebates not supported on
    doubles, matching the reference's DoubleBarrier); neither => vanilla.
    """
    args = _continuous_inputs(s, k, t, r, b, sigma, lower, upper, is_call, is_in, rebate, crossed,
                              device)
    return _continuous_sweep_kernel(*args, rebate_timing_in, rebate_timing_out, double_m)


def continuous_barrier_sweep_greeks(
    s, k, t, r, b, sigma,
    lower=None, upper=None,
    is_call=True, is_in=False, rebate=0.0, crossed=False,
    rebate_timing_in: str = "expiry", rebate_timing_out: str = "hit",
    double_m: int = 5,
    rel_spot_bump: float = 1e-4, abs_vol_bump: float = 1e-4,
    greeks_mode: str = "bump",
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Batched price+delta+gamma+vega for the continuous sweep.

    ``greeks_mode``: 'bump' (default — the reference's central-spot /
    one-sided-vol convention) or 'ad' (exact derivatives of the closed
    forms: delta and vega from one reverse pass, ``torch.func.grad``;
    gamma the Hessian diagonal by forward-over-reverse, ``torch.func.jvp``
    of the gradient with a ones tangent).
    """
    (s, k, t, r, b, sigma, lower, upper, has_lower, has_upper,
     is_call, is_in, rebate, crossed) = _continuous_inputs(
        s, k, t, r, b, sigma, lower, upper, is_call, is_in, rebate, crossed, device)
    px = lambda s_, sig_: _continuous_sweep_kernel(
        s_, k, t, r, b, sig_, lower, upper, has_lower, has_upper,
        is_call, is_in, rebate, crossed,
        rebate_timing_in, rebate_timing_out, double_m,
    )
    if greeks_mode == "ad":
        # the kernel is elementwise over trades, so grad-of-sum is the
        # per-trade derivative
        shape = torch.broadcast_shapes(s.shape, sigma.shape)
        sig = torch.broadcast_to(sigma.to(s.dtype), shape)
        s_b = torch.broadcast_to(s, shape)
        psum = lambda s_, sig_: torch.sum(px(s_, sig_))
        base = px(s_b, sig)
        delta, dvdsig = torch.func.grad(psum, argnums=(0, 1))(s_b, sig)
        delta_fn = torch.func.grad(lambda ss: torch.sum(px(ss, sig)))
        gamma = torch.func.jvp(delta_fn, (s_b,), (torch.ones_like(s_b),))[1]
        return {
            "price": base,
            "delta": delta,
            "gamma": gamma,
            # per vol-POINT, matching the PDE driver's vega scale
            "vega": dvdsig / 100.0,
        }
    if greeks_mode != "bump":
        raise ValueError(f"unknown greeks_mode {greeks_mode!r}")
    ds = torch.clamp(rel_spot_bump * s, min=1e-8)
    base = px(s, sigma)
    up_px = px(s + ds, sigma)
    dn_px = px(s - ds, sigma)
    v_up = px(s, sigma + abs_vol_bump)
    return {
        "price": base,
        "delta": (up_px - dn_px) / (2.0 * ds),
        "gamma": (up_px - 2.0 * base + dn_px) / (ds * ds),
        # one-sided bump per vol-POINT: the PDE batch driver's convention
        # (discrete_barrier_fdm_pricer.py:896)
        "vega": (v_up - base) / (abs_vol_bump * 100.0),
    }


def _bgk_sweep_kernel(
    s_eff, spot, strike, forward, mu, sigma, t, df, m,
    lower, upper, has_lower, has_upper, is_call, is_in,
    already_hit, rebate, rebate_at_hit,
    monitor_cum_t, monitor_dfs,
    series_terms: int,
):
    s_eff, spot, strike, forward, mu, sigma, t, df, m, lower, upper, rebate = torch.broadcast_tensors(
        s_eff, spot, strike, forward, mu, sigma, t, df, m, lower, upper, rebate
    )
    has_lower, has_upper, is_call, is_in, already_hit, rebate_at_hit = (
        torch.broadcast_to(v, s_eff.shape)
        for v in (has_lower, has_upper, is_call, is_in, already_hit, rebate_at_hit)
    )
    single = has_lower ^ has_upper
    double = has_lower & has_upper
    is_up = has_upper & ~double

    shift = bgk_shift_mag(torch.clamp(m, min=1.0))

    h = torch.where(is_up, upper, lower)
    h_safe = torch.where(single, h, torch.where(is_up, 2.0 * s_eff, 0.5 * s_eff))
    out_single = single_barrier_out_price(
        s_eff, strike, h_safe, forward, mu, sigma, t, df, m,
        is_call, is_up, spot=spot, shift_mag=shift,
    )
    lo_safe = torch.where(double, lower, 0.5 * s_eff)
    up_safe = torch.where(double, upper, 2.0 * s_eff)
    out_double = double_barrier_out_price(
        s_eff, strike, lo_safe, up_safe, forward, mu, sigma, t, df, m,
        is_call, series_terms=series_terms, shift_mag=shift,
    )

    vol = torch.clamp(sigma * torch.sqrt(t), min=1e-12)
    d1 = (torch.log(torch.clamp(forward, min=1e-300) / torch.clamp(strike, min=1e-300))
          + 0.5 * vol**2) / vol

    vanilla = df * torch.where(
        is_call,
        forward * N(d1) - strike * N(d1 - vol),
        strike * N(-(d1 - vol)) - forward * N(-d1),
    )

    out_px = torch.where(double, out_double, torch.where(single, out_single, vanilla))
    out_px = torch.where(m <= 0, vanilla, out_px)  # no monitors => vanilla

    # rebate leg, OUT only (discrete_barrier_bgk.py:1107-1130 semantics):
    # at hit -> per-monitor hazard PV sum_k rebate*DF_k*p_k (singles only —
    # the scalar's hit metrics return empty for doubles) on the (B, M)
    # padded monitor grid. Padding rows by repeating the last horizon with
    # df 0 is exact: spurious hazard increments multiply df=0.
    # at expiry -> rebate * df UNCONDITIONALLY (the reference's convention).
    # already_hit -> rebate * df(hit ~ now) = rebate.
    # The scalar pricer's hazard_rebate_pv, broadcast over rows with unit
    # rebate, so the shift/decomposition conventions cannot diverge between
    # the scalar and batched engines.
    pv_hit = hazard_rebate_pv(
        s_eff, h_safe, mu, sigma, monitor_cum_t, monitor_dfs, torch.ones_like(s_eff), is_up
    )[0]
    rebate_leg = torch.where(
        rebate_at_hit,
        rebate * torch.where(single, pv_hit, 0.0),
        rebate * df * (single | double).to(df.dtype),
    )
    rebate_leg = torch.where(rebate > 0.0, rebate_leg, 0.0)

    in_px = vanilla - out_px
    price = torch.where(is_in, in_px, out_px + rebate_leg)
    # already_hit: OUT worth rebate now; IN worth vanilla
    return torch.where(
        already_hit,
        torch.where(is_in, vanilla, torch.where(rebate_at_hit, rebate, rebate * df)),
        price,
    )


def bgk_discrete_sweep(
    s_eff, strike, forward, mu, sigma, t, df, m,
    lower=None, upper=None,
    is_call=True, is_in=False,
    spot=None, already_hit=False,
    rebate=0.0, rebate_at_hit=False,
    monitor_cum_t: Optional[np.ndarray] = None,
    monitor_dfs: Optional[np.ndarray] = None,
    series_terms: int = 50,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """BGK/Hörfelt discretely-monitored barrier sweep (Black-76 layout).

    Inputs follow the scalar pricer's resolved quantities (the JAX
    package's ``bgk_pricer.DiscreteBarrierBGKPricer``): ``s_eff`` escrowed
    spot, ``forward`` = F(T_carry), ``mu`` the theta drift, ``df`` =
    e^{-r T_disc}, ``m`` monitors per trade (array ok). Rebate-at-hit needs
    the monitor grid: ``monitor_cum_t``/``monitor_dfs`` of shape (B, M)
    (pad rows by repeating the last horizon with df 0 — the padded hazard
    increments are then exactly zero).
    """
    def _shape1(v):
        # barrier args may be None or sequences CONTAINING None (mask
        # entries), so length is read without a float conversion
        if v is None:
            return (1,)
        if isinstance(v, (list, tuple)):
            return (len(v),)
        arr = _host(v)
        return arr.shape if arr.ndim else (1,)

    # the batch size comes from every batched argument: only lower/upper or
    # the flag arrays may carry the batch dimension
    B = int(
        np.prod(
            np.broadcast_shapes(
                *(
                    _shape1(v)
                    for v in (
                        s_eff, strike, forward, mu, sigma, t, df, m,
                        lower, upper, is_call, is_in, spot, already_hit,
                        rebate, rebate_at_hit,
                    )
                )
            )
        )
    )
    lo, up, has_lo, has_up = _mask_arrays(lower, upper, B)
    if monitor_cum_t is None:
        # rebate-at-hit PV needs the real monitor grid; this placeholder
        # (single horizon T, df 0) makes the at-hit leg evaluate to 0
        t_host = _host(t)
        monitor_cum_t = np.broadcast_to(
            np.asarray(t_host, dtype=np.float64).reshape(-1, 1)
            if np.ndim(t_host)
            else np.full((B, 1), float(t_host)),
            (B, 1),
        )
        monitor_dfs = np.zeros((B, 1))
    args = as_tensors(
        s_eff, s_eff if spot is None else spot, strike, forward, mu, sigma, t, df,
        np.asarray(_host(m), dtype=np.float64), lo, up, has_lo, has_up,
        np.asarray(is_call), np.asarray(is_in), np.asarray(already_hit),
        np.asarray(rebate, dtype=np.float64), np.asarray(rebate_at_hit),
        np.asarray(_host(monitor_cum_t), dtype=np.float64),
        np.asarray(_host(monitor_dfs), dtype=np.float64),
        device=device,
    )
    return _bgk_sweep_kernel(*args, series_terms=series_terms)


def bs93_sweep(s, f, k, t, r, sigma, is_call, device=DEFAULT_DEVICE) -> torch.Tensor:
    """BS93 American prices over a trade table (calls and puts)."""
    return american_price_bs93(*as_tensors(s, f, k, t, r, sigma, is_call, device=device))


def bs93_sweep_greeks(s, f, k, t, r, sigma, is_call, rel_bump=1e-4,
                      device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Batched bump greeks, forward held fixed (bjerksund_stensland.py:47-91)."""
    s, f, k, t, r, sigma, is_call = as_tensors(s, f, k, t, r, sigma, is_call, device=device)
    ds = s * rel_bump
    base = american_price_bs93(s, f, k, t, r, sigma, is_call)
    up = american_price_bs93(s + ds, f, k, t, r, sigma, is_call)
    dn = american_price_bs93(s - ds, f, k, t, r, sigma, is_call)
    dv = sigma * rel_bump
    vu = american_price_bs93(s, f, k, t, r, sigma + dv, is_call)
    vd = american_price_bs93(s, f, k, t, r, sigma - dv, is_call)
    return {
        "price": base,
        "delta": (up - dn) / (2.0 * ds),
        "gamma": (up - 2.0 * base + dn) / (ds * ds),
        "vega": (vu - vd) / (2.0 * dv),
    }


def bs2002_sweep(s, k, r, b, sigma, t, variant: str = "riskflow_1993",
                 device=DEFAULT_DEVICE) -> torch.Tensor:
    """BS2002 two-step American call sweep; puts via the standard transform
    C(K, S, T, r-b, -b, sigma) applied by the caller (bjerk_stens_new.py).

    Broadcast over trades: the Gauss-Legendre bivariate normal CDF
    contracts its fixed quadrature nodes along a trailing axis."""
    arrs = torch.broadcast_tensors(*as_tensors(s, k, r, b, sigma, t, device=device))
    return american_call_two_step_2002(*arrs, variant)[0]


def monitoring_decision(
    t_expiry: np.ndarray,
    monitor_times,
    sigma: np.ndarray,
    n_desired: int = 400,
    n_min_per_interval: int = 1,
    n_lim_multiplier: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised FIS n_lim rule (discrete_barrier_analytic_pricer.py:278-342).

    ``monitor_times``: per-trade list of monitor year-fractions (host).
    Returns (use_continuous (B,), bgk_adj (B,)) where ``bgk_adj`` is the
    barrier shift factor exp(beta * sigma * sqrt(dt_avg)) — shifted barriers
    are lower/adj and upper*adj.
    """
    t_expiry = np.atleast_1d(np.asarray(t_expiry, dtype=np.float64))
    sigma = np.broadcast_to(np.asarray(sigma, dtype=np.float64), t_expiry.shape)
    B = t_expiry.shape[0]
    use_cont = np.zeros(B, dtype=bool)
    adj = np.ones(B, dtype=np.float64)
    for i in range(B):
        mts = sorted(x for x in monitor_times[i] if 0.0 < x <= t_expiry[i])
        if not mts:
            continue
        dt_eq = t_expiry[i] / max(1, n_desired)
        # intervals between CONSECUTIVE monitors only — deliberately
        # excluding valuation->first-monitor, exactly like the reference
        # decision (discrete_barrier_analytic_pricer.py:301-311). The
        # standalone BGK pricer's _compute_dt_years includes that first
        # interval for ITS shift — a different engine's convention, not
        # this router's.
        intervals = np.diff(mts).tolist() or [t_expiry[i] / len(mts)]
        steps = [
            max(n_min_per_interval, int(round(ti / max(1e-12, dt_eq))))
            for ti in intervals
        ]
        use_cont[i] = sum(steps) > n_lim_multiplier * n_desired
        avg_dt = sum(intervals) / len(intervals)
        adj[i] = np.exp(BETA_BGK * sigma[i] * np.sqrt(max(1e-12, avg_dt)))
    return use_cont, adj
