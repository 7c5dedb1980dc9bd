"""Spectral (sine-basis) propagator for the discretely monitored CN solve.

Counterpart of ``finite_difference_tpu.models.pde.spectral``. Between two
monitor dates the barrier CN operator (uniform log grid, constant
coefficients, knock-out projection at monitor steps only, no dividend
jumps) is linear with constant coefficients, so the whole march collapses
to a closed form per sine mode:

* ``L = tri(a, b, c)`` is similar to a symmetric Toeplitz tridiagonal via
  ``D = diag(g^i)``, ``g = sqrt(a/c)``; its eigenvectors are the discrete
  sine modes and one theta-step is, per mode, ``w' = rho_k w`` once the
  Dirichlet boundary forcing is subtracted as two exponential channels
  (``e^{-r tau}`` and ``e^{(b-q-r) tau}``) pinned to discrete
  eigen-profiles.
* A projection overwrites grid values in real space; the step after it
  sees actual edge values that differ from the asymptotics, which enters
  the closed form as one rank-2 term, kept exactly.

Per monitor interval the work is an elementwise update of the (B, M) mode
state, one inverse DST (a (B, M) x (M, M) matmul), the masked projection
and one forward DST. Where the JAX package vmaps a per-trade solve, here
the state carries the batch: per-trade scalars are (B,) tensors that
broadcast as (B, 1), and the interval loop runs over the batch's padded
interval count (padded intervals are zero-length no-ops).

The float32 DSTs must run at full float32: TF32's 10-bit mantissa destroys
the sine reconstruction (the JAX package pins ``Precision.HIGHEST`` for
the same reason). A float32 DST on a card where the caller has enabled
TF32 for matmuls raises instead of running (:func:`dst_product`).

Every ``log1p``/``expm1`` residual form of the JAX module is kept: alpha ~
sigma^2/dx^2 reaches 1e5 while the eigenvalues are O(1), and the float32
accuracy rests on those forms.
"""
from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .stepper import BarrierSpec, CNDynamics, CNGrid, _boundary_values, _payoff


# --------------------------------------------------------------------------- #
# Host side: interval structure and the layout's guards (numpy)               #
# --------------------------------------------------------------------------- #
def spectral_intervals(monitor: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(k_end, apply_proj) arrays, shape (B, M_iv), from (B, n_steps) flags.

    ``monitor[b, k-1]`` means the KO projection fires after tau index k.
    Intervals end at each monitor index and at n_steps; padding repeats
    k_end = n_steps with apply_proj = False (a zero-length no-op interval).
    """
    monitor = np.asarray(monitor, dtype=bool)
    if monitor.ndim == 1:
        monitor = monitor[None, :]
    B, n = monitor.shape
    ends = [np.flatnonzero(m) + 1 for m in monitor]
    n_iv = max((len(e) + (0 if len(e) and e[-1] == n else 1)) for e in ends)
    k_end = np.full((B, n_iv), n, dtype=np.int32)
    apply_proj = np.zeros((B, n_iv), dtype=bool)
    for b, e in enumerate(ends):
        k_end[b, : len(e)] = e
        apply_proj[b, : len(e)] = True
    return k_end, apply_proj


def symmetrizer_exponent(
    sigma: np.ndarray, b: np.ndarray, q: np.ndarray, dx: np.ndarray, n_nodes: int
) -> np.ndarray:
    """max_i |i ln g| per trade: the overflow guard for D = g^i."""
    sig2 = np.asarray(sigma, dtype=float) ** 2
    mu_x = (np.asarray(b, float) - np.asarray(q, float)) - 0.5 * sig2
    # ln g = 0.5 ln(a/c), a = alpha - beta, c = alpha + beta,
    # alpha = sig2/(2 dx^2), beta = mu_x/(2 dx)
    ratio = np.asarray(dx, float) * mu_x / sig2  # = beta/alpha
    ratio = np.clip(ratio, -0.999999, 0.999999)
    ln_g = 0.5 * (np.log1p(-ratio) - np.log1p(ratio))
    return np.abs(ln_g) * (n_nodes - 2)


def channel_conditioning(sigma, b, q, r, dx, dt, n_nodes: int) -> np.ndarray:
    """min |det| of the boundary-channel 2x2 edge solves per trade.

    Each boundary exponential is pinned to a discrete eigen-profile
    u_i = kp zeta_+^{i-(n-1)} + km zeta_-^i; when the two roots (nearly)
    coincide the edge solve degenerates (det -> 0). 0 where the root
    discriminant is non-positive (complex roots)."""
    sigma = np.asarray(sigma, float)
    bb = np.asarray(b, float)
    qq = np.asarray(q, float)
    rr = np.asarray(r, float)
    dx = np.asarray(dx, float)
    dt = np.asarray(dt, float)
    sig2 = sigma**2
    mu_x = bb - qq - 0.5 * sig2
    alpha = 0.5 * sig2 / (dx * dx)
    beta = mu_x / (2.0 * dx)
    a_c, c_c = alpha - beta, alpha + beta
    b_c = -2.0 * alpha - rr
    gam = bb - qq - rr
    out = np.full(sigma.shape, np.inf)
    for a_rate in (-rr, gam):
        for th in (1.0, 0.5):
            q1 = np.expm1(a_rate * dt)
            omega = q1 / (dt * (th * np.exp(a_rate * dt) + 1.0 - th))
            bw = b_c - omega
            disc = bw * bw - 4.0 * a_c * c_c
            bad = disc <= 0.0
            sq = np.sqrt(np.maximum(disc, 0.0))
            zp = (-bw + sq) / (2.0 * c_c)
            zm = a_c / (c_c * zp)
            nn = n_nodes - 1
            with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
                det = np.abs(np.exp(-nn * np.log(zp) + nn * np.log(zm)) - 1.0)
            det = np.where(bad | ~np.isfinite(det), 0.0, det)
            out = np.minimum(out, det)
    return out


@functools.lru_cache(maxsize=16)
def dst_matrix(n_nodes: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Orthonormal DST-I matrix over the M = n_nodes-2 interior nodes, built
    at float64 and cast once; cached per (N, dtype, device). Symmetric, so
    a row vector's transform is ``x @ S``. Callers only read it."""
    M = n_nodes - 2
    idx = np.arange(1, M + 1, dtype=np.float64)
    S = np.sqrt(2.0 / (M + 1)) * np.sin(np.pi * np.outer(idx, idx) / (M + 1))
    return torch.as_tensor(S).to(device=device, dtype=dtype)


def tf32_enabled() -> bool:
    """True when float32 matmuls on CUDA may run as TF32 (the caller's
    ``torch.backends.cuda.matmul`` setting, through either of torch's
    interfaces to it). Reads only; the flags are never changed here."""
    mm = torch.backends.cuda.matmul
    prec = getattr(mm, "fp32_precision", None)
    if prec is None:  # torch before the fp32_precision interface
        return bool(mm.allow_tf32)
    if prec == "none":
        return getattr(torch.backends, "fp32_precision", "none") == "tf32"
    return prec == "tf32"


def require_full_float32(dtype: torch.dtype, device: torch.device) -> None:
    """Raise ValueError where DSTs of ``dtype`` on ``device`` would run as
    TF32 (float32 on a card with TF32 enabled for matmuls): its 10-bit
    mantissa destroys the sine reconstruction. Checked on every call, also
    where a CUDA graph replays the solve (whose kernels were captured at
    full float32)."""
    if dtype == torch.float32 and device.type == "cuda" and tf32_enabled():
        raise ValueError(
            "the spectral propagator's float32 DSTs need full float32 matmuls, "
            "but TF32 is enabled (torch.backends.cuda.matmul); disable it, or "
            "use solver='spectral_x64dst' (float64 DSTs) or another solver"
        )


def dst_product(x: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``x @ dst`` at the operands' full precision (see
    :func:`require_full_float32`)."""
    require_full_float32(dst.dtype, dst.device)
    return torch.matmul(x, dst)


# --------------------------------------------------------------------------- #
# Device side: closed-form pieces                                             #
# --------------------------------------------------------------------------- #
# rho = (1 + (1-th) z)/(1 - th z), z = dt*lambda, sits within one ulp of 1
# for the low modes: every power is formed from the cancellation-free
# residual rho - 1 = z/denom via log1p, falling back to direct logs only
# where rho <= 0.5 (where nothing cancels).
def _log_rho(z, theta):
    """(log|rho|, rho_negative) for rho = (1 + (1-theta) z)/(1 - theta z)."""
    denom = 1.0 - theta * z
    ratio = z / denom  # rho - 1, exact form
    rho = 1.0 + ratio
    near = rho > 0.5
    log_mag = torch.where(
        near,
        torch.log1p(torch.where(near, ratio, torch.zeros_like(ratio))),
        torch.log(torch.clamp(torch.abs(torch.where(near, -torch.ones_like(rho), rho)), min=1e-300)),
    )
    return log_mag, (~near) & (rho < 0.0)


def _pow_from_log(log_mag, negative, m):
    """rho^m from the (log|rho|, sign) pair; ``m`` (B,) integers >= 0."""
    mf = m.to(log_mag.dtype)[:, None]
    mag = torch.exp(mf * log_mag)
    odd = torch.remainder(mf, 2.0) > 0.5
    out = torch.where(negative & odd, -mag, mag)
    return torch.where(mf > 0.5, out, torch.ones_like(out))


def _stage_switch_fns(rho_cache, P, Q, ud_bar):
    """(stage, switch) shared by the uniform-dt and per-interval-dt branches.

    ``stage(w, m, theta, d_lo, d_hi)``: m homogeneous theta-steps on a
    channel-residual state; (d_lo, d_hi) are the j=0 deviations of the
    actual previous edge values from the asymptotics (nonzero right after
    a projection). ``m`` is an int where every trade takes the same count
    (the powers rho^m and the deviation term's (B, M) factors are then
    made once per count and reused across intervals), else (B,) integers
    (the JAX package's per-trade form).
    ``switch(w, coefs, sign)``: re-base the residual between the CN and
    implicit channel profiles (+1 = CN -> implicit); ``coefs`` are the
    channels' exponentials e^{alpha tau} at the switch's tau, (B,) each.
    """
    powers, corr_terms = {}, {}

    def power(theta, m: int):
        if (theta, m) not in powers:
            log_mag, neg, _ = rho_cache[theta]
            mag = torch.exp(m * log_mag)
            powers[(theta, m)] = torch.where(neg, -mag, mag) if m % 2 else mag
        return powers[(theta, m)]

    def stage(w, m, theta, d_lo, d_hi):
        if isinstance(m, int):
            if m == 0:
                return w
            w_new = power(theta, m) * w
            if theta == 1.0:  # the deviation term carries a factor 1 - theta
                return w_new
            if (theta, m) not in corr_terms:
                denom = rho_cache[theta][2]
                a_lo, a_hi = (1.0 - theta) * P / denom, (1.0 - theta) * Q / denom
                if m > 1:
                    a_lo, a_hi = power(theta, m - 1) * a_lo, power(theta, m - 1) * a_hi
                corr_terms[(theta, m)] = (a_lo, a_hi)
            a_lo, a_hi = corr_terms[(theta, m)]
            return torch.addcmul(torch.addcmul(w_new, a_lo, d_lo[:, None]), a_hi, d_hi[:, None])
        log_mag, neg, denom = rho_cache[theta]
        w_new = _pow_from_log(log_mag, neg, m) * w
        if theta == 1.0:
            return w_new
        corr = (1.0 - theta) * (P * d_lo[:, None] + Q * d_hi[:, None]) / denom
        return w_new + _pow_from_log(log_mag, neg, torch.clamp(m - 1, min=0)) * torch.where(
            (m > 0)[:, None], corr, torch.zeros_like(corr)
        )

    def switch(w, coefs, sign):
        for c, ud in zip(coefs, ud_bar):
            w = torch.addcmul(w, c[:, None], ud, value=sign)
        return w

    return stage, switch


def _two_stages(w, stage, switch, n_imp, n_cn, e_s, e_mid, d_lo, d_hi):
    """One interval's theta=1 stage of ``n_imp`` steps (between its two
    channel switches, at the interval's start and at the stage's end:
    exponentials ``e_s``, ``e_mid``) and its CN stage of ``n_cn``. The j=0
    deviation term belongs to the stage that runs step j=0. An int
    ``n_imp`` of 0 (every trade past its Rannacher prefix) skips the
    theta=1 stage and its switches, which cancel."""
    if isinstance(n_imp, int) and n_imp == 0:
        return stage(w, n_cn, 0.5, d_lo, d_hi)
    w1 = stage(switch(w, e_s, +1.0), n_imp, 1.0, d_lo, d_hi)
    if isinstance(n_imp, int):
        d_lo2 = d_hi2 = torch.zeros_like(d_lo)
    else:
        d_lo2 = torch.where(n_imp > 0, torch.zeros_like(d_lo), d_lo)
        d_hi2 = torch.where(n_imp > 0, torch.zeros_like(d_hi), d_hi)
    return stage(switch(w1, e_mid, -1.0), n_cn, 0.5, d_lo2, d_hi2)


def _coefficients(grid: CNGrid, dyn: CNDynamics):
    """(alpha, beta, a, c) of the interior operator, (B,) each."""
    sig2 = dyn.sigma * dyn.sigma
    mu_x = (dyn.b - dyn.q) - 0.5 * sig2
    alpha = 0.5 * sig2 / (grid.dx * grid.dx)
    beta_adv = mu_x / (2.0 * grid.dx)
    return alpha, beta_adv, alpha - beta_adv, alpha + beta_adv


def _channel_profile(alpha, beta_adv, c_coef, ln_g, r, ii, n_nodes, alpha_rate, lo_amp, hi_amp,
                     theta, dt):
    """Interior eigen-profile (B, M) of one boundary exponential e^{alpha_rate tau}
    under a theta-step of ``dt``, pinned to its edge amplitudes.

    Root pair of c z^2 + (b - omega) z + a = 0 in stable residual form:
    with s = r + omega, disc = 4 alpha s + s^2 + 4 beta^2 (not bw^2 - 4ac,
    which cancels at the 1e5^2 scale in f32), and zp - 1 = (s + (sqrt(disc)
    - 2 beta))/(2c), the sqrt difference rationalized when beta > 0."""
    q1 = torch.expm1(alpha_rate * dt)
    omega = q1 / (dt * (theta * torch.exp(alpha_rate * dt) + 1.0 - theta))
    s_ch = r + omega
    disc = 4.0 * alpha * s_ch + s_ch * s_ch + 4.0 * beta_adv * beta_adv
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sq_m2b = torch.where(
        beta_adv > 0.0,
        (4.0 * alpha * s_ch + s_ch * s_ch) / torch.clamp(sq + 2.0 * beta_adv, min=1e-300),
        sq - 2.0 * beta_adv,
    )
    zp_m1 = (s_ch + sq_m2b) / (2.0 * c_coef)  # zeta_+ - 1
    ln_p = torch.log1p(zp_m1)
    ln_m = 2.0 * ln_g - ln_p  # zeta_- = (a/c)/zeta_+
    nn = float(n_nodes - 1)
    ep = torch.exp(-nn * ln_p)  # phi_+(0)
    em = torch.exp(nn * ln_m)  # phi_-(n-1)
    det = ep * em - 1.0
    kp = (lo_amp * em - hi_amp) / det
    km = (hi_amp * ep - lo_amp) / det
    return kp[:, None] * torch.exp((ii - nn)[None, :] * ln_p[:, None]) + km[:, None] * torch.exp(
        ii[None, :] * ln_m[:, None]
    )


class _Interval(NamedTuple):
    """What the host knows of one interval column of the layout."""

    live: bool  # some trade advances or projects (else a padded no-op for all)
    projects: bool  # some trade projects after it
    all_project: bool  # every trade projects after it
    m: Optional[int]  # the step count, where every trade shares it
    n_imp: Optional[int]  # its theta=1 steps, where every trade shares them


def interval_plan(k_end: torch.Tensor, apply_proj: torch.Tensor, R) -> List[_Interval]:
    """Per interval column of a layout, the host's view (:class:`_Interval`),
    from one small pull of per-column reductions (``tolist``, not numpy: this runs
    inside ``torch.func.jvp`` too)."""
    k_prev = torch.cat([torch.zeros_like(k_end[:, :1]), k_end[:, :-1]], dim=1)
    R = R if torch.is_tensor(R) else torch.full_like(k_end[:, 0], int(R))
    cols = torch.stack([
        k_end.min(dim=0).values, k_end.max(dim=0).values,
        k_prev.min(dim=0).values, k_prev.max(dim=0).values,
        (k_end > k_prev).any(dim=0).long(), apply_proj.any(dim=0).long(),
        apply_proj.all(dim=0).long(),
    ]).long()
    r_lo, r_hi = torch.stack([R.min(), R.max()]).long().tolist()
    plan = []
    for ke_lo, ke_hi, ks_lo, ks_hi, advances, projects, every in zip(*cols.tolist()):
        m = ke_lo - ks_lo if (ke_lo == ke_hi and ks_lo == ks_hi) else None
        n_imp = None
        if m is not None and r_lo == r_hi:
            n_imp = min(max(r_lo - ks_lo, 0), m)
        plan.append(_Interval(bool(advances or projects), bool(projects), bool(every), m, n_imp))
    return plan


def spectral_solve(
    grid: CNGrid,
    dyn: CNDynamics,
    dt: torch.Tensor,
    k_end: torch.Tensor,
    apply_proj: torch.Tensor,
    n_nodes: int,
    rannacher_steps,
    barrier: Optional[BarrierSpec] = None,
    euro_put_lower_boundary: bool = True,
    mm_dtype: Optional[torch.dtype] = None,
    plan: Optional[List["_Interval"]] = None,
):
    """March a batch via the sine-basis propagator; mirrors ``stepper.cn_solve``.

    ``dt``: (B,) for a uniform schedule (the hoisted branch) or (B, n_iv),
    aligned with ``k_end``/``apply_proj`` (B, n_iv) from
    :func:`spectral_intervals`, for per-interval dt. ``rannacher_steps``:
    (B,) integers or an int (the theta=1 prefix of each trade).
    ``mm_dtype``: run the DSTs at this dtype (the state stays in the
    working dtype). ``plan``: :func:`interval_plan` of the layout, made
    here where not given (it reads the layout on the host, so a caller
    that captures the solve in a CUDA graph makes it first). Returns
    ``(V, s_nodes)``, (B, n_nodes) each.

    The arithmetic is the JAX package's, batched. Where every trade of an
    interval column takes the same step counts (a shared monitor layout)
    the powers rho^m are made once per count, and a theta=1 stage of no
    step (past the Rannacher prefix) is skipped with its two channel
    switches, which cancel; these change roundings only.
    """
    dtype, device = grid.x_min.dtype, grid.x_min.device
    M = n_nodes - 2
    i = torch.arange(n_nodes, dtype=dtype, device=device)
    s = torch.exp(grid.x_min[:, None] + i[None, :] * grid.dx[:, None])
    s_min, s_max = s[:, 0], s[:, -1]

    dst = dst_matrix(n_nodes, mm_dtype or dtype, device)
    if mm_dtype is not None:
        mm = lambda a: dst_product(a.to(mm_dtype), dst).to(dtype)
    else:
        mm = lambda a: dst_product(a, dst)

    payoff = _payoff(s, dyn.strike, dyn.is_call)
    alpha, beta_adv, a_coef, c_coef = _coefficients(grid, dyn)

    # ln g and the eigenvalues in cancellation-free forms:
    #   lam_k = -(r + 2 beta^2/(alpha + sqrt(ac)) + 4 sqrt(ac) sin^2(t/2))
    # (all-positive terms) and ln g = 0.5 log1p(-2 beta / c)
    ln_g = 0.5 * torch.log1p(-2.0 * beta_adv / c_coef)
    ii = torch.arange(M, dtype=dtype, device=device) + 1.0  # interior index 1..M
    d_vec = torch.exp(ii[None, :] * ln_g[:, None])  # D = diag(g^i), (B, M)
    off = torch.sqrt(a_coef * c_coef)
    half_t = 0.5 * math.pi * ii / (M + 1.0)
    lam = -(
        (dyn.r + 2.0 * beta_adv * beta_adv / (alpha + off))[:, None]
        + 4.0 * off[:, None] * (torch.sin(half_t) ** 2)[None, :]
    )

    # forcing projections: S row values at interior positions 1 and M
    s_k1 = dst[:, 0].to(dtype)
    s_kM = dst[:, M - 1].to(dtype)

    # boundary asymptotics as A e^{-r tau} + B e^{gamma tau} per edge
    gam = dyn.b - dyn.q - dyn.r
    zero = torch.zeros_like(dyn.strike)
    A_lo = torch.where(dyn.is_call, zero, dyn.strike)
    B_lo = torch.where(dyn.is_call, zero, -s_min if euro_put_lower_boundary else zero)
    A_hi = torch.where(dyn.is_call, -dyn.strike, zero)
    B_hi = torch.where(dyn.is_call, s_max, zero)

    if barrier is not None:
        out_mask = (barrier.has_lower[:, None] & (s <= barrier.lower[:, None])) | (
            barrier.has_upper[:, None] & (s >= barrier.upper[:, None])
        )
        out_int = out_mask[:, 1:-1]

    def project(v_int, v_lo, v_hi, do_proj, every, tau_e):
        """The knock-out projection after an interval: interior and edges."""
        if barrier is None:
            return v_int, v_lo, v_hi
        rebate_pv = torch.where(
            barrier.rebate_at_hit, barrier.rebate,
            barrier.rebate * torch.exp(-barrier.rebate_rate * tau_e),
        )
        mask = out_int if every else do_proj[:, None] & out_int
        return (
            torch.where(mask, rebate_pv[:, None], v_int),
            torch.where(do_proj & out_mask[:, 0], rebate_pv, v_lo),
            torch.where(do_proj & out_mask[:, -1], rebate_pv, v_hi),
        )

    channels = ((-dyn.r, A_lo, A_hi), (gam, B_lo, B_hi))
    alphas = tuple(a for a, _, _ in channels)

    def profile(alpha_rate, lo, hi, theta, dt_):
        return _channel_profile(alpha, beta_adv, c_coef, ln_g, dyn.r, ii, n_nodes,
                                alpha_rate, lo, hi, theta, dt_)

    def E_channels(profiles, tau):
        """Real-space interior channel sum at time-to-maturity tau (B,)."""
        (a0, a1), (u0, u1) = alphas, profiles
        return torch.addcmul(torch.exp(a0 * tau)[:, None] * u0, torch.exp(a1 * tau)[:, None], u1)

    plan = plan if plan is not None else interval_plan(k_end, apply_proj, rannacher_steps)
    R = rannacher_steps
    k_end = k_end.long()
    exps = lambda tau: [torch.exp(a * tau) for a in alphas]

    if dt.ndim > 1:
        # ---- per-interval dt (monitor-aligned layouts) --------------------
        # The residual basis (channel profiles) changes with dt at every
        # interval boundary, so this branch carries the real-space interior
        # vector and re-projects per interval: two DSTs per interval, and
        # the rho/channel transcendentals lose the interval-invariant hoist.
        v_int_c = payoff[:, 1:-1]
        k_start = torch.zeros_like(k_end[:, 0])
        tau_s = torch.zeros_like(dyn.strike)
        v_lo_act, v_hi_act = payoff[:, 0], payoff[:, -1]
        for j, iv in enumerate(plan):
            if not iv.live:
                continue
            ke, do_proj, dt_iv = k_end[:, j], apply_proj[:, j], dt[:, j]
            if iv.n_imp is not None:
                m, n_imp = iv.m, iv.n_imp
            else:
                m = ke - k_start
                n_imp = torch.minimum(torch.clamp(R - k_start, min=0), m)
            u_cn = [profile(a, lo, hi, 0.5, dt_iv) for a, lo, hi in channels]
            u_imp = [profile(a, lo, hi, 1.0, dt_iv) for a, lo, hi in channels]
            ud_bar = [mm((uc - ui) / d_vec) for uc, ui in zip(u_cn, u_imp)]
            P_iv = (dt_iv * a_coef * torch.exp(-ln_g))[:, None] * s_k1
            Q_iv = (dt_iv * c_coef * torch.exp(-M * ln_g))[:, None] * s_kM
            z = dt_iv[:, None] * lam
            rho_c = {th: (*_log_rho(z, th), 1.0 - th * z) for th in (1.0, 0.5)}
            stage, switch = _stage_switch_fns(rho_c, P_iv, Q_iv, ud_bar)

            v_lo_asym, v_hi_asym = _boundary_values(tau_s, s_min, s_max, dyn, euro_put_lower_boundary)
            w = mm((v_int_c - E_channels(u_cn, tau_s)) / d_vec)
            tau_mid = tau_s + _as_float(n_imp, dtype) * dt_iv
            w2 = _two_stages(w, stage, switch, n_imp, m - n_imp, exps(tau_s), exps(tau_mid),
                             v_lo_act - v_lo_asym, v_hi_act - v_hi_asym)
            tau_e = tau_s + _as_float(m, dtype) * dt_iv
            v_lo_e, v_hi_e = _boundary_values(tau_e, s_min, s_max, dyn, euro_put_lower_boundary)
            v_int = torch.addcmul(E_channels(u_cn, tau_e), mm(w2), d_vec)
            v_int_c, v_lo_act, v_hi_act = project(v_int, v_lo_e, v_hi_e, do_proj, iv.all_project, tau_e)
            k_start, tau_s = ke, tau_e
        return torch.cat([v_lo_act[:, None], v_int_c, v_hi_act[:, None]], dim=1), s

    # ---- uniform dt: interval-invariant quantities hoisted -----------------
    P = (dt * a_coef * torch.exp(-ln_g))[:, None] * s_k1  # lower-edge channel
    Q = (dt * c_coef * torch.exp(-M * ln_g))[:, None] * s_kM  # upper-edge channel
    u_cn = [profile(a, lo, hi, 0.5, dt) for a, lo, hi in channels]
    ud_bar = [mm((uc - profile(a, lo, hi, 1.0, dt)) / d_vec) for uc, (a, lo, hi) in zip(u_cn, channels)]

    # The carried state is the sine transform of the residual v - E (E the
    # CN-profile channel sum): the matmul operands stay at the residual
    # scale, which bounds the f32 absolute noise. The actual edge values at
    # tau=0 are the payoff's (the j=0 deviation term absorbs the
    # American-convention put lower edge exactly).
    w = mm((payoff[:, 1:-1] - E_channels(u_cn, torch.zeros_like(dt))) / d_vec)

    z_modes = dt[:, None] * lam
    rho_cache = {th: (*_log_rho(z_modes, th), 1.0 - th * z_modes) for th in (1.0, 0.5)}
    stage, switch = _stage_switch_fns(rho_cache, P, Q, ud_bar)

    # Every (B,) quantity of every interval at once, (B, n_iv): the
    # interval's ends in tau, the edge asymptotics there, the channel
    # exponentials at its start, after its theta=1 stage and at its end,
    # the rebate PV, and the actual edge values after it (a projection
    # sets a knocked-out edge to the rebate). The loop then launches only
    # the (B, M) work.
    k_prev = torch.cat([torch.zeros_like(k_end[:, :1]), k_end[:, :-1]], dim=1)
    m_all = k_end - k_prev
    R_col = R[:, None] if torch.is_tensor(R) else R
    n_imp_all = torch.minimum(torch.clamp(R_col - k_prev, min=0), m_all)
    tau_s = k_prev.to(dtype) * dt[:, None]
    tau_e = k_end.to(dtype) * dt[:, None]
    e_s = _exps_cols(alphas, tau_s)
    e_mid = _exps_cols(alphas, (k_prev + n_imp_all).to(dtype) * dt[:, None])
    e_e = _exps_cols(alphas, tau_e)
    dyn_cols = CNDynamics(*(f[:, None] for f in dyn))
    lo_s, hi_s = _boundary_values(tau_s, s_min[:, None], s_max[:, None], dyn_cols, euro_put_lower_boundary)
    lo_e, hi_e = _boundary_values(tau_e, s_min[:, None], s_max[:, None], dyn_cols, euro_put_lower_boundary)
    if barrier is not None:
        rebate_pv = torch.where(
            barrier.rebate_at_hit[:, None], barrier.rebate[:, None],
            barrier.rebate[:, None] * torch.exp(-barrier.rebate_rate[:, None] * tau_e),
        )
        lo_e = torch.where(apply_proj & out_mask[:, :1], rebate_pv, lo_e)
        hi_e = torch.where(apply_proj & out_mask[:, -1:], rebate_pv, hi_e)
        d_inv = 1.0 / d_vec
        u_over_d = [u / d_vec for u in u_cn]
    d_lo_all = torch.cat([payoff[:, :1], lo_e[:, :-1]], dim=1) - lo_s
    d_hi_all = torch.cat([payoff[:, -1:], hi_e[:, :-1]], dim=1) - hi_s

    last = 0
    for j, iv in enumerate(plan):
        if not iv.live:
            continue
        last = j
        if iv.n_imp is not None:
            n_imp, n_cn = iv.n_imp, iv.m - iv.n_imp
        else:
            n_imp, n_cn = n_imp_all[:, j], m_all[:, j] - n_imp_all[:, j]
        col = lambda cs: [c[:, j] for c in cs]
        w2 = _two_stages(w, stage, switch, n_imp, n_cn, col(e_s), col(e_mid),
                         d_lo_all[:, j], d_hi_all[:, j])
        if iv.projects and barrier is not None:
            # The projected state's residual, per node: the rebate's
            # (rebate - E)/D where a trade knocks out, else the state's own
            # reconstruction DST(w2) (the JAX package's (v - E)/D of
            # v = DST(w2) D + E, without the round trip through E)
            resid = d_inv * rebate_pv[:, j, None]
            for c, u in zip(col(e_e), u_over_d):
                resid = torch.addcmul(resid, c[:, None], u, value=-1.0)
            do_proj = apply_proj[:, j, None]
            mask = out_int if iv.all_project else do_proj & out_int
            w_proj = mm(torch.where(mask, resid, mm(w2)))
            w = w_proj if iv.all_project else torch.where(do_proj, w_proj, w2)
        else:  # a projection without a barrier is the identity
            w = w2
    v_int = torch.addcmul(E_channels(u_cn, tau_e[:, last]), mm(w), d_vec)
    return torch.cat([lo_e[:, last, None], v_int, hi_e[:, last, None]], dim=1), s


def _exps_cols(alphas, tau):
    """The channels' exponentials e^{alpha tau} at (B, n_iv) taus."""
    return [torch.exp(a[:, None] * tau) for a in alphas]


def _as_float(n, dtype):
    """A step count, an int or (B,) integers, as a multiplier of dt."""
    return n.to(dtype) if torch.is_tensor(n) else float(n)


def spectral_solve_mixed(
    grid: CNGrid,
    dyn: CNDynamics,
    dt: torch.Tensor,
    k_end: torch.Tensor,
    apply_proj: torch.Tensor,
    n_nodes: int,
    rannacher_steps,
    barrier: Optional[BarrierSpec] = None,
    euro_put_lower_boundary: bool = True,
    plan: Optional[List["_Interval"]] = None,
):
    """Mixed-precision spectral march: f64 transcendentals and DSTs, f32 state.

    Every exp/log/expm1-family evaluation (the coefficient chain, the mode
    powers, the channel and boundary exponentials) runs at float64 with
    results cast to float32; the carried state, the elementwise stage
    arithmetic and the projection stay float32, and the DST matmuls run at
    float64. Uniform dt only (``dt`` (B,)); mirrors :func:`spectral_solve`'s
    hoisted branch (``plan`` as there). Returns float32 ``(V, s_nodes)``.
    """
    f32, f64 = torch.float32, torch.float64
    hx = lambda v: v.to(f64)
    sc = lambda v: v.to(f32)
    device = grid.x_min.device

    M = n_nodes - 2
    i64 = torch.arange(n_nodes, dtype=f64, device=device)
    s64 = torch.exp(hx(grid.x_min)[:, None] + i64[None, :] * hx(grid.dx)[:, None])
    s = sc(s64)
    s_min, s_max = s64[:, 0], s64[:, -1]

    dst = dst_matrix(n_nodes, f64, device)
    mm64 = lambda a: dst_product(a.to(f64), dst)

    payoff = sc(_payoff(s64, hx(dyn.strike), dyn.is_call))

    # the whole coefficient chain at f64
    dt64 = hx(dt)
    sig = hx(dyn.sigma)
    sig2 = sig * sig
    r64, b64, q64 = hx(dyn.r), hx(dyn.b), hx(dyn.q)
    dx64 = hx(grid.dx)
    mu_x = (b64 - q64) - 0.5 * sig2
    alpha = 0.5 * sig2 / (dx64 * dx64)
    beta_adv = mu_x / (2.0 * dx64)
    a_coef = alpha - beta_adv
    c_coef = alpha + beta_adv

    ln_g = 0.5 * torch.log1p(-2.0 * beta_adv / c_coef)
    ii = torch.arange(M, dtype=f64, device=device) + 1.0
    d_vec = torch.exp(ii[None, :] * ln_g[:, None])  # f64; cast at use sites
    d_vec_s = sc(d_vec)
    off = torch.sqrt(a_coef * c_coef)
    half_t = 0.5 * math.pi * ii / (M + 1.0)
    lam = -(
        (r64 + 2.0 * beta_adv * beta_adv / (alpha + off))[:, None]
        + 4.0 * off[:, None] * (torch.sin(half_t) ** 2)[None, :]
    )

    s_k1 = dst[:, 0]
    s_kM = dst[:, M - 1]
    P = sc((dt64 * a_coef * torch.exp(-ln_g))[:, None] * s_k1)
    Q = sc((dt64 * c_coef * torch.exp(-M * ln_g))[:, None] * s_kM)

    gam = b64 - q64 - r64
    zero = torch.zeros_like(r64)
    strike64 = hx(dyn.strike)
    A_lo = torch.where(dyn.is_call, zero, strike64)
    B_lo = torch.where(dyn.is_call, zero, -s_min if euro_put_lower_boundary else zero)
    A_hi = torch.where(dyn.is_call, -strike64, zero)
    B_hi = torch.where(dyn.is_call, s_max, zero)

    if barrier is not None:
        out_mask = (barrier.has_lower[:, None] & (s <= sc(hx(barrier.lower))[:, None])) | (
            barrier.has_upper[:, None] & (s >= sc(hx(barrier.upper))[:, None])
        )

    channels = ((-r64, A_lo, A_hi), (gam, B_lo, B_hi))
    alphas = tuple(a for a, _, _ in channels)
    profile = lambda a_r, lo, hi, th: _channel_profile(
        alpha, beta_adv, c_coef, ln_g, r64, ii, n_nodes, a_r, lo, hi, th, dt64)
    u_cn = [profile(a, lo, hi, 0.5) for a, lo, hi in channels]
    u_imp = [profile(a, lo, hi, 1.0) for a, lo, hi in channels]
    u_cn_s = [sc(u) for u in u_cn]
    ud_bar_s = [sc(mm64((uc - ui) / d_vec)) for uc, ui in zip(u_cn, u_imp)]

    def exp_rate(a_r, tau):
        """e^{a_r tau} at f64, returned f32, (B,)."""
        return sc(torch.exp(a_r * hx(tau)))

    def E_channels_s(tau):
        tot = None
        for a_r, u_s in zip(alphas, u_cn_s):
            term = exp_rate(a_r, tau)[:, None] * u_s
            tot = term if tot is None else tot + term
        return tot

    def boundary_s(tau):
        """(v_lo, v_hi) asymptotics at tau from the channel amplitudes."""
        e_r = exp_rate(-r64, tau)
        e_g = exp_rate(gam, tau)
        return sc(A_lo) * e_r + sc(B_lo) * e_g, sc(A_hi) * e_r + sc(B_hi) * e_g

    w = sc(mm64((payoff[:, 1:-1] - E_channels_s(torch.zeros_like(s[:, 0]))) / d_vec_s))
    v_lo_act, v_hi_act = payoff[:, 0], payoff[:, -1]

    z64 = dt64[:, None] * lam
    rho_cache = {th: (*_log_rho(z64, th), sc(1.0 - th * z64)) for th in (1.0, 0.5)}

    def pow_s(log_mag64, neg, m):
        mf = m.to(f64)[:, None]
        mag = sc(torch.exp(mf * log_mag64))
        odd = torch.remainder(mf, 2.0) > 0.5
        out = torch.where(neg & odd, -mag, mag)
        return torch.where(mf > 0.5, out, torch.ones_like(out))

    def stage(w, m, theta, d_lo, d_hi):
        log_mag, neg, denom_s = rho_cache[theta]
        w_new = pow_s(log_mag, neg, m) * w
        if theta == 1.0:
            return w_new
        corr = (1.0 - theta) * (P * d_lo[:, None] + Q * d_hi[:, None]) / denom_s
        return w_new + pow_s(log_mag, neg, torch.clamp(m - 1, min=0)) * torch.where(
            (m > 0)[:, None], corr, torch.zeros_like(corr)
        )

    def switch(w, tau, sign):
        for a_r, ud_s in zip(alphas, ud_bar_s):
            w = w + sign * exp_rate(a_r, tau)[:, None] * ud_s
        return w

    R = rannacher_steps
    plan = plan if plan is not None else interval_plan(k_end, apply_proj, R)
    k_end = k_end.long()
    k_start = torch.zeros_like(k_end[:, 0])
    for j, iv in enumerate(plan):
        if not iv.live:
            continue
        projects = iv.projects
        ke, do_proj = k_end[:, j], apply_proj[:, j]
        m = ke - k_start
        tau_s = sc(k_start.to(f64) * dt64)
        v_lo_asym, v_hi_asym = boundary_s(tau_s)
        d_lo = v_lo_act - v_lo_asym
        d_hi = v_hi_act - v_hi_asym
        n_imp = torch.minimum(torch.clamp(R - k_start, min=0), m)
        n_cn = m - n_imp
        tau_mid = sc((k_start + n_imp).to(f64) * dt64)
        w1 = stage(switch(w, tau_s, +1.0), n_imp, 1.0, d_lo, d_hi)
        d_lo2 = torch.where(n_imp > 0, torch.zeros_like(d_lo), d_lo)
        d_hi2 = torch.where(n_imp > 0, torch.zeros_like(d_hi), d_hi)
        w2 = stage(switch(w1, tau_mid, -1.0), n_cn, 0.5, d_lo2, d_hi2)

        tau_e = sc(ke.to(f64) * dt64)
        v_lo_e, v_hi_e = boundary_s(tau_e)
        if projects:
            E_e = E_channels_s(tau_e)
            v_int = sc(mm64(w2)) * d_vec_s + E_e
            v_full = torch.cat([v_lo_e[:, None], v_int, v_hi_e[:, None]], dim=1)
            if barrier is not None:
                reb = sc(hx(barrier.rebate))
                rebate_pv = torch.where(
                    barrier.rebate_at_hit, reb, reb * exp_rate(-hx(barrier.rebate_rate), tau_e))
                v_proj = torch.where(do_proj[:, None] & out_mask, rebate_pv[:, None], v_full)
            else:
                v_proj = v_full
            w_proj = sc(mm64((v_proj[:, 1:-1] - E_e) / d_vec_s))
            w = torch.where(do_proj[:, None], w_proj, w2)
            v_lo_act = torch.where(do_proj, v_proj[:, 0], v_lo_e)
            v_hi_act = torch.where(do_proj, v_proj[:, -1], v_hi_e)
        else:
            w, v_lo_act, v_hi_act = w2, v_lo_e, v_hi_e
        k_start = ke
    tau_fin = sc(k_start.to(f64) * dt64)
    v_final = torch.cat(
        [v_lo_act[:, None], sc(mm64(w)) * d_vec_s + E_channels_s(tau_fin), v_hi_act[:, None]], dim=1
    )
    return v_final, s


# --------------------------------------------------------------------------- #
# CUDA graphs of the solve                                                     #
# --------------------------------------------------------------------------- #
# A solve launches about 800 device kernels from Python (one per (B, M) pass,
# per (B, n_iv) table and per DST); the host's launch time then sets the
# pace at small batches and leaves the card idle a third of the time at
# B=4096 (chip_smoke.py's spectral phase). A graph replays them in one launch.
# Each graph keeps its own memory pool. chip_smoke.py's spectral phase
# measures the largest solve it runs (float64, B=4096, N=1024) on an H100:
# its capture (warm-up, capture, replay) takes about 480 ms against 22 ms
# replayed and leaves 0.18 GB more reserved.
#
# The capture rule: in a key's first driver call its solves run eagerly; its
# second call captures, and later calls replay. The key holds the host plan,
# which changes with the trades' monitor layout, so a serving stream of
# mixed trades makes new keys often (every single-trade request padded with
# its own clones is one); a capture costs about 20 replays and pays only
# where the key comes back (chip_smoke.py's serving phase counts both). A
# call's further solves (the vega bump's, of the same key) follow its first:
# they never capture. GRAPH_CACHE_SIZE covers the serving buckets (8 ...
# 4096: ten) with room for the other routes' shapes; chip_smoke.py's whole
# run, serving included, leaves about 5.4 GB reserved on the H100. A key
# holds its tensors' device and a graph its memory there, so the bound is
# per device: a call over a mesh of n cards keeps its n shards' graphs
# without evicting the keys of the cards' other shapes.
#
# The scalar pricers' scan (american._solve_batch) shares the rule and the
# cache: one solve is one driver call, keyed on its shape and scan plan.
_GRAPHS: "OrderedDict[tuple, tuple]" = OrderedDict()
_SEEN: "OrderedDict[tuple, None]" = OrderedDict()  # keys run once, eagerly
GRAPH_CACHE_SIZE = 16  # graphs kept per device, the least recently used dropped first
SEEN_KEYS = 1024  # keys remembered between their first and second call
graph_counts: Dict[str, int] = {"eager": 0, "captures": 0, "replays": 0}


def reset_graph_counts() -> None:
    for name in graph_counts:
        graph_counts[name] = 0


def _drop_least_recent(device: torch.device) -> None:
    """Drop ``device``'s least recently used graphs past GRAPH_CACHE_SIZE."""
    keys = [k for k, hit in _GRAPHS.items() if hit[3] == device]
    for k in keys[: max(len(keys) - GRAPH_CACHE_SIZE, 0)]:
        del _GRAPHS[k]


def run_graphed(key: tuple, solve, tensors: Sequence[torch.Tensor],
                new_call: bool = True) -> Tuple[torch.Tensor, ...]:
    """``solve(*tensors)`` by the capture rule above: eagerly in the first
    driver call with this ``key``; in the second, captured into a CUDA graph
    (after one warm-up run on a side stream, which builds the DST matrix and
    cuBLAS's state on the spectral route) and replayed; later, replayed. ``new_call``: this solve
    starts a driver call (one sighting of ``key``); a solve that does not
    replays an existing graph or runs eagerly. ``key`` must name
    everything the captured work depends on besides the values of
    ``tensors``: their shapes and dtypes, and the host-side plan. A replay
    copies the inputs into the graph's buffers and returns clones of the
    outputs. At most :data:`GRAPH_CACHE_SIZE` graphs are kept per device
    (that of ``tensors``), the least recently used there dropped first;
    :data:`graph_counts` counts each kind of call. Not safe to call from
    two threads at once."""
    hit = _GRAPHS.get(key)
    if hit is None:
        if not new_call or key not in _SEEN:
            if new_call:
                _SEEN[key] = None
                while len(_SEEN) > SEEN_KEYS:
                    _SEEN.popitem(last=False)
            graph_counts["eager"] += 1
            return tuple(solve(*tensors))
        del _SEEN[key]
        static = [t.clone() for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            solve(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # captured on the side stream, which is the current card's:
        # torch.cuda.graph's default capture stream is made once, on the
        # card current at the process's first capture, and a capture of
        # another card's work there fails
        with torch.cuda.graph(graph, stream=side):
            out = solve(*static)
        hit = _GRAPHS[key] = (graph, static, out, static[0].device)
        _drop_least_recent(static[0].device)
        graph_counts["captures"] += 1
    else:
        _GRAPHS.move_to_end(key)
    graph_counts["replays"] += 1
    graph, static, out, _ = hit
    for buf, t in zip(static, tensors):
        buf.copy_(t)
    graph.replay()
    return tuple(o.clone() for o in out)
