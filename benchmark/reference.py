"""The plain reference of the rows a pricing service returns.

Plain PyTorch at float64, written from the reference desk's conventions and
independent of the program under test: it imports nothing of the port and
takes nothing the port made. From the trade dicts the benchmark handed the
service it works out again each trade's grid, time schedule, barrier or
dividend events and greeks, and marches the Crank–Nicolson (Rannacher)
scheme with a tridiagonal solve of its own (parallel cyclic reduction).

The grid and schedule rules are frozen copies of the desk's:

- the barrier grid: a domain of 2 Phi^-1(0.99999) sigma sqrt(T) about the
  geometric mean of spot, strike and barriers, widened to [0.5 s_low,
  2 s_high] (discrete_barrier_fdm_pricer.py:270-340); uniform dt = T/n,
  Rannacher's first two steps implicit, a monitor at t projected after step
  floor((T - t)/dt + 1e-9) (clamped to [1, n]), and a monitor at expiry
  added when the trade's list lacks one (:442-547);
- the American grid: a band of 4.5 sigma sqrt(T) about sqrt(spot strike),
  widened to [0.5 s_low, 2 s_high] (fd_american_equity.py:340-411);
  segments at the dividend dates, round(length / (T/n)) steps each, the
  remainder to the last; Ikonen–Toivanen splitting with its multiplier reset
  at each segment start; the cash dividend jump V(S) <- V(S - D) through a
  natural cubic spline (:701-843);
- greeks: the price by linear interpolation at spot, delta and gamma by the
  three-point non-uniform stencil at the node nearest spot, vega as the
  one-sided difference of a full re-solve at sigma + 1e-4 (per vol point),
  barrier theta from the Black–Scholes identity (:843-870); knock-ins by
  parity, KI(R) = vanilla - KO(R at expiry) + R DF, the vanilla leg's greeks
  by bumps of the generalized Black–Scholes price; Richardson's
  (4 P(2n) - P(n)) / 3 on every output (fd_american_equity.py:925-1060).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

PPF_99999 = 4.264890793922602  # Phi^-1(0.99999)
RANNACHER_STEPS = 2
VEGA_BUMP = 1e-4
F64 = torch.float64


# --------------------------------------------------------------------------- #
# grids and schedules (one trade at a time, on the host)                       #
# --------------------------------------------------------------------------- #
def barrier_grid(spot, strike, sigma, t, lower, upper, n_space):
    """(x_min, dx) of the barrier grid with ``n_space`` intervals."""
    levels = [spot, strike] + [h for h in (lower, upper) if h is not None and h > 0.0]
    s_low, s_high = min(levels), max(levels)
    width = 2.0 * PPF_99999 * sigma * math.sqrt(max(t, 1e-12))
    x_c = math.log(math.sqrt(s_low * s_high))
    s_min = max(min(math.exp(x_c - 0.5 * width), 0.5 * s_low), 1e-12)
    s_max = max(math.exp(x_c + 0.5 * width), 2.0 * s_high)
    return math.log(s_min), (math.log(s_max) - math.log(s_min)) / n_space


def american_grid(spot, strike, sigma, t, n_space, band_mult=4.5):
    """(x_min, dx) of the American grid with ``n_space`` intervals."""
    s_low, s_high = min(spot, strike), max(spot, strike)
    x_c = math.log(math.sqrt(max(s_low * s_high, 1e-12)))
    band = band_mult * sigma * math.sqrt(max(t, 1e-12))
    s_min = max(min(math.exp(x_c - 0.5 * band), 0.5 * s_low), 1e-8)
    s_max = max(math.exp(x_c + 0.5 * band), 2.0 * s_high)
    return math.log(s_min), (math.log(s_max) - math.log(s_min)) / n_space


def barrier_schedule(t, n, monitors):
    """dt, theta, tau after each step, monitor flag: (n,) arrays."""
    dt = np.full(n, t / n)
    theta = np.where(np.arange(n) < RANNACHER_STEPS, 1.0, 0.5)
    mon = np.zeros(n, dtype=bool)
    times = [float(m) for m in monitors]
    if not times or times[-1] < t - 1e-14:
        times.append(t)
    for tm in times:
        if 0.0 < tm <= t:
            k = min(max(int(math.floor((t - tm) / (t / n) + 1e-9)), 1), n)
            mon[k - 1] = True
    return dict(dt=dt, theta=theta, tau=np.cumsum(dt), monitor=mon,
                div=np.zeros(n), reset=np.zeros(n, dtype=bool))


def american_schedule(t, n, dividends, is_call):
    """The segmented schedule of a trade with cash ``dividends``
    [(tau before expiry, amount)]: (n,) arrays."""
    divs = sorted((float(a), float(d)) for a, d in dividends if 0.0 < float(a) < t)
    taus = [0.0] + [a for a, _ in divs] + [t]
    lengths = [hi - lo for lo, hi in zip(taus[:-1], taus[1:])]
    steps, left = [], n
    for length in lengths[:-1]:
        steps.append(max(1, int(round(length / (t / n)))))
        left -= steps[-1]
    steps.append(max(1, left))
    if sum(steps) != n:
        raise ValueError("dividend segments do not fit the step count")
    cols = {k: [] for k in ("dt", "theta", "div", "reset")}
    for j, (length, ns) in enumerate(zip(lengths, steps)):
        restart = j == 0 or is_call
        for k in range(ns):
            cols["dt"].append(length / ns)
            cols["theta"].append(1.0 if restart and k < RANNACHER_STEPS else 0.5)
            cols["div"].append(divs[j][1] if k == ns - 1 and j < len(divs) else 0.0)
            cols["reset"].append(k == 0)
    out = {k: np.asarray(v) for k, v in cols.items()}
    out["tau"] = np.cumsum(out["dt"])
    out["monitor"] = np.zeros(n, dtype=bool)
    return out


# --------------------------------------------------------------------------- #
# tridiagonal solves: parallel cyclic reduction                                #
# --------------------------------------------------------------------------- #
def pcr_factor(lo, di, up):
    """Factors of the tridiagonal systems lo x[i-1] + di x[i] + up x[i+1],
    (B, n) each (lo[:, 0] and up[:, -1] unread): per level its stride and
    the multipliers of the rows ``stride`` below and above, then the final
    diagonal."""
    n = di.shape[1]
    a, b, c = lo.clone(), di.clone(), up.clone()
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    levels = []
    s = 1
    while s < n:
        k1 = torch.zeros_like(b)
        k2 = torch.zeros_like(b)
        k1[:, s:] = a[:, s:] / b[:, :-s]
        k2[:, :-s] = c[:, :-s] / b[:, s:]
        nb = b.clone()
        nb[:, s:] -= k1[:, s:] * c[:, :-s]
        nb[:, :-s] -= k2[:, :-s] * a[:, s:]
        na = torch.zeros_like(a)
        nc = torch.zeros_like(c)
        na[:, s:] = -k1[:, s:] * a[:, :-s]
        nc[:, :-s] = -k2[:, :-s] * c[:, s:]
        levels.append((s, k1[:, s:].contiguous(), k2[:, :-s].contiguous()))
        a, b, c = na, nb, nc
        s *= 2
    return levels, b


def pcr_solve(factor, d):
    levels, diag = factor
    for s, k1, k2 in levels:
        nd = d.clone()
        nd[:, s:].addcmul_(k1, d[:, :-s], value=-1.0)
        nd[:, :-s].addcmul_(k2, d[:, s:], value=-1.0)
        d = nd
    return d / diag


def spline_shift(s, v, div):
    """The natural cubic spline through (s, v) per row, at s - div; values
    beyond the end knots clamp to them."""
    h = s[:, 1:] - s[:, :-1]
    dy = v[:, 1:] - v[:, :-1]
    rhs = 3.0 * (dy[:, 1:] / h[:, 1:] - dy[:, :-1] / h[:, :-1])
    c_int = pcr_solve(pcr_factor(h[:, :-1], 2.0 * (h[:, :-1] + h[:, 1:]), h[:, 1:]), rhs)
    zero = torch.zeros_like(s[:, :1])
    c = torch.cat([zero, c_int, zero], dim=1)
    slope = dy / h - h * (c[:, 1:] + 2.0 * c[:, :-1]) / 3.0
    cubic = (c[:, 1:] - c[:, :-1]) / (3.0 * h)
    xq = s - div
    j = (torch.searchsorted(s.contiguous(), xq.contiguous(), right=True) - 1).clamp(0, s.shape[1] - 2)
    at = lambda a: torch.gather(a, 1, j)
    z = xq - at(s[:, :-1])
    out = at(v[:, :-1]) + z * (at(slope) + z * (at(c[:, :-1]) + z * at(cubic)))
    out = torch.where(xq <= s[:, :1], v[:, :1], out)
    return torch.where(xq >= s[:, -1:], v[:, -1:], out)


# --------------------------------------------------------------------------- #
# the march                                                                    #
# --------------------------------------------------------------------------- #
def march(t: Dict[str, torch.Tensor], sched: Dict[str, torch.Tensor], plan: Dict[str, set],
          sigma, n_nodes: int, american: bool):
    """V (B, n_nodes) at valuation and the nodes S (B, n_nodes).

    ``t``: per-trade (B,) columns x_min, dx, strike, is_call, r, b, q and
    the barrier's lower, upper, has_lower, has_upper, rebate, rebate_at_hit;
    ``sched``: (B, n) dt, theta, tau, monitor, div, reset; ``plan``: the
    steps at which some row's (theta, dt) changes (``refactor``), some row
    is monitored (``monitor``) or takes a dividend (``div``)."""
    dev = sigma.device
    i = torch.arange(n_nodes, dtype=F64, device=dev)
    s = torch.exp(t["x_min"][:, None] + i[None, :] * t["dx"][:, None])
    call = t["is_call"][:, None]
    payoff = torch.where(call, (s - t["strike"][:, None]).clamp(min=0.0),
                         (t["strike"][:, None] - s).clamp(min=0.0))
    v = payoff.clone()
    alpha = 0.5 * sigma * sigma / (t["dx"] * t["dx"])
    beta = ((t["b"] - t["q"]) - 0.5 * sigma * sigma) / (2.0 * t["dx"])
    a_co, c_co, b_co = alpha - beta, alpha + beta, -2.0 * alpha - t["r"]
    tau = sched["tau"]
    growth = torch.exp((t["b"] - t["q"] - t["r"])[:, None] * tau)
    disc = torch.exp(-t["r"][:, None] * tau)
    v_max = torch.where(call, s[:, -1:] * growth - t["strike"][:, None] * disc, 0.0)
    put_min = t["strike"][:, None] * disc
    if not american:
        put_min = put_min - s[:, :1] * growth
    v_min = torch.where(call, 0.0, put_min)
    ko = (t["has_lower"][:, None] & (s <= t["lower"][:, None])) | (
        t["has_upper"][:, None] & (s >= t["upper"][:, None]))
    rebate_pv = torch.where(t["rebate_at_hit"][:, None], t["rebate"][:, None],
                            t["rebate"][:, None] * torch.exp(-t["b"][:, None] * tau))
    pay_int = payoff[:, 1:-1]
    lam = torch.zeros_like(pay_int)
    dts, thetas = sched["dt"], sched["theta"]
    n_int = n_nodes - 2
    for k in range(dts.shape[1]):
        dt, th = dts[:, k], thetas[:, k]
        if k in plan["refactor"]:
            ones = torch.ones(len(dt), n_int, dtype=F64, device=dev)
            lo_i, di_i, up_i = -th * dt * a_co, 1.0 - th * dt * b_co, -th * dt * c_co
            factor = pcr_factor(lo_i[:, None] * ones, di_i[:, None] * ones, up_i[:, None] * ones)
            ex = [((1.0 - th) * dt * a_co)[:, None], (1.0 + (1.0 - th) * dt * b_co)[:, None],
                  ((1.0 - th) * dt * c_co)[:, None]]
        rhs = ex[0] * v[:, :-2] + ex[1] * v[:, 1:-1] + ex[2] * v[:, 2:]
        if american:
            lam = torch.where(sched["reset"][:, k, None], 0.0, lam)
            rhs = rhs + dt[:, None] * lam
        rhs[:, 0] -= lo_i * v_min[:, k]
        rhs[:, -1] -= up_i * v_max[:, k]
        x = pcr_solve(factor, rhs)
        if american:
            inner = torch.maximum(pay_int, x - dt[:, None] * lam)
            lam = (lam + (pay_int - x) / dt[:, None]).clamp(min=0.0)
        else:
            inner = x
        v = torch.cat([v_min[:, k, None], inner, v_max[:, k, None]], dim=1)
        if k in plan["monitor"]:
            v = torch.where(sched["monitor"][:, k, None] & ko, rebate_pv[:, k, None], v)
        if k in plan["div"]:
            d = sched["div"][:, k, None]
            shifted = spline_shift(s, v, d)
            shifted = torch.where(call, torch.maximum(shifted, payoff), shifted)
            v = torch.where(d != 0.0, shifted, v)
    return v, s


def _interp(xq, s, v):
    """Linear interpolation of each row's v(s) at xq (B,), clamped."""
    n = s.shape[1]
    j = torch.searchsorted(s.contiguous(), xq[:, None].contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(s, 1, j - 1), torch.gather(s, 1, j)
    f0, f1 = torch.gather(v, 1, j - 1), torch.gather(v, 1, j)
    f = f0 + (xq[:, None] - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(xq[:, None] < s[:, :1], v[:, :1], f)
    return torch.where(xq[:, None] > s[:, -1:], v[:, -1:], f)[:, 0]


def _delta_gamma(s, v, spot):
    n = s.shape[1]
    j = torch.argmin((s - spot[:, None]).abs(), dim=1).clamp(1, n - 2)[:, None]
    at = lambda a, o: torch.gather(a, 1, j + o)[:, 0]
    h1, h2 = at(s, 0) - at(s, -1), at(s, 1) - at(s, 0)
    vm, v0, vp = at(v, -1), at(v, 0), at(v, 1)
    delta = -h2 / (h1 * (h1 + h2)) * vm + (h2 - h1) / (h1 * h2) * v0 + h1 / (h2 * (h1 + h2)) * vp
    gamma = 2.0 * (vm / (h1 * (h1 + h2)) - v0 / (h1 * h2) + vp / (h2 * (h1 + h2)))
    return delta, gamma


def _outputs(t, sched, n_nodes, american, with_theta):
    sched, plan = sched
    v0, s = march(t, sched, plan, t["sigma"], n_nodes, american)
    v1, _ = march(t, sched, plan, t["sigma"] + VEGA_BUMP, n_nodes, american)
    price = _interp(t["spot"], s, v0)
    delta, gamma = _delta_gamma(s, v0, t["spot"])
    out = dict(price=price, delta=delta, gamma=gamma,
               vega=(_interp(t["spot"], s, v1) - price) / (VEGA_BUMP * 100.0))
    if with_theta:
        sp = t["spot"]
        out["theta"] = -(0.5 * t["sigma"] ** 2 * sp**2 * gamma
                         + (t["b"] - t["q"]) * sp * delta - t["r"] * price)
    return out


def _columns(rows: List[dict], device) -> Dict[str, torch.Tensor]:
    keys = rows[0].keys()
    return {k: torch.tensor([r[k] for r in rows], device=device,
                            dtype=torch.bool if isinstance(rows[0][k], bool) else F64)
            for k in keys}


def _schedules(scheds: List[dict], device):
    """The (B, n) schedule tensors and the march's host plan."""
    host = {k: np.stack([sc[k] for sc in scheds]) for k in scheds[0]}
    cols = lambda mask: set(np.flatnonzero(mask.any(axis=0)).tolist())
    same = (host["dt"][:, 1:] == host["dt"][:, :-1]) & (host["theta"][:, 1:] == host["theta"][:, :-1])
    plan = dict(refactor={0} | {k + 1 for k in cols(~same)},
                monitor=cols(host["monitor"]), div=cols(host["div"] != 0.0))
    tensors = {k: torch.as_tensor(v, device=device, dtype=torch.bool if v.dtype == bool else F64)
               for k, v in host.items()}
    return tensors, plan


# --------------------------------------------------------------------------- #
# the generalized Black–Scholes leg of knock-in parity                         #
# --------------------------------------------------------------------------- #
def _gbs(s, k, sig, te, r, b, call):
    ncdf = torch.special.ndtr
    vol = sig * torch.sqrt(te)
    fwd = s * torch.exp(b * te)
    d1 = (torch.log(fwd / k) + 0.5 * vol * vol) / vol
    d2 = d1 - vol
    df = torch.exp(-r * te)
    return torch.where(call, df * (fwd * ncdf(d1) - k * ncdf(d2)),
                       df * (k * ncdf(-d2) - fwd * ncdf(-d1)))


def _knock_in_parity(t, out, is_in):
    """KI(R) = vanilla - KO(R at expiry) + R DF, on the rows ``is_in``."""
    s, k, sig, te, r = t["spot"], t["strike"], t["sigma"], t["t"], t["r"]
    b, call, reb = t["b"] - t["q"], t["is_call"], t["rebate"]
    df = torch.exp(-r * te)
    van = _gbs(s, k, sig, te, r, b, call)
    ds = s * 1e-4
    up, dn = _gbs(s + ds, k, sig, te, r, b, call), _gbs(s - ds, k, sig, te, r, b, call)
    dte = torch.clamp(0.5 * te, max=1e-5)
    leg = dict(
        price=van + reb * df,
        delta=(up - dn) / (2 * ds),
        gamma=(up - 2 * van + dn) / ds**2,
        vega=(_gbs(s, k, sig + 1e-4, te, r, b, call) - van) / (100.0 * 1e-4),
        theta=-(_gbs(s, k, sig, te + dte, r, b, call) - _gbs(s, k, sig, te - dte, r, b, call))
        / (2 * dte) + r * reb * df,
    )
    return {key: torch.where(is_in, leg[key] - val, val) for key, val in out.items()}


# --------------------------------------------------------------------------- #
# the rows a service returns                                                   #
# --------------------------------------------------------------------------- #
def barrier_rows(trades: Sequence[Mapping], n_steps: int, n_space: int, device) -> List[dict]:
    """Price, delta, gamma, vega and theta of each barrier (or vanilla)
    trade dict, as the barrier service's schema defines them, on a grid of
    ``n_space`` intervals and ``n_steps`` steps."""
    cols, scheds, is_in = [], [], []
    for tr in trades:
        kind = str(tr.get("barrier_type", "none"))
        lower = tr.get("lower") if kind != "none" and "up" not in kind else None
        upper = tr.get("upper") if kind != "none" and "down" not in kind else None
        spot, strike, sigma, te = (float(tr[k]) for k in ("spot", "strike", "sigma", "t_expiry"))
        x_min, dx = barrier_grid(spot, strike, sigma, te, lower, upper, n_space)
        r = float(tr["r"])
        knock_in = "in" in kind
        cols.append(dict(
            x_min=x_min, dx=dx, spot=spot, strike=strike, sigma=sigma, t=te, r=r,
            b=float(tr.get("b", r)), q=float(tr.get("q", 0.0)),
            is_call=bool(tr.get("is_call", True)),
            lower=float(lower or 0.0), upper=float(upper or 0.0),
            has_lower=lower is not None, has_upper=upper is not None,
            rebate=float(tr.get("rebate", 0.0)),
            rebate_at_hit=bool(tr.get("rebate_at_hit", False)) and not knock_in,
        ))
        scheds.append(barrier_schedule(te, n_steps, tr.get("monitor_times", [te])))
        is_in.append(knock_in)
    t = _columns(cols, device)
    out = _outputs(t, _schedules(scheds, device), n_space + 1, american=False, with_theta=True)
    out = _knock_in_parity(t, out, torch.tensor(is_in, device=device))
    return _rows(out)


def american_rows(trades: Sequence[Mapping], n_steps: int, n_space: int, device,
                  richardson: bool = True) -> List[dict]:
    """Price, delta, gamma and vega of each American trade dict, as the
    American service's schema defines them (``n_space`` + 2 nodes), with
    Richardson's combination of the ``n_steps`` and ``2 n_steps`` marches."""
    def solve(n):
        cols, scheds = [], []
        for tr in trades:
            spot, strike, sigma, te = (float(tr[k]) for k in ("spot", "strike", "sigma", "t_expiry"))
            x_min, dx = american_grid(spot, strike, sigma, te, n_space)
            r = float(tr["r"])
            call = bool(tr.get("is_call", False))
            cols.append(dict(
                x_min=x_min, dx=dx, spot=spot, strike=strike, sigma=sigma, t=te, r=r,
                b=float(tr.get("b", r)), q=0.0, is_call=call, lower=0.0, upper=0.0,
                has_lower=False, has_upper=False, rebate=0.0, rebate_at_hit=False,
            ))
            scheds.append(american_schedule(te, n, tr.get("dividends", []), call))
        return _outputs(_columns(cols, device), _schedules(scheds, device), n_space + 2,
                        american=True, with_theta=False)

    coarse = solve(n_steps)
    if not richardson:
        return _rows(coarse)
    fine = solve(2 * n_steps)
    return _rows({k: (4.0 * fine[k] - coarse[k]) / 3.0 for k in coarse})


def _rows(out: Dict[str, torch.Tensor]) -> List[dict]:
    host = {k: v.cpu().numpy() for k, v in out.items()}
    n = len(next(iter(host.values())))
    return [{k: float(v[i]) for k, v in host.items()} for i in range(n)]


ROWS = {"barrier": barrier_rows, "american": american_rows}
