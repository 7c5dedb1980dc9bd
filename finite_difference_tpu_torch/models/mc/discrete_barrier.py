"""Curve-driven discrete-barrier Monte Carlo pricer (counterpart of
``finite_difference_tpu.models.mc.discrete_barrier``).

Capability parity with the reference's vectorised MC
(mc_discrete_barrier_option.py:160-425 and the twin in
class_yield.py:82-230):

- event grid = valuation ∪ dividend dates ∪ monitor dates ∪ maturity, with
  maturity always monitored when ``include_maturity_monitor``;
- per-interval drift from the forward curve's forward NACC,
  drift = (carry - sigma^2/2) tau, diffusion sigma sqrt(tau);
- barrier tolerance band max(abs_tol, |H| * tol_bps * 1e-4); down breaches
  at s <= H + band, up at s >= H - band;
- dividend-before/after-monitor ordering flag, spot floored after drops;
- KO alive-mask with rebate at hit (PV at the hit step's grid date) or at
  expiry; KI hit-mask; antithetic pair averaging; price/stderr/CI95.

The host resolves dates and curves into per-step arrays; the paths run on
the device, all at once, one Python step per event (JAX's ``lax.scan``),
with the threefry normals of :mod:`.rng` (the same draws as the JAX
package's for a seed). The dividend and monitor flags are host values, so
each step runs only the operations its event needs.
"""
from __future__ import annotations

import datetime as dt
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.curves import DailyNacaCurve
from .rng import _normals, prng_key

OptionType = str  # "call" | "put"


@dataclass(frozen=True)
class BarrierSpec:
    barrier_type: str  # none | down-and-out | up-and-out | down-and-in | up-and-in
    level: Optional[float] = None
    tol_bps: float = 0.0
    abs_tol: float = 0.0


@dataclass(frozen=True)
class RebateSpec:
    amount: float = 0.0
    rebate_at_hit: bool = False


@dataclass(frozen=True)
class MCConfig:
    n_paths: int = 200_000
    seed: int = 42
    antithetic: bool = True
    chunk_size: int = 50_000  # kept for API parity; the device path is chunk-free
    dividend_before_monitor: bool = True
    spot_floor: float = 1e-12


def _barrier_band(level: float, tol_bps: float, abs_tol: float) -> float:
    return max(abs_tol, abs(level) * (tol_bps * 1e-4))


def build_event_grid(
    valuation: dt.date,
    maturity: dt.date,
    dividends: Sequence[Tuple[dt.date, float]],
    monitor_dates: Sequence[dt.date],
    include_maturity_monitor: bool = True,
):
    if maturity <= valuation:
        raise ValueError("maturity must be after valuation.")
    div_map: Dict[dt.date, float] = {}
    for d, amt in dividends:
        if valuation < d <= maturity and float(amt) != 0.0:
            div_map[d] = div_map.get(d, 0.0) + float(amt)
    monitor_set = {d for d in monitor_dates if valuation < d <= maturity}
    if include_maturity_monitor:
        monitor_set.add(maturity)
    grid = sorted({valuation, maturity, *div_map.keys(), *monitor_set})
    return grid, div_map, monitor_set


def _simulate_kernel(
    key,
    n_obs: int,
    spot: float,
    strike: float,
    drift: np.ndarray,  # (n_steps,)
    diff: np.ndarray,  # (n_steps,)
    div_amt: np.ndarray,  # (n_steps,)
    is_mon: np.ndarray,  # (n_steps,) bool
    step_df: np.ndarray,  # (n_steps,) discount factor at each step's grid date
    level: float,
    band: float,
    df_t: float,
    rebate_amount: float,
    spot_floor: float,
    is_call: bool,
    barrier_kind: str,  # "none"|"down-out"|"up-out"|"down-in"|"up-in"
    antithetic: bool,
    dividend_before_monitor: bool,
    rebate_at_hit: bool,
    device=DEFAULT_DEVICE,
):
    """(mean, stderr) as 0-d float64 tensors on ``device``."""
    dev = resolve_device(device)
    n_steps = drift.shape[0]
    # JAX draws z (n_obs, n_steps) row-major; the same counters laid out
    # (n_steps, n_obs) give its transpose, one contiguous row per step
    counts = (torch.arange(n_steps, dtype=torch.int64, device=dev)[:, None]
              + torch.arange(n_obs, dtype=torch.int64, device=dev)[None, :] * n_steps)
    z = _normals(key, counts, torch.float64)
    del counts
    barrier_at = level + band if barrier_kind.startswith("down") else level - band

    def drop_dividend(s, i):
        return torch.clamp_min(s - float(div_amt[i]), spot_floor) if div_amt[i] != 0.0 else s

    def run(sign: float):
        s = torch.full((n_obs,), spot, dtype=torch.float64, device=dev)
        alive = torch.ones((n_obs,), dtype=torch.bool, device=dev)
        hit = torch.zeros((n_obs,), dtype=torch.bool, device=dev)
        hit_df = torch.zeros((n_obs,), dtype=torch.float64, device=dev)
        for i in range(n_steps):
            # diff * (-z) = (-diff) * z exactly
            s = s * torch.exp(float(drift[i]) + (sign * float(diff[i])) * z[i])
            if dividend_before_monitor:
                s = drop_dividend(s, i)
            if barrier_kind != "none" and is_mon[i]:
                breached = s <= barrier_at if barrier_kind.startswith("down") else s >= barrier_at
                if barrier_kind.endswith("out"):
                    hit_df = torch.where(alive & breached, float(step_df[i]), hit_df)
                    alive = alive & ~breached
                else:
                    hit = hit | breached
            if not dividend_before_monitor:
                s = drop_dividend(s, i)

        vanilla = torch.clamp_min(s - strike, 0.0) if is_call else torch.clamp_min(strike - s, 0.0)
        if barrier_kind == "none":
            return df_t * vanilla
        if barrier_kind.endswith("out"):
            out = torch.where(alive, df_t * vanilla, 0.0)
            if rebate_at_hit:
                return torch.where(~alive, rebate_amount * hit_df, out)
            return torch.where(~alive, rebate_amount * df_t, out)
        # knock-in: vanilla iff hit, plus the RR-convention rebate paid at
        # expiry iff the barrier is NEVER hit (reiner_rubinstein term E /
        # equity_barrier semantics). The reference MC drops this leg
        # (mc_discrete_barrier_option.py:386-387 — rebate is KO-only
        # there).
        hitf = hit.to(vanilla.dtype)
        return df_t * vanilla * hitf + rebate_amount * df_t * (1.0 - hitf)

    p = run(1.0)
    if antithetic:
        p = 0.5 * (p + run(-1.0))
    mean = torch.mean(p)
    stderr = torch.std(p, correction=1) / math.sqrt(n_obs)
    return mean, stderr


def price_discrete_barrier_mc(
    *,
    spot: float,
    strike: float,
    vol: float,
    option_type: OptionType,
    valuation: dt.date,
    maturity: dt.date,
    discount_curve,
    forward_curve=None,
    dividends: Sequence[Tuple[dt.date, float]] = (),
    monitor_dates: Sequence[dt.date] = (),
    barrier: BarrierSpec = BarrierSpec("none"),
    rebate: RebateSpec = RebateSpec(),
    cfg: MCConfig = MCConfig(),
    include_maturity_monitor: bool = True,
    device=DEFAULT_DEVICE,
) -> Dict[str, object]:
    """Price a discretely-monitored barrier option by MC on ``device``.

    Returns {"price", "stderr", "ci95"/"ci_95", "n_obs"/"n_observations",
    "steps", "barrier_type", "barrier_band", "antithetic", "grid_points"}
    — a superset of the reference's result dict
    (mc_discrete_barrier_option.py:407-425), with both its key spellings
    and this module's shorter aliases.
    """
    dev = resolve_device(device)
    if not isinstance(discount_curve, DailyNacaCurve):
        discount_curve = DailyNacaCurve(discount_curve, valuation)
    fwd = forward_curve
    if fwd is not None and not isinstance(fwd, DailyNacaCurve):
        fwd = DailyNacaCurve(fwd, valuation)
    fwd = fwd or discount_curve

    grid, div_map, mon_set = build_event_grid(
        valuation, maturity, dividends, monitor_dates, include_maturity_monitor
    )
    n_steps = len(grid) - 1
    drift = np.empty(n_steps)
    diff = np.empty(n_steps)
    div_amt = np.zeros(n_steps)
    is_mon = np.zeros(n_steps, bool)
    step_df = np.empty(n_steps)
    for i in range(n_steps):
        d0, d1 = grid[i], grid[i + 1]
        tau = discount_curve.year_fraction(d0, d1)
        carry = fwd.get_forward_nacc_rate(d0, d1)
        drift[i] = (carry - 0.5 * vol * vol) * tau
        diff[i] = vol * math.sqrt(max(tau, 0.0))
        div_amt[i] = div_map.get(d1, 0.0)
        is_mon[i] = d1 in mon_set
        step_df[i] = discount_curve.get_discount_factor(d1)
    df_t = discount_curve.get_discount_factor(maturity)

    bt = barrier.barrier_type
    if bt != "none":
        if barrier.level is None:
            raise ValueError("Barrier level required.")
        band = _barrier_band(barrier.level, barrier.tol_bps, barrier.abs_tol)
        level = float(barrier.level)
        kind = {"down-and-out": "down-out", "up-and-out": "up-out",
                "down-and-in": "down-in", "up-and-in": "up-in"}[bt]
    else:
        band, level, kind = 0.0, 0.0, "none"

    n_obs = cfg.n_paths // 2 if cfg.antithetic else cfg.n_paths
    mean, stderr = _simulate_kernel(
        prng_key(cfg.seed), n_obs, float(spot), float(strike), drift, diff, div_amt,
        is_mon, step_df, level, band, float(df_t), float(rebate.amount), float(cfg.spot_floor),
        option_type == "call", kind, cfg.antithetic, cfg.dividend_before_monitor,
        rebate.rebate_at_hit, device=dev,
    )
    price, se = float(mean), float(stderr)
    ci = (price - 1.96 * se, price + 1.96 * se)
    return {
        "price": price,
        "stderr": se,
        "ci95": ci,
        "ci_95": ci,  # the reference's key (mc_discrete_barrier_option.py)
        "n_obs": int(n_obs),
        "n_observations": int(n_obs),  # reference key
        "steps": int(n_steps),  # reference key (event-grid steps)
        "barrier_type": bt,
        "barrier_band": float(band),
        "antithetic": cfg.antithetic,
        "grid_points": len(grid),
    }
