"""Host-side grid and time-schedule construction for the CN pricers.

Plain numpy on the host, carried over unchanged from the JAX package's
``models/pde/grid.py`` (the port imports nothing of that package): ragged,
date-driven structure (dividend segments, monitor schedules, Rannacher
restarts) is canonicalised into the fixed-shape arrays the batched stepper
consumes.

Grid policies reproduced from the reference:
- ``american_log_grid``: geometric-center band s_max_mult * sigma * sqrt(T)
  around sqrt(s_low*s_high) with widening clamps
  (fd_american_equity.py:340-411).
- ``barrier_log_grid``: Phi^{-1}(0.99999) domain width and the
  N_space = ceil(domain_width*N_time / (2 sigma sqrt(T))) node-count rule
  (discrete_barrier_fdm_pricer.py:270-340).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Phi^{-1}(0.99999) — the reference computes this via scipy.stats.norm.ppf
_PPF_99999 = 4.264890793922602


@dataclass(frozen=True)
class LogGrid:
    """A uniform log-S grid on the host."""

    x_min: float
    dx: float
    n_nodes: int  # total nodes (num_space_nodes + 1)

    @property
    def x_max(self) -> float:
        return self.x_min + (self.n_nodes - 1) * self.dx

    @property
    def s_nodes(self) -> np.ndarray:
        return np.exp(self.x_min + self.dx * np.arange(self.n_nodes))

    def nearest_index(self, s_level: float) -> int:
        return int(np.argmin(np.abs(self.s_nodes - s_level)))

    def snapped(self, s_level: float) -> float:
        return float(self.s_nodes[self.nearest_index(s_level)])


def american_log_grid(
    spot: float,
    strike: float,
    sigma: float,
    t_expiry: float,
    num_space_nodes: int,
    s_max_mult: float = 4.5,
) -> LogGrid:
    """Band of width s_max_mult*sigma*sqrt(T) around the geometric center of
    (spot, strike), widened to cover [0.5*s_low, 2*s_high]."""
    s_low, s_high = min(spot, strike), max(spot, strike)
    s_c = math.sqrt(max(s_low * s_high, 1e-12))
    band = s_max_mult * sigma * math.sqrt(max(t_expiry, 1e-12))
    x_c = math.log(s_c)
    s_min = math.exp(x_c - 0.5 * band)
    s_max = math.exp(x_c + 0.5 * band)
    s_min = max(min(s_min, 0.5 * s_low), 1e-8)
    s_max = max(s_max, 2.0 * s_high)
    x_min, x_max = math.log(s_min), math.log(s_max)
    n = int(num_space_nodes)
    dx = (x_max - x_min) / float(n)
    return LogGrid(x_min=x_min, dx=dx, n_nodes=n + 1)


def barrier_log_grid(
    spot_eff: float,
    strike: float,
    sigma: float,
    t_expiry: float,
    num_time_steps: int,
    lower_barrier: Optional[float] = None,
    upper_barrier: Optional[float] = None,
    num_space_nodes: Optional[int] = None,
) -> LogGrid:
    """The production barrier grid policy (choose_grid_parameters).

    Domain width 2*Phi^{-1}(0.99999)*sigma*sqrt(T) centered on the geometric
    mean of {S0_eff, K, barriers}, clamped to cover [0.5 s_low, 2 s_high].
    Node count defaults to the reference's rule
    ceil(domain_width * N_time / (2 sigma sqrt(T))) ≈ 4.265 * N_time; pass
    ``num_space_nodes`` to pin a static bucket size for batching.
    """
    candidates = [spot_eff, strike]
    for h in (lower_barrier, upper_barrier):
        if h is not None and h > 0.0:
            candidates.append(h)
    s_low, s_high = min(candidates), max(candidates)

    sqrt_t = math.sqrt(max(t_expiry, 1e-12))
    domain_width = 2.0 * _PPF_99999 * sigma * sqrt_t
    x_c = math.log(math.sqrt(s_low * s_high))
    s_min = math.exp(x_c - 0.5 * domain_width)
    s_max = math.exp(x_c + 0.5 * domain_width)
    s_min = max(min(s_min, 0.5 * s_low), 1e-12)
    s_max = max(s_max, 2.0 * s_high)

    if num_space_nodes is None:
        num_space_nodes = math.ceil(domain_width * num_time_steps / (2.0 * sigma * sqrt_t))
    x_min, x_max = math.log(s_min), math.log(s_max)
    n = int(num_space_nodes)
    dx = (x_max - x_min) / float(n)
    return LogGrid(x_min=x_min, dx=dx, n_nodes=n + 1)


# --------------------------------------------------------------------------- #
# Time-step schedules                                                          #
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ScheduleArrays:
    """Numpy mirror of the device CNSchedule (see stepper.CNSchedule)."""

    dt: np.ndarray
    theta: np.ndarray
    tau_next: np.ndarray
    monitor: np.ndarray
    div_amount: np.ndarray
    reset_lambda: np.ndarray

    @property
    def n_steps(self) -> int:
        return len(self.dt)


def uniform_schedule(
    t_expiry: float,
    n_steps: int,
    rannacher_steps: int = 2,
    monitor_times: Sequence[float] = (),
) -> ScheduleArrays:
    """The barrier pricer's layout (discrete_barrier_fdm_pricer.py:442-547):
    constant dt = T/n, Rannacher at the start of the march (near expiry),
    KO projection on the steps whose tau index matches a monitor time via
    k = floor((T - t_mon)/dt + 1e-9), clamped to [1, n]."""
    n = int(n_steps)
    dt = np.full(n, t_expiry / n)
    theta = np.where(np.arange(n) < rannacher_steps, 1.0, 0.5)
    tau_next = dt.cumsum()
    monitor = np.zeros(n, dtype=bool)
    for t_mon in monitor_times:
        if t_mon <= 0.0 or t_mon > t_expiry:
            continue
        tau_mon = t_expiry - t_mon
        k = int(math.floor(tau_mon / (t_expiry / n) + 1e-9))
        k = max(1, min(n, k))
        monitor[k - 1] = True  # applied after step index k-1 (tau index k)
    zeros = np.zeros(n)
    return ScheduleArrays(
        dt=dt,
        theta=theta,
        tau_next=tau_next,
        monitor=monitor,
        div_amount=zeros,
        reset_lambda=np.zeros(n, dtype=bool),
    )


def monitor_aligned_schedule(
    t_expiry: float,
    monitor_times: Sequence[float],
    steps_per_interval: int = 10,
    target_dt: "Optional[float]" = None,
    rannacher_steps: int = 2,
) -> ScheduleArrays:
    """Monitor-aligned layout (the reference CN auto-grid's ">= 10 steps
    per monitor interval" semantics, discrete_barrier_fdm_pricer_cn.py:
    92-118): interval boundaries at every monitor date and at expiry,
    each interval with its OWN constant dt so monitors land exactly on
    step boundaries (no floor-snap aliasing like :func:`uniform_schedule`).
    ``steps_per_interval`` is the per-interval minimum; ``target_dt``
    additionally bounds dt from above. dt is piecewise-constant on the
    monitor intervals, which the spectral propagator accepts
    (models.pde.spectral, per-interval-dt branch).
    """
    T = float(t_expiry)
    tol = 1e-12 * max(T, 1.0)
    if T <= tol:
        raise ValueError(
            f"t_expiry={t_expiry} too small for a monitor-aligned "
            "schedule (below the boundary-merge tolerance)"
        )
    taus = sorted({T - float(t) for t in monitor_times if 0.0 < t <= T})
    at_expiry = bool(taus) and taus[0] <= tol
    bounds = [0.0]
    for t in taus:
        if t > bounds[-1] + tol:
            bounds.append(t)
    final_is_monitor = False
    if T > bounds[-1] + tol:
        bounds.append(T)
    else:
        # a monitor tau within tolerance of T merges into the expiry
        # boundary — keep its projection (uniform_schedule flags the
        # final step for the same input)
        final_is_monitor = len(bounds) > 1
        bounds[-1] = T

    dt_l: List[float] = []
    mon_l: List[bool] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        seg = hi - lo
        n_seg = max(int(steps_per_interval), 1)
        if target_dt is not None:
            n_seg = max(n_seg, int(math.ceil(seg / float(target_dt) - 1e-9)))
        dt_l.extend([seg / n_seg] * n_seg)
        mon_l.extend([False] * (n_seg - 1))
        # every interior boundary IS a monitor tau by construction; the
        # final boundary (tau = T) only when a monitor merged into it
        mon_l.append(hi < T - tol)
    if final_is_monitor:
        mon_l[-1] = True
    if at_expiry:
        # monitor AT expiry: mirror uniform_schedule's k >= 1 clamp
        # (projection after the first step)
        mon_l[0] = True
    n = len(dt_l)
    dt = np.asarray(dt_l)
    return ScheduleArrays(
        dt=dt,
        theta=np.where(np.arange(n) < rannacher_steps, 1.0, 0.5),
        tau_next=dt.cumsum(),
        monitor=np.asarray(mon_l, dtype=bool),
        div_amount=np.zeros(n),
        reset_lambda=np.zeros(n, dtype=bool),
    )


def segmented_schedule(
    t_expiry: float,
    base_steps: int,
    dividends_tau: Sequence[Tuple[float, float]],
    rannacher_steps: int = 2,
    restart_rannacher_at_div: bool = False,
) -> ScheduleArrays:
    """The American pricer's layout (fd_american_equity.py:790-843):

    Segment boundaries at dividend taus (ascending, measured from expiry).
    Integer steps per segment = round(seg_len/base_dt) (>=1), remainder to
    the last segment; each segment uses its own dt. Rannacher (theta = 1)
    restarts at expiry and — for calls — after each dividend. The dividend
    jump fires on the last step of each non-final segment, and the IT
    multiplier resets at each segment start.
    """
    # same open-interval filter as AmericanFDMPricer._div_times_tau: a
    # tau=0 dividend would make seg_len=0 -> dt=0 (NaN in the IT update
    # lam += (payoff - tilde)/dt), and tau>=T a negative final segment
    divs = sorted(
        [
            (float(t), float(a))
            for t, a in dividends_tau
            if 0.0 < float(t) < float(t_expiry)
        ],
        key=lambda p: p[0],
    )
    tau_pts = [0.0] + [t for t, _ in divs] + [float(t_expiry)]
    n_segments = len(tau_pts) - 1
    seg_lengths = [tau_pts[i + 1] - tau_pts[i] for i in range(n_segments)]
    base_dt = t_expiry / float(base_steps)

    seg_steps: List[int] = []
    remaining = int(base_steps)
    for seg_len in seg_lengths[:-1]:
        n_seg = max(1, int(round(seg_len / base_dt)))
        seg_steps.append(n_seg)
        remaining -= n_seg
    seg_steps.append(max(1, remaining))

    dt_l, theta_l, tau_l, div_l, reset_l = [], [], [], [], []
    tau = 0.0
    for seg_idx in range(n_segments):
        n_seg = seg_steps[seg_idx]
        seg_dt = seg_lengths[seg_idx] / float(n_seg)
        restart = seg_idx == 0 or restart_rannacher_at_div
        for k in range(n_seg):
            dt_l.append(seg_dt)
            theta_l.append(1.0 if (restart and k < rannacher_steps) else 0.5)
            tau += seg_dt
            tau_l.append(tau)
            is_last = k == n_seg - 1
            div_l.append(divs[seg_idx][1] if (is_last and seg_idx < len(divs)) else 0.0)
            reset_l.append(k == 0)
    n = len(dt_l)
    return ScheduleArrays(
        dt=np.asarray(dt_l),
        theta=np.asarray(theta_l),
        tau_next=np.asarray(tau_l),
        monitor=np.zeros(n, dtype=bool),
        div_amount=np.asarray(div_l),
        reset_lambda=np.asarray(reset_l, dtype=bool),
    )
