"""FIS stencil-variant discrete-barrier CN pricer (S-space).

Counterpart of ``finite_difference_tpu.models.pde.fis_stencil``, with
capability parity with the reference's ``discrete_barrier_fdm_pricer_2.py``
(DiscreteBarrierFDMPricer2, :16-591):

- S-space uniform grid to 4*s_ref*e^{sigma sqrt(T)} with strike/barrier
  node snapping and local quadratic payoff smoothing around the strike;
- the FIS n_lim frequent-monitoring decision with the FIS-form BGK shift
  B*exp(+-0.5826*sigma*a_b), a_b = t_b/n_mon (note: NOT sqrt(dt) — this
  variant reproduces the reference's formula verbatim);
- continuous window => KO projection every step between first and last
  monitor; otherwise projection at monitor steps only;
- a NON-SYMMETRIC stencil on the two rows straddling the (shifted) barrier
  (h_-, h_+ one-sided first/second-derivative weights);
- Greeks: one-sided delta in the first interval next to the barrier,
  alpha=0.5 blending in the second, central elsewhere; barrier-row gamma
  blends the non-symmetric second difference with the PDE-limit
  Gamma_lim = 2 (r V - g S Delta) / (sigma^2 S^2);
- flat NACC rate, PV-escrowed discrete dividends.

The grid, the window decision, the two coefficient sets (Rannacher theta=1
and CN theta=0.5), the monitor mask, the final ``np.interp`` and the
greeks' stencils are host numpy, copied from the JAX module. The backward
march (:func:`_fis_march`) runs at float64 on the pricer's ``device`` (the
card by default). The JAX package marches a ``lax.scan`` whose steps call
the sequential Thomas algorithm; here each coefficient set's system is
factored once per solve (:func:`ops.tridiag.thomas_factor`, the log-depth
homography scan) and every step applies the two affine sweeps of its set.
The two agree to roundings on these diagonally dominant systems. On a card
the march is replayed from a CUDA graph (:func:`spectral.run_graphed`'s
rule: eager on a key's first solve, captured on its second), keyed on
N+1, the step counts, the option type and the dtype; the coefficient
sets, the monitor and knock-out masks and the boundary terms are tensor
inputs, so the knock-out solve and the vanilla solve of a knock-in share
one graph.
"""
from __future__ import annotations

import datetime as _dt
import math
from typing import Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.tridiag import const_solve, thomas_factor
from ...utils.daycount import year_fraction
from .spectral import run_graphed

OptionType = Literal["call", "put"]
BarrierType = Literal[
    "none", "down-and-out", "up-and-out", "double-out",
    "down-and-in", "up-and-in", "double-in",
]


def _fis_march(
    v0, sub_sets, main_sets, sup_sets, expl_a_sets, expl_b_sets, expl_c_sets,
    monitor_mask, out_mask, strike, r, tenor, s_max, n_steps: int,
    rannacher_steps: int, is_call: bool,
):
    """Backward CN march with per-step theta selection and KO projection;
    returns (the values at valuation,).

    *_sets are (2, N+1): index 0 = Rannacher (theta=1), index 1 = CN
    (theta=0.5). ``monitor_mask`` (n_steps,) bool: the KO projection
    (``out_mask``, (N+1,) bool) applies after the step. Step k = 0 is the
    one nearest expiry. Host-free, so a CUDA graph can replay it.
    """
    factors = [thomas_factor(sub_sets[i], main_sets[i], sup_sets[i]) for i in range(2)]
    # the Dirichlet boundary values of every step at once, in the rhs's
    # end columns (the boundary rows of the explicit sets are zero)
    dt = tenor / n_steps
    k = torch.arange(n_steps, dtype=v0.dtype, device=v0.device)
    tau_left = tenor - (n_steps - 1 - k) * dt
    disc_k = strike * torch.exp(-r * tau_left)
    bnd = torch.zeros(n_steps, v0.shape[-1], dtype=v0.dtype, device=v0.device)
    if is_call:
        bnd[:, -1] = s_max - disc_k
    else:
        bnd[:, 0] = disc_k
    kill = monitor_mask[:, None] & out_mask[None, :]

    v = v0
    for step in range(n_steps):
        i = 0 if step < rannacher_steps else 1
        rhs = torch.addcmul(bnd[step], expl_b_sets[i], v)
        rhs[1:].addcmul_(expl_a_sets[i][1:], v[:-1])
        rhs[:-1].addcmul_(expl_c_sets[i][:-1], v[1:])
        v = const_solve(factors[i], rhs).masked_fill_(kill[step], 0.0)
    return (v,)


class DiscreteBarrierFDMPricer2:
    BGK_BETA = 0.5826
    N_LIM = 5
    MIN_INTERVAL_STEPS = 1
    DEFAULT_DAYCOUNT = "ACT/365"

    def __init__(
        self,
        spot: float,
        strike: float,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        volatility: float,
        option_type: OptionType,
        barrier_type: BarrierType = "none",
        lower_barrier: Optional[float] = None,
        upper_barrier: Optional[float] = None,
        monitoring_dates: Optional[List[_dt.date]] = None,
        flat_rate_nacc: float = 0.0,
        dividends: Optional[List[Tuple[_dt.date, float]]] = None,
        num_space_nodes: int = 600,
        num_time_steps: int = 600,
        rannacher_steps: int = 2,
        day_count: str = DEFAULT_DAYCOUNT,
        smooth_payoff_around_strike: bool = True,
        payoff_smoothing_half_width_nodes: int = 2,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.spot_price = float(spot)
        self.strike_price = float(strike)
        self.valuation_date = valuation_date
        self.maturity_date = maturity_date
        self.option_type = option_type
        self.barrier_type = barrier_type
        self.barrier_lower = lower_barrier
        self.barrier_upper = upper_barrier
        self.monitoring_dates = sorted(monitoring_dates or [])
        self.volatility = float(volatility)
        self.r_flat = float(flat_rate_nacc)
        self.day_count = day_count.upper()
        self.dividends = [(d, float(a)) for d, a in (dividends or [])]
        self.num_space_nodes = int(num_space_nodes)
        self.num_time_steps = int(num_time_steps)
        self.rannacher_steps = int(rannacher_steps)
        self.smooth_payoff_around_strike = bool(smooth_payoff_around_strike)
        self.payoff_smoothing_half_width_nodes = int(payoff_smoothing_half_width_nodes)

        self.tenor_years = self._year_fraction(valuation_date, maturity_date)
        self.dt = self.tenor_years / max(1, self.num_time_steps)
        self.S_nodes = self._build_space_grid()
        self.dS = self.S_nodes[1] - self.S_nodes[0]

        (
            self.use_bgk_correction,
            self.bgk_lower,
            self.bgk_upper,
            self.k_first_cont,
            self.k_last_cont,
        ) = self._decide_and_adjust_for_continuous_window()

    # ------------------------------------------------------------------

    def _year_fraction(self, d0: _dt.date, d1: _dt.date) -> float:
        return year_fraction(d0, d1, self.day_count)

    def _pv_dividends_escrow(self) -> float:
        pv = 0.0
        for pay_date, cash in self.dividends:
            if self.valuation_date < pay_date <= self.maturity_date:
                tau = self._year_fraction(self.valuation_date, pay_date)
                pv += cash * math.exp(-self.r_flat * tau)
        return pv

    def _build_space_grid(self) -> np.ndarray:
        """Uniform S grid with strike/barrier snapping
        (discrete_barrier_fdm_pricer_2.py:146-167)."""
        anchors = [self.spot_price, self.strike_price]
        if self.barrier_lower:
            anchors.append(self.barrier_lower)
        if self.barrier_upper:
            anchors.append(self.barrier_upper)
        s_ref = max(anchors)
        s_max = 4.0 * s_ref * math.exp(
            self.volatility * math.sqrt(max(self.tenor_years, 1e-12))
        )
        N = max(200, self.num_space_nodes)
        nodes = np.linspace(0.0, s_max, N + 1)

        def snap(x):
            if x is None:
                return
            j = int(np.argmin(np.abs(nodes - x)))
            nodes[j] = float(x)

        snap(self.strike_price)
        snap(self.barrier_lower)
        snap(self.barrier_upper)
        return nodes

    def _decide_and_adjust_for_continuous_window(self):
        """FIS n_lim decision + FIS-form BGK shift (:172-229)."""
        if self.barrier_type == "none" or not self.monitoring_dates:
            return (False, self.barrier_lower, self.barrier_upper, None, None)
        sorted_mons = [
            d for d in self.monitoring_dates
            if self.valuation_date < d <= self.maturity_date
        ]
        if not sorted_mons:
            return (False, self.barrier_lower, self.barrier_upper, None, None)
        first_mon, last_mon = sorted_mons[0], sorted_mons[-1]
        if last_mon <= first_mon:
            return (False, self.barrier_lower, self.barrier_upper, None, None)

        dt_uniform = self.tenor_years / max(1, self.num_time_steps)
        intervals = [
            self._year_fraction(a, b)
            for a, b in zip(sorted_mons[:-1], sorted_mons[1:])
        ]
        N_hat = sum(
            max(self.MIN_INTERVAL_STEPS, int(round(ti / dt_uniform)))
            for ti in intervals
        )
        frequent_enough = N_hat > self.N_LIM * self.num_time_steps

        t_b = self._year_fraction(first_mon, last_mon)
        a_b = t_b / max(1, len(sorted_mons))
        adj = math.exp(self.BGK_BETA * self.volatility * a_b)
        lo_adj = self.barrier_lower / adj if self.barrier_lower is not None else None
        up_adj = self.barrier_upper * adj if self.barrier_upper is not None else None

        k0 = int(round(self._year_fraction(self.valuation_date, first_mon) / self.dt))
        k1 = int(round(self._year_fraction(self.valuation_date, last_mon) / self.dt))
        k0 = max(0, min(self.num_time_steps, k0))
        k1 = max(0, min(self.num_time_steps, k1))
        return (frequent_enough, lo_adj, up_adj, min(k0, k1), max(k0, k1))

    # ------------------------------------------------------------------

    def _terminal_payoff_array(self) -> np.ndarray:
        """Payoff with local quadratic smoothing around the strike (:231-252)."""
        s = self.S_nodes
        if self.option_type == "call":
            V = np.maximum(s - self.strike_price, 0.0)
        else:
            V = np.maximum(self.strike_price - s, 0.0)
        m = self.payoff_smoothing_half_width_nodes
        if not self.smooth_payoff_around_strike or m <= 0:
            return V
        k_star = int(np.argmin(np.abs(s - self.strike_price)))
        i0, i1 = max(0, k_star - m), min(len(s) - 1, k_star + m)
        S0, V0 = s[i0], V[i0]
        S1, V1 = s[i1], V[i1]
        a = (V1 - V0) / ((S1 - S0) ** 2) if S1 != S0 else 0.0
        V[i0 : i1 + 1] = a * (s[i0 : i1 + 1] - S0) ** 2 + V0
        return V

    def _effective_barriers_for_pricing(self):
        if self.use_bgk_correction:
            return self.bgk_lower, self.bgk_upper
        return self.barrier_lower, self.barrier_upper

    def _locate_barrier_interval(self, lo_bar, up_bar):
        """(side, j, h_minus, h_plus) of the active KO barrier (:307-331)."""
        s = self.S_nodes
        N = len(s) - 1
        ko = self.barrier_type.replace("in", "out")

        def locate(H, side):
            if H <= s[0]:
                return (side, 0, 1e-12, s[1] - s[0])
            if H >= s[-1]:
                return (side, N - 1, s[N - 1] - s[N - 2], 1e-12)
            j = int(np.searchsorted(s, H, side="right") - 1)
            j = max(0, min(N - 1, j))
            return (side, j, max(1e-12, H - s[j]), max(1e-12, s[j + 1] - H))

        if ko in ("down-and-out", "double-out") and lo_bar is not None:
            return locate(lo_bar, "down")
        if ko in ("up-and-out", "double-out") and up_bar is not None:
            return locate(up_bar, "up")
        return (None, None, None, None)

    def _coefficient_sets(self, lo_bar, up_bar, sigma: float):
        """(2, N+1) implicit/explicit diagonal sets for theta in {1, 0.5},
        with the non-symmetric rows at the barrier (:336-420); numpy."""
        s = self.S_nodes
        N = len(s) - 1
        dt, dS, r = self.dt, self.dS, self.r_flat
        side, j_bar, hm, hp = self._locate_barrier_interval(lo_bar, up_bar)

        sig2S2 = (sigma * s) ** 2
        L_left = 0.5 * sig2S2 / dS**2 - 0.5 * r * s / dS
        L_center = -(sig2S2 / dS**2 + r)
        L_right = 0.5 * sig2S2 / dS**2 + 0.5 * r * s / dS

        if side is not None:
            for i in (j_bar, j_bar + 1):
                if i < 1 or i > N - 1:
                    continue
                a1 = hp / (hm * (hm + hp))
                b1 = (hp - hm) / (hm * hp)
                c1 = -hm / (hp * (hm + hp))
                d2 = 2.0 / (hm * (hm + hp))
                e2 = -2.0 / (hm * hp)
                f2 = 2.0 / (hp * (hm + hp))
                L_left[i] = 0.5 * sig2S2[i] * f2 + r * s[i] * c1
                L_center[i] = 0.5 * sig2S2[i] * e2 + r * s[i] * b1 - r
                L_right[i] = 0.5 * sig2S2[i] * d2 + r * s[i] * a1

        subs, mains, sups = [], [], []
        eas, ebs, ecs = [], [], []
        for theta in (1.0, 0.5):
            sub = -theta * dt * L_left
            main = 1.0 - theta * dt * L_center
            sup = -theta * dt * L_right
            ea = (1 - theta) * dt * L_left
            eb = 1.0 + (1 - theta) * dt * L_center
            ec = (1 - theta) * dt * L_right
            # Dirichlet boundary rows
            for arr, v0, vN in ((sub, 0.0, 0.0), (main, 1.0, 1.0), (sup, 0.0, 0.0),
                                (ea, 0.0, 0.0), (eb, 0.0, 0.0), (ec, 0.0, 0.0)):
                arr[0], arr[N] = v0, vN
            subs.append(sub)
            mains.append(main)
            sups.append(sup)
            eas.append(ea)
            ebs.append(eb)
            ecs.append(ec)
        return tuple(np.stack(x) for x in (subs, mains, sups, eas, ebs, ecs))

    def _monitor_mask(self) -> np.ndarray:
        """(n_steps,) projection flags in march order (k=0 nearest expiry)."""
        M = self.num_time_steps
        mask = np.zeros(M, dtype=bool)
        if self.barrier_type == "none":
            return mask
        if self.use_bgk_correction:
            for step_after in range(self.k_first_cont, self.k_last_cont + 1):
                k = M - 1 - step_after  # step_index_after = m-1; k = M - m
                if 0 <= k < M:
                    mask[k] = True
            return mask
        for d in self.monitoring_dates:
            if not (self.valuation_date < d <= self.maturity_date):
                continue
            step_after = int(round(self._year_fraction(self.valuation_date, d) / self.dt))
            step_after = max(0, min(M - 1, step_after))
            k = M - 1 - step_after
            if 0 <= k < M:
                mask[k] = True
        return mask

    def _solve_grid_once(self, sigma: Optional[float] = None):
        sigma = sigma if sigma is not None else self.volatility
        lo_eff, up_eff = self._effective_barriers_for_pricing()
        coeffs = self._coefficient_sets(lo_eff, up_eff, sigma)

        ko = self.barrier_type.replace("in", "out")
        out_mask = np.zeros(len(self.S_nodes), dtype=bool)
        if ko in ("down-and-out", "double-out") and lo_eff is not None:
            out_mask |= self.S_nodes <= lo_eff
        if ko in ("up-and-out", "double-out") and up_eff is not None:
            out_mask |= self.S_nodes >= up_eff

        t = lambda a: torch.as_tensor(a).to(self.device)
        tensors = (
            t(self._terminal_payoff_array()), *(t(c) for c in coeffs),
            t(self._monitor_mask()), t(out_mask),
            *(t(np.float64(x)) for x in (self.strike_price, self.r_flat, self.tenor_years,
                                         self.S_nodes[-1])),
        )
        is_call = self.option_type == "call"
        march = lambda *a: _fis_march(*a, n_steps=self.num_time_steps,
                                      rannacher_steps=self.rannacher_steps, is_call=is_call)
        if self.device.type == "cuda":
            key = ("fis_stencil", len(self.S_nodes), self.num_time_steps, self.rannacher_steps,
                   is_call, torch.float64)
            (v,) = run_graphed(key, march, tensors)
        else:
            (v,) = march(*tensors)
        S_eff = self.spot_price - self._pv_dividends_escrow()
        return self.S_nodes, v.cpu().numpy(), S_eff

    # ------------------------------------------------------------------

    def price(self) -> float:
        Sg, Vg, S_eff = self._solve_grid_once()
        ko_price = float(np.interp(S_eff, Sg, Vg))
        if "in" in self.barrier_type:
            saved = self.barrier_type
            self.barrier_type = "none"  # type: ignore[assignment]
            Sg2, Vg2, _ = self._solve_grid_once()
            self.barrier_type = saved  # type: ignore[assignment]
            return float(np.interp(S_eff, Sg2, Vg2)) - ko_price
        return ko_price

    def _delta_gamma_from_grid(self, s_nodes, V, S_eff, lo_bar, up_bar):
        """Blended one-sided greeks with Gamma_lim on the barrier rows
        (:488-550)."""
        N = len(s_nodes) - 1
        dS = s_nodes[1] - s_nodes[0]
        iS = int(np.argmin(np.abs(S_eff - np.asarray(s_nodes[:N]))))
        iS = max(1, min(N - 1, iS))

        delta_c = (V[iS + 1] - V[iS - 1]) / (2.0 * dS)
        gamma_c = (V[iS + 1] - 2.0 * V[iS] + V[iS - 1]) / dS**2

        side, j_bar, hm, hp = self._locate_barrier_interval(lo_bar, up_bar)
        if side is None or j_bar is None:
            return float(delta_c), float(gamma_c)

        in_first = iS in (j_bar, j_bar + 1)
        in_second = iS in (j_bar - 1, j_bar + 2)

        # Second-order one-sided stencils: backward (i, i-1, i-2) away
        # from a lower barrier, forward (i, i+1, i+2) away from an upper.
        # The reference mistypes the third node (V[i+1]/V[i-1] instead of
        # V[i-2]/V[i+2], discrete_barrier_fdm_pricer_2.py:511-543), which
        # Taylor-expands to 2.5*V' - 0.75*dS*V'' — ~2.5x the true delta;
        # corrected here, as in the JAX package (the gamma_lim blend
        # consumes delta_os too).
        if in_first:
            if side == "down":
                i = j_bar + 1
                delta_os = (
                    1.5 * V[i] - 2.0 * V[i - 1] + 0.5 * V[max(0, i - 2)]
                ) / dS
            else:
                i = j_bar
                delta_os = (
                    -1.5 * V[i] + 2.0 * V[i + 1] - 0.5 * V[min(N, i + 2)]
                ) / dS
            S_bar = s_nodes[i]
            gamma_ns = (V[i + 1] - 2.0 * V[i] + V[i - 1]) / dS**2
            g = 0.0  # carry in Gamma_lim; escrowed-dividend convention
            denom = max(1e-14, (self.volatility**2) * S_bar**2)
            gamma_lim = 2.0 * (self.r_flat * V[i] - g * S_bar * delta_os) / denom
            q = 0.5
            return float(delta_os), float(q * gamma_ns + (1 - q) * gamma_lim)

        if in_second:
            if side == "down":
                delta_os = (
                    1.5 * V[iS] - 2.0 * V[iS - 1] + 0.5 * V[max(0, iS - 2)]
                ) / dS
            else:
                delta_os = (
                    -1.5 * V[iS] + 2.0 * V[iS + 1] - 0.5 * V[min(N, iS + 2)]
                ) / dS
            gamma_os = (V[iS + 1] - 2.0 * V[iS] + V[iS - 1]) / dS**2
            alpha = 0.5
            return (
                float(alpha * delta_os + (1 - alpha) * delta_c),
                float(alpha * gamma_os + (1 - alpha) * gamma_c),
            )
        return float(delta_c), float(gamma_c)

    def _rebuild_bgk_window(self) -> None:
        """Recompute the vol-dependent BGK-shifted barriers; the shift
        exp(0.5826*sigma*sqrt(dt)) must move with a bumped volatility or
        the vega misses the barrier-shift term where barrier vega is
        largest (spot near the barrier)."""
        (
            self.use_bgk_correction,
            self.bgk_lower,
            self.bgk_upper,
            self.k_first_cont,
            self.k_last_cont,
        ) = self._decide_and_adjust_for_continuous_window()

    def greeks(self, vega_bump: float = 0.01) -> Dict[str, float]:
        lo_eff, up_eff = self._effective_barriers_for_pricing()
        Sg, Vg, S_eff = self._solve_grid_once()
        delta, gamma = self._delta_gamma_from_grid(Sg, Vg, S_eff, lo_eff, up_eff)
        sig0 = self.volatility
        try:
            self.volatility = sig0 + vega_bump
            self._rebuild_bgk_window()
            upv = self.price()
            self.volatility = sig0 - vega_bump
            self._rebuild_bgk_window()
            dnv = self.price()
        finally:
            self.volatility = sig0
            self._rebuild_bgk_window()
        vega = (upv - dnv) / (2.0 * vega_bump)
        return {"delta": float(delta), "gamma": float(gamma), "vega": float(vega)}

    def print_details(self) -> None:
        print(
            f"FIS stencil pricer: {self.option_type} {self.barrier_type} "
            f"S={self.spot_price} K={self.strike_price} T={self.tenor_years:.4f} "
            f"r={self.r_flat} continuous={self.use_bgk_correction} "
            f"BGK=({self.bgk_lower}, {self.bgk_upper})"
        )
        print(f"price: {self.price():.8f}")
