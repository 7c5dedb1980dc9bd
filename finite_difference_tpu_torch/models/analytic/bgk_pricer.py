"""Date-driven discrete-barrier pricer: BGK/Hörfelt analytic with MC routing.

Counterpart of ``finite_difference_tpu.models.analytic.bgk_pricer``, with
capability parity with the reference's ``DiscreteBarrierBGKPricer`` class
(discrete_barrier_bgk.py:99-1136): three FIS time measures, escrowed
dividends (flat q, S_eff = S e^{-q T_carry}), the method router (auto: BGK
when monitor frequency >= bgk_min_freq/yr else MC,
discrete_barrier_bgk.py:674-692), smoothed RiskFlow-style MC (smooth_relu
eps=0.005, smooth_heaviside eps=0.01, torch-RNG path ordering with
antithetic [Z; -Z]), rebate legs (hazard PV at hit / discounted at expiry),
already_hit short-circuits, and the report()/hazard-table diagnostics.

Dates, curves and the router are host code. The BGK legs
(:mod:`.bgk_horfelt`, :func:`.black_scholes.black76_price`) and the Monte
Carlo paths, breach flags and payoffs run at float64 on the pricer's
``device`` (the card by default). The MC normals are drawn on the host,
as the JAX package draws them: ``torch.randn`` from a CPU generator seeded
with ``mc_seed`` (RiskFlow's sequence, seed for seed), or numpy's
``default_rng(mc_seed)``; they then move to the device. So the MC route
reproduces the JAX package's paths exactly and its price to roundings; a
CUDA generator would give another stream.
"""
from __future__ import annotations

import datetime as _dt
import math
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.calendars import SouthAfricaCalendar
from ...utils.curves import DailyNacaCurve
from ...utils.daycount import year_fraction
from .bgk_horfelt import (
    BETA_BGK,
    double_barrier_out_price,
    hazard_rebate_pv,
    single_barrier_out_price,
)
from .black_scholes import black76_price

OptionType = Literal["call", "put"]
BarrierKind = Literal[
    "none", "up-and-out", "down-and-out", "double-out",
    "up-and-in", "down-and-in", "double-in",
]


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, dtype=np.float64))


def smooth_relu(x, eps: float = 0.005):
    """RiskFlow's differentiable max(x, 0) (discrete_barrier_bgk.py:17-38)."""
    x = _tensor(x)
    quad = (0.5 * x**2 + eps * x + 0.5 * eps**2) / (2 * eps)
    return torch.where(x < -eps, torch.zeros_like(x), torch.where(x > eps, x, quad))


def smooth_heaviside_up(x, k, eps: float = 0.01):
    x = _tensor(x)
    ramp = 0.5 + (x - k) / (2 * eps)
    return torch.where(x < k - eps, torch.zeros_like(x),
                       torch.where(x > k + eps, torch.ones_like(x), ramp))


def smooth_heaviside_down(x, k, eps: float = 0.01):
    x = _tensor(x)
    ramp = 0.5 + (k - x) / (2 * eps)
    return torch.where(x < k - eps, torch.ones_like(x),
                       torch.where(x > k + eps, torch.zeros_like(x), ramp))


class DiscreteBarrierBGKPricer:
    def __init__(
        self,
        *,
        spot: float,
        strike: float,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        option_type: OptionType,
        barrier_type: BarrierKind = "none",
        lower_barrier: Optional[float] = None,
        upper_barrier: Optional[float] = None,
        monitor_dates: Optional[List[_dt.date]] = None,
        rebate_amount: float = 0.0,
        rebate_at_hit: bool = False,
        already_hit: bool = False,
        barrier_hit_date: Optional[_dt.date] = None,
        discount_curve: Any = None,
        forward_curve: Any = None,
        dividend_schedule: Optional[List[Tuple[_dt.date, float]]] = None,
        volatility: float = 0.2,
        day_count: str = "ACT/365",
        include_expiry_monitor: bool = True,
        use_mean_sqrt_dt: bool = False,
        theta_from_forward: bool = False,
        pricing_method: Literal["bgk", "mc", "auto"] = "auto",
        bgk_min_freq: float = 20.0,
        mc_n_paths: int = 4096,
        mc_seed: Optional[int] = 42,
        mc_use_antithetic: bool = True,
        mc_use_torch_rng: bool = True,
        mc_smooth_barrier_eps: float = 0.01,
        mc_smooth_payoff_eps: float = 0.005,
        underlying_spot_days: int = 0,
        option_days: int = 0,
        option_settlement_days: int = 0,
        trade_id: str = "T-0001",
        direction: Literal["long", "short"] = "long",
        quantity: int = 1,
        contract_multiplier: float = 1.0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if spot <= 0 or strike <= 0 or volatility <= 0:
            raise ValueError("spot, strike, volatility must be positive.")
        if maturity_date <= valuation_date:
            raise ValueError("maturity_date must be after valuation_date.")
        self.device = resolve_device(device)

        self.spot_price = float(spot)
        self.strike_price = float(strike)
        self.valuation_date = valuation_date
        self.maturity_date = maturity_date
        self.option_type = option_type
        self.barrier_type = barrier_type
        self.lower_barrier = lower_barrier
        self.upper_barrier = upper_barrier
        self.monitor_dates = sorted(monitor_dates or [])
        self.rebate_amount = float(rebate_amount)
        self.rebate_at_hit = bool(rebate_at_hit)
        self.already_hit = bool(already_hit)
        self.barrier_hit_date = barrier_hit_date
        self.sigma = float(volatility)
        self.day_count = day_count.upper()
        self.include_expiry_monitor = include_expiry_monitor
        self.use_mean_sqrt_dt = use_mean_sqrt_dt
        self.theta_from_forward = theta_from_forward
        self.pricing_method = pricing_method
        self.bgk_min_freq = float(bgk_min_freq)
        self.mc_n_paths = int(mc_n_paths)
        self.mc_seed = mc_seed
        self.mc_use_antithetic = bool(mc_use_antithetic)
        self.mc_use_torch_rng = bool(mc_use_torch_rng)
        self.mc_smooth_barrier_eps = float(mc_smooth_barrier_eps)
        self.mc_smooth_payoff_eps = float(mc_smooth_payoff_eps)
        self._last_mc_std_error = 0.0
        self.trade_id = trade_id
        self.direction = direction
        self.quantity = int(quantity)
        self.contract_multiplier = float(contract_multiplier)

        def _curve(c):
            if c is None:
                return None
            if isinstance(c, DailyNacaCurve):
                return c
            return DailyNacaCurve(c, valuation_date, day_count=self.day_count)

        self.discount_curve = _curve(discount_curve)
        self.forward_curve = _curve(forward_curve) or self.discount_curve
        self.dividend_schedule = sorted(dividend_schedule or [], key=lambda x: x[0])

        if underlying_spot_days or option_days or option_settlement_days:
            cal = SouthAfricaCalendar()
            self.carry_start_date = cal.add_working_days(valuation_date, underlying_spot_days)
            self.carry_end_date = cal.add_working_days(maturity_date, underlying_spot_days)
            self.discount_start_date = cal.add_working_days(valuation_date, option_days)
            self.discount_end_date = cal.add_working_days(maturity_date, option_settlement_days)
        else:
            self.carry_start_date = self.discount_start_date = valuation_date
            self.carry_end_date = self.discount_end_date = maturity_date

        yf = lambda a, b: year_fraction(a, b, self.day_count)
        self.time_to_expiry = yf(valuation_date, maturity_date)
        self.time_to_carry = yf(self.carry_start_date, self.carry_end_date)
        self.time_to_discount = yf(self.discount_start_date, self.discount_end_date)
        self.tenor_years = self.time_to_expiry
        self.discount_years = self.time_to_discount

        self.discount_rate_nacc = (
            self.discount_curve.get_forward_nacc_rate(self.discount_start_date, self.discount_end_date)
            if self.discount_curve is not None else 0.0
        )
        self.discount_rate = self.discount_rate_nacc
        self.carry_rate_nacc = (
            self.forward_curve.get_forward_nacc_rate(self.carry_start_date, self.carry_end_date)
            if self.forward_curve is not None else self.discount_rate_nacc
        )
        self.div_yield_nacc = self._dividend_yield_nacc()
        self.spot_price_eff = self.spot_price * math.exp(-self.div_yield_nacc * self.time_to_carry)
        self.forward_price = self.spot_price_eff * math.exp(self.carry_rate_nacc * self.time_to_carry)

        self._dt_years = self._compute_dt_years()
        self.m = len(self._dt_years)

    # ------------------------------------------------------------------ #
    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def _dividend_yield_nacc(self) -> float:
        if not self.dividend_schedule or self.discount_curve is None:
            return 0.0
        pv = 0.0
        df0 = self.discount_curve.get_discount_factor(self.carry_start_date)
        for d, a in self.dividend_schedule:
            if self.valuation_date < d <= self.maturity_date:
                pv += a * self.discount_curve.get_discount_factor(d) / df0
        if pv <= 0.0:
            return 0.0
        if pv >= self.spot_price:
            raise ValueError("PV(dividends) >= spot.")
        return -math.log((self.spot_price - pv) / self.spot_price) / max(1e-12, self.time_to_carry)

    def _monitor_dates_effective(self) -> List[_dt.date]:
        if self.include_expiry_monitor:
            return [d for d in self.monitor_dates if self.valuation_date < d <= self.maturity_date]
        return [d for d in self.monitor_dates if self.valuation_date < d < self.maturity_date]

    def _compute_dt_years(self) -> List[float]:
        mons = self._monitor_dates_effective()
        out, prev = [], self.valuation_date
        for d in mons:
            out.append(year_fraction(prev, d, self.day_count))
            prev = d
        return out

    def _mu(self) -> float:
        if self.theta_from_forward:
            return math.log(self.forward_price / self.spot_price_eff) / max(1e-12, self.time_to_carry)
        return self.carry_rate_nacc - self.div_yield_nacc

    def _shift_mag(self, m: Optional[int] = None, t: Optional[float] = None) -> float:
        m = self.m if m is None else m
        t = self.tenor_years if t is None else t
        if m <= 0:
            return 0.0
        if self.use_mean_sqrt_dt and self._dt_years:
            partial = self._dt_years[:m]
            mean_sqrt = sum(math.sqrt(x) for x in partial) / len(partial)
            return BETA_BGK * mean_sqrt / math.sqrt(max(t, 1e-12))
        return BETA_BGK / math.sqrt(m)

    def _vanilla_b76(self) -> float:
        df = math.exp(-self.discount_rate * self.discount_years)
        return float(
            black76_price(
                self._on_device(self.forward_price), self.strike_price, self.sigma,
                self.tenor_years, df, self.option_type == "call",
            )
        )

    def _select_method(self) -> str:
        if self.pricing_method in ("bgk", "mc"):
            return self.pricing_method
        if self.m <= 0:
            return "bgk"
        freq = self.m / max(self.tenor_years, 1e-12)
        return "bgk" if freq >= self.bgk_min_freq else "mc"

    # ------------------------------------------------------------------ #
    # BGK analytic legs                                                   #
    # ------------------------------------------------------------------ #
    def _out_price_bgk(self, btype: str) -> float:
        if self.m <= 0:
            return self._vanilla_b76()
        df = math.exp(-self.discount_rate * self.discount_years)
        mu = self._mu()
        s_eff = self._on_device(self.spot_price_eff)
        if btype in ("up-and-out", "down-and-out"):
            is_up = "up" in btype
            barrier = self.upper_barrier if is_up else self.lower_barrier
            if barrier is None:
                return 0.0
            return float(
                single_barrier_out_price(
                    s_eff, self.strike_price, barrier,
                    self.forward_price, mu, self.sigma, self.tenor_years, df,
                    float(self.m), self.option_type == "call", is_up,
                    spot=self.spot_price, shift_mag=self._shift_mag(),
                )
            )
        if btype == "double-out":
            if self.lower_barrier is None or self.upper_barrier is None:
                raise ValueError("Double barrier requires both barriers.")
            return float(
                double_barrier_out_price(
                    s_eff, self.strike_price,
                    self.lower_barrier, self.upper_barrier,
                    self.forward_price, mu, self.sigma, self.tenor_years, df,
                    float(self.m), self.option_type == "call",
                    shift_mag=self._shift_mag(),
                )
            )
        raise ValueError(btype)

    def barrier_hit_metrics(self) -> Dict[str, Any]:
        """Per-monitor hazard curve + rebate-at-hit PV (:1033-1105)."""
        empty = {
            "P_hit": 0.0, "survival_to_T": 1.0, "hazard": [],
            "expected_hit_date": None, "mode_hit_date": None, "rebate_pv_at_hit": 0.0,
        }
        if self.barrier_type not in {"up-and-out", "down-and-out", "up-and-in", "down-and-in"}:
            return empty
        mons = self._monitor_dates_effective()
        if not mons or not self._dt_years:
            return empty

        is_up = "up" in self.barrier_type
        barrier = self.upper_barrier if is_up else self.lower_barrier
        if barrier is None:
            return empty
        cum_t = np.cumsum(self._dt_years)
        dfs = np.array([self.discount_curve.get_discount_factor(d) if self.discount_curve else 1.0 for d in mons])

        pv, p_hit, surv, p_k = hazard_rebate_pv(
            self._on_device(self.spot_price_eff), barrier, self._mu(), self.sigma,
            self._on_device(cum_t), self._on_device(dfs), self.rebate_amount, is_up,
        )
        p_k = p_k.cpu().numpy()
        hazards = [
            (d, float(p), float(df_), float(self.rebate_amount * df_ * p))
            for d, p, df_ in zip(mons, p_k, dfs)
        ]
        expected_date = mode_date = None
        total = float(p_hit)
        if total > 0:
            w = p_k / total
            ords = np.array([d.toordinal() for d in mons], dtype=float)
            expected_date = _dt.date.fromordinal(int(round(float(np.sum(w * ords)))))
            mode_date = mons[int(np.argmax(p_k))]
        return {
            "P_hit": total,
            "survival_to_T": float(surv),
            "hazard": hazards,
            "expected_hit_date": expected_date,
            "mode_hit_date": mode_date,
            "rebate_pv_at_hit": float(pv),
        }

    def _rebate_leg(self) -> float:
        if self.rebate_amount <= 0.0:
            return 0.0
        if self.barrier_type not in {"up-and-out", "down-and-out", "double-out"}:
            return 0.0
        if self.rebate_at_hit:
            if self.already_hit:
                hit = self.barrier_hit_date or self.valuation_date
                df = self.discount_curve.get_discount_factor(hit) if self.discount_curve else 1.0
                return self.rebate_amount * df
            return self.barrier_hit_metrics()["rebate_pv_at_hit"]
        return self.rebate_amount * math.exp(-self.discount_rate * self.discount_years)

    # ------------------------------------------------------------------ #
    # RiskFlow-parity Monte Carlo (:708-925)                              #
    # ------------------------------------------------------------------ #
    def _mc_monitoring_times(self) -> List[float]:
        if self._dt_years:
            acc, times = 0.0, []
            for d in self._dt_years:
                acc += d
                times.append(round(acc, 12))
            return times
        t, m = self.tenor_years, max(1, self.m)
        return [round(t * k / m, 12) for k in range(1, m + 1)]

    def _mc_normals(self, n_half: int, n_steps: int) -> torch.Tensor:
        """The JAX package's normals, drawn on the host: torch's CPU stream
        after seeding with ``mc_seed`` (or numpy's ``default_rng``)."""
        if self.mc_use_torch_rng:
            gen = None
            if self.mc_seed is not None:
                gen = torch.Generator(device="cpu").manual_seed(self.mc_seed)
            return torch.randn(n_half, n_steps, dtype=torch.float64, generator=gen)
        return torch.from_numpy(
            np.random.default_rng(self.mc_seed).standard_normal((n_half, n_steps)))

    def _mc_out_price(self, effective_barrier_type: Optional[str] = None) -> float:
        btype = effective_barrier_type or self.barrier_type
        t = self.tenor_years
        df_t = math.exp(-self.discount_rate * self.discount_years)
        mu = self.carry_rate_nacc - self.div_yield_nacc
        sig, s0, k = self.sigma, self.spot_price, self.strike_price
        hu, hd = self.upper_barrier, self.lower_barrier

        mon_times = self._mc_monitoring_times()
        raw = [0.0] + mon_times
        if not mon_times or abs(mon_times[-1] - t) > 1e-10:
            raw.append(t)
        time_points = sorted(set(round(x, 10) for x in raw))
        mon_set = {round(x, 10) for x in mon_times}
        is_mon = [round(tp, 10) in mon_set for tp in time_points]
        dts = np.diff(time_points)
        n_steps = len(dts)

        n_half = max(1, self.mc_n_paths // 2) if self.mc_use_antithetic else self.mc_n_paths
        z = self._mc_normals(n_half, n_steps).to(self.device)
        if self.mc_use_antithetic:
            z = torch.cat([z, -z], dim=0)
        n_sim = z.shape[0]

        log_incs = (self._on_device((mu - 0.5 * sig * sig) * dts)[None, :]
                    + self._on_device(sig * np.sqrt(np.maximum(dts, 0.0)))[None, :] * z)
        log_s = math.log(s0) + torch.cat(
            [torch.zeros_like(z[:, :1]), torch.cumsum(log_incs, dim=1)], dim=1
        )
        s_paths = torch.exp(log_s)

        zeros = torch.zeros(n_sim, dtype=torch.float64, device=self.device)
        eps_b = self.mc_smooth_barrier_eps
        if eps_b > 0.0:
            breached = zeros
            rebate_pv = zeros
            for col, (tp, flag) in enumerate(zip(time_points, is_mon)):
                if col == 0 or not flag:
                    continue
                s_k = s_paths[:, col]
                event = zeros
                if btype in ("up-and-out", "double-out") and hu is not None:
                    event = torch.maximum(event, smooth_heaviside_up(s_k, hu, eps_b))
                if btype in ("down-and-out", "double-out") and hd is not None:
                    event = torch.maximum(event, smooth_heaviside_down(s_k, hd, eps_b))
                breached = breached + event
                if self.rebate_at_hit and self.rebate_amount > 0.0:
                    df_k = math.exp(-self.discount_rate * tp)
                    newly = torch.clamp(event - (rebate_pv > 0).double(), min=0.0)
                    rebate_pv = rebate_pv + newly * self.rebate_amount * df_k
            alive = torch.clamp(1.0 - breached, 0.0, 1.0)
            knocked_bool = alive <= 0.0
        else:
            alive_b = torch.ones(n_sim, dtype=torch.bool, device=self.device)
            rebate_pv = zeros
            for col, (tp, flag) in enumerate(zip(time_points, is_mon)):
                if col == 0 or not flag:
                    continue
                s_k = s_paths[:, col]
                newly = torch.zeros_like(alive_b)
                if btype in ("up-and-out", "double-out") and hu is not None:
                    newly = newly | (s_k >= hu)
                if btype in ("down-and-out", "double-out") and hd is not None:
                    newly = newly | (s_k <= hd)
                newly = newly & alive_b
                alive_b = alive_b & ~newly
                if self.rebate_at_hit and self.rebate_amount > 0.0:
                    pv_k = self.rebate_amount * math.exp(-self.discount_rate * tp)
                    rebate_pv = torch.where(newly, pv_k, rebate_pv)
            alive = alive_b.double()
            knocked_bool = ~alive_b

        s_mat = s_paths[:, -1]
        eps_p = self.mc_smooth_payoff_eps
        gap = s_mat - k if self.option_type == "call" else k - s_mat
        intrinsic = smooth_relu(gap, eps_p) if eps_p > 0.0 else torch.clamp(gap, min=0.0)

        payoff = alive * intrinsic
        if self.rebate_amount > 0.0 and self.rebate_at_hit:
            price = df_t * payoff.mean() + rebate_pv.mean()
            se = payoff.std() * df_t / math.sqrt(n_sim)
        elif self.rebate_amount > 0.0:
            total = payoff + torch.where(knocked_bool, self.rebate_amount, zeros)
            price = df_t * total.mean()
            se = total.std() * df_t / math.sqrt(n_sim)
        else:
            price = df_t * payoff.mean()
            se = payoff.std() * df_t / math.sqrt(n_sim)
        price, self._last_mc_std_error = torch.stack([price, se]).tolist()
        return price

    def _price_via_mc(self) -> float:
        if self.barrier_type == "none":
            return self._vanilla_b76()
        if self.barrier_type in ("up-and-out", "double-out") and self.upper_barrier is not None:
            if self.spot_price >= self.upper_barrier:
                return 0.0
        if self.barrier_type in ("down-and-out", "double-out") and self.lower_barrier is not None:
            if self.spot_price <= self.lower_barrier:
                return 0.0
        if self.barrier_type in ("up-and-out", "down-and-out", "double-out"):
            return self._mc_out_price()
        if self.barrier_type in ("up-and-in", "down-and-in"):
            out_type = "up-and-out" if "up" in self.barrier_type else "down-and-out"
            return self._vanilla_b76() - self._mc_out_price(out_type)
        if self.barrier_type == "double-in":
            return self._vanilla_b76() - self._mc_out_price("double-out")
        raise ValueError(self.barrier_type)

    # ------------------------------------------------------------------ #
    # Public API                                                          #
    # ------------------------------------------------------------------ #
    def _signed_scale(self, px: float) -> float:
        sgn = 1.0 if self.direction == "long" else -1.0
        return sgn * self.quantity * self.contract_multiplier * float(px)

    def _refresh_for_spot_change(self) -> None:
        self.spot_price_eff = self.spot_price * math.exp(-self.div_yield_nacc * self.time_to_carry)
        self.forward_price = self.spot_price_eff * math.exp(self.carry_rate_nacc * self.time_to_carry)

    def price(self) -> float:
        if self.barrier_type == "none":
            return self._signed_scale(self._vanilla_b76())
        if self.already_hit:
            # production CN semantics (discrete_barrier_fdm_pricer.py:
            # 923-933), shared with the batched sweep (batch.py
            # bgk_discrete_sweep): a knocked-OUT trade is worth its rebate
            # leg (cash already paid at hit -> DF to the hit date ~ now;
            # at-expiry rebate -> DF to expiry), a knocked-IN trade is the
            # vanilla. The reference's analytic route never short-circuits
            # and its MC route returns the rebate even for IN types
            # (discrete_barrier_bgk.py:904-908); both are fixed, as in the
            # JAX package (PARITY.md).
            if "in" in self.barrier_type:
                return self._signed_scale(self._vanilla_b76())
            if self.rebate_amount <= 0.0:
                return 0.0
            if self.rebate_at_hit:
                hit = self.barrier_hit_date or self.valuation_date
                df = (
                    self.discount_curve.get_discount_factor(hit)
                    if self.discount_curve
                    else 1.0
                )
                return self._signed_scale(self.rebate_amount * df)
            return self._signed_scale(
                self.rebate_amount
                * math.exp(-self.discount_rate * self.discount_years)
            )
        if self._select_method() == "mc":
            return self._signed_scale(self._price_via_mc())
        if self.barrier_type in ("up-and-out", "down-and-out"):
            return self._signed_scale(self._out_price_bgk(self.barrier_type) + self._rebate_leg())
        if self.barrier_type in ("up-and-in", "down-and-in"):
            out_type = "up-and-out" if "up" in self.barrier_type else "down-and-out"
            return self._signed_scale(self._vanilla_b76() - self._out_price_bgk(out_type))
        if self.barrier_type == "double-out":
            return self._signed_scale(self._out_price_bgk("double-out") + self._rebate_leg())
        if self.barrier_type == "double-in":
            return self._signed_scale(self._vanilla_b76() - self._out_price_bgk("double-out"))
        raise ValueError(f"Unsupported barrier_type: {self.barrier_type}")

    def greeks(self, ds_rel: float = 1e-4, dvol_abs: float = 1e-4) -> Dict[str, float]:
        saved = self.direction
        self.direction = "long"
        s0 = self.spot_price
        ds = max(1e-8, ds_rel * s0)
        self.spot_price = s0 + ds; self._refresh_for_spot_change(); up = self.price()
        self.spot_price = s0 - ds; self._refresh_for_spot_change(); dn = self.price()
        self.spot_price = s0; self._refresh_for_spot_change(); base = self.price()
        delta = (up - dn) / (2 * ds)
        gamma = (up - 2 * base + dn) / (ds * ds)
        sig0 = self.sigma
        self.sigma = sig0 + dvol_abs; upv = self.price()
        self.sigma = sig0 - dvol_abs; dnv = self.price()
        self.sigma = sig0
        vega = (upv - dnv) / (2 * dvol_abs)
        self.direction = saved
        scale = (1.0 if self.direction == "long" else -1.0) * self.quantity * self.contract_multiplier
        return {"delta": scale * delta, "gamma": scale * gamma, "vega": scale * vega}

    def report(self) -> str:
        lines = [
            "==== Discrete Barrier (BGK/Hörfelt) — Black-76 layout (CUDA port) ====",
            f"Trade ID           : {self.trade_id}",
            f"Option/Barrier     : {self.option_type} / {self.barrier_type}",
            f"Spot/Strike        : {self.spot_price:.8f} / {self.strike_price:.8f}",
            f"T expiry/carry/disc: {self.time_to_expiry:.8f} / {self.time_to_carry:.8f} / {self.time_to_discount:.8f}",
            f"sigma / r / carry  : {self.sigma:.8f} / {self.discount_rate_nacc:.8f} / {self.carry_rate_nacc:.8f}",
            f"F0 / m             : {self.forward_price:.8f} / {self.m}",
            f"method             : {self.pricing_method} -> {self._select_method().upper()}",
        ]
        px = self.price()
        g = self.greeks()
        lines.append(f"Price              : {px:.10f}")
        if self._select_method() == "mc":
            lines.append(f"MC std error       : {self._last_mc_std_error:.2e}")
        lines.append(f"Delta/Gamma/Vega   : {g['delta']:.8f} / {g['gamma']:.8f} / {g['vega']:.8f}")
        return "\n".join(lines)
