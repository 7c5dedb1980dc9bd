"""Bjerksund-Stensland pricer with date/curve-driven resolution.

Counterpart of ``finite_difference_tpu.models.analytic.bs_forward``, with
capability parity with the reference's ``bjerksund_stensland_forward.py``
(:14-756): the BS93 forward-frame American approximation with

- a simple float API (``price``/``greeks``) resolving the forward from an
  explicit F, continuous yield q, or discrete dividends (F > q > divs);
- a curve-based API (``price_from_curves``/``greeks_from_curves``)
  consuming daily NACA curves, dividend schedules and the three
  business-day lags, returning the resolved T_exp/T_carry/T_disc,
  carry/discount NACC rates, F_eff, and b alongside the price;
- finite-difference Greeks with the carry held fixed on spot bumps.

Time decomposition (bjerksund_stensland_forward.py:498-518):
  carry window   = [val + underlying_spot_days, mat + underlying_spot_days]
  discount window= [val + option_days, mat + option_settlement_days]
  T_exp scales sigma; T_carry scales the carry; T_disc scales discounting
  (folded into an effective rate r_eff = disc_rate * T_disc / T_exp so the
  closed form sees exp(-r_eff T_exp) = exp(-disc_rate T_disc)).

The dates, curves and forwards are host floats; the closed form
(:func:`.bjerksund_stensland.american_price_bs93`) runs at float64 on the
pricer's ``device`` (the card by default). A greeks call evaluates its base
and bumped prices as one stacked tensor call and reads them back once: one
launch chain and one device sync per call where the JAX package makes a
scalar call per bump. The closed form is elementwise, so only roundings
change.
"""
from __future__ import annotations

import datetime as _dt
import math
from typing import Dict, Sequence

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.calendars import SouthAfricaCalendar
from ...utils.curves import DailyNacaCurve
from ...utils.daycount import year_fraction
from .bjerksund_stensland import american_price_bs93

OptionType = str


class BjerksundStenslandForwardPricer:
    def __init__(self, device=DEFAULT_DEVICE) -> None:
        self.device = resolve_device(device)

    def _bs93(self, S: Sequence[float], F: Sequence[float], K, T, r, sigma, is_call) -> list:
        """``american_price_bs93`` on ``device`` at float64 over the stacked
        rows (each argument a number or a sequence of one per row), read
        back once."""
        t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=self.device)
        return american_price_bs93(t(S), t(F), t(K), t(T), t(r), t(sigma),
                                   torch.as_tensor(is_call, device=self.device)).tolist()

    # ------------------------------------------------------------------
    # simple API (bjerksund_stensland_forward.py:52-157)
    # ------------------------------------------------------------------

    def _resolve_forward(self, S, r, T, F=None, q=None, dividends=None) -> float:
        if F is not None:
            return float(F)
        if q is not None:
            return S * math.exp((r - q) * T)
        if dividends:
            pv = sum(
                d * math.exp(-r * ti)
                for ti, d in dividends
                if 0.0 < ti <= T and d != 0.0
            )
            return (S - pv) * math.exp(r * T)
        return S * math.exp(r * T)

    @staticmethod
    def _intrinsic(S, K, option_type) -> float:
        return max(0.0, (S - K) if option_type == "call" else (K - S))

    def price(
        self, S, K, T, r, sigma, option_type: OptionType = "call",
        F=None, q=None, dividends=None,
    ) -> Dict[str, float]:
        if T <= 0.0:
            return {"price": self._intrinsic(S, K, option_type), "I": 0.0, "early_exercise": 0.0}
        F_eff = self._resolve_forward(S, r, T, F, q, dividends)
        (px,) = self._bs93([S], [F_eff], K, T, [r], [sigma], option_type == "call")
        b = math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / T
        early = 1.0 if (option_type == "call" and b < r) or (
            option_type == "put" and -b < r - b
        ) else 0.0
        return {"price": px, "I": 0.0, "early_exercise": early}

    def greeks(
        self, S, K, T, r, sigma, option_type: OptionType = "call",
        F=None, q=None, dividends=None, dS: float = 1e-4, dSigma: float = 1e-4,
        dR: float = 1e-6,
    ) -> Dict[str, float]:
        F_eff = self._resolve_forward(S, r, T, F, q, dividends)
        b = math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / max(T, 1e-12)
        S_up, S_dn = S * (1.0 + dS), S * (1.0 - dS)
        # rows: base, spot up, spot down, vol up, vol down, rate up, rate down
        spots = [S, S_up, S_dn, S, S, S, S]
        if T <= 0.0:
            base, p_up, p_dn, p_vu, p_vd, p_ru, p_rd = (
                self._intrinsic(s, K, option_type) for s in spots)
        else:
            base, p_up, p_dn, p_vu, p_vd, p_ru, p_rd = self._bs93(
                spots,
                [F_eff, S_up * math.exp(b * T), S_dn * math.exp(b * T)] + [F_eff] * 4,
                K, T, [r] * 5 + [r + dR, r - dR],
                [sigma] * 3 + [sigma * (1 + dSigma), sigma * (1 - dSigma), sigma, sigma],
                option_type == "call",
            )
        delta = (p_up - p_dn) / (S_up - S_dn)
        gamma = (p_up - 2.0 * base + p_dn) / ((S_up - S) * (S - S_dn) + 1e-18)
        vega = (p_vu - p_vd) / (2.0 * sigma * dSigma + 1e-18)
        rho = (p_ru - p_rd) / (2.0 * dR)
        return {"delta": delta, "gamma": gamma, "vega": vega, "rho": rho}

    # ------------------------------------------------------------------
    # curve-based API (:157-378, 477-620)
    # ------------------------------------------------------------------

    @staticmethod
    def _as_curve(curve, val_date: _dt.date) -> DailyNacaCurve:
        if isinstance(curve, DailyNacaCurve):
            return curve
        return DailyNacaCurve(curve, val_date)

    def _resolve_curve_inputs(
        self, S, val_date, mat_date, discount_curve, forward_curve,
        div_schedule, underlying_spot_days, option_days,
        option_settlement_days, day_count,
    ) -> Dict[str, float]:
        if discount_curve is None:
            raise ValueError("discount_curve is required for the curve API.")
        cal = SouthAfricaCalendar()
        disc = self._as_curve(discount_curve, val_date)
        fwd = (
            self._as_curve(forward_curve, val_date)
            if forward_curve is not None
            else disc
        )

        carry_start = cal.add_working_days(val_date, underlying_spot_days)
        carry_end = cal.add_working_days(mat_date, underlying_spot_days)
        disc_start = cal.add_working_days(val_date, option_days)
        disc_end = cal.add_working_days(mat_date, option_settlement_days)

        T_exp = year_fraction(val_date, mat_date, day_count)
        T_carry = year_fraction(carry_start, carry_end, day_count)
        T_disc = year_fraction(disc_start, disc_end, day_count)

        carry_rate = fwd.get_forward_nacc_rate(carry_start, carry_end)
        disc_rate = disc.get_forward_nacc_rate(disc_start, disc_end)

        pv_divs = 0.0
        for ex_date, amount in div_schedule or []:
            if val_date < ex_date <= mat_date and amount:
                pv_divs += amount * disc.get_discount_factor(ex_date)

        S_eff = S - pv_divs
        F_eff = S_eff * math.exp(carry_rate * T_carry)
        df = math.exp(-disc_rate * T_disc)
        b = math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / max(T_exp, 1e-12)
        return {
            "T_exp": T_exp, "T_carry": T_carry, "T_disc": T_disc,
            "carry_rate": carry_rate, "disc_rate": disc_rate,
            "F_eff": F_eff, "df": df, "b": b, "S_eff": S_eff,
        }

    def price_from_curves(
        self, S, K, valuation_date, maturity_date, sigma,
        option_type: OptionType = "call",
        discount_curve=None, forward_curve=None, dividend_schedule=None,
        underlying_spot_days: int = 0, option_days: int = 0,
        option_settlement_days: int = 0, day_count: str = "ACT/365",
    ) -> Dict[str, float]:
        if maturity_date <= valuation_date:
            return {
                "price": self._intrinsic(S, K, option_type), "I": 0.0, "early_exercise": 0.0,
                "T_exp": 0.0, "T_carry": 0.0, "T_disc": 0.0,
                "carry_rate": 0.0, "disc_rate": 0.0, "F_eff": S, "b": 0.0,
            }
        res = self._resolve_curve_inputs(
            S, valuation_date, maturity_date, discount_curve, forward_curve,
            dividend_schedule, underlying_spot_days, option_days,
            option_settlement_days, day_count,
        )
        # fold T_disc into an effective rate on T_exp so df is exact
        r_eff = res["disc_rate"] * res["T_disc"] / max(res["T_exp"], 1e-12)
        (px,) = self._bs93([S], [res["F_eff"]], K, res["T_exp"], r_eff, [sigma],
                           option_type == "call")
        out = {"price": px, "I": 0.0, "early_exercise": float(res["b"] < r_eff)}
        out.update({k: res[k] for k in (
            "T_exp", "T_carry", "T_disc", "carry_rate", "disc_rate", "F_eff", "b",
        )})
        return out

    def greeks_from_curves(
        self, S, K, valuation_date, maturity_date, sigma,
        option_type: OptionType = "call",
        discount_curve=None, forward_curve=None, dividend_schedule=None,
        underlying_spot_days: int = 0, option_days: int = 0,
        option_settlement_days: int = 0, day_count: str = "ACT/365",
        dS: float = 1e-4, dSigma: float = 1e-4,
    ) -> Dict[str, float]:
        res = self._resolve_curve_inputs(
            S, valuation_date, maturity_date, discount_curve, forward_curve,
            dividend_schedule, underlying_spot_days, option_days,
            option_settlement_days, day_count,
        )
        r_eff = res["disc_rate"] * res["T_disc"] / max(res["T_exp"], 1e-12)

        # spot bumps hold carry_rate and T_carry fixed: F scales with S_eff
        growth = math.exp(res["carry_rate"] * res["T_carry"])
        pv_divs = S - res["S_eff"]
        S_up, S_dn = S * (1 + dS), S * (1 - dS)
        # rows: base, spot up, spot down, vol up, vol down
        base, p_up, p_dn, p_vu, p_vd = self._bs93(
            [S, S_up, S_dn, S, S],
            [res["F_eff"], (S_up - pv_divs) * growth, (S_dn - pv_divs) * growth,
             res["F_eff"], res["F_eff"]],
            K, res["T_exp"], r_eff,
            [sigma, sigma, sigma, sigma * (1 + dSigma), sigma * (1 - dSigma)],
            option_type == "call",
        )
        delta = (p_up - p_dn) / (S_up - S_dn)
        gamma = (p_up - 2.0 * base + p_dn) / ((S_up - S) * (S - S_dn) + 1e-18)
        vega = (p_vu - p_vd) / (2.0 * sigma * dSigma + 1e-18)
        return {"price": base, "delta": delta, "gamma": gamma, "vega": vega}
