"""Forward rate agreement (the port's copy of
``finite_difference_tpu.bonds.fra``, host Python).

Capability parity with the reference's ``forward_rate_agreement.py:9-100``
and ``forward_rate_agreement_pricer.py:9-82`` without QuantLib: the implied
forward is the simple rate over [settle, maturity] on the curve; the NPV is
the classic FRA value N * (fwd - K) * tau * DF(maturity), signed by
position (equivalent to discounting the settle-date payoff
N*(fwd-K)*tau/(1+fwd*tau) by DF(settle)).
"""
from __future__ import annotations

import datetime as dt


class ForwardRateAgreement:
    def __init__(
        self,
        settle_date: dt.date,
        maturity_date: dt.date,
        position: str,
        strike_rate: float,
        notional: float,
        frequency: str = "quarterly",
    ) -> None:
        if maturity_date <= settle_date:
            raise ValueError("maturity_date must be after settle_date.")
        self.settle_date = settle_date
        self.maturity_date = maturity_date
        self.position = position.lower()
        if self.position not in ("long", "short"):
            raise ValueError("position must be 'long' or 'short'.")
        self.strike_rate = strike_rate
        self.notional = notional
        freq = frequency.lower()
        self.index_months = 6 if freq in ("semi-annual", "semiannual", "6m") else 3


class ForwardRateAgreementPricer:
    def __init__(self, fra_def: ForwardRateAgreement, yield_curve) -> None:
        self.fra_def = fra_def
        self.yield_curve = yield_curve

    def _tau(self) -> float:
        f = self.fra_def
        if hasattr(self.yield_curve, "year_fraction"):
            return float(self.yield_curve.year_fraction(f.settle_date, f.maturity_date))
        return (f.maturity_date - f.settle_date).days / 365.0

    def forward_rate(self) -> float:
        """Simple forward over [settle, maturity]."""
        f = self.fra_def
        df_s = float(self.yield_curve.get_discount_factor(f.settle_date))
        df_m = float(self.yield_curve.get_discount_factor(f.maturity_date))
        tau = self._tau()
        return (df_s / df_m - 1.0) / tau

    def npv(self) -> float:
        f = self.fra_def
        fwd = self.forward_rate()
        tau = self._tau()
        df_m = float(self.yield_curve.get_discount_factor(f.maturity_date))
        sign = 1.0 if f.position == "long" else -1.0
        return sign * f.notional * (fwd - f.strike_rate) * tau * df_m
