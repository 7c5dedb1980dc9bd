"""Zero-coupon bond and pricer (the port's copy of
``finite_difference_tpu.bonds.zero_coupon``, host Python).

Capability parity with the reference's ``zero_coupon_bond.py:4-21`` and
``zero_coupon_bond_pricer.py:12-61``: PV = face * DF(maturity); PV01 from a
central zero-rate bump (modified-duration form). The curve is any object
exposing ``get_discount_factor(date)`` / ``get_zero_rate(date)`` /
``year_fraction(d0, d1)`` (e.g. ``utils.curves.DailyNacaCurve``).
"""
from __future__ import annotations

import datetime as dt
import math


class ZeroCouponBond:
    def __init__(self, face_value: float, maturity_date: dt.date):
        if face_value <= 0:
            raise ValueError("face_value must be positive.")
        if not isinstance(maturity_date, dt.date):
            raise TypeError("maturity_date must be a datetime.date.")
        self.face_value = face_value
        self.maturity_date = maturity_date

    def __str__(self) -> str:
        return (
            f"ZeroCouponBond(face_value={self.face_value}, "
            f"maturity_date={self.maturity_date})"
        )


class ZeroCouponBondPricer:
    def __init__(self, bond: ZeroCouponBond, yield_curve) -> None:
        self.bond = bond
        self.yield_curve = yield_curve
        self.eval_date = getattr(
            yield_curve, "valuation_date", getattr(yield_curve, "value_date", None)
        )

    def present_value(self) -> float:
        df = self.yield_curve.get_discount_factor(self.bond.maturity_date)
        return self.bond.face_value * float(df)

    def _zero_rate_nacc(self) -> float:
        """Continuously-compounded zero rate to maturity."""
        if hasattr(self.yield_curve, "get_zero_rate"):
            return float(self.yield_curve.get_zero_rate(self.bond.maturity_date))
        df = float(self.yield_curve.get_discount_factor(self.bond.maturity_date))
        t = self._year_fraction()
        return -math.log(df) / max(t, 1e-12)

    def _year_fraction(self) -> float:
        if hasattr(self.yield_curve, "year_fraction"):
            return float(
                self.yield_curve.year_fraction(self.eval_date, self.bond.maturity_date)
            )
        return (self.bond.maturity_date - self.eval_date).days / 365.0

    def pv01(self, bump: float = 1e-4) -> float:
        """PV01 = (PV(r-bump) - PV(r+bump)) / 2 (zero_coupon_bond_pricer.py:30-61)."""
        zero_rate = self._zero_rate_nacc()
        t = self._year_fraction()
        pv_up = self.bond.face_value * math.exp(-(zero_rate + bump) * t)
        pv_down = self.bond.face_value * math.exp(-(zero_rate - bump) * t)
        return (pv_down - pv_up) / (2 * bump) * bump
