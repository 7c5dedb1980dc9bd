"""American option CN pricer on the driftless log-forward PDE (Black-76).

Counterpart of ``finite_difference_tpu.models.pde.american_black76``.
Capability parity with the reference's ``fd_american_black76.py:12-625``
(AmericanFwdFDMPricer): the same CN + Rannacher + Ikonen-Toivanen
machinery as the equity pricer, applied to dF = sigma F dW with discounting
at r — i.e. carry b = 0 with dividends assumed embedded in the forward.
The state variable is the forward; price/greeks are reported against it.
"""
from __future__ import annotations

import datetime as _dt

from .american import AmericanFDMPricer


class AmericanFwdFDMPricer(AmericanFDMPricer):
    def __init__(
        self,
        forward: float,
        strike: float,
        valuation_date: _dt.date,
        maturity_date: _dt.date,
        sigma: float,
        option_type: str,
        discount_curve,
        **kwargs,
    ) -> None:
        kwargs.pop("dividend_schedule", None)  # dividends live inside F
        super().__init__(
            spot=forward,
            strike=strike,
            valuation_date=valuation_date,
            maturity_date=maturity_date,
            sigma=sigma,
            option_type=option_type,
            discount_curve=discount_curve,
            forward_curve=None,
            dividend_schedule=None,
            **kwargs,
        )
        # driftless forward dynamics (fd_american_black76.py:12,320)
        self.carry_rate_nacc = 0.0

    @property
    def forward(self) -> float:
        return self.spot
