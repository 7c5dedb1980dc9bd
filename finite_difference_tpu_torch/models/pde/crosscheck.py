"""Independent-engine cross-check pricers.

Counterpart of ``finite_difference_tpu.models.pde.crosscheck``, with
capability parity with the reference's QuantLib cross-check harness
``discrete_barrier_fdm_ql.py:25-241`` (QLDiscreteBarrierPricer): a
discretely-monitored barrier pricer configured FIS-style (CN + Rannacher,
time grid refined to ``steps_per_monitor`` per monitoring interval, KO
priced directly, KI via knock-in/knock-out parity against the vanilla).

The JAX module drives ``ql.FdBlackScholesBarrierEngine`` where the QuantLib
bindings import, and otherwise the framework's *independent*
year-fraction CN engine (``cn_log``), which shares no code path with the
production ``DiscreteBarrierFDMPricer`` grid policy. That engine is what
both packages run without QuantLib; the port keeps the optional import
(``HAS_QUANTLIB``) and prices through its own ``cn_log`` on the pricer's
``device`` (the card by default).
"""
from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from typing import Dict, List, Optional

from ...device import DEFAULT_DEVICE, resolve_device
from ...utils.daycount import year_fraction

try:  # pragma: no cover - exercised only where QuantLib is installed
    import QuantLib as ql  # type: ignore

    HAS_QUANTLIB = True
except ImportError:  # pragma: no cover
    ql = None
    HAS_QUANTLIB = False


@dataclass(frozen=True)
class MarketParams:
    """Inputs of the reference's MarketParams block."""

    spot: float
    strike: float
    sigma: float
    rate_nacc: float
    dividend_nacc: float = 0.0
    rebate: float = 0.0
    valuation_date: Optional[dt.date] = None


def fis_time_steps(
    n_monitors: int, min_time_steps: int = 200, steps_per_monitor: int = 4
) -> int:
    """The FIS-style time-grid refinement rule: enough steps that every
    monitoring date is well-resolved (discrete_barrier_fdm_ql.py:40-46)."""
    return max(int(min_time_steps), int(steps_per_monitor) * max(1, n_monitors))


class QLDiscreteBarrierPricer:
    def __init__(
        self,
        market: MarketParams,
        is_call: bool,
        barrier_type: str,
        monitoring_dates: List[dt.date],
        maturity_date: dt.date,
        barrier: float,
        valuation_date: Optional[dt.date] = None,
        grid_points: int = 200,
        min_time_steps: int = 200,
        steps_per_monitor: int = 4,
        day_count: str = "ACT/365",
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.market = market
        self.is_call = is_call
        self.barrier_type_str = barrier_type.lower()
        self.monitoring_dates = sorted(monitoring_dates)
        self.maturity_date = maturity_date
        self.barrier = float(barrier)
        self.valuation_date = valuation_date or market.valuation_date
        if self.valuation_date is None:
            raise ValueError("valuation_date required (market or argument).")
        self.grid_points = int(grid_points)
        self.time_steps = fis_time_steps(
            len(self.monitoring_dates), min_time_steps, steps_per_monitor
        )
        self.day_count = day_count
        self.tenor_years = year_fraction(
            self.valuation_date, maturity_date, day_count
        )

    # ------------------------------------------------------------------

    def _cn_engine(self, barrier_type: str):
        from .cn_log import DiscreteBarrierCrankNicolsonLog

        monitor_times = [
            year_fraction(self.valuation_date, d, self.day_count)
            for d in self.monitoring_dates
            if self.valuation_date < d <= self.maturity_date
        ]
        return DiscreteBarrierCrankNicolsonLog(
            S0=self.market.spot,
            K=self.market.strike,
            T=self.tenor_years,
            sigma=self.market.sigma,
            r_disc=self.market.rate_nacc,
            b_carry=self.market.rate_nacc - self.market.dividend_nacc,
            option_type="call" if self.is_call else "put",
            barrier_type=barrier_type,
            lower_barrier=self.barrier if "down" in self.barrier_type_str else None,
            upper_barrier=self.barrier if "up" in self.barrier_type_str else None,
            rebate=self.market.rebate,
            monitor_times=monitor_times,
            N_space=self.grid_points,
            N_time=self.time_steps,
            device=self.device,
        )

    def price_vanilla_FD(self) -> Dict[str, float]:
        eng = self._cn_engine("none")
        out = eng.greeks()
        return {k: out[k] for k in ("price", "delta", "gamma", "vega")}

    def price_KO_FD(self) -> Dict[str, float]:
        ko_type = self.barrier_type_str.replace("in", "out")
        eng = self._cn_engine(ko_type)
        return eng._pde_price_and_greeks()

    def price_KI_from_parity(self) -> Dict[str, float]:
        """KI = Vanilla - KO, greeks by the same identity
        (discrete_barrier_fdm_ql.py:221-241)."""
        v = self.price_vanilla_FD()
        ko = self.price_KO_FD()
        return {g: v[g] - ko[g] for g in v}

    def price_and_greeks(self) -> Dict[str, float]:
        if "out" in self.barrier_type_str:
            return self.price_KO_FD()
        if "in" in self.barrier_type_str:
            return self.price_KI_from_parity()
        raise ValueError("barrier_type must contain 'in' or 'out'.")
