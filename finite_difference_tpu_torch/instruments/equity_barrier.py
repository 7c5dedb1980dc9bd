"""Discretely-monitored equity barrier option as a netting-set instrument
(the port of ``finite_difference_tpu.instruments.equity_barrier``).

The reference's exposure engine declares a ``precompute`` hook for "PDE
surfaces / LSM boundaries / surrogates before the simulation loop"
(the reference's instrument.py:44-74, exposure_engine.py:157-164) but its
dump contains no instrument that uses it. This is that instrument:

- ``precompute`` prices the WHOLE scenario-date ladder in one batched CN
  solve (models/pde/batch.solve_value_surfaces, routed by its ``auto``
  rule) on the instrument's ``device``: for every scenario date d it
  stores the knock-out value function V_d(S) over the monitors remaining
  after d (and the vanilla surface, for knock-ins via in-out parity — the
  production pricer's own method, discrete_barrier_fdm_pricer.py:907-946).
  The surfaces stay on the device for the device exposure engine, with
  one host copy each, made once, for the generic engine's host pricing.
- monitor-date spots are stamped once each by the engine's equity-fixing
  cache (the same ``get_equity_reset_schedule`` contract EquityTRS uses,
  exposure_engine.py:499-546), so the barrier's survival state is exact
  per path: knocked-OUT paths are worth the rebate (0 once an at-hit
  rebate has settled), knocked-IN paths hold the vanilla.
- ``scenario_npvs`` is then one ``np.interp`` of the simulated spots
  against the date's host surface — no PDE work inside the date x trade
  loop.

The surface approximation (standard for XVA surrogates): sigma, r and
carry are the flat parameters the trade was priced with; the simulated
equity path moves the spot dimension only. Spots beyond the grid clamp to
the far-field values (flat extrapolation).
"""
from __future__ import annotations

import datetime as dt
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.daycount import year_fraction
from .instrument import Instrument

_OUT_TYPES = ("up-and-out", "down-and-out", "double-out")
_IN_TYPES = ("up-and-in", "down-and-in", "double-in")


class EquityBarrierOption(Instrument):
    def __init__(
        self,
        name: str,
        spot_name: str,
        strike: float,
        maturity_date: dt.date,
        sigma: float,
        rate: float,
        monitor_dates: Sequence[dt.date],
        option_type: str = "call",
        barrier_type: str = "up-and-out",
        lower_barrier: Optional[float] = None,
        upper_barrier: Optional[float] = None,
        rebate: float = 0.0,
        rebate_at_hit: bool = False,
        carry: Optional[float] = None,
        dividend_yield: float = 0.0,
        quantity: float = 1.0,
        day_count: str = "ACT/365",
        n_time_steps: int = 256,
        num_space_nodes: int = 511,
        already_hit: bool = False,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(name)
        if barrier_type not in _OUT_TYPES + _IN_TYPES:
            raise ValueError(f"unknown barrier_type {barrier_type!r}")
        if barrier_type.startswith(("down", "double")) and lower_barrier is None:
            raise ValueError(f"{barrier_type} requires lower_barrier")
        if barrier_type.startswith(("up", "double")) and upper_barrier is None:
            raise ValueError(f"{barrier_type} requires upper_barrier")
        self.spot_name = spot_name
        self.strike = float(strike)
        self.maturity_date = maturity_date
        self.sigma = float(sigma)
        self.rate = float(rate)
        self.carry = float(rate if carry is None else carry)
        self.dividend_yield = float(dividend_yield)
        self.option_type = option_type
        self.barrier_type = barrier_type
        self.lower_barrier = lower_barrier
        self.upper_barrier = upper_barrier
        self.rebate = float(rebate)
        self.rebate_at_hit = bool(rebate_at_hit)
        self.quantity = float(quantity)
        self.day_count = day_count
        self.monitor_dates = sorted(monitor_dates)
        self.n_time_steps = int(n_time_steps)
        self.num_space_nodes = int(num_space_nodes)
        self.already_hit = bool(already_hit)
        self.device = resolve_device(device)
        self._surfaces: Optional[Dict[dt.date, int]] = None

    # ------------------------------------------------------------------
    # engine contracts
    # ------------------------------------------------------------------
    def get_equity_reset_schedule(self) -> List[dt.date]:
        """Monitor dates; the engine stamps the spot once at each."""
        return list(self.monitor_dates)

    def _compute_equity_fixing_for_date(
        self, reset_date: dt.date, fix_state: Dict
    ) -> Dict[tuple, np.ndarray]:
        spot_slice = fix_state[self.spot_name]
        return {
            (self.spot_name, reset_date): np.asarray(
                spot_slice.values, dtype=np.float64
            ).copy()
        }

    def precompute(
        self,
        market_states: Sequence[Dict[str, object]],
        dates: Sequence[dt.date],
    ) -> None:
        """One batched CN solve -> a value surface per scenario date."""
        spot0 = float(
            np.mean(np.asarray(market_states[0][self.spot_name].values))
        )
        self.build_surfaces(spot0, dates)

    def build_surfaces(
        self, spot0: float, dates: Sequence[dt.date]
    ) -> None:
        """Surface construction core (grid centered at ``spot0``); also
        called by the device exposure path, which has no state dicts."""
        from ..models.pde.batch import solve_value_surfaces

        live = [d for d in dates if d < self.maturity_date]
        if not live:
            self._surfaces = {}
            return
        n_nodes = self.num_space_nodes + 1
        ko_batch, van_batch = self._surface_batches(spot0, live)
        v_ko, s_nodes = solve_value_surfaces(ko_batch, n_nodes, device=self.device)
        self._v_ko, self._s_nodes = v_ko, s_nodes
        if van_batch is not None:
            self._v_van, _ = solve_value_surfaces(van_batch, n_nodes, device=self.device)
        # one host copy of each surface for the generic engine's np.interp
        self._host = {
            "s": s_nodes.cpu().numpy(),
            "ko": v_ko.cpu().numpy(),
            "van": None if van_batch is None else self._v_van.cpu().numpy(),
        }
        self._surfaces = {d: i for i, d in enumerate(live)}

    def _surface_batches(self, spot0: float, live: Sequence[dt.date]):
        """(knock-out batch, vanilla batch or None) of the live dates'
        surfaces on the instrument's device: the vanilla batch only for a
        knock-in, on the knock-out batch's grid."""
        from ..models.pde.batch import build_trade_batch

        is_call = self.option_type == "call"
        is_in = self.barrier_type in _IN_TYPES
        has_lower = self.barrier_type.startswith(("down", "double"))
        has_upper = self.barrier_type.startswith(("up", "double"))

        t_exp, monitors = [], []
        for d in live:
            t_exp.append(year_fraction(d, self.maturity_date, self.day_count))
            monitors.append(
                [
                    year_fraction(d, m, self.day_count)
                    for m in self.monitor_dates
                    if m > d
                ]
            )
        B = len(live)
        common = dict(
            spots=[spot0] * B,
            strikes=[self.strike] * B,
            sigmas=[self.sigma] * B,
            t_expiry=t_exp,
            r=[self.rate] * B,
            b=[self.carry] * B,
            q=[self.dividend_yield] * B,
            is_call=[is_call] * B,
            n_time_steps=self.n_time_steps,
            num_space_nodes=self.num_space_nodes,
            device=self.device,
        )
        ko_batch = build_trade_batch(
            monitor_times=monitors,
            lower=[self.lower_barrier if has_lower else None] * B,
            upper=[self.upper_barrier if has_upper else None] * B,
            rebate=[self.rebate] * B,
            # the IN option's rebate pays at expiry iff never knocked in,
            # so its parity complement is the at-EXPIRY-rebate KO leg:
            # rebate_at_hit must not leak into the KI surfaces
            rebate_at_hit=[self.rebate_at_hit and not is_in] * B,
            **common,
        )
        if not is_in:
            return ko_batch, None
        # KI via in-out parity needs the vanilla surface; the KO leg of the
        # parity must carry NO rebate (the IN option's rebate is paid when
        # it expires un-knocked-in — at-expiry only). Pin the vanilla batch
        # to the KO batch's grid so every surface shares self._s_nodes.
        van_batch = build_trade_batch(monitor_times=[[] for _ in range(B)], **common)
        return ko_batch, replace(van_batch, x_min=ko_batch.x_min, dx=ko_batch.dx)

    # ------------------------------------------------------------------
    # pricing
    # ------------------------------------------------------------------
    def _hit_mask(
        self,
        val_date: dt.date,
        fixings: Optional[Dict[tuple, np.ndarray]],
        n_paths: int,
    ) -> np.ndarray:
        hit = np.full(n_paths, self.already_hit, dtype=bool)
        if fixings is None:
            return hit
        for m in self.monitor_dates:
            if m > val_date:
                break
            s_m = fixings.get((self.spot_name, m))
            if s_m is None:
                continue
            s_m = np.asarray(s_m, dtype=np.float64)
            if self.barrier_type.startswith(("down", "double")):
                hit |= s_m <= self.lower_barrier
            if self.barrier_type.startswith(("up", "double")):
                hit |= s_m >= self.upper_barrier
        return hit

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict[str, object],
        fixings: Optional[Dict[tuple, np.ndarray]] = None,
        rng=None,
    ) -> np.ndarray:
        spot_slice = market_state[self.spot_name]
        spot = np.asarray(spot_slice.values, dtype=np.float64)
        n_paths = spot.shape[0]
        if val_date >= self.maturity_date:
            return np.zeros(n_paths)
        if self._surfaces is None:
            raise RuntimeError(
                "EquityBarrierOption.precompute was not called; run through "
                "ExposureEngine (it invokes the hook) or call precompute "
                "with the scenario states first."
            )
        idx = self._surfaces.get(val_date)
        if idx is None:
            raise KeyError(
                f"no precomputed surface for valuation date {val_date}"
            )
        s = self._host["s"][idx]
        hit = self._hit_mask(val_date, fixings, n_paths)
        tau = year_fraction(val_date, self.maturity_date, self.day_count)

        if self.barrier_type in _OUT_TYPES:
            alive_val = np.interp(spot, s, self._host["ko"][idx])
            if self.rebate_at_hit:
                # rebate settles in cash at the hit -> no remaining MTM
                dead_val = 0.0
            else:
                dead_val = self.rebate * np.exp(-self.rate * tau)
            return self.quantity * np.where(hit, dead_val, alive_val)

        # knock-IN via parity: KI(R) = vanilla - KO(R at expiry) + R*DF.
        # The KI rebate pays at expiry iff the barrier is never touched
        # (the Reiner-Rubinstein convention, term E): the at-expiry-rebate
        # KO surface carries the touch-contingent leg R*DF*P(touch), so
        # subtracting it and adding the unconditional R*DF leaves exactly
        # R*DF*P(never touched). Once hit, the holder owns the vanilla.
        van = np.interp(spot, s, self._host["van"][idx])
        alive_val = van - np.interp(spot, s, self._host["ko"][idx])
        if self.rebate != 0.0:
            alive_val = alive_val + self.rebate * np.exp(-self.rate * tau)
        return self.quantity * np.where(hit, van, alive_val)
