"""American equity option as a netting-set instrument (PDE surfaces; the
port of ``finite_difference_tpu.instruments.american_option``).

The second user of the exposure engine's PDE-surrogate ``precompute``
hook (the reference's instrument.py:44-74 names "PDE surfaces / LSM
boundaries" as the intent; see also instruments/equity_barrier.py):
``precompute`` runs ONE batched Ikonen-Toivanen CN solve across every
scenario date (models/pde/batch.solve_value_surfaces(american=True) —
the early-exercise projection is per-step, so this stays on the scan),
storing the per-date American value surface V_d(S) on the instrument's
``device``, with one host copy made once; ``scenario_npvs`` interpolates
the simulated spots against the host copy. The usual XVA-surrogate
approximation applies: sigma/r/carry are the trade's flat parameters,
simulated paths move the spot dimension; holder exercise is assumed
optimal (the surface already embeds the exercise boundary), so a
netting-set holding an American option marks it at continuation value.

Cross-checks: the surface at t=0 matches price_american_batch to 1e-9;
models/mc/lsm.py (Longstaff-Schwartz) is the independent MC oracle.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, Optional, Sequence

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.daycount import year_fraction
from .instrument import Instrument


class AmericanOptionPosition(Instrument):
    def __init__(
        self,
        name: str,
        spot_name: str,
        strike: float,
        maturity_date: dt.date,
        sigma: float,
        rate: float,
        option_type: str = "put",
        carry: Optional[float] = None,
        quantity: float = 1.0,
        day_count: str = "ACT/365",
        n_time_steps: int = 200,
        num_space_nodes: int = 400,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(name)
        self.spot_name = spot_name
        self.strike = float(strike)
        self.maturity_date = maturity_date
        self.sigma = float(sigma)
        self.rate = float(rate)
        self.carry = float(rate if carry is None else carry)
        self.option_type = option_type
        self.quantity = float(quantity)
        self.day_count = day_count
        self.n_time_steps = int(n_time_steps)
        self.num_space_nodes = int(num_space_nodes)
        self.device = resolve_device(device)
        self._surfaces: Optional[Dict[dt.date, int]] = None

    def precompute(
        self,
        market_states: Sequence[Dict[str, object]],
        dates: Sequence[dt.date],
    ) -> None:
        spot0 = float(
            np.mean(np.asarray(market_states[0][self.spot_name].values))
        )
        self.build_surfaces(spot0, dates)

    def build_surfaces(self, spot0: float, dates: Sequence[dt.date]) -> None:
        """Surface construction core (grid centered at ``spot0``); also
        called by the device exposure path, which has no state dicts."""
        from ..models.pde.batch import (
            build_american_batch,
            solve_value_surfaces,
        )

        live = [d for d in dates if d < self.maturity_date]
        if not live:
            self._surfaces = {}
            return
        B = len(live)
        batch = build_american_batch(
            spots=[spot0] * B,
            strikes=[self.strike] * B,
            sigmas=[self.sigma] * B,
            t_expiry=[
                year_fraction(d, self.maturity_date, self.day_count)
                for d in live
            ],
            r=[self.rate] * B,
            b=[self.carry] * B,
            is_call=[self.option_type == "call"] * B,
            n_time_steps=self.n_time_steps,
            num_space_nodes=self.num_space_nodes,
            device=self.device,
        )
        self._v, self._s_nodes = solve_value_surfaces(
            batch, self.num_space_nodes + 1, american=True, device=self.device
        )
        # one host copy for the generic engine's np.interp
        self._host = {"s": self._s_nodes.cpu().numpy(), "v": self._v.cpu().numpy()}
        self._surfaces = {d: i for i, d in enumerate(live)}

    def scenario_npvs(
        self,
        val_date: dt.date,
        market_state: Dict[str, object],
        fixings=None,
        rng=None,
    ) -> np.ndarray:
        spot = np.asarray(market_state[self.spot_name].values, dtype=np.float64)
        if val_date >= self.maturity_date:
            return np.zeros(spot.shape[0])
        if self._surfaces is None:
            raise RuntimeError(
                "AmericanOptionPosition.precompute was not called; run "
                "through ExposureEngine or call precompute first."
            )
        idx = self._surfaces[val_date]
        return self.quantity * np.interp(
            spot, self._host["s"][idx], self._host["v"][idx]
        )
