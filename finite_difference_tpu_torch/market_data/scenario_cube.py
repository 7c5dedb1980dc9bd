"""Scenario cube: simulated risk factors over (dates, paths) (the port's
copy of ``finite_difference_tpu.market_data.scenario_cube``, host numpy).

Reconstruction of the reference's absent ``market_data/scenario_cube.py`` /
``static_market_data.py`` (interfaces from exposure_engine.py:86-162):

- ``ScenarioCube.n_paths / n_times / dates``
- ``ScenarioCube.get_time_slice(t) -> dict[name, RiskFactorSlice]``
- ``StaticMarketData.factors`` merged under cube slices (stochastic factors
  win on name collision).

Storage is struct-of-arrays: each factor keeps ONE dense array over all
times ((n_times, n_paths[, n_tenors[, n_strikes]])), so the whole cube can
live on device and shard over the path axis; ``get_time_slice`` is a cheap
view construction for the host-side engine loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import date
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .risk_factor import CurveSlice, ScalarSlice, SurfaceSlice


@dataclass
class StaticMarketData:
    """Path-invariant factors merged into every time slice."""

    factors: Dict[str, Union[ScalarSlice, CurveSlice, SurfaceSlice]] = field(
        default_factory=dict
    )


class ScenarioCube:
    """Dense factor storage with per-date slice views.

    Parameters
    ----------
    dates : simulation dates (ascending).
    factors : dict name -> spec, where spec is one of
        ("scalar", values (n_times, n_paths)),
        ("curve",  values (n_times, n_paths, n_tenors), tenors),
        ("surface", values (n_times, n_paths, n_tenors, n_strikes), tenors,
         strikes).
    """

    def __init__(self, dates: Sequence[date], factors: Dict[str, tuple]) -> None:
        self.dates: List[date] = list(dates)
        self.n_times = len(self.dates)
        self._factors = {}
        n_paths = None
        for name, spec in factors.items():
            kind = spec[0]
            values = np.asarray(spec[1], dtype=np.float64)
            if values.shape[0] != self.n_times:
                raise ValueError(
                    f"Factor {name!r} has {values.shape[0]} time steps, "
                    f"cube has {self.n_times}."
                )
            if n_paths is None:
                n_paths = values.shape[1]
            elif values.shape[1] != n_paths:
                raise ValueError(f"Factor {name!r} path count mismatch.")
            self._factors[name] = (kind,) + (values,) + tuple(spec[2:])
        self.n_paths = int(n_paths or 0)

    @classmethod
    def from_slices(
        cls, dates: Sequence[date], slices: Sequence[Dict[str, object]]
    ) -> "ScenarioCube":
        """Build a cube from per-date slice dicts (test/interop convenience)."""
        factors: Dict[str, tuple] = {}
        names = slices[0].keys()
        for name in names:
            first = slices[0][name]
            stacked = np.stack([np.asarray(s[name].values) for s in slices])
            if isinstance(first, SurfaceSlice):
                factors[name] = ("surface", stacked, first.tenors, first.strikes)
            elif isinstance(first, CurveSlice):
                factors[name] = ("curve", stacked, first.tenors)
            else:
                factors[name] = ("scalar", stacked)
        return cls(dates, factors)

    def factor_array(self, name: str) -> np.ndarray:
        """The full (n_times, n_paths, ...) array for one factor."""
        return self._factors[name][1]

    def get_time_slice(
        self, t: int
    ) -> Dict[str, Union[ScalarSlice, CurveSlice, SurfaceSlice]]:
        out = {}
        for name, spec in self._factors.items():
            kind, values = spec[0], spec[1]
            if kind == "scalar":
                out[name] = ScalarSlice(values=values[t])
            elif kind == "curve":
                out[name] = CurveSlice(values=values[t], tenors=spec[2])
            else:
                out[name] = SurfaceSlice(
                    values=values[t], tenors=spec[2], strikes=spec[3]
                )
        return out
