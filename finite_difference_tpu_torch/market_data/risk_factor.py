"""Typed per-date risk-factor slices (the port's copy of
``finite_difference_tpu.market_data.risk_factor``, host numpy).

Reconstruction of the reference's absent ``market_data/risk_factor.py``
(interfaces recovered from call sites: exposure_engine.py:10,46-59,
ir_swap.py:243-252, equity_trs.py:443-466):

- ``ScalarSlice.values``  : (n_paths,)
- ``CurveSlice.values``   : (n_paths, n_tenors) with ``tenors`` year fracs
- ``SurfaceSlice.values`` : (n_paths, n_tenors, n_strikes) with ``tenors``
  and ``strikes``

Values are plain numpy on the host boundary; pricing kernels lift them to
device. 1-D curve input is normalised to (1, n_tenors) so deterministic
(single-state) pricing reuses the pathwise code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ScalarSlice:
    values: np.ndarray  # (n_paths,)

    def __post_init__(self):
        self.values = np.atleast_1d(np.asarray(self.values, dtype=np.float64))

    @property
    def n_paths(self) -> int:
        return self.values.shape[0]


@dataclass
class CurveSlice:
    values: np.ndarray  # (n_paths, n_tenors)
    tenors: np.ndarray  # (n_tenors,) year fractions

    def __post_init__(self):
        v = np.asarray(self.values, dtype=np.float64)
        if v.ndim == 1:
            v = v[None, :]
        self.values = v
        self.tenors = np.asarray(self.tenors, dtype=np.float64)
        if self.values.shape[1] != self.tenors.shape[0]:
            raise ValueError(
                f"CurveSlice values {self.values.shape} do not match "
                f"{self.tenors.shape[0]} tenors."
            )

    @property
    def n_paths(self) -> int:
        return self.values.shape[0]


@dataclass
class SurfaceSlice:
    values: np.ndarray  # (n_paths, n_tenors, n_strikes)
    tenors: np.ndarray
    strikes: np.ndarray

    def __post_init__(self):
        v = np.asarray(self.values, dtype=np.float64)
        if v.ndim == 2:
            v = v[None, :, :]
        self.values = v
        self.tenors = np.asarray(self.tenors, dtype=np.float64)
        self.strikes = np.asarray(self.strikes, dtype=np.float64)

    @property
    def n_paths(self) -> int:
        return self.values.shape[0]


RiskFactorSlice = (ScalarSlice, CurveSlice, SurfaceSlice)
