"""Netting sets and trades (the port's copy of
``finite_difference_tpu.portfolio.netting_set``, host numpy).

Reconstruction of the absent ``portfolio/netting_set.py`` from
exposure_engine.py:104-201: a netting set groups trades (instrument,
trade_id, currency, optional FX factor for cross-currency conversion,
notional scale) under a reporting currency and an optional CSA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .csa import CSA


@dataclass
class Trade:
    instrument: object
    trade_id: str
    currency: str = "ZAR"
    fx_rate_factor: Optional[str] = None
    notional_scale: float = 1.0


@dataclass
class NettingSet:
    netting_set_id: str
    trades: List[Trade]
    reporting_currency: str = "ZAR"
    csa: Optional[CSA] = None
