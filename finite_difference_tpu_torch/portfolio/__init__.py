"""Portfolio layer: netting sets, trades, CSA terms (host) and the SIMM
delta-margin aggregation (torch tensors), the port of
``finite_difference_tpu.portfolio``.
"""
from .csa import CSA, CloseOutMethod, InitialMarginMethod
from .netting_set import NettingSet, Trade
from .simm import SimmConfig, SimmParams, simm_im

__all__ = [
    "CSA",
    "CloseOutMethod",
    "InitialMarginMethod",
    "NettingSet",
    "Trade",
    "SimmConfig",
    "SimmParams",
    "simm_im",
]
