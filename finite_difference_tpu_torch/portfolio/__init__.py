"""Portfolio layer: netting sets, trades, CSA terms (the port of
``finite_difference_tpu.portfolio``, host). SIMM (``portfolio.simm``)
comes with ROADMAP.md queue 1 item 4b.
"""
from .csa import CSA, CloseOutMethod, InitialMarginMethod
from .netting_set import NettingSet, Trade

__all__ = [
    "CSA",
    "CloseOutMethod",
    "InitialMarginMethod",
    "NettingSet",
    "Trade",
]
