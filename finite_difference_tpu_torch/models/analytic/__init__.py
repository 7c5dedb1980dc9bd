"""Closed-form pricers on torch tensors (counterpart of ``finite_difference_tpu.models.analytic``).

Black–Scholes, Reiner–Rubinstein, the double barrier, BGK/Hörfelt,
Bjerksund–Stensland 1993 and 2002 and the batched sweeps over trade tables
(the serving layer's), and the FA-validation tools: the date-driven BGK
and Bjerksund–Stensland forward pricers and the implied-vol inverse.
"""
from .black_scholes import (
    bs_price,
    bs_greeks,
    black76_price,
    black76_greeks,
    generalized_bs_greeks,
    generalized_bs_price,
)
from .reiner_rubinstein import BarrierEngine, barrier_price, barrier_factors
from .double_barrier import DoubleBarrier, double_barrier_price, double_barrier_ko_price
from .bjerksund_stensland import (
    BjerksundStenslandOptionPricer,
    american_call_bs93,
    american_put_bs93,
    american_price_bs93,
)
from .bgk_pricer import DiscreteBarrierBGKPricer
from .bs_forward import BjerksundStenslandForwardPricer
from .bjerksund_stensland_2002 import (
    BjerksundStensland2002Pricer,
    american_call_single_2002,
    american_call_two_step_2002,
    boundary_XT,
)
from .batch import (
    continuous_barrier_sweep,
    continuous_barrier_sweep_greeks,
    bgk_discrete_sweep,
    bs93_sweep,
    bs93_sweep_greeks,
    bs2002_sweep,
    monitoring_decision,
)
from .implied_vol import implied_vol_black76, implied_vol_bs

__all__ = [
    "implied_vol_black76",
    "implied_vol_bs",
    "bs_price",
    "bs_greeks",
    "black76_price",
    "black76_greeks",
    "generalized_bs_greeks",
    "generalized_bs_price",
    "BarrierEngine",
    "barrier_price",
    "barrier_factors",
    "DoubleBarrier",
    "double_barrier_price",
    "double_barrier_ko_price",
    "BjerksundStenslandOptionPricer",
    "american_call_bs93",
    "american_put_bs93",
    "american_price_bs93",
    "DiscreteBarrierBGKPricer",
    "BjerksundStenslandForwardPricer",
    "BjerksundStensland2002Pricer",
    "american_call_single_2002",
    "american_call_two_step_2002",
    "boundary_XT",
    "continuous_barrier_sweep",
    "continuous_barrier_sweep_greeks",
    "bgk_discrete_sweep",
    "bs93_sweep",
    "bs93_sweep_greeks",
    "bs2002_sweep",
    "monitoring_decision",
]
