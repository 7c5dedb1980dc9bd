"""Batched Crank–Nicolson barrier and American pricing (counterpart of ``finite_difference_tpu.models.pde``).

- :mod:`.grid` — host numpy grids and schedules;
- :mod:`.batch` — the trade batch, ``build_trade_batch`` /
  ``price_barrier_batch`` and ``build_american_batch`` /
  ``price_american_batch`` (the main paths), ``solve_value_surfaces``;
- :mod:`.stepper` — the batched CN step loop (``solver="scan"``);
- :mod:`.spectral` — the sine-basis propagator (``solver="spectral"``,
  ``"spectral_x64dst"``, ``"spectral_mixed"``): DST matmuls between monitor
  dates;
- :mod:`.spike` — the SPIKE march host prep, its plain reference and the
  dispatch to the CUDA kernel (``solver="spike"``);
- :mod:`.fused` — the fused march with Hillis–Steele scans
  (``price_barrier_batch_fused``, ``cn_barrier_solve_fused``);
- :mod:`.cr` — the fused march with cyclic reduction
  (``cn_barrier_solve_cr``);
- the scalar pricers of the FA-validation path, each trade one batched
  scan over its sigma bumps: :mod:`.american` (``AmericanFDMPricer``),
  :mod:`.american_black76`, :mod:`.barrier` (``DiscreteBarrierFDMPricer``),
  :mod:`.vanilla_fis`, :mod:`.cn_log`, :mod:`.hybrid`, and :mod:`.risk`'s
  spot-scenario functions;
- the FA-validation tools: :mod:`.fis_stencil` (FIS's S-space stencil,
  ``DiscreteBarrierFDMPricer2``), :mod:`.crosscheck` (the independent
  engine) and :mod:`.order_accuracy` (convergence-order diagnostics).
"""
from .stepper import BarrierSpec, CNDynamics, CNGrid, CNSchedule, cn_solve
from .american import AmericanFDMPricer
from .american_black76 import AmericanFwdFDMPricer
from .barrier import DiscreteBarrierFDMPricer
from .cn_log import DiscreteBarrierCrankNicolsonLog
from .hybrid import DiscreteBarrierFDMPricerAnalytic
from .crosscheck import MarketParams, QLDiscreteBarrierPricer, fis_time_steps
from .fis_stencil import DiscreteBarrierFDMPricer2
from .vanilla_fis import VanillaOptionPricerFIS
from .risk import front_arena_style_spot_curve, risk_reprice_spot, risk_spot_scenario
from .order_accuracy import (
    compute_empirical_order,
    diagnose_order_of_accuracy,
    greek_order_of_accuracy,
    predict_truncation_error,
)
from .spectral import spectral_solve

__all__ = [
    "spectral_solve",
    "CNDynamics",
    "CNGrid",
    "CNSchedule",
    "BarrierSpec",
    "cn_solve",
    "AmericanFDMPricer",
    "AmericanFwdFDMPricer",
    "DiscreteBarrierFDMPricer",
    "DiscreteBarrierCrankNicolsonLog",
    "DiscreteBarrierFDMPricerAnalytic",
    "MarketParams",
    "QLDiscreteBarrierPricer",
    "fis_time_steps",
    "DiscreteBarrierFDMPricer2",
    "VanillaOptionPricerFIS",
    "front_arena_style_spot_curve",
    "risk_reprice_spot",
    "risk_spot_scenario",
    "compute_empirical_order",
    "diagnose_order_of_accuracy",
    "greek_order_of_accuracy",
    "predict_truncation_error",
]
