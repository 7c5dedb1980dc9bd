"""Scenario runners of the FA-validation path (counterpart of
``finite_difference_tpu.runners``): a config CSV of trades in, a table of
model values beside Front Arena's (or a benchmark's) and their differences
out. The barrier and American runners price per scenario through the
scalar pricers or as one batched call; the Bjerksund–Stensland and BGK
runners price trade dicts through their closed-form pricers; ``run_asset``
runs one commodity asset's CVA through the commodity XVA engine; the IR
swap FA check prices a ZAR swap's legs on synthetic hermite-RT curves
against FA's figures."""
from .barrier_scenarios import run_all_scenarios, run_all_scenarios_batched, run_scenario
from .american_scenarios import (
    run_all_american_scenarios,
    run_all_american_scenarios_batched,
    run_american_scenario,
)
from .bs_scenarios import run_all_bs_scenarios, run_bs_scenario
from .bgk_scenarios import build_flat_curve, run_all_bgk_scenarios, run_bgk_scenario
from .xva_main import run_asset
from .irswap_fa import IRSwapFAPricer, run_irswap_fa_check, synthetic_zar_curves

__all__ = [
    "run_all_scenarios",
    "run_all_scenarios_batched",
    "run_scenario",
    "run_all_american_scenarios",
    "run_all_american_scenarios_batched",
    "run_american_scenario",
    "run_all_bs_scenarios",
    "run_bs_scenario",
    "build_flat_curve",
    "run_all_bgk_scenarios",
    "run_bgk_scenario",
    "run_asset",
    "IRSwapFAPricer",
    "run_irswap_fa_check",
    "synthetic_zar_curves",
]
