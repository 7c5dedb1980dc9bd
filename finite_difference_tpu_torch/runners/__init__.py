"""Scenario runners of the FA-validation path (counterpart of
``finite_difference_tpu.runners``, the barrier and American runners): a
config CSV of trades in, a table of model values beside Front Arena's and
their differences out, per scenario through the scalar pricers or as one
batched call. The other JAX runners (BGK, Black–Scholes, the IR swap and
XVA mains) are not ported yet."""
from .barrier_scenarios import run_all_scenarios, run_all_scenarios_batched, run_scenario
from .american_scenarios import (
    run_all_american_scenarios,
    run_all_american_scenarios_batched,
    run_american_scenario,
)

__all__ = [
    "run_all_scenarios",
    "run_all_scenarios_batched",
    "run_scenario",
    "run_all_american_scenarios",
    "run_all_american_scenarios_batched",
    "run_american_scenario",
]
