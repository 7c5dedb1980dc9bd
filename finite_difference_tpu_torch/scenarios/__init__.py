"""RiskFlow-style scenario generation (the port of
``finite_difference_tpu.scenarios``).

Capability parity with the reference's ``cs_simulation.py`` (the RiskFlow
scenario-generation replica): time-grid-string parsing, CVAMarketData JSON
loading, Clewlow-Strickland precalculate/generate, correlation Cholesky with
eigenvalue healing, batch simulation drivers, the RiskFlow scenario frame
round-trip, a scenario-output comparator, the diagnostics and the joint
multi-factor cube.

Host/device split: JSON, dates, grid parsing, the (tiny) vol/drift
precompute, frames and diagnostics stay on the host in numpy; the normals
and the (n_steps, n_tenors, n_scenarios) path generation run on
``device`` (``cuda`` unless the caller passes ``"cpu"``) as torch ops.
Dates are ``datetime.date``, scenario frames
:class:`riskflow_io.ScenarioFrame`, tables lists of row dicts.
"""
from .time_grid import (
    DAYS_IN_YEAR,
    EXCEL_OFFSET,
    excel_days_to_date,
    date_to_excel_days,
    parse_offset,
    parse_time_grid,
)
from .market_data import (
    load_market_data,
    extract_forward_curve,
    extract_model_params,
    extract_correlations,
)
from .simulation import (
    build_cholesky,
    generate_random_numbers,
    generate_paths,
    precalculate,
    run_simulation_from_json,
    run_multi_factor_simulation_from_json,
)
from .joint_cube import (
    GBMScalarFactor,
    HW1FCurveFactor,
    simulate_joint_cube,
)
from .diagnostics import (
    correlation_recovery,
    cs_log_variance,
    cs_theoretical_log_moments,
    cs_theoretical_price_moments,
    martingale_test,
    moment_matching,
    parameter_recovery,
    run_full_diagnostics,
    tail_analysis,
)
from .riskflow_io import (
    to_riskflow_dataframe,
    from_riskflow_dataframe,
    export_scenarios_csv,
    load_riskflow_scenarios,
    load_scenarios_csv,
    compare_scenario_outputs,
)

__all__ = [
    "DAYS_IN_YEAR",
    "EXCEL_OFFSET",
    "excel_days_to_date",
    "date_to_excel_days",
    "parse_offset",
    "parse_time_grid",
    "load_market_data",
    "extract_forward_curve",
    "extract_model_params",
    "extract_correlations",
    "build_cholesky",
    "generate_random_numbers",
    "generate_paths",
    "precalculate",
    "run_simulation_from_json",
    "run_multi_factor_simulation_from_json",
    "to_riskflow_dataframe",
    "from_riskflow_dataframe",
    "export_scenarios_csv",
    "load_riskflow_scenarios",
    "load_scenarios_csv",
    "compare_scenario_outputs",
    "correlation_recovery",
    "cs_log_variance",
    "cs_theoretical_log_moments",
    "cs_theoretical_price_moments",
    "martingale_test",
    "moment_matching",
    "parameter_recovery",
    "run_full_diagnostics",
    "tail_analysis",
    "GBMScalarFactor",
    "HW1FCurveFactor",
    "simulate_joint_cube",
]
