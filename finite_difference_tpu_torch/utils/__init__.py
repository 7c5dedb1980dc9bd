"""Host utilities of the port (counterpart of ``finite_difference_tpu.utils``):
dates, day counts, the South African calendar, rate conversions, the
daily NACA curves and the NACC zero curve, all without pandas; the
profiling harness (``torch.profiler``) and the matplotlib plots."""
from .dates import to_date, day_offset, add_days, ensure_dates
from .daycount import year_fraction, year_denominator
from .calendars import SouthAfricaCalendar, build_monitoring_dates
from .rates import nacc_to_naca, naca_to_nacc, discount_factor
from .curves import (
    DailyNacaCurve,
    NacaCurve,
    create_rate_df,
    flat_curve,
    flat_naca_dataframe,
    load_curve_csv,
)
from .zero_curve import ZeroCurve
from .zero_curve import discount_factor as discount_factor_methods
from .profiling import throughput, trace
from .plotting import plot_convergence, plot_exposure_profile, plot_path_fan

__all__ = [
    "to_date",
    "day_offset",
    "add_days",
    "ensure_dates",
    "year_fraction",
    "year_denominator",
    "SouthAfricaCalendar",
    "build_monitoring_dates",
    "nacc_to_naca",
    "naca_to_nacc",
    "discount_factor",
    "discount_factor_methods",
    "DailyNacaCurve",
    "NacaCurve",
    "create_rate_df",
    "flat_curve",
    "flat_naca_dataframe",
    "load_curve_csv",
    "ZeroCurve",
    "throughput",
    "trace",
]
