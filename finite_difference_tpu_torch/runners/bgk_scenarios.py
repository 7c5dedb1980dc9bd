"""BGK discrete-barrier scenario runner.

Counterpart of ``finite_difference_tpu.runners.bgk_scenarios``, with
capability parity with the reference's ``discrete_barrier_bgk_main.py``
(:98-121 flat curve, :123-168 monitoring dates, :197-529 scenario runner /
table / CSV): trade dicts through the ``DiscreteBarrierBGKPricer`` (auto
BGK<->MC routing) with benchmark diffs. Results are lists of row dicts with
the JAX runner's column names, written as CSV with the ``csv`` module (no
pandas); a trade that fails to price is an ``error`` row, as in the JAX
runner. The pricer runs on ``device`` (the card by default;
``device="cpu"`` or ``--cpu`` without one), resolved before any trade, so
a run asked for a card that is absent raises rather than writing error
rows.

    python -m finite_difference_tpu_torch.runners.bgk_scenarios [cfg.csv] [-o out.csv] [--cpu]
"""
from __future__ import annotations

import datetime as dt
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.analytic.bgk_pricer import DiscreteBarrierBGKPricer
from ..utils.calendars import build_monitoring_dates
from ._cli import read_rows, write_rows
from .bs_scenarios import _abs_diff, _opt_float, _pct_diff


def build_flat_curve(
    rate: float,
    val_date: dt.date,
    mat_date: dt.date,
    pad_days: int = 15,
) -> Tuple[List[str], np.ndarray]:
    """Flat NACA daily curve (discrete_barrier_bgk_main.py:98-121) as a
    ``(dates, naca)`` pair, dates "YYYY-MM-DD" from the day before
    ``val_date`` to ``pad_days`` after ``mat_date``. The JAX function
    returns a DataFrame of the same "Date" and "NACA" columns."""
    start = val_date - dt.timedelta(days=1)
    n = (mat_date + dt.timedelta(days=pad_days) - start).days + 1
    dates = [(start + dt.timedelta(days=i)).isoformat() for i in range(n)]
    return dates, np.full(n, float(rate))


def run_bgk_scenario(trade: Dict[str, Any], device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Price one discrete-barrier trade (discrete_barrier_bgk_main.py:197-365)."""
    dev = resolve_device(device)
    name = trade.get("trade_name", "unnamed")
    try:
        if trade.get("monitor_dates") is not None:
            mon_dates = list(trade["monitor_dates"])
        else:
            mon_dates = build_monitoring_dates(
                trade["valuation_date"],
                trade["maturity_date"],
                trade.get("monitor_frequency", "weekly"),
            )
        pricer = DiscreteBarrierBGKPricer(
            spot=float(trade["S"]),
            strike=float(trade["K"]),
            valuation_date=trade["valuation_date"],
            maturity_date=trade["maturity_date"],
            option_type=trade["option_type"],
            barrier_type=trade.get("barrier_type", "none"),
            lower_barrier=trade.get("lower_barrier"),
            upper_barrier=trade.get("upper_barrier"),
            monitor_dates=mon_dates,
            rebate_amount=float(trade.get("rebate_amount", 0.0)),
            rebate_at_hit=bool(trade.get("rebate_at_hit", False)),
            already_hit=bool(trade.get("already_hit", False)),
            barrier_hit_date=trade.get("barrier_hit_date"),
            discount_curve=trade["discount_curve"],
            forward_curve=trade.get("forward_curve"),
            dividend_schedule=trade.get("dividend_schedule"),
            volatility=float(trade["sigma"]),
            day_count=trade.get("day_count", "ACT/365"),
            include_expiry_monitor=bool(trade.get("include_expiry_monitor", True)),
            use_mean_sqrt_dt=bool(trade.get("use_mean_sqrt_dt", False)),
            pricing_method=trade.get("pricing_method", "auto"),
            bgk_min_freq=float(trade.get("bgk_min_freq", 20.0)),
            mc_n_paths=int(trade.get("mc_n_paths", 100_000)),
            mc_seed=trade.get("mc_seed", 42),
            mc_use_antithetic=bool(trade.get("mc_use_antithetic", True)),
            underlying_spot_days=int(trade.get("underlying_spot_days", 0)),
            option_days=int(trade.get("option_days", 0)),
            option_settlement_days=int(trade.get("option_settlement_days", 0)),
            trade_id=name,
            direction=trade.get("direction", "long"),
            quantity=int(trade.get("quantity", 1)),
            contract_multiplier=float(trade.get("contract_multiplier", 1.0)),
            device=dev,
        )
        model_price = pricer.price()
        # capture the base run's MC standard error BEFORE greeks(): each
        # bumped re-price overwrites _last_mc_std_error, so reading it
        # after would report the sigma-bumped run's SE against model_price
        mc_se = pricer._last_mc_std_error
        greeks = pricer.greeks(
            ds_rel=float(trade.get("dS_rel", 1e-4)),
            dvol_abs=float(trade.get("dVol_abs", 1e-4)),
        )
        result: Dict[str, Any] = {
            "trade_name": name,
            "barrier_type": trade.get("barrier_type", "none"),
            "pricing_method": pricer._select_method().upper(),
            "n_monitors": len(pricer.monitor_dates),
            "model_price": model_price,
            "model_delta": greeks["delta"],
            "model_gamma": greeks["gamma"],
            "model_vega": greeks["vega"],
            "mc_std_error": mc_se,
        }
        for g in ("price", "delta", "gamma", "vega"):
            bench = trade.get(f"bench_{g}")
            result[f"bench_{g}"] = bench
            result[f"{g}_abs_diff"] = _abs_diff(result[f"model_{g}"], bench)
            result[f"{g}_pct_diff"] = _pct_diff(result[f"model_{g}"], bench)
        return result
    except Exception as exc:  # runner keeps going on a bad trade (main:340-346)
        return {"trade_name": name, "error": str(exc)}


def run_all_bgk_scenarios(
    trades: List[Dict[str, Any]],
    output_csv: Optional[str] = None,
    print_results: bool = False,
    device=DEFAULT_DEVICE,
) -> List[Dict[str, Any]]:
    """Run all trades (discrete_barrier_bgk_main.py:367-423)."""
    dev = resolve_device(device)
    all_results = [run_bgk_scenario(t, device=dev) for t in trades]
    if print_results:
        for r in all_results:
            if "error" in r:
                print(f"{r['trade_name']}: ERROR {r['error']}")
            else:
                print(
                    f"{r['trade_name']}: [{r['pricing_method']}] "
                    f"price={r['model_price']:.6f}"
                )
    if output_csv:
        write_rows(all_results, output_csv)
    return all_results


def trades_from_csv(config_csv_path: str) -> List[Dict[str, Any]]:
    """Config CSV -> trade dicts for :func:`run_all_bgk_scenarios`.

    Columns: trade_name, option_type, barrier_type, S, K, sigma, rate,
    valuation, maturity; optional upper_barrier/lower_barrier/
    rebate_amount/rebate_at_hit/monitor_frequency (daily|weekly|monthly,
    default weekly)/pricing_method (auto|bgk|mc)/fwd_rate/
    underlying_spot_days/mc_n_paths/mc_seed and
    bench_price/bench_delta/bench_gamma/bench_vega diff columns. Flat
    NACA curves built like the reference main
    (discrete_barrier_bgk_main.py:98-121).
    """
    trades: List[Dict[str, Any]] = []
    for row in read_rows(config_csv_path):
        val = dt.date.fromisoformat(str(row["valuation"]))
        mat = dt.date.fromisoformat(str(row["maturity"]))
        t: Dict[str, Any] = {
            "trade_name": row.get("trade_name", "unnamed"),
            "option_type": row.get("option_type", "call"),
            "barrier_type": row.get("barrier_type", "none"),
            "S": float(row["S"]), "K": float(row["K"]),
            "sigma": float(row["sigma"]),
            "valuation_date": val, "maturity_date": mat,
            "discount_curve": build_flat_curve(float(row["rate"]), val, mat),
            "monitor_frequency": row.get("monitor_frequency", "weekly")
            or "weekly",
        }
        fwd = _opt_float(row, "fwd_rate")
        if fwd is not None:
            t["forward_curve"] = build_flat_curve(fwd, val, mat)
        for k in ("upper_barrier", "lower_barrier", "rebate_amount"):
            v = _opt_float(row, k)
            if v is not None:
                t[k] = v
        for k, cast in (
            ("rebate_at_hit", bool), ("underlying_spot_days", int),
            ("mc_n_paths", int), ("mc_seed", int), ("bgk_min_freq", float),
        ):
            v = _opt_float(row, k)
            if v is not None:
                t[k] = cast(v)
        pm = row.get("pricing_method")
        if isinstance(pm, str) and pm:
            t["pricing_method"] = pm
        for g in ("price", "delta", "gamma", "vega"):
            v = _opt_float(row, f"bench_{g}")
            if v is not None:
                t[f"bench_{g}"] = v
        trades.append(t)
    return trades


def demo_trades() -> List[Dict[str, Any]]:
    """The reference main's demo book shape (discrete_barrier_bgk_main.py:
    565-700): daily BGK route, sparse-monitor MC route, rebate, KI."""
    val, mat = dt.date(2025, 7, 28), dt.date(2026, 7, 28)
    disc = build_flat_curve(0.085, val, mat)
    return [
        {"trade_name": "T01_UAO_Call_Daily_BGK", "option_type": "call",
         "barrier_type": "up-and-out", "S": 229.74, "K": 220.0,
         "sigma": 0.32, "valuation_date": val, "maturity_date": mat,
         "discount_curve": disc, "monitor_frequency": "daily",
         "upper_barrier": 260.0},
        {"trade_name": "T02_DAO_Put_Monthly_MC", "option_type": "put",
         "barrier_type": "down-and-out", "S": 100.0, "K": 105.0,
         "sigma": 0.25, "valuation_date": val, "maturity_date": mat,
         "discount_curve": disc, "monitor_frequency": "monthly",
         "lower_barrier": 80.0, "mc_n_paths": 50_000},
        {"trade_name": "T03_UAI_Call_Weekly_Rebate", "option_type": "call",
         "barrier_type": "up-and-in", "S": 100.0, "K": 100.0,
         "sigma": 0.30, "valuation_date": val, "maturity_date": mat,
         "discount_curve": disc, "upper_barrier": 125.0,
         "rebate_amount": 2.0},
    ]


def build_parser():
    import argparse

    from ._cli import add_backend_flag

    p = argparse.ArgumentParser(
        prog="python -m finite_difference_tpu_torch.runners.bgk_scenarios",
        description="BGK/MC discrete-barrier scenario sweep: config CSV "
        "in (demo book when omitted), results CSV/table out.",
    )
    p.add_argument("config_csv", nargs="?", default=None)
    p.add_argument("-o", "--output", default=None, help="results CSV path")
    add_backend_flag(p)
    return p


def main(argv=None) -> List[Dict[str, Any]]:
    from ._cli import device_of

    args = build_parser().parse_args(argv)
    trades = (
        trades_from_csv(args.config_csv) if args.config_csv else demo_trades()
    )
    return run_all_bgk_scenarios(trades, output_csv=args.output, print_results=True,
                                 device=device_of(args))


if __name__ == "__main__":
    main()
