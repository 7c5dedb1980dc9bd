"""Bjerksund-Stensland scenario runner.

Counterpart of ``finite_difference_tpu.runners.bs_scenarios``, with
capability parity with the reference's ``bjerksund_stensland_main.py:77-393``:
trade dicts priced through the simple (float T/r) or curve-based path, with
benchmark diffs and CSV export. Results are lists of row dicts with the
JAX runner's column names, written as CSV with the ``csv`` module (no
pandas). The closed form runs on ``device`` (the card by default;
``device="cpu"`` or ``--cpu`` without one).

    python -m finite_difference_tpu_torch.runners.bs_scenarios [cfg.csv] [-o out.csv] [--cpu]
"""
from __future__ import annotations

import datetime as dt
import math
from typing import Any, Dict, List, Optional

from ..device import DEFAULT_DEVICE
from ..models.analytic.bs_forward import BjerksundStenslandForwardPricer
from ._cli import read_rows, write_rows


def _abs_diff(model: float, bench: Optional[float]) -> Optional[float]:
    if bench is None or (isinstance(bench, float) and math.isnan(bench)):
        return None
    return abs(model - bench)


def _pct_diff(model: float, bench: Optional[float]) -> Optional[float]:
    if bench is None or (isinstance(bench, float) and math.isnan(bench)) or bench == 0.0:
        return None
    return abs(model - bench) / abs(bench) * 100.0


def run_bs_scenario(trade: Dict[str, Any], device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Price one trade (bjerksund_stensland_main.py:136-274).

    Curve path when 'discount_curve' is present; simple path otherwise.
    """
    name = trade.get("trade_name", "unnamed")
    pricer = BjerksundStenslandForwardPricer(device=device)
    S = float(trade["S"])
    K = float(trade["K"])
    sigma = float(trade["sigma"])
    opt_type = trade.get("option_type", "call")
    dS = float(trade.get("dS", 1e-4))
    dSigma = float(trade.get("dSigma", 1e-4))

    if "discount_curve" in trade:
        kwargs = dict(
            discount_curve=trade["discount_curve"],
            forward_curve=trade.get("forward_curve"),
            dividend_schedule=trade.get("dividend_schedule"),
            underlying_spot_days=int(trade.get("underlying_spot_days", 0)),
            option_days=int(trade.get("option_days", 0)),
            option_settlement_days=int(trade.get("option_settlement_days", 0)),
            day_count=trade.get("day_count", "ACT/365"),
        )
        price_result = pricer.price_from_curves(
            S, K, trade["valuation_date"], trade["maturity_date"], sigma,
            opt_type, **kwargs,
        )
        greek_result = pricer.greeks_from_curves(
            S, K, trade["valuation_date"], trade["maturity_date"], sigma,
            opt_type, dS=dS, dSigma=dSigma, **kwargs,
        )
        resolved = {k: price_result[k] for k in (
            "T_exp", "T_carry", "T_disc", "carry_rate", "disc_rate", "F_eff", "b",
        )}
        path = "curve"
    else:
        if trade.get("T") is not None:
            T_exp = float(trade["T"])
        elif "valuation_date" in trade and "maturity_date" in trade:
            T_exp = max(
                (trade["maturity_date"] - trade["valuation_date"]).days / 365.0, 0.0
            )
        else:
            raise ValueError(
                f"Trade {name!r}: supply 'T', dates, or 'discount_curve'."
            )
        r = float(trade["r"])
        F_arg, q_arg, divs_arg = trade.get("F"), trade.get("q"), trade.get("dividends")
        price_result = pricer.price(S, K, T_exp, r, sigma, opt_type, F_arg, q_arg, divs_arg)
        greek_result = pricer.greeks(
            S, K, T_exp, r, sigma, opt_type, F_arg, q_arg, divs_arg,
            dS=dS, dSigma=dSigma,
        )
        F_eff = pricer._resolve_forward(S, r, T_exp, F_arg, q_arg, divs_arg)
        resolved = {
            "T_exp": T_exp, "T_carry": T_exp, "T_disc": T_exp,
            "carry_rate": r, "disc_rate": r, "F_eff": F_eff,
            "b": math.log(max(F_eff, 1e-15) / max(S, 1e-15)) / max(T_exp, 1e-12),
        }
        path = "simple"

    result: Dict[str, Any] = {
        "trade_name": name,
        "option_type": opt_type,
        "path": path,
        "S": S,
        "K": K,
        "sigma": sigma,
        "early_exercise": price_result.get("early_exercise", 0.0),
        "model_price": price_result["price"],
        "model_delta": greek_result["delta"],
        "model_gamma": greek_result["gamma"],
        "model_vega": greek_result["vega"],
    }
    result.update(resolved)
    for g in ("price", "delta", "gamma", "vega"):
        bench = trade.get(f"bench_{g}")
        result[f"bench_{g}"] = bench
        result[f"{g}_abs_diff"] = _abs_diff(result[f"model_{g}"], bench)
        result[f"{g}_pct_diff"] = _pct_diff(result[f"model_{g}"], bench)
    return result


def run_all_bs_scenarios(
    trades: List[Dict[str, Any]],
    output_csv: Optional[str] = None,
    print_results: bool = False,
    device=DEFAULT_DEVICE,
) -> List[Dict[str, Any]]:
    """Run all trades; optional CSV (bjerksund_stensland_main.py:276-321)."""
    all_results = [run_bs_scenario(trade, device=device) for trade in trades]
    if print_results:
        for r in all_results:
            print(
                f"{r['trade_name']}: price={r['model_price']:.4f} "
                f"delta={r['model_delta']:.4f}"
            )
    if output_csv:
        write_rows(all_results, output_csv)
    return all_results


def _opt_float(row: Dict[str, Any], key: str) -> Optional[float]:
    v = row.get(key)
    if v is None or (isinstance(v, float) and math.isnan(v)) or v == "":
        return None
    return float(v)


def trades_from_csv(config_csv_path: str) -> List[Dict[str, Any]]:
    """Config CSV -> trade dicts for :func:`run_all_bs_scenarios`.

    Columns: trade_name, option_type, S, K, sigma, then EITHER the simple
    path (T, r, optional q/F) or the curve path (valuation, maturity,
    rate, optional fwd_rate — flat NACA curves built like the reference
    main's build_flat_curve, bjerksund_stensland_main.py:95-121).
    Optional bench_price/bench_delta/bench_gamma/bench_vega diff columns.
    """
    from .bgk_scenarios import build_flat_curve

    trades: List[Dict[str, Any]] = []
    for row in read_rows(config_csv_path):
        t: Dict[str, Any] = {
            "trade_name": row.get("trade_name", "unnamed"),
            "option_type": row.get("option_type", "call"),
            "S": float(row["S"]), "K": float(row["K"]),
            "sigma": float(row["sigma"]),
        }
        rate = _opt_float(row, "rate")
        if rate is not None:
            val = dt.date.fromisoformat(str(row["valuation"]))
            mat = dt.date.fromisoformat(str(row["maturity"]))
            t.update(
                valuation_date=val, maturity_date=mat,
                discount_curve=build_flat_curve(rate, val, mat),
            )
            fwd = _opt_float(row, "fwd_rate")
            if fwd is not None:
                t["forward_curve"] = build_flat_curve(fwd, val, mat)
        else:
            t["T"] = float(row["T"])
            t["r"] = float(row["r"])
            for k in ("q", "F"):
                v = _opt_float(row, k)
                if v is not None:
                    t[k] = v
        for g in ("price", "delta", "gamma", "vega"):
            v = _opt_float(row, f"bench_{g}")
            if v is not None:
                t[f"bench_{g}"] = v
        trades.append(t)
    return trades


def demo_trades() -> List[Dict[str, Any]]:
    """The reference main's demo book shape (bjerksund_stensland_main.py:
    424-529): simple/curve paths, dividend yield, explicit forward."""
    from .bgk_scenarios import build_flat_curve

    val, mat = dt.date(2025, 8, 28), dt.date(2026, 8, 28)
    curve = build_flat_curve(0.07, val, mat)
    return [
        {"trade_name": "ATM_Call_1Y_simple", "option_type": "call",
         "S": 100.0, "K": 100.0, "T": 1.0, "r": 0.07, "sigma": 0.25},
        {"trade_name": "ITM_Put_DivYield_simple", "option_type": "put",
         "S": 110.0, "K": 100.0, "T": 0.5, "r": 0.06, "sigma": 0.30,
         "q": 0.02},
        {"trade_name": "Fwd_Override_simple", "option_type": "call",
         "S": 95.0, "K": 100.0, "T": 0.75, "r": 0.065, "sigma": 0.28,
         "F": 99.5},
        {"trade_name": "ATM_Put_1Y_curve", "option_type": "put",
         "S": 100.0, "K": 100.0, "sigma": 0.25, "valuation_date": val,
         "maturity_date": mat, "discount_curve": curve},
    ]


def build_parser():
    import argparse

    from ._cli import add_backend_flag

    p = argparse.ArgumentParser(
        prog="python -m finite_difference_tpu_torch.runners.bs_scenarios",
        description="Bjerksund-Stensland scenario sweep: config CSV in "
        "(demo book when omitted), results CSV/table out.",
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
    return run_all_bs_scenarios(trades, output_csv=args.output, print_results=True,
                                device=device_of(args))


if __name__ == "__main__":
    main()
