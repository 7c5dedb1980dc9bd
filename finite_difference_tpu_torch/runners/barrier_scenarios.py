"""Barrier scenario runner: config CSV -> diff-vs-FA results CSV.

Counterpart of ``finite_difference_tpu.runners.barrier_scenarios``, with
capability parity with the reference's ``run_config_scenarios.py:9-199``
(per-scenario ``DiscreteBarrierFDMPricer`` pricing with FA price/greek
diffs), plus the batched path: ``run_all_scenarios_batched`` prices the
whole scenario table in one ``price_barrier_batch`` call.

The tables are lists of row dicts with the JAX runners' column names, read
and written as CSV with the ``csv`` module (no pandas). Every entry point
runs on ``device`` (the card by default; ``device="cpu"`` or ``--cpu``
without one).

    python -m finite_difference_tpu_torch.runners.barrier_scenarios cfg.csv [--batched] [-o out.csv] [--cpu]
"""
from __future__ import annotations

import datetime as dt
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.pde.barrier import DiscreteBarrierFDMPricer
from ..parallel.mesh import check_mesh
from ..utils.curves import flat_curve
from ..utils.rates import naca_to_nacc
from ._cli import Row, diff_block, read_rows, write_rows


def run_scenario(
    scenario_name: str,
    S0: float,
    K: float,
    sigma: float,
    rate: float,
    barrier_type: str,
    upper_barrier: Optional[float],
    lower_barrier: Optional[float],
    FA_price: Optional[float],
    FA_delta: Optional[float],
    FA_gamma: Optional[float],
    FA_vega: Optional[float],
    *,
    valuation: dt.date,
    maturity: dt.date,
    monitor_dates: List[dt.date],
    opt_type: str = "call",
    trade_number: int = 201871103,
    quantity: int = 1000,
    contract_size: int = 1,
    position: str = "long",
    divs: Optional[list] = None,
    rebate_amount: float = 0.0,
    rebate_at_hit: bool = True,
    use_one_sided_greeks_near_barrier: bool = False,
    already_hit: bool = False,
    already_in: bool = False,
    underlying_spot_days: int = 0,
    option_days: int = 0,
    option_settlement_days: int = 0,
    day_count: str = "ACT/365",
    grid_type: str = "uniform",
    num_space_nodes: int = 500,
    num_time_steps: int = 500,
    device=DEFAULT_DEVICE,
) -> Row:
    """One scenario through the CN pricer (run_config_scenarios.py:9-133)."""
    curve = flat_curve(rate, valuation)
    pricer = DiscreteBarrierFDMPricer(
        spot=S0,
        strike=K,
        valuation_date=valuation,
        maturity_date=maturity,
        sigma=sigma,
        option_type=opt_type,
        barrier_type=barrier_type,
        lower_barrier=lower_barrier,
        upper_barrier=upper_barrier,
        already_in=already_in,
        already_hit=already_hit,
        monitor_dates=monitor_dates,
        discount_curve=curve,
        forward_curve=curve,
        dividend_schedule=divs or [],
        trade_id=trade_number,
        direction=position,
        quantity=quantity,
        underlying_spot_days=underlying_spot_days,
        option_days=option_days,
        option_settlement_days=option_settlement_days,
        rebate_amount=rebate_amount,
        rebate_at_hit=rebate_at_hit,
        contract_multiplier=contract_size,
        use_one_sided_greeks_near_barrier=use_one_sided_greeks_near_barrier,
        num_space_nodes=num_space_nodes,
        num_time_steps=num_time_steps,
        grid_type=grid_type,
        rannacher_steps=2,
        day_count=day_count,
        device=device,
    )
    model_price = pricer.price_log2()
    greeks = pricer.greeks_log2()

    results: Row = {
        "scenario_name": scenario_name,
        "S0": S0,
        "K": K,
        "sigma": sigma,
        "rate": rate,
        "barrier_type": barrier_type,
        "upper_barrier": upper_barrier if upper_barrier is not None else math.nan,
        "lower_barrier": lower_barrier if lower_barrier is not None else math.nan,
    }
    results.update(diff_block("price", model_price, FA_price))
    results.update(diff_block("delta", greeks["delta"], FA_delta))
    results.update(diff_block("gamma", greeks["gamma"], FA_gamma))
    results.update(diff_block("vega", greeks["vega"], FA_vega))
    return results


def run_all_scenarios(
    config_csv_path: str,
    output_csv_path: Optional[str],
    base_params: Dict[str, Any],
    verbose: bool = False,
    device=DEFAULT_DEVICE,
) -> List[Row]:
    """Config CSV in, diff table out (run_config_scenarios.py:137-199)."""
    all_results = []
    for row in read_rows(config_csv_path):
        result = run_scenario(
            scenario_name=row["scenario_name"],
            S0=row["S0"],
            K=row["K"],
            sigma=row["sigma"],
            rate=row["rate"],
            barrier_type=row["barrier_type"],
            upper_barrier=row["upper_barrier"],
            lower_barrier=row["lower_barrier"],
            FA_price=row["FA_price"],
            FA_delta=row["FA_delta"],
            FA_gamma=row["FA_gamma"],
            FA_vega=row["FA_vega"],
            device=device,
            **base_params,
        )
        all_results.append(result)
        if verbose:
            print(
                f"{result['scenario_name']}: price %diff "
                f"{result['price_pct_diff']:.4f}%"
            )
    if output_csv_path:
        write_rows(all_results, output_csv_path)
    return all_results


def run_all_scenarios_batched(
    config_csv_path: str,
    output_csv_path: Optional[str],
    base_params: Dict[str, Any],
    mesh=None,
    num_space_nodes: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    route: str = "pde",
    schedule: str = "uniform",
    device=DEFAULT_DEVICE,
) -> List[Row]:
    """The whole scenario table as one batched call on ``device``.

    Uses the same flat-curve/time-measure resolution as the per-scenario
    runner, then prices with ``price_barrier_batch`` (its ``auto`` route).
    KI prices come from in-out parity against the Black-76 vanilla,
    computed for the whole table at once. ``mesh`` (a ``parallel.Mesh``, a
    device count or a list of device names, of ``device``'s type;
    ``parallel.mesh.check_mesh``) splits the CN batch's trades over its
    ``"data"`` axis; anything else but None raises ValueError.

    ``route='hybrid'`` applies the FIS n_lim monitoring decision per trade
    (discrete_barrier_analytic_pricer.py:278-342): continuous-regime trades
    go to the batched analytic sweep with BGK-shifted barriers
    (models.analytic.batch), the rest to the CN batch. ``route='pde'``
    sends everything through the CN batch.

    ``schedule='monitor-aligned'`` builds the reference CN auto-grid's
    ">= 10 steps per monitor interval" time layout (per-interval constant
    dt, monitors exactly on step boundaries — grid.monitor_aligned_schedule)
    instead of the uniform grid with floor-snapped monitor indices.
    """
    from ..models.analytic.batch import continuous_barrier_sweep_greeks, monitoring_decision
    from ..models.analytic.black_scholes import black76_price
    from ..models.pde.batch import build_trade_batch, price_barrier_batch
    from ..utils.daycount import year_fraction

    dev = resolve_device(device)
    mesh = check_mesh(mesh, dev)
    rows = read_rows(config_csv_path)
    valuation = base_params["valuation"]
    maturity = base_params["maturity"]
    monitor_dates = base_params["monitor_dates"]
    opt_type = base_params.get("opt_type", "call")
    n_time = base_params.get("num_time_steps", 500)
    n_nodes = num_space_nodes or base_params.get("num_space_nodes", 500)
    rebate_amount = float(base_params.get("rebate_amount", 0.0))
    rebate_at_hit = bool(base_params.get("rebate_at_hit", True))
    # base_params the batch container cannot express must fail loudly —
    # the per-scenario runner honors them, so silently dropping them
    # would make the batched path quietly price a different trade
    for key in (
        "divs", "already_hit", "already_in", "underlying_spot_days",
        "option_days", "option_settlement_days",
    ):
        if base_params.get(key):
            raise ValueError(
                f"batched barrier runner does not support {key}; use "
                "run_all_scenarios (the per-scenario path)"
            )
    if base_params.get("grid_type", "uniform") != "uniform":
        raise ValueError(
            "batched barrier runner only supports grid_type='uniform'; "
            "use run_all_scenarios"
        )
    if route not in ("pde", "hybrid"):
        raise ValueError(f"route must be 'pde' or 'hybrid', got {route!r}")

    day_count = base_params.get("day_count", "ACT/365")
    t_exp = year_fraction(valuation, maturity, day_count)
    monitor_times = [
        year_fraction(valuation, d, day_count) for d in monitor_dates if valuation < d <= maturity
    ]
    # the scalar engine ALWAYS monitors at expiry
    # (DiscreteBarrierFDMPricer._build_monitor_times, mirroring the reference)
    if monitor_times and monitor_times[-1] < t_exp - 1e-14:
        monitor_times.append(t_exp)

    B = len(rows)
    uppers, lowers, is_in = [], [], []
    for row in rows:
        bt = str(row["barrier_type"])
        is_in.append("in" in bt)
        uppers.append(None if "down" in bt else row["upper_barrier"])
        lowers.append(None if "up" in bt else row["lower_barrier"])
    is_in = np.array(is_in, dtype=bool)
    nacc = np.array([naca_to_nacc(row["rate"]) for row in rows], dtype=np.float64)
    spots = np.array([row["S0"] for row in rows], dtype=np.float64)
    strikes = np.array([row["K"] for row in rows], dtype=np.float64)
    sigmas = np.array([row["sigma"] for row in rows], dtype=np.float64)

    if route == "hybrid" and not rebate_amount:
        use_cont, bgk_adj = monitoring_decision(np.full(B, t_exp), [monitor_times] * B, sigmas)
    else:
        # the continuous analytic sweep carries no rebate leg; keep
        # rebate-bearing tables on the CN batch (which does)
        use_cont, bgk_adj = np.zeros(B, dtype=bool), np.ones(B)
    pde_idx = np.where(~use_cont)[0]
    cont_idx = np.where(use_cont)[0]

    out = {k: np.zeros(B) for k in ("price", "delta", "gamma", "vega")}
    if len(pde_idx):
        sub = lambda seq: [seq[i] for i in pde_idx]
        tb = build_trade_batch(
            spots=sub(spots),
            strikes=sub(strikes),
            sigmas=sub(sigmas),
            t_expiry=[t_exp] * len(pde_idx),
            r=sub(nacc),
            b=sub(nacc),
            is_call=[opt_type == "call"] * len(pde_idx),
            n_time_steps=n_time,
            monitor_times=[monitor_times] * len(pde_idx),
            lower=sub(lowers),
            upper=sub(uppers),
            rebate=[rebate_amount] * len(pde_idx),
            # the IN parity complement must carry the rebate at EXPIRY
            # (KI(R) = vanilla - KO(R at expiry) + R*DF, barrier.price_log2)
            rebate_at_hit=[rebate_at_hit and not is_in[i] for i in pde_idx],
            num_space_nodes=n_nodes,
            dtype=dtype,
            monitor_aligned=(schedule == "monitor-aligned"),
            device=dev,
        )
        res = price_barrier_batch(tb, n_nodes=n_nodes + 1, mesh=mesh, device=dev)
        for k in out:
            out[k][pde_idx] = res[k].double().cpu().numpy()

    if len(cont_idx):
        # continuous regime: analytic sweep with BGK-shifted barriers
        # (H_lo/adj, H_up*adj); IN trades price directly (RR is_in), so no
        # parity fix-up is needed for these lanes.
        g = continuous_barrier_sweep_greeks(
            spots[cont_idx], strikes[cont_idx], t_exp, nacc[cont_idx], nacc[cont_idx],
            sigmas[cont_idx],
            lower=[None if lowers[i] is None else lowers[i] / bgk_adj[i] for i in cont_idx],
            upper=[None if uppers[i] is None else uppers[i] * bgk_adj[i] for i in cont_idx],
            is_call=np.full(len(cont_idx), opt_type == "call"),
            is_in=is_in[cont_idx],
            device=dev,
        )
        for k in out:
            out[k][cont_idx] = g[k].cpu().numpy()

    # KI(R) = vanilla - KO(R at expiry) + R*DF (the framework-wide identity;
    # the never-knocked-in rebate leg is flat in spot/vol, so only the price
    # picks it up), on the CN lanes; the vanilla's greeks by closed-form bumps
    ki = is_in & ~use_cont
    if ki.any():
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)[ki], device=dev)
        df = np.exp(-nacc * t_exp)
        call = torch.full((int(ki.sum()),), opt_type == "call", device=dev)
        s0, k_, sig, df_t = t(spots), t(strikes), t(sigmas), t(df)
        t_e = torch.full_like(s0, t_exp)
        b76 = lambda s, v: black76_price(s / df_t, k_, v, t_e, df_t, call).cpu().numpy()
        ds = s0 * 1e-4
        vanilla = b76(s0, sig)
        v_up, v_dn = b76(s0 + ds, sig), b76(s0 - ds, sig)
        v_vega = (b76(s0, sig + 1e-4) - vanilla) / (100.0 * 1e-4)
        ds = ds.cpu().numpy()
        out["price"][ki] = vanilla - out["price"][ki] + rebate_amount * df[ki]
        out["delta"][ki] = (v_up - v_dn) / (2 * ds) - out["delta"][ki]
        out["gamma"][ki] = (v_up - 2 * vanilla + v_dn) / ds**2 - out["gamma"][ki]
        out["vega"][ki] = v_vega - out["vega"][ki]

    results = []
    for i, row in enumerate(rows):
        rec: Row = {
            "scenario_name": row["scenario_name"],
            "S0": row["S0"],
            "K": row["K"],
            "sigma": row["sigma"],
            "rate": row["rate"],
            "barrier_type": row["barrier_type"],
        }
        for k in ("price", "delta", "gamma", "vega"):
            rec.update(diff_block(k, float(out[k][i]), row[f"FA_{k}"]))
        results.append(rec)
    if output_csv_path:
        write_rows(results, output_csv_path)
    return results


def build_parser():
    """CLI mirroring the reference's run_config_scenarios.py __main__
    defaults (val 2025-07-28, 1-month tenor, daily ZA monitor dates)."""
    import argparse

    from ._cli import add_backend_flag

    p = argparse.ArgumentParser(
        prog="python -m finite_difference_tpu_torch.runners.barrier_scenarios",
        description="Barrier scenario sweep: config CSV in, FA-diff CSV out.",
    )
    p.add_argument("config_csv", help="scenario config CSV")
    p.add_argument("-o", "--output-csv", default=None)
    p.add_argument("--valuation", default="2025-07-28", help="ISO date")
    p.add_argument("--maturity", default="2025-08-28", help="ISO date")
    p.add_argument("--opt-type", default="call", choices=["call", "put"])
    p.add_argument("--batched", action="store_true",
                   help="price the whole table as one device batch")
    p.add_argument("--num-space-nodes", type=int, default=None,
                   help="batched path grid override")
    p.add_argument("--route", default="pde", choices=["pde", "hybrid"],
                   help="batched path: 'hybrid' sends continuous-regime "
                        "trades (FIS n_lim rule) to the analytic sweep")
    p.add_argument("--schedule", default="uniform",
                   choices=["uniform", "monitor-aligned"],
                   help="batched path time layout: 'monitor-aligned' uses "
                        "per-interval constant dt with monitors exactly on "
                        "step boundaries (reference CN auto-grid rule)")
    p.add_argument("-v", "--verbose", action="store_true")
    add_backend_flag(p)
    return p


def main(argv=None) -> List[Row]:
    from ..utils.calendars import build_monitoring_dates
    from ._cli import device_of, print_summary

    args = build_parser().parse_args(argv)
    val = dt.date.fromisoformat(args.valuation)
    mat = dt.date.fromisoformat(args.maturity)
    base = dict(
        valuation=val,
        maturity=mat,
        monitor_dates=build_monitoring_dates(val, mat, "daily"),
        opt_type=args.opt_type,
    )
    if args.batched:
        rows = run_all_scenarios_batched(
            args.config_csv, args.output_csv, base,
            num_space_nodes=args.num_space_nodes,
            route=args.route,
            schedule=args.schedule,
            device=device_of(args),
        )
    else:
        rows = run_all_scenarios(
            args.config_csv, args.output_csv, base, verbose=args.verbose,
            device=device_of(args),
        )
    print_summary(rows)
    return rows


if __name__ == "__main__":
    main()
