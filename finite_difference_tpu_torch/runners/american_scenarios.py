"""American-option scenario runner.

Counterpart of ``finite_difference_tpu.runners.american_scenarios``, with
capability parity with the reference's ``run_american_scenarios.py:46-316``:
per-scenario ``AmericanFDMPricer`` pricing with FA price/greek diffs from a
config CSV, and the batched path (``price_american_batch_richardson``: on
a card at float64 the SPIKE march at double precision). Tables are lists
of row dicts with the JAX runner's column names, read and written with the
``csv`` module.

    python -m finite_difference_tpu_torch.runners.american_scenarios cfg.csv [--batched] [-o out.csv] [--cpu]
"""
from __future__ import annotations

import datetime as dt
from typing import Any, Dict, List, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.pde.american import AmericanFDMPricer
from ..parallel.mesh import check_mesh
from ..utils.curves import flat_curve
from ..utils.rates import naca_to_nacc
from ._cli import Row, diff_block, read_rows, write_rows


def run_american_scenario(
    scenario_name: str,
    S0: float,
    K: float,
    sigma: float,
    rate: float,
    FA_price: Optional[float],
    FA_delta: Optional[float],
    FA_gamma: Optional[float],
    FA_vega: Optional[float],
    *,
    valuation: dt.date,
    maturity: dt.date,
    opt_type: str = "call",
    trade_number: int = 201871103,
    quantity: int = 1000,
    contract_size: int = 1,
    position: str = "long",
    divs: Optional[list] = None,
    underlying_spot_days: int = 0,
    option_days: int = 0,
    option_settlement_days: int = 0,
    day_count: str = "ACT/365",
    num_space_nodes: int = 500,
    num_time_steps: int = 500,
    device=DEFAULT_DEVICE,
) -> Row:
    curve = flat_curve(rate, valuation)
    pricer = AmericanFDMPricer(
        spot=S0,
        strike=K,
        valuation_date=valuation,
        maturity_date=maturity,
        sigma=sigma,
        option_type=opt_type,
        discount_curve=curve,
        forward_curve=curve,
        dividend_schedule=divs or [],
        trade_id=trade_number,
        direction=position,
        quantity=quantity,
        contract_multiplier=contract_size,
        underlying_spot_days=underlying_spot_days,
        option_days=option_days,
        option_settlement_days=option_settlement_days,
        day_count=day_count,
        num_space_nodes=num_space_nodes,
        num_time_steps=num_time_steps,
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
    }
    results.update(diff_block("price", model_price, FA_price))
    results.update(diff_block("delta", greeks["delta"], FA_delta))
    results.update(diff_block("gamma", greeks["gamma"], FA_gamma))
    results.update(diff_block("vega", greeks["vega"], FA_vega))
    return results


def run_all_american_scenarios(
    config_csv_path: str,
    output_csv_path: Optional[str],
    base_params: Dict[str, Any],
    verbose: bool = False,
    device=DEFAULT_DEVICE,
) -> List[Row]:
    """Config CSV in, diff table out (run_american_scenarios.py:209-316)."""
    all_results = []
    for row in read_rows(config_csv_path):
        result = run_american_scenario(
            scenario_name=row["scenario_name"],
            S0=row["S0"],
            K=row["K"],
            sigma=row["sigma"],
            rate=row["rate"],
            FA_price=row.get("FA_price"),
            FA_delta=row.get("FA_delta"),
            FA_gamma=row.get("FA_gamma"),
            FA_vega=row.get("FA_vega"),
            device=device,
            **base_params,
        )
        all_results.append(result)
        if verbose:
            print(f"{result['scenario_name']}: price {result['model_price']:.6f}")
    if output_csv_path:
        write_rows(all_results, output_csv_path)
    return all_results


def run_all_american_scenarios_batched(
    config_csv_path: str,
    output_csv_path: Optional[str],
    base_params: Dict[str, Any],
    mesh=None,
    num_space_nodes: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    richardson: bool = True,
    device=DEFAULT_DEVICE,
) -> List[Row]:
    """The whole American scenario table as one batched call on ``device``
    (the reference's per-scenario loop, run_american_scenarios.py:209-316,
    collapsed into one batch).

    Prices with ``price_american_batch_richardson`` (the batched twin of
    the scalar pricer's ``price_log2`` Richardson pair) or the flat
    ``price_american_batch`` when ``richardson=False``, each under its
    ``auto`` route: on a card the American SPIKE march with the
    Ikonen–Toivanen projection fused into the step (at float64 the march
    at double precision), on the CPU the scan. ``mesh`` (a ``parallel.Mesh``,
    a device count or a list of device names, of ``device``'s type;
    ``parallel.mesh.check_mesh``) splits the trades over its ``"data"``
    axis; anything else but None raises ValueError.
    """
    from ..models.pde.batch import (
        build_american_batch,
        price_american_batch,
        price_american_batch_richardson,
    )
    from ..utils.daycount import year_fraction

    dev = resolve_device(device)
    mesh = check_mesh(mesh, dev)
    rows = read_rows(config_csv_path)
    valuation = base_params["valuation"]
    maturity = base_params["maturity"]
    opt_type = base_params.get("opt_type", "call")
    n_time = base_params.get("num_time_steps", 500)
    n_space = num_space_nodes or base_params.get("num_space_nodes", 500)
    day_count = base_params.get("day_count", "ACT/365")
    for lag in ("underlying_spot_days", "option_days", "option_settlement_days"):
        if base_params.get(lag):
            # the batch container carries one time measure; non-zero FA
            # settlement lags need the scalar per-scenario path
            raise ValueError(
                f"batched American runner does not support {lag}; use "
                "run_all_american_scenarios"
            )

    t_exp = year_fraction(valuation, maturity, day_count)
    B = len(rows)
    nacc = [naca_to_nacc(float(row["rate"])) for row in rows]
    # discrete dividends (base_params 'divs': [(ex_date, amount), ...])
    # become per-trade (tau_from_expiry, amount) pairs for the segmented
    # schedule
    divs_tau = sorted(
        (
            (t_exp - year_fraction(valuation, d, day_count), float(a))
            for d, a in base_params.get("divs") or []
            # same strict window as AmericanFDMPricer._div_times_tau
            if valuation < d < maturity and 0.0 < year_fraction(valuation, d, day_count) < t_exp
        ),
        key=lambda x: x[0],
    )
    build_kwargs = dict(
        spots=[float(row["S0"]) for row in rows],
        strikes=[float(row["K"]) for row in rows],
        sigmas=[float(row["sigma"]) for row in rows],
        t_expiry=[t_exp] * B,
        r=nacc,
        b=nacc,
        is_call=[opt_type == "call"] * B,
        dividends_tau=[list(divs_tau)] * B,
        num_space_nodes=n_space,
        dtype=dtype,
        snap_to_grid=True,  # match AmericanFDMPricer's runner defaults
    )
    if richardson:
        out = price_american_batch_richardson(
            n_nodes=n_space + 1, n_time_steps=n_time,
            # the scalar price_log2's reference quirk: the refined run
            # steps 2*num_space_nodes times (fd_american_equity.py:944-952)
            n_time_steps_fine=2 * n_space,
            mesh=mesh,
            device=dev,
            **build_kwargs,
        )
    else:
        tb = build_american_batch(n_time_steps=n_time, device=dev, **build_kwargs)
        out = price_american_batch(tb, n_nodes=n_space + 1, mesh=mesh, device=dev)
    out = {k: v.double().cpu().numpy() for k, v in out.items()}

    all_results = []
    for i, row in enumerate(rows):
        res: Row = {
            "scenario_name": row["scenario_name"],
            "S0": row["S0"],
            "K": row["K"],
            "sigma": row["sigma"],
            "rate": row["rate"],
        }
        for k in ("price", "delta", "gamma", "vega"):
            res.update(diff_block(k, float(out[k][i]), row.get(f"FA_{k}")))
        all_results.append(res)
    if output_csv_path:
        write_rows(all_results, output_csv_path)
    return all_results


def build_parser():
    """CLI mirroring the reference's run_american_scenarios.py __main__."""
    import argparse

    from ._cli import add_backend_flag

    p = argparse.ArgumentParser(
        prog="python -m finite_difference_tpu_torch.runners.american_scenarios",
        description="American scenario sweep: config CSV in, FA-diff CSV out.",
    )
    p.add_argument("config_csv")
    p.add_argument("-o", "--output-csv", default=None)
    p.add_argument("--valuation", default="2025-07-28")
    p.add_argument("--maturity", default="2025-08-28")
    p.add_argument("--opt-type", default="put", choices=["call", "put"])
    p.add_argument(
        "--batched", action="store_true",
        help="price the whole table as one batched call (Richardson pair; "
        "on a card the American SPIKE march)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    add_backend_flag(p)
    return p


def main(argv=None) -> List[Row]:
    from ._cli import device_of, print_summary

    args = build_parser().parse_args(argv)
    base = dict(
        valuation=dt.date.fromisoformat(args.valuation),
        maturity=dt.date.fromisoformat(args.maturity),
        opt_type=args.opt_type,
    )
    if args.batched:
        rows = run_all_american_scenarios_batched(
            args.config_csv, args.output_csv, base, device=device_of(args)
        )
    else:
        rows = run_all_american_scenarios(
            args.config_csv, args.output_csv, base, verbose=args.verbose,
            device=device_of(args),
        )
    print_summary(rows)
    return rows


if __name__ == "__main__":
    main()
