"""Clewlow-Strickland scenario generation with RiskFlow mechanics: the port
of ``finite_difference_tpu.scenarios.simulation``.

Capability parity with cs_simulation.py:556-1077 and :1741-1905 (precalculate,
get_cholesky_decomp, CMC_State.reset, CSForwardPriceModel.generate, and the
single-/multi-factor batch drivers):

- ``precalculate`` is a tiny host-side numpy computation of the
  (n_steps, n_tenors) drift/vol tensors (maturity-clipped dt, OU variance);
- path generation runs on ``device`` as torch ops — correlate normals with
  the Cholesky factor (a matmul), scale by vol, ``cumsum`` over time,
  exponentiate — one batch at a time, RiskFlow's batch loop;
- the native RNG is counter-based threefry, the JAX package's draws (up
  to erfinv's rounding): batch b draws under ``fold_in(PRNGKey(seed), b)``.
  ``rng_backend="torch"`` reproduces RiskFlow's torch.manual_seed /
  torch.randn sequence for scenario-for-scenario parity tests
  (cs_simulation.py:725-770) from a CPU ``torch.Generator`` seeded with
  the run's seed, where the JAX package reseeds torch's global generator:
  the port leaves the global generator alone, and the stream is the same.

Dates are ``datetime.date``; each scenario frame is a
:class:`~.riskflow_io.ScenarioFrame`.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mc.clewlow_strickland import CSParams, cs_precalculate, cs_simulate_paths
from ..models.mc.rng import prng_key, sobol_normals, threefry_fold_in, threefry_normals
from .market_data import (
    extract_correlations,
    extract_forward_curve,
    extract_model_params,
    load_market_data,
)
from .time_grid import (
    DAYS_IN_YEAR,
    as_date,
    date_to_excel_days,
    excel_days_to_date,
    parse_time_grid,
)


def precalculate(
    initial_curve: np.ndarray,
    tenors_in_days: np.ndarray,
    scen_time_grid_days: np.ndarray,
    sigma: float,
    alpha: float,
    drift: float,
    base_date_excel: int,
    use_implied: bool = False,
) -> Dict[str, np.ndarray]:
    """Vol/drift tensors for CS path generation (cs_simulation.py:556-683).

    Tenor day numbers are absolute Excel serials; the scenario grid is
    day offsets from base_date. Implied mode zeroes the drift rate (the
    -0.5*var Ito term remains). Shapes follow RiskFlow's generate():
    initial_curve (1, n_tenors, 1); vol/drift (n_steps, n_tenors, 1).
    """
    tenor_rel = np.asarray(tenors_in_days, np.float64) - float(base_date_excel)
    mu = 0.0 if use_implied else float(drift)
    drift_t, vol_t = cs_precalculate(
        CSParams(alpha=float(alpha), sigma=float(sigma), mu=mu),
        tenor_rel,
        np.asarray(scen_time_grid_days, np.float64),
        DAYS_IN_YEAR,
    )
    return {
        "initial_curve": np.asarray(initial_curve, np.float64).reshape(1, -1, 1),
        "vol": vol_t[:, :, None],
        "drift": drift_t[:, :, None],
    }


def build_cholesky(
    correlation_dict: Dict[Tuple[str, str], float], factor_names: Sequence[str]
) -> np.ndarray:
    """Cholesky of the correlation matrix with eigenvalue healing.

    Mirrors riskflow's get_cholesky_decomp (cs_simulation.py:686-722): if any
    eigenvalue < 1e-8, raise eigenvalues to >= 1e-4, renormalise the diagonal
    to 1, then factorize.
    """
    n = len(factor_names)
    corr = np.eye(n, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            key = (factor_names[i], factor_names[j])
            alt = (factor_names[j], factor_names[i])
            rho = correlation_dict.get(key, correlation_dict.get(alt, 0.0))
            corr[i, j] = corr[j, i] = rho

    eigval, eigvec = np.linalg.eig(corr)
    eigval, eigvec = np.real(eigval), np.real(eigvec)
    if (eigval < 1e-8).any():
        healed = eigvec @ np.diag(np.maximum(eigval, 1e-4)) @ eigvec.T
        diag_norm = np.diag(1.0 / np.sqrt(healed.diagonal()))
        corr = diag_norm @ healed @ diag_norm
    return np.linalg.cholesky(corr)


def generate_random_numbers(
    cholesky_L: np.ndarray,
    num_timesteps: int,
    batch_size: int,
    use_antithetic: bool = False,
    rng_backend: str = "threefry",
    key=None,
    seed: int = 42,
    sobol_offset: int = 0,
    dtype=np.float64,
    device=DEFAULT_DEVICE,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Correlated normals (n_factors, n_steps, batch) on ``device`` —
    CMC_State.reset().

    ``threefry`` draws ``jax.random.normal(key, (n_factors, n_steps*half))``
    at float64 (``key`` a uint32 pair, by default ``prng_key(seed)``), casts
    to ``dtype`` and correlates with one matmul. ``rng_backend="torch"``
    reproduces the reference's draw order exactly: ``torch.randn(n_factors,
    half*n_steps)`` on the CPU from ``generator`` (by default a new CPU
    generator seeded with ``seed``), correlate, reshape, antithetic concat
    (cs_simulation.py:725-770), then float64 on ``device``.
    ``rng_backend="sobol_device"`` uses the device-native unscrambled Sobol
    (one QMC dimension per factor-step pair, one point per path); being
    deterministic, ``seed`` acts as a fast-forward offset into the stream.
    """
    dev = resolve_device(device)
    n_factors = cholesky_L.shape[0]
    half = batch_size // 2 if use_antithetic else batch_size

    if rng_backend == "torch":
        t_dtype = torch.float64 if dtype == np.float64 else torch.float32
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        t_chol = torch.tensor(cholesky_L, dtype=t_dtype)
        z = torch.randn(n_factors, half * num_timesteps, dtype=t_dtype, generator=generator)
        correlated = torch.matmul(t_chol, z).reshape(n_factors, num_timesteps, -1)
        if use_antithetic:
            correlated = torch.concat([correlated, -correlated], dim=-1)
        return correlated.to(torch.float64).to(dev)

    if rng_backend == "sobol_device":
        # one Sobol dimension per (factor, step) pair, one point per path;
        # +1 skips the all-zeros origin point (an ~-8 sigma draw
        # everywhere); ``sobol_offset`` advances past earlier batches' points
        z = sobol_normals(
            half, n_factors * num_timesteps,
            fast_forward=seed + 1 + sobol_offset, device=dev,
        )
        z = z.T.reshape(n_factors, num_timesteps, half).reshape(
            n_factors, num_timesteps * half
        )
    else:
        if key is None:
            key = prng_key(seed)
        z = threefry_normals(key, (n_factors, num_timesteps * half), torch.float64, device=dev)
    t_dtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    z = z.to(t_dtype)
    correlated = (
        torch.as_tensor(np.asarray(cholesky_L), dtype=t_dtype, device=dev) @ z
    ).reshape(n_factors, num_timesteps, half)
    if use_antithetic:
        correlated = torch.cat([correlated, -correlated], dim=-1)
    return correlated


def generate_paths(
    precalc: Dict[str, np.ndarray], random_numbers, factor_index: int = 0, device=None
) -> np.ndarray:
    """Simulated forward curves (n_steps, n_tenors, n_scens) as numpy.

    Mirrors CSForwardPriceModel.generate (cs_simulation.py:772-825): take
    this factor's draws, broadcast over the tenor axis, scale by incremental
    vol, cumulative-sum the stochastic integral: F(t,T) = F(0,T) *
    exp(drift + cumsum(vol * Z)), on the draws' device (or ``device``).
    """
    vol = precalc["vol"]
    n_steps = vol.shape[0]
    z = random_numbers[factor_index, :n_steps, :]
    out = cs_simulate_paths(
        precalc["initial_curve"].reshape(-1), precalc["drift"][:, :, 0], vol[:, :, 0], z,
        device=device,
    )
    return out.cpu().numpy()


def _resolve_base_date(val_config, tenors_excel) -> dt.date:
    base_date = None
    if isinstance(val_config, dict):
        base_date = val_config.get("Run_Date") or val_config.get("Base_Date")
    if base_date is None:
        return excel_days_to_date(tenors_excel[0] - 90)
    return as_date(base_date)


def _resolve_grid_string(val_config, time_grid_string) -> str:
    if time_grid_string is not None:
        return time_grid_string
    if isinstance(val_config, dict):
        s = val_config.get("Time_grid") or val_config.get("Tenor")
        if s is not None:
            return s
    return "0d 2d 1w(1w) 1m(1m) 3m(3m)"


def _theoretical_moments(prices, tenors_excel, base_date_excel, params, t_final):
    """E[F] and Std of the terminal CS marginals (validation printout)."""
    sigma, alpha, mu = params["Sigma"], params["Alpha"], params["Drift"]
    out = []
    for F0, t_ex in zip(prices, tenors_excel):
        T_del = max((t_ex - base_date_excel) / DAYS_IN_YEAR, 0.0)
        # variance (and drift) accumulation stops at delivery, as the
        # simulation's tenor-clipped dt matrix does
        t_eff = min(t_final, T_del)
        ln_var = (
            sigma**2
            * np.exp(-2.0 * alpha * (T_del - t_eff))
            * (1.0 - np.exp(-2.0 * alpha * t_eff))
            / (2.0 * alpha)
        )
        mean = F0 * np.exp(mu * t_eff)
        std = mean * np.sqrt(max(np.exp(ln_var) - 1.0, 0.0))
        out.append((mean, std))
    return out


def run_simulation_from_json(
    json_path: str,
    factor_name: str,
    time_grid_string: Optional[str] = None,
    max_date: Optional[dt.date] = None,
    batch_size: int = 1024,
    simulation_batches: int = 4,
    use_antithetic: bool = True,
    random_seed: int = 42,
    rng_backend: str = "threefry",
    verbose: bool = False,
    device=DEFAULT_DEVICE,
):
    """Single-factor CS simulation from a CVAMarketData JSON.

    Mirrors the reference driver (cs_simulation.py:827-1077) and RiskFlow's
    Credit_Monte_Carlo batch loop: per batch fresh correlated normals, paths
    concatenated on the scenario axis. Returns (all_simulated, scenario
    frame, metadata).
    """
    results, frames, metas = run_multi_factor_simulation_from_json(
        json_path,
        [factor_name],
        time_grid_string=time_grid_string,
        max_date=max_date,
        batch_size=batch_size,
        simulation_batches=simulation_batches,
        use_antithetic=use_antithetic,
        random_seed=random_seed,
        rng_backend=rng_backend,
        verbose=verbose,
        device=device,
    )
    return results[factor_name], frames[factor_name], metas[factor_name]


def run_multi_factor_simulation_from_json(
    json_path: str,
    factor_names: List[str],
    time_grid_string: Optional[str] = None,
    max_date: Optional[dt.date] = None,
    batch_size: int = 1024,
    simulation_batches: int = 4,
    use_antithetic: bool = True,
    random_seed: int = 42,
    rng_backend: str = "threefry",
    verbose: bool = False,
    device=DEFAULT_DEVICE,
):
    """Correlated multi-factor CS simulation (cs_simulation.py:1741-1905) on
    ``device``.

    All factors share each batch's correlated normal block; correlations come
    from the JSON. Returns ({factor: array}, {factor: scenario frame},
    {factor: metadata}).
    """
    from .riskflow_io import to_riskflow_dataframe

    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(int(random_seed)) if rng_backend == "torch" else None

    total_scenarios = batch_size * simulation_batches
    market_data = load_market_data(json_path)

    factor_data = {}
    for fname in factor_names:
        tenors, prices, currency = extract_forward_curve(market_data, fname)
        params, model_type = extract_model_params(market_data, fname)
        factor_data[fname] = dict(
            tenors=tenors, prices=prices, currency=currency,
            params=params, model_type=model_type,
        )

    val_config = market_data.get("Valuation Configuration", {})
    all_first = min(fd["tenors"][0] for fd in factor_data.values())
    all_last = max(fd["tenors"][-1] for fd in factor_data.values())
    base_date = _resolve_base_date(val_config, np.array([all_first]))
    base_date_excel = date_to_excel_days(base_date)

    grid_string = _resolve_grid_string(val_config, time_grid_string)
    if max_date is None:
        max_date = excel_days_to_date(all_last)
    scen_time_grid = parse_time_grid(base_date, max_date, grid_string)
    num_timesteps = len(scen_time_grid)
    if num_timesteps and scen_time_grid[0] != 0:
        # RiskFlow's dt matrix zeroes the FIRST grid row (the first
        # scenario date carries the initial curve), so a grid that skips
        # '0d' silently loses all variance before its first date while
        # the diagnostics still measure t from 0
        import warnings

        warnings.warn(
            f"scenario grid {grid_string!r} does not start at day 0: the "
            f"first slice (day {int(scen_time_grid[0])}) will carry the "
            "initial curve with ZERO dispersion (RiskFlow dt mechanics); "
            "prepend '0d' unless that is intended"
        )

    precalcs = {
        fname: precalculate(
            fd["prices"], fd["tenors"], scen_time_grid,
            fd["params"]["Sigma"], fd["params"]["Alpha"], fd["params"]["Drift"],
            base_date_excel, use_implied=(fd["model_type"] == "implied"),
        )
        for fname, fd in factor_data.items()
    }

    L = build_cholesky(extract_correlations(market_data), factor_names)

    batch_results: Dict[str, list] = {fname: [] for fname in factor_names}
    base_key = prng_key(random_seed)
    for batch in range(simulation_batches):
        half = batch_size // 2 if use_antithetic else batch_size
        random_numbers = generate_random_numbers(
            L, num_timesteps, batch_size,
            use_antithetic=use_antithetic,
            rng_backend=rng_backend,
            key=threefry_fold_in(base_key, batch),
            # the Sobol stream is deterministic: honor random_seed and
            # advance past earlier batches' points
            seed=random_seed,
            sobol_offset=batch * half,
            device=dev,
            generator=generator,
        )
        for idx, fname in enumerate(factor_names):
            batch_results[fname].append(
                generate_paths(precalcs[fname], random_numbers, factor_index=idx)
            )

    results = {f: np.concatenate(v, axis=-1) for f, v in batch_results.items()}

    scenario_frames, metadata_dict = {}, {}
    for fname, fd in factor_data.items():
        meta = dict(
            factor_name=fname,
            model_type=fd["model_type"],
            params=fd["params"],
            base_date=base_date,
            base_date_excel=base_date_excel,
            time_grid_string=grid_string,
            scen_time_grid=scen_time_grid,
            tenors_excel=fd["tenors"],
            prices=fd["prices"],
            currency=fd["currency"],
            batch_size=batch_size,
            simulation_batches=simulation_batches,
            total_scenarios=total_scenarios,
        )
        meta["scenario_dates"] = sorted(
            base_date + dt.timedelta(days=int(d)) for d in scen_time_grid
        )
        metadata_dict[fname] = meta
        scenario_frames[fname] = to_riskflow_dataframe(results[fname], meta)
        if verbose:
            t_final = scen_time_grid[-1] / DAYS_IN_YEAR
            theo = _theoretical_moments(
                fd["prices"], fd["tenors"], base_date_excel, fd["params"], t_final
            )
            print(f"{fname}: shape={results[fname].shape}")
            for i, (m, s) in enumerate(theo):
                sim = results[fname][-1, i, :]
                print(
                    f"  tenor {i}: E[F] sim={sim.mean():.4f} theo={m:.4f} "
                    f"Std sim={sim.std():.4f} theo={s:.4f}"
                )

    return results, scenario_frames, metadata_dict
