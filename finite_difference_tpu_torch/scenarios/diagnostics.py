"""Statistical diagnostics for CS scenario simulations: the port of
``finite_difference_tpu.scenarios.diagnostics``, host numpy and scipy.

Capability parity with the reference's ``cs_diagnostics.py`` (1583 LoC;
plots dropped — this is the library API): theoretical CS moments, the
martingale test, log/price moment matching, tail analysis (KS / quantiles /
VaR-ES), parameter recovery (Samuelson-ratio alpha, implied sigma, drift),
cross-factor correlation recovery, convergence and standard-error analysis,
and a full-suite driver. Each table is a list of row dicts with the JAX
package's DataFrame columns as keys; a simulation is an (n_steps,
n_tenors, n_scenarios) array or a scenario frame.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


# =============================================================================
# Theoretical CS moments (cs_diagnostics.py:57-140)
# =============================================================================

def cs_log_variance(sigma, alpha, T_years, t_years):
    """Var[log F(t,T)/F(0,T)] = sigma^2 e^{-2a(T-t)} (1-e^{-2a t_eff})/(2a)."""
    T_arr = np.asarray(T_years, dtype=np.float64)
    t_arr = np.asarray(t_years, dtype=np.float64)
    t_eff = np.minimum(t_arr, T_arr)
    Tmt = np.maximum(T_arr - t_arr, 0.0)
    if np.abs(alpha) < 1e-10:
        return sigma**2 * t_eff
    return (
        sigma**2
        * np.exp(-2.0 * alpha * Tmt)
        * (1.0 - np.exp(-2.0 * alpha * t_eff))
        / (2.0 * alpha)
    )


def cs_theoretical_log_moments(sigma, alpha, drift, T_years, t_years):
    """(m, V) of X = log(F(t,T)/F(0,T)) ~ N(m, V)."""
    V = cs_log_variance(sigma, alpha, T_years, t_years)
    t_eff = np.minimum(np.asarray(t_years), np.asarray(T_years))
    return drift * t_eff - 0.5 * V, V


def cs_theoretical_price_moments(F0, sigma, alpha, drift, T_years, t_years):
    """Lognormal price-level moments of F(t,T)."""
    m, V = cs_theoretical_log_moments(sigma, alpha, drift, T_years, t_years)
    t_eff = np.minimum(np.asarray(t_years), np.asarray(T_years))
    price_mean = F0 * np.exp(drift * t_eff)
    price_var = price_mean**2 * np.maximum(np.exp(V) - 1.0, 0.0)
    eV = np.exp(V)
    return {
        "log_mean": m,
        "log_var": V,
        "price_mean": price_mean,
        "price_var": price_var,
        "price_std": np.sqrt(price_var),
        "price_skew": (eV + 2.0) * np.sqrt(np.maximum(eV - 1.0, 0.0)),
        "price_kurt_excess": np.exp(4 * V) + 2 * np.exp(3 * V) + 3 * np.exp(2 * V) - 6.0,
    }


# =============================================================================
# Helpers (cs_diagnostics.py:142-233)
# =============================================================================

def _to_3d_array(simulated, metadata=None) -> np.ndarray:
    from .riskflow_io import ScenarioFrame, from_riskflow_dataframe

    if isinstance(simulated, ScenarioFrame) or hasattr(simulated, "to_numpy"):
        arr, _, _ = from_riskflow_dataframe(simulated, metadata)
        return arr
    return np.asarray(simulated)


def _get_time_tenor_arrays(metadata):
    from .time_grid import DAYS_IN_YEAR

    t_years = np.asarray(metadata["scen_time_grid"], float) / DAYS_IN_YEAR
    T_years = (
        np.asarray(metadata["tenors_excel"], float) - metadata["base_date_excel"]
    ) / DAYS_IN_YEAR
    return t_years, T_years


def _select_timesteps(n_timesteps: int, n_target: int = 10) -> List[int]:
    if n_timesteps <= n_target:
        return list(range(n_timesteps))
    return sorted(set(np.linspace(0, n_timesteps - 1, n_target).astype(int).tolist()))


# =============================================================================
# 1. Martingale test (cs_diagnostics.py:235-334)
# =============================================================================

def martingale_test(
    simulated, metadata, timestep_indices=None, confidence: float = 0.95
) -> List[dict]:
    """E[F(t,T)] vs F(0,T) e^{mu t} with a two-sided t-test per (t, T)."""
    from scipy import stats as sp_stats

    simulated = _to_3d_array(simulated, metadata)
    t_years, T_years = _get_time_tenor_arrays(metadata)
    drift = metadata["params"]["Drift"]
    F0 = metadata["prices"]
    n_scenarios = simulated.shape[2]
    if timestep_indices is None:
        timestep_indices = _select_timesteps(simulated.shape[0])

    z_crit = sp_stats.norm.ppf(0.5 + confidence / 2.0)
    records = []
    for t_idx in timestep_indices:
        t = t_years[t_idx]
        for tenor_idx, (T, f0) in enumerate(zip(T_years, F0)):
            if t > T + 0.01:
                continue
            sim_prices = simulated[t_idx, tenor_idx, :]
            sim_mean = float(np.mean(sim_prices))
            sim_se = float(np.std(sim_prices, ddof=1) / np.sqrt(n_scenarios))
            theo_mean = float(f0 * np.exp(drift * min(t, T)))
            z = (sim_mean - theo_mean) / sim_se if sim_se > 0 else 0.0
            records.append(
                {
                    "t_idx": t_idx,
                    "t_years": t,
                    "tenor_idx": tenor_idx,
                    "T_years": T,
                    "sim_mean": sim_mean,
                    "theo_mean": theo_mean,
                    "ratio": sim_mean / theo_mean if theo_mean else np.nan,
                    "se": sim_se,
                    "z_stat": z,
                    "pass": bool(abs(z) < z_crit),
                }
            )
    return records


# =============================================================================
# 2. Moment matching (cs_diagnostics.py:378-477)
# =============================================================================

def moment_matching(simulated, metadata, timestep_indices=None):
    """Log and price moments vs theory; returns (log rows, price rows)."""
    simulated = _to_3d_array(simulated, metadata)
    t_years, T_years = _get_time_tenor_arrays(metadata)
    params = metadata["params"]
    F0 = metadata["prices"]
    if timestep_indices is None:
        timestep_indices = _select_timesteps(simulated.shape[0])

    log_records, price_records = [], []
    for t_idx in timestep_indices:
        t = t_years[t_idx]
        if t < 1e-9:
            continue
        for tenor_idx, (T, f0) in enumerate(zip(T_years, F0)):
            if t > T + 0.01:
                continue
            sim_F = simulated[t_idx, tenor_idx, :]
            log_ret = np.log(sim_F / f0)
            m, V = cs_theoretical_log_moments(
                params["Sigma"], params["Alpha"], params["Drift"], T, t
            )
            theo = cs_theoretical_price_moments(
                f0, params["Sigma"], params["Alpha"], params["Drift"], T, t
            )
            log_records.append(
                {
                    "t_years": t, "T_years": T,
                    "sim_mean": float(log_ret.mean()),
                    "theo_mean": float(m),
                    "sim_var": float(log_ret.var(ddof=1)),
                    "theo_var": float(V),
                }
            )
            price_records.append(
                {
                    "t_years": t, "T_years": T,
                    "sim_mean": float(sim_F.mean()),
                    "theo_mean": float(theo["price_mean"]),
                    "sim_std": float(sim_F.std(ddof=1)),
                    "theo_std": float(theo["price_std"]),
                }
            )
    return log_records, price_records


# =============================================================================
# 3. Tail analysis (cs_diagnostics.py:520-656)
# =============================================================================

def tail_analysis(simulated, metadata, tenor_idx: int = 0, timestep_idx: int = -1):
    """KS test, quantile table, VaR/ES vs the theoretical lognormal."""
    from scipy import stats as sp_stats

    simulated = _to_3d_array(simulated, metadata)
    t_years, T_years = _get_time_tenor_arrays(metadata)
    params = metadata["params"]
    F0 = metadata["prices"]
    if timestep_idx < 0:
        timestep_idx = simulated.shape[0] + timestep_idx

    t, T, f0 = t_years[timestep_idx], T_years[tenor_idx], F0[tenor_idx]
    sim_F = simulated[timestep_idx, tenor_idx, :]
    log_ret = np.log(sim_F / f0)
    m, V = cs_theoretical_log_moments(
        params["Sigma"], params["Alpha"], params["Drift"], T, t
    )
    sd = np.sqrt(max(float(V), 1e-18))

    ks_stat, ks_p = sp_stats.kstest(log_ret, "norm", args=(float(m), sd))
    quantiles = {}
    for q in (0.01, 0.05, 0.10, 0.90, 0.95, 0.99):
        quantiles[q] = {
            "sim": float(np.quantile(log_ret, q)),
            "theo": float(sp_stats.norm.ppf(q, loc=float(m), scale=sd)),
        }
    var_level = 0.95
    sim_var = float(np.quantile(sim_F, 1 - var_level))
    theo_var = float(f0 * np.exp(sp_stats.norm.ppf(1 - var_level, float(m), sd)))
    sim_es = float(sim_F[sim_F <= sim_var].mean()) if (sim_F <= sim_var).any() else np.nan
    return {
        "ks_stat": float(ks_stat),
        "ks_pvalue": float(ks_p),
        "quantiles": quantiles,
        "var_95": {"sim": sim_var, "theo": theo_var},
        "es_95_sim": sim_es,
        "log_mean": {"sim": float(log_ret.mean()), "theo": float(m)},
        "log_var": {"sim": float(log_ret.var(ddof=1)), "theo": float(V)},
    }


# =============================================================================
# 4. Parameter recovery (cs_diagnostics.py:715-925)
# =============================================================================

def parameter_recovery(simulated, metadata) -> Dict:
    """Recover (sigma, alpha, drift) from the simulated vol surface."""
    simulated = _to_3d_array(simulated, metadata)
    t_years, T_years = _get_time_tenor_arrays(metadata)
    params = metadata["params"]
    F0 = metadata["prices"]
    n_tenors = len(F0)
    n_timesteps = simulated.shape[0]

    vol_surface = np.full((n_timesteps, n_tenors), np.nan)
    mean_surface = np.full((n_timesteps, n_tenors), np.nan)
    for t_idx in range(1, n_timesteps):
        t = t_years[t_idx]
        if t < 1e-6:
            continue
        for tenor_idx in range(n_tenors):
            T = T_years[tenor_idx]
            if t > T + 0.01:
                continue
            log_ret = np.log(simulated[t_idx, tenor_idx, :] / F0[tenor_idx])
            vol_surface[t_idx, tenor_idx] = np.std(log_ret, ddof=1)
            mean_surface[t_idx, tenor_idx] = np.mean(log_ret)

    # alpha from the Samuelson ratio across tenor pairs
    last_indices = list(range(max(1, n_timesteps - 5), n_timesteps))
    alpha_estimates = []
    for t_idx in last_indices:
        t = t_years[t_idx]
        for i in range(n_tenors):
            for j in range(i + 1, n_tenors):
                T_i, T_j = T_years[i], T_years[j]
                if t > min(T_i, T_j) + 0.01 or abs(T_i - T_j) < 0.01:
                    continue
                v_i, v_j = vol_surface[t_idx, i], vol_surface[t_idx, j]
                if np.isnan(v_i) or np.isnan(v_j) or v_i <= 0 or v_j <= 0:
                    continue
                alpha_est = -np.log(v_i**2 / v_j**2) / (2.0 * (T_i - T_j))
                if -1 < alpha_est < 5:
                    alpha_estimates.append(alpha_est)
    alpha_rec = float(np.median(alpha_estimates)) if alpha_estimates else np.nan

    # sigma: invert V(t,T) with the recovered alpha
    sigma_estimates = []
    for t_idx in last_indices:
        t = t_years[t_idx]
        for tenor_idx in range(n_tenors):
            T = T_years[tenor_idx]
            v = vol_surface[t_idx, tenor_idx]
            if np.isnan(v) or t > T + 0.01 or not np.isfinite(alpha_rec):
                continue
            denom = cs_log_variance(1.0, alpha_rec, T, t)
            if denom > 0:
                sigma_estimates.append(v / np.sqrt(denom))
    sigma_rec = float(np.median(sigma_estimates)) if sigma_estimates else np.nan

    # drift: mu = (E[logret] + 0.5 V) / t
    drift_estimates = []
    for t_idx in last_indices:
        t = t_years[t_idx]
        for tenor_idx in range(n_tenors):
            T = T_years[tenor_idx]
            mmean = mean_surface[t_idx, tenor_idx]
            v = vol_surface[t_idx, tenor_idx]
            if np.isnan(mmean) or np.isnan(v) or t > T + 0.01 or t <= 0:
                continue
            drift_estimates.append((mmean + 0.5 * v**2) / min(t, T))
    drift_rec = float(np.median(drift_estimates)) if drift_estimates else np.nan

    return {
        "sigma": sigma_rec,
        "alpha": alpha_rec,
        "drift": drift_rec,
        "sigma_true": params["Sigma"],
        "alpha_true": params["Alpha"],
        "drift_true": params["Drift"],
        "vol_surface": vol_surface,
    }


# =============================================================================
# 5. Correlation recovery (cs_diagnostics.py:989-1052)
# =============================================================================

def correlation_recovery(
    simulations_dict: Dict[str, np.ndarray],
    metadata_dict: Dict[str, dict],
    true_correlations: Optional[Dict] = None,
) -> Optional[List[dict]]:
    """Pairwise log-return correlations at the mid timestep."""
    factor_names = list(simulations_dict.keys())
    if len(factor_names) < 2:
        return None
    log_returns = {}
    for fname in factor_names:
        sim = np.asarray(simulations_dict[fname])
        F0 = metadata_dict[fname]["prices"][0]
        t_idx = sim.shape[0] // 2
        log_returns[fname] = np.log(sim[t_idx, 0, :] / F0)

    records = []
    for i in range(len(factor_names)):
        for j in range(i + 1, len(factor_names)):
            fi, fj = factor_names[i], factor_names[j]
            rho_sim = float(np.corrcoef(log_returns[fi], log_returns[fj])[0, 1])
            rho_true = np.nan
            if true_correlations:
                rho_true = true_correlations.get(
                    (fi, fj), true_correlations.get((fj, fi), np.nan)
                )
            records.append(
                {
                    "Factor 1": fi,
                    "Factor 2": fj,
                    "rho_input": rho_true,
                    "rho_sim": rho_sim,
                    "diff": rho_sim - rho_true if np.isfinite(rho_true) else np.nan,
                }
            )
    return records


# =============================================================================
# 6. Convergence / standard errors (cs_diagnostics.py:1055-1302)
# =============================================================================

def convergence_analysis(
    simulated, metadata, tenor_idx: int = 0, timestep_idx: int = -1,
    sample_sizes: Optional[List[int]] = None,
) -> List[dict]:
    """Mean estimate vs scenario count against the theoretical value."""
    simulated = _to_3d_array(simulated, metadata)
    t_years, T_years = _get_time_tenor_arrays(metadata)
    params = metadata["params"]
    f0 = metadata["prices"][tenor_idx]
    if timestep_idx < 0:
        timestep_idx = simulated.shape[0] + timestep_idx
    t, T = t_years[timestep_idx], T_years[tenor_idx]
    sim_F = simulated[timestep_idx, tenor_idx, :]
    n = sim_F.shape[0]
    theo = float(f0 * np.exp(params["Drift"] * min(t, T)))
    if sample_sizes is None:
        # reference semantics (cs_diagnostics.py:1093-1097): power-of-two
        # candidates filtered by n, ALWAYS ending at n — never empty, so
        # small smoke runs (n < 64) get a single-point ladder instead of
        # an IndexError
        sample_sizes = [
            int(x) for x in 2 ** np.arange(6, max(int(np.log2(n)), 6) + 1)
            if int(x) <= n
        ]
        if not sample_sizes or sample_sizes[-1] != n:
            sample_sizes.append(n)
    records = []
    for size in sample_sizes:
        sub = sim_F[:size]
        records.append(
            {
                "n": size,
                "mean": float(sub.mean()),
                "se": float(sub.std(ddof=1) / np.sqrt(size)),
                "abs_err": abs(float(sub.mean()) - theo),
                "theo": theo,
            }
        )
    return records


def standard_error_analysis(
    simulated, metadata, tenor_idx: int = 0, timestep_idx: int = -1,
    n_batches: int = 16,
) -> List[dict]:
    """Batch-means standard errors vs the i.i.d. formula."""
    simulated = _to_3d_array(simulated, metadata)
    if timestep_idx < 0:
        timestep_idx = simulated.shape[0] + timestep_idx
    sim_F = simulated[timestep_idx, tenor_idx, :]
    n = sim_F.shape[0]
    batch = n // n_batches
    batch_means = np.array(
        [sim_F[k * batch : (k + 1) * batch].mean() for k in range(n_batches)]
    )
    return [
        {
            "se_iid": float(sim_F.std(ddof=1) / np.sqrt(n)),
            "se_batch": float(batch_means.std(ddof=1) / np.sqrt(n_batches)),
            "n": n,
            "n_batches": n_batches,
        }
    ]


def compare_simulations(sim_a, sim_b, metadata, tenor_idx: int = 0) -> Dict:
    """Path-level or distributional comparison of two runs
    (cs_diagnostics.py:1304-1411)."""
    from scipy import stats as sp_stats

    a = _to_3d_array(sim_a, metadata)
    b = _to_3d_array(sim_b, metadata)
    fa = a[-1, tenor_idx, :]
    fb = b[-1, tenor_idx, :]
    same_seed = fa.shape == fb.shape
    out = {"same_shape": same_seed}
    if same_seed:
        diff = np.abs(fa - fb)
        out.update(
            max_abs_diff=float(diff.max()),
            mean_abs_diff=float(diff.mean()),
            correlation=float(np.corrcoef(fa, fb)[0, 1]),
        )
    ks_stat, ks_p = sp_stats.ks_2samp(fa, fb)
    out.update(ks_stat=float(ks_stat), ks_pvalue=float(ks_p))
    return out


def run_full_diagnostics(simulated, metadata, sim_benchmark=None) -> Dict:
    """All diagnostics in one pass (cs_diagnostics.py:1466-1583)."""
    results = {
        "martingale": martingale_test(simulated, metadata),
        "moments": moment_matching(simulated, metadata),
        "tails": tail_analysis(simulated, metadata),
        "recovery": parameter_recovery(simulated, metadata),
        "convergence": convergence_analysis(simulated, metadata),
        "standard_errors": standard_error_analysis(simulated, metadata),
    }
    if sim_benchmark is not None:
        results["comparison"] = compare_simulations(simulated, sim_benchmark, metadata)
    return results
