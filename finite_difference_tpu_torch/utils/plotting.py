"""Plot-style observability: the reference's matplotlib analogs (the
port's own copy of ``finite_difference_tpu.utils.plotting``, host numpy;
matplotlib is imported when a plot is drawn, not with the module).

The reference plots exposure profiles (xva_commodity_forward_main.py:
181-201), simulated path fans (clewlow_strickland.py:178-231,
gbm_asset_price_diagnostic.py) and grid-convergence ladders
(vanilla_option_pricer_test.py:392-420). The rebuild emits CSV/JSON for
all of those; this module adds the presentation layer. All functions are
headless (Agg), take a ``save_path``, and return the Figure so notebooks
can restyle them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_exposure_profile(
    profile,
    save_path: Optional[str] = None,
    quantile: float = 0.95,
    title: Optional[str] = None,
):
    """EE and PFE(q) curves for an ExposureProfile
    (xva_commodity_forward_main.py:181-201 analog)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 5))
    dates = list(profile.dates)
    ax.plot(dates, profile.ee(), label="EE", lw=2)
    ax.plot(
        dates, profile.pfe(quantile), label=f"PFE {quantile:.0%}", lw=2, ls="--"
    )
    if getattr(profile, "collateral", None) is not None:
        ax.plot(
            dates, profile.collateral.mean(axis=0), label="collateral (mean)",
            lw=1, alpha=0.7,
        )
    ax.set_xlabel("scenario date")
    ax.set_ylabel(f"exposure ({profile.currency})")
    ax.set_title(title or f"Exposure profile — {profile.netting_set_id}")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.autofmt_xdate()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_ee_pfe(
    times: Sequence,
    ee: np.ndarray,
    pfe: np.ndarray,
    save_path: Optional[str] = None,
    title: str = "Exposure profile",
    xlabel: str = "time (days)",
    ylabel: str = "exposure",
):
    """EE/PFE arrays plot (commodity-XVA profile form,
    xva_commodity_forward_main.py:181-201 analog)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(times, ee, label="EE", lw=2)
    ax.plot(times, pfe, label="PFE", lw=2, ls="--")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_path_fan(
    times: Sequence,
    paths: np.ndarray,
    save_path: Optional[str] = None,
    quantiles: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95),
    n_sample_paths: int = 20,
    title: str = "Simulated paths",
    ylabel: str = "level",
):
    """Quantile fan + sample spaghetti for (n_paths, n_times) simulations
    (clewlow_strickland.py:178-231 analog)."""
    plt = _plt()
    paths = np.asarray(paths)
    fig, ax = plt.subplots(figsize=(9, 5))
    qs = np.quantile(paths, quantiles, axis=0)
    n_bands = len(quantiles) // 2
    for k in range(n_bands):
        ax.fill_between(
            times, qs[k], qs[-(k + 1)],
            alpha=0.15 + 0.1 * k, color="C0", lw=0,
            label=f"{quantiles[k]:.0%}-{quantiles[-(k+1)]:.0%}",
        )
    ax.plot(times, qs[len(quantiles) // 2], color="C0", lw=2, label="median")
    for p in paths[: min(n_sample_paths, paths.shape[0])]:
        ax.plot(times, p, color="C1", lw=0.4, alpha=0.4)
    ax.set_xlabel("time")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_convergence(
    rows: List[Dict],
    save_path: Optional[str] = None,
    x_key: str = "M",
    y_key: str = "price",
    reference_value: Optional[float] = None,
    title: str = "Grid convergence",
):
    """Price-vs-refinement ladder (validate_convergence output rows;
    vanilla_option_pricer_test.py:392-420 analog). Log-log error panel is
    added when a reference value is given."""
    plt = _plt()
    xs = np.array([r[x_key] for r in rows], dtype=float)
    ys = np.array([r[y_key] for r in rows], dtype=float)
    order = np.argsort(xs)
    xs, ys = xs[order], ys[order]

    if reference_value is not None:
        fig, (ax, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
        err = np.abs(ys - reference_value)
        ax2.loglog(xs, np.maximum(err, 1e-16), "o-")
        ax2.set_xlabel(x_key)
        ax2.set_ylabel(f"|{y_key} - ref|")
        ax2.grid(alpha=0.3, which="both")
        ax2.set_title("error vs refinement")
    else:
        fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(xs, ys, "o-")
    if reference_value is not None:
        ax.axhline(reference_value, color="k", ls=":", label="reference")
        ax.legend()
    ax.set_xlabel(x_key)
    ax.set_ylabel(y_key)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
