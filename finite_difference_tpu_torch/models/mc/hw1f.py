"""Hull–White one-factor yield-curve scenario simulator (counterpart of
``finite_difference_tpu.models.mc.hw1f``).

Turns calibrated ``Alpha`` / ``Sigma`` parameters (RiskFlow's
``HullWhite1FactorInterestRateModel`` packing) plus today's zero curve into
a yield-curve :class:`~finite_difference_tpu_torch.market_data.scenario_cube.ScenarioCube`
factor for the exposure engine (BASELINE.json config 5: "CVA exposure
engine with HW1F-calibrated rates").

Model (risk-neutral, cash numeraire), in the deviation form
x_t = r_t − f(0,t) (Andersen–Piterbarg quasi-Gaussian with one factor):

    dx = (y(t) − α x) dt + σ(t) dW,      x_0 = 0
    y(t) = Var[x_t] = ∫_0^t σ(s)² e^{−2α(t−s)} ds

with the affine zero-coupon reconstitution

    P(t,T) = P(0,T)/P(0,t) · exp(−B(t,T)·x_t − ½·B(t,T)²·y(t)),
    B(t,T) = (1 − e^{−α(T−t)})/α.

σ(t) is piecewise-constant per scenario interval (interpolated from the
calibrated Sigma term-curve at the interval start), which makes the exact
per-interval recursions closed-form:

    y_t = y_s e^{−2αΔ} + σ²(1−e^{−2αΔ})/(2α)
    E[x_t|x_s] = x_s e^{−αΔ} + y_s e^{−αΔ}(1−e^{−αΔ})/α
                 + σ²(1−e^{−αΔ})²/(2α²)
    Var[x_t|x_s] = σ²(1−e^{−2αΔ})/(2α)

so the simulation is exact at the scenario dates (no Euler bias). The
path set evolves on the device as one (n_paths,) state, a Python step per
date (JAX's ``lax.scan``), and the cube is dense (n_times, n_paths,
n_tenors). The normals are the threefry draws of :mod:`.rng`, the JAX
package's for a seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import date, timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from .rng import prng_key, threefry_normals

DAYS_IN_YEAR = 365.25


def _hw1f_state_kernel(key, z, e, e2, sd, dc, yg, yi, *, n_paths, antithetic, gen_normals,
                       device=DEFAULT_DEVICE):
    """The normals (drawn here when ``gen_normals``, else ``z``) and the
    exact per-interval recursion: x (n_times, n_paths) on ``device``. The
    coefficients (host numpy, (n_times,)) are cast to the normals' dtype,
    and the deterministic variance y runs on the host in that dtype."""
    dev = resolve_device(device)
    n_times = e.shape[0]
    if gen_normals:
        if antithetic:
            half = (n_paths + 1) // 2
            z_half = threefry_normals(key, (n_times, half), device=dev)
            z = torch.cat([z_half, -z_half], dim=1)[:, :n_paths]
        else:
            z = threefry_normals(key, (n_times, n_paths), device=dev)
    z = z.to(dev)
    np_dtype = np.float64 if z.dtype == torch.float64 else np.float32
    e, e2, sd, dc, yg, yi = (np.asarray(a).astype(np_dtype) for a in (e, e2, sd, dc, yg, yi))

    xs = torch.empty((n_times, n_paths), dtype=z.dtype, device=dev)
    x = torch.zeros(n_paths, dtype=z.dtype, device=dev)
    y = np_dtype(0.0)
    for i in range(n_times):
        x = x * float(e[i]) + float(y * yg[i]) + float(dc[i]) + float(sd[i]) * z[i]
        y = y * e2[i] + yi[i]
        xs[i] = x
    return xs


def _reconstitute(xs, B, tau, y_path, z_fwd):
    """Affine zero-coupon reconstitution: the z(t, t+tau) cube."""
    adj_x = (B / tau)[None, None, :] * xs[:, :, None]
    adj_y = (0.5 * B**2 / tau)[None, :] * y_path[:, None]
    return z_fwd[:, None, :] + adj_x + adj_y[:, None, :]


def _expm1_neg(a: torch.Tensor) -> torch.Tensor:
    """1 − e^{−a}, stable for small a."""
    return -torch.expm1(-a)


@dataclass(frozen=True)
class HW1FParams:
    """Calibrated Hull–White parameters.

    ``sigma_tenors``/``sigma_values`` is the Sigma term-curve from the
    calibration (vol of the short-rate deviation per start tenor);
    pass one-element arrays for a flat sigma.
    """

    alpha: float
    sigma_tenors: np.ndarray
    sigma_values: np.ndarray

    def __post_init__(self):
        # the simulator's var/drift/B closed forms divide by alpha; the
        # alpha -> 0 limit is not implemented, so reject it loudly
        # instead of returning an all-NaN cube (the reference calibrator
        # clips alpha to [0.001, 4], calibrate_hw1f_interest_rate)
        if not self.alpha > 0.0:
            raise ValueError(
                f"HW1F alpha must be positive, got {self.alpha} "
                "(the calibrator clips to [0.001, 4])"
            )

    @classmethod
    def flat(cls, alpha: float, sigma: float) -> "HW1FParams":
        return cls(alpha=alpha, sigma_tenors=np.array([0.0]),
                   sigma_values=np.array([float(sigma)]))

    @classmethod
    def from_calibration(cls, params: Dict) -> "HW1FParams":
        """From the OrderedDict of an HW1F calibration or a RiskFlow
        ``HullWhite1FactorInterestRateModel`` block. ``Sigma`` may be the
        calibration's ``{'.Curve': {'data': [(tenor, vol), ...]}}`` packing,
        a plain ``{tenor: vol}`` dict, or a pair list."""
        sig = params["Sigma"]
        if isinstance(sig, dict) and ".Curve" in sig:
            sig = sig[".Curve"].get("data", [])
        if isinstance(sig, dict):
            items = sorted((float(k), float(v)) for k, v in sig.items())
        else:
            items = sorted((float(t), float(v)) for t, v in sig)
        tenors = np.array([t for t, _ in items])
        vols = np.array([v for _, v in items])
        return cls(alpha=float(params["Alpha"]), sigma_tenors=tenors,
                   sigma_values=vols)

    def sigma_at(self, t: np.ndarray) -> np.ndarray:
        """Piecewise-linear σ(t) with flat extrapolation."""
        return np.interp(np.asarray(t, dtype=float),
                         self.sigma_tenors, self.sigma_values)


class HW1FCurveSimulator:
    """Simulates pathwise zero curves z(t, t+τ) on a fixed tenor grid.

    Parameters
    ----------
    params : calibrated :class:`HW1FParams`.
    curve_tenors, curve_rates : today's NACC zero curve z(0, τ).
    device : where the paths and the cube are computed.
    """

    def __init__(
        self,
        params: HW1FParams,
        curve_tenors: Sequence[float],
        curve_rates: Sequence[float],
        device=DEFAULT_DEVICE,
    ) -> None:
        self.params = params
        self.curve_tenors = np.asarray(curve_tenors, dtype=np.float64)
        self.curve_rates = np.asarray(curve_rates, dtype=np.float64)
        if self.curve_tenors.ndim != 1 or self.curve_tenors.size < 2:
            raise ValueError("curve_tenors must be a 1-D grid (>=2 points).")
        self.device = resolve_device(device)

    def _zero_rate0(self, t: np.ndarray) -> np.ndarray:
        return np.interp(np.asarray(t, float), self.curve_tenors,
                         self.curve_rates)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)

    def moments(self, t_years: np.ndarray):
        """Closed-form (E[x_t], Var[x_t]=y(t)) at the scenario times —
        the recursion the simulation uses, for tests/diagnostics."""
        a = self.params.alpha
        ts = np.concatenate([[0.0], np.asarray(t_years, float)])
        mean, y = 0.0, 0.0
        means, ys = [], []
        for s, t in zip(ts[:-1], ts[1:]):
            dt = t - s
            sig = float(self.params.sigma_at(np.array(s)))
            e, e2 = np.exp(-a * dt), np.exp(-2.0 * a * dt)
            mean = (mean * e + y * e * (1.0 - e) / a
                    + sig**2 * (1.0 - e) ** 2 / (2.0 * a**2))
            y = y * e2 + sig**2 * (1.0 - e2) / (2.0 * a)
            means.append(mean)
            ys.append(y)
        return np.array(means), np.array(ys)

    def simulate_state(
        self,
        scen_years: Sequence[float],
        n_paths: int,
        seed: int = 42,
        antithetic: bool = True,
        normals: Optional[np.ndarray] = None,
        as_jax: bool = False,
    ):
        """Exact paths of the deviation x_t at the scenario dates,
        shape (n_times, n_paths): numpy, or with ``as_jax=True`` (the JAX
        package's name for a device-resident result) a tensor on the
        simulator's device."""
        t_grid = np.asarray(scen_years, dtype=np.float64)
        n_times = t_grid.size

        a = self.params.alpha
        dts = np.diff(np.concatenate([[0.0], t_grid]))
        sig = self.params.sigma_at(np.concatenate([[0.0], t_grid[:-1]]))
        e = np.exp(-a * dts)
        e2 = np.exp(-2.0 * a * dts)
        var_inc = sig**2 * (1.0 - e2) / (2.0 * a)          # Var[x_t | x_s]
        drift_c = sig**2 * (1.0 - e) ** 2 / (2.0 * a**2)   # σ part of E[x]
        y_gain = e * (1.0 - e) / a                         # y_s part of E[x]

        if normals is not None:
            z = normals if torch.is_tensor(normals) else torch.as_tensor(np.asarray(normals))
            if tuple(z.shape) != (n_times, n_paths):
                raise ValueError("normals must be (n_times, n_paths).")
            key, gen = None, False
        else:
            key, z, gen = prng_key(seed), None, True

        xs = _hw1f_state_kernel(
            key, z, e, e2, np.sqrt(var_inc), drift_c, y_gain, var_inc,
            n_paths=n_paths, antithetic=bool(antithetic), gen_normals=gen, device=self.device,
        )
        return xs if as_jax else xs.cpu().numpy()

    def simulate(
        self,
        scen_years: Sequence[float],
        tenors: Sequence[float],
        n_paths: int,
        seed: int = 42,
        antithetic: bool = True,
        normals: Optional[np.ndarray] = None,
        as_jax: bool = False,
    ):
        """Zero-rate cube z(t_i, t_i+τ_j) of shape (n_times, n_paths, n_tenors).

        ``scen_years`` are year fractions from today (strictly positive,
        ascending; prepend t=0 yourself if the cube should include today).
        ``normals`` overrides the RNG with an explicit (n_times, n_paths)
        array (for parity testing against an external path sequence).
        ``as_jax=True`` keeps the cube on the simulator's device (a tensor),
        for the device exposure pipeline.
        """
        t_grid = np.asarray(scen_years, dtype=np.float64)
        if t_grid.ndim != 1 or (np.diff(t_grid) <= 0).any() or t_grid[0] <= 0:
            raise ValueError("scen_years must be ascending and > 0.")
        tau = np.asarray(tenors, dtype=np.float64)
        if (tau <= 0).any():
            raise ValueError("tenors must be > 0.")
        xs = self.simulate_state(
            t_grid, n_paths, seed=seed, antithetic=antithetic, normals=normals,
            as_jax=True,
        )  # (n_times, n_paths)
        a = self.params.alpha
        # reconstitution on the tenor grid
        _, y_path = self.moments(t_grid)                       # (n_times,)
        B = _expm1_neg(self._tensor(a * tau)) / a              # (n_tenors,)
        z0_t = self._zero_rate0(t_grid)                        # (n_times,)
        z0_tT = self._zero_rate0(t_grid[:, None] + tau[None, :])
        # forward zero rate between t and t+tau off today's curve:
        # z_fwd = (z0(t+τ)(t+τ) − z0(t)t)/τ
        with np.errstate(divide="ignore", invalid="ignore"):
            z_fwd = (z0_tT * (t_grid[:, None] + tau[None, :])
                     - (z0_t * t_grid)[:, None]) / tau[None, :]
        # −ln P(t,t+τ)/τ = z_fwd + (B x + ½ B² y)/τ
        out = _reconstitute(xs, B, self._tensor(tau), self._tensor(y_path), self._tensor(z_fwd))
        return out if as_jax else out.cpu().numpy()

    def values_with_today(self, rates, tenors, n_paths: int, as_jax: bool = False):
        """Prepend the t=0 slice (today's zero curve, broadcast across
        paths) to simulated rates — the single home for the cube's t=0
        convention. ``as_jax=True``: a tensor on the simulator's device."""
        tau = np.asarray(tenors, dtype=np.float64)
        today0 = self._zero_rate0(tau)
        if as_jax:
            rates = rates.to(self.device) if torch.is_tensor(rates) else self._tensor(rates)
            today = self._tensor(today0)[None, None, :].expand(1, n_paths, tau.size)
            return torch.cat([today, rates], dim=0)
        rates = rates.cpu().numpy() if torch.is_tensor(rates) else np.asarray(rates)
        today = np.broadcast_to(
            np.asarray(today0)[None, None, :], (1, n_paths, tau.size)
        )
        return np.concatenate([today, rates], axis=0)

    def to_scenario_cube(
        self,
        base_date: date,
        scen_days: Sequence[int],
        tenors: Sequence[float],
        n_paths: int,
        factor_name: str = "InterestRate.ZAR-SWAP",
        seed: int = 42,
        antithetic: bool = True,
        days_in_year: float = DAYS_IN_YEAR,
    ):
        """Simulate and wrap as a one-factor ScenarioCube (+ t=0 slice)."""
        from ...market_data.scenario_cube import ScenarioCube

        scen_days = np.asarray(sorted(scen_days), dtype=np.int64)
        if scen_days[0] == 0:
            scen_days = scen_days[1:]
        t_grid = scen_days / float(days_in_year)
        rates = self.simulate(t_grid, tenors, n_paths, seed=seed,
                              antithetic=antithetic)
        tau = np.asarray(tenors, dtype=np.float64)
        values = self.values_with_today(rates, tau, n_paths)
        dates = [base_date] + [
            base_date + timedelta(days=int(d)) for d in scen_days
        ]
        return ScenarioCube(
            dates, {factor_name: ("curve", values, tau)}
        )
