"""Netting-set exposure engine (the port's copy of
``finite_difference_tpu.xva.exposure_engine``, host numpy).

Capability parity with the reference's ``exposure_engine.py`` (the generic
RiskFlow-style engine, :63-648):

- validation of cube maturity coverage and FX factors (:104-130);
- instrument ``precompute`` hook before the date loop (:157-164);
- per-date, per-trade ``scenario_npvs`` with FX conversion and notional
  scaling (:166-201);
- fixing caches stamped exactly once per reset (the RiskFlow ``old_resets``
  convention): LIBOR once-at-reset, OIS incremental compounding with
  historical-CF seeding, CPI bracket dates with T_last_pub pre-seeding,
  commodity averaging dates, equity return-leg resets (:227-546);
- linear interpolation of the market state to exact fixing dates (:16-60);
- CSA close-out risky-curve substitution (:552-587);
- pathwise collateral with MPOR lookback, two-sided VM thresholds, and
  NONE/FIXED/SCHEDULE IM (:593-648), and SIMM IM from bumped re-pricings
  aggregated by ``portfolio.simm`` on the CPU.

The engine's date x trade loop is host orchestration (it stamps caches and
dispatches to instruments); the heavy math lives inside the instruments'
vectorized pricing kernels, which see all paths at once.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from datetime import date, timedelta
from typing import Dict, List, Optional

import numpy as np

from ..market_data.risk_factor import CurveSlice, ScalarSlice, SurfaceSlice
from ..market_data.scenario_cube import ScenarioCube, StaticMarketData
from ..portfolio.csa import CloseOutMethod, InitialMarginMethod
from ..portfolio.netting_set import NettingSet


@dataclass
class ExposureProfile:
    """Reconstruction of the absent pricing/exposure_profile.py (SURVEY §2.9)."""

    netting_set_id: str
    dates: tuple
    mtm: np.ndarray          # (n_paths, n_times)
    collateral: np.ndarray   # (n_paths, n_times)
    exposure: np.ndarray     # (n_paths, n_times) = max(mtm - collateral, 0)
    neg_exposure: np.ndarray
    currency: str

    def ee(self) -> np.ndarray:
        return self.exposure.mean(axis=0)

    def pfe(self, q: float = 0.95) -> np.ndarray:
        return np.quantile(self.exposure, q, axis=0)


def _interp_scenario_state(
    all_states: List[dict],
    scenario_dates: List[date],
    prev_idx: int,
    target_date: date,
) -> dict:
    """Linearly interpolated market state at target_date (exposure_engine.py:16-60)."""
    next_idx = prev_idx + 1
    if next_idx >= len(all_states) or scenario_dates[prev_idx] == target_date:
        return all_states[prev_idx]

    span = (scenario_dates[next_idx] - scenario_dates[prev_idx]).days
    if span == 0:
        return all_states[prev_idx]

    alpha = (target_date - scenario_dates[prev_idx]).days / span
    if alpha <= 0.0:
        return all_states[prev_idx]
    if alpha >= 1.0:
        return all_states[next_idx]

    state_a, state_b = all_states[prev_idx], all_states[next_idx]
    result: dict = {}
    for name, sa in state_a.items():
        sb = state_b.get(name)
        if sb is None or type(sa) is not type(sb):
            result[name] = sa
            continue
        v = (1.0 - alpha) * sa.values + alpha * sb.values
        if isinstance(sa, SurfaceSlice):
            result[name] = SurfaceSlice(values=v, tenors=sa.tenors, strikes=sa.strikes)
        elif isinstance(sa, CurveSlice):
            result[name] = CurveSlice(values=v, tenors=sa.tenors)
        else:
            result[name] = ScalarSlice(values=v)
    return result


def simulate_collateral(
    mtm_paths: np.ndarray,
    dates: List[date],
    csa,
    netting_set=None,
    im_fn=None,
) -> np.ndarray:
    """Pathwise collateral with MPOR lookback and two-sided VM thresholds.

    ``im_fn(n_paths, sim_date)`` -> (n_paths,) initial margin; defaults to
    zero (the engine supplies its NONE/FIXED/SCHEDULE policies).
    Shared by the host ExposureEngine and the device fast path (the
    (n_paths, n_times) MTM matrix is small either way).
    """
    n_paths, n_times = mtm_paths.shape
    collateral = np.zeros((n_paths, n_times))
    mpor = timedelta(days=csa.mpor_days)

    for t_idx, sim_date in enumerate(dates):
        lookback_date = sim_date - mpor
        lag_idx = bisect_right(dates, lookback_date) - 1
        if lag_idx < 0:
            continue
        lagged_mtm = mtm_paths[:, lag_idx]
        vm_recv = np.maximum(lagged_mtm - csa.vm_threshold, 0.0)
        vm_post = np.maximum(-lagged_mtm - csa.vm_threshold_post, 0.0)
        im = im_fn(n_paths, sim_date) if im_fn is not None else 0.0
        collateral[:, t_idx] = vm_recv - vm_post + im

    return collateral


def compute_im(
    n_paths: int, csa, sim_date=None, netting_set=None
) -> np.ndarray:
    """Per-date IM under the NONE/FIXED/SCHEDULE policies (module-level
    twin of ExposureEngine._compute_im so the device fast path can honor
    the same CSA without an engine instance; SIMM stays pathwise in the
    generic engine's pricing pass)."""
    return ExposureEngine._compute_im(None, n_paths, csa, sim_date, netting_set)


class ExposureEngine:
    """Computes an ExposureProfile for a NettingSet against a ScenarioCube."""

    def __init__(
        self,
        cube: ScenarioCube,
        static_data: Optional[StaticMarketData] = None,
    ) -> None:
        self.cube = cube
        self.static_data = static_data or StaticMarketData()

    # ------------------------------------------------------------------

    def compute(self, netting_set: NettingSet) -> ExposureProfile:
        n_paths = self.cube.n_paths
        n_times = self.cube.n_times
        scenario_dates = list(self.cube.dates)
        cube_end = scenario_dates[-1]

        for trade in netting_set.trades:
            trade_end = trade.instrument.effective_maturity
            if isinstance(trade_end, date) and trade_end > cube_end:
                raise ValueError(
                    f"Trade {trade.trade_id!r} effective maturity {trade_end} "
                    f"extends beyond the last cube date {cube_end}. "
                    f"Re-run the simulation with a grid covering at least {trade_end}."
                )

        for trade in netting_set.trades:
            if (
                trade.currency != netting_set.reporting_currency
                and trade.fx_rate_factor is None
            ):
                raise ValueError(
                    f"Trade {trade.trade_id!r} currency {trade.currency!r} differs "
                    f"from reporting currency {netting_set.reporting_currency!r} "
                    f"but fx_rate_factor is not set."
                )

        fixing_cache: Dict[tuple, np.ndarray] = {}
        cpi_fixings_cache: Dict[int, dict] = {}
        commodity_fixings_cache: Dict[int, dict] = {}
        equity_fixings_cache: Dict[int, dict] = {}

        mtm_paths = np.zeros((n_paths, n_times))

        all_states = [
            {**self.static_data.factors, **self.cube.get_time_slice(t)}
            for t in range(n_times)
        ]
        for trade in netting_set.trades:
            trade.instrument.precompute(all_states, scenario_dates)

        simm_on = (
            netting_set.csa is not None
            and netting_set.csa.im_method is InitialMarginMethod.SIMM
        )
        simm_im_paths = np.zeros((n_paths, n_times)) if simm_on else None

        for t_idx in range(n_times):
            sim_date = scenario_dates[t_idx]
            base_market_state = all_states[t_idx]

            trade_ctx = []
            for trade in netting_set.trades:
                instrument = trade.instrument
                fixings = self._build_fixings(
                    instrument, sim_date, scenario_dates, fixing_cache, all_states
                )
                commodity_fixings = self._build_commodity_fixings(
                    instrument, sim_date, commodity_fixings_cache,
                    scenario_dates, all_states,
                )
                if commodity_fixings:
                    fixings = {**fixings, **commodity_fixings}
                equity_fixings = self._build_equity_fixings(
                    instrument, sim_date, equity_fixings_cache,
                    scenario_dates, all_states,
                )
                if equity_fixings:
                    fixings = {**fixings, **equity_fixings}
                cpi_kwargs = self._build_cpi_fixings(
                    instrument, base_market_state, sim_date, cpi_fixings_cache,
                    scenario_dates, all_states,
                )
                trade_ctx.append((trade, fixings, cpi_kwargs))

            def price_all(market_state):
                """Netting-set NPV paths under a (possibly bumped) state;
                fixings stay frozen at the base state (historical)."""
                total = np.zeros(n_paths)
                for trade, fixings, cpi_kwargs in trade_ctx:
                    pricing_state = self._pricing_market_state(
                        market_state, trade.instrument, netting_set,
                        trade.currency,
                    )
                    npv = trade.instrument.scenario_npvs(
                        sim_date, pricing_state, fixings=fixings or None,
                        **cpi_kwargs,
                    )
                    if trade.currency != netting_set.reporting_currency:
                        fx_slice = market_state[trade.fx_rate_factor]
                        npv = npv * fx_slice.values
                    total = total + trade.notional_scale * npv
                return total

            mtm_paths[:, t_idx] = price_all(base_market_state)
            if simm_on:
                simm_im_paths[:, t_idx] = self._simm_im_paths(
                    base_market_state, price_all, mtm_paths[:, t_idx],
                    netting_set.csa,
                )

        if netting_set.csa is not None:
            collateral = self._simulate_collateral(
                mtm_paths, scenario_dates, netting_set.csa, netting_set,
                im_paths=simm_im_paths,
            )
        else:
            collateral = np.zeros((n_paths, n_times))

        net = mtm_paths - collateral
        return ExposureProfile(
            netting_set_id=netting_set.netting_set_id,
            dates=tuple(scenario_dates),
            mtm=mtm_paths,
            collateral=collateral,
            exposure=np.maximum(net, 0.0),
            neg_exposure=np.minimum(net, 0.0),
            currency=netting_set.reporting_currency,
        )

    # ------------------------------------------------------------------
    # Fixing cache (Category B resets)
    # ------------------------------------------------------------------

    def _state_at(
        self, scenario_dates: List[date], d: date,
        all_states: Optional[List[dict]] = None,
    ) -> dict:
        """Market state from the nearest-prior scenario date."""
        idx = max(0, bisect_right(scenario_dates, d) - 1)
        if all_states is not None:
            return all_states[idx]
        return {**self.static_data.factors, **self.cube.get_time_slice(idx)}

    def _ois_accrue(
        self, instrument, curve_name: str, p_start: date,
        from_date: Optional[date], to_date: date,
        scenario_dates: List[date], cf: Optional[np.ndarray],
    ) -> np.ndarray:
        """Roll the compounded OIS factor forward over realized steps.

        A fresh accrual seeds from the trade's ``old_resets``-style initial
        factor (RiskFlow convention) and walks from the period start;
        otherwise it resumes from where the cache stopped.
        """
        if cf is None:
            initial = instrument.get_ois_initial_cf(curve_name, p_start)
            cf = np.full(
                self.cube.n_paths,
                1.0 if initial is None else float(initial),
            )
            from_date = p_start
        steps = [t for t in scenario_dates if from_date <= t < to_date]
        for t_j, t_j1 in zip(steps, steps[1:] + [to_date]):
            cf = cf * instrument.compute_cf_increment(
                curve_name, t_j, t_j1, self._state_at(scenario_dates, t_j)
            )
        return cf

    def _build_fixings(
        self,
        instrument,
        sim_date: date,
        scenario_dates: List[date],
        fixing_cache: dict,
        all_states: Optional[List[dict]] = None,
    ) -> Dict[tuple, np.ndarray]:
        """LIBOR once-at-reset / OIS incremental fixings (exposure_engine.py:227-364)."""
        if not hasattr(instrument, "get_reset_dates"):
            return {}
        has_libor = hasattr(instrument, "compute_fixings")
        has_ois = hasattr(instrument, "compute_cf_increment")
        if not has_libor and not has_ois:
            return {}

        fixings: Dict[tuple, np.ndarray] = {}
        inst_id = id(instrument)

        for reset_tuple in instrument.get_reset_dates():
            reset_date, curve_name, p_start, p_end = reset_tuple[:4]
            is_overnight = len(reset_tuple) > 4 and reset_tuple[4]
            # OIS accrues strictly-past resets; LIBOR fixes on the reset day
            if reset_date > sim_date or (is_overnight and reset_date == sim_date):
                continue

            if is_overnight and has_ois:
                cf_key = (inst_id, curve_name, p_start, "_ois_cf")
                last_key = (inst_id, curve_name, p_start, "_ois_last")
                cf = self._ois_accrue(
                    instrument, curve_name, p_start,
                    fixing_cache.get(last_key), sim_date,
                    scenario_dates, fixing_cache.get(cf_key),
                )
                fixing_cache[cf_key] = cf
                fixing_cache[last_key] = sim_date
                fixings[(curve_name, p_start)] = cf
            elif has_libor:
                cache_key = (inst_id, curve_name, p_start)
                if cache_key not in fixing_cache:
                    computed = instrument.compute_fixings(
                        [(reset_date, curve_name, p_start, p_end)],
                        self._state_at(scenario_dates, reset_date, all_states),
                        reset_date,
                    )
                    for (cn, ps), rate in computed.items():
                        fixing_cache[(inst_id, cn, ps)] = rate
                fixings[(curve_name, p_start)] = fixing_cache[cache_key]

        return fixings

    # ------------------------------------------------------------------
    # CPI fixings accumulator
    # ------------------------------------------------------------------

    def _build_cpi_fixings(
        self,
        instrument,
        base_market_state: dict,
        sim_date: date,
        cpi_fixings_cache: Dict[int, dict],
        scenario_dates: List[date],
        all_states: List[dict],
    ) -> dict:
        """CPI bracket-date stamping with T_last_pub pre-seed (:370-433)."""
        if not hasattr(instrument, "get_cpi_reference_dates"):
            return {}

        stamped = cpi_fixings_cache.setdefault(id(instrument), {})

        # pre-seed the T_last_pub level so unpublished brackets can project
        # from it (the RiskFlow convention), then stamp each reference month
        # exactly once from the state interpolated to its bracket date
        if hasattr(instrument, "_compute_t_last_pub_fixing"):
            stamped.update(instrument._compute_t_last_pub_fixing(
                base_market_state, sim_date, stamped
            ))
        due = (
            (d, n) for d, n in instrument.get_cpi_reference_dates()
            if d <= sim_date and d not in stamped
        )
        for ref_date, _name in due:
            idx = max(0, bisect_right(scenario_dates, ref_date) - 1)
            stamped.update(instrument._compute_cpi_fixing_for_date(
                ref_date,
                _interp_scenario_state(all_states, scenario_dates, idx, ref_date),
            ))

        out = {"cpi_fixings": stamped, "cpi_last_pub_date": None}
        if hasattr(instrument, "get_cpi_last_pub_date"):
            out["cpi_last_pub_date"] = instrument.get_cpi_last_pub_date(sim_date)
        return out

    # ------------------------------------------------------------------
    # Commodity fixing accumulator
    # ------------------------------------------------------------------

    def _build_commodity_fixings(
        self,
        instrument,
        sim_date: date,
        commodity_fixings_cache: Dict[int, dict],
        scenario_dates: List[date],
        all_states: List[dict],
    ) -> dict:
        """Realized commodity prices stamped once per averaging date (:439-493)."""
        if not hasattr(instrument, "get_commodity_fixing_schedule"):
            return {}

        inst_id = id(instrument)
        accumulated = commodity_fixings_cache.setdefault(inst_id, {})

        for avg_date, pricing_date, fx_settle_date in (
            instrument.get_commodity_fixing_schedule()
        ):
            if pricing_date > sim_date:
                break
            key_fwd = (instrument.forward_curve_name, avg_date)
            if key_fwd in accumulated:
                continue
            fix_t_idx = max(0, bisect_right(scenario_dates, pricing_date) - 1)
            fix_state = _interp_scenario_state(
                all_states, scenario_dates, fix_t_idx, pricing_date
            )
            accumulated.update(
                instrument._compute_fixing_for_date(
                    avg_date, pricing_date, fx_settle_date, fix_state, pricing_date
                )
            )

        return accumulated

    # ------------------------------------------------------------------
    # Equity spot fixing accumulator
    # ------------------------------------------------------------------

    def _build_equity_fixings(
        self,
        instrument,
        sim_date: date,
        equity_fixings_cache: Dict[int, dict],
        scenario_dates: List[date],
        all_states: List[dict],
    ) -> dict:
        """Equity return-leg reset stamping (:499-546)."""
        if not hasattr(instrument, "get_equity_reset_schedule"):
            return {}

        inst_id = id(instrument)
        accumulated = equity_fixings_cache.setdefault(inst_id, {})

        for reset_date in instrument.get_equity_reset_schedule():
            if reset_date > sim_date:
                break
            key = (instrument.spot_name, reset_date)
            if key in accumulated:
                continue
            fix_t_idx = max(0, bisect_right(scenario_dates, reset_date) - 1)
            fix_state = _interp_scenario_state(
                all_states, scenario_dates, fix_t_idx, reset_date
            )
            accumulated.update(
                instrument._compute_equity_fixing_for_date(reset_date, fix_state)
            )

        return accumulated

    # ------------------------------------------------------------------
    # Close-out market state
    # ------------------------------------------------------------------

    def _pricing_market_state(
        self,
        market_state: dict,
        instrument,
        netting_set: NettingSet,
        trade_currency: str = "",
    ) -> dict:
        """Risky-curve substitution for FORWARD close-out (:552-587)."""
        csa = netting_set.csa
        if csa is None or csa.close_out_method is CloseOutMethod.STANDARD:
            return market_state

        risky_name = csa.risky_curve_name
        if isinstance(risky_name, dict):
            risky_name = risky_name.get(
                trade_currency or netting_set.reporting_currency
            )
        if risky_name is None or risky_name not in market_state:
            return market_state

        disc_name = getattr(instrument, "discount_curve_name", None)
        if disc_name is None or disc_name == risky_name:
            return market_state
        return {**market_state, disc_name: market_state[risky_name]}

    # ------------------------------------------------------------------
    # Collateral simulation
    # ------------------------------------------------------------------

    def _simulate_collateral(
        self, mtm_paths: np.ndarray, dates: List[date], csa, netting_set=None,
        im_paths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Pathwise collateral with MPOR lookback and two-sided VM (:593-633).

        ``im_paths`` (n_paths, n_times): precomputed pathwise IM (the SIMM
        method computes it during the pricing pass); otherwise IM comes
        from the per-date NONE/FIXED/SCHEDULE policy."""
        if im_paths is not None:
            date_idx = {d: i for i, d in enumerate(dates)}
            im_fn = lambda n, d: im_paths[:, date_idx[d]]
        else:
            im_fn = lambda n, d: self._compute_im(n, csa, d, netting_set)
        return simulate_collateral(mtm_paths, dates, csa, netting_set, im_fn=im_fn)

    @staticmethod
    def _trade_asset_class(instrument) -> str:
        """Explicit ``asset_class`` attribute wins; else infer from type."""
        explicit = getattr(instrument, "asset_class", None)
        if explicit:
            return str(explicit)
        name = type(instrument).__name__.lower()
        if "swap" in name or "bond" in name or "fra" in name:
            return "interest_rate"
        if "equity" in name or "trs" in name:
            return "equity"
        if "commodity" in name:
            return "commodity"
        if "fx" in name:
            return "fx"
        return "other"

    def _compute_im(
        self, n_paths: int, csa, sim_date: Optional[date] = None,
        netting_set=None,
    ) -> np.ndarray:
        """Pathwise IM for one time step (:635-648).

        SCHEDULE goes beyond the reference (which raises NotImplementedError
        there): gross standardised-schedule IM — sum over live trades of
        |notional| x grid pct(asset class, residual maturity), NGR fixed at
        1 (conservative; see portfolio.csa.IM_SCHEDULE_GRID).
        """
        if csa.im_method is InitialMarginMethod.NONE:
            return np.zeros(n_paths)
        if csa.im_method is InitialMarginMethod.FIXED:
            return np.full(n_paths, csa.im_amount)
        if csa.im_method is InitialMarginMethod.SCHEDULE:
            if netting_set is None or sim_date is None:
                raise ValueError(
                    "Schedule IM needs the netting set and simulation date."
                )
            from ..portfolio.csa import schedule_im_factor

            im = 0.0
            for trade in netting_set.trades:
                inst = trade.instrument
                end = getattr(inst, "effective_maturity", None) or getattr(
                    inst, "maturity_date", None
                )
                if end is None or end <= sim_date:
                    continue
                residual = (end - sim_date).days / 365.25
                notional = abs(float(getattr(inst, "notional", 0.0)))
                im += (
                    abs(trade.notional_scale) * notional
                    * schedule_im_factor(
                        ExposureEngine._trade_asset_class(inst), residual
                    )
                )
            return np.full(n_paths, im)
        if csa.im_method is InitialMarginMethod.SIMM:
            raise ValueError(
                "SIMM IM is computed pathwise during the pricing pass "
                "(ExposureEngine.compute -> _simm_im_paths); it is not "
                "available through the per-date policy interface."
            )
        raise ValueError(f"Unknown IM method: {csa.im_method}")

    def _simm_im_paths(
        self, base_state: dict, price_fn, base_total: np.ndarray, csa
    ) -> np.ndarray:
        """Pathwise SIMM delta margin at one simulation date.

        The reference declares the SIMM method but raises NotImplementedError
        (exposure_engine.py:640-644); here the delta margin is computed from
        finite-difference sensitivities of the NETTING-SET NPV paths:

        - every CurveSlice is shifted +1bp per SIMM tenor bucket (slice
          tenors map to their nearest bucket) -> bucketed PV01 paths;
        - every ScalarSlice is shifted +1%% relative -> scalar-class
          sensitivity paths (class from SimmConfig overrides or the
          factor-name heuristic);
        - aggregation (risk weights, tenor/intra-class/cross-class
          correlations) lives in portfolio.simm.

        Each bump re-prices the whole netting set vectorized over paths, so
        the cost is (n_buckets_touched) x the base pricing cost per date.
        Restrict ``SimmConfig.factors`` to the curves that matter to cut it.
        """
        from ..portfolio.simm import (
            IR_TENORS, SimmConfig, assign_ir_buckets, simm_im,
            weight_ir_sensitivities,
        )

        cfg = csa.simm_config or SimmConfig()
        p = cfg.params
        n_paths = base_total.shape[0]
        ir_s = np.zeros((n_paths, len(IR_TENORS)))
        scalar_ws: Dict[str, list] = {}
        has_ir = False
        for name, slc in base_state.items():
            if cfg.factors is not None and name not in cfg.factors:
                continue
            if isinstance(slc, CurveSlice):
                has_ir = True
                buckets = assign_ir_buckets(slc.tenors)
                shift = p.bump_bp * 1e-4
                for k in np.unique(buckets):
                    mask = (buckets == k).astype(np.float64)
                    bumped = CurveSlice(
                        slc.values + shift * mask[None, :], slc.tenors
                    )
                    s = (
                        price_fn({**base_state, name: bumped}) - base_total
                    ) / p.bump_bp
                    ir_s[:, int(k)] += s
            elif isinstance(slc, ScalarSlice):
                bumped = ScalarSlice(slc.values * (1.0 + p.bump_rel))
                s = (price_fn({**base_state, name: bumped}) - base_total) * (
                    0.01 / p.bump_rel
                )
                if not np.any(s):
                    continue  # factor not referenced by any trade
                cls = cfg.scalar_class(name)
                scalar_ws.setdefault(cls, []).append(
                    p.scalar_risk_weights[cls] * s
                )
        ws_ir = weight_ir_sensitivities(ir_s, p) if has_ir else None
        im = simm_im(ws_ir, scalar_ws or None, p)
        return np.broadcast_to(im.cpu().numpy(), (n_paths,)).copy()
