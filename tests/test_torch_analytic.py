"""The port's analytic layer against the JAX package, on the CPU at float64.

The same numpy-seeded inputs go through each JAX function and its port
(``finite_difference_tpu_torch.ops.special`` and ``.models.analytic``).
Tolerances, each of the JAX output's max|value| (per output of a dict):

- prices and every closed form: 1e-12;
- bump greeks: 1e-8 for delta and vega, 1e-7 for gamma. A bump quotient
  divides the prices' last-digit differences by the bump (1e-4 of spot),
  gamma by its square: a double-barrier lane's image series differs from
  JAX's by up to about 30 ulps of its price (exp and log are not the same
  library's), which the second difference turns into 2.4e-8 of max|gamma|;
- ``greeks_mode="ad"`` greeks against JAX's ``ad``: 1e-10;
- ``monitoring_decision``: exact.

Where compiling a JAX sweep would take most of a minute (``ad`` greeks, the
BGK sweep, the BS93 sweeps), the JAX side runs op by op under
``jax.disable_jit()``: the same functions, differing from their compiled
form in roundings only.
"""
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.analytic import batch as jax_batch
from finite_difference_tpu.models.analytic import bgk_horfelt as jax_bgk
from finite_difference_tpu.models.analytic import bjerksund_stensland as jax_bs93
from finite_difference_tpu.models.analytic import bjerksund_stensland_2002 as jax_bs02
from finite_difference_tpu.models.analytic import black_scholes as jax_bs
from finite_difference_tpu.models.analytic import double_barrier as jax_db
from finite_difference_tpu.models.analytic import reiner_rubinstein as jax_rr
from finite_difference_tpu.ops import special as jax_special
from finite_difference_tpu_torch.models.analytic import batch as port_batch
from finite_difference_tpu_torch.models.analytic import bgk_horfelt as port_bgk
from finite_difference_tpu_torch.models.analytic import bjerksund_stensland as port_bs93
from finite_difference_tpu_torch.models.analytic import bjerksund_stensland_2002 as port_bs02
from finite_difference_tpu_torch.models.analytic import black_scholes as port_bs
from finite_difference_tpu_torch.models.analytic import double_barrier as port_db
from finite_difference_tpu_torch.models.analytic import reiner_rubinstein as port_rr
from finite_difference_tpu_torch.ops import special as port_special

PRICE_TOL = 1e-12
BUMP_TOL = 1e-8
BUMP_GAMMA_TOL = 1e-7
AD_TOL = 1e-10
CPU = torch.device("cpu")


def _t(*xs):
    """numpy inputs as CPU tensors (float64, booleans kept)."""
    out = [torch.as_tensor(np.asarray(x)) for x in xs]
    return out[0] if len(out) == 1 else out


def _close(got, ref, tol, what=""):
    """``got`` (tensor, tuple or dict of tensors) against the JAX ``ref``,
    each within ``tol`` of its max|ref|."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _close(got[k], ref[k], tol, f"{what}.{k}")
        return
    if isinstance(ref, tuple):
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, tol, f"{what}[{i}]")
        return
    r = np.asarray(ref, dtype=np.float64)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got, dtype=np.float64)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    assert np.all(np.isfinite(r)), what
    scale = max(float(np.max(np.abs(r))), 1e-300) if r.size else 1.0
    err = float(np.max(np.abs(g - r))) if r.size else 0.0
    assert err <= tol * scale, f"{what}: {err / scale:.3e} > {tol}"


def _table(seed=0, B=24):
    rng = np.random.default_rng(seed)
    s = rng.uniform(80.0, 120.0, B)
    return dict(
        s=s, k=rng.uniform(80.0, 120.0, B), t=rng.uniform(0.1, 2.0, B),
        r=rng.uniform(0.0, 0.1, B), b=rng.uniform(-0.05, 0.1, B),
        sigma=rng.uniform(0.1, 0.5, B), is_call=rng.random(B) < 0.5,
        is_in=rng.random(B) < 0.5, is_up=rng.random(B) < 0.5,
        rebate=np.where(rng.random(B) < 0.5, rng.uniform(0.0, 5.0, B), 0.0),
        crossed=rng.random(B) < 0.2, u=rng.uniform(1.05, 1.6, B), d=rng.uniform(0.6, 0.95, B),
    )


# --------------------------------------------------------------------------- #
# ops.special                                                                  #
# --------------------------------------------------------------------------- #
def _special_case(name):
    rng = np.random.default_rng(1)
    if name == "norm_cdf":
        x = np.concatenate([rng.normal(0.0, 4.0, 500), [0.0, 7.0, 7.1, -7.1, 36.9, 38.0, -40.0]])
        return (x,)
    if name == "norm_pdf":
        return (rng.normal(0.0, 3.0, 500),)
    if name == "norm_icdf":
        return (rng.uniform(1e-6, 1.0 - 1e-6, 500),)
    return rng.normal(0.0, 1.5, 64), rng.normal(0.0, 1.5, 64), rng.uniform(-0.95, 0.95, 64)


@pytest.mark.parametrize("name", ["norm_cdf", "norm_pdf", "norm_icdf", "bivariate_norm_cdf"])
def test_special_functions_match_jax(name):
    args = _special_case(name)
    got = getattr(port_special, name)(*_t(*args)) if len(args) > 1 else \
        getattr(port_special, name)(_t(*args))
    if name == "bivariate_norm_cdf":  # JAX's form takes scalars (it vmaps)
        ref = np.array([float(jax_special.bivariate_norm_cdf(*row)) for row in zip(*args)])
    else:
        ref = getattr(jax_special, name)(*args)
    _close(got, ref, PRICE_TOL, name)


# --------------------------------------------------------------------------- #
# black_scholes                                                                #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", [
    "black76_price", "generalized_bs_price", "bs_price",
    "generalized_bs_greeks", "bs_greeks", "black76_greeks",
])
def test_black_scholes_matches_jax(name):
    c = _table(2)
    sigma, t = c["sigma"].copy(), c["t"].copy()
    sigma[0], t[1] = 0.0, 0.0  # degenerate lanes: discounted intrinsic
    if name.startswith("black76"):
        fwd = c["s"] * np.exp(c["b"] * t)
        args = (fwd, c["k"], sigma, t) + ((np.exp(-c["r"] * t),) if name == "black76_price" else (c["r"],))
        if name == "black76_greeks":  # greeks divide by sigma*sqrt(t)
            args = (fwd, c["k"], c["sigma"], c["t"], c["r"])
        args = args + (c["is_call"],)
    elif name.endswith("greeks"):
        args = (c["s"], c["k"], c["sigma"], c["t"], c["r"], c["b"], c["is_call"])
    else:
        args = (c["s"], c["k"], sigma, t, c["r"], c["b"], c["is_call"])
    _close(getattr(port_bs, name)(*_t(*args)), getattr(jax_bs, name)(*args), PRICE_TOL, name)


# --------------------------------------------------------------------------- #
# reiner_rubinstein                                                            #
# --------------------------------------------------------------------------- #
def _rr_args(c):
    h = np.where(c["is_up"], c["s"] * c["u"], c["s"] * c["d"])
    return (c["s"], c["k"], h, c["t"], c["r"], c["b"], c["sigma"],
            c["is_call"], c["is_up"], c["is_in"])


def test_barrier_factors_match_jax():
    c = _table(3)
    s, x, h, t, r, b, sig = _rr_args(c)[:7]
    phi = np.where(c["is_call"], 1.0, -1.0)
    eta = np.where(c["is_up"], -1.0, 1.0)
    args = (s, x, h, c["rebate"], t, r, b, sig, phi, eta)
    _close(tuple(port_rr.barrier_factors(*_t(*args))), tuple(jax_rr.barrier_factors(*args)),
           PRICE_TOL, "factors")


@pytest.mark.parametrize("timing_in", ["expiry", "hit"])
@pytest.mark.parametrize("timing_out", ["hit", "expiry"])
def test_barrier_price_matches_jax(timing_in, timing_out):
    c = _table(4)
    args = _rr_args(c)
    kw = dict(rebate_timing_in=timing_in, rebate_timing_out=timing_out)
    got = port_rr.barrier_price(*_t(*args), rebate=_t(c["rebate"]), crossed=_t(c["crossed"]), **kw)
    ref = jax_rr.barrier_price(*args, rebate=c["rebate"], crossed=c["crossed"], **kw)
    _close(got, ref, PRICE_TOL, "barrier_price")


def test_barrier_engine_matches_jax():
    c = _table(5, B=6)
    for i in range(6):
        h = c["s"][i] * (c["u"][i] if c["is_up"][i] else c["d"][i])
        kw = dict(s=c["s"][i], b=c["b"][i], r=c["r"][i], t=c["t"][i], x=c["k"][i],
                  sigma=c["sigma"][i], h=h, optionflag="c" if c["is_call"][i] else "p",
                  directionflag="u" if c["is_up"][i] else "d",
                  in_out_flag="i" if c["is_in"][i] else "o", k=c["rebate"][i],
                  barrier_status="crossed" if i == 0 else None, rebate_timing_out="expiry")
        got, ref = port_rr.BarrierEngine(device="cpu", **kw), jax_rr.BarrierEngine(**kw)
        for k, v in ref.get_factors().items():
            assert got.get_factors()[k] == pytest.approx(v, rel=PRICE_TOL, abs=1e-13), (i, k)
        assert got.price() == pytest.approx(ref.price(), rel=PRICE_TOL, abs=1e-13), i
        assert got.vanilla() == pytest.approx(ref.vanilla(), rel=PRICE_TOL, abs=1e-13), i


# --------------------------------------------------------------------------- #
# double_barrier                                                               #
# --------------------------------------------------------------------------- #
def _db_args(c):
    lo, up = c["s"] * c["d"], c["s"] * c["u"]
    lo[0] = c["s"][0] * 1.01  # spot outside the corridor: 0
    return (c["s"], c["k"], lo, up, c["t"], c["r"], c["b"], c["sigma"], c["is_call"])


@pytest.mark.parametrize("m", [4, 5])
def test_double_barrier_matches_jax(m):
    c = _table(6)
    args = _db_args(c)
    _close(port_db.double_barrier_ko_price(*_t(*args), m=m),
           jax_db.double_barrier_ko_price(*args, m=m), PRICE_TOL, "ko")
    _close(port_db.double_barrier_price(*_t(*args, c["is_in"]), m=m),
           jax_db.double_barrier_price(*args, c["is_in"], m=m), PRICE_TOL, "price")
    for i in range(4):
        kw = dict(S=c["s"][i], X=c["k"][i], L=args[2][i], U=args[3][i], sigma=c["sigma"][i],
                  callflag="c" if c["is_call"][i] else "p", inflag="in" if c["is_in"][i] else "out",
                  m=m)
        pk = dict(b=c["b"][i], r=c["r"][i], T=c["t"][i])
        assert port_db.DoubleBarrier(device="cpu", **kw).price(**pk) == pytest.approx(
            jax_db.DoubleBarrier(**kw).price(**pk), rel=PRICE_TOL, abs=1e-13), i


# --------------------------------------------------------------------------- #
# bgk_horfelt                                                                  #
# --------------------------------------------------------------------------- #
def _bgk_case(seed=7, B=24):
    c = _table(seed, B)
    fwd = c["s"] * np.exp(c["b"] * c["t"])
    h = np.where(c["is_up"], c["s"] * c["u"], c["s"] * c["d"])
    m = np.floor(np.random.default_rng(seed).uniform(1, 60, B))
    return c, fwd, h, m


def test_bgk_blocks_match_jax():
    c, fwd, h, m = _bgk_case()
    a, b, th = c["u"] - 1.2, c["d"] - 0.7, c["b"] * 3.0
    _close(port_bgk.phi_coord(*_t(h, c["s"], c["sigma"], c["t"])),
           jax_bgk.phi_coord(h, c["s"], c["sigma"], c["t"]), PRICE_TOL, "phi_coord")
    _close(tuple(port_bgk.thetas(*_t(c["b"], c["sigma"], c["t"]))),
           jax_bgk.thetas(c["b"], c["sigma"], c["t"]), PRICE_TOL, "thetas")
    for name in ("f_plus", "f_minus"):
        _close(getattr(port_bgk, name)(*_t(a, b, th)), getattr(jax_bgk, name)(a, b, th),
               PRICE_TOL, name)
    _close(port_bgk.bgk_shift_mag(_t(m)), jax_bgk.bgk_shift_mag(m), PRICE_TOL, "shift")
    _close(port_bgk.bgk_shift_mag(_t(m), t=_t(c["t"]), mean_sqrt_dt=_t(np.sqrt(c["t"] / m))),
           jax_bgk.bgk_shift_mag(m, t=c["t"], mean_sqrt_dt=np.sqrt(c["t"] / m)),
           PRICE_TOL, "shift_mean_sqrt_dt")
    _close(port_bgk.g_continuous(*_t(a - 0.5, a, b - 1.0, b + 1.0, th), series_terms=20),
           jax_bgk.g_continuous(a - 0.5, a, b - 1.0, b + 1.0, th, series_terms=20),
           PRICE_TOL, "g_continuous")


def test_bgk_out_prices_match_jax():
    c, fwd, h, m = _bgk_case(8)
    df = np.exp(-c["r"] * c["t"])
    spot = c["s"] * 1.001
    args = (c["s"], c["k"], h, fwd, c["b"], c["sigma"], c["t"], df, m, c["is_call"], c["is_up"])
    _close(port_bgk.single_barrier_out_price(*_t(*args), spot=_t(spot)),
           jax_bgk.single_barrier_out_price(*args, spot=spot), PRICE_TOL, "single")
    lo, up = c["s"] * c["d"], c["s"] * c["u"]
    dargs = (c["s"], c["k"], lo, up, fwd, c["b"], c["sigma"], c["t"], df, m, c["is_call"])
    _close(port_bgk.double_barrier_out_price(*_t(*dargs)),
           jax_bgk.double_barrier_out_price(*dargs), PRICE_TOL, "double")
    _close(port_bgk.survival_prob(*_t(c["s"], h, c["b"], c["sigma"], c["t"], m, c["is_up"])),
           jax_bgk.survival_prob(c["s"], h, c["b"], c["sigma"], c["t"], m, c["is_up"]),
           PRICE_TOL, "survival")


def test_hazard_rebate_pv_matches_jax():
    """The port broadcasts rows along the last axis; JAX takes one row."""
    c, fwd, h, m = _bgk_case(9, B=5)
    M = 12
    cum_t = c["t"][:, None] * np.arange(1, M + 1)[None, :] / M
    dfs = np.exp(-c["r"][:, None] * cum_t)
    got = port_bgk.hazard_rebate_pv(*_t(c["s"], h, c["b"], c["sigma"], cum_t, dfs, c["rebate"],
                                        c["is_up"]))
    for i in range(5):
        ref = jax_bgk.hazard_rebate_pv(c["s"][i], h[i], c["b"][i], c["sigma"][i], cum_t[i],
                                       dfs[i], c["rebate"][i], bool(c["is_up"][i]))
        _close(tuple(g[i] for g in got), tuple(ref), PRICE_TOL, f"hazard[{i}]")


# --------------------------------------------------------------------------- #
# Bjerksund–Stensland 1993 and 2002                                            #
# --------------------------------------------------------------------------- #
def _american_case(seed=11, B=24):
    c = _table(seed, B)
    q = np.random.default_rng(seed).uniform(0.0, 0.12, B)
    return c, c["s"] * np.exp((c["r"] - q) * c["t"])


@pytest.mark.parametrize("name", ["american_call_bs93", "american_put_bs93", "american_price_bs93"])
def test_bs93_matches_jax(name):
    c, f = _american_case()
    args = (c["s"], f, c["k"], c["t"], c["r"], c["sigma"])
    args = args + ((c["is_call"],) if name == "american_price_bs93" else ())
    _close(getattr(port_bs93, name)(*_t(*args)), getattr(jax_bs93, name)(*args), PRICE_TOL, name)


def test_bs93_scalar_pricer_matches_jax():
    kw = dict(spot=100.0, strike=105.0, expiry=0.7, rate=0.06, vol=0.3, div_yield=0.04)
    got = port_bs93.BjerksundStenslandOptionPricer(device="cpu", **kw)
    ref = jax_bs93.BjerksundStenslandOptionPricer(**kw)
    assert got.price_call() == pytest.approx(ref.price_call(), rel=PRICE_TOL)
    assert got.price_put() == pytest.approx(ref.price_put(), rel=PRICE_TOL)
    for leg in ("greeks_call", "greeks_put"):
        g, r = getattr(got, leg)(), getattr(ref, leg)()
        for k in r:
            assert g[k] == pytest.approx(r[k], rel=BUMP_TOL, abs=BUMP_TOL), (leg, k)


@pytest.mark.parametrize("variant", ["riskflow_1993", "paper_2002_modified"])
def test_bs2002_matches_jax(variant):
    c, _ = _american_case(12, B=6)
    args = (c["s"], c["k"], c["r"], c["b"] * 0.5, c["sigma"], c["t"])
    _close(port_bs02.boundary_XT(*_t(c["k"], c["r"], c["b"], c["sigma"], c["t"]), variant),
           jax_bs02.boundary_XT(c["k"], c["r"], c["b"], c["sigma"], c["t"], variant),
           PRICE_TOL, "boundary_XT")
    _close(tuple(port_bs02.american_call_single_2002(*_t(*args), variant)),
           jax_bs02.american_call_single_2002(*args, variant), PRICE_TOL, "single")
    got = port_bs02.american_call_two_step_2002(*_t(*args), variant)
    for i in range(6):  # JAX's bivariate CDF takes scalars
        ref = jax_bs02.american_call_two_step_2002(*(a[i] for a in args), variant)
        _close(tuple(g[i] for g in got), tuple(ref), PRICE_TOL, f"two_step[{i}]")


@pytest.mark.parametrize("method", ["single", "two_step", "proxy"])
def test_bs2002_scalar_pricer_matches_jax(method):
    kw = dict(S=100.0, K=95.0, T=0.8, r=0.05, sigma=0.3, option_type="put", q=0.03,
              method=method)
    got = port_bs02.BjerksundStensland2002Pricer(device="cpu")
    ref = jax_bs02.BjerksundStensland2002Pricer()
    g, r = got.price(**kw), ref.price(**kw)
    for k in r:
        assert g[k] == pytest.approx(r[k], rel=PRICE_TOL, abs=1e-13), k
    g, r = got.greeks(**kw), ref.greeks(**kw)
    for k in r:
        assert g[k] == pytest.approx(r[k], rel=BUMP_TOL, abs=BUMP_TOL), k


# --------------------------------------------------------------------------- #
# analytic.batch                                                               #
# --------------------------------------------------------------------------- #
def _mixed_table(seed=13, B=24):
    """Vanillas, singles (up and down, IN lanes, rebates) and doubles."""
    c = _table(seed, B)
    kind = np.arange(B) % 4  # 0 vanilla, 1 up, 2 down, 3 double
    lower = [float(c["s"][i] * c["d"][i]) if kind[i] in (2, 3) else None for i in range(B)]
    upper = [float(c["s"][i] * c["u"][i]) if kind[i] in (1, 3) else None for i in range(B)]
    rebate = np.where(kind == 3, 0.0, c["rebate"])  # no rebates on doubles
    kw = dict(lower=lower, upper=upper, is_call=c["is_call"], is_in=c["is_in"], rebate=rebate)
    return (c["s"], c["k"], c["t"], c["r"], c["b"], c["sigma"]), kw, c


@pytest.mark.parametrize("crossed", [False, True])
def test_continuous_barrier_sweep_matches_jax(crossed):
    args, kw, c = _mixed_table()
    kw["crossed"] = c["crossed"] if crossed else False
    _close(port_batch.continuous_barrier_sweep(*args, device="cpu", **kw),
           jax_batch.continuous_barrier_sweep(*args, **kw), PRICE_TOL, "sweep")


@pytest.mark.parametrize("greeks_mode", ["bump", "ad"])
def test_continuous_barrier_sweep_greeks_matches_jax(greeks_mode):
    args, kw, _ = _mixed_table(14)
    got = port_batch.continuous_barrier_sweep_greeks(*args, greeks_mode=greeks_mode, device="cpu",
                                                     **kw)
    with jax.disable_jit(greeks_mode == "ad"):
        ref = jax_batch.continuous_barrier_sweep_greeks(*args, greeks_mode=greeks_mode, **kw)
    _close(got["price"], ref["price"], PRICE_TOL, "price")
    for k in ("delta", "gamma", "vega"):
        assert torch.isfinite(got[k]).all(), k
        tol = AD_TOL if greeks_mode == "ad" else BUMP_GAMMA_TOL if k == "gamma" else BUMP_TOL
        _close(got[k], ref[k], tol, k)


def test_bgk_discrete_sweep_matches_jax():
    """Singles, a double, vanillas, IN lanes, rebates at hit and at expiry,
    already-hit lanes, zero-monitor lanes, on a padded (B, M) monitor grid."""
    rng = np.random.default_rng(15)
    B, M = 16, 10
    args, kw, c = _mixed_table(15, B)
    s, k, t, r, b, sigma = args
    fwd, df = s * np.exp(b * t), np.exp(-r * t)
    m = np.floor(rng.uniform(1, M + 1, B))
    m[5] = 0.0
    cum_t = np.stack([np.minimum(np.arange(1, M + 1), mi) * ti / max(mi, 1.0)
                      for mi, ti in zip(m, t)])
    dfs = np.where(np.arange(1, M + 1)[None, :] <= m[:, None], np.exp(-r[:, None] * cum_t), 0.0)
    sweep = dict(lower=kw["lower"], upper=kw["upper"], is_call=kw["is_call"], is_in=kw["is_in"],
                 spot=s * 1.0005, already_hit=rng.random(B) < 0.15, rebate=kw["rebate"],
                 rebate_at_hit=rng.random(B) < 0.5, monitor_cum_t=cum_t, monitor_dfs=dfs)
    pargs = (s, k, fwd, b, sigma, t, df, m)
    with jax.disable_jit():
        ref = jax_batch.bgk_discrete_sweep(*pargs, series_terms=20, **sweep)
        # the placeholder monitor grid, with the batch carried by the barriers only
        plain = dict(lower=[90.0, 85.0, 80.0], series_terms=5)
        scalars = (100.0, 100.0, 101.0, 0.01, 0.2, 1.0, 0.95, 12.0)
        ref_plain = jax_batch.bgk_discrete_sweep(*scalars, **plain)
    _close(port_batch.bgk_discrete_sweep(*pargs, series_terms=20, device="cpu", **sweep), ref,
           PRICE_TOL, "bgk")
    _close(port_batch.bgk_discrete_sweep(*scalars, device="cpu", **plain), ref_plain, PRICE_TOL,
           "bgk_placeholder")


def test_bs93_sweeps_match_jax():
    c, f = _american_case(16)
    args = (c["s"], f, c["k"], c["t"], c["r"], c["sigma"], c["is_call"])
    with jax.disable_jit():
        ref_price, ref = jax_batch.bs93_sweep(*args), jax_batch.bs93_sweep_greeks(*args)
    _close(port_batch.bs93_sweep(*args, device="cpu"), ref_price, PRICE_TOL, "bs93_sweep")
    got = port_batch.bs93_sweep_greeks(*args, device="cpu")
    _close(got["price"], ref["price"], PRICE_TOL, "price")
    for k in ("delta", "gamma", "vega"):
        _close(got[k], ref[k], BUMP_GAMMA_TOL if k == "gamma" else BUMP_TOL, k)


def test_bs2002_sweep_matches_jax():
    c, _ = _american_case(17, B=12)
    args = (c["s"], c["k"], c["r"], c["b"] * 0.5, c["sigma"], c["t"])
    _close(port_batch.bs2002_sweep(*args, device="cpu"), jax_batch.bs2002_sweep(*args),
           PRICE_TOL, "bs2002")


def test_monitoring_decision_matches_jax_exactly():
    rng = np.random.default_rng(18)
    B = 12
    t = rng.uniform(0.1, 2.0, B)
    sigma = rng.uniform(0.1, 0.5, B)
    monitors = [list(np.linspace(ti / n, ti, n)) for ti, n in
                zip(t, rng.choice([1, 4, 52, 250, 3000, 9000], B))]
    monitors[0] = []  # no monitor: discrete, no shift
    monitors[1] = [t[1] * 2.0]  # beyond expiry only
    got = port_batch.monitoring_decision(t, monitors, sigma)
    ref = jax_batch.monitoring_decision(t, monitors, sigma)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].any() and not got[0].all()


def test_sweeps_default_to_the_card(monkeypatch):
    """Without a card the sweeps raise unless given device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, kw, _ = _mixed_table()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_batch.continuous_barrier_sweep(*args, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bs.generalized_bs_price(100.0, 100.0, 0.2, 1.0, 0.05, 0.05, True)
    assert port_batch.continuous_barrier_sweep(*args, device="cpu", **kw).device == CPU
