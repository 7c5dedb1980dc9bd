"""The port's FA-validation tools against the JAX package, on the CPU at
float64: the FIS S-space stencil pricer (``models.pde.fis_stencil``), the
log-depth tridiagonal solve on the stencil's own systems,
``stepper.BarrierSpec.none``, the order-of-accuracy diagnostics
(``order_accuracy``) and the cross-check engine (``crosscheck``).

The same inputs go through both packages. Tolerances:

- the FIS stencil at 150 nodes x 150 steps: the value grid, prices and
  greeks within 1e-10 of max|value| (the port marches with the log-depth
  solve, factored once per coefficient set; JAX with the sequential
  Thomas algorithm);
- the port's ``thomas_solve`` and its factored form
  (``thomas_factor`` + ``const_solve``) against JAX's sequential
  ``thomas_solve`` on the stencil's Rannacher and CN systems: 1e-12
  relative to max|x|;
- the order diagnostics (host numpy, copied): exactly;
- the cross-check engine: price and greeks within 1e-10 of max|value|.
"""
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import crosscheck as jax_xc
from finite_difference_tpu.models.pde import fis_stencil as jax_fis
from finite_difference_tpu.models.pde import order_accuracy as jax_oa
from finite_difference_tpu.models.pde import stepper as jax_stepper
from finite_difference_tpu.ops import tridiag as jax_tridiag
from finite_difference_tpu_torch.models.pde import crosscheck as port_xc
from finite_difference_tpu_torch.models.pde import fis_stencil as port_fis
from finite_difference_tpu_torch.models.pde import order_accuracy as port_oa
from finite_difference_tpu_torch.models.pde import stepper as port_stepper
from finite_difference_tpu_torch.ops import tridiag as port_tridiag

VAL = dt.date(2025, 7, 28)
MAT = dt.date(2025, 8, 28)
WEEKLY = [VAL + dt.timedelta(days=7 * k) for k in range(1, 5)]


def _fis(mod, extra=None, **kw):
    base = dict(spot=229.74, strike=190.0, valuation_date=VAL, maturity_date=MAT,
                volatility=0.2879, option_type="call", barrier_type="up-and-out",
                upper_barrier=260.0, monitoring_dates=WEEKLY, flat_rate_nacc=0.0705,
                num_space_nodes=150, num_time_steps=150)
    base.update(kw)
    return mod.DiscreteBarrierFDMPricer2(**base, **(extra or {}))


FIS_CASES = {
    "uo_call": dict(),
    "ui_call": dict(barrier_type="up-and-in"),
    "uo_call_near_barrier": dict(spot=255.0),
    "do_put": dict(option_type="put", strike=240.0, barrier_type="down-and-out",
                   upper_barrier=None, lower_barrier=200.0, spot=215.0),
    "continuous_window": dict(monitoring_dates=[VAL + dt.timedelta(days=k) for k in range(1, 32)],
                              num_time_steps=4),
    "vanilla": dict(barrier_type="none", monitoring_dates=[]),
    "double_in_dividend": dict(barrier_type="double-in", lower_barrier=190.0,
                               dividends=[(dt.date(2025, 8, 10), 2.0)], rannacher_steps=4),
}


class TestFISStencil:
    @pytest.mark.parametrize("name", list(FIS_CASES))
    def test_matches_jax(self, name):
        kw = FIS_CASES[name]
        j, p = _fis(jax_fis, **kw), _fis(port_fis, dict(device="cpu"), **kw)
        assert p.use_bgk_correction == j.use_bgk_correction
        np.testing.assert_array_equal(p.S_nodes, j.S_nodes)
        _, v_want, s_eff = j._solve_grid_once()
        _, v_got, s_eff_got = p._solve_grid_once()
        assert s_eff_got == s_eff
        scale = np.abs(v_want).max()
        assert np.abs(v_got - v_want).max() <= 1e-10 * scale
        want = {"price": j.price(), **j.greeks()}
        got = {"price": p.price(), **p.greeks()}
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-10 * max(scale, abs(want[key])), key

    def test_in_out_parity_and_vanilla(self):
        """KO + KI = the same grid's vanilla solve (test_pde_extensions.py)."""
        ko = _fis(port_fis, dict(device="cpu")).price()
        ki = _fis(port_fis, dict(device="cpu"), barrier_type="up-and-in").price()
        vanilla = _fis(port_fis, dict(device="cpu"), barrier_type="none", monitoring_dates=[]).price()
        assert ko + ki == pytest.approx(vanilla, rel=1e-12)
        assert ko < vanilla

    @pytest.mark.parametrize("theta_set", [0, 1])
    def test_log_depth_solve_matches_the_sequential_one(self, theta_set):
        """The port's solve against JAX's sequential Thomas algorithm on the
        stencil's own systems (the Rannacher set and the CN set, with the
        non-symmetric rows at the barrier)."""
        pr = _fis(port_fis, dict(device="cpu"), spot=255.0, num_space_nodes=400)
        lo, up = pr._effective_barriers_for_pricing()
        sub, main, sup, ea, eb, ec = (c[theta_set] for c in pr._coefficient_sets(lo, up, 0.2879))
        v = pr._terminal_payoff_array()
        rhs = eb * v
        rhs[1:] += ea[1:] * v[:-1]
        rhs[:-1] += ec[:-1] * v[1:]
        rhs[-1] = pr.S_nodes[-1] - 190.0
        want = np.asarray(jax_tridiag.thomas_solve(*(jnp.asarray(a) for a in (sub, main, sup, rhs))))
        t = lambda a: torch.as_tensor(a)
        got = port_tridiag.thomas_solve(t(sub), t(main), t(sup), t(rhs)).numpy()
        factored = port_tridiag.const_solve(port_tridiag.thomas_factor(t(sub), t(main), t(sup)),
                                            t(rhs)).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-12 * scale
        assert np.abs(factored - want).max() <= 1e-12 * scale

    def test_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _fis(port_fis)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_barrier_spec_none(dtype):
    """JAX's ``BarrierSpec.none`` for one trade, one row per trade here."""
    want = jax_stepper.BarrierSpec.none()
    got = port_stepper.BarrierSpec.none(3, dtype=dtype, device="cpu")
    for w, g in zip(want, got):
        assert g.shape == (3,)
        assert g.dtype == (torch.bool if w.dtype == jnp.bool_ else dtype)
        assert (g.numpy() == np.asarray(w)).all()


ORDER_CASES = {
    "first_order": (lambda n: 10.0 + 3.0 / n, dict(richardson_reference=False)),
    "second_order": (lambda n: 10.0 + 5.0 / n**2, dict(richardson_reference=False)),
    "richardson": (lambda n: 10.0 + 5.0 / n**2 + 0.3 / n**3, dict()),
}


class TestOrderOfAccuracy:
    @pytest.mark.parametrize("name", list(ORDER_CASES))
    def test_fit_matches_jax(self, name):
        fn, kw = ORDER_CASES[name]
        want = jax_oa.compute_empirical_order(fn, **kw)
        got = port_oa.compute_empirical_order(fn, **kw)
        assert got == want
        assert port_oa.predict_truncation_error(got, 30) == jax_oa.predict_truncation_error(want, 30)
        assert port_oa.greek_order_of_accuracy(fn) == jax_oa.greek_order_of_accuracy(fn)

    @pytest.mark.parametrize("observed, verdict", [(0.004, "CONSISTENT"), (0.5, "EXCEEDS")])
    def test_verdict_matches_jax(self, observed, verdict):
        fn = lambda n: 10.0 + 5.0 / n**2
        want = jax_oa.diagnose_order_of_accuracy(fn, observed_difference=observed, n_production=30)
        got = port_oa.diagnose_order_of_accuracy(fn, observed_difference=observed, n_production=30)
        assert got == want and got["verdict"] == verdict

    def test_on_the_fis_stencil(self):
        """The diagnostic on the port's FIS stencil price, as JAX's on its own."""
        fns = {m: (lambda n, m=m: _fis(m, dict(device="cpu") if m is port_fis else None,
                                       num_time_steps=n, num_space_nodes=120).price())
               for m in (jax_fis, port_fis)}
        kw = dict(observed_difference=0.01, n_ladder=(40, 80, 160), t_expiry=31 / 365)
        want = jax_oa.diagnose_order_of_accuracy(fns[jax_fis], **kw)
        got = port_oa.diagnose_order_of_accuracy(fns[port_fis], **kw)
        np.testing.assert_allclose(got["prices"], want["prices"], rtol=1e-12)
        assert got["order"] == pytest.approx(want["order"], rel=1e-6)
        assert got["verdict"] == want["verdict"]


class TestCrossCheck:
    @staticmethod
    def _pricer(mod, barrier_type, extra=None, **kw):
        return mod.QLDiscreteBarrierPricer(
            mod.MarketParams(spot=229.74, strike=190.0, sigma=0.2879, rate_nacc=0.0705),
            is_call=True, barrier_type=barrier_type, monitoring_dates=WEEKLY + [MAT],
            maturity_date=MAT, barrier=260.0, valuation_date=VAL, grid_points=200,
            min_time_steps=200, **kw, **(extra or {}))

    @pytest.mark.parametrize("barrier_type", ["up-and-out", "up-and-in"])
    def test_matches_jax(self, barrier_type):
        assert port_xc.HAS_QUANTLIB == jax_xc.HAS_QUANTLIB
        j = self._pricer(jax_xc, barrier_type)
        p = self._pricer(port_xc, barrier_type, dict(device="cpu"))
        assert p.time_steps == j.time_steps and p.tenor_years == j.tenor_years
        want, got = j.price_and_greeks(), p.price_and_greeks()
        assert set(got) == set(want)
        scale = max(abs(v) for v in want.values())
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-10 * scale, key

    def test_ki_parity_and_time_steps(self):
        assert port_xc.fis_time_steps(24, 200, 4) == jax_xc.fis_time_steps(24, 200, 4) == 200
        assert port_xc.fis_time_steps(100, 200, 4) == 400
        ko = self._pricer(port_xc, "up-and-out", dict(device="cpu"))
        ki = self._pricer(port_xc, "up-and-in", dict(device="cpu"))
        v = ko.price_vanilla_FD()["price"]
        assert ko.price_and_greeks()["price"] + ki.price_and_greeks()["price"] == pytest.approx(v, rel=1e-9)
        with pytest.raises(ValueError, match="'in' or 'out'"):
            self._pricer(port_xc, "none", dict(device="cpu")).price_and_greeks()
