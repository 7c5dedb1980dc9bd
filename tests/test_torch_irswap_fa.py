"""The port's IR swap FA check (``finite_difference_tpu_torch.runners.irswap_fa``)
against the JAX package on the CPU, and tests/test_irswap_fa.py's six
checks on the port, its pinned synthetic-curve goldens included.

The pay and receive leg PVs are held to JAX's within 1e-12 relative on
several swaps. On these inputs the two packages agree bit for bit (the
same numpy arithmetic in both); both give pay and receive PVs 1 ulp
(1.8e-16 relative) below the pinned goldens, which 1e-12 covers.
"""
import datetime as dt
import os
import subprocess
import sys

import pytest

from finite_difference_tpu.runners import irswap_fa as jax_fa
from finite_difference_tpu_torch.runners import irswap_fa as port_fa
from finite_difference_tpu_torch.runners.irswap_fa import run_irswap_fa_check, synthetic_zar_curves

VAL = dt.date(2025, 7, 28)
MAT = dt.date(2030, 7, 28)
LEG_GAP = 1e-12
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _swap(module=port_fa, **kw):
    discount, receive = module.synthetic_zar_curves(VAL)
    base = dict(effective_date=VAL, maturity_date=MAT, notional=1_000_000, value_date=VAL, receive_curve=receive,
                discount_curve=discount)
    base.update(kw)
    return module.IRSwapFAPricer(**base)


class TestIRSwapFAWorkflow:
    """tests/test_irswap_fa.py on the port."""

    def test_synthetic_goldens(self):
        swap = _swap()
        assert swap.pay_leg_pv() == pytest.approx(327214.7213617418, rel=1e-12)
        assert swap.receive_leg_pv() == pytest.approx(316727.46266538475, rel=1e-12)
        assert swap.net_pv() == pytest.approx(-10487.258696357021, rel=1e-10)

    def test_fa_diff_table(self, capsys):
        out = run_irswap_fa_check(334439.05, -27800.25)
        printed = capsys.readouterr().out
        assert "Relative difference in Pay Leg PV" in printed
        assert "FA Total PV: -27,800.25" in printed
        assert out["rel_diff_pay"] == pytest.approx((out["pay_pv"] - 334439.05) / 334439.05)
        assert abs(out["rel_diff_pay"]) < 0.05
        assert abs(out["rel_diff_receive"]) < 0.05

    def test_pay_leg_is_fixed_annuity(self):
        swap = _swap()
        annuity = 0.0
        for p_start, p_end, pay_date, accrual in swap.pay_schedule:
            t = swap.sc.curve_year_fraction(VAL, pay_date)
            annuity += float(swap.discount_curve.discount_factor([t])[0, 0]) * accrual
        assert swap.pay_leg_pv() == pytest.approx(0.08 * annuity * 1e6, rel=1e-12)

    def test_receive_leg_decreases_with_spread(self):
        lo = _swap(receive_spread=0.0).receive_leg_pv()
        hi = _swap(receive_spread=0.02).receive_leg_pv()
        swap = _swap()
        annuity = sum(
            float(swap.discount_curve.discount_factor([swap.sc.curve_year_fraction(VAL, pay)])[0, 0]) * acc
            for _, _, pay, acc in swap.receive_schedule
        )
        assert hi - lo == pytest.approx(0.02 * annuity * 1e6, rel=1e-10)

    def test_quarterly_modfollowing_schedule(self):
        swap = _swap()
        assert len(swap.pay_schedule) == 20  # 5y quarterly
        for start, end, pay, accrual in swap.pay_schedule:
            assert swap.sc.cal.is_working_day(start)
            assert swap.sc.cal.is_working_day(end)
            assert 0.2 < accrual < 0.3

    def test_forward_fixing_tenor_used(self):
        with_tenor = _swap(fixing_tenor_months=3).receive_leg_pv()
        without = _swap(fixing_tenor_months=None).receive_leg_pv()
        assert with_tenor != without
        assert with_tenor == pytest.approx(without, rel=1e-3)


class TestIRSwapFAEqualJax:
    @pytest.mark.parametrize("kw", [
        {},
        {"receive_spread": 0.0},
        {"fixing_tenor_months": None},
        {"pay_payment_frequency": 6, "pay_fixed_rate": 0.0825},
        {"value_date": dt.date(2026, 2, 17)},  # seasoned: the first periods have paid
        {"effective_date": dt.date(2025, 9, 30), "maturity_date": dt.date(2035, 9, 28), "notional": 25e6},
    ], ids=["base", "no_spread", "period_forwards", "semiannual_pay", "seasoned", "forward_start_10y"])
    def test_leg_pvs(self, kw):
        port, jax_swap = _swap(**kw), _swap(jax_fa, **kw)
        assert port.pay_schedule == jax_swap.pay_schedule
        assert port.receive_schedule == jax_swap.receive_schedule
        for leg in ("pay_leg_pv", "receive_leg_pv"):
            got, want = getattr(port, leg)(), getattr(jax_swap, leg)()
            assert abs(got - want) <= LEG_GAP * abs(want), (leg, got, want)

    def test_fa_check_rows(self):
        got = run_irswap_fa_check(334439.05, -27800.25, verbose=False)
        want = jax_fa.run_irswap_fa_check(334439.05, -27800.25, verbose=False)
        assert list(got) == list(want)
        for k in ("pay_pv", "receive_pv"):
            assert abs(got[k] - want[k]) <= LEG_GAP * abs(want[k]), k
        # the net of the two legs: relative to the legs it is made of
        assert abs(got["total_pv"] - want["total_pv"]) <= LEG_GAP * abs(want["pay_pv"])

    def test_curves_equal_jax(self):
        for got, want in zip(synthetic_zar_curves(VAL), jax_fa.synthetic_zar_curves(VAL)):
            assert (got.year_fracs == want.year_fracs).all() and (got.rates == want.rates).all()

    def test_main_prints_the_table(self):
        """``python -m ...irswap_fa`` runs the check, with no platform switch."""
        out = subprocess.run([sys.executable, "-m", "finite_difference_tpu_torch.runners.irswap_fa"], cwd=REPO_ROOT,
                             capture_output=True, text=True, check=True, timeout=120).stdout
        assert "Total PV: -10,487.26" in out and "FA Total PV: -27,800.25" in out
