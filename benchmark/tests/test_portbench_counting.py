"""The roofline's counts on a hand-worked shape."""
import pytest

from benchmark import counting

PEAK = {"float64_flops": 67e12, "float32_flops": 67e12, "bytes_per_s": 3.35e12}


def test_barrier_trade_with_greeks():
    svc = dict(kind="barrier", n_time_steps=4, num_space_nodes=9, with_greeks=True)
    trade = dict(spot=100.0, strike=100.0, sigma=0.2, t_expiry=1.0, r=0.05,
                 monitor_times=[0.5, 1.0], barrier_type="up-and-out", upper=120.0)
    w = counting.trade_work(trade, svc)
    # 10 nodes, 8 interior, 4 steps, 10 flops, price and vega solves
    assert w["flops"] == 2 * 4 * 8 * 10
    # numbers handed in: spot strike sigma t r, 2 monitors, upper; 5 outputs
    assert w["bytes"] == 8 * (5 + 2 + 1 + 5)


def test_american_trade_with_richardson_and_dividends():
    svc = dict(kind="american", n_time_steps=4, num_space_nodes=8, with_greeks=True, richardson=True)
    trade = dict(spot=100.0, strike=100.0, sigma=0.2, t_expiry=1.0, r=0.06, b=0.02, is_call=False,
                 dividends=[[0.25, 1.2], [0.75, 1.2], [1.25, 1.2]])
    w = counting.trade_work(trade, svc)
    # 10 nodes, 8 interior; runs of 4 and 8 steps at 19 flops a node-step;
    # two dividends before expiry at 30 flops a node, in each run; two solves
    assert w["flops"] == 2 * ((8 * 4 * 19 + 2 * 30 * 10) + (8 * 8 * 19 + 2 * 30 * 10))
    # spot strike sigma t r b is_call, 3 x 2 dividend numbers; 4 outputs
    assert w["bytes"] == 8 * (7 + 6 + 4)


def test_least_time_takes_the_larger_bound():
    t, by = counting.least_seconds(67e12, 1.0, PEAK, "float64")
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = counting.least_seconds(1.0, 3.35e12, PEAK, "float64")
    assert (t, by) == (pytest.approx(1.0), "bytes")


def test_request_work_sums_its_trades():
    svc = dict(kind="barrier", n_time_steps=4, num_space_nodes=9, with_greeks=False)
    trade = dict(spot=100.0, strike=100.0, sigma=0.2, t_expiry=1.0, r=0.05)
    w = counting.request_work([trade] * 3, svc)
    assert w["flops"] == 3 * 4 * 8 * 10 and w["bytes"] == 3 * 8 * (5 + 1)
