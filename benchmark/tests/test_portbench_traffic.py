"""The generator: the same seed gives the same requests; a cell whose pool
has a seed of its own prices the same set for every run's seed, in another
order."""
import json

from benchmark import traffic
from benchmark.spec import HERE


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _window(gen, n):
    return [gen.request(i) for i in range(n)]


def test_closed_loop_is_determined_by_the_seed():
    cfg, mix = _config("fa_american_div_f64"), _mix("ladder_fresh_book")
    seed = 2**31 + 12345
    a = traffic.ClosedLoop(cfg["trades"], mix, seed)
    b = traffic.ClosedLoop(cfg["trades"], mix, seed)
    assert _window(a, 8) == _window(b, 8) and a.warmup == b.warmup
    assert len(a.request(0)) == 64 * 8 * 8
    other = traffic.ClosedLoop(cfg["trades"], mix, seed + 1)
    assert other.request(0) not in a.pool


def test_the_window_cycles_its_pool():
    cfg, mix = _config("fa_american_div_f64"), _mix("ladder_fresh_book")
    gen = traffic.ClosedLoop(cfg["trades"], mix, 7)
    n = len(gen.pool)
    assert n == mix["pool"] and len(gen.warmup) == mix["warmup_requests"]
    first = _window(gen, n)
    assert sorted(map(id, first)) == sorted(map(id, gen.pool))  # each once per cycle
    assert _window(gen, 3 * n) == first * 3


def test_fixed_pool_is_one_set_for_every_seed():
    cfg, mix = _config("fa_barrier_f64"), _mix("ladder_fixed_book")
    a = traffic.ClosedLoop(cfg["trades"], mix, 5)
    b = traffic.ClosedLoop(cfg["trades"], mix, 2**31 + 5)
    assert a.pool == b.pool and _window(a, len(a.pool)) != _window(b, len(b.pool))
    keys = ("strike", "t_expiry", "monitor_times", "barrier_type")
    r1, r2 = a.pool[0], a.pool[1]
    assert [{k: t.get(k) for k in keys} for t in r1] == [{k: t.get(k) for k in keys} for t in r2]
    assert r1[0]["spot"] != r2[0]["spot"]
    # the vol ladder: 8 points 5 vol points either side, around one move
    vols = [t["sigma"] for t in r1[:8]]
    assert abs((vols[-1] - vols[0]) - 0.1) < 1e-12
    # the warm-up passes over the whole pool, every request the window sends
    assert all(any(w is p for w in a.warmup) for p in a.pool)


def test_fresh_book_cycles_its_expiries_and_shares_them_within_a_request():
    cfg, mix = _config("fa_american_div_f64"), _mix("ladder_fresh_book")
    gen = traffic.ClosedLoop(cfg["trades"], mix, 99)
    expiries = [r[0]["t_expiry"] for r in gen.pool]
    assert sorted(expiries[:3]) == [0.5, 1.0, 2.0] and sorted(expiries[3:]) == [0.5, 1.0, 2.0]
    # the warm-up meets every expiry, so every schedule the window marches
    assert sorted(r[0]["t_expiry"] for r in gen.warmup) == [0.5, 1.0, 2.0]
    for r in gen.pool:
        assert len({t["t_expiry"] for t in r}) == 1
        te = r[0]["t_expiry"]
        assert [d[0] for d in r[0]["dividends"]] == [0.25 + 0.5 * k for k in range(4) if 0.25 + 0.5 * k < te]
        strikes = sorted({t["strike"] for t in r})
        assert len(strikes) == 64 and strikes[0] == 70.0 and strikes[-1] == 130.0
