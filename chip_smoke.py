#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (finite_difference_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, drives the port's main
paths and checks their output, times them, and prints one JSON line per
phase:

- the barrier path, ``price_barrier_batch`` on the benchmark trade set:
  B=4096 barrier trades, 1024-node grids, 512 Crank–Nicolson steps, f32;
- K5, the knock-in parity (phase 4b, :func:`ki_parity_phases`): the
  barrier cells' own first requests (4096 trades with 960 knock-ins, and
  16,384 with 3840, here on one card) through the float64 service, the
  kernel's result on the stack the main path hands it held to its plain
  version bit for bit, one launch a request, its device time and bound;
- the American path, ``price_american_batch`` on the benchmark's American
  trade set (bench.py make_american_batch): B=4096 one-year puts at f32,
  price only, with greeks and with two cash dividends per trade; and the
  float64 rung, B=256 with greeks, against the f64 scan;
- the fused path, ``price_barrier_batch_fused`` (the march with
  Hillis–Steele scans) on the barrier trade set at B=4096 x 1024 x 512 f32,
  and the cyclic-reduction path, ``cn_barrier_solve_cr``, on the same
  trades at N=1026, each held against the f64 routes;
- the spectral propagator (``solver="spectral"``) on the barrier set at
  f64 and f32, its f32 rungs, ``greeks_mode="ad"``,
  ``solve_value_surfaces``, and the route sweep that ``solver="auto"``'s
  rule on the card (``batch.auto_solver``) rests on;
- the serving path: the bucketed barrier and American services on a
  desk's mixed stream at buckets 8 to 4096 (float32 price only through
  K1 and K1a, float64 with greeks through the spectral route and K2), and
  the micro-batching HTTP server on the float64 barrier service;
- the FA-validation path (phase 20, :func:`fa_phases`): the xlsx golden
  rows through the scalar barrier pricer (its scan replayed from CUDA
  graphs), the American scalar pricers, the batched scenario runners on a
  4160-row barrier stress table and a 4096-row American table (K2), the
  per-scenario runner and the two CLIs;
- the rest of the FA-validation layer (phase 21, :func:`fa_analytics_phases`):
  implied vol on a 2^20-quote chain, the FIS stencil pricer, the
  Bjerksund–Stensland and BGK runners (BGK and Monte Carlo routes) beside
  the batched sweeps on the desk's stress shape, their CLIs, the
  cross-check engine and the order-of-accuracy diagnostics;
- the Monte Carlo layer (phase 22, :func:`mc_phases`): the discrete-barrier
  MC at ``MCConfig``'s defaults (200,000 paths) on a month and a year of
  daily monitors, Longstaff–Schwartz at its defaults, the HW1F curve
  simulator (10,000 paths x 120 monthly dates x 20 tenors), GBM and
  Clewlow–Strickland, each against its closed form or CN counterpart and
  against the port on the CPU, draw for draw;
- the XVA exposure path (phase 23, :func:`xva_phases`):
  ``hw1f_cva_pipeline`` on examples/device_cva_pipeline.py's ten swaps at
  50,000 paths x 63 dates x 8 tenors (and once at float32), the exotic
  netting set of examples/exotic_xva.py (an up-and-out call, an American
  put and a swap) through the generic and the device exposure engines,
  its barrier surfaces also through K2 (``solver="spike"``), and the CSA
  cases, each held against the generic engine and the CPU;
- the rest of the XVA engine (phase 24, :func:`xva_rest_phases`): the
  seven trades of examples/exposure_bench.py (swaps, equity TRS and
  index-linked swaps) at 50,000 paths x 62 dates on the device exposure
  engine (and once at float32), a SIMM CSA on its base netting set, the
  commodity forwards, and examples/xva_commodity_forward.py's assets
  through ``run_asset`` at ``SimulationConfig()``'s defaults, each held
  against the generic engine and the CPU;
- the scenario layer and the CS and HW1F calibration (phase 25,
  :func:`scenario_phases`): RiskFlow's CS batch loop on a two-factor
  market (16,384 scenarios) under each draw backend, the joint HW1F + GBM
  cube at 50,000 paths x 63 dates into the device exposure engine,
  examples/hw1f_rates_xva.py end to end, and the CS implied calibration,
  each held against the CPU (and the cube against the generic engine);
- the device mesh (phase 26, :func:`mesh_phases`): the drivers, two
  services, the barrier runner and the device exposure engine over meshes
  that repeat the card (``["cuda:0"] * k``; over the real cards too where
  there are two or more), each held against its unsharded call, and the
  port's ``entry()`` and ``dryrun_multichip(4)``;
- the host-only remainder (phase 27, :func:`host_remainder_phases`): a
  book of bonds, inflation-linked bonds and swaps and FRAs, the PCA
  calibration on ten years of a 20-tenor curve, the GBM FX calibration of
  eight currencies with its CSVs and the IR swap FA check, each checked
  and shown to launch none of our kernels.

The barrier path's phases ask for ``solver="spike"`` by name, so that
the SPIKE march runs there whatever the auto rule picks.

The SPIKE march's timing lines also give its design bytes, its trades
resident per SM and waves (the occupancy API); so do the scan march's
(K3) and the CR march's. K3 is held against its plain version in both
its launch designs: one warp per trade up to 1024 nodes, one block per
trade at 2048. The
SPIKE march is also held against its plain version and timed at P = 32, 64
and 128 chunks per trade (one warp per trade, two and four) on the float64
rung's batch.

Each phase group's wall time is in the ``phase_wall_s`` line. The last
three lines are the kernels' summary (JSON), the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, "device":
{...}}``.

It exits non-zero, printing no result, when ``torch.cuda.is_available()``
is false or when the port is not beside it; any failed check raises.
It imports no JAX and nothing of the JAX package.
"""
import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the benchmark trade set (bench.py make_batch): 1-month up-and-out calls,
# 24 daily monitors, far barrier H=420, seed 0
N_NODES = 1024
N_STEPS = 512
T_EXP = 31.0 / 365.0
STRIKE, RATE, BARRIER = 190.0, 0.0705, 420.0
B_MAIN = 4096
B_CHECK = 256  # the prefix held against the float64 route and the plain version
SPIKE_P_CHECKED = (32, 64, 128)  # the SPIKE march's P held against the plain version at B_CHECK
N_CR = 1026  # the cyclic-reduction march needs N - 2 a power of two
N_HS_BLOCK = 2048  # a grid on the scan march's block design (N > 1024)
P_RULE_B = (256, 512, 1024, 2048, 4096)  # batches at which the SPIKE march is timed at each P
RULE_REPS = 7  # host-clock repetitions of each solve there
CR_TRADES_PER_SM = (4, 8, 16, 24)  # the CR march's occupancy sweep at N_CR
CR_SWEEP_N = (130, 258, 514, 1026, 2050)  # its grid sweep at 4 trades per SM
ROUTE_SWEEP_B = (256, 1024, 4096)  # batches at which auto's routes are timed
ROUTE_REPS = 9  # host-clock calls of spike and spectral there, interleaved, after a warm-up
ROUTE_RECORD_REPS = 3  # host-clock calls of the fused march and the scan (for the record)
SERVE_BUCKETS = (8, 64, 512, 4096)  # the serving phase's buckets, per service
SERVE_REQUESTS = 20  # fresh mixed requests per service and bucket: the first, then steady
SERVER_CLIENTS = 256  # concurrent 1-trade clients of the server
SERVER_BURST = 24  # then a burst of requests of 1-512 trades

# the American trade set (bench.py make_american_batch): 1-year puts,
# spots U(80, 120), sigma U(0.15, 0.40), seed 7, K=100, r=0.06, b=0.02;
# the dividend case adds two cash dividends per trade
AM_STRIKE, AM_RATE, AM_CARRY = 100.0, 0.06, 0.02
AM_DIVIDENDS = [(0.35, 1.2), (0.75, 1.2)]
B_AM64 = 256  # the float64 rung's batch

# the FA-validation path (phase 20): the xlsx model block of the reference's
# 500x500 engine (tests/test_xlsx_golden.py:37-82, copied): spot 229.74, a
# flat NACA of 0.073085649282, valuation 2025-07-28, maturity 2025-08-28,
# monitored on its 24 South African business days (day offsets below); rows
# (name, option, barrier type, K, sigma, lower, upper, model price, delta,
# gamma, vega)
FA_SPOT, FA_RATE = 229.74, 0.073085649282
FA_MONITOR_DAYS = (0, 1, 2, 3, 4, 7, 8, 9, 10, 11, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25,
                   28, 29, 30, 31)
FA_GOLDEN = [
    ("co1", "call", "up-and-out", 190.0, 0.287899981643, None, 260.0,
     32.464174906875897, 0.122330501269814, -0.065045360125054602, -0.80200735270210499),
    ("co2", "call", "up-and-out", 190.0, 0.287899981643, None, 420.0,
     40.932576101800002, 0.99120615060498096, 1.23569532945566e-3, 1.5858548508163001e-2),
    ("co3", "call", "up-and-out", 190.0, 0.287899981643, None, 240.0,
     12.8984955654629, -0.79900392310436497, -0.053366924178646899, -0.58726173002270299),
    ("co4", "call", "down-and-out", 200.0, 0.278483170115, 150.0, None,
     31.1935362626187, 0.96554617906390605, 4.0918919511341301e-3, 0.050774047045720701),
    ("co5", "call", "down-and-out", 220.0, 0.261319367995, 140.0, None,
     13.716232712515099, 0.75262636730426602, 0.0180646178608867, 0.2111778964478),
    ("ci1", "call", "up-and-in", 190.0, 0.287899981643, None, 260.0,
     8.4683807425467901, 0.86894191858081904, 0.066272829031302993, 0.81786376729908705),
    ("ci2", "call", "up-and-in", 190.0, 0.287899981643, None, 420.0,
     -2.04523773632558e-5, 6.6269245653116594e-5, -8.22642320736223e-6, -2.1339111810902901e-6),
    ("ci3", "call", "up-and-in", 190.0, 0.287899981643, None, 240.0,
     28.034060083959702, 1.7902763429549899, 0.0545943930848952, 0.60311814461968505),
    ("ci4", "call", "down-and-in", 200.0, 0.278483170115, 150.0, None,
     -2.9547590855827302e-5, 2.67928988613941e-4, -2.70330697361353e-5, -9.4173806530761699e-7),
    ("ci5", "call", "down-and-in", 220.0, 0.261319367995, 140.0, None,
     -2.16467431446432e-5, 8.8558748080025396e-4, -3.8470577094013699e-5, 1.3839315471386701e-6),
    ("po1", "put", "up-and-out", 260.0, 0.234882165755, None, 280.0,
     28.997294437893999, -0.95441823233073797, 6.0885809449473501e-3, 0.064495720763701997),
    ("po2", "put", "up-and-out", 260.0, 0.234882165755, None, 420.0,
     28.997359536003501, -0.95422044902792802, 6.1110714591450198e-3, 0.064535977379875903),
    ("po3", "put", "up-and-out", 260.0, 0.234882165755, None, 240.0,
     20.8029963459574, -1.6227928623466701, -0.024604102947932902, -0.1913910030364),
    ("po4", "put", "down-and-out", 250.0, 0.239975287381, 150.0, None,
     19.862392172093902, -0.860666117466102, 0.0138031902723696, 0.14785509623784701),
    ("po5", "put", "down-and-out", 230.0, 0.253462822027, 140.0, None,
     6.2099541607035498, -0.46114326169532399, 0.02340594433781, 0.26569498628736798),
    ("pi1", "put", "up-and-in", 260.0, 0.234882165755, None, 280.0,
     1.5431450748337701e-5, 3.3021700531099502e-4, 3.6810978096188997e-5, 3.9856905331703199e-5),
    ("pi2", "put", "up-and-in", 260.0, 0.234882165755, None, 420.0,
     -4.9666658700431299e-5, 1.3243370250171001e-4, 1.43204638985185e-5, -3.9971084220269399e-7),
    ("pi3", "put", "up-and-in", 260.0, 0.234882165755, None, 240.0,
     8.1943135233874003, 0.66870484702124999, 0.030729494870976402, 0.255926580705434),
    ("pi4", "put", "down-and-in", 250.0, 0.239975287381, 150.0, None,
     -9.8732281077928906e-5, -9.9156590774474008e-4, -6.20930541235884e-5, 2.5908121870088499e-6),
    ("pi5", "put", "down-and-in", 230.0, 0.253462822027, 140.0, None,
     -9.0546526354096102e-5, 2.0528203486550002e-3, -2.1166298145212901e-5, 4.0009002333363199e-6),
]
FA_CPU_ROWS = ("co1", "pi3")  # golden rows held on the card against the CPU
FA_SPOT_SHOCKS = np.linspace(-0.3, 0.3, 16)  # the stress table: spot -30% ... +30%
FA_VOL_SHOCKS = np.linspace(0.7, 1.3, 13)  # x sigma x0.7 ... x1.3
FA_SUBSET = 64  # rows of each table held against the port's CPU runner
FA_TABLE_CALLS = 3  # runner calls per table: eager, capture, replay (the spectral graph)
FA_AMERICAN_ROWS = 4096  # the American table: bench.py's put set
# trade 201870944 of the FA validation notebook (examples/fa_american_validation.py)
# and FA's own numbers for it
FIS_TRADE = dict(spot_price=176.39, strike_price=170.0, volatility=0.296783211249,
                 option_type="put", exercise_type="american", settlement_type="cash",
                 underlying_spot_days=3, option_spot_days=0, option_settlement_days=0)
FIS_R_NACC = 0.070538282720
FIS_FRONT_ARENA = {"Price": 2.9846891127, "Delta": -0.2978815582, "Gamma": 0.0230742255,
                   "Vega": 0.1778185529, "Theta (Annual)": -27.96921280}

# the rest of the FA-validation layer (phase 21)
FA_IV_QUOTES = 1 << 20  # the implied-vol chain (tests/test_implied_vol.py's draws, seed 0)
FA_IV_CPU_QUOTES = 4096  # its prefix held on the card against the CPU
# the runner tables' spot shocks, -20% ... +20%: four, not eight, so that
# phase 21 keeps to about a minute (a BGK row takes about 128 ms on the card)
FA_BS_SPOT_SHOCKS = np.linspace(-0.2, 0.2, 4)
FA_ANALYTIC_CPU_ROWS = 32  # rows of each runner table priced on the CPU too
FA_MC_CPU_ROWS = 8  # MC-route rows priced on the CPU too (about 0.37 s each there)
FA_MC_BARRIER = 130.0  # the MC-route rows: one-year up-and-out calls, monthly monitors
FA_ORDER_LADDER = (150, 300, 600)  # the FIS stencil's step counts for the order fit

# the Monte Carlo layer (phase 22): MCConfig's defaults (200,000 paths,
# antithetic, seed 42) on test_mc.py's trade (spot 229.74, K=190, sigma
# 0.2879, a month of daily monitors, H=260) and on a one-year daily-monitored
# up-and-out call with two cash dividends (about 250 event steps); LSM at its
# defaults on test_lsm.py's trades; HW1F on ten years of monthly dates x 20
# tenors; GBM at a year of 252 steps; Clewlow–Strickland at 120 steps x 24
# monthly tenors
MC_YEAR = dict(spot=100.0, strike=100.0, vol=0.25, level=140.0, naca=0.07, cash=1.5)
MC_CPU_PATHS = 8192  # barrier and LSM paths held on the card against the CPU
MC_HW1F_PATHS, MC_HW1F_DATES = 10_000, 120
MC_HW1F_TENORS = (1 / 12, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0,
                  12.0, 15.0, 20.0, 25.0, 30.0)
MC_HW1F_CPU_PATHS = 512
MC_GBM_SIMS, MC_GBM_STEPS = 100_000, 252
MC_CS_SIMS, MC_CS_STEPS, MC_CS_TENORS = 10_000, 120, 24
MC_PROFILE_WINDOW_MS = 25.0  # the least host time profiled per MC call (repeats of a short call)

# phase 23, the XVA exposure path: examples/device_cva_pipeline.py's shape (23a,
# 23c) and examples/exotic_xva.py's netting set (23b)
XVA_TENORS = (0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0)
XVA_PATHS = 50_000
XVA_SCEN_DAYS = tuple(range(30, 1890, 30))  # 62 dates, and today: 63
XVA_SWAPS = 10  # five-year quarterly float-vs-fixed, fixed 7.0% ... 8.8%
XVA_CPU_PATHS = 2_000  # paths held against the CPU and against the generic engine
XVA_EXOTIC_PATHS, XVA_EXOTIC_DATES = 10_000, 28  # fortnightly dates
XVA_EXOTIC_TENORS = (0.25, 0.5, 1.0, 2.0, 5.0)

# phase 24, the rest of XVA: examples/exposure_bench.py's cube and netting set
# (24a, 24b), TestDeviceCommodity's market and examples/xva_commodity_forward.py's
# assets (24c)
XVA_VAL = datetime.date(2025, 7, 28)
XVA_BENCH_PATHS, XVA_BENCH_DATES = 50_000, 62
XVA_SIMM_CHECK_PATHS = 64  # paths of the generic engine's per-date SIMM loop
XVA_COMMODITY_DATES = 28  # fortnightly
XVA_CS_CPU_SIMS = 2_000  # run_asset's sims held against the CPU
XVA_ASSETS = {  # initial curve, tenor days, CS (alpha, sigma, mu)
    "BRENT": ((78.0, 79.5, 80.2, 81.0, 81.5), (30.0, 90.0, 180.0, 270.0, 365.0), (1.1, 0.35, 0.0)),
    "GOLD": ((2400.0, 2410.0, 2425.0, 2450.0), (90.0, 180.0, 270.0, 365.0), (0.4, 0.14, 0.0)),
}

# phase 25, the scenario layer and the CS and HW1F calibration: a two-factor CS
# market (BRENT 24 monthly tenors, GOLD 12 bimonthly, rho 0.6) run in RiskFlow's
# batch loop (25a); tests/test_device_exposure.py's joint-cube factors at
# examples/device_cva_pipeline.py's size (25b); examples/hw1f_rates_xva.py (25c);
# test_calibration.py's implied round trip and bootstrap fixture (25d)
SCEN_RUN = datetime.date(2025, 1, 6)
SCEN_BATCH, SCEN_BATCHES = 1024, 16  # 16,384 scenarios
SCEN_FACTORS = ("ForwardPrice.BRENT.OIL", "ForwardPrice.GOLD")
SCEN_BACKENDS = ("threefry", "sobol_device", "torch")
SCEN_GENERIC_PATHS = 64  # the joint cube's paths held on the generic engine
# phase 26, the device mesh: one card repeated k times (the machine has one)
MESH_SHARDS = (1, 2, 4)
MESH_CALLS = 5  # host-clock calls per mesh, after a warm-up (the median is kept)
MESH_REQUESTS = 4  # phase 19's mixed requests at bucket 512 through each service
MESH_SAMPLES = 200_000  # the reductions' sample: MCConfig's default path count (22a's)
# the host-only remainder (phase 27): a rates desk's book, a ten-year
# daily curve history and an eight-currency FX vol market, seed 27
REM_VAL = datetime.date(2025, 7, 28)
REM_SEED = 27
REM_CALLS = 5  # host-clock calls per sub-phase, after a warm-up (the median is kept)
REM_BONDS, REM_INFLATION, REM_FRAS = 64, 16, 64
REM_FLAT_NACA = 0.0775  # the zero-coupon bonds' flat curve
REM_PCA_DAYS = 2520
REM_PCA_TENORS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0, 15.0, 20.0,
                  25.0, 30.0)
REM_PCA_FACTORS = 3
REM_FX = ("EUR", "USD", "GBP", "JPY", "CHF", "AUD", "CNY", "NGN")
REM_FA_FIGURES = (334439.05, -27800.25)  # FA's pay and total PV (the reference's test_1.py)
# the synthetic-curve leg PVs that tests/test_irswap_fa.py pins
REM_FA_GOLDENS = {"pay_pv": 327214.7213617418, "receive_pv": 316727.46266538475}
HW1F_XVA_TENORS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0)  # examples/hw1f_rates_xva.py
HW1F_XVA_TODAY = (0.0705, 0.0710, 0.0718, 0.0735, 0.0765, 0.0788)

# published H100 SXM peaks (NVIDIA data sheet): float32 and float64 outside
# the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
# the matmul peak of either dtype: float32 outside the tensor cores, float64
# on them (the data sheet's FP64 Tensor Core rate)
PEAK_MATMUL_FLOPS = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_trades(B: int, n_nodes: int = N_NODES):
    rng = np.random.default_rng(0)
    spots = rng.uniform(180.0, 250.0, 4096)[:B]
    sigmas = rng.uniform(0.2, 0.35, 4096)[:B]
    kw = dict(
        spots=spots, strikes=[STRIKE] * B, sigmas=list(sigmas),
        t_expiry=[T_EXP] * B, r=[RATE] * B, b=[RATE] * B, is_call=[True] * B,
        n_time_steps=N_STEPS,
        monitor_times=[[T_EXP * (k + 1) / 24.0 for k in range(24)]] * B,
        upper=[BARRIER] * B, num_space_nodes=n_nodes - 1,
    )
    return kw, spots, sigmas


def mixed_trades(B: int, n_steps: int, num_space_nodes: int):
    """Calls and puts, up/down/double barriers, rebates at hit and at expiry."""
    rng = np.random.default_rng(1)
    t = 0.25
    return dict(
        spots=list(rng.uniform(90.0, 110.0, B)), strikes=list(rng.uniform(95.0, 105.0, B)),
        sigmas=list(rng.uniform(0.2, 0.4, B)), t_expiry=[t] * B, r=[0.05] * B,
        b=list(rng.uniform(0.0, 0.05, B)), is_call=[i % 2 == 0 for i in range(B)],
        n_time_steps=n_steps, monitor_times=[[t * (k + 1) / 4.0 for k in range(4)]] * B,
        lower=[80.0 if i % 4 < 2 else None for i in range(B)],
        upper=[125.0 if i % 4 != 1 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 3.0, B)), rebate_at_hit=[i % 3 == 0 for i in range(B)],
        num_space_nodes=num_space_nodes,
    )


def american_trades(B: int, dividends: bool = False):
    rng = np.random.default_rng(7)
    spots = rng.uniform(80.0, 120.0, 4096)[:B]
    sigmas = rng.uniform(0.15, 0.4, 4096)[:B]
    kw = dict(
        spots=list(spots), strikes=[AM_STRIKE] * B, sigmas=list(sigmas), t_expiry=[1.0] * B,
        r=[AM_RATE] * B, b=[AM_CARRY] * B, is_call=[False] * B, n_time_steps=N_STEPS,
        num_space_nodes=N_NODES - 2, dividends_tau=[AM_DIVIDENDS] * B if dividends else None,
    )
    return kw, spots, sigmas


def small_american_trades(B: int, is_call: bool):
    """Calls or puts with two dividends each (lambda resets at each segment
    start); calls also restart Rannacher after each dividend."""
    rng = np.random.default_rng(3)
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)), strikes=[AM_STRIKE] * B,
        sigmas=list(rng.uniform(0.15, 0.4, B)), t_expiry=[1.0] * B, r=[AM_RATE] * B,
        b=list(rng.uniform(0.0, 0.06, B)), is_call=[is_call] * B, n_time_steps=40,
        dividends_tau=[AM_DIVIDENDS] * B, num_space_nodes=126,
    )


def black_scholes_put(spots, sigmas):
    """Generalized Black–Scholes European put (carry b): a lower bound of
    the American put."""
    n = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    out = []
    for s, sg in zip(spots, sigmas):
        d1 = (math.log(s / AM_STRIKE) + (AM_CARRY + 0.5 * sg * sg)) / sg
        out.append(AM_STRIKE * math.exp(-AM_RATE) * n(sg - d1)
                   - s * math.exp(AM_CARRY - AM_RATE) * n(-d1))
    return np.asarray(out)


def black_scholes_call(spots, sigmas):
    """Generalized Black–Scholes call (carry b = r): the far-barrier limit."""
    n = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    out = []
    for s, sg in zip(spots, sigmas):
        vol = sg * math.sqrt(T_EXP)
        d1 = (math.log(s / STRIKE) + (RATE + 0.5 * sg * sg) * T_EXP) / vol
        out.append(s * n(d1) - STRIKE * math.exp(-RATE * T_EXP) * n(d1 - vol))
    return np.asarray(out)


def march_cost(prep, segments, n_jumps: int = 0) -> dict:
    """What one march costs, by count.

    ``flops`` and ``bytes`` are the work the march itself needs, from which
    the bound follows: about 14 flops per interior node and step (rhs 5,
    forward 3, backward 2, correction 4), plus the reduced interface
    system, which couples each of its 2P unknowns only to b_{j-1} and
    t_{j+1} and so is banded: a solve with precomputed factors takes about
    9 flops per unknown. The American branch adds 9 per node and step,
    counted from the kernel: the source term dt*lambda (2) and the
    projection (7: payoff - x, the division by dt, the add to lambda, its
    max with 0, dt*lambda, x minus it, the max with the payoff). Bytes:
    each input read once and each output written once, per launch
    (American: the payoff, lambda in and lambda out too), in the prep's
    compressed layout. Each dividend jump between launches reads and
    writes the (B, N) grid and takes about 30 flops per node (spline system
    8, coefficients 10, evaluation 8, the shift and the check 4).

    ``design_bytes`` is what the kernel itself requests from global memory
    per march, by the design's own count: per launch the trade's constants,
    coefficients, the two solver columns (10 m values) and the interface
    factors (8 P) once, v and the edges in and out, tau and the monitor
    flag once per step, and in the American branch lambda in and out and
    the payoff once per step (it is read from L2, not held on chip); the
    dividend jumps are not the kernel's. ``iface_flops`` is what the
    kernel's interface solve spends per march: per pair and step 40 (the
    entry term 3, two 5-stage scans of affine maps at 3 each, the second
    recurrence's entry 5, the b_j term 2).
    """
    B, n_pad = prep.v0.shape
    P, m, n_int = prep.P, prep.m, prep.n_int
    item = prep.v0.element_size()
    per_node = 14 + (9 if prep.american else 0)
    flops = nbytes = design = iface_flops = 0
    for k0, k1, _ in segments:
        ns = k1 - k0
        flops += ns * B * (per_node * n_int + 9 * 2 * P)
        iface_flops += ns * B * 40 * (P - 1)
        # each input once: trade, coef, the two solver columns (10 m values)
        # and the interface factors (8 P), tau and the monitor flag; v and
        # the edges in and out; American: lambda in and out, the payoff
        words = (B * 13 + B * 7 + B * 10 * m + B * 8 * P + 2 * B * ns
                 + 2 * (B * n_pad + 2 * B) + (3 * B * n_pad if prep.american else 0))
        nbytes += words * item
        # the kernel reads the payoff once per step
        design += (words + ((ns - 1) * B * n_pad if prep.american else 0)) * item
    n_full = n_int + 2
    flops += n_jumps * 30 * B * n_full
    nbytes += n_jumps * 2 * B * n_full * item
    return dict(flops=flops, bytes=nbytes, design_bytes=design, iface_flops=iface_flops)


def bound(prep, segments, n_jumps: int = 0):
    """(bound_ms, bound_by, cost) of one march on the card: the larger of
    its operations over the peak rate of its dtype and its bytes over the
    memory rate; ``cost`` is :func:`march_cost`."""
    cost = march_cost(prep, segments, n_jumps)
    peak = PEAK_F64_FLOPS if prep.v0.element_size() == 8 else PEAK_F32_FLOPS
    t_ops, t_bytes = cost["flops"] / peak * 1e3, cost["bytes"] / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", cost


def residency(prep, query=None) -> dict:
    """Trades of a march resident per SM (the occupancy API, through the
    kernel library: ``query``, by default the SPIKE march's) and the waves
    its batch takes on this card."""
    import torch

    from finite_difference_tpu_torch import kernels

    resident = (query or kernels.spike_resident_trades)(prep)
    sms = torch.cuda.get_device_properties(prep.v0.device).multi_processor_count
    return dict(resident_trades_per_sm=resident, sms=sms,
                waves=math.ceil(prep.v0.shape[0] / (resident * sms)))


def fused_bound(prep, kind: str) -> dict:
    """The bound of one fused march (``kind`` "hs" or "cr") and what its
    design spends beyond it.

    The bound counts about 10 flops per interior node and step (rhs 5, and
    the 5 of a tridiagonal solve: forward 3, backward 2) over the peak rate
    of the dtype, and the bytes of each input read once and the values
    written once (the solver data, the mask, the schedule, the payoff in
    and V out) over the memory rate; the larger of the two. ``extra_flops``
    is the design's own arithmetic in place of the solve's 5 per node:
    for the scans (kernels.hs_block's design, R rows on T threads) per
    step and scan, each thread composes its rows (3R), runs 5 shuffle
    stages (3 each) and applies the entry value to its rows (2R; the block
    design 2 more to form it), and in the block design warp 0 scans the
    warp maps (5 stages of 3 per lane); for cyclic reduction 4 flops per
    row eliminated and 5 per row substituted (one a division), n - 1 rows
    each, and the 1x1 pivot.
    """
    from finite_difference_tpu_torch import kernels

    B, N = prep.v0.shape
    steps = prep.n_steps
    item = prep.v0.element_size()
    flops = 10 * B * (N - 2) * steps
    words = sum(x.numel() for x in (prep.trade, prep.coef, prep.solver, prep.omask, prep.tau,
                                    prep.mon, prep.v0)) + B * N
    nbytes = words * item
    if kind == "hs":
        design, rows, threads = kernels.hs_block(N)
        if design == "warp":
            extra = B * steps * 2 * 32 * (5 * rows + 15)
        else:
            extra = B * steps * 2 * (threads * (5 * rows + 17) + 32 * 15)
    else:
        n = N - 2
        extra = B * steps * (9 * (n - 1) + 1)
    peak = PEAK_F64_FLOPS if item == 8 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, extra_flops=extra)


def hs_design_bytes(prep) -> int:
    """What the scan kernel requests from global memory per march, by the
    design's own count: per trade its constants (9 values) and both theta
    sets' coefficients (10), w, af and ab of both sets (6N, each loaded
    once into shared memory or registers), the knock-out mask (N), tau and
    the monitor flag of each step, and the value row in and out (2N)."""
    B, N = prep.v0.shape
    words = B * (9 + 10 + 6 * N + N + 2 * prep.n_steps + 2 * N)
    return words * prep.v0.element_size()


def cr_design_bytes(prep) -> int:
    """What the CR kernel requests from global memory per march, by the
    design's own count (as :func:`march_cost` counts the SPIKE kernel's):
    per trade its constants (9 values), both theta sets' coefficients (10)
    and level scalars (32 per level) once, the value row in and out (N
    each), tau and the monitor flag once per step, and the knock-out mask's
    N values on each monitor step."""
    B, N = prep.v0.shape
    n_mon = int((prep.mon != 0).sum())
    words = B * (9 + 10 + 32 * prep.solver.shape[2] + 2 * N + 2 * prep.n_steps) + n_mon * N
    return words * prep.v0.element_size()


def host_ms(fn):
    """(fn(), milliseconds on the host clock between two synchronisations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_call(fn, call_ms: float):
    """Device time of one call by kernel, and the busy share of the
    unprofiled call time (the profiler's own overhead inflates wall time);
    the matmul kernels' time and count (cuBLAS kernel names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    check(device_ms > 0, "the profiler saw no device time")
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    mm = [e for e in rows if any(t in e.key.lower() for t in ("gemm", "xmma", "cutlass"))]
    return dict(call_ms=call_ms, device_ms=device_ms, busy_share=device_ms / call_ms,
                device_kernels=sum(e.count for e in rows),
                matmul_ms=sum(e.self_device_time_total for e in mm) / 1e3,
                matmul_kernels=sum(e.count for e in mm if "reduce" not in e.key.lower()),
                top=[{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
                     for e in top])


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def american_phases(dev, card: dict, limits: dict):
    """The American path: its kernel against the plain version, the f32
    path (price only, greeks, dividends) and the float64 rung, each checked;
    their timing. Returns the K1a and K2 entries of the kernels' summary."""
    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import spike
    from finite_difference_tpu_torch.models.pde.batch import (
        _spike_schedule_impl,
        build_american_batch,
        price_american_batch,
    )

    def american_prep(tb, n_nodes, P=None):
        """The American march of ``tb`` at ``P`` chunks (the batch-size rule's
        P by default)."""
        sched = _spike_schedule_impl(tb, n_nodes)
        check(sched is not None, "an American batch of the run is not SPIKE-eligible")
        segments, set_defs, div_steps, reset_steps = sched
        prep = spike.prepare_spike(tb, tb.sigma, n_nodes, P, set_defs, american=True)
        march = lambda step: spike.march_segments(tb, prep, segments, div_steps, reset_steps, step=step)
        return prep, segments, div_steps, march

    def vs_plain(label, tb, n_nodes, reps=0, P=None):
        """The American march (kernel launches, lambda resets and dividend
        jumps between them) against its plain version; ``reps`` > 0 also
        times the kernel's march. On CUDA tensors spike.spike_march is the
        kernel, never the plain version."""
        prep, segments, div_steps, march = american_prep(tb, n_nodes, P)
        limit = limits[tb.sigma.dtype]
        v_k, e_k = march(spike.spike_march)
        (v_r, e_r), plain_ms = host_ms(lambda: march(spike.spike_march_reference))
        scale = float(v_r.abs().max())
        err = max(float((v_k - v_r).abs().max()), float((e_k - e_r).abs().max()))
        ms = cuda_ms(lambda: march(spike.spike_march), reps) if reps else None
        b_ms, b_by, cost = bound(prep, segments, len(div_steps))
        shape = dict(P=prep.P, warps_per_trade=max(1, prep.P // 32))
        timed = dict(**cost, **residency(prep)) if reps else {}
        emit("american_kernel_vs_plain", size=label, dtype=str(tb.sigma.dtype), B=tb.batch_size,
             N=n_nodes, steps=tb.n_steps, **shape, launches_per_march=len(segments),
             dividend_jumps=len(div_steps), max_abs_err=err, max_abs_v=scale, ratio=err / scale,
             limit=limit, kernel_ms_per_march=ms, plain_ms_per_march=plain_ms, **timed, **card)
        check(math.isfinite(err) and err <= limit * scale,
              f"American kernel vs plain {label} {tb.sigma.dtype}: {err / scale:.3e} > {limit}")
        out = dict(max_abs_err=err, max_abs_err_over_max_abs_v=err / scale, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **shape)
        if reps:
            out.update(resident_trades_per_sm=timed["resident_trades_per_sm"], waves=timed["waves"])
        return out

    # 5. the American kernel against its plain version ---------------------
    for is_call in (False, True):
        for dtype in (torch.float64, torch.float32):
            tb = build_american_batch(dtype=dtype, device=dev, **small_american_trades(8, is_call))
            vs_plain("small_calls" if is_call else "small_puts", tb, 128)
    kw_d, spots, sigmas = american_trades(B_MAIN, dividends=True)
    tb_div = build_american_batch(dtype=torch.float32, device=dev, **kw_d)
    k1a = vs_plain("main_width_dividends", tb_div, N_NODES, reps=3)
    tb64 = build_american_batch(dtype=torch.float64, device=dev, **american_trades(B_AM64)[0])
    k2 = vs_plain("rung_f64", tb64, N_NODES, reps=5)
    # the rung's batch at every checked P, f32 and f64; K2's march timed at each
    tb32_rung = build_american_batch(dtype=torch.float32, device=dev, **american_trades(B_AM64)[0])
    k2_ms_by_p = {k2["P"]: k2["ms"]}
    for P in SPIKE_P_CHECKED:
        vs_plain(f"rung_batch_p{P}", tb32_rung, N_NODES, P=P)
        if P != k2["P"]:
            k2_ms_by_p[P] = vs_plain(f"rung_f64_p{P}", tb64, N_NODES, reps=5, P=P)["ms"]

    # 6. the American path at f32 -------------------------------------------
    kw, _, _ = american_trades(B_MAIN)
    tb = build_american_batch(dtype=torch.float32, device=dev, **kw)
    kernels.reset_launch_counts()
    out_p = price_american_batch(tb, N_NODES, with_greeks=False)
    out_g = price_american_batch(tb, N_NODES, with_greeks=True)
    out_d = price_american_batch(tb_div, N_NODES, with_greeks=False)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    k1a["launches"] = launches["spike_march_american_f32"]
    check(k1a["launches"] > 0, "the American f32 path launched no American kernel")
    for key, val in [*out_p.items(), *out_g.items(), *(("div_" + k, v) for k, v in out_d.items())]:
        check(val.shape == (B_MAIN,) and bool(torch.isfinite(val).all()), f"American {key} not finite")
    intrinsic = np.maximum(AM_STRIKE - spots, 0.0)
    european = black_scholes_put(spots, sigmas)
    bounds = {}
    for label, out in (("price_only", out_p), ("dividends", out_d)):
        price = out["price"].double().cpu().numpy()
        bounds[label] = dict(
            min_over_intrinsic=float(np.min(price - intrinsic)) / AM_STRIKE,
            min_rel_over_european=float(np.min((price - european) / european)),
        )
        check(np.all(price >= intrinsic - 1e-4 * AM_STRIKE), f"American {label} price below intrinsic")
        check(np.all(price >= european * (1.0 - 1e-3)),
              f"American {label} price below the European put")
    div_moved = float(np.max(np.abs(out_d["price"].double().cpu().numpy()
                                    - out_p["price"].double().cpu().numpy())))
    check(div_moved > 0.0, "the dividend jumps did not move the American prices")

    out64 = price_american_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-2)
    f32_vs_f64 = {}
    for key, val in out64.items():
        ref = val.cpu().numpy()
        got = out_g[key][:B_AM64].double().cpu().numpy()
        if key == "price":
            f32_vs_f64[key] = float(np.max(np.abs(got - ref) / np.abs(ref)))
        else:
            f32_vs_f64[key] = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    # gamma's limit is 1e-1, not the barrier path's 1e-2: on the American
    # grid (node spacing ~0.14 at S ~ 90 against ~0.48 on the barrier grid)
    # the second difference amplifies f32 noise of V 12x more. Rounding the
    # exact f64 values to f32 alone moves gamma by 6.1e-3 of its max, and
    # CN keeps its highest-frequency error mode (factor ~-0.98 per step at
    # dt*alpha ~ 47), so the march holds ~5 ulp of node-to-node noise: 3.5e-2
    # on the plain version at B=256 on the CPU (python -m
    # finite_difference_tpu_torch.f32_budget --batch 256; TPU history: 0.32).
    limits_f64 = {"price": 2e-3, "delta": 1e-2, "gamma": 1e-1, "vega": 5e-2}
    emit("american_path", B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float32", solver="auto",
         launches=launches, bounds=bounds, dividend_max_abs_move=div_moved,
         f32_vs_f64_first_256=f32_vs_f64, limits=limits_f64, **card)
    for key, lim in limits_f64.items():
        check(f32_vs_f64[key] <= lim, f"American f32 vs f64 {key}: {f32_vs_f64[key]:.3e} > {lim}")

    # 7. the float64 rung (K2): the double kernel against the f64 scan ------
    kernels.reset_launch_counts()
    out_k = price_american_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-4)
    torch.cuda.synchronize()
    launches64 = dict(kernels.launch_counts)
    k2["launches"] = launches64["spike_march_american_f64"]
    check(k2["launches"] > 0, "the American f64 path launched no American f64 kernel")
    out_s = price_american_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-4, solver="scan")
    rung = {
        key: float((out_k[key] - out_s[key]).abs().max() / out_s[key].abs().max())
        for key in ("price", "delta", "gamma", "vega")
    }
    emit("american_f64_rung", B=B_AM64, N=N_NODES, steps=N_STEPS, dv_sigma=1e-4,
         launches=launches64, spike_vs_scan=rung, limit=1e-6, **card)
    for key, val in rung.items():
        check(val <= 1e-6, f"American f64 rung {key}: {val:.3e} > 1e-6")

    # 8. timing ---------------------------------------------------------------
    def grids_per_s(batch, with_greeks: bool, iters: int, **kw) -> float:
        price_american_batch(batch, N_NODES, with_greeks=with_greeks, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            price_american_batch(batch, N_NODES, with_greeks=with_greeks, **kw)
        torch.cuda.synchronize()
        return batch.batch_size * iters / (time.perf_counter() - t0)

    gps = grids_per_s(tb, False, 5)
    gps_greeks = grids_per_s(tb, True, 3)
    gps_div = grids_per_s(tb_div, False, 5)
    gps64_greeks = grids_per_s(tb64, True, 3, dv_sigma=1e-4)
    # the price-only batch's march: kernel launches only, no jumps
    prep, segments, _, march = american_prep(tb, N_NODES)
    ms = cuda_ms(lambda: march(spike.spike_march), reps=5)
    b_ms, b_by, cost = bound(prep, segments)
    n_div = len(_spike_schedule_impl(tb_div, N_NODES)[0])
    call_ms = B_MAIN / gps * 1e3
    emit("american_timing", grids_per_s=gps, greeks_grids_per_s=gps_greeks,
         div_grids_per_s=gps_div, f64_greeks_grids_per_s=gps64_greeks, f64_B=B_AM64,
         call_ms=call_ms, kernel_ms_per_march=ms, launches_per_march=len(segments),
         bound_ms=b_ms, bound_by=b_by,
         **cost, **residency(prep),
         div_kernel_ms_per_march=k1a["ms"], div_plain_ms_per_march=k1a["plain_ms"],
         div_launches_per_march=n_div,
         f64_kernel_ms_per_march=k2["ms"], f64_plain_ms_per_march=k2["plain_ms"],
         f64_P=k2["P"], f64_warps_per_trade=k2["warps_per_trade"],
         f64_kernel_ms_per_march_p32=k2_ms_by_p[32],
         f64_kernel_ms_per_march_by_p={str(p): ms for p, ms in sorted(k2_ms_by_p.items())},
         launches_per_call={"price_only": len(segments), "greeks": 2 * len(segments),
                            "dividends": n_div},
         B=B_MAIN, N=N_NODES, steps=N_STEPS, P=prep.P, **card)
    emit("american_profile", **profile_call(
        lambda: price_american_batch(tb, N_NODES, with_greeks=False), call_ms), **card)
    emit("american_greeks_profile", **profile_call(
        lambda: price_american_batch(tb, N_NODES, with_greeks=True), B_MAIN / gps_greeks * 1e3), **card)
    k1a.update(name="spike_march_american_f32",
               replaces="finite_difference_tpu/models/pde/pallas_kernel.py:677")
    k2.update(name="spike_march_american_f64",
              replaces="finite_difference_tpu/models/pde/pallas_kernel.py:1138")
    return k1a, k2


def fused_phases(dev, card: dict, limits: dict):
    """The two fused marches off the routed path: each kernel against its
    plain version, the fused path (``price_barrier_batch_fused``) and the
    cyclic-reduction path (``cn_barrier_solve_cr``), each checked, and
    their timing. Returns the K3 and K4 entries of the kernels' summary."""
    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import cr, fused
    from finite_difference_tpu_torch.ops.interp import linear_interp
    from finite_difference_tpu_torch.models.pde.batch import (
        _solve_scan,
        build_trade_batch,
        price_barrier_batch,
    )

    marches = {
        "hs": (fused.prepare_fused, kernels.hs_march_cuda, fused.hs_march_reference),
        "cr": (cr.prepare_cr, kernels.cr_march_cuda, cr.cr_march_reference),
    }

    def vs_plain(kind, label, tb, n_nodes):
        prepare, kernel, plain = marches[kind]
        prep = prepare(tb, tb.sigma, n_nodes)
        v_k = kernel(prep)
        v_r, plain_ms = host_ms(lambda: plain(prep))
        scale = float(v_r.abs().max())
        err = float((v_k - v_r).abs().max())
        limit = limits[tb.sigma.dtype]
        design = {"design": kernels.hs_block(n_nodes)[0]} if kind == "hs" else {}
        emit(f"{kind}_kernel_vs_plain", size=label, dtype=str(tb.sigma.dtype), B=tb.batch_size,
             N=n_nodes, steps=tb.n_steps, max_abs_err=err, max_abs_v=scale, ratio=err / scale,
             limit=limit, plain_ms_per_march=plain_ms, **design, **card)
        check(math.isfinite(err) and err <= limit * scale,
              f"{kind} kernel vs plain {label} {tb.sigma.dtype}: {err / scale:.3e} > {limit}")

    # 9. K3 and K4 against their plain versions ----------------------------
    for kind, n_small, n_main in (("hs", 128, N_NODES), ("cr", 130, N_CR)):
        for dtype in limits:
            tb = build_trade_batch(dtype=dtype, device=dev, **mixed_trades(8, 32, n_small - 1))
            vs_plain(kind, "small", tb, n_small)
            tb = build_trade_batch(dtype=dtype, device=dev, **bench_trades(B_CHECK, n_main)[0])
            vs_plain(kind, "main_width", tb, n_main)
    # K3's block design, which runs grids wider than its warp design takes
    for dtype in limits:
        tb = build_trade_batch(dtype=dtype, device=dev, **bench_trades(B_CHECK, N_HS_BLOCK)[0])
        check(kernels.hs_block(N_HS_BLOCK)[0] == "block", "N_HS_BLOCK is not on the block design")
        vs_plain("hs", "block_design", tb, N_HS_BLOCK)

    # 10. the fused path (K3) -------------------------------------------------
    kw, spots, sigmas = bench_trades(B_MAIN)
    tb = build_trade_batch(dtype=torch.float32, device=dev, **kw)
    kernels.reset_launch_counts()
    out_p = fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=False)
    out_g = fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=True)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    check(launches["hs_march_f32"] > 0, "the fused path launched no hs_march kernel")
    for key, val in {**out_p, **out_g}.items():
        check(val.shape == (B_MAIN,) and bool(torch.isfinite(val).all()), f"fused {key} not finite")
    bs = black_scholes_call(spots, sigmas)
    price = out_p["price"].double().cpu().numpy()
    bs_err = float(np.max(np.abs(price - bs) / np.maximum(bs, 1e-8)))
    tb64 = build_trade_batch(dtype=torch.float64, device=dev, **bench_trades(B_CHECK)[0])
    spike64 = price_barrier_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-2, solver="spike")
    f32_vs_f64 = rel_errors(out_g, spike64, per_trade_price=True)
    fused64 = fused.price_barrier_batch_fused(tb64, N_NODES, with_greeks=True, dv_sigma=1e-2)
    f64_vs_spike = rel_errors(fused64, spike64, per_trade_price=False)
    limits_f64 = {"price": 1e-3, "delta": 1e-2, "gamma": 1e-2, "theta": 1e-2, "vega": 5e-2}
    emit("fused_path", B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float32", launches=launches,
         far_barrier_max_rel_err_vs_bs=bs_err, f32_vs_f64_spike_first_256=f32_vs_f64,
         limits=limits_f64, f64_vs_f64_spike=f64_vs_spike, f64_limit=1e-9, **card)
    check(bs_err <= 1e-3, f"fused far-barrier price vs Black–Scholes {bs_err:.3e} > 1e-3")
    for key, lim in limits_f64.items():
        check(f32_vs_f64[key] <= lim, f"fused f32 vs f64 {key}: {f32_vs_f64[key]:.3e} > {lim}")
    for key, val in f64_vs_spike.items():
        check(val <= 1e-9, f"fused f64 vs the f64 spike route {key}: {val:.3e} > 1e-9")
    k3 = dict(launches=launches["hs_march_f32"])

    # 11. the cyclic-reduction path (K4) ---------------------------------------
    kw_cr, spots_cr, sigmas_cr = bench_trades(B_MAIN, N_CR)
    tbc = build_trade_batch(dtype=torch.float32, device=dev, **kw_cr)
    kernels.reset_launch_counts()
    v_cr = cr.cn_barrier_solve_cr(tbc, tbc.sigma, N_CR, N_STEPS)
    torch.cuda.synchronize()
    launches_cr = dict(kernels.launch_counts)
    check(launches_cr["cr_march_f32"] > 0, "the cyclic-reduction path launched no cr_march kernel")
    check(v_cr.shape == (B_MAIN, N_CR) and bool(torch.isfinite(v_cr).all()), "CR values not finite")
    i = torch.arange(N_CR, dtype=torch.float64, device=dev)
    s_cr = torch.exp(tbc.x_min.double()[:, None] + i[None, :] * tbc.dx.double()[:, None])
    price_cr = linear_interp(tbc.s_eff.double(), s_cr, v_cr.double()).cpu().numpy()
    bs_cr = black_scholes_call(spots_cr, sigmas_cr)
    bs_err_cr = float(np.max(np.abs(price_cr - bs_cr) / np.maximum(bs_cr, 1e-8)))
    tbc64 = build_trade_batch(dtype=torch.float64, device=dev, **bench_trades(B_CHECK, N_CR)[0])
    v64 = cr.cn_barrier_solve_cr(tbc64, tbc64.sigma, N_CR, N_STEPS)
    v_scan, _ = _solve_scan(tbc64, tbc64.sigma, N_CR)
    scan_err = float((v64 - v_scan).abs().max() / v_scan.abs().max())
    emit("cr_path", B=B_MAIN, N=N_CR, steps=N_STEPS, dtype="float32", launches=launches_cr,
         far_barrier_max_rel_err_vs_bs=bs_err_cr, f64_B=B_CHECK, f64_vs_f64_scan=scan_err,
         f64_limit=1e-9, **card)
    check(bs_err_cr <= 1e-3, f"CR far-barrier price vs Black–Scholes {bs_err_cr:.3e} > 1e-3")
    check(scan_err <= 1e-9, f"CR f64 vs the f64 scan: {scan_err:.3e} > 1e-9")
    k4 = dict(launches=launches_cr["cr_march_f32"])

    # 12. timing ---------------------------------------------------------------
    def grids_per_s(with_greeks: bool, iters: int) -> float:
        fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=with_greeks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=with_greeks)
        torch.cuda.synchronize()
        return B_MAIN * iters / (time.perf_counter() - t0)

    gps = grids_per_s(False, 5)
    gps_greeks = grids_per_s(True, 3)
    timing = {}
    for kind, entry, batch, n_nodes in (("hs", k3, tb, N_NODES), ("cr", k4, tbc, N_CR)):
        prepare, kernel, plain = marches[kind]
        prep, prep_ms = host_ms(lambda: prepare(batch, batch.sigma, n_nodes))
        ms = cuda_ms(lambda: kernel(prep), reps=5)
        # the kernel against its plain version at the path's own shapes
        v_r, plain_ms = host_ms(lambda: plain(prep))
        v_k = kernel(prep)
        torch.cuda.synchronize()
        scale = float(v_r.abs().max())
        err = float((v_k - v_r).abs().max())
        emit(f"{kind}_kernel_vs_plain", size="main_path", dtype=str(torch.float32), B=B_MAIN,
             N=n_nodes, steps=N_STEPS, max_abs_err=err, max_abs_v=scale, ratio=err / scale,
             limit=limits[torch.float32], plain_ms_per_march=plain_ms, **card)
        check(math.isfinite(err) and err <= limits[torch.float32] * scale,
              f"{kind} kernel vs plain main path: {err / scale:.3e} > {limits[torch.float32]}")
        b = fused_bound(prep, kind)
        if kind == "hs":
            design = dict(design=kernels.hs_block(n_nodes)[0], design_bytes=hs_design_bytes(prep),
                          **residency(prep, kernels.hs_resident_trades))
        else:
            design = dict(design_bytes=cr_design_bytes(prep),
                          **residency(prep, kernels.cr_resident_trades))
        entry.update(max_abs_err=err, max_abs_err_over_max_abs_v=err / scale, ms=ms,
                     plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"], **design)
        timing[kind] = dict(prep_ms=prep_ms, kernel_ms_per_march=ms, plain_ms_per_march=plain_ms,
                            launches_per_march=1, N=n_nodes, **b, **design)
        del prep, v_r, v_k
    call_ms = B_MAIN / gps * 1e3
    emit("fused_timing", grids_per_s=gps, greeks_grids_per_s=gps_greeks, call_ms=call_ms,
         launches_per_call={"price_only": 1, "greeks": 2}, B=B_MAIN, steps=N_STEPS,
         hs=timing["hs"], cr=timing["cr"], **card)
    emit("fused_profile", **profile_call(
        lambda: fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=False), call_ms), **card)
    k3.update(name="hs_march_f32", source="finite_difference_tpu_torch/csrc/hs_march.cu",
              replaces="finite_difference_tpu/models/pde/pallas_kernel.py:70")
    k4.update(name="cr_march_f32", source="finite_difference_tpu_torch/csrc/cr_march.cu",
              replaces="finite_difference_tpu/models/pde/pallas_cr.py:129")
    return k3, k4


def rule_phases(dev, card: dict) -> None:
    """What two launch choices rest on, timed on the card.

    - The SPIKE march's P against the batch size
      (``spike.spike_p_choices``): on the barrier set at f32 and the
      American set at f32 and f64, at each B of :data:`P_RULE_B` and each P
      of :data:`SPIKE_P_CHECKED`, the solve (``cn_barrier_solve_spike``:
      the prep and the march) and the prep alone (host clock, median of
      :data:`RULE_REPS`, the P in turns), the march alone (CUDA events) and
      the prep's device kernels, beside the P that the rule takes.
    - The CR march against its occupancy: microseconds per step at N=1026
      with each count of :data:`CR_TRADES_PER_SM` trades on every SM
      (blocks of 4 trades); a march whose time does not grow with the
      trades per SM is bound by latency. And at each N of
      :data:`CR_SWEEP_N` at 4 trades per SM (one warp per SM scheduler):
      the time per step against the levels (log2 n) and the rows (n).
    """
    import statistics

    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import cr, spike
    from finite_difference_tpu_torch.models.pde.batch import (
        _spike_schedule_impl,
        build_american_batch,
        build_trade_batch,
    )

    # 13. the SPIKE march's P against the batch size ---------------------------
    for path, dtype in (("barrier", torch.float32), ("american", torch.float32),
                        ("american", torch.float64)):
        american = path == "american"
        for B in P_RULE_B:
            if american:
                tb = build_american_batch(dtype=dtype, device=dev, **american_trades(B)[0])
            else:
                tb = build_trade_batch(dtype=dtype, device=dev, **bench_trades(B)[0])
            segments, set_defs, div_steps, reset_steps = _spike_schedule_impl(tb, N_NODES)
            events = dict(div_steps=div_steps, reset_steps=reset_steps) if american else {}
            prepare = lambda P: spike.prepare_spike(tb, tb.sigma, N_NODES, P, set_defs, american)
            solve = lambda P: spike.cn_barrier_solve_spike(
                tb, tb.sigma, N_NODES, tb.n_steps, p_chunks=P, segments=segments,
                set_defs=set_defs, american=american, **events)
            # the P in turns, so that the host's drift reaches each alike
            solve_ms = {P: [] for P in SPIKE_P_CHECKED}
            prep_ms = {P: [] for P in SPIKE_P_CHECKED}
            for rep in range(RULE_REPS + 1):
                for P in SPIKE_P_CHECKED:
                    t_solve, t_prep = host_ms(lambda: solve(P))[1], host_ms(lambda: prepare(P))[1]
                    if rep:  # the first turn warms up
                        solve_ms[P].append(t_solve)
                        prep_ms[P].append(t_prep)
            by_p = {}
            for P in SPIKE_P_CHECKED:
                prep = prepare(P)
                ms = cuda_ms(lambda: spike.march_segments(tb, prep, segments, **events), reps=3)
                by_p[str(P)] = dict(solve_ms=statistics.median(solve_ms[P]),
                                    prep_ms=statistics.median(prep_ms[P]), march_ms=ms)
                if B == P_RULE_B[0]:  # the prep's launches do not depend on B
                    by_p[str(P)]["prep_device_kernels"] = profile_call(
                        lambda: prepare(P), 1.0)["device_kernels"]
            rule = prepare(None).P
            emit("spike_p_rule", path=path, dtype=str(dtype), B=B, N=N_NODES, steps=N_STEPS,
                 rule_P=rule, by_P=by_p, reps=RULE_REPS, **card)
            del tb, prep

    # 14. the CR march against its occupancy and its grid ----------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def cr_march(B, n_nodes):
        tb = build_trade_batch(dtype=torch.float32, device=dev, **bench_trades(B, n_nodes)[0])
        prep = cr.prepare_cr(tb, tb.sigma, n_nodes)
        ms = cuda_ms(lambda: kernels.cr_march_cuda(prep), reps=3)
        return dict(B=B, N=n_nodes, ms=ms, us_per_step=ms * 1e3 / N_STEPS)

    occupancy = [dict(trades_per_sm=k, **cr_march(k * sms, N_CR)) for k in CR_TRADES_PER_SM]
    grid = [cr_march(4 * sms, n) for n in CR_SWEEP_N]
    emit("cr_sweep", dtype="torch.float32", steps=N_STEPS, sms=sms, occupancy=occupancy,
         grid=grid, **card)


def spectral_cost(tb, n_nodes: int, matmuls: int) -> dict:
    """The matmul flops of one spectral call and the call's bound on the
    card: ``matmuls`` products of (B, M) by (M, M) (counted by the
    profiler) at 2 B M^2 flops each, over the peak rate of the dtype's
    matmul (float32 outside the tensor cores, float64 on them: both 67
    TFLOP/s), against each input of the batch read once and V written once
    over the memory rate; the larger of the two."""
    B, M = tb.batch_size, n_nodes - 2
    item = tb.sigma.element_size()
    flops = matmuls * 2 * B * M * M
    fields = [getattr(tb, f.name) for f in dataclasses.fields(tb)]
    nbytes = sum(x.numel() * x.element_size() for x in fields if x is not None) + B * n_nodes * item
    t_ops = flops / PEAK_MATMUL_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(matmul_flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_errors(out, ref, per_trade_price: bool):
    """Each output's error against ``ref`` (on ``ref``'s first trades):
    price per trade or of max|price|, the others of their max|value|."""
    errs = {}
    for key, val in ref.items():
        r = val.double().cpu().numpy()
        g = out[key][: r.shape[0]].double().cpu().numpy()
        if key == "price" and per_trade_price:
            errs[key] = float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-8)))
        else:
            errs[key] = float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
    return errs


def spectral_phases(dev, card: dict) -> None:
    """The spectral propagator, greeks_mode="ad", solve_value_surfaces and
    the card's auto rule (batch.auto_solver), each checked or timed.

    - spectral: the barrier set at full width (B=4096, N=1024, 512 steps,
      24 monitors), f64 and f32, price only and with greeks: grids/s, call
      ms, the matmul ms, device kernels and busy share (profiler), the
      matmul flops and the bound. Held: f64 against the f64 scan on the
      first 256 trades (1e-9 of max|value|, all five outputs) and its
      far-barrier price against Black–Scholes (1e-3). The same two limits
      at f32 (Black–Scholes, and main_path's f32 limits against the f64
      route) gate auto: where f32 misses them, auto_solver must not route a
      float32 batch to spectral on any of its inputs (checked), and the
      sweep leaves f32 spectral out of the measured rule. The first
      call's ms (eager: spectral.run_graphed's capture rule) and the
      greeks call after it, which captures the CUDA graph, with the card
      memory they leave reserved (the graph's pool). spectral_x64dst and spectral_mixed
      at f32, B=256, against f64 (1e-3 per trade: the JAX package's
      TestX64DstRescue floors); an f32 call under TF32 raises (or equals).
    - ad: greeks_mode="ad" at f64, B=256, on the barrier scan, the American
      scan and the spectral route: the outputs other than vega within 1e-12
      of the bump call; the barrier routes' vega within 1e-6 of max|vega|
      of a central difference of the same route at dv=1e-4. The American
      price is only piecewise smooth in sigma (a node's early-exercise
      test switches as sigma moves, and the jvp takes the derivative of
      the piece it is on, as the JAX package's does), so a difference
      across +-1e-4 straddles kinks: its vega is held to the same jvp on
      the CPU (the first 16 trades, 1e-10 of max|vega|; the CPU jvp is
      held to the JAX package's in tests/test_torch_greeks_ad.py), and the
      central difference is recorded and held at 1e-3.
    - surfaces: solve_value_surfaces at B=256 (barrier auto, barrier scan,
      American): its V at the spot is that route's price within 1e-12.
    - route_sweep: the barrier set at B = 256, 1024, 4096, f32 and f64,
      price only and with greeks: spike and spectral timed in turn
      (ROUTE_REPS calls each, interleaved, after a warm-up: median, min,
      max), the fused march and the scan at B=256 for the record; a cell
      is resolved where the faster route's slowest call beats the other's
      fastest; the measured pick beside auto_solver's, with the graphs the
      spectral cache then holds and the card memory reserved.
    """
    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import batch as pbatch
    from finite_difference_tpu_torch.models.pde import fused, spectral
    from finite_difference_tpu_torch.ops.interp import linear_interp

    build = lambda B, dtype: pbatch.build_trade_batch(dtype=dtype, device=dev, **bench_trades(B)[0])
    price = pbatch.price_barrier_batch

    def timed_calls(fn, reps: int) -> float:
        """Host-clock ms per call of ``fn`` after one warm-up call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    # 15. the spectral route at full width -------------------------------------
    t_phase = time.perf_counter()
    kw, spots, sigmas = bench_trades(B_MAIN)
    bs = black_scholes_call(spots, sigmas)
    ref64, f32_ok = {}, False
    for dtype in (torch.float64, torch.float32):
        tb = build(B_MAIN, dtype)
        label = str(dtype).split(".")[-1]
        # the first call of a key runs eagerly (the capture rule of
        # spectral.run_graphed); the greeks call after it captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        out_p = price(tb, N_NODES, with_greeks=False, solver="spectral")
        torch.cuda.synchronize()
        first_call = dict(ms=(time.perf_counter() - t0) * 1e3,
                          reserved_bytes=torch.cuda.memory_reserved() - reserved0)
        t0 = time.perf_counter()
        out_g = price(tb, N_NODES, with_greeks=True, solver="spectral", dv_sigma=1e-2)
        torch.cuda.synchronize()
        capture_call = dict(ms=(time.perf_counter() - t0) * 1e3,
                            reserved_bytes=torch.cuda.memory_reserved() - reserved0,
                            peak_reserved_bytes=torch.cuda.max_memory_reserved())
        for key, val in {**out_p, **out_g}.items():
            check(val.shape == (B_MAIN,) and bool(torch.isfinite(val).all()),
                  f"spectral {label} {key} not finite")
        bs_err = float(np.max(np.abs(out_p["price"].double().cpu().numpy() - bs) / np.maximum(bs, 1e-8)))
        if dtype == torch.float64:
            check(bs_err <= 1e-3, f"spectral f64 far-barrier price vs Black–Scholes {bs_err:.3e} > 1e-3")
            ref64 = {k: v[:B_CHECK] for k, v in out_g.items()}
            tb_c = build(B_CHECK, dtype)
            scan = price(tb_c, N_NODES, with_greeks=True, solver="scan", dv_sigma=1e-2)
            accuracy = dict(vs_f64_scan_first_256=rel_errors(out_g, scan, per_trade_price=False),
                            limit=1e-9)
            for key, val in accuracy["vs_f64_scan_first_256"].items():
                check(val <= 1e-9, f"spectral f64 vs the f64 scan {key}: {val:.3e} > 1e-9")
        else:
            # the f32 limits gate auto: a float32 batch may take the spectral
            # route only if it meets them (Black–Scholes and main_path's)
            limits_f32 = {"price": 1e-3, "delta": 1e-2, "gamma": 1e-2, "theta": 1e-2, "vega": 5e-2}
            errs = rel_errors(out_g, ref64, per_trade_price=True)
            f32_ok = bs_err <= 1e-3 and all(errs[k] <= lim for k, lim in limits_f32.items())
            accuracy = dict(vs_f64_spectral_first_256=errs, limits=limits_f32, bs_limit=1e-3,
                            passes_f32_limits=f32_ok)
            f32_routes = {pbatch.auto_solver("cuda", seg, passed, spectral_ok=True, american=american,
                                             float64=False, ad=ad)
                          for seg in (((0, N_STEPS, 0),), None) for passed in (True, False)
                          for american in (False, True) for ad in (False, True)}
            check(f32_ok or "spectral" not in f32_routes,
                  "auto routes float32 batches to the spectral route, which misses the f32 limits")
        timing = {}
        for greeks in (False, True):
            call = lambda: price(tb, N_NODES, with_greeks=greeks, solver="spectral")
            call_ms = timed_calls(call, 3)
            prof = profile_call(call, call_ms)
            timing["greeks" if greeks else "price_only"] = dict(
                grids_per_s=B_MAIN / call_ms * 1e3, **prof,
                **spectral_cost(tb, N_NODES, prof["matmul_kernels"]))
        kernels.reset_launch_counts()
        price(tb, N_NODES, with_greeks=False)
        torch.cuda.synchronize()
        auto_route = "spike" if any(kernels.launch_counts.values()) else "not spike"
        emit("spectral", dtype=label, B=B_MAIN, N=N_NODES, steps=N_STEPS, monitors=24,
             far_barrier_max_rel_err_vs_bs=bs_err, **accuracy, first_call=first_call,
             greeks_call_capturing=capture_call, timing=timing,
             auto_route_price_only=auto_route, **card)
        del tb, out_p, out_g

    # the precision rungs at f32, B=256, against the f64 scan, and TF32
    tb32, tb64 = build(B_CHECK, torch.float32), build(B_CHECK, torch.float64)
    oracle = price(tb64, N_NODES, with_greeks=False, solver="scan")["price"].cpu().numpy()
    rungs = {}
    for solver in ("spectral", "spectral_x64dst", "spectral_mixed"):
        p = price(tb32, N_NODES, with_greeks=False, solver=solver)["price"].double().cpu().numpy()
        rungs[solver] = float(np.max(np.abs(p - oracle) / oracle))
    for solver in ("spectral_x64dst", "spectral_mixed"):
        check(rungs[solver] < 1e-3, f"{solver} f32 vs the f64 scan {rungs[solver]:.3e} >= 1e-3")
    plain = price(tb32, N_NODES, with_greeks=False, solver="spectral")["price"]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        under_tf32 = price(tb32, N_NODES, with_greeks=False, solver="spectral")["price"]
        tf32 = "same output" if torch.equal(under_tf32, plain) else "differs"
    except ValueError:
        tf32 = "raised"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    emit("spectral_rungs", dtype="float32", B=B_CHECK, N=N_NODES, max_rel_err_vs_f64_scan=rungs,
         limit=1e-3, tf32_call=tf32, wall_s=time.perf_counter() - t_phase, **card)
    check(tf32 in ("same output", "raised"), "an f32 spectral call under TF32 changed its output")

    # 16. greeks_mode="ad" -------------------------------------------------------
    t_phase = time.perf_counter()
    tam = pbatch.build_american_batch(dtype=torch.float64, device=dev, **american_trades(B_CHECK)[0])
    ad_lines = {}
    for label, batch, fn, solver in (("barrier_scan", tb64, price, "scan"),
                                     ("american_scan", tam, pbatch.price_american_batch, "scan"),
                                     ("barrier_spectral", tb64, price, "spectral")):
        ad = fn(batch, N_NODES, greeks_mode="ad", solver=solver)
        bump = fn(batch, N_NODES, solver=solver, dv_sigma=1e-4)
        h = 1e-4
        lo, hi = batch._map(lambda x: x), batch._map(lambda x: x)
        lo.sigma, hi.sigma = batch.sigma - h, batch.sigma + h
        central = (fn(hi, N_NODES, with_greeks=False, solver=solver)["price"]
                   - fn(lo, N_NODES, with_greeks=False, solver=solver)["price"]) / (2 * h * 100.0)
        scale = float(ad["vega"].abs().max())
        vega_err = float((ad["vega"] - central).abs().max()) / scale
        others = {k: float((ad[k] - bump[k]).abs().max() / bump[k].abs().max())
                  for k in ad if k != "vega"}
        line = dict(vega_vs_central=vega_err, others_vs_bump=others,
                    bump_vega_vs_ad=float((bump["vega"] - ad["vega"]).abs().max()) / scale)
        for k, v in others.items():
            check(v <= 1e-12, f"ad {label}: {k} vs the bump call {v:.3e} > 1e-12")
        if label.startswith("american"):
            head = batch[:16].to("cpu")
            on_cpu = fn(head, N_NODES, greeks_mode="ad", solver=solver, device="cpu")["vega"]
            line["vega_vs_cpu_jvp_first_16"] = float((ad["vega"][:16].cpu() - on_cpu).abs().max()) / scale
            check(line["vega_vs_cpu_jvp_first_16"] <= 1e-10,
                  f"ad {label}: vega vs the CPU jvp {line['vega_vs_cpu_jvp_first_16']:.3e} > 1e-10")
            check(vega_err <= 1e-3, f"ad {label}: vega vs central difference {vega_err:.3e} > 1e-3")
        else:
            check(vega_err <= 1e-6, f"ad {label}: vega vs central difference {vega_err:.3e} > 1e-6")
        ad_lines[label] = line
    emit("ad", dtype="float64", B=B_CHECK, N=N_NODES, steps=N_STEPS, dv=1e-4, routes=ad_lines,
         limits={"vega_vs_central": 1e-6, "american_vega_vs_central": 1e-3,
                 "american_vega_vs_cpu_jvp": 1e-10, "others_vs_bump": 1e-12},
         wall_s=time.perf_counter() - t_phase, **card)

    # 17. solve_value_surfaces ---------------------------------------------------
    t_phase = time.perf_counter()
    surf = {}
    for label, batch, solver, american, fn in (
        ("barrier_auto", tb64, "auto", False, price),
        ("barrier_scan", tb64, "scan", False, price),
        ("american", tam, "scan", True, pbatch.price_american_batch),
    ):
        v, s = pbatch.solve_value_surfaces(batch, N_NODES, solver=solver, american=american)
        check(v.shape == s.shape == (B_CHECK, N_NODES) and v.is_cuda, f"surface {label} shape/device")
        p_surf = linear_interp(batch.s_eff, s, v)
        p_path = fn(batch, N_NODES, with_greeks=False, solver=solver)["price"]
        surf[label] = float((p_surf - p_path).abs().max() / p_path.abs().max())
        check(surf[label] <= 1e-12, f"surface {label} vs its price path {surf[label]:.3e} > 1e-12")
    emit("surfaces", dtype="float64", B=B_CHECK, N=N_NODES, price_vs_price_path=surf, limit=1e-12,
         wall_s=time.perf_counter() - t_phase, **card)
    del tb32, tb64, tam

    # 18. the route sweep behind auto_solver's rule on the card ----------------
    t_phase = time.perf_counter()
    cells = []
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for B in ROUTE_SWEEP_B:
            tb = build(B, dtype)
            for greeks in (False, True):
                calls = {route: (lambda r=route: price(tb, N_NODES, with_greeks=greeks, solver=r))
                         for route in ("spike", "spectral")}
                runs = {route: [] for route in calls}
                for fn in calls.values():  # twice: spectral captures on a key's second call
                    fn()
                    fn()
                for rep in range(ROUTE_REPS):  # interleaved, the order turned every call
                    for route in (("spike", "spectral") if rep % 2 == 0 else ("spectral", "spike")):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        calls[route]()
                        torch.cuda.synchronize()
                        runs[route].append((time.perf_counter() - t0) * 1e3)
                ms = {route: dict(median=float(np.median(v)), min=min(v), max=max(v))
                      for route, v in runs.items()}
                record = {"fused": timed_calls(
                    lambda: fused.price_barrier_batch_fused(tb, N_NODES, with_greeks=greeks),
                    ROUTE_RECORD_REPS)}
                if B == ROUTE_SWEEP_B[0]:
                    record["scan"] = timed_calls(
                        lambda: price(tb, N_NODES, with_greeks=greeks, solver="scan"), ROUTE_RECORD_REPS)
                fast, slow = sorted(ms, key=lambda r: ms[r]["median"])
                resolved = ms[fast]["max"] < ms[slow]["min"]
                # the pick: the faster route among those that meet the dtype's limits
                if not (f64 or f32_ok):
                    pick = "spike"
                else:
                    pick = fast if resolved else "unresolved"
                in_code = pbatch.auto_solver("cuda", ((0, N_STEPS, 0),), True, spectral_ok=True,
                                             float64=f64)
                cells.append(dict(float64=f64, B=B, greeks=greeks, ms=ms, record_ms=record,
                                  faster=fast, resolved=resolved, measured=pick, in_code=in_code))
            del tb
    emit("route_sweep", N=N_NODES, steps=N_STEPS, reps=ROUTE_REPS, record_reps=ROUTE_RECORD_REPS,
         cells=cells, agrees=all(c["measured"] in (c["in_code"], "unresolved") for c in cells),
         unresolved=sum(c["measured"] == "unresolved" for c in cells),
         graphs_cached=len(spectral._GRAPHS), graph_cache_size=spectral.GRAPH_CACHE_SIZE,
         reserved_bytes=torch.cuda.memory_reserved(), wall_s=time.perf_counter() - t_phase, **card)


def serving_trades(kind: str, n: int, rng) -> list:
    """A request of ``n`` trade dicts, as a desk's stream mixes them.

    barrier: bench_trades's underlyings (spots U(180, 250), sigma
    U(0.2, 0.35), K=190, r=b=0.0705), each with its own expiry (0.5-2x the
    set's month) and monitor count (4-24, evenly spaced): up-and-out at the
    set's far barrier (H=420), up-and-out at a near barrier (H U(260, 320))
    with a rebate of 1 at hit, its up-and-in twin with a rebate of 1, and
    vanillas. american: american_trades's puts (spots U(80, 120), sigma
    U(0.15, 0.40), K=100, r=0.06, b=0.02), each with its own expiry
    (0.25-2 years), no dividends."""
    if kind == "barrier":
        _, spots, sigmas = bench_trades(B_MAIN)
    else:
        _, spots, sigmas = american_trades(B_MAIN)
    idx = rng.integers(0, B_MAIN, n)
    out = []
    for i in idx:
        if kind == "american":
            out.append(dict(spot=float(spots[i]), strike=AM_STRIKE, sigma=float(sigmas[i]),
                            t_expiry=float(rng.uniform(0.25, 2.0)), r=AM_RATE, b=AM_CARRY))
            continue
        t = T_EXP * float(rng.uniform(0.5, 2.0))
        n_mon = int(rng.integers(4, 25))
        trade = dict(spot=float(spots[i]), strike=STRIKE, sigma=float(sigmas[i]), t_expiry=t,
                     r=RATE, monitor_times=[t * (k + 1) / n_mon for k in range(n_mon)])
        style = int(rng.integers(0, 4))
        near = float(rng.uniform(260.0, 320.0))
        trade.update((dict(barrier_type="up-and-out", upper=BARRIER),
                      dict(barrier_type="up-and-out", upper=near, rebate=1.0, rebate_at_hit=True),
                      dict(barrier_type="up-and-in", upper=near, rebate=1.0),
                      dict(barrier_type="none"))[style])
        out.append(trade)
    return out


def rows_error(got: list, want: list, keys=None, per_trade_price: bool = False) -> dict:
    """Each output's max error over the rows, of its max|want| (price per
    trade with ``per_trade_price``)."""
    errs = {}
    for k in keys or want[0]:
        g = np.array([r[k] for r in got])
        w = np.array([r[k] for r in want])
        if k == "price" and per_trade_price:
            errs[k] = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-8)))
        else:
            errs[k] = float(np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1e-300))
    return errs


def serving_phases(dev, card: dict) -> dict:
    """The serving path: the port's bucketed services and micro-batching
    server at full width (512 steps, 1024 nodes), on a desk's mixed stream
    (:func:`serving_trades`).

    - Four services: barrier float32 price only (SPIKE, K1), barrier
      float64 with greeks (the default: spectral), American float64 with
      greeks (the default: K2), American float32 price only (K1a). At each
      bucket of :data:`SERVE_BUCKETS`, :data:`SERVE_REQUESTS` requests of
      fresh mixes (half the bucket to the bucket): the first request's ms,
      the steady ms (median, min, max of the rest), the K1/K1a/K2 launches
      and the spectral graph counts over them (eager first sightings,
      captures, replays), the route, one request's host build ms
      (``build_batch``) and price ms (the driver call on that batch), its
      device kernels (profiler), and the card memory reserved.
    - Checks: each service's rows equal a direct ``price_barrier_batch`` /
      ``price_american_batch`` call on the same padded bucket (knock-ins
      excepted: they are served by parity), within 1e-12 of max|value| at
      float64 and 2e-4 at float32; served KO + KI = generalized
      Black–Scholes + R·DF within 1e-10 (float64); the hybrid lane on the
      card (``greeks_mode="ad"``) equals the port's analytic lane on the
      CPU within 1e-12 (theta, a central maturity bump of 1e-5, within
      1e-9); the launches of K1, K1a and K2 on their services, and of K5
      (``ki_parity_f64``), one a request with a knock-in row, none without.
    - Policy evidence (not a gate): float32 services with greeks
      (``greeks_dtype=float32``) against the float64 ones, per greek,
      beside the f32 limits of the earlier phases.
    - Server: ``PricingServer`` at ``window_ms=5`` on the float64 barrier
      service; :data:`SERVER_CLIENTS` concurrent 1-trade clients, then a
      burst of :data:`SERVER_BURST` requests of 1-512 trades: latency p50
      and p99, batches, trades per batch, trades per second; every response
      against ``service.price`` of the same trades within 1e-9.
    """
    import http.client
    import statistics
    import threading

    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.analytic import (
        generalized_bs_price,
        monitoring_decision,
    )
    from finite_difference_tpu_torch.models.pde import spectral
    from finite_difference_tpu_torch.models.pde.batch import (
        price_american_batch,
        price_barrier_batch,
    )
    from finite_difference_tpu_torch.serving import (
        AmericanPricingService,
        BarrierPricingService,
        PricingServer,
    )

    spike_names = ("spike_march_f32", "spike_march_f64", "spike_march_american_f32",
                   "spike_march_american_f64")
    services = (
        ("barrier_f32_price", "barrier", "spike_march_f32",
         BarrierPricingService(dtype=np.float32, with_greeks=False, device=dev)),
        ("barrier_f64_greeks", "barrier", None, BarrierPricingService(device=dev)),
        ("american_f64_greeks", "american", "spike_march_american_f64",
         AmericanPricingService(device=dev)),
        ("american_f32_price", "american", "spike_march_american_f32",
         AmericanPricingService(dtype=np.float32, with_greeks=False, device=dev)),
    )
    serving_launches = {}
    lines = []
    for label, kind, kernel, svc in services:
        f64 = svc.dtype == torch.float64
        check(svc.num_space_nodes + (1 if kind == "barrier" else 2) == N_NODES
              and svc.n_time_steps == N_STEPS, f"{label} is not at full width")
        driver = price_barrier_batch if kind == "barrier" else price_american_batch
        launches_total = dict.fromkeys(spike_names + ("ki_parity_f64",), 0)
        for bucket in SERVE_BUCKETS:
            rng = np.random.default_rng(1000 * bucket + len(lines))
            request = lambda: serving_trades(kind, int(rng.integers(bucket // 2 + 1, bucket + 1)), rng)
            stream = [request() for _ in range(SERVE_REQUESTS)]
            kernels.reset_launch_counts()
            spectral.reset_graph_counts()
            first_ms = host_ms(lambda: svc.price(stream[0]))[1]
            steady = [host_ms(lambda: svc.price(req))[1] for req in stream[1:]]
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            graphs = dict(spectral.graph_counts)
            # a request's first solve is its sighting of its graph key (the
            # vega bump's solve follows it): what a rule that captured on a
            # key's first call would have captured
            graphs["first_sightings"] = graphs["eager"] // (2 if svc.with_greeks else 1)
            for k in launches_total:
                launches_total[k] += kernels.launch_counts[k]
            # K5: one launch a request with a knock-in row, none without
            knocked_in = sum(any("in" in t.get("barrier_type", "none") for t in req) for req in stream)
            check(launches.get("ki_parity_f64", 0) == knocked_in,
                  f"{label} B={bucket}: {launches.get('ki_parity_f64', 0)} ki_parity_f64 launches "
                  f"for {knocked_in} requests with knock-ins")
            route = ("spike" if any(launches.get(k) for k in spike_names) else
                     "spectral" if any(graphs.values()) else "scan")
            # one request split into its host build and its price, and held
            # against the driver's call on the same padded bucket
            trades = request()
            tb, build_ms = host_ms(lambda: svc.build_batch(trades, bucket))
            direct, price_ms = host_ms(lambda: driver(tb, N_NODES, with_greeks=svc.with_greeks,
                                                      solver=svc.solver, device=dev))
            served = svc.price(trades)
            keep = [i for i, t in enumerate(trades) if "in" not in t.get("barrier_type", "none")]
            want = [{k: float(direct[k][i]) for k in served[0]} for i in keep]
            vs_direct = rows_error([served[i] for i in keep], want)
            limit = 1e-12 if f64 else 2e-4
            prof = profile_call(lambda: svc.price(trades), statistics.median(steady))
            line = dict(service=label, bucket=bucket, requests=SERVE_REQUESTS, route=route,
                        first_ms=first_ms, steady_ms=dict(median=statistics.median(steady),
                                                          min=min(steady), max=max(steady)),
                        trades_per_request=len(trades), build_ms=build_ms, price_ms=price_ms,
                        device_kernels=prof["device_kernels"], busy_share=prof["busy_share"],
                        launches=launches, graph_counts=graphs,
                        graphs_cached=len(spectral._GRAPHS),
                        reserved_bytes=torch.cuda.memory_reserved(), vs_direct=vs_direct,
                        limit=limit)
            emit("serving", dtype=str(svc.dtype), with_greeks=svc.with_greeks, N=N_NODES,
                 steps=N_STEPS, **line, **card)
            lines.append(line)
            for k, v in vs_direct.items():
                check(math.isfinite(v) and v <= limit,
                      f"{label} B={bucket} {k} vs the direct call {v:.3e} > {limit}")
        if kernel is not None:
            check(launches_total[kernel] > 0, f"the {label} service launched no {kernel} kernel")
            serving_launches[kernel] = launches_total[kernel]
        serving_launches["ki_parity_f64"] = (serving_launches.get("ki_parity_f64", 0)
                                             + launches_total["ki_parity_f64"])

    svc32, svc64, am64, am32 = (svc for *_, svc in services)

    # knock-in parity: KO + KI = generalized Black–Scholes + R·DF (float64)
    rng = np.random.default_rng(5)
    twins = []
    for t in serving_trades("barrier", 32, rng):
        t.update(barrier_type="up-and-out", upper=float(rng.uniform(260.0, 320.0)),
                 rebate=float(rng.uniform(0.5, 2.0)), rebate_at_hit=False)
        twins += [t, dict(t, barrier_type="up-and-in")]
    served = svc64.price(twins)
    col = lambda key: torch.tensor([t[key] for t in twins[::2]], dtype=torch.float64)
    van = generalized_bs_price(col("spot"), col("strike"), col("sigma"), col("t_expiry"),
                               col("r"), col("r"), True).numpy()
    ref = van + (col("rebate") * torch.exp(-col("r") * col("t_expiry"))).numpy()
    got = np.array([served[2 * i]["price"] + served[2 * i + 1]["price"] for i in range(32)])
    parity = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    check(parity <= 1e-10, f"served KO + KI vs Black–Scholes + R·DF {parity:.3e} > 1e-10")

    # the hybrid lane on the card against the port's analytic lane on the CPU
    hyb = dict(route="hybrid", greeks_mode="ad")
    trades = serving_trades("barrier", 64, rng)
    for t in trades[::2]:
        t.update(barrier_type="up-and-out", upper=float(rng.uniform(260.0, 320.0)), rebate=0.0,
                 monitor_times=[t["t_expiry"] * (k + 1) / 2100 for k in range(2100)])
    served = BarrierPricingService(device=dev, **hyb).price(trades)
    cpu = BarrierPricingService(device="cpu", **hyb)
    cont = list(range(0, 64, 2))
    use_cont, adj = monitoring_decision(
        np.array([trades[i]["t_expiry"] for i in cont]), cpu._monitors([trades[i] for i in cont]),
        np.array([trades[i]["sigma"] for i in cont]))
    check(bool(use_cont.all()), "the hybrid check's dense trades are not in the continuous regime")
    want = cpu._price_continuous([trades[i] for i in cont], adj)
    hybrid = rows_error([served[i] for i in cont], want)
    for k, v in hybrid.items():
        lim = 1e-9 if k == "theta" else 1e-12
        check(v <= lim, f"hybrid lane on the card vs the CPU {k} {v:.3e} > {lim}")

    # policy evidence: float32 greeks against the float64 services
    policy = {}
    limits_policy = {
        "barrier": {"price": 1e-3, "delta": 1e-2, "gamma": 1e-2, "theta": 1e-2, "vega": 5e-2},
        "american": {"price": 2e-3, "delta": 1e-2, "gamma": 1e-1, "vega": 5e-2},
    }
    for kind, ref_svc, cls in (("barrier", svc64, BarrierPricingService),
                               ("american", am64, AmericanPricingService)):
        check(cls(dtype=np.float32, device=dev).dtype == torch.float64,
              f"a float32 {kind} service with greeks does not solve at float64")
        f32g = cls(dtype=np.float32, greeks_dtype=np.float32, device=dev)
        trades = serving_trades(kind, 512, np.random.default_rng(6))
        got, want = f32g.price(trades), ref_svc.price(trades)
        errs = rows_error(got, want, per_trade_price=True)
        policy[kind] = dict(f32_vs_f64=errs, limits=limits_policy[kind],
                            price_of_max_price=rows_error(got, want, keys=["price"])["price"],
                            within={k: errs[k] <= lim for k, lim in limits_policy[kind].items()},
                            max_over_1e_3={k: errs[k] / 1e-3 for k in errs})
    emit("serving_checks", dtype="float64", N=N_NODES, steps=N_STEPS,
         ki_parity_vs_bs_plus_rebate=parity, ki_limit=1e-10, hybrid_ad_vs_cpu=hybrid,
         hybrid_limits={"theta": 1e-9, "others": 1e-12}, policy=policy,
         serving_launches=serving_launches, **card)

    # the micro-batching server on the float64 barrier service
    def post(srv, trades):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/price", json.dumps({"trades": trades}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            return resp.status, body, (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()

    def wave(srv, requests):
        out = [None] * len(requests)
        start = threading.Barrier(len(requests))

        def client(i):
            start.wait()
            out[i] = post(srv, requests[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        batches0, t0 = srv.stats["batches"], time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600.0)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a server client did not finish")
        check(all(o[0] == 200 for o in out), f"server statuses {sorted({o[0] for o in out})}")
        lat = np.array([o[2] for o in out])
        n_trades = sum(len(r) for r in requests)
        batches = srv.stats["batches"] - batches0
        return [o[1]["results"] for o in out], dict(
            requests=len(requests), trades=n_trades, p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)), max_ms=float(lat.max()), batches=batches,
            trades_per_batch=n_trades / max(batches, 1), trades_per_s=n_trades / wall, wall_s=wall)

    rng = np.random.default_rng(8)
    singles = [serving_trades("barrier", 1, rng) for _ in range(SERVER_CLIENTS)]
    burst = [serving_trades("barrier", int(n), rng) for n in rng.integers(1, 513, SERVER_BURST)]
    with PricingServer(svc64, window_ms=5.0, max_queue=1024) as srv:
        got_singles, single_stats = wave(srv, singles)
        got_burst, burst_stats = wave(srv, burst)
        server_stats = dict(srv.stats)
        backend = srv.backend
    # the references, after the server stopped: service.price of the same trades
    server_err = {}
    for label, reqs, got in (("singles", singles, got_singles), ("burst", burst, got_burst)):
        want, group = [], []
        for req in reqs + [None]:
            if req is None or sum(map(len, group)) + len(req) > svc64.max_bucket:
                rows = svc64.price([t for g in group for t in g])
                for g in group:
                    want.append(rows[:len(g)])
                    rows = rows[len(g):]
                group = []
            if req is not None:
                group.append(req)
        server_err[label] = rows_error([r for g in got for r in g], [r for g in want for r in g])
    emit("serving_server", service="barrier_f64_greeks", window_ms=5.0, backend=backend,
         singles=single_stats, burst=burst_stats, stats=server_stats,
         vs_service_price=server_err, limit=1e-9, **card)
    for label, errs in server_err.items():
        for k, v in errs.items():
            check(v <= 1e-9, f"server {label} {k} vs service.price {v:.3e} > 1e-9")
    return serving_launches


# the barrier cells whose requests K5 is held on: (configuration, traffic)
KI_CELLS = (("fa_barrier_f64", "ladder_fixed_book"), ("fa_barrier_f64_mesh4", "ladder_fixed_book_16x16"))


def ki_parity_request(config: str, traffic: str):
    """(the service's settings, the first request of the cell's pool): the
    benchmark's configuration and traffic files, through its generator, so
    the trades are the cell's own (``fa_barrier_f64.sweep``: 4096 trades,
    960 knock-ins; ``fa_barrier_f64_mesh4.sweep4``: 16,384 and 3840)."""
    from benchmark.traffic import ClosedLoop

    def load(*path):
        with open(os.path.join(HERE, "benchmark", *path)) as f:
            return json.load(f)

    cfg = load("configs", f"{config}.json")
    service = {k: v for k, v in cfg["service"].items() if k not in ("kind", "mesh")}
    service["dtype"] = np.dtype(service["dtype"])
    return service, ClosedLoop(cfg["trades"], load("traffic", f"{traffic}.json"), 0).request(0)


def ki_parity_check(svc, trades) -> dict:
    """One request priced by ``svc`` with its knock-in parity watched: the
    stack of outputs that ``_price_pde`` hands to ``_apply_ki_parity`` is
    kept before and after, and the parity is redone by
    ``ki_parity_reference`` on a copy of the same stack. Returns the rows,
    the stacks, the keys, the knock-ins and each output's max |after -
    plain| (0 where equal bit for bit)."""
    import torch
    from finite_difference_tpu_torch.serving.service import ki_parity_reference

    seen = {}
    apply = svc._apply_ki_parity

    def watched(stack, keys, knock_ins):
        seen.update(before=stack.clone(), keys=list(keys), knock_ins=knock_ins)
        apply(stack, keys, knock_ins)
        seen["after"] = stack.clone()

    svc._apply_ki_parity = watched
    try:
        rows = svc.price(trades)
    finally:
        del svc._apply_ki_parity
    check("after" in seen, "the request ran no knock-in parity")
    plain = seen["before"].clone()
    ki_parity_reference(plain, seen["keys"], *seen["knock_ins"])
    gap = {k: float((seen["after"][i] - plain[i]).abs().max())
           for i, k in enumerate(seen["keys"])}
    same = {k: bool(torch.equal(seen["after"][i], plain[i])) for i, k in enumerate(seen["keys"])}
    return dict(rows=rows, plain=plain, gap=gap, same=same, **seen)


def ki_parity_bound(n: int, K: int, evaluations: int) -> dict:
    """The bound of one knock-in parity launch over ``n`` rows and ``K``
    outputs. Operations: per vanilla evaluation 77 FP64 additions,
    multiplications and divisions (the forward and the discount 3, d1 and
    d2 8, two of Hart's rationals at 31 each, the payoff 4) and six
    transcendentals (four exponentials, a logarithm, a square root) at 20
    each, ``evaluations`` a row (6 with every output), and 20 for the
    discount and the parity rows; bytes: the 8 fields and the row index
    read once, each output read and written once."""
    flops = n * (evaluations * (77 + 6 * 20) + 20)
    nbytes = n * (8 + 1 + 2 * K) * 8
    t_ops, t_bytes = flops / PEAK_F64_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def ki_parity_phases(dev, card: dict) -> dict:
    """K5, the knock-in parity (``csrc/ki_parity.cu``), on the barrier
    cells' own requests (:func:`ki_parity_request`), each priced once by
    the float64 service as its cell configures it, on this one card. The
    kernel's result on the stack the main path hands it is held to
    ``ki_parity_reference`` on a copy of the same stack, output by output,
    bit for bit (:func:`ki_parity_check`); the other columns must be left
    as priced and the host rows must be the stack's. One launch a request.
    Then on that stack the kernel's device time (profiler, per launch), the
    plain version's (host clock, synchronised) and the bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.serving import BarrierPricingService
    from finite_difference_tpu_torch.serving.service import ki_parity_reference

    k5 = None
    for config, traffic in KI_CELLS:
        service, trades = ki_parity_request(config, traffic)
        service["max_bucket"] = max(service["max_bucket"], len(trades))
        svc = BarrierPricingService(device=dev, **service)
        kernels.reset_launch_counts()
        got = ki_parity_check(svc, trades)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        keys, before, after, knock_ins = got["keys"], got["before"], got["after"], got["knock_ins"]
        n_in = sum("in" in str(t.get("barrier_type", "none")) for t in trades)
        n, B, K = knock_ins.rows.shape[0], before.shape[1], before.shape[0]
        check(n == n_in and n > 0, f"{config}: {n} knock-in rows for {n_in} knock-in trades")
        check(launches.get("ki_parity_f64") == 1, f"{config}: ki_parity_f64 launches {launches}")
        check(all(got["same"].values()), f"{config}: kernel vs plain, max gaps {got['gap']}")
        rest = torch.ones(B, dtype=torch.bool, device=before.device)
        rest[knock_ins.rows] = False
        check(torch.equal(after[:, rest], before[:, rest]), f"{config}: parity moved other rows")
        at = keys.index("price")
        check(bool((after[at, knock_ins.rows] != before[at, knock_ins.rows]).all()),
              f"{config}: a knock-in price was left as its knock-out leg")
        host = np.array([[row[k] for k in keys] for row in got["rows"]]).T
        check(np.array_equal(host, after.cpu().numpy()), f"{config}: the host rows are not the stack's")

        kernel = lambda w: kernels.ki_parity_cuda(w, keys, *knock_ins)
        work = [before.clone() for _ in range(20)]
        kernel(before.clone())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for w in work:
                kernel(w)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "ki_parity" in e.key]
        count = sum(e.count for e in rows)
        check(count == len(work), f"{config}: the profiler saw {count} ki_parity launches")
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / count
        plain = lambda w: ki_parity_reference(w, keys, *knock_ins)
        call_ms, plain_ms = (sorted(host_ms(lambda w=before.clone(): fn(w))[1] for _ in range(5))[2]
                             for fn in (kernel, plain))
        evaluations = 1 + 2 * ("delta" in keys or "gamma" in keys) + ("vega" in keys) + 2 * ("theta" in keys)
        b = ki_parity_bound(n, K, evaluations)
        scale = float(after[:, knock_ins.rows].abs().max())
        err = max(got["gap"].values())
        emit("ki_parity", config=config, traffic=traffic, B=B, knock_ins=n, keys=keys,
             launches=launches.get("ki_parity_f64", 0), bit_for_bit=got["same"],
             max_abs_err=err, max_abs_v=scale, ms=ms, call_ms=call_ms, plain_ms=plain_ms, **b,
             **card)
        if k5 is None:  # the one-card cell's shape is the summary's
            k5 = dict(name="ki_parity_f64", launches=launches.get("ki_parity_f64", 0),
                      replaces="finite_difference_tpu/serving/service.py:380",
                      source="finite_difference_tpu_torch/csrc/ki_parity.cu",
                      max_abs_err=err, max_abs_err_over_max_abs_v=err / scale,
                      ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        del svc, got, before, after, work
    return k5


FA_HEADER = ["scenario_name", "S0", "K", "sigma", "rate", "barrier_type", "upper_barrier",
             "lower_barrier", "FA_price", "FA_delta", "FA_gamma", "FA_vega"]


def fa_stress_rows() -> dict:
    """Phase 20's barrier stress table, per option type (a runner prices
    one per table): the golden trades x :data:`FA_SPOT_SHOCKS` x
    :data:`FA_VOL_SHOCKS`, 4160 rows in all, in :data:`FA_HEADER`'s order."""
    blank = lambda x: "" if x is None else x
    return {opt: [[f"{r[0]}_s{i}_v{j}", FA_SPOT * (1.0 + ds), r[3], r[4] * dv, FA_RATE, r[2],
                   blank(r[6]), blank(r[5]), "", "", "", ""]
                  for r in FA_GOLDEN if r[1] == opt for i, ds in enumerate(FA_SPOT_SHOCKS)
                  for j, dv in enumerate(FA_VOL_SHOCKS)] for opt in ("call", "put")}


def write_csv(path: str, header, rows) -> str:
    import csv

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        w.writerows(rows)
    return path


def fa_phases(dev, card: dict) -> dict:
    """Phase 20, the FA-validation path, at the runners' and FA's own widths
    (float64, 500 steps). Returns the kernels' launches in 20c's tables.

    - 20a, the xlsx golden rows (:data:`FA_GOLDEN`) through
      ``DiscreteBarrierFDMPricer`` on the card (``price_log2``,
      ``greeks_log2``; the chooser's 2134 nodes), each held to
      test_xlsx_golden.py's limits (the ``abs(p) > 1e-3`` split included),
      :data:`FA_CPU_ROWS` against the port on the CPU (1e-10 of
      max|value|). Per row its ms, and the graph counts; one key's eager,
      capture and replayed ms, the replay against the eager run (1e-12),
      and a solve's device kernels (profiler, on a replay). No kernel of ours
      runs: the scalar pricers keep to the scan, as the JAX package's do.
    - 20b, the American scalar pricers: FA trade 201870944 through
      ``VanillaOptionPricerFIS`` (``price(500)``, ``calculate_greeks(500)``;
      within FA's 1% materiality) and a one-year put with a cash dividend
      through ``AmericanFDMPricer`` at 500 x 500 (``price_log2``,
      ``greeks_log2``), each against the CPU: first-order outputs within
      1e-10 of max|value|; FIS gamma and theta, second differences over
      ds = 1e-3 S that multiply a price's rounding by 4/ds^2, within 1e-7.
    - 20c, the batched runners at a desk's scenario size: the golden
      trades x :data:`FA_SPOT_SHOCKS` x :data:`FA_VOL_SHOCKS` (4160 rows, a
      table of calls and one of puts, since a runner prices one option
      type) through ``run_all_scenarios_batched`` (routes ``pde`` and ``hybrid``;
      the default 500 steps, 501 nodes: the spectral route on the card),
      and 4096 rows of bench.py's American put set (spots U(80, 120),
      sigma U(0.15, 0.40), K=100, seed 7; the runner's flat curve makes
      r = b = 0.06) through ``run_all_american_scenarios_batched``
      (Richardson, 500 x 500 and 1000 steps: K2). Per table the ms of each
      of :data:`FA_TABLE_CALLS` calls, rows/s of the last, its host build
      ms beside its driver ms, the graph counts, K2's launches and the card
      memory reserved; the first :data:`FA_SUBSET` rows against the port's
      CPU runner (barrier 1e-9 of max|price|, American 1e-6), and the
      barrier batch's spectral prices against the scan on the card (1e-9).
    - 20d, ``run_all_scenarios`` on the golden rows written as CSVs (calls,
      puts) gives 20a's numbers exactly; the two CLIs (``--batched``; the
      barrier CLI on the golden calls) run at once as subprocesses on the
      card, exit 0 and write their CSVs.
    """
    import csv
    import datetime as dt
    import statistics
    import tempfile

    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import (
        AmericanFDMPricer,
        DiscreteBarrierFDMPricer,
        VanillaOptionPricerFIS,
        spectral,
    )
    from finite_difference_tpu_torch.models.pde import batch as pbatch
    from finite_difference_tpu_torch.runners import (
        run_all_american_scenarios_batched,
        run_all_scenarios,
        run_all_scenarios_batched,
    )
    from finite_difference_tpu_torch.utils.curves import flat_curve, flat_naca_dataframe

    val, mat = dt.date(2025, 7, 28), dt.date(2025, 8, 28)
    monitors = [val + dt.timedelta(days=d) for d in FA_MONITOR_DAYS]
    curve = flat_curve(FA_RATE, val)
    wall = {}

    def rel_err(got: dict, want: dict, keys=None) -> float:
        keys = keys or list(want)
        scale = max(abs(float(want[k])) for k in keys)
        return max(abs(float(got[k]) - float(want[k])) for k in keys) / scale

    def golden_pricer(row, device):
        _, opt, btype, k, sigma, lower, upper = row[:7]
        return DiscreteBarrierFDMPricer(
            spot=FA_SPOT, strike=k, valuation_date=val, maturity_date=mat, sigma=sigma,
            option_type=opt, barrier_type=btype, lower_barrier=lower, upper_barrier=upper,
            monitor_dates=monitors, discount_curve=curve, forward_curve=curve,
            underlying_spot_days=0, option_days=0, option_settlement_days=0,
            num_space_nodes=500, num_time_steps=500, device=device,
        )

    def priced(pricer) -> dict:
        g = pricer.greeks_log2()
        return {"price": pricer.price_log2(), **{k: g[k] for k in ("delta", "gamma", "vega", "theta")}}

    # 20a. the golden rows on the scalar barrier pricer ---------------------------
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    # the capture rule on one key: a three-sigma solve on co1's grid
    p0 = golden_pricer(FA_GOLDEN[0], dev)
    sig = p0.sigma
    solve3 = lambda: p0._solve_grids([sig, sig + 1e-4, sig - 1e-4], "up-and-out")
    spectral.reset_graph_counts()
    v_eager, eager_ms = host_ms(solve3)
    _, capture_ms = host_ms(solve3)
    v_replay, replay_ms = host_ms(solve3)
    prof = profile_call(solve3, replay_ms)
    key_counts = dict(spectral.graph_counts)
    check(key_counts == {"eager": 1, "captures": 1, "replays": 3},
          f"the scan's capture rule: {key_counts}")
    replay_err = float(np.abs(v_replay - v_eager).max() / np.abs(v_eager).max())
    check(replay_err <= 1e-12, f"replayed scan vs its eager run {replay_err:.3e} > 1e-12")
    emit("fa_scan_key", B=3, N=p0.grid.n_nodes, steps=500, eager_ms=eager_ms,
         capture_ms=capture_ms, replay_ms=replay_ms, replay_vs_eager=replay_err,
         device_kernels_per_solve=prof["device_kernels"], replay_device_ms=prof["device_ms"],
         replay_busy_share=prof["busy_share"], graphs=key_counts, **card)

    spectral.reset_graph_counts()
    golden, row_ms = {}, []
    for row in FA_GOLDEN:
        name, p, d, g, v = row[0], *row[7:]
        pricer = golden_pricer(row, dev)
        out, ms = host_ms(lambda: priced(pricer))
        golden[name] = out
        row_ms.append(ms)
        if abs(p) > 1e-3:
            ok = (abs(out["price"] - p) <= 5e-6 * abs(p)
                  and abs(out["delta"] - d) <= max(5e-6 * abs(d), 1e-7)
                  and abs(out["gamma"] - g) <= max(5e-4 * abs(g), 1e-7)
                  and abs(out["vega"] - v) <= max(2e-4 * abs(v), 1e-7))
        else:
            ok = abs(out["price"] - p) <= 1e-4 and abs(out["delta"] - d) <= 1e-3
        emit("fa_golden_row", name=name, ms=ms, **out,
             xlsx=dict(price=p, delta=d, gamma=g, vega=v), within_xlsx_limits=ok)
        check(ok, f"golden row {name} outside test_xlsx_golden.py's limits: {out}")
    graphs = dict(spectral.graph_counts)
    cpu_err = {}
    for row in FA_GOLDEN:
        if row[0] in FA_CPU_ROWS:
            cpu_err[row[0]] = rel_err(golden[row[0]], priced(golden_pricer(row, "cpu")))
            check(cpu_err[row[0]] <= 1e-10, f"golden row {row[0]} card vs CPU {cpu_err[row[0]]:.3e}")
    launches = dict(kernels.launch_counts)
    check(not any(launches.values()), f"the scalar pricers launched a kernel of ours: {launches}")
    emit("fa_golden", rows=len(FA_GOLDEN), N=p0.grid.n_nodes, steps=500, first_row_ms=row_ms[0],
         second_row_ms=row_ms[1], steady_row_ms=statistics.median(row_ms[2:]),
         steady_min_ms=min(row_ms[2:]), steady_max_ms=max(row_ms[2:]), total_ms=sum(row_ms),
         graph_counts=graphs, card_vs_cpu=cpu_err, limit=1e-10, **card)
    wall["20a golden rows"] = time.perf_counter() - t_phase

    # 20b. the American scalar pricers ---------------------------------------------
    t_phase = time.perf_counter()
    fis_curve = flat_naca_dataframe(math.exp(FIS_R_NACC) - 1.0)

    def fis(device):
        pr = VanillaOptionPricerFIS(valuation_date=val, maturity_date=mat, discount_curve=fis_curve,
                                    device=device, **FIS_TRADE)
        return {"price_500": pr.price(500), **pr.calculate_greeks(500)}

    am_curve = flat_curve(0.06, val)

    def american(device):
        pr = AmericanFDMPricer(
            100.0, 100.0, val, dt.date(2026, 7, 28), 0.3, "put", am_curve,
            dividend_schedule=[(dt.date(2026, 1, 15), 2.0)], num_space_nodes=500,
            num_time_steps=500, device=device)
        return {"price_log2": pr.price_log2(), **pr.greeks_log2()}

    spectral.reset_graph_counts()
    fis_gpu, fis_ms = host_ms(lambda: fis(dev))
    am_gpu, am_ms = host_ms(lambda: american(dev))
    graphs_b = dict(spectral.graph_counts)
    t0 = time.perf_counter()
    fis_cpu, am_cpu = fis("cpu"), american("cpu")
    cpu_s = time.perf_counter() - t0
    second = ("Gamma", "Theta (Annual)", "Theta (Daily)")
    errs = dict(fis_first=rel_err(fis_gpu, fis_cpu, [k for k in fis_cpu if k not in second]),
                fis_second=rel_err(fis_gpu, fis_cpu, second), american=rel_err(am_gpu, am_cpu))
    fa_pct = {k: abs(fis_gpu[k] - v) / abs(v) * 100.0 for k, v in FIS_FRONT_ARENA.items()}
    emit("fa_american_scalar", fis=fis_gpu, fis_ms=fis_ms, american=am_gpu, american_ms=am_ms,
         cpu_s=cpu_s, card_vs_cpu=errs, limits=dict(first=1e-10, second=1e-7),
         fis_vs_fa_pct=fa_pct, graph_counts=graphs_b, **card)
    check(errs["fis_first"] <= 1e-10 and errs["american"] <= 1e-10,
          f"American scalar pricers card vs CPU {errs}")
    check(errs["fis_second"] <= 1e-7, f"FIS gamma/theta card vs CPU {errs['fis_second']:.3e}")
    check(max(fa_pct.values()) < 1.0, f"FIS trade outside FA's 1% materiality: {fa_pct}")
    wall["20b American scalar"] = time.perf_counter() - t_phase

    # 20c-d. the runners ----------------------------------------------------------
    t_phase = time.perf_counter()
    timings = {"build": [], "driver": []}
    built = []

    def timed(fn, log, keep=None):
        def wrapped(*a, **kw):
            out, ms = host_ms(lambda: fn(*a, **kw))
            timings[log].append(ms)
            if keep is not None:
                keep[:] = [out]
            return out
        return wrapped

    header_b = FA_HEADER
    header_a = ["scenario_name", "S0", "K", "sigma", "rate", "FA_price", "FA_delta", "FA_gamma",
                "FA_vega"]
    blank = lambda x: "" if x is None else x
    bar_rows = fa_stress_rows()
    golden_rows = {opt: [[r[0], FA_SPOT, r[3], r[4], FA_RATE, r[2], blank(r[6]), blank(r[5]),
                          *r[7:]] for r in FA_GOLDEN if r[1] == opt] for opt in ("call", "put")}
    rng = np.random.default_rng(7)
    am_rows = [[f"am{i}", s_, 100.0, v_, math.exp(0.06) - 1.0, "", "", "", ""]
               for i, (s_, v_) in enumerate(zip(rng.uniform(80.0, 120.0, 4096),
                                                rng.uniform(0.15, 0.4, 4096)))][:FA_AMERICAN_ROWS]
    bar_base = dict(valuation=val, maturity=mat, monitor_dates=monitors)

    def run_barrier(paths, out_csv, base, **kw):
        """Both option types' tables through ``run_all_scenarios_batched``."""
        return [row for opt in ("call", "put")
                for row in run_all_scenarios_batched(paths[opt], None, dict(base, opt_type=opt), **kw)]

    am_base = dict(valuation=val, maturity=dt.date(2026, 7, 28), opt_type="put")
    cols = ("model_price", "model_delta", "model_gamma", "model_vega")
    patched = {n: getattr(pbatch, n) for n in (
        "build_trade_batch", "price_barrier_batch", "build_american_batch", "price_american_batch")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fa_") as tmp:
        def write(name, header, rows):
            return write_csv(os.path.join(tmp, name), header, rows)

        bar_csv = {o: write(f"barrier_{o}.csv", header_b, rows) for o, rows in bar_rows.items()}
        bar_sub = {o: write(f"barrier_{o}_sub.csv", header_b, rows[:FA_SUBSET // 2])
                   for o, rows in bar_rows.items()}
        am_csv = write("american.csv", header_a, am_rows)
        am_sub = write("american_sub.csv", header_a, am_rows[:FA_SUBSET])
        golden_csv = {o: write(f"golden_{o}.csv", header_b, rows) for o, rows in golden_rows.items()}
        pbatch.build_trade_batch = timed(patched["build_trade_batch"], "build", built)
        # (``built`` keeps the last barrier batch built)
        pbatch.build_american_batch = timed(patched["build_american_batch"], "build")
        pbatch.price_barrier_batch = timed(patched["price_barrier_batch"], "driver")
        pbatch.price_american_batch = timed(patched["price_american_batch"], "driver")
        try:
            kernels.reset_launch_counts()
            fa_launches, card_batch = None, None
            for label, run, path, sub, base, kw in (
                ("barrier_pde", run_barrier, bar_csv, bar_sub, bar_base, dict(route="pde")),
                ("barrier_hybrid", run_barrier, bar_csv, bar_sub, bar_base, dict(route="hybrid")),
                ("american", run_all_american_scenarios_batched, am_csv, am_sub, am_base, {}),
            ):
                ms = []
                spectral.reset_graph_counts()
                for _ in range(FA_TABLE_CALLS):
                    timings["build"].clear()
                    timings["driver"].clear()
                    out, call_ms = host_ms(lambda: run(path, None, base, device=dev, **kw))
                    ms.append(call_ms)
                    if label == "american" and fa_launches is None:
                        fa_launches = dict(kernels.launch_counts)
                split = dict(build_ms=sum(timings["build"]), driver_ms=sum(timings["driver"]))
                graphs_c = dict(spectral.graph_counts)
                if label == "barrier_pde":
                    card_batch = built[-1]
                want = run(sub, None, base, device="cpu", **kw)
                scale = max(abs(w["model_price"]) for w in want)
                by_name = {r["scenario_name"]: r for r in out}
                sub_err = {c: max(abs(by_name[w["scenario_name"]][c] - w[c]) for w in want) / scale
                           for c in cols}
                limit = 1e-6 if label == "american" else 1e-9
                emit("fa_table", table=label, rows=len(out), call_ms=ms,
                     rows_per_s=len(out) / ms[-1] * 1e3, **split, graph_counts=graphs_c,
                     subset_vs_cpu=sub_err, limit=limit,
                     reserved_bytes=torch.cuda.memory_reserved(), **card)
                n_rows = len(am_rows) if label == "american" else sum(map(len, bar_rows.values()))
                check(len(out) == n_rows, f"{label}: {len(out)} rows")
                check(all(math.isfinite(r[c]) for r in out for c in cols), f"{label}: not finite")
                check(max(sub_err.values()) <= limit, f"{label} vs the CPU runner {sub_err} > {limit}")
        finally:
            for n, fn in patched.items():
                setattr(pbatch, n, fn)
        check(fa_launches["spike_march_american_f64"] > 0, "the American table launched no K2")
        # the barrier batch's spectral prices against the scan, on the card
        tb = card_batch[:FA_SUBSET]
        p_spec = pbatch.price_barrier_batch(tb, 501, with_greeks=False, solver="spectral", device=dev)["price"]
        p_scan = pbatch.price_barrier_batch(tb, 501, with_greeks=False, solver="scan", device=dev)["price"]
        spec_err = float((p_spec - p_scan).abs().max() / p_scan.abs().max())
        check(spec_err <= 1e-9, f"barrier table spectral vs scan {spec_err:.3e} > 1e-9")
        wall["20c runner tables"] = time.perf_counter() - t_phase

        # 20d. the per-scenario runner and the CLIs
        t_phase = time.perf_counter()
        rows20, ms20 = host_ms(lambda: [
            row for opt in ("call", "put") for row in run_all_scenarios(
                golden_csv[opt], os.path.join(tmp, f"golden_{opt}_out.csv"),
                dict(bar_base, opt_type=opt), device=dev)])
        check(len(rows20) == len(FA_GOLDEN), f"run_all_scenarios gave {len(rows20)} rows")
        diff = max(abs(r[f"model_{k}"] - golden[r["scenario_name"]][k])
                   for r in rows20 for k in ("price", "delta", "gamma", "vega"))
        check(diff == 0.0, f"run_all_scenarios vs 20a's pricers: {diff:.3e}")
        # the two CLIs at once, each a process of its own on the card
        cli = {}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
        jobs = {mod: (path, n_rows, os.path.join(tmp, f"{mod}_cli.csv")) for mod, path, n_rows in (
            ("barrier_scenarios", golden_csv["call"], len(golden_rows["call"])),
            ("american_scenarios", am_sub, FA_SUBSET))}
        t_cli = time.perf_counter()
        procs = {mod: subprocess.Popen(
            [sys.executable, "-m", f"finite_difference_tpu_torch.runners.{mod}", path, "--batched",
             "-o", out_csv], cwd=HERE, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True) for mod, (path, _, out_csv) in jobs.items()}
        try:
            errs_cli = {mod: proc.communicate(timeout=600)[1] for mod, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cli_ms = (time.perf_counter() - t_cli) * 1e3
        for mod, (path, n_rows, out_csv) in jobs.items():
            rc = procs[mod].returncode
            check(rc == 0, f"{mod} CLI exited {rc}: {errs_cli[mod][-2000:]}")
            with open(out_csv, newline="") as fh:
                got_rows = list(csv.DictReader(fh))
            check(len(got_rows) == n_rows and all(math.isfinite(float(r["model_price"]))
                                                  for r in got_rows), f"{mod} CLI's CSV")
            cli[mod] = dict(rc=rc, rows=len(got_rows))
    emit("fa_runner", table_spectral_vs_scan=spec_err, per_scenario_ms=ms20,
         per_scenario_vs_golden=diff, cli=cli, cli_ms=cli_ms, fa_launches=fa_launches, **card)
    wall["20d per-scenario runner and CLIs"] = time.perf_counter() - t_phase
    emit("fa_phase_wall_s", **wall, total=sum(wall.values()))
    return fa_launches


def iv_chain(seed: int, B: int):
    """The implied-vol chain of tests/test_implied_vol.py's ``_chain`` (copied,
    seeded): forwards U(50, 400), log-moneyness U(-3, 3), tenors U(0.02, 10),
    vols U(0.02, 1.5), rates U(0, 0.1), calls and puts; returns numpy arrays
    (f, k, t, df, is_call, sigma), unpriced."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(50, 400, B)
    k = f * np.exp(rng.uniform(-3.0, 3.0, B))
    t = rng.uniform(0.02, 10.0, B)
    sigma = rng.uniform(0.02, 1.5, B)
    r = rng.uniform(0.0, 0.1, B)
    df = np.exp(-r * t)
    is_call = rng.integers(0, 2, B).astype(bool)
    return f, k, t, df, is_call, sigma


def iv_noise(price, f, k, df, is_call, sigma_t, eps: float):
    """Per quote, the relative error in sigma that the roundings of its
    normalized premium imply (float64 numpy): eps times the magnitudes that
    meet in c(x, v) = e^{x/2} N(d+) - e^{-x/2} N(d-) (and in the intrinsic an
    ITM quote sheds), over dc/dlnv. Two correct solvers whose exp differs
    in the last bit differ by about this; and the quotes whose premium lies
    within this noise of the no-arbitrage band's edges (or below the
    solver's 1e-300 clip) may fall on either side of it. Returns (relative
    noise, at-an-edge mask)."""
    from math import sqrt, pi

    from scipy.special import ndtr

    x = np.log(f / k)
    xm = -np.abs(x)
    v = sigma_t
    c_in = price / df / np.sqrt(f * k)
    itm = np.where(is_call, x > 0, x < 0)
    wings = np.exp(0.5 * x) + np.exp(-0.5 * x)
    d1 = xm / v + 0.5 * v
    terms = np.exp(0.5 * xm) * ndtr(d1) + np.exp(-0.5 * xm) * ndtr(d1 - v)
    noise = eps * (c_in + terms + np.where(itm, wings, 0.0))
    vega = np.exp(0.5 * xm) * np.exp(-0.5 * d1 * d1) / sqrt(2 * pi)
    intr = np.abs(np.exp(0.5 * x) - np.exp(-0.5 * x))
    c_otm = c_in - np.where(itm, intr, 0.0)
    floor = np.where(itm, 8.0 * eps * intr, 0.0)
    edge = ((np.abs(c_otm - floor) <= 4 * noise) | (np.abs(np.exp(0.5 * xm) - c_otm) <= 4 * noise)
            | (c_otm < 1e-290))
    return noise / (vega * v), edge


def fa_analytics_phases(dev, card: dict) -> None:
    """Phase 21, the rest of the FA-validation layer, float64 unless stated.
    No kernel of ours runs here (checked): the closed forms, the implied-vol
    solver and the FIS march are plain PyTorch ops.

    - 21a, implied vol (``implied_vol_black76``) on a 2^20-quote chain
      (:func:`iv_chain`, seed 0) at float64 and float32: ms per call,
      quotes/s and device kernels per call (``utils.profiling.throughput``);
      test_implied_vol.py's gates at float64; 4096 quotes on the card
      against the port on the CPU (the same NaN mask off the band's edges,
      1e-12 relative or :func:`iv_noise`'s bound); the jvp through the
      solver against 1/vega (1e-6); a ``utils.profiling.trace`` of a 2^16
      call.
    - 21b, the FIS stencil pricer (``DiscreteBarrierFDMPricer2``) on
      test_pde_extensions.py's trade at the class defaults (600 x 600): one
      solve's eager, capture and replayed ms and device kernels; KO, KI and
      greeks; KO + KI = the vanilla (1e-10); card against CPU (1e-10 of
      max|value|, gamma 1e-7); the replay against the eager run (1e-12).
    - 21c, the BS and BGK runners: 80 curve-path BS rows (bench.py's
      American set, 10 calls and 10 puts, x :data:`FA_BS_SPOT_SHOCKS`), 80
      BGK rows (:data:`FA_GOLDEN` x the same shocks) and 20 MC-route rows
      (monthly monitors, the runner's 100,000 paths); ms per row and rows/s
      on the card and for :data:`FA_ANALYTIC_CPU_ROWS` rows
      (:data:`FA_MC_CPU_ROWS` MC rows) on the CPU, device kernels per row;
      the card's rows against the CPU's (price, delta, vega 1e-10 of the
      column's max; gamma 1e-7), no ``error`` row;
      beside them, ``bs93_sweep`` and ``bgk_discrete_sweep`` on the desk's
      stress shape (20 x 16 spot x 13 vol shocks = 4160 rows) from the
      runners' resolved inputs, ms and rows/s, and each sweep's price
      against the runner's on the tables' rows (1e-12 of the table's
      max|price|; BGK: the BGK-route table).
    - 21d, the two CLIs as subprocesses on the card; the cross-check engine
      (``QLDiscreteBarrierPricer``) against ``DiscreteBarrierFDMPricer`` on
      golden row co1 (5e-2) and against itself on the CPU (1e-10);
      ``diagnose_order_of_accuracy`` on the FIS stencil's price.
    """
    import csv
    import datetime as dt
    import statistics
    import tempfile

    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.analytic import (
        DiscreteBarrierBGKPricer,
        bgk_discrete_sweep,
        bs93_sweep,
        generalized_bs_price,
        implied_vol_black76,
    )
    from finite_difference_tpu_torch.models.analytic.bs_forward import (
        BjerksundStenslandForwardPricer,
    )
    from finite_difference_tpu_torch.models.pde import (
        DiscreteBarrierFDMPricer,
        DiscreteBarrierFDMPricer2,
        MarketParams,
        QLDiscreteBarrierPricer,
        diagnose_order_of_accuracy,
        spectral,
    )
    from finite_difference_tpu_torch.runners import run_all_bgk_scenarios, run_all_bs_scenarios
    from finite_difference_tpu_torch.utils import flat_curve, flat_naca_dataframe, throughput, trace
    from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates

    wall = {}
    kernels.reset_launch_counts()
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # 21a. implied vol on a chain ---------------------------------------------------
    t_phase = time.perf_counter()
    f, k, t, df, is_call, sigma = iv_chain(0, FA_IV_QUOTES)
    price = (f64(df) * generalized_bs_price(f64(f), f64(k), f64(sigma), f64(t), 0.0, 0.0,
                                            f64(is_call))).cpu().numpy()
    iv_out, chains = {}, {}
    for dtype in (torch.float64, torch.float32):
        args = chains[dtype] = [f64(a).to(dtype) if a.dtype != bool else f64(a)
                                for a in (price, f, k, t, df, is_call)]
        call = lambda: implied_vol_black76(*args)
        res = throughput(call, FA_IV_QUOTES, iters=5, warmup=1)
        prof = profile_call(call, res["seconds_per_call"] * 1e3)
        iv = call().double().cpu().numpy()
        ok = np.isfinite(iv)
        err = np.abs(iv[ok] - sigma[ok]) / sigma[ok]
        rt = (f64(df) * generalized_bs_price(f64(f), f64(k), f64(np.where(ok, iv, 0.3)), f64(t),
                                             0.0, 0.0, f64(is_call))).cpu().numpy()
        rel_p = np.abs(rt[ok] - price[ok]) / np.maximum(price[ok], 1e-300)
        iv_out[str(dtype)] = dict(
            ms_per_call=res["seconds_per_call"] * 1e3, quotes_per_s=res["items_per_sec"],
            device_kernels_per_call=prof["device_kernels"], device_ms=prof["device_ms"],
            busy_share=prof["busy_share"], finite_share=float(ok.mean()),
            sigma_rel_err_quantiles={q: float(np.quantile(err, q)) for q in (0.5, 0.9, 0.99, 1.0)},
            price_round_trip_p99=float(np.quantile(rel_p, 0.99)))
        if dtype == torch.float64:
            g = iv_out[str(dtype)]
            check(g["finite_share"] > 0.9, f"implied vol finite share {g['finite_share']}")
            check(g["sigma_rel_err_quantiles"][0.5] < 1e-14 and g["sigma_rel_err_quantiles"][0.99] < 1e-6,
                  f"implied vol sigma errors {g['sigma_rel_err_quantiles']}")
            check(g["price_round_trip_p99"] < 1e-10, f"implied vol round trip {g['price_round_trip_p99']}")
            iv64 = iv
    sub = slice(0, FA_IV_CPU_QUOTES)
    iv_cpu = implied_vol_black76(*(torch.as_tensor(np.ascontiguousarray(a[sub]))
                                   for a in (price, f, k, t, df, is_call))).numpy()
    noise, edge = iv_noise(price[sub], f[sub], k[sub], df[sub], is_call[sub],
                           iv_cpu * np.sqrt(t[sub]), np.finfo(np.float64).eps)
    on_card = iv64[sub]
    mask_diff = int(((np.isfinite(on_card) != np.isfinite(iv_cpu)) & ~edge).sum())
    both = np.isfinite(on_card) & np.isfinite(iv_cpu) & ~edge
    rel = np.abs(on_card[both] - iv_cpu[both]) / iv_cpu[both]
    over = int((rel > np.maximum(1e-12, 16.0 * noise[both])).sum())
    check(mask_diff == 0, f"implied vol card vs CPU: {mask_diff} NaN lanes differ off the band's edges")
    check(over == 0, f"implied vol card vs CPU: {over} lanes beyond max(1e-12, 16 x noise)")
    # d(sigma)/d(price) through the solver, by forward AD, against 1/vega
    s0, k0, t0, r0, sig0 = 100.0, 110.0, 1.5, 0.05, 0.3
    fwd0, df0 = s0 * math.exp(r0 * t0), math.exp(-r0 * t0)
    p0 = generalized_bs_price(f64(s0), k0, sig0, t0, r0, r0, True)
    _, dsig = torch.func.jvp(lambda p: implied_vol_black76(p, fwd0, k0, t0, df0, True),
                             (p0,), (torch.ones_like(p0),))
    d1 = (math.log(s0 / k0) + (r0 + 0.5 * sig0 ** 2) * t0) / (sig0 * math.sqrt(t0))
    vega = s0 * math.sqrt(t0) * math.exp(-0.5 * d1 * d1) / math.sqrt(2 * math.pi)
    jvp_err = abs(float(dsig) * vega - 1.0)
    check(jvp_err <= 1e-6, f"implied vol jvp vs 1/vega {jvp_err:.3e}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        small = [a[: 1 << 16] for a in chains[torch.float64]]
        with trace(os.path.join(tmp, "iv")) as logdir:
            implied_vol_black76(*small)
            torch.cuda.synchronize()
        trace_files = sum(len(files) for _, _, files in os.walk(logdir))
        trace_bytes = sum(os.path.getsize(os.path.join(d, x)) for d, _, fs in os.walk(logdir) for x in fs)
    check(trace_files > 0 and trace_bytes > 0, "utils.profiling.trace wrote nothing")
    emit("fa_implied_vol", quotes=FA_IV_QUOTES, by_dtype=iv_out, cpu_quotes=FA_IV_CPU_QUOTES,
         card_vs_cpu=dict(max_rel=float(rel.max()), lanes_over=over, nan_mask_diff=mask_diff,
                          edge_lanes=int(edge.sum())),
         jvp_vs_inverse_vega=jvp_err, trace_files=trace_files, trace_bytes=trace_bytes, **card)
    wall["21a implied vol"] = time.perf_counter() - t_phase

    # 21b. the FIS stencil pricer ---------------------------------------------------
    t_phase = time.perf_counter()
    val, mat = dt.date(2025, 7, 28), dt.date(2025, 8, 28)
    fis_mons = [val + dt.timedelta(days=7 * j) for j in range(1, 5)]

    def fis(device, **kw):
        base = dict(spot=229.74, strike=190.0, valuation_date=val, maturity_date=mat,
                    volatility=0.2879, option_type="call", barrier_type="up-and-out",
                    upper_barrier=260.0, monitoring_dates=fis_mons, flat_rate_nacc=0.0705)
        return DiscreteBarrierFDMPricer2(**{**base, **kw}, device=device)

    spectral.reset_graph_counts()
    p_ko = fis(dev)
    solve = lambda: p_ko._solve_grid_once()[1]
    v_eager, eager_ms = host_ms(solve)
    _, capture_ms = host_ms(solve)
    v_replay, replay_ms = host_ms(solve)
    prof = profile_call(solve, replay_ms)
    solve_counts = dict(spectral.graph_counts)
    replay_err = float(np.abs(v_replay - v_eager).max() / np.abs(v_eager).max())
    check(solve_counts == {"eager": 1, "captures": 1, "replays": 3},
          f"the FIS march's capture rule: {solve_counts}")
    check(replay_err <= 1e-12, f"FIS replay vs eager {replay_err:.3e} > 1e-12")

    def fis_outputs(device):
        ko, ki = fis(device), fis(device, barrier_type="up-and-in")
        van = fis(device, barrier_type="none", monitoring_dates=[])
        return {"ko": ko.price(), "ki": ki.price(), "vanilla": van.price(), **ko.greeks()}

    spectral.reset_graph_counts()
    out_gpu, fis_ms = host_ms(lambda: fis_outputs(dev))
    fis_graphs = dict(spectral.graph_counts)
    t0 = time.perf_counter()
    out_cpu = fis_outputs("cpu")
    fis_cpu_s = time.perf_counter() - t0
    parity = abs(out_gpu["ko"] + out_gpu["ki"] - out_gpu["vanilla"]) / abs(out_gpu["vanilla"])
    first = [x for x in out_cpu if x != "gamma"]
    scale = max(abs(out_cpu[x]) for x in first)
    fis_err = max(abs(out_gpu[x] - out_cpu[x]) for x in first) / scale
    gamma_err = abs(out_gpu["gamma"] - out_cpu["gamma"]) / max(abs(out_cpu["gamma"]), 1e-300)
    emit("fa_fis_stencil", N=len(p_ko.S_nodes), steps=p_ko.num_time_steps, eager_ms=eager_ms,
         capture_ms=capture_ms, replay_ms=replay_ms, replay_vs_eager=replay_err,
         device_kernels_per_solve=prof["device_kernels"], replay_device_ms=prof["device_ms"],
         replay_busy_share=prof["busy_share"], solve_graph_counts=solve_counts,
         outputs=out_gpu, outputs_ms=fis_ms, outputs_graph_counts=fis_graphs,
         cpu_s=fis_cpu_s, ko_plus_ki_vs_vanilla=parity, card_vs_cpu=fis_err,
         gamma_card_vs_cpu=gamma_err, limits=dict(parity=1e-10, first=1e-10, gamma=1e-7), **card)
    check(parity <= 1e-10, f"FIS KO + KI vs vanilla {parity:.3e}")
    check(fis_err <= 1e-10, f"FIS card vs CPU {fis_err:.3e}")
    check(gamma_err <= 1e-7, f"FIS gamma card vs CPU {gamma_err:.3e}")
    wall["21b FIS stencil"] = time.perf_counter() - t_phase

    # 21c. the BS and BGK runners, and the batched sweeps beside them --------------
    t_phase = time.perf_counter()
    am_mat = dt.date(2026, 7, 28)
    rng = np.random.default_rng(7)
    am_spots, am_sigmas = rng.uniform(80.0, 120.0, 4096)[:20], rng.uniform(0.15, 0.4, 4096)[:20]
    disc = flat_naca_dataframe(math.exp(AM_RATE) - 1.0)
    carry = flat_naca_dataframe(math.exp(AM_CARRY) - 1.0)

    def bs_trades(spot_shocks, vol_shocks=(1.0,)):
        return [dict(trade_name=f"bs{i}_s{a}_v{b}", option_type="call" if i < 10 else "put",
                     S=s_ * (1.0 + ds), K=AM_STRIKE, sigma=v_ * dv, valuation_date=val,
                     maturity_date=am_mat, discount_curve=disc, forward_curve=carry)
                for i, (s_, v_) in enumerate(zip(am_spots, am_sigmas))
                for a, ds in enumerate(spot_shocks) for b, dv in enumerate(vol_shocks)]

    golden_mons = [val + dt.timedelta(days=d) for d in FA_MONITOR_DAYS]
    fa_curve = flat_curve(FA_RATE, val)

    def bgk_trades(spot_shocks, vol_shocks=(1.0,)):
        return [dict(trade_name=f"{r[0]}_s{a}_v{b}", option_type=r[1], barrier_type=r[2],
                     S=FA_SPOT * (1.0 + ds), K=r[3], sigma=r[4] * dv, lower_barrier=r[5],
                     upper_barrier=r[6], valuation_date=val, maturity_date=mat,
                     monitor_dates=golden_mons, discount_curve=fa_curve)
                for r in FA_GOLDEN for a, ds in enumerate(spot_shocks) for b, dv in enumerate(vol_shocks)]

    monthly = build_monitoring_dates(val, am_mat, "monthly")
    mc_trades = [dict(trade_name=f"mc{i}", option_type="call", barrier_type="up-and-out",
                      S=float(s_), K=AM_STRIKE, sigma=float(v_), upper_barrier=FA_MC_BARRIER,
                      valuation_date=val, maturity_date=am_mat, monitor_dates=monthly,
                      discount_curve=disc, forward_curve=carry)
                 for i, (s_, v_) in enumerate(zip(am_spots, am_sigmas))]
    tables = {"bs": (run_all_bs_scenarios, bs_trades(FA_BS_SPOT_SHOCKS)),
              "bgk": (run_all_bgk_scenarios, bgk_trades(FA_BS_SPOT_SHOCKS)),
              "bgk_mc": (run_all_bgk_scenarios, mc_trades)}
    cols = ("model_price", "model_delta", "model_gamma", "model_vega")
    runner_rows, table_out = {}, {}
    for label, (run, trades) in tables.items():
        run(trades[:2], device=dev)  # warm-up
        rows, ms = host_ms(lambda: run(trades, device=dev))
        n_cpu = FA_MC_CPU_ROWS if label == "bgk_mc" else FA_ANALYTIC_CPU_ROWS
        rows_cpu, cpu_ms = host_ms(lambda: run(trades[:n_cpu], device="cpu"))
        prof = profile_call(lambda: run(trades[:4], device=dev), ms * 4 / len(trades))
        errs = [r.get("error") for r in rows + rows_cpu if "error" in r]
        check(not errs, f"{label} runner error rows: {errs[:3]}")
        check(all(math.isfinite(r[c]) for r in rows for c in cols), f"{label}: not finite")
        diff = {}
        for c in cols:
            want = np.array([r[c] for r in rows_cpu])
            got = np.array([r[c] for r in rows[:n_cpu]])
            diff[c] = float(np.abs(got - want).max() / np.abs(want).max())
        limits_c = {c: 1e-7 if c == "model_gamma" else 1e-10 for c in cols}
        table_out[label] = dict(rows=len(rows), ms=ms, ms_per_row=ms / len(rows),
                                rows_per_s=len(rows) / ms * 1e3, cpu_rows=n_cpu, cpu_ms=cpu_ms,
                                cpu_ms_per_row=cpu_ms / n_cpu, cpu_rows_per_s=n_cpu / cpu_ms * 1e3,
                                device_kernels_per_row=prof["device_kernels"] / 4,
                                card_vs_cpu=diff, limits=limits_c,
                                methods=sorted({r.get("pricing_method", "") for r in rows}))
        for c in cols:
            check(diff[c] <= limits_c[c], f"{label} card vs CPU {c}: {diff[c]:.3e} > {limits_c[c]}")
        runner_rows[label] = rows
    check(table_out["bgk"]["methods"] == ["BGK"] and table_out["bgk_mc"]["methods"] == ["MC"],
          f"BGK routes {table_out['bgk']['methods']}, {table_out['bgk_mc']['methods']}")

    # the batched sweeps on the stress shape, from the runners' resolved inputs
    bs_pr = BjerksundStenslandForwardPricer(device=dev)

    # a BS row's resolution (bs_forward's curve API): the same rates, tenors
    # and carry growth for every trade of the set, F = S * growth
    res = bs_pr._resolve_curve_inputs(1.0, val, am_mat, disc, carry, None, 0, 0, 0, "ACT/365")
    growth = math.exp(res["carry_rate"] * res["T_carry"])
    r_eff = res["disc_rate"] * res["T_disc"] / max(res["T_exp"], 1e-12)

    def bs_inputs(trades):
        s_ = np.array([tr["S"] for tr in trades])
        return dict(s=s_, f=s_ * growth, t=res["T_exp"], r=r_eff,
                    sigma=np.array([tr["sigma"] for tr in trades]),
                    is_call=np.array([tr["option_type"] == "call" for tr in trades]))

    def bgk_inputs(trades):
        keys = ("s_eff", "strike", "forward", "mu", "sigma", "t", "df", "m", "lower", "upper",
                "is_call", "is_in", "spot")
        cols_ = {x: [] for x in keys}
        for tr in trades:
            p = DiscreteBarrierBGKPricer(
                spot=tr["S"], strike=tr["K"], valuation_date=val, maturity_date=mat,
                option_type=tr["option_type"], barrier_type=tr["barrier_type"],
                lower_barrier=tr["lower_barrier"], upper_barrier=tr["upper_barrier"],
                monitor_dates=golden_mons, discount_curve=fa_curve, volatility=tr["sigma"],
                device=dev)
            for x, v in (("s_eff", p.spot_price_eff), ("strike", p.strike_price),
                         ("forward", p.forward_price), ("mu", p._mu()), ("sigma", p.sigma),
                         ("t", p.tenor_years), ("df", math.exp(-p.discount_rate * p.discount_years)),
                         ("m", p.m), ("lower", p.lower_barrier), ("upper", p.upper_barrier),
                         ("is_call", p.option_type == "call"), ("is_in", "in" in p.barrier_type),
                         ("spot", p.spot_price)):
                cols_[x].append(v)
        return {x: (v if x in ("lower", "upper") else np.asarray(v)) for x, v in cols_.items()}

    sweeps = {"bs93_sweep": (lambda a: bs93_sweep(a["s"], a["f"], AM_STRIKE, a["t"], a["r"],
                                                  a["sigma"], a["is_call"], device=dev),
                             bs_inputs, bs_trades, "bs"),
              "bgk_discrete_sweep": (lambda a: bgk_discrete_sweep(**a, device=dev), bgk_inputs,
                                     bgk_trades, "bgk")}
    sweep_out = {}
    for name, (sweep, inputs, make, label) in sweeps.items():
        big = inputs(make(FA_SPOT_SHOCKS, FA_VOL_SHOCKS))
        sweep(big)
        out, ms = host_ms(lambda: sweep(big))
        ms_runs = [host_ms(lambda: sweep(big))[1] for _ in range(4)]
        check(out.shape == (len(big["sigma"]),) and bool(torch.isfinite(out).all()), f"{name} output")
        table = inputs(make(FA_BS_SPOT_SHOCKS))
        got = sweep(table).cpu().numpy()
        want = np.array([r["model_price"] for r in runner_rows[label]])
        sweep_err = float(np.max(np.abs(got - want)) / np.abs(want).max())
        sweep_out[name] = dict(rows=len(big["sigma"]), ms=[ms] + ms_runs,
                               rows_per_s=len(big["sigma"]) / statistics.median([ms] + ms_runs) * 1e3,
                               vs_runner_rows=len(want), vs_runner_max_rel=sweep_err, limit=1e-12,
                               runner_rows_per_s=table_out[label]["rows_per_s"])
        check(sweep_err <= 1e-12, f"{name} vs the {label} runner's prices {sweep_err:.3e} > 1e-12")
    emit("fa_analytic_tables", tables=table_out, sweeps=sweep_out, **card)
    wall["21c runners and sweeps"] = time.perf_counter() - t_phase

    # 21d. the CLIs, the cross-check and the order tools ----------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fa_analytics_") as tmp:
        bgk_cfg = os.path.join(tmp, "bgk.csv")
        with open(bgk_cfg, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["trade_name", "option_type", "barrier_type", "S", "K", "sigma", "rate",
                        "valuation", "maturity", "monitor_frequency", "upper_barrier",
                        "lower_barrier", "rebate_amount", "pricing_method", "mc_n_paths"])
            w.writerow(["D1", "call", "up-and-out", 100.0, 95.0, 0.3, 0.085, "2025-07-28",
                        "2026-07-28", "daily", 130.0, "", 1.5, "", ""])
            w.writerow(["M1", "put", "down-and-in", 100.0, 105.0, 0.28, 0.085, "2025-07-28",
                        "2026-01-28", "weekly", "", 85.0, "", "mc", 20000])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
        jobs = {"bs_scenarios": ([], 4), "bgk_scenarios": ([bgk_cfg], 2)}
        outs = {mod: os.path.join(tmp, f"{mod}_out.csv") for mod in jobs}
        t_cli = time.perf_counter()
        procs = {mod: subprocess.Popen(
            [sys.executable, "-m", f"finite_difference_tpu_torch.runners.{mod}", *a, "-o", outs[mod]],
            cwd=HERE, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for mod, (a, _) in jobs.items()}
        try:
            errs_cli = {mod: proc.communicate(timeout=600)[1] for mod, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cli_ms = (time.perf_counter() - t_cli) * 1e3
        cli = {}
        for mod, (_, n_rows) in jobs.items():
            rc = procs[mod].returncode
            check(rc == 0, f"{mod} CLI exited {rc}: {errs_cli[mod][-2000:]}")
            with open(outs[mod], newline="") as fh:
                got_rows = list(csv.DictReader(fh))
            check(len(got_rows) == n_rows and all(not r.get("error") and math.isfinite(float(r["model_price"]))
                                                  for r in got_rows), f"{mod} CLI's CSV")
            cli[mod] = dict(rc=rc, rows=len(got_rows))

    co1 = FA_GOLDEN[0]

    def crosscheck(device):
        return QLDiscreteBarrierPricer(
            MarketParams(spot=FA_SPOT, strike=co1[3], sigma=co1[4], rate_nacc=math.log1p(FA_RATE)),
            is_call=True, barrier_type=co1[2], monitoring_dates=golden_mons, maturity_date=mat,
            barrier=co1[6], valuation_date=val, grid_points=400, min_time_steps=400,
            device=device).price_and_greeks()

    xc_gpu, xc_ms = host_ms(lambda: crosscheck(dev))
    xc_cpu = crosscheck("cpu")
    prod = DiscreteBarrierFDMPricer(
        spot=FA_SPOT, strike=co1[3], valuation_date=val, maturity_date=mat, sigma=co1[4],
        option_type="call", barrier_type=co1[2], upper_barrier=co1[6], monitor_dates=golden_mons,
        discount_curve=fa_curve, forward_curve=fa_curve, underlying_spot_days=0, option_days=0,
        option_settlement_days=0, num_space_nodes=500, num_time_steps=500, device=dev).price_log2()
    xc_vs_prod = abs(xc_gpu["price"] - prod) / abs(prod)
    xc_card_cpu = abs(xc_gpu["price"] - xc_cpu["price"]) / abs(xc_cpu["price"])
    check(xc_vs_prod <= 5e-2, f"cross-check vs the production pricer {xc_vs_prod:.3e} > 5e-2")
    check(xc_card_cpu <= 1e-10, f"cross-check card vs CPU {xc_card_cpu:.3e} > 1e-10")
    p_ref = fis(dev).price()
    order, order_ms = host_ms(lambda: diagnose_order_of_accuracy(
        lambda n: fis(dev, num_time_steps=n).price(), observed_difference=p_ref - prod,
        n_ladder=FA_ORDER_LADDER, t_expiry=p_ko.tenor_years))
    launches = dict(kernels.launch_counts)
    check(not any(launches.values()), f"phase 21 launched a kernel of ours: {launches}")
    emit("fa_analytic_tools", cli=cli, cli_ms=cli_ms, crosscheck=xc_gpu, crosscheck_ms=xc_ms,
         production_price=prod, crosscheck_vs_production=xc_vs_prod, crosscheck_card_vs_cpu=xc_card_cpu,
         order_of_accuracy={x: order[x] for x in ("n_ladder", "prices", "order", "reference_price",
                                                  "predicted_truncation_error", "observed_difference",
                                                  "verdict")},
         order_ms=order_ms, **card)
    wall["21d CLIs, cross-check, order"] = time.perf_counter() - t_phase
    emit("fa_analytics_phase_wall_s", **wall, total=sum(wall.values()))


def mc_call(fn) -> dict:
    """A Monte Carlo call's figures: its first and warm ms (host clock, each
    ending in a synchronisation), its peak device memory, and device ms,
    kernels and busy share per call from ``profile_call`` over a window of
    repeated warm calls of at least :data:`MC_PROFILE_WINDOW_MS` (a window
    of one 2 ms call showed the profiler no device time)."""
    import torch

    _, first_ms = host_ms(fn)
    torch.cuda.reset_peak_memory_stats()
    out, warm_ms = host_ms(fn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reps = max(1, math.ceil(MC_PROFILE_WINDOW_MS / warm_ms))

    def window():
        for _ in range(reps):
            fn()

    prof = profile_call(window, warm_ms * reps)
    return out, dict(first_ms=first_ms, warm_ms=warm_ms, profiled_calls=reps,
                     device_ms=prof["device_ms"] / reps, busy_share=prof["busy_share"],
                     device_kernels=prof["device_kernels"] / reps, peak_memory_gb=peak_gb,
                     top=prof["top"][:4])


def threefry_timing(dev, shape) -> dict:
    """One threefry float64 draw of ``shape``: ms (CUDA events), its output
    bytes' rate against ``PEAK_BYTES`` (the least the draw must move: each
    normal written once, the counters made in place), and the bound."""
    import torch

    from finite_difference_tpu_torch.models.mc.rng import prng_key, threefry_normals

    key = prng_key(42)
    ms = cuda_ms(lambda: threefry_normals(key, shape, torch.float64, device=dev), reps=5)
    out_bytes = math.prod(shape) * 8
    return dict(shape=list(shape), ms=ms, gb_per_s=out_bytes / ms / 1e6,
                bound_ms=out_bytes / PEAK_BYTES * 1e3, bound_share=out_bytes / PEAK_BYTES * 1e3 / ms)


def mc_phases(dev, card: dict) -> None:
    """Phase 22, the Monte Carlo layer (``models.mc``), float64. No kernel
    of ours runs here (checked): threefry, the path loops and the
    regressions are plain PyTorch ops.

    - 22a, ``price_discrete_barrier_mc`` at ``MCConfig``'s defaults on
      test_mc.py's trade and on the one-year trade of :data:`MC_YEAR`
      (cash dividends on 2025-11-14 and 2026-05-15): each vanilla within 4
      stderr of ``generalized_bs_price``; KO + KI (no rebate) = the vanilla
      on the same draws (1e-10 relative); the KO within 4 stderr + 1e-3
      relative of the port's CN scalar pricer (``DiscreteBarrierFDMPricer``,
      500 steps) on the same dates. The CN pricer models cash dividends as
      an escrowed flat yield and the MC drops them on their dates, so the
      dividend-free twin of the one-year trade takes the closed-form and CN
      checks, and the dividend trade the parity check and the timing. On
      :data:`MC_CPU_PATHS` paths of the dividend trade: the threefry bits on
      the card equal the CPU's exactly and the price is within 1e-12.
    - 22b, ``price_american_lsm`` at its defaults: test_lsm.py's q=0 call
      within 4 stderr of Black–Scholes; its put within max(4 stderr, 5e-3
      cn) of the port's ``price_american_batch`` (``solver="scan"``, the
      route JAX's CPU test takes; no kernel of ours); the card against the
      CPU on :data:`MC_CPU_PATHS` paths (1e-10).
    - 22c, ``HW1FCurveSimulator`` at :data:`MC_HW1F_PATHS` x
      :data:`MC_HW1F_DATES` monthly dates x :data:`MC_HW1F_TENORS`: the
      state's mean against ``moments`` (1e-13 absolute, antithetic) and its
      variance (5%); test_hw1f.py's discounted-bond martingale (weekly, a
      year, 100,000 paths, 5e-4); the card against the CPU on
      :data:`MC_HW1F_CPU_PATHS` paths (1e-12 of max|z|); the scenario cube.
    - 22d, GBM at :data:`MC_GBM_SIMS` x :data:`MC_GBM_STEPS` and
      Clewlow–Strickland at :data:`MC_CS_SIMS` x :data:`MC_CS_STEPS` x
      :data:`MC_CS_TENORS`, with test_mc.py's checks (GBM mean 5e-3 and
      log-std 1e-2 relative, the shocks' moments; CS risk-neutral means
      within 4 standard errors, variance frozen after delivery 1e-9).

    Each timed call gives its first and warm ms, device kernels, busy
    share and peak memory (:func:`mc_call`); each threefry draw its ms and
    rate against the card's memory bandwidth (:func:`threefry_timing`).
    """
    import datetime as dt

    import torch

    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.analytic import bs_price, generalized_bs_price
    from finite_difference_tpu_torch.models.mc import (
        CSForwardCurveSimulator,
        CSParams,
        GBMParams,
        GBMSimulator,
        HW1FCurveSimulator,
        HW1FParams,
        MCConfig,
        price_american_lsm,
        price_discrete_barrier_mc,
    )
    from finite_difference_tpu_torch.models.mc.discrete_barrier import BarrierSpec, build_event_grid
    from finite_difference_tpu_torch.models.mc.rng import prng_key, threefry_bits, threefry_normals
    from finite_difference_tpu_torch.models.pde import DiscreteBarrierFDMPricer
    from finite_difference_tpu_torch.models.pde.batch import build_trade_batch, price_american_batch
    from finite_difference_tpu_torch.utils.calendars import build_monitoring_dates
    from finite_difference_tpu_torch.utils.curves import flat_curve, flat_naca_dataframe

    wall = {}
    kernels.reset_launch_counts()
    f64 = lambda x: torch.tensor(x, dtype=torch.float64, device=dev)

    # 22a. the discrete-barrier MC ------------------------------------------------
    t_phase = time.perf_counter()
    month = dict(spot=FA_SPOT, strike=190.0, vol=0.2879, level=260.0, naca=FA_RATE,
                 val=dt.date(2025, 7, 28), mat=dt.date(2025, 8, 28), dividends=())
    year = dict(MC_YEAR, val=dt.date(2025, 7, 28), mat=dt.date(2026, 7, 28), dividends=())
    year_div = dict(year, dividends=((dt.date(2025, 11, 14), MC_YEAR["cash"]),
                                     (dt.date(2026, 5, 15), MC_YEAR["cash"])))

    def mc(case, barrier_type, device=dev, cfg=MCConfig()):
        return price_discrete_barrier_mc(
            spot=case["spot"], strike=case["strike"], vol=case["vol"], option_type="call",
            valuation=case["val"], maturity=case["mat"],
            discount_curve=flat_curve(case["naca"], case["val"]),
            dividends=case["dividends"], monitor_dates=build_monitoring_dates(case["val"], case["mat"]),
            barrier=BarrierSpec(barrier_type, case["level"]), cfg=cfg, device=device)

    barrier_out = {}
    for label, case in (("month", month), ("year", year), ("year_dividends", year_div)):
        ko, call = mc_call(lambda: mc(case, "up-and-out"))
        ki, van = mc(case, "up-and-in"), mc(case, "none")
        parity = abs(ko["price"] + ki["price"] - van["price"]) / van["price"]
        check(parity <= 1e-10, f"MC {label}: KO + KI vs vanilla {parity:.3e} > 1e-10")
        row = dict(steps=ko["steps"], n_obs=ko["n_obs"], ko=ko["price"], ko_stderr=ko["stderr"],
                   ki=ki["price"], vanilla=van["price"], vanilla_stderr=van["stderr"],
                   ko_plus_ki_vs_vanilla=parity, ko_call=call)
        if not case["dividends"]:
            curve = flat_curve(case["naca"], case["val"])
            t = curve.year_fraction(case["val"], case["mat"])
            r = curve.get_forward_nacc_rate(case["val"], case["mat"])
            bs = float(generalized_bs_price(f64(case["spot"]), case["strike"], case["vol"], t, r, r, True))
            mons = build_monitoring_dates(case["val"], case["mat"])
            cn, cn_ms = host_ms(lambda: DiscreteBarrierFDMPricer(
                spot=case["spot"], strike=case["strike"], valuation_date=case["val"],
                maturity_date=case["mat"], sigma=case["vol"], option_type="call",
                barrier_type="up-and-out", upper_barrier=case["level"], monitor_dates=mons,
                discount_curve=flat_naca_dataframe(case["naca"], case["val"], case["mat"]),
                underlying_spot_days=0, num_time_steps=500, device=dev).price_log2())
            row.update(black_scholes=bs, vanilla_vs_bs_in_stderr=(van["price"] - bs) / van["stderr"],
                       cn_ko=cn, cn_ms=cn_ms, ko_vs_cn_in_stderr=(ko["price"] - cn) / ko["stderr"])
            check(abs(van["price"] - bs) <= 4 * van["stderr"],
                  f"MC {label}: vanilla {van['price']} vs Black–Scholes {bs}")
            check(abs(ko["price"] - cn) <= 4 * ko["stderr"] + 1e-3 * abs(cn),
                  f"MC {label}: KO {ko['price']} vs CN {cn}")
        barrier_out[label] = row
    # the card against the CPU on the dividend trade
    small = MCConfig(n_paths=MC_CPU_PATHS)
    on_card, on_cpu = mc(year_div, "up-and-out", cfg=small), mc(year_div, "up-and-out", "cpu", small)
    card_vs_cpu = abs(on_card["price"] - on_cpu["price"]) / abs(on_cpu["price"])
    shape = (MC_CPU_PATHS // 2, on_card["steps"])
    bits_equal = bool(torch.equal(threefry_bits(prng_key(42), shape, device=dev).cpu(),
                                  threefry_bits(prng_key(42), shape, device="cpu")))
    check(bits_equal, f"threefry bits on the card differ from the CPU's at {shape}")
    check(card_vs_cpu <= 1e-12, f"MC year_dividends card vs CPU {card_vs_cpu:.3e} > 1e-12")
    grid = build_event_grid(year_div["val"], year_div["mat"], year_div["dividends"],
                            build_monitoring_dates(year_div["val"], year_div["mat"]))[0]
    draw = (MCConfig().n_paths // 2, len(grid) - 1)
    emit("mc_barrier", cases=barrier_out, paths=MCConfig().n_paths, antithetic=True, seed=42,
         shocks_gb=math.prod(draw) * 8 / 1e9, card_vs_cpu=dict(paths=MC_CPU_PATHS, price_rel=card_vs_cpu,
                                                                bits_equal=bits_equal),
         threefry=threefry_timing(dev, draw), **card)
    wall["22a discrete-barrier MC"] = time.perf_counter() - t_phase

    # 22b. Longstaff–Schwartz --------------------------------------------------------
    t_phase = time.perf_counter()
    (call_p, call_se), call_fig = mc_call(lambda: price_american_lsm(
        100.0, 100.0, 0.25, 1.0, 0.05, 0.0, True, seed=1, device=dev))
    euro = float(bs_price(f64(100.0), 100.0, 0.25, 1.0, 0.05, 0.0, True))
    check(abs(call_p - euro) <= 4 * call_se, f"LSM call {call_p} vs Black–Scholes {euro}")
    (put_p, put_se), put_fig = mc_call(lambda: price_american_lsm(
        100.0, 100.0, 0.25, 1.0, 0.05, 0.0, False, seed=2, device=dev))
    tb = build_trade_batch(spots=[100.0], strikes=[100.0], sigmas=[0.25], t_expiry=[1.0], r=[0.05],
                           b=[0.05], is_call=[False], n_time_steps=800, monitor_times=[[]],
                           num_space_nodes=799, device=dev)
    cn_put, cn_ms = host_ms(lambda: float(price_american_batch(
        tb, n_nodes=800, with_greeks=False, solver="scan", device=dev)["price"][0]))
    check(abs(put_p - cn_put) < max(4 * put_se, 5e-3 * cn_put), f"LSM put {put_p} vs CN {cn_put}")
    lsm_small = dict(n_paths=MC_CPU_PATHS, seed=2)
    lsm_card = price_american_lsm(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, False, **lsm_small, device=dev)
    lsm_cpu = price_american_lsm(100.0, 100.0, 0.25, 1.0, 0.05, 0.0, False, **lsm_small, device="cpu")
    lsm_card_cpu = max(abs(a - b) / abs(b) for a, b in zip(lsm_card, lsm_cpu))
    check(lsm_card_cpu <= 1e-10, f"LSM card vs CPU {lsm_card_cpu:.3e} > 1e-10")
    emit("mc_lsm", paths=200_000, steps=50, degree=3, call=call_p, call_stderr=call_se,
         black_scholes=euro, call_vs_bs_in_stderr=(call_p - euro) / call_se, put=put_p,
         put_stderr=put_se, cn_put=cn_put, cn_ms=cn_ms, put_vs_cn=(put_p - cn_put) / cn_put,
         call_timing=call_fig, put_timing=put_fig, card_vs_cpu=dict(paths=MC_CPU_PATHS, rel=lsm_card_cpu),
         threefry=threefry_timing(dev, (50, 100_000)), **card)
    wall["22b LSM"] = time.perf_counter() - t_phase

    # 22c. HW1F ------------------------------------------------------------------------
    t_phase = time.perf_counter()
    tenors0 = np.array([0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0])  # test_hw1f.py's curve
    rates0 = np.array([0.070, 0.071, 0.072, 0.074, 0.077, 0.079, 0.080])
    sim = lambda device: HW1FCurveSimulator(HW1FParams.flat(0.1, 0.012), tenors0, rates0, device=device)
    t_grid = np.arange(1, MC_HW1F_DATES + 1) / 12.0
    taus = np.array(MC_HW1F_TENORS)
    cube, cube_fig = mc_call(lambda: sim(dev).simulate(t_grid, taus, MC_HW1F_PATHS, seed=7, as_jax=True))
    check(tuple(cube.shape) == (MC_HW1F_DATES, MC_HW1F_PATHS, taus.size)
          and bool(torch.isfinite(cube).all()), "HW1F cube shape or values")
    xs = sim(dev).simulate_state(t_grid, MC_HW1F_PATHS, seed=7)
    m_cl, y_cl = sim(dev).moments(t_grid)
    mean_err = float(np.abs(xs.mean(axis=1) - m_cl).max())
    var_err = float(np.abs(xs.var(axis=1) / y_cl - 1.0).max())
    check(mean_err <= 1e-13, f"HW1F state mean vs moments {mean_err:.3e} > 1e-13")
    check(var_err <= 0.05, f"HW1F state variance vs moments {var_err:.3e} > 5%")
    # test_hw1f.py's martingale check: a weekly year, 100,000 paths
    weekly, tau_T, n_mart, eps = np.linspace(1 / 52, 1.0, 52), 5.0, 100_000, 1e-4
    out = sim(dev).simulate(weekly, [tau_T], n_paths=n_mart, seed=7)
    r_path = sim(dev).simulate(weekly, [eps], n_paths=n_mart, seed=7)[:, :, 0]
    dts = np.diff(np.concatenate([[0.0], weekly]))
    r_prev = np.vstack([np.full((1, n_mart), np.interp(eps, tenors0, rates0)), r_path[:-1]])
    integ = np.cumsum(0.5 * (r_path + r_prev) * dts[:, None], axis=0)
    lhs = float((np.exp(-integ[-1]) * np.exp(-out[-1, :, 0] * tau_T)).mean())
    T = weekly[-1] + tau_T
    mart = abs(lhs / math.exp(-np.interp(T, tenors0, rates0) * T) - 1.0)
    check(mart < 5e-4, f"HW1F discounted bond martingale {mart:.3e} >= 5e-4")
    hw_card = sim(dev).simulate(t_grid, taus, MC_HW1F_CPU_PATHS, seed=7)
    hw_cpu = sim("cpu").simulate(t_grid, taus, MC_HW1F_CPU_PATHS, seed=7)
    hw_card_cpu = float(np.abs(hw_card - hw_cpu).max() / np.abs(hw_cpu).max())
    check(hw_card_cpu <= 1e-12, f"HW1F card vs CPU {hw_card_cpu:.3e} > 1e-12")
    sc, sc_ms = host_ms(lambda: sim(dev).to_scenario_cube(
        dt.date(2025, 7, 28), [30 * i for i in range(1, 25)], tenors0, 256, seed=11))
    check(sc.n_times == 25 and sc.n_paths == 256, "HW1F scenario cube shape")
    emit("mc_hw1f", paths=MC_HW1F_PATHS, dates=MC_HW1F_DATES, tenors=int(taus.size),
         cube_gb=cube.numel() * 8 / 1e9, cube_timing=cube_fig, state_mean_err=mean_err,
         state_var_rel_err=var_err, martingale_rel_err=mart,
         card_vs_cpu=dict(paths=MC_HW1F_CPU_PATHS, rel=hw_card_cpu), scenario_cube_ms=sc_ms,
         threefry=threefry_timing(dev, (MC_HW1F_DATES, MC_HW1F_PATHS // 2)), **card)
    del cube
    wall["22c HW1F"] = time.perf_counter() - t_phase

    # 22d. GBM and Clewlow–Strickland ---------------------------------------------------
    t_phase = time.perf_counter()
    gbm = GBMSimulator(GBMParams(mu=0.05, sigma=0.2), days_in_year=365.0, device=dev)
    days = np.round(np.linspace(0.0, 365.0, MC_GBM_STEPS))
    z = threefry_normals(prng_key(0), (MC_GBM_STEPS, MC_GBM_SIMS), device=dev)
    paths, gbm_fig = mc_call(lambda: gbm.simulate(100.0, days, z))
    t_end = days[-1] / 365.0
    last = paths[-1]
    gbm_mean = abs(float(last.mean()) / (100.0 * math.exp(0.05 * t_end)) - 1.0)
    gbm_std = abs(float(torch.log(last).std(correction=0)) / (0.2 * math.sqrt(t_end)) - 1.0)
    zd = GBMSimulator.sanity_check_z(z)
    check(gbm_mean < 5e-3 and gbm_std < 1e-2, f"GBM mean {gbm_mean:.3e}, log-std {gbm_std:.3e}")
    check(abs(zd["mean"]) < 0.01 and abs(zd["std"] - 1) < 0.01 and abs(zd["kurtosis"] - 3.0) < 0.1,
          f"GBM shocks' moments {zd}")
    del paths, z, last
    cs = CSForwardCurveSimulator(CSParams(alpha=1.2, sigma=0.35, mu=0.08), 365.25, device=dev)
    scen = 3.0 * np.arange(MC_CS_STEPS)
    tenor_days = 30.0 * np.arange(1, MC_CS_TENORS + 1)
    f0 = 50.0 + 0.5 * np.arange(MC_CS_TENORS)
    zc = threefry_normals(prng_key(1), (MC_CS_STEPS, MC_CS_SIMS), device=dev)
    fwd, cs_fig = mc_call(lambda: cs.simulate(f0, tenor_days, scen, zc, risk_neutral=True))
    end = fwd[-1]
    cs_z = ((end.mean(dim=1).cpu().numpy() - f0)
            / (end.std(dim=1).cpu().numpy() / math.sqrt(MC_CS_SIMS)))
    log_var = torch.log(fwd[:, 0, :]).var(dim=1).cpu().numpy()
    delivered = int(np.searchsorted(scen, tenor_days[0]))  # the first tenor's delivery step
    frozen = float(np.abs(log_var[delivered:] / log_var[delivered] - 1.0).max())
    check(float(np.abs(cs_z).max()) <= 4.0, f"CS risk-neutral means off by {cs_z} standard errors")
    check(frozen <= 1e-9, f"CS variance after delivery moved {frozen:.3e}")
    emit("mc_gbm_cs", gbm=dict(sims=MC_GBM_SIMS, steps=MC_GBM_STEPS, mean_rel_err=gbm_mean,
                               log_std_rel_err=gbm_std, shocks=zd, timing=gbm_fig),
         cs=dict(sims=MC_CS_SIMS, steps=MC_CS_STEPS, tenors=MC_CS_TENORS,
                 max_mean_err_in_stderr=float(np.abs(cs_z).max()), variance_after_delivery=frozen,
                 cube_gb=fwd.numel() * 8 / 1e9, timing=cs_fig),
         threefry=threefry_timing(dev, (MC_GBM_STEPS, MC_GBM_SIMS)), **card)
    del fwd, zc, end
    launches = dict(kernels.launch_counts)
    check(not any(launches.values()), f"phase 22 launched a kernel of ours: {launches}")
    wall["22d GBM and CS"] = time.perf_counter() - t_phase
    emit("mc_phase_wall_s", **wall, total=sum(wall.values()))


def xva_swaps(instruments, n: int, notional: float = 1_000_000.0):
    """examples/device_cva_pipeline.py's netting set: five-year quarterly
    float-vs-fixed swaps on one curve, fixed 7.0% + 0.2% k."""
    import datetime as dt

    return [
        instruments.IRSwap(
            name=f"irs{k}", effective_date=dt.date(2025, 7, 28),
            maturity_date=dt.date(2030, 7, 28), notional=notional,
            receive_leg=instruments.SwapLeg(instruments.LegType.FLOATING, frequency=3,
                                            curve_name="ZAR-SWAP"),
            pay_leg=instruments.SwapLeg(instruments.LegType.FIXED, frequency=3,
                                        fixed_rate=0.07 + 0.002 * k),
            discount_curve_name="ZAR-SWAP",
        )
        for k in range(n)
    ]


def xva_phases(dev, card: dict) -> dict:
    """Phase 23, the XVA exposure path (``instruments``, ``portfolio``,
    ``xva``), float64 unless stated. Returns the launch counts of the
    path's own calls (23a's pipeline, 23b's engines and surface builds),
    each read with the counts zeroed just before it: kernels of ours run
    there only where ``auto`` routes the barrier surfaces to the SPIKE
    march. The forced SPIKE check of 23b is counted apart
    (``k2_forced_launches``).

    - 23a, ``hw1f_cva_pipeline`` in examples/device_cva_pipeline.py's
      shape: HW1F flat (alpha 0.05, sigma 0.01) on a flat 7.5% curve,
      :data:`XVA_PATHS` paths x 63 dates x :data:`XVA_TENORS`, the ten
      swaps of :func:`xva_swaps`, hazard 2%, recovery 40%, flat discount
      7.5%. Checks: the card against the CPU on :data:`XVA_CPU_PATHS` paths
      at the same seed (MTM within 1e-10 of max|MTM|, CVA 1e-10 relative);
      the device MTM against the port's generic ``ExposureEngine`` on the
      same host cube (rtol 1e-9, atol 1e-5, as in TestHW1FPipeline);
      CVA > 0, PFE >= 0, peak PFE >= peak EE. One float32 call of the same
      cube: finite, EE within 1e-3 relative of float64 at the EE peak.
    - 23b, examples/exotic_xva.py's netting set (an up-and-out call at its
      defaults, 512 nodes, 256 steps, 11 monthly monitors; an American put;
      a swap) on :data:`XVA_EXOTIC_PATHS` x 28 fortnightly dates x
      :data:`XVA_EXOTIC_TENORS`: the generic engine against
      ``DeviceExposureEngine.mtm`` (rtol 1e-10, atol 1e-8, as in
      TestDeviceSurfaceExotics); the KO surfaces of ``auto`` against the
      same batch through ``solver="spike"`` (K2, 1e-9 of max|V|, K2 launches
      > 0); the surfaces on the card against the CPU (1e-10 of max|V|).
    - 23c, the CSA on 23a's cube at :data:`XVA_CPU_PATHS` paths: VM
      thresholds with a 10-day MPOR, FIXED and SCHEDULE IM, FORWARD
      close-out with a risky curve by name and by currency (half the
      swaps in USD, converted by an FX factor): the device engine's MTM,
      collateral and exposure against the generic engine's, within 1e-10
      of the largest |value| (JAX's tests hold one swap without FX at rtol
      1e-10 with an atol of 1e-8; here ten swaps and an FX rate near 18
      put the engines' last-bit MTM differences above that atol).
    """
    import datetime as dt

    import torch

    from finite_difference_tpu_torch import instruments, kernels
    from finite_difference_tpu_torch.market_data import ScenarioCube
    from finite_difference_tpu_torch.models.mc import HW1FCurveSimulator, HW1FParams
    from finite_difference_tpu_torch.models.pde import batch as pbatch
    from finite_difference_tpu_torch.portfolio import (
        CSA, CloseOutMethod, InitialMarginMethod, NettingSet, Trade)
    from finite_difference_tpu_torch.xva import (
        DeviceExposureEngine, ExposureEngine, hw1f_cva_pipeline)
    from finite_difference_tpu_torch.xva import device_exposure
    from finite_difference_tpu_torch.xva.cva import exposure_profile

    wall = {}
    val = dt.date(2025, 7, 28)
    tenors = np.asarray(XVA_TENORS)
    scen_days = list(XVA_SCEN_DAYS)
    dates = [val] + [val + dt.timedelta(days=d) for d in scen_days]
    times_days = np.array([0.0] + [float(d) for d in scen_days])
    df0 = np.exp(-0.075 * times_days / 365.25)
    swaps = xva_swaps(instruments, XVA_SWAPS)
    params = HW1FParams.flat(alpha=0.05, sigma=0.01)
    sim = HW1FCurveSimulator(params, tenors, np.full(tenors.size, 0.075), device=dev)
    sim_cpu = HW1FCurveSimulator(params, tenors, np.full(tenors.size, 0.075), device="cpu")
    pipe = dict(hazard_rate=0.02, recovery=0.4, flat_discount_rate=0.075)

    # 23a. the HW1F CVA pipeline ---------------------------------------------------
    t_phase = time.perf_counter()
    run = lambda: hw1f_cva_pipeline(sim, val, scen_days, tenors, XVA_PATHS, swaps, **pipe)
    kernels.reset_launch_counts()
    _, first_ms = host_ms(run)
    device_exposure._LEG_CACHE.clear()
    _, legs_ms = host_ms(lambda: DeviceExposureEngine(dates, {}, tenors, device=dev)._prepare(swaps))
    # the call's own peak: what it allocates above the tensors already held
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out, warm_ms = host_ms(run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pipeline_launches = dict(kernels.launch_counts)
    prof = profile_call(run, warm_ms)
    ee, pfe = out["profile"].ee, out["profile"].pfe
    check(np.isfinite(ee).all() and np.isfinite(pfe).all() and math.isfinite(out["cva"]),
          "the pipeline's profile or CVA is not finite")
    check(out["cva"] > 0 and (pfe >= 0).all() and pfe.max() >= ee.max(),
          f"CVA {out['cva']:.6g}, min PFE {pfe.min():.6g}, peak PFE {pfe.max():.6g} vs EE {ee.max():.6g}")
    npvs = XVA_PATHS * len(dates) * XVA_SWAPS

    small = {d: hw1f_cva_pipeline(s, val, scen_days, tenors, XVA_CPU_PATHS, swaps, **pipe)
             for d, s in (("card", sim), ("cpu", sim_cpu))}
    m_card, m_cpu = small["card"]["mtm"].cpu().numpy(), small["cpu"]["mtm"].numpy()
    card_vs_cpu = dict(mtm=float(np.abs(m_card - m_cpu).max() / np.abs(m_cpu).max()),
                       cva=abs(small["card"]["cva"] - small["cpu"]["cva"]) / abs(small["cpu"]["cva"]))
    check(card_vs_cpu["mtm"] <= 1e-10 and card_vs_cpu["cva"] <= 1e-10,
          f"pipeline card vs CPU at {XVA_CPU_PATHS} paths: {card_vs_cpu}")
    # the same host cube through the generic engine
    rates = sim.simulate(np.asarray(scen_days) / 365.25, tenors, XVA_CPU_PATHS, seed=42, as_jax=True)
    cube = sim.values_with_today(rates, tenors, XVA_CPU_PATHS, as_jax=True)
    cube_np = cube.cpu().numpy()
    host_cube = ScenarioCube(dates, {"ZAR-SWAP": ("curve", cube_np, tenors)})
    ns = NettingSet("NS", [Trade(s, f"T{i}") for i, s in enumerate(swaps)])
    generic, generic_ms = host_ms(lambda: ExposureEngine(host_cube).compute(ns))
    check(np.allclose(m_card, generic.mtm, rtol=1e-9, atol=1e-5),
          "pipeline MTM vs the generic engine (rtol 1e-9, atol 1e-5)")
    dev_vs_generic = float(np.abs(m_card - generic.mtm).max() / np.abs(generic.mtm).max())

    # one float32 call of the full cube (TF32 is off: main() turns it off)
    full = sim.values_with_today(
        sim.simulate(np.asarray(scen_days) / 365.25, tenors, XVA_PATHS, seed=42, as_jax=True),
        tenors, XVA_PATHS, as_jax=True)
    f64_mtm = lambda: DeviceExposureEngine(dates, {"ZAR-SWAP": full}, tenors, device=dev).mtm(swaps)
    f32_mtm = lambda: DeviceExposureEngine(dates, {"ZAR-SWAP": full.float()}, tenors, device=dev).mtm(swaps)
    f64_mtm(), f32_mtm()
    m64, mtm64_ms = host_ms(f64_mtm)
    m32, mtm32_ms = host_ms(f32_mtm)
    check(m32.dtype == torch.float32 and bool(torch.isfinite(m32).all()), "float32 MTM not finite")
    ee64 = exposure_profile(times_days, m64.T, df0=df0).ee
    ee32 = exposure_profile(times_days, m32.T, df0=df0).ee
    k = int(np.argmax(ee64))
    f32_gap = abs(float(ee32[k]) - ee64[k]) / ee64[k]
    check(f32_gap <= 1e-3, f"float32 EE at the peak vs float64: {f32_gap:.3e} > 1e-3")
    del full, m64, m32
    emit("xva_hw1f_pipeline", paths=XVA_PATHS, dates=len(dates), tenors=tenors.size, swaps=XVA_SWAPS,
         cube_gb=XVA_PATHS * len(dates) * tenors.size * 8 / 1e9, first_ms=first_ms,
         legs_build_ms=legs_ms, warm_ms=warm_ms, npvs_per_s=npvs / (warm_ms / 1e3),
         device_ms=prof["device_ms"], busy_share=prof["busy_share"],
         device_kernels=prof["device_kernels"], bmm_ms=prof["matmul_ms"],
         bmm_share_of_device=prof["matmul_ms"] / prof["device_ms"], top=prof["top"][:5],
         call_peak_gb=peak_gb - held_gb, held_before_gb=held_gb, peak_allocated_gb=peak_gb,
         launches=pipeline_launches, cva=out["cva"], peak_ee=float(ee.max()), peak_pfe=float(pfe.max()),
         card_vs_cpu=card_vs_cpu, cpu_paths=XVA_CPU_PATHS, device_vs_generic=dev_vs_generic,
         generic_ms=generic_ms, mtm_only_f64_ms=mtm64_ms, mtm_only_f32_ms=mtm32_ms,
         f32_ee_peak_rel_gap=f32_gap, limits={"card_vs_cpu": 1e-10, "f32_ee_peak": 1e-3,
                                                "device_vs_generic": [1e-9, 1e-5]}, **card)
    wall["23a HW1F pipeline"] = time.perf_counter() - t_phase

    # 23b. the exotic netting set ----------------------------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    ex_dates = [val + dt.timedelta(days=14 * i) for i in range(XVA_EXOTIC_DATES)]
    ex_tenors = np.asarray(XVA_EXOTIC_TENORS)
    eq = 100.0 * np.exp(rng.normal(0.0005, 0.035, (XVA_EXOTIC_DATES, XVA_EXOTIC_PATHS)).cumsum(axis=0))
    ex_rates = 0.07 + rng.normal(0, 0.002, (XVA_EXOTIC_DATES, XVA_EXOTIC_PATHS, ex_tenors.size)).cumsum(axis=0)
    mat = dt.date(2026, 7, 28)
    monitors = [val + dt.timedelta(days=30 * k) for k in range(1, 12)]

    def exotics(device):
        barrier = instruments.EquityBarrierOption(
            "uoc", "EQ.SPOT", strike=100.0, maturity_date=mat, sigma=0.3, rate=0.07,
            monitor_dates=monitors, barrier_type="up-and-out", upper_barrier=135.0, rebate=1.0,
            quantity=5_000.0, device=device)
        american = instruments.AmericanOptionPosition(
            "amp", "EQ.SPOT", strike=95.0, maturity_date=mat, sigma=0.3, rate=0.07,
            option_type="put", quantity=5_000.0, device=device)
        swap = instruments.IRSwap(
            name="irs", effective_date=val, maturity_date=mat, notional=500_000,
            receive_leg=instruments.SwapLeg(instruments.LegType.FLOATING, frequency=3,
                                            curve_name="ZAR-SWAP"),
            pay_leg=instruments.SwapLeg(instruments.LegType.FIXED, frequency=3, fixed_rate=0.075),
            discount_curve_name="ZAR-SWAP")
        return barrier, american, swap

    barrier, american, swap = exotics(dev)
    ex_cube = ScenarioCube(ex_dates, {"EQ.SPOT": ("scalar", eq), "ZAR-SWAP": ("curve", ex_rates, ex_tenors)})
    spot0 = float(np.mean(eq[0]))
    eng = DeviceExposureEngine(
        ex_dates, {"ZAR-SWAP": torch.as_tensor(ex_rates, device=dev)}, ex_tenors,
        scalars={"EQ.SPOT": torch.as_tensor(eq, device=dev)}, device=dev)
    trades = [barrier, american, swap]
    kernels.reset_launch_counts()
    generic, ex_generic_ms = host_ms(lambda: ExposureEngine(ex_cube).compute(
        NettingSet("NS-EXOTIC", [Trade(barrier, "T1"), Trade(american, "T2"), Trade(swap, "T3")])))
    _, surfaces_ms = host_ms(lambda: (barrier.build_surfaces(spot0, ex_dates),
                                      american.build_surfaces(spot0, ex_dates)))
    _, dev_first_ms = host_ms(lambda: eng.mtm(trades))
    mtm, dev_warm_ms = host_ms(lambda: eng.mtm(trades))
    torch.cuda.synchronize()
    exotic_launches = dict(kernels.launch_counts)
    mtm = mtm.cpu().numpy()
    # the route auto took for the knock-out surfaces, from the same decision
    # solve_value_surfaces makes, and checked against the path's counts
    live = [d for d in ex_dates if d < mat]
    ko_batch, _ = barrier._surface_batches(spot0, live)
    n_ko = barrier.num_space_nodes + 1
    route = pbatch._surface_route(ko_batch, n_ko, "auto", False, None, dev)[1]
    check((exotic_launches["spike_march_f64"] > 0) == (route == "spike"),
          f"auto's surface route {route!r} vs the path's counts {exotic_launches}")
    check(not any(v for k, v in exotic_launches.items() if k != "spike_march_f64"),
          f"the exotic path launched a kernel besides the f64 SPIKE march: {exotic_launches}")
    check(np.allclose(mtm, generic.mtm, rtol=1e-10, atol=1e-8),
          "exotic netting set: device engine vs generic (rtol 1e-10, atol 1e-8)")
    ex_dev_vs_generic = float(np.abs(mtm - generic.mtm).max() / np.abs(generic.mtm).max())

    # K2: the same knock-out batch through the forced SPIKE route
    kernels.reset_launch_counts()
    v_spike, _ = pbatch.solve_value_surfaces(ko_batch, n_ko, solver="spike", device=dev)
    torch.cuda.synchronize()
    k2_forced = kernels.launch_counts["spike_march_f64"]
    check(k2_forced > 0, "the forced spike surfaces launched no K2")
    v_auto = barrier._v_ko
    spike_vs_auto = float((v_spike - v_auto).abs().max() / v_auto.abs().max())
    check(spike_vs_auto <= 1e-9, f"K2 surfaces vs auto's ({route}): {spike_vs_auto:.3e} > 1e-9")
    _, spike_ms = host_ms(lambda: pbatch.solve_value_surfaces(ko_batch, n_ko, solver="spike", device=dev))
    _, auto_ms = host_ms(lambda: pbatch.solve_value_surfaces(ko_batch, n_ko, device=dev))

    # the surfaces on the card against the CPU
    cpu_barrier, cpu_american, _ = exotics("cpu")
    cpu_barrier.build_surfaces(spot0, ex_dates)
    cpu_american.build_surfaces(spot0, ex_dates)
    surf_vs_cpu = {
        name: float((card_v.cpu() - cpu_v).abs().max() / cpu_v.abs().max())
        for name, card_v, cpu_v in (("barrier_ko", barrier._v_ko, cpu_barrier._v_ko),
                                    ("american", american._v, cpu_american._v))
    }
    check(max(surf_vs_cpu.values()) <= 1e-10, f"surfaces card vs CPU: {surf_vs_cpu}")
    emit("xva_exotics", paths=XVA_EXOTIC_PATHS, dates=XVA_EXOTIC_DATES, tenors=ex_tenors.size,
         surface_rows=len(live), barrier_nodes=n_ko, barrier_steps=barrier.n_time_steps,
         american_nodes=american.num_space_nodes + 1, auto_route=route,
         launches=exotic_launches, generic_ms=ex_generic_ms, surfaces_build_ms=surfaces_ms,
         device_first_ms=dev_first_ms, device_warm_ms=dev_warm_ms,
         device_vs_generic=ex_dev_vs_generic, k2_forced_launches=k2_forced,
         k2_surfaces_ms=spike_ms, auto_surfaces_ms=auto_ms, k2_vs_auto=spike_vs_auto,
         surfaces_card_vs_cpu=surf_vs_cpu,
         limits={"device_vs_generic": [1e-10, 1e-8], "k2_vs_auto": 1e-9, "card_vs_cpu": 1e-10},
         **card)
    wall["23b exotics"] = time.perf_counter() - t_phase

    # 23c. the CSA on 23a's cube -------------------------------------------------------
    t_phase = time.perf_counter()
    fx = 18.0 * np.exp(np.random.default_rng(11).normal(0, 0.01, (len(dates), XVA_CPU_PATHS)).cumsum(axis=0))
    curves = {"ZAR-SWAP": cube, "RISKY-ZAR": cube + 0.02, "RISKY-USD": cube + 0.035}
    csa_cube = ScenarioCube(dates, {**{k: ("curve", v.cpu().numpy(), tenors) for k, v in curves.items()},
                                    "USDZAR": ("scalar", fx)})
    ccys = ["ZAR", "USD"] * (XVA_SWAPS // 2)
    fxs = [None if c == "ZAR" else "USDZAR" for c in ccys]
    vm = dict(mpor_days=10, vm_threshold=5e4, vm_threshold_post=8e4)
    cases = {
        "vm": CSA(**vm),
        "fixed_im": CSA(**vm, im_method=InitialMarginMethod.FIXED, im_amount=2.5e5),
        "schedule_im": CSA(**vm, im_method=InitialMarginMethod.SCHEDULE),
        "forward_string": CSA(close_out_method=CloseOutMethod.FORWARD, risky_curve_name="RISKY-ZAR"),
        "forward_dict": CSA(close_out_method=CloseOutMethod.FORWARD,
                            risky_curve_name={"ZAR": "RISKY-ZAR", "USD": "RISKY-USD"}),
    }
    eng = DeviceExposureEngine(dates, curves, tenors, scalars={"USDZAR": torch.as_tensor(fx, device=dev)},
                               device=dev)
    csa_gaps = {}
    for name, csa in cases.items():
        kw = dict(fx_factors=fxs, currencies=ccys) if name == "forward_dict" else {}
        gen = ExposureEngine(csa_cube).compute(NettingSet(
            "NS", [Trade(s, f"T{i}", currency=ccys[i] if kw else "ZAR",
                         fx_rate_factor=fxs[i] if kw else None) for i, s in enumerate(swaps)], csa=csa))
        got = eng.compute(swaps, csa=csa, **kw)
        csa_gaps[name] = {}
        for field in ("mtm", "collateral", "exposure"):
            g, w = getattr(got, field), getattr(gen, field)
            csa_gaps[name][field] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
            check(csa_gaps[name][field] <= 1e-10,
                  f"CSA {name}: device {field} vs generic {csa_gaps[name][field]:.3e} > 1e-10")
        check(name.startswith("forward") or np.abs(got.collateral).max() > 0, f"CSA {name}: no collateral")
    emit("xva_csa", paths=XVA_CPU_PATHS, dates=len(dates), swaps=XVA_SWAPS, device_vs_generic=csa_gaps,
         limit_of_max_abs=1e-10, **card)
    wall["23c CSA"] = time.perf_counter() - t_phase
    emit("xva_phase_wall_s", **wall, total=sum(wall.values()))
    return {k: pipeline_launches[k] + exotic_launches[k] for k in pipeline_launches}


def xva_bench_cube(n_paths: int, n_times: int = XVA_BENCH_DATES, seed: int = 0):
    """examples/exposure_bench.py's ``build_cube`` as arrays (dates, curves,
    scalars): a monthly swap curve with drift, an inflation curve, a flat
    2% dividend curve and a CPI level curve, with CPI and equity spots."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    tenors = np.asarray(XVA_TENORS)
    dates = [XVA_VAL + dt.timedelta(days=30 * i) for i in range(n_times)]
    t = np.arange(n_times)[:, None, None]
    z = rng.normal(0.0, 0.002, (n_times, n_paths, tenors.size)).cumsum(axis=0)
    swap = 0.075 + 0.0005 * t + z
    infl = 0.05 + 0.0003 * t + rng.normal(0.0, 0.001, z.shape).cumsum(axis=0)
    cpi = 100.0 * np.exp(0.004 * np.arange(n_times)[:, None]
                         + rng.normal(0, 0.002, (n_times, n_paths)).cumsum(axis=0))
    eq = 100.0 * np.exp(rng.normal(0.002, 0.05, (n_times, n_paths)).cumsum(axis=0))
    curves = {"ZAR-SWAP": swap, "INFL.ZA": infl, "EQ.DIV": np.full(z.shape, 0.02),
              "CPI.CURVE": cpi[:, :, None] * np.exp(0.05 * tenors)[None, None, :]}
    return dates, curves, {"CPI.ZA": cpi, "EQ.SPOT": eq}


def xva_bench_trades(I, md):
    """examples/exposure_bench.py's ``build_netting_set`` (a five-year IRS, a
    two-year TRS and a three-year RiskFlow-mode ILS) and ``build_wide_extras``
    (an OIS swap, a compounded-reset swap, a price-scaled TRS and a legacy
    CPI-curve ILS), in the port: (base, extras)."""
    import datetime as dt

    val = XVA_VAL
    hist = {md.shift_months(md.first_of_month(val), -k): 100.0 for k in range(0, 8)}
    float_leg = lambda **kw: I.SwapLeg(I.LegType.FLOATING, curve_name="ZAR-SWAP", **kw)
    fixed_leg = lambda freq, rate: I.SwapLeg(I.LegType.FIXED, frequency=freq, fixed_rate=rate)
    trs = lambda name, **kw: I.EquityTRS(
        name=name, effective_date=val, maturity_date=dt.date(2027, 7, 28), quantity=1000.0,
        notional=100_000.0, interest_leg=float_leg(frequency=3, spread=0.01), spot_name="EQ.SPOT",
        carry_curve_name="ZAR-SWAP", dividend_curve_name="EQ.DIV", discount_curve_name="ZAR-SWAP",
        initial_price=100.0, **kw)
    ils = lambda name, cpi, rate_curve: I.IndexLinkedSwap(
        name=name, effective_date=val, maturity_date=dt.date(2028, 7, 28), notional=1_000_000,
        inflation_leg=I.InflationLeg(real_rate=0.025, base_cpi=100.0, cpi_curve_name=cpi, frequency=6,
                                     inflation_rate_curve_name=rate_curve),
        nominal_leg=fixed_leg(6, 0.08), discount_curve_name="ZAR-SWAP", inflation_index=hist)
    base = [
        I.IRSwap(name="irs-5y", effective_date=val, maturity_date=dt.date(2030, 7, 28), notional=1_000_000,
                 receive_leg=float_leg(frequency=3), pay_leg=fixed_leg(3, 0.08),
                 discount_curve_name="ZAR-SWAP"),
        trs("trs-2y"),
        ils("ils-3y", "CPI.ZA", "INFL.ZA"),
    ]
    extras = [
        I.IRSwap(name="ois-2y", effective_date=val, maturity_date=dt.date(2027, 7, 28), notional=1_000_000,
                 receive_leg=float_leg(frequency=3, overnight_compounding=True), pay_leg=fixed_leg(3, 0.078),
                 discount_curve_name="ZAR-SWAP"),
        I.IRSwap(name="cmp-3y", effective_date=val, maturity_date=dt.date(2028, 7, 28), notional=1_000_000,
                 receive_leg=float_leg(frequency=6, reset_frequency_months=3), pay_leg=fixed_leg(6, 0.08),
                 discount_curve_name="ZAR-SWAP"),
        trs("trs-price-2y", interest_nominal_scaling="Price"),
        ils("ils-legacy-3y", "CPI.CURVE", ""),
    ]
    return base, extras


def xva_commodity_market(n_paths: int, n_times: int = XVA_COMMODITY_DATES, seed: int = 11):
    """tests/test_device_exposure.py TestDeviceCommodity's market: a swap
    curve and a Brent forward curve on fortnightly dates."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    k = len(XVA_TENORS)
    dates = [XVA_VAL + dt.timedelta(days=14 * i) for i in range(n_times)]
    swap = 0.07 + rng.normal(0, 0.002, (n_times, n_paths, k)).cumsum(axis=0)
    fwd = 70.0 * np.exp(rng.normal(0.001, 0.02, (n_times, n_paths, k)).cumsum(axis=0))
    return dates, {"ZAR-SWAP": swap, "BRENT": fwd}


def xva_commodity_trades(I):
    """TestDeviceCommodity's forward and average forward, and a one-year swap."""
    import datetime as dt

    val = XVA_VAL
    return [
        I.CommodityForwardInstrument(
            "cf", delivery_date=val + dt.timedelta(days=180), strike=72.0, notional=1000.0,
            forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP", pricing_lag_days=2),
        I.CommodityAverageForwardInstrument(
            "caf", averaging_dates=[val + dt.timedelta(days=30 * k) for k in range(1, 7)],
            payment_date=val + dt.timedelta(days=200), strike=71.0, notional=500.0,
            forward_curve_name="BRENT", discount_curve_name="ZAR-SWAP", pricing_lag_days=1),
        I.IRSwap(name="irs-1y", effective_date=val, maturity_date=dt.date(2026, 7, 28), notional=1_000_000,
                 receive_leg=I.SwapLeg(I.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
                 pay_leg=I.SwapLeg(I.LegType.FIXED, frequency=3, fixed_rate=0.08),
                 discount_curve_name="ZAR-SWAP"),
    ]


def xva_rest_phases(dev, card: dict) -> dict:
    """Phase 24, the rest of the XVA engine (the TRS, ILS and commodity
    families on the device engine, SIMM initial margin, the commodity CVA
    stack and ``run_asset``), float64 unless stated. Returns the launch
    counts of 24a-24c, each read with the counts zeroed just before it: the
    path is plain torch ops, so every count should be 0.

    - 24a, examples/exposure_bench.py's seven trades (:func:`xva_bench_trades`:
      IRS, TRS, RiskFlow ILS, OIS, compounded-reset swap, price-scaled TRS,
      legacy CPI-curve ILS) on its cube (:func:`xva_bench_cube`, seed 0) at
      :data:`XVA_BENCH_PATHS` paths x 62 monthly dates x 8 tenors, through
      ``DeviceExposureEngine.mtm``, and once at float32. Checks: the card
      against the CPU at :data:`XVA_CPU_PATHS` paths (MTM within 1e-10 of
      max|MTM|); the device engine against the generic one there under the
      example's CSA (MTM, collateral and exposure within 1e-10 of the
      largest |value|); the float32 EE at its peak within 1e-3 of float64.
    - 24b, the base set (IRS, TRS, ILS) under ``CSA(mpor_days=10,
      im_method=SIMM)`` through ``DeviceExposureEngine.compute`` at full
      width. Checks: its first :data:`XVA_SIMM_CHECK_PATHS` paths' collateral
      against the generic engine's SIMM on those paths (JAX's gate, rtol
      1e-7, atol 1e-8); a plain MTM after the SIMM call equal to the one
      before it bit for bit.
    - 24c, TestDeviceCommodity's forward, average forward and a one-year
      swap on its market (seed 11) at :data:`XVA_BENCH_PATHS` paths x 28
      fortnightly dates (device = generic at :data:`XVA_CPU_PATHS` paths
      within 1e-10 of max|MTM|); then examples/xva_commodity_forward.py's
      BRENT and GOLD through ``run_asset`` at ``SimulationConfig()``'s
      defaults (50,000 sims, daily steps, 365 days), threefry twice (first
      and warm) and ``sobol_device`` once; the card against the CPU at
      :data:`XVA_CS_CPU_SIMS` sims (CVA within 1e-12 relative).
    """
    import torch

    from finite_difference_tpu_torch import instruments, kernels, market_data
    from finite_difference_tpu_torch.market_data import ScenarioCube
    from finite_difference_tpu_torch.models.mc import CSParams
    from finite_difference_tpu_torch.portfolio import CSA, InitialMarginMethod, NettingSet, Trade
    from finite_difference_tpu_torch.runners import run_asset
    from finite_difference_tpu_torch.xva import DeviceExposureEngine, ExposureEngine, SimulationConfig
    from finite_difference_tpu_torch.xva import device_exposure
    from finite_difference_tpu_torch.xva.cva import exposure_profile

    wall, launches = {}, {}
    tenors = np.asarray(XVA_TENORS)
    on_dev = lambda arrays, dtype=torch.float64: {k: torch.as_tensor(v, device=dev, dtype=dtype)
                                                  for k, v in arrays.items()}

    def rel_gap(got, want):
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))

    def host_cube(dates, curves, scalars, n=None):
        cut = (lambda a: a[:, :n]) if n else (lambda a: a)
        return ScenarioCube(dates, {**{k: ("curve", cut(v), tenors) for k, v in curves.items()},
                                    **{k: ("scalar", cut(v)) for k, v in scalars.items()}})

    def netting_set(trades, csa):
        return NettingSet("NS", [Trade(t, f"T{i}") for i, t in enumerate(trades)], csa=csa)

    # 24a. the TRS, ILS and swap families --------------------------------------------
    t_phase = time.perf_counter()
    base, extras = xva_bench_trades(instruments, market_data)
    trades = base + extras
    dates, curves_np, scalars_np = xva_bench_cube(XVA_BENCH_PATHS)
    curves, scalars = on_dev(curves_np), on_dev(scalars_np)
    eng = DeviceExposureEngine(dates, curves, tenors, scalars=scalars, device=dev)
    device_exposure._LEG_CACHE.clear()
    kernels.reset_launch_counts()
    _, first_ms = host_ms(lambda: eng.mtm(trades))
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    mtm, warm_ms = host_ms(lambda: eng.mtm(trades))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["24a"] = dict(kernels.launch_counts)
    prof = profile_call(lambda: eng.mtm(trades), warm_ms)
    check(tuple(mtm.shape) == (XVA_BENCH_PATHS, len(dates)) and bool(torch.isfinite(mtm).all()),
          f"24a MTM shape {tuple(mtm.shape)} or not finite")
    npvs = XVA_BENCH_PATHS * len(dates) * len(trades)
    times_days = np.array([float((d - dates[0]).days) for d in dates])
    eng32 = DeviceExposureEngine(dates, on_dev(curves_np, torch.float32), tenors,
                                 scalars=on_dev(scalars_np, torch.float32), device=dev)
    eng32.mtm(trades)
    m32, f32_ms = host_ms(lambda: eng32.mtm(trades))
    check(m32.dtype == torch.float32 and bool(torch.isfinite(m32).all()), "24a float32 MTM not finite")
    ee64 = exposure_profile(times_days, mtm.T).ee
    ee32 = exposure_profile(times_days, m32.T).ee
    k = int(np.argmax(ee64))
    f32_gap = abs(float(ee32[k]) - ee64[k]) / ee64[k]
    check(f32_gap <= 1e-3, f"24a float32 EE at the peak vs float64: {f32_gap:.3e} > 1e-3")
    del m32, eng32

    s_dates, s_curves, s_scalars = xva_bench_cube(XVA_CPU_PATHS)
    small = {d: DeviceExposureEngine(s_dates, on_dev(s_curves) if d == "card" else s_curves, tenors,
                                     scalars=on_dev(s_scalars) if d == "card" else s_scalars,
                                     device=dev if d == "card" else "cpu").mtm(trades).cpu().numpy()
             for d in ("card", "cpu")}
    card_vs_cpu = rel_gap(small["card"], small["cpu"])
    check(card_vs_cpu <= 1e-10, f"24a card vs CPU at {XVA_CPU_PATHS} paths: {card_vs_cpu:.3e}")
    bench_csa = CSA(mpor_days=10, vm_threshold=0.0, vm_threshold_post=0.0, im_method=InitialMarginMethod.NONE)
    gen, generic_ms = host_ms(lambda: ExposureEngine(host_cube(s_dates, s_curves, s_scalars)).compute(
        netting_set(trades, bench_csa)))
    got = DeviceExposureEngine(s_dates, on_dev(s_curves), tenors, scalars=on_dev(s_scalars),
                               device=dev).compute(trades, csa=bench_csa)
    dev_vs_generic = {f: rel_gap(getattr(got, f), getattr(gen, f)) for f in ("mtm", "collateral", "exposure")}
    check(max(dev_vs_generic.values()) <= 1e-10, f"24a device vs generic: {dev_vs_generic}")
    emit("xva_families", paths=XVA_BENCH_PATHS, dates=len(dates), tenors=tenors.size,
         trades=[t.name for t in trades], npvs_per_call=npvs, first_ms=first_ms, warm_ms=warm_ms,
         npvs_per_s=npvs / (warm_ms / 1e3), device_ms=prof["device_ms"], busy_share=prof["busy_share"],
         device_kernels=prof["device_kernels"], bmm_ms=prof["matmul_ms"],
         bmm_share_of_device=prof["matmul_ms"] / prof["device_ms"], top=prof["top"][:5],
         call_peak_gb=peak_gb - held_gb, held_before_gb=held_gb, peak_allocated_gb=peak_gb,
         f32_ms=f32_ms, f32_ee_peak_rel_gap=f32_gap, launches=launches["24a"], card_vs_cpu=card_vs_cpu,
         cpu_paths=XVA_CPU_PATHS, device_vs_generic=dev_vs_generic, generic_ms=generic_ms,
         limits={"card_vs_cpu": 1e-10, "device_vs_generic": 1e-10, "f32_ee_peak": 1e-3}, **card)
    wall["24a families"] = time.perf_counter() - t_phase

    # 24b. SIMM on the base set --------------------------------------------------------
    t_phase = time.perf_counter()
    simm = CSA(mpor_days=10, im_method=InitialMarginMethod.SIMM)
    eng = DeviceExposureEngine(dates, curves, tenors, scalars=scalars, device=dev)
    before = eng.mtm(base)
    vm_only = eng.compute(base, csa=CSA(mpor_days=10))
    eng.compute(base, csa=simm)  # warm-up
    kernels.reset_launch_counts()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    prof_simm, simm_ms = host_ms(lambda: eng.compute(base, csa=simm))
    simm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["24b"] = dict(kernels.launch_counts)
    runs = eng.simm_runs
    check(torch.equal(eng.mtm(base), before), "24b: the plain MTM after the SIMM call moved")
    im = prof_simm.collateral - vm_only.collateral
    check(np.isfinite(prof_simm.collateral).all() and im.max() > 0, "24b: SIMM IM not finite or zero")
    n = XVA_SIMM_CHECK_PATHS
    gen, generic_simm_ms = host_ms(lambda: ExposureEngine(host_cube(dates, curves_np, scalars_np, n)).compute(
        netting_set(base, simm)))
    simm_gap = rel_gap(prof_simm.collateral[:n], gen.collateral)
    check(np.allclose(prof_simm.collateral[:n], gen.collateral, rtol=1e-7, atol=1e-8),
          f"24b device SIMM vs generic on {n} paths: {simm_gap:.3e} of max|collateral|")
    emit("xva_simm", paths=XVA_BENCH_PATHS, dates=len(dates), trades=[t.name for t in base], ms=simm_ms,
         netting_runs=runs, peak_im=float(im.max()), mean_im=float(im.mean()),
         call_peak_gb=simm_peak_gb - held_gb, held_before_gb=held_gb, launches=launches["24b"],
         generic_paths=n, generic_ms=generic_simm_ms, device_vs_generic_collateral=simm_gap,
         plain_mtm_unchanged=True, limits={"device_vs_generic": [1e-7, 1e-8]}, **card)
    del eng, curves, scalars, before, mtm, prof_simm, vm_only
    wall["24b SIMM"] = time.perf_counter() - t_phase

    # 24c. commodities ----------------------------------------------------------------
    t_phase = time.perf_counter()
    com_trades = xva_commodity_trades(instruments)
    c_dates, c_curves = xva_commodity_market(XVA_BENCH_PATHS)
    eng = DeviceExposureEngine(c_dates, on_dev(c_curves), tenors, device=dev)
    kernels.reset_launch_counts()
    _, com_first_ms = host_ms(lambda: eng.mtm(com_trades))
    com_mtm, com_warm_ms = host_ms(lambda: eng.mtm(com_trades))
    check(bool(torch.isfinite(com_mtm).all()), "24c commodity MTM not finite")
    s_dates, s_curves = xva_commodity_market(XVA_CPU_PATHS)
    gen = ExposureEngine(host_cube(s_dates, s_curves, {})).compute(netting_set(com_trades, None))
    got = DeviceExposureEngine(s_dates, on_dev(s_curves), tenors, device=dev).mtm(com_trades).cpu().numpy()
    com_gap = rel_gap(got, gen.mtm)
    check(com_gap <= 1e-10, f"24c commodity device vs generic: {com_gap:.3e}")

    assets = {}
    for code, spec in XVA_ASSETS.items():
        spec = dict(initial_curve=np.asarray(spec[0]), tenor_days=np.asarray(spec[1]), cs_params=CSParams(*spec[2]))
        run = lambda backend, cfg=SimulationConfig(), device=dev: run_asset(
            code, sim_cfg=cfg, discount_rate=0.05, hazard_rate=0.02, recovery=0.4, rng_backend=backend,
            device=device, **spec)
        out, first = host_ms(lambda: run("threefry"))
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        out, warm = host_ms(lambda: run("threefry"))
        peak = torch.cuda.max_memory_allocated() / 1e9 - held_gb
        p = profile_call(lambda: run("threefry"), warm)
        sob, sob_ms = host_ms(lambda: run("sobol_device"))
        for o in (out, sob):
            check(math.isfinite(o["cva"]) and o["cva"] > 0 and o["peak_pfe"] >= o["peak_ee"] > 0,
                  f"24c {code}: CVA {o['cva']}, peak EE {o['peak_ee']}, peak PFE {o['peak_pfe']}")
        cpu_cfg = SimulationConfig(num_sims=XVA_CS_CPU_SIMS)
        gaps = {}
        for backend in ("threefry", "sobol_device"):
            c, w = run(backend, cpu_cfg), run(backend, cpu_cfg, "cpu")
            gaps[backend] = abs(c["cva"] - w["cva"]) / abs(w["cva"])
            check(gaps[backend] <= 1e-12, f"24c {code} {backend}: CVA card vs CPU {gaps[backend]:.3e} > 1e-12")
        assets[code] = dict(first_ms=first, warm_ms=warm, device_ms=p["device_ms"], busy_share=p["busy_share"],
                            device_kernels=p["device_kernels"], top=p["top"][:3], call_peak_gb=peak,
                            cva=out["cva"], peak_ee=out["peak_ee"], peak_pfe=out["peak_pfe"],
                            sobol_device_ms=sob_ms, sobol_device_cva=sob["cva"],
                            cva_card_vs_cpu=gaps, strike=out["strike"], maturity_day=out["maturity_day"])
    torch.cuda.synchronize()
    launches["24c"] = dict(kernels.launch_counts)
    emit("xva_commodity", paths=XVA_BENCH_PATHS, dates=len(c_dates), trades=[t.name for t in com_trades],
         first_ms=com_first_ms, warm_ms=com_warm_ms, device_vs_generic=com_gap, cpu_paths=XVA_CPU_PATHS,
         sims=SimulationConfig().num_sims, steps=SimulationConfig().time_grid().n_steps, assets=assets,
         cpu_sims=XVA_CS_CPU_SIMS, launches=launches["24c"],
         limits={"device_vs_generic": 1e-10, "cva_card_vs_cpu": 1e-12}, **card)
    wall["24c commodities"] = time.perf_counter() - t_phase

    for name, counts in launches.items():
        check(not any(counts.values()), f"phase {name} launched a kernel of ours: {counts}")
    emit("xva_rest_phase_wall_s", **wall, total=sum(wall.values()))
    return {k: sum(c[k] for c in launches.values()) for k in launches["24a"]}


def scenario_market_json(directory: str) -> str:
    """25a's CVAMarketData file (tests/test_scenarios.py's layout): BRENT on
    24 monthly tenors to two years (historical CS: sigma 0.35, alpha 0.9,
    drift 4%), GOLD on 12 tenors every 60 days (implied CS: sigma 25%, alpha
    1.2), correlated 0.6 under RiskFlow's process prefix, run date
    :data:`SCEN_RUN` and the default grid ``0d 2d 1w(1w) 1m(1m) 3m(3m)``."""
    base = (SCEN_RUN - datetime.date(1899, 12, 30)).days
    curve = lambda rows: {".Curve": {"meta": [], "data": rows}}
    md = {"MarketData": {
        "Price Factors": {
            SCEN_FACTORS[0]: {"Curve": curve([[base + 30 * (i + 1), 80.0 + 0.5 * i] for i in range(24)]),
                              "Currency": "USD"},
            SCEN_FACTORS[1]: {"Curve": curve([[base + 60 * (i + 1), 2400.0 + 5.0 * i] for i in range(12)]),
                              "Currency": "USD"},
            "CSForwardPriceModelParameters.GOLD": {"Sigma": {".Percent": 25.0}, "Alpha": 1.2},
        },
        "Price Models": {"CSForwardPriceModel.BRENT.OIL": {"Sigma": 0.35, "Alpha": 0.9, "Drift": 0.04}},
        "Model Configuration": {},
        "Correlations": {"ClewlowStricklandProcess.ForwardPrice.BRENT.OIL": {
            "ClewlowStricklandProcess.ForwardPrice.GOLD": 0.6}},
        "Valuation Configuration": {"Run_Date": SCEN_RUN.isoformat()},
    }}
    path = os.path.join(directory, "market.json")
    with open(path, "w") as fh:
        json.dump(md, fh)
    return path


def implied_fixtures(directory: str, cal):
    """25d's inputs: test_calibration.py's fifteen options priced from
    (sigma, alpha) = (0.45, 0.8) on the CPU, and its bootstrap JSON file."""
    options = []
    for T, S in [(0.25, 0.3), (0.5, 0.6), (1.0, 1.1), (1.5, 1.6), (2.0, 2.1)]:
        for K in (90.0, 100.0, 110.0):
            var = float(cal.cs_variance(0.45, 0.8, T, S, device="cpu"))
            prem = float(cal.black_european_option_price(100.0, K, 0.0, math.sqrt(var), 1.0, 1.0, 1.0,
                                                         device="cpu")) * math.exp(-0.05 * T)
            options.append(dict(Forward=100.0, Strike=K, r=0.05, T=T, S=S, Premium=prem, Units=1.0,
                                Option_Type="Call", Weight=1.0))
    curve = lambda rows: {".Curve": {"meta": [], "data": rows}}
    md = {"MarketData": {
        "Price Factors": {
            "ForwardPrice.BRENT.OIL": {"Curve": curve([[45000 + 30 * i, 100.0 + i] for i in range(1, 13)]),
                                       "Currency": "USD"},
            "InterestRate.USD-OIS": {"Curve": curve([[0.0, 0.05], [5.0, 0.05]]), "Day_Count": "ACT_365"},
            "ForwardPriceVol.BRENT.VOL": {"Surface": curve([[1.0, T, T + 0.08, 0.35] for T in (0.25, 0.5, 1.0)])},
        },
        "Price Models": {}, "Model Configuration": {}, "Correlations": {},
        "System Parameters": {"Base_Date": "2023-03-15"},
        "Market Prices": {"CSForwardPriceModelPrices.BRENT.OIL": {"instrument": {
            "Forward_Volatility": "BRENT.VOL", "Energy": "BRENT.OIL", "Discount_Rate": "USD-OIS",
            "Energy_Futures_Options": [
                {"Expiry_Date": e, "Settlement_Date": s, "Option_Type": "Call"}
                for e, s in (("2023-06-15", "2023-07-15"), ("2023-09-15", "2023-10-15"),
                             ("2024-03-15", "2024-04-15"))]}}},
    }}
    path = os.path.join(directory, "bootstrap.json")
    with open(path, "w") as fh:
        json.dump(md, fh)
    return options, path


def hw1f_rates_xva(device, cal, sc, mc, instruments, portfolio, xva):
    """examples/hw1f_rates_xva.py with the port's modules on ``device``:
    calibrate HW1F on its 750-day synthetic panel (a numpy ``Panel``), a
    correlated rates + FX cube of 2,048 paths x 25 dates, the two-swap USD
    netting set through ``ExposureEngine``, then ``XvaCalculator``."""
    from finite_difference_tpu_torch.xva.config import CounterpartyConfig
    from finite_difference_tpu_torch.xva.cva import XvaCalculator

    tenors, today = np.asarray(HW1F_XVA_TENORS), np.asarray(HW1F_XVA_TODAY)
    rng = np.random.default_rng(0)
    x, rows = np.zeros(tenors.size), []
    for _ in range(750):
        x = x * (1 - 0.004) + 0.0004 * rng.standard_normal(tenors.size)
        rows.append(today + x)
    param, _, _ = cal.calibrate_hw1f_interest_rate(cal.Panel(range(750), tenors, np.array(rows)))
    p = mc.HW1FParams.from_calibration(param)
    p = mc.HW1FParams(alpha=p.alpha, sigma_tenors=p.sigma_tenors, sigma_values=p.sigma_values * today.mean())
    sim = mc.HW1FCurveSimulator(p, tenors, today, device=device)
    cube = sc.simulate_joint_cube(
        XVA_VAL, [30 * i for i in range(1, 25)] + [735],
        {"ZAR-SWAP": sc.HW1FCurveFactor(simulator=sim, tenors=tenors),
         "FX.USDZAR": sc.GBMScalarFactor(mc.GBMParams(mu=0.0, sigma=0.14), 18.0)},
        n_paths=2048, correlations={("ZAR-SWAP", "FX.USDZAR"): -0.25}, seed=42, device=device)

    def swap(fixed, years, flip=False):
        legs = dict(receive_leg=instruments.SwapLeg(instruments.LegType.FLOATING, frequency=3, curve_name="ZAR-SWAP"),
                    pay_leg=instruments.SwapLeg(instruments.LegType.FIXED, frequency=3, fixed_rate=fixed))
        if flip:
            legs = dict(receive_leg=legs["pay_leg"], pay_leg=legs["receive_leg"])
        return instruments.IRSwap(name=f"swap{years}y", effective_date=XVA_VAL,
                                  maturity_date=datetime.date(XVA_VAL.year + years, XVA_VAL.month, XVA_VAL.day),
                                  notional=1_000_000, discount_curve_name="ZAR-SWAP", **legs)

    ns = portfolio.NettingSet("US-bank", [
        portfolio.Trade(swap(0.074, 2), "T1", currency="USD", fx_rate_factor="FX.USDZAR"),
        portfolio.Trade(swap(0.073, 1, flip=True), "T2", currency="USD", fx_rate_factor="FX.USDZAR")])
    prof = xva.ExposureEngine(cube).compute(ns)
    ee, pfe = prof.ee(), prof.pfe(0.95)
    calc = XvaCalculator(CounterpartyConfig(hazard_rate=0.02, recovery=0.4), days_in_year=365.25,
                         discount_to_zero=False)
    days = np.array([(d - XVA_VAL).days for d in cube.dates], float)
    return dict(alpha=p.alpha, sigma_abs_1y=float(p.sigma_at(np.array(1.0))), peak_ee=float(ee.max()),
                peak_pfe=float(pfe.max()), cva=float(calc.cva_from_ee(days, ee)))


def scenario_phases(dev, card: dict) -> dict:
    """Phase 25, the scenario layer and the CS and HW1F calibration
    (``scenarios``, ``calibration``), float64. Returns the launch counts of
    25a-25d, each read with the counts zeroed just before it: the path is
    plain torch ops and host numpy, so every count should be 0.

    - 25a, ``run_multi_factor_simulation_from_json`` on
      :func:`scenario_market_json`'s two factors, 16 batches of 1,024
      scenarios (16,384), with each draw backend (threefry, sobol_device,
      torch): first and warm ms, the profile, the call's peak. Checks: the
      card against the CPU on the same run within 1e-12 of max|F| per
      factor; the torch backend's draws bit for bit; the comparator on
      the card's frames against the CPU's says MATCH; GOLD (implied) is a
      martingale at the last date within 3% per tenor.
    - 25b, ``simulate_joint_cube(..., as_jax=True)`` with
      test_device_exposure.py's factors (HW1F ZAR-SWAP and INFL.ZA on
      :data:`XVA_TENORS`, GBM CPI.ZA and EQ.SPOT, their correlations) at
      :data:`XVA_PATHS` x 63 dates, into ``DeviceExposureEngine.mtm`` over
      :func:`xva_swaps`' ten swaps on ZAR-SWAP: the cube's ms apart from the
      engine's. Checks: card = CPU at :data:`XVA_CPU_PATHS` paths (MTM within
      1e-10 of max|MTM|); the device engine on the device cube = the generic
      engine on the host cube at :data:`SCEN_GENERIC_PATHS` paths (1e-10 of
      max|MTM|).
    - 25c, :func:`hw1f_rates_xva` on the card: peak EE, peak PFE, CVA
      (card = CPU within 1e-10 relative; CVA > 0, peak PFE >= peak EE > 0).
    - 25d, ``calibrate_implied`` on the fifteen options of
      :func:`implied_fixtures` and ``bootstrap_from_json`` on its file: the
      L-BFGS-B iterations and ms. Checks: the fit's (Sigma, Alpha) card =
      CPU within 1e-9, the bootstrap's within L-BFGS-B's 1e-6 (its optimum
      sits at alpha ~ 0, where the variance formula keeps 8 digits); the
      round trip recovers (0.45, 0.8) (1e-3 and 1e-2 relative, JAX's test).
    """
    import tempfile

    import scipy.optimize
    import torch

    from finite_difference_tpu_torch import calibration as cal
    from finite_difference_tpu_torch import instruments, kernels, portfolio, xva
    from finite_difference_tpu_torch import scenarios as sc
    from finite_difference_tpu_torch.models import mc

    wall, launches = {}, {}

    def rel_gap(got, want):
        got, want = np.asarray(got), np.asarray(want)
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))

    def measured(fn):
        """(out, first ms, warm ms, call peak GB, profile) of ``fn`` on the card,
        the launch counts zeroed before the first call."""
        kernels.reset_launch_counts()
        _, first = host_ms(fn)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, warm = host_ms(fn)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        counts = dict(kernels.launch_counts)
        prof = profile_call(fn, warm)
        return out, first, warm, peak, prof, counts

    tmp = tempfile.TemporaryDirectory()
    # 25a. CS scenario generation -----------------------------------------------------
    t_phase = time.perf_counter()
    path = scenario_market_json(tmp.name)
    run = lambda backend, device=dev: sc.run_multi_factor_simulation_from_json(
        path, list(SCEN_FACTORS), batch_size=SCEN_BATCH, simulation_batches=SCEN_BATCHES, random_seed=42,
        rng_backend=backend, device=device)
    n_scen = SCEN_BATCH * SCEN_BATCHES
    backends = {}
    for backend in SCEN_BACKENDS:
        (res, frames, metas), first, warm, peak, prof, launches[f"25a {backend}"] = measured(lambda: run(backend))
        (cpu_res, cpu_frames, _), cpu_ms = host_ms(lambda: run(backend, "cpu"))
        gaps, verdicts = {}, {}
        for name in SCEN_FACTORS:
            sim = res[name]
            check(sim.shape == (len(metas[name]["scen_time_grid"]), len(metas[name]["prices"]), n_scen)
                  and np.isfinite(sim).all(), f"25a {backend} {name}: shape {sim.shape} or not finite")
            gaps[name] = rel_gap(sim, cpu_res[name])
            check(gaps[name] <= 1e-12, f"25a {backend} {name}: card vs CPU {gaps[name]:.3e} > 1e-12")
            verdicts[name] = sc.compare_scenario_outputs(frames[name], cpu_frames[name])["verdict"]
            check(verdicts[name] == "MATCH", f"25a {backend} {name}: comparator says {verdicts[name]}")
        gold = res[SCEN_FACTORS[1]][-1]
        drift = np.abs(gold.mean(axis=-1) / metas[SCEN_FACTORS[1]]["prices"] - 1.0).max()
        check(drift <= 0.03, f"25a {backend}: GOLD's last-date mean off its forward by {drift:.3e}")
        draws_equal = None
        if backend == "torch":
            L = sc.build_cholesky({SCEN_FACTORS: 0.6}, list(SCEN_FACTORS))
            n_steps = res[SCEN_FACTORS[0]].shape[0]
            z = [sc.generate_random_numbers(L, n_steps, SCEN_BATCH, True, "torch", seed=42, device=d).cpu()
                 for d in (dev, "cpu")]
            draws_equal = bool(torch.equal(*z))
            check(draws_equal, "25a torch backend: the card's draws differ from the CPU's")
        backends[backend] = dict(
            first_ms=first, warm_ms=warm, scenarios_per_s=n_scen / (warm / 1e3), device_ms=prof["device_ms"],
            busy_share=prof["busy_share"], device_kernels=prof["device_kernels"], top=prof["top"][:3],
            call_peak_gb=peak, cpu_ms=cpu_ms, card_vs_cpu=gaps, comparator=verdicts,
            gold_martingale_gap=float(drift), draws_bit_for_bit=draws_equal,
            launches=launches[f"25a {backend}"])
    grid = metas[SCEN_FACTORS[0]]["scen_time_grid"]
    emit("scenarios_cs", factors=list(SCEN_FACTORS), tenors=[len(metas[n]["prices"]) for n in SCEN_FACTORS],
         steps=len(grid), grid_days=[int(d) for d in grid], batch=SCEN_BATCH, batches=SCEN_BATCHES,
         scenarios=n_scen, backends=backends,
         limits={"card_vs_cpu": 1e-12, "gold_martingale": 0.03, "comparator": "MATCH"}, **card)
    wall["25a CS scenarios"] = time.perf_counter() - t_phase

    # 25b. the joint cube into the device exposure engine -------------------------------
    t_phase = time.perf_counter()
    tenors = np.asarray(XVA_TENORS)
    swaps = xva_swaps(instruments, XVA_SWAPS)

    def factors(device):
        sim = lambda r0: mc.HW1FCurveSimulator(mc.HW1FParams.flat(alpha=0.05, sigma=0.008), tenors,
                                               np.full(tenors.size, r0), device=device)
        return {"ZAR-SWAP": sc.HW1FCurveFactor(sim(0.075), tenors), "INFL.ZA": sc.HW1FCurveFactor(sim(0.05), tenors),
                "CPI.ZA": sc.GBMScalarFactor(mc.GBMParams(mu=0.05, sigma=0.015), 102.4),
                "EQ.SPOT": sc.GBMScalarFactor(mc.GBMParams(mu=0.07, sigma=0.25), 100.0)}

    corr = {("ZAR-SWAP", "INFL.ZA"): 0.4, ("CPI.ZA", "INFL.ZA"): 0.6}
    cube = lambda n, device=dev, as_jax=True: sc.simulate_joint_cube(
        XVA_VAL, list(XVA_SCEN_DAYS), factors(device), n, corr, as_jax=as_jax, device=device)
    (dates, curves, scalars, _), cube_first, cube_warm, cube_peak, cube_prof, cube_counts = measured(
        lambda: cube(XVA_PATHS))
    eng = xva.DeviceExposureEngine(dates, curves, tenors, scalars=scalars, device=dev)
    mtm, eng_first, eng_warm, eng_peak, eng_prof, eng_counts = measured(lambda: eng.mtm(swaps))
    launches["25b"] = {k: cube_counts[k] + eng_counts[k] for k in cube_counts}
    check(tuple(mtm.shape) == (XVA_PATHS, len(dates)) and bool(torch.isfinite(mtm).all()),
          f"25b MTM shape {tuple(mtm.shape)} or not finite")
    for name, t in {**curves, **scalars}.items():
        check(t.device.type == dev.type and bool(torch.isfinite(t).all()), f"25b factor {name} off the card or not finite")
    del eng, curves, scalars, mtm

    def cube_mtm(n, device):
        d, c, s, _ = cube(n, device)
        return xva.DeviceExposureEngine(d, c, tenors, scalars=s, device=device).mtm(swaps).cpu().numpy()

    card_vs_cpu = rel_gap(cube_mtm(XVA_CPU_PATHS, dev), cube_mtm(XVA_CPU_PATHS, "cpu"))
    check(card_vs_cpu <= 1e-10, f"25b card vs CPU at {XVA_CPU_PATHS} paths: {card_vs_cpu:.3e} > 1e-10")
    host_cube = cube(SCEN_GENERIC_PATHS, as_jax=False)
    gen, generic_ms = host_ms(lambda: xva.ExposureEngine(host_cube).compute(
        portfolio.NettingSet("NS", [portfolio.Trade(s, f"T{i}") for i, s in enumerate(swaps)])))
    dev_vs_generic = rel_gap(cube_mtm(SCEN_GENERIC_PATHS, dev), gen.mtm)
    check(dev_vs_generic <= 1e-10, f"25b device vs generic at {SCEN_GENERIC_PATHS} paths: {dev_vs_generic:.3e}")
    npvs = XVA_PATHS * len(dates) * XVA_SWAPS
    emit("scenarios_joint_cube", paths=XVA_PATHS, dates=len(dates), tenors=tenors.size, factors=list(factors("cpu")),
         swaps=XVA_SWAPS, cube_first_ms=cube_first, cube_warm_ms=cube_warm, cube_device_ms=cube_prof["device_ms"],
         cube_busy_share=cube_prof["busy_share"], cube_device_kernels=cube_prof["device_kernels"],
         cube_top=cube_prof["top"][:3], cube_call_peak_gb=cube_peak, engine_first_ms=eng_first,
         engine_warm_ms=eng_warm, npvs_per_s=npvs / (eng_warm / 1e3), engine_device_ms=eng_prof["device_ms"],
         engine_busy_share=eng_prof["busy_share"], engine_device_kernels=eng_prof["device_kernels"],
         engine_call_peak_gb=eng_peak, card_vs_cpu=card_vs_cpu, cpu_paths=XVA_CPU_PATHS,
         device_vs_generic=dev_vs_generic, generic_paths=SCEN_GENERIC_PATHS, generic_ms=generic_ms,
         launches=launches["25b"], limits={"card_vs_cpu": 1e-10, "device_vs_generic": 1e-10}, **card)
    wall["25b joint cube"] = time.perf_counter() - t_phase

    # 25c. examples/hw1f_rates_xva.py on the card -------------------------------------
    t_phase = time.perf_counter()
    example = lambda device=dev: hw1f_rates_xva(device, cal, sc, mc, instruments, portfolio, xva)
    out, first, warm, peak, prof, launches["25c"] = measured(example)
    want, cpu_ms = host_ms(lambda: example("cpu"))
    cva_gap = abs(out["cva"] - want["cva"]) / abs(want["cva"])
    check(math.isfinite(out["cva"]) and out["cva"] > 0 and out["peak_pfe"] >= out["peak_ee"] > 0,
          f"25c: CVA {out['cva']}, peak EE {out['peak_ee']}, peak PFE {out['peak_pfe']}")
    check(cva_gap <= 1e-10, f"25c CVA card vs CPU {cva_gap:.3e} > 1e-10")
    emit("scenarios_hw1f_xva", paths=2048, dates=26, **out, first_ms=first, warm_ms=warm,
         device_ms=prof["device_ms"], busy_share=prof["busy_share"], device_kernels=prof["device_kernels"],
         top=prof["top"][:3], call_peak_gb=peak, cpu_ms=cpu_ms, cpu_cva=want["cva"], cva_card_vs_cpu=cva_gap,
         launches=launches["25c"], limits={"cva_card_vs_cpu": 1e-10}, **card)
    wall["25c HW1F rates XVA"] = time.perf_counter() - t_phase

    # 25d. the CS implied calibration -------------------------------------------------
    t_phase = time.perf_counter()
    options, boot_path = implied_fixtures(tmp.name, cal)
    fits, minimize = [], scipy.optimize.minimize

    def counted(*args, **kwargs):
        res = minimize(*args, **kwargs)
        fits.append(res)
        return res

    scipy.optimize.minimize = counted
    try:
        fit, first, warm, peak, prof, launches["25d"] = measured(lambda: cal.calibrate_implied(options, device=dev))
        iterations, evaluations = fits[-1].nit, fits[-1].nfev
        fit_cpu, cpu_ms = host_ms(lambda: cal.calibrate_implied(options, device="cpu"))
        kernels.reset_launch_counts()
        boot, boot_ms = host_ms(lambda: cal.bootstrap_from_json(boot_path, device=dev))
        launches["25d"] = {k: v + kernels.launch_counts[k] for k, v in launches["25d"].items()}
        boot_iterations = fits[-1].nit
        boot_cpu = cal.bootstrap_from_json(boot_path, device="cpu")
    finally:
        scipy.optimize.minimize = minimize
    fit_gap = max(abs(fit[k] - fit_cpu[k]) for k in ("Sigma", "Alpha"))
    boot_gap = max(abs(boot["BRENT.OIL"][k] - boot_cpu["BRENT.OIL"][k]) for k in ("Sigma", "Alpha"))
    check(fit_gap <= 1e-9, f"25d calibrate_implied card vs CPU: {fit_gap:.3e} > 1e-9")
    # the bootstrap's optimum sits at alpha ~ 0, where cs_variance's
    # (1 - exp(-2 alpha T)) / (2 alpha) (JAX's formula) keeps about 8 digits:
    # the two devices' last-bit exp differences move L-BFGS-B's stopping
    # point at that level, so it is held at L-BFGS-B's tolerance
    check(boot_gap <= 1e-6, f"25d bootstrap card vs CPU: {boot_gap:.3e} > 1e-6")
    check(abs(fit["Sigma"] / 0.45 - 1) <= 1e-3 and abs(fit["Alpha"] / 0.8 - 1) <= 1e-2,
          f"25d round trip: {fit} is not (0.45, 0.8)")
    b = boot["BRENT.OIL"]
    check(0.001 < b["Sigma"] < 2.5 and -1.0 <= b["Alpha"] <= 2.0, f"25d bootstrap out of bounds: {b}")
    emit("scenarios_cs_implied", options=len(options), fit=fit, iterations=int(iterations),
         objective_evaluations=int(evaluations), first_ms=first, warm_ms=warm, ms_per_evaluation=warm / evaluations,
         device_ms=prof["device_ms"], busy_share=prof["busy_share"], device_kernels=prof["device_kernels"],
         call_peak_gb=peak, cpu_ms=cpu_ms, fit_card_vs_cpu=fit_gap, bootstrap=b, bootstrap_ms=boot_ms,
         bootstrap_iterations=int(boot_iterations), bootstrap_card_vs_cpu=boot_gap, launches=launches["25d"],
         limits={"card_vs_cpu": 1e-9, "bootstrap_card_vs_cpu": 1e-6, "round_trip": [1e-3, 1e-2]}, **card)
    tmp.cleanup()
    wall["25d CS implied"] = time.perf_counter() - t_phase

    for name, counts in launches.items():
        check(not any(counts.values()), f"phase {name} launched a kernel of ours: {counts}")
    emit("scenario_phase_wall_s", **wall, total=sum(wall.values()))
    return {k: sum(c[k] for c in launches.values()) for k in launches["25b"]}


def mesh_phases(dev, card: dict) -> dict:
    """Phase 26, the device mesh (``finite_difference_tpu_torch.parallel``
    and ``mesh=``). The machine has one card, so a k-way mesh repeats it
    (``["cuda:0"] * k``): each check shows that the split, the padding, the
    per-shard launches and the gather are right at full width, not that
    cards overlap. Where torch sees two cards or more, 26a runs over the
    real cards too. Returns the launches of K1, K1a and K2 in the sharded
    calls (each read with the counts zeroed just before it; the unsharded
    references are not counted).

    - 26a, the benchmark trade set (B=4096, N=1024, 512 steps, f32,
      ``solver="spike"``, price only) unsharded and over k = 1, 2, 4
      shards: equal bit for bit, K1 launched k times the unsharded count
      (one launch per segment per shard), and each call's host ms (the
      median of :data:`MESH_CALLS`), the split's cost on one card.
    - 26b, the American set over 4 shards (``solver="spike"``): B=4096 f32
      with two dividends (K1a) and the f64 rung, B=256 with greeks (K2):
      equal to unsharded bit for bit, each kernel launched 4 times the
      unsharded count.
    - 26c, the spectral route: f64 B=4096 ``auto`` over 4 shards, within
      1e-12 of max|price| of the unsharded call; its graph counts.
    - 26d, the float64 barrier service with greeks and the float32
      price-only service on phase 19's mixed stream at bucket 512, built
      with a 4-shard mesh: rows within 1e-12 of max|value| of the plain
      service's; and the spectral graphs a mesh request adds beside a plain
      request's key, which keeps replaying.
    - 26e, the barrier runner on phase 20's 4160-row stress table with the
      mesh: rows within 1e-12 of max|value| of the unsharded runner's.
    - 26f, phase 23's ten swaps at 50,000 x 63 x 8 with the cube's path
      axis sharded over 4: MTM within 1e-12 of max|MTM|; the reductions:
      ``sharded_mean_stderr`` on 200,000 seeded samples (22a's path count)
      against numpy, ``sharded_exposure_profile`` on that MTM against
      ``xva.cva.exposure_profile``, each within 1e-12 (stderr 1e-10).
    - 26g, ``entry()`` on the card and ``dryrun_multichip(4, devices=
      ["cuda:0"] * 4)``: each completes.
    """
    import datetime as dt
    import statistics
    import tempfile

    import torch

    from finite_difference_tpu_torch import instruments, kernels, parallel
    from finite_difference_tpu_torch.entry import dryrun_multichip, entry
    from finite_difference_tpu_torch.models.mc import HW1FCurveSimulator, HW1FParams
    from finite_difference_tpu_torch.models.pde import spectral, spike
    from finite_difference_tpu_torch.models.pde.batch import (
        build_american_batch,
        build_trade_batch,
        price_american_batch,
        price_barrier_batch,
    )
    from finite_difference_tpu_torch.runners import run_all_scenarios_batched
    from finite_difference_tpu_torch.serving import BarrierPricingService
    from finite_difference_tpu_torch.xva import DeviceExposureEngine
    from finite_difference_tpu_torch.xva.cva import exposure_profile

    wall, launches = {}, {}
    here = f"cuda:{torch.cuda.current_device()}"
    repeated = lambda k: parallel.make_mesh(k, devices=[here] * k)
    mesh4 = repeated(4)

    def drive(fn):
        """``fn()`` with the kernels' counts zeroed just before and read just after."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    def median_ms(fn):
        fn()
        return statistics.median(host_ms(fn)[1] for _ in range(MESH_CALLS))

    def same(got, want) -> bool:
        return set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    def gap(got, want) -> float:
        return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-300)
                   for k in want)

    # 26a. the benchmark trade set over k shards ----------------------------------------
    t_phase = time.perf_counter()
    tb = build_trade_batch(dtype=torch.float32, device=dev, **bench_trades(B_MAIN)[0])
    call = lambda mesh=None: price_barrier_batch(tb, N_NODES, with_greeks=False, solver="spike", mesh=mesh,
                                                 device=dev)
    kernels.reset_launch_counts()
    single = call()
    torch.cuda.synchronize()
    base = kernels.launch_counts["spike_march_f32"]
    base_ms = median_ms(call)

    def over(meshes) -> dict:
        rows = {}
        for k, mesh in meshes:
            out, counts = drive(lambda: call(mesh))
            check(same(out, single), f"26a {k} shards: not equal to the unsharded call")
            check(counts.get("spike_march_f32") == k * base,
                  f"26a {k} shards launched K1 {counts.get('spike_march_f32')} times, not {k} x {base}")
            rows[str(k)] = dict(call_ms=median_ms(lambda: call(mesh)), launches=counts, bit_for_bit=True)
        return rows

    emit("mesh_spike", mesh=f"[{here!r}] * k", B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float32",
         solver="spike", P_whole_batch=spike.spike_p_choices(N_NODES, B_MAIN)[0],
         P_shard_alone={str(k): spike.spike_p_choices(N_NODES, B_MAIN // k)[0] for k in MESH_SHARDS},
         unsharded_call_ms=base_ms, unsharded_launches=base,
         shards=over((k, repeated(k)) for k in MESH_SHARDS),
         note="one card repeated: the split's cost, not an overlap across cards", **card)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        emit("mesh_spike_real_cards", cards=n_cards, shards=over([(n_cards, parallel.make_mesh())]), **card)
    else:
        emit("mesh_spike_real_cards", cards=n_cards, run=False,
             note=f"torch.cuda.device_count() is {n_cards}: 26a ran on the repeated card only", **card)
    del tb, single
    wall["26a benchmark set"] = time.perf_counter() - t_phase

    # 26b. the American set: K1a and K2 over 4 shards --------------------------------------
    t_phase = time.perf_counter()
    american = {}
    for label, kernel, make, kw in (
        ("f32_dividends", "spike_march_american_f32",
         lambda: build_american_batch(dtype=torch.float32, device=dev, **american_trades(B_MAIN, True)[0]),
         dict(with_greeks=False, solver="spike")),
        ("f64_greeks", "spike_march_american_f64",
         lambda: build_american_batch(dtype=torch.float64, device=dev, **american_trades(B_CHECK)[0]),
         dict(with_greeks=True, dv_sigma=1e-2, solver="spike")),
    ):
        batch = make()
        kernels.reset_launch_counts()
        want = price_american_batch(batch, N_NODES, device=dev, **kw)
        torch.cuda.synchronize()
        alone = kernels.launch_counts[kernel]
        got, counts = drive(lambda: price_american_batch(batch, N_NODES, mesh=mesh4, device=dev, **kw))
        check(same(got, want), f"26b {label}: 4 shards not equal to the unsharded call")
        check(counts.get(kernel) == 4 * alone, f"26b {label}: {kernel} {counts.get(kernel)} != 4 x {alone}")
        american[label] = dict(B=batch.batch_size, launches=counts, unsharded_launches=alone, bit_for_bit=True,
                               call_ms=median_ms(lambda: price_american_batch(batch, N_NODES, mesh=mesh4, device=dev, **kw)),
                               unsharded_call_ms=median_ms(lambda: price_american_batch(batch, N_NODES, device=dev, **kw)))
    emit("mesh_american", shards=4, N=N_NODES, steps=N_STEPS, **american, **card)
    wall["26b American"] = time.perf_counter() - t_phase

    # 26c. the spectral route over 4 shards --------------------------------------------------
    t_phase = time.perf_counter()
    tb64 = build_trade_batch(dtype=torch.float64, device=dev, **bench_trades(B_MAIN)[0])
    spectral_call = lambda mesh=None: price_barrier_batch(tb64, N_NODES, with_greeks=False, mesh=mesh, device=dev)
    want = spectral_call()
    spectral.reset_graph_counts()
    outs = [drive(lambda: spectral_call(mesh4)) for _ in range(3)]
    graphs = dict(spectral.graph_counts)
    spec_gap = max(gap(o, want) for o, _ in outs)
    check(spec_gap <= 1e-12, f"26c spectral over 4 shards vs unsharded {spec_gap:.3e} > 1e-12")
    check(not any(c for _, c in outs), f"26c launched a kernel of ours: {[c for _, c in outs]}")
    emit("mesh_spectral", shards=4, B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float64", solver="auto",
         calls=3, graph_counts=graphs, max_rel_gap=spec_gap, limit=1e-12,
         call_ms=median_ms(lambda: spectral_call(mesh4)), unsharded_call_ms=median_ms(spectral_call), **card)
    del tb64
    wall["26c spectral"] = time.perf_counter() - t_phase

    # 26d. two services over a 4-shard mesh ------------------------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2600)
    stream = [serving_trades("barrier", int(rng.integers(257, 513)), rng) for _ in range(MESH_REQUESTS)]
    services = {}
    for label, make in (
        ("barrier_f64_greeks", lambda **kw: BarrierPricingService(device=dev, **kw)),
        ("barrier_f32_price", lambda **kw: BarrierPricingService(dtype=np.float32, with_greeks=False,
                                                                 device=dev, **kw)),
    ):
        plain, sharded = make(), make(mesh=mesh4)
        want = [plain.price(r) for r in stream]
        got, counts = drive(lambda: [sharded.price(r) for r in stream])
        errs = [rows_error(g, w) for g, w in zip(got, want)]
        worst = max(max(e.values()) for e in errs)
        check(worst <= 1e-12, f"26d {label} over 4 shards vs the plain service {worst:.3e} > 1e-12")
        line = dict(requests=MESH_REQUESTS, bucket=512, launches=counts, max_rel_gap=worst, limit=1e-12,
                    bit_for_bit=all(g == w for g, w in zip(got, want)))
        if label == "barrier_f64_greeks":
            # a plain request's graph key against the keys a mesh request adds
            request = stream[0]
            for _ in range(3):
                plain.price(request)
            before = set(spectral._GRAPHS)
            for _ in range(3):
                sharded.price(request)
            added = len(set(spectral._GRAPHS) - before)
            spectral.reset_graph_counts()
            plain.price(request)
            after = dict(spectral.graph_counts)
            check(after["eager"] == 0 and after["captures"] == 0,
                  f"26d the plain request's graph was evicted by the mesh's: {after}")
            line.update(graphs_cached=len(spectral._GRAPHS), graphs_added_by_mesh_request=added,
                        cache_size=spectral.GRAPH_CACHE_SIZE, plain_request_after_mesh=after)
        else:
            check(counts.get("spike_march_f32", 0) > 0, "26d the float32 service over the mesh launched no K1")
        services[label] = line
    emit("mesh_serving", shards=4, N=N_NODES, steps=N_STEPS, **services, **card)
    wall["26d services"] = time.perf_counter() - t_phase

    # 26e. the barrier runner on the stress table ----------------------------------------
    t_phase = time.perf_counter()
    base_params = dict(valuation=datetime.date(2025, 7, 28), maturity=datetime.date(2025, 8, 28),
                       monitor_dates=[datetime.date(2025, 7, 28) + dt.timedelta(days=d) for d in FA_MONITOR_DAYS])
    runner = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        for opt, rows in fa_stress_rows().items():
            path = write_csv(os.path.join(tmp, f"barrier_{opt}.csv"), FA_HEADER, rows)
            params = dict(base_params, opt_type=opt)
            want, plain_ms = host_ms(lambda: run_all_scenarios_batched(path, None, params, device=dev))
            (got, counts), mesh_ms = host_ms(lambda: drive(
                lambda: run_all_scenarios_batched(path, None, params, mesh=mesh4, device=dev)))
            cols = [c for c in want[0] if c.startswith("model_")]
            worst = rows_error(got, want, keys=cols)
            check(len(got) == len(want) and [r["scenario_name"] for r in got] == [r["scenario_name"] for r in want],
                  f"26e {opt}: rows out of order")
            check(max(worst.values()) <= 1e-12, f"26e {opt} over 4 shards vs unsharded {worst} > 1e-12")
            runner[opt] = dict(rows=len(got), mesh_ms=mesh_ms, plain_ms=plain_ms, max_rel_gap=worst,
                               bit_for_bit=got == want, launches=counts)
    emit("mesh_runner", shards=4, table="phase 20 stress table", **runner, limit=1e-12, **card)
    wall["26e runner"] = time.perf_counter() - t_phase

    # 26f. the path-sharded exposure and the reductions --------------------------------
    t_phase = time.perf_counter()
    val = dt.date(2025, 7, 28)
    tenors = np.asarray(XVA_TENORS)
    scen_days = list(XVA_SCEN_DAYS)
    dates = [val] + [val + dt.timedelta(days=d) for d in scen_days]
    times_days = np.array([0.0] + [float(d) for d in scen_days])
    swaps = xva_swaps(instruments, XVA_SWAPS)
    sim = HW1FCurveSimulator(HW1FParams.flat(alpha=0.05, sigma=0.01), tenors, np.full(tenors.size, 0.075),
                             device=dev)
    cube = sim.values_with_today(
        sim.simulate(np.asarray(scen_days) / 365.25, tenors, XVA_PATHS, seed=42, as_jax=True),
        tenors, XVA_PATHS, as_jax=True)
    plain_mtm = lambda: DeviceExposureEngine(dates, {"ZAR-SWAP": cube}, tenors, device=dev).mtm(swaps)
    sharded_cube = parallel.shard_batch(cube, mesh4, dim=1)
    mesh_mtm = lambda: DeviceExposureEngine(dates, {"ZAR-SWAP": sharded_cube}, tenors, device=dev).mtm(swaps)
    want = plain_mtm()
    got, counts = drive(mesh_mtm)
    mtm_gap = float((got - want).abs().max() / want.abs().max())
    check(tuple(got.shape) == (XVA_PATHS, len(dates)) and mtm_gap <= 1e-12,
          f"26f path-sharded MTM {tuple(got.shape)}: {mtm_gap:.3e} of max|MTM| > 1e-12")
    samples = np.random.default_rng(22).normal(5.0, 2.0, MESH_SAMPLES)
    mean, stderr = parallel.sharded_mean_stderr(torch.as_tensor(samples, device=dev), mesh4)
    mean_gap = abs(float(mean) - samples.mean()) / abs(samples.mean())
    se_want = samples.std(ddof=1) / math.sqrt(samples.size)
    se_gap = abs(float(stderr) - se_want) / se_want
    check(mean_gap <= 1e-12 and se_gap <= 1e-10, f"26f sharded_mean_stderr: {mean_gap:.3e}, {se_gap:.3e}")
    ee, pfe = parallel.sharded_exposure_profile(parallel.shard_batch(got, mesh4), mesh4)
    ref = exposure_profile(times_days, want.T)
    prof_gap = {"ee": float(np.abs(ee.cpu().numpy() - ref.ee).max() / np.abs(ref.ee).max()),
                "pfe": float(np.abs(pfe.cpu().numpy() - ref.pfe).max() / np.abs(ref.pfe).max())}
    check(max(prof_gap.values()) <= 1e-12, f"26f sharded_exposure_profile vs xva.cva {prof_gap} > 1e-12")
    emit("mesh_xva", shards=4, paths=XVA_PATHS, dates=len(dates), tenors=tenors.size, swaps=XVA_SWAPS,
         mtm_rel_gap=mtm_gap, mtm_ms=median_ms(mesh_mtm), unsharded_mtm_ms=median_ms(plain_mtm),
         launches=counts, samples=MESH_SAMPLES, mean_rel_gap=mean_gap, stderr_rel_gap=se_gap, profile_rel_gap=prof_gap,
         limits={"mtm": 1e-12, "mean": 1e-12, "stderr": 1e-10, "profile": 1e-12}, **card)
    del cube, sharded_cube, got, want
    wall["26f XVA and reductions"] = time.perf_counter() - t_phase

    # 26g. the driver entry points ------------------------------------------------------
    t_phase = time.perf_counter()
    fn, args = entry(device=dev)
    out = fn(*args)
    check(all(v.shape == (8,) and bool(torch.isfinite(v).all()) for v in out.values()), "26g entry() not finite")
    steps = dryrun_multichip(4, devices=[here] * 4)
    emit("mesh_entry", entry_outputs=sorted(out), dryrun_multichip_4=steps, **card)
    wall["26g entry points"] = time.perf_counter() - t_phase
    emit("mesh_phase_wall_s", **wall, total=sum(wall.values()), **card)
    return launches


def host_remainder_book(rng):
    """Phase 27a's book on ``REM_VAL``'s seeded ZAR curve (a knot every 30
    days to 31 years, forward-filled daily), as constructor arguments: 64
    zero-coupon bonds (1-30 years), 64 semi-annual fixed-rate bonds of
    2-30 years (their next coupons 1-180 days out, so that the value date
    falls before book close for some and inside the ex period for the
    rest), 16 inflation-linked bonds (issued 2012-2024, 2028-2050
    maturities) with a CPI history of 2010-2025, 16 inflation swaps and 64
    FRAs (3- and 6-month periods starting 1-24 months out)."""
    val = REM_VAL
    n = 31 * 365 // 30 + 2
    dates = [val - datetime.timedelta(days=30) + datetime.timedelta(days=30 * i) for i in range(n)]
    rates = 0.0725 + 0.02 * (1.0 - np.exp(-np.arange(n) / 40.0)) + rng.normal(0.0, 5e-4, n)

    def add_months(d, m):
        y, mo = divmod(d.month - 1 + m, 12)
        return datetime.date(d.year + y, mo + 1, min(d.day, 28))

    zcb = [dict(face_value=float(rng.uniform(1e5, 1e7)), maturity_date=add_months(val, 12 * int(y)))
           for y in rng.integers(1, 31, REM_BONDS)]
    frb = []
    for i in range(REM_BONDS):
        # half the next coupons within 12 days: inside the 10-business-day ex period
        ncd = val + datetime.timedelta(days=int(rng.integers(1, 13) if i % 2 else rng.integers(20, 181)))
        frb.append(dict(notional=100.0, issue_date=datetime.date(2010, 1, 1), value_date=val,
                        last_coupon_date=add_months(ncd, -6), next_coupon_date=ncd,
                        maturity_date=add_months(ncd, 12 * int(rng.integers(2, 31))),
                        coupon_rate=float(rng.uniform(0.065, 0.105)), frequency="semi-annual"))
    months = [datetime.date(2010 + m // 12, m % 12 + 1, 1) for m in range(15 * 12 + 7)]
    cpi = dict(zip(months, 70.0 * np.exp(np.cumsum(rng.normal(0.05 / 12, 0.003, len(months))))))
    ilb = [dict(issue_date=datetime.date(int(y), 3, 31), maturity_date=datetime.date(int(m), 3, 31),
                notional=float(rng.uniform(1e6, 5e7)), coupon_rate=float(rng.uniform(0.015, 0.035)),
                value_date=val, base_cpi=float(cpi[datetime.date(int(y) - 1, 11, 1)]))
           for y, m in zip(rng.integers(2012, 2025, REM_INFLATION), rng.integers(2028, 2051, REM_INFLATION))]
    ils = [dict(issue_date=datetime.date(int(y), 1, 31), maturity_date=datetime.date(int(m), 7, 31),
                notional=float(rng.uniform(1e6, 1e8)), fixed_rate=float(rng.uniform(0.02, 0.04)), value_date=val,
                float_frequency_months=int(f))
           for y, m, f in zip(rng.integers(2018, 2026, REM_INFLATION), rng.integers(2027, 2041, REM_INFLATION),
                              rng.choice([3, 6], REM_INFLATION))]
    fra = []
    for _ in range(REM_FRAS):
        period = int(rng.choice([3, 6]))
        settle = add_months(val, int(rng.integers(1, 25)))
        fra.append(dict(settle_date=settle, maturity_date=add_months(settle, period), strike_rate=0.075,
                        notional=float(rng.uniform(1e6, 1e8)),
                        frequency="quarterly" if period == 3 else "semi-annual"))
    return (dates, rates), cpi, zcb, frb, ilb, ils, fra


def host_remainder_panel(rng):
    """Phase 27b's history: 2,520 business days (ten years) of a 20-tenor
    ZAR swap curve, each tenor's log level an OU process (alpha 1.2 a
    year, 15% volatility, around 6.5-9.5%) driven by level, slope and
    curvature shocks plus its own, as :class:`calibration.Panel` with
    ``datetime.date`` rows and "ZAR-SWAP,<tenor>" columns."""
    from finite_difference_tpu_torch import calibration as cal

    tenors = np.array(REM_PCA_TENORS)
    x = np.log(tenors / 30.0 + 1.0)
    loadings = np.stack([np.ones_like(x), x - x.mean(), (x - x.mean()) ** 2 - ((x - x.mean()) ** 2).mean()])
    theta = np.log(0.065 + 0.03 * x / x.max())
    step = 1.0 / 252.0
    logs = np.empty((REM_PCA_DAYS, len(tenors)))
    logs[0] = theta
    shocks = rng.normal(size=(REM_PCA_DAYS, 3)) @ (loadings * np.array([[0.8], [0.5], [0.3]])) \
        + 0.3 * rng.normal(size=(REM_PCA_DAYS, len(tenors)))
    for i in range(1, REM_PCA_DAYS):
        logs[i] = logs[i - 1] + 1.2 * (theta - logs[i - 1]) * step + 0.15 * np.sqrt(step) * shocks[i]
    days, d = [], datetime.date(2015, 7, 1)
    while len(days) < REM_PCA_DAYS:
        if d.weekday() < 5:
            days.append(d)
        d += datetime.timedelta(days=1)
    return cal.Panel(days, [f"ZAR-SWAP,{t}" for t in tenors], np.exp(logs))


def host_remainder_market(directory: str, rng) -> str:
    """Phase 27c's RiskFlow market, written to ``directory``: for each of
    :data:`REM_FX` an FX vol surface of 12 expiries (one month to ten
    years) x 5 moneyness points (0.8-1.2, a smile on seeded ATM vols of
    6-30%, so that some variance curves decline), the stored GBM
    parameters and the market-price entry that names the surface."""
    expiries = (1 / 12, 2 / 12, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, 7.0, 10.0)
    factors, prices = {}, {}
    for ccy in REM_FX:
        atm = rng.uniform(0.06, 0.30, len(expiries))
        rows = [[m, t, v + 0.04 * (m - 1.0) ** 2 + 0.01 * (1.0 - m)]
                for t, v in zip(expiries, atm) for m in (0.8, 0.9, 1.0, 1.1, 1.2)]
        factors[f"FXVol.{ccy}"] = {"Surface": {".Curve": {"meta": [], "data": rows}}}
        factors[f"GBMAssetPriceTSModelParameters.{ccy}"] = {
            "Vol": {".Curve": {"meta": [], "data": [[t, float(v)] for t, v in zip(expiries, atm)]}},
            "Quanto_FX_Correlation": 0.0}
        prices[f"GBMAssetPriceTSModelPrices.{ccy}"] = {"instrument": {"Asset_Price_Volatility": ccy}}
    path = os.path.join(directory, "gbm_fx_market.json")
    with open(path, "w") as fh:
        json.dump({"MarketData": {"Price Factors": factors, "Price Models": {}, "Model Configuration": {},
                                  "Correlations": {}, "Market Prices": prices}}, fh)
    return path


def host_remainder_phases(card: dict) -> dict:
    """Phase 27, the host-only remainder: ``bonds``, the PCA and GBM-FX
    calibrations and the IR swap FA check. In both packages these are
    host Python and numpy, so each sub-phase checks that none of our
    kernels launched (the counts zeroed just before it and read after) and
    that the card's allocated memory did not change. Each reports host ms
    per call, the median of :data:`REM_CALLS` calls after a warm-up.
    Returns the launch counts summed over 27a-27d.

    - 27a, :func:`host_remainder_book`: the zero-coupon bonds' PV and PV01,
      the fixed-rate bonds' dirty, accrued, clean, YTM, val01 and gamma,
      the inflation-linked bonds' summaries and their forwards at 3 months
      (long and short at a strike of 95), the swaps' NPV and fair rate and
      the FRAs' forward and NPV. Checks: ZCB PV = face e^(-rT) within 1e-12
      relative (r the curve's NACC rate); the YTM round trip within 1e-10
      of the dirty price; accrued >= 0 before book close and < 0 inside
      the ex period, both present; a forward at its default strike, a swap
      at its fair rate and an FRA at its forward price to 0 within 1e-8 of
      notional; long = -short for the forwards and FRAs, pay = -receive for
      the swaps, within 1e-12 relative.
    - 27b, ``calibrate_pca_interest_rate`` on :func:`host_remainder_panel`
      with 3 factors, and once at full rank. Checks: the eigenvalues
      descend; at full rank aki @ aki.T equals the covariance (outer(vols)
      x correlation) within 1e-10 of its largest entry.
    - 27c, ``run_gbm_fx_calibration`` on :func:`host_remainder_market` with
      CSV export. Checks: every corrected variance curve (avg vol^2 x T)
      is non-decreasing within 1e-12; two CSVs per currency.
    - 27d, ``run_irswap_fa_check(334439.05, -27800.25)``. Checks: the pay
      and receive PVs equal the synthetic goldens (JAX's test pins them)
      within 1e-12 relative.
    """
    import gc
    import statistics
    import tempfile

    import torch

    from finite_difference_tpu_torch import bonds, calibration as cal, kernels
    from finite_difference_tpu_torch.instruments.schedule import get_calendar
    from finite_difference_tpu_torch.market_data import HistoricalCPI
    from finite_difference_tpu_torch.runners import run_irswap_fa_check
    from finite_difference_tpu_torch.utils.curves import DailyNacaCurve, flat_curve

    wall, launches, allocated = {}, {}, {}

    def measured(label, fn):
        """(fn()'s result, median host ms of REM_CALLS calls after a warm-up),
        holding that ``fn`` launched no kernel of ours and left the card's
        allocated memory as it was."""
        # earlier phases' garbage cycles may still hold card tensors: collect
        # them first, so that only this path's own use shows
        gc.collect()
        kernels.reset_launch_counts()
        held = torch.cuda.memory_allocated()
        out = fn()
        ms = statistics.median(host_ms(fn)[1] for _ in range(REM_CALLS))
        launches[label] = dict(kernels.launch_counts)
        allocated[label] = torch.cuda.memory_allocated() - held
        check(not any(launches[label].values()), f"phase {label} launched a kernel of ours: {launches[label]}")
        check(allocated[label] == 0, f"phase {label} changed the card's allocated memory by {allocated[label]} B")
        return out, ms

    def device_use(sub: str) -> dict:
        """The launches of our kernels and the change of the card's allocated
        bytes over sub-phase ``sub``'s calls."""
        labels = [k for k in launches if k.split()[0] == sub]
        return dict(launches=sum(sum(launches[k].values()) for k in labels),
                    cuda_allocated_change_bytes=sum(allocated[k] for k in labels))

    rng = np.random.default_rng(REM_SEED)
    # 27a. bonds ----------------------------------------------------------------------
    t_phase = time.perf_counter()
    curve_points, cpi_map, zcb_kw, frb_kw, ilb_kw, ils_kw, fra_kw = host_remainder_book(rng)
    curve = DailyNacaCurve(curve_points, REM_VAL)
    flat = flat_curve(REM_FLAT_NACA, REM_VAL, end=REM_VAL + datetime.timedelta(days=31 * 366))
    infl_df = lambda d: math.exp(-0.05 * (d - REM_VAL).days / 365.0)
    cpi = HistoricalCPI(REM_VAL, cpi_map, discount_factor_fn=infl_df, extend_cpi=360)
    ms_by = {}

    def zero_coupon():
        out = []
        for kw in zcb_kw:
            p = bonds.ZeroCouponBondPricer(bonds.ZeroCouponBond(**kw), flat)
            out.append((p.present_value(), p.pv01()))
        return out

    def fixed_rate():
        out = []
        for kw in frb_kw:
            pr = bonds.FixedRateBondPricer(bonds.FixedRateBond(**kw), curve)
            ytm = pr.yield_to_maturity()
            out.append(dict(dirty=pr.dirty_price(), accrued=pr.accrued_amount(), clean=pr.clean_price(), ytm=ytm,
                            round_trip=pr._dirty_from_yield(ytm), val01=pr.val01(yield_to_maturity=ytm),
                            gamma=pr.gamma(yield_to_maturity=ytm)))
        return out

    def inflation_bonds():
        out = []
        for kw in ilb_kw:
            bond = bonds.InflationLinkedBondPricer(discount_curve=curve, historical_cpi=cpi, **kw)
            fwd_date = REM_VAL + datetime.timedelta(days=91)
            at_fwd = bonds.ForwardInflationBondPricer(bond, fwd_date)
            long, short = (bonds.ForwardInflationBondPricer(bond, fwd_date, strike_price=95.0, position=p).npv()
                           for p in ("long", "short"))
            out.append(dict(spot=bond.summary(), forward=at_fwd.summary(), long=long, short=short,
                            notional=bond.notional))
        return out

    def inflation_swaps():
        out = []
        for kw in ils_kw:
            pricers = [bonds.InflationLinkedSwapPricer(bonds.InflationLinkedSwap(
                historical_cpi=cpi, yield_curve=curve, pay_fixed_leg=pay, **kw)) for pay in (True, False)]
            fair = pricers[0].fair_fixed_rate()
            at_fair = bonds.InflationLinkedSwapPricer(bonds.InflationLinkedSwap(
                historical_cpi=cpi, yield_curve=curve, **{**kw, "fixed_rate": fair})).npv()
            out.append(dict(pay=pricers[0].npv(), receive=pricers[1].npv(), fair=fair, at_fair=at_fair,
                            notional=kw["notional"]))
        return out

    def fras():
        out = []
        for kw in fra_kw:
            long, short = (bonds.ForwardRateAgreementPricer(bonds.ForwardRateAgreement(position=p, **kw), curve)
                           for p in ("long", "short"))
            fwd = long.forward_rate()
            at_fwd = bonds.ForwardRateAgreementPricer(
                bonds.ForwardRateAgreement(position="long", **{**kw, "strike_rate": fwd}), curve).npv()
            out.append(dict(forward=fwd, long=long.npv(), short=short.npv(), at_forward=at_fwd,
                            notional=kw["notional"]))
        return out

    results = {}
    for name, fn in (("zero_coupon", zero_coupon), ("fixed_rate", fixed_rate),
                     ("inflation_bond", inflation_bonds), ("inflation_swap", inflation_swaps), ("fra", fras)):
        results[name], ms_by[name] = measured(f"27a {name}", fn)
    zcb_gap = max(abs(pv - kw["face_value"] * math.exp(-math.log1p(REM_FLAT_NACA) * flat.year_fraction(
        REM_VAL, kw["maturity_date"]))) / pv for (pv, _), kw in zip(results["zero_coupon"], zcb_kw))
    frb = results["fixed_rate"]
    round_trip = max(abs(b["round_trip"] - b["dirty"]) for b in frb)
    cal_sa = get_calendar("SouthAfrica")
    ex = [REM_VAL >= cal_sa.add_working_days(kw["next_coupon_date"], -10) for kw in frb_kw]
    check(all((b["accrued"] < 0) == e for b, e in zip(frb, ex)) and 0 < sum(ex) < len(ex),
          f"27a accrued against book close: {sum(ex)} of {len(ex)} ex")
    check(all(b["val01"] > 0 and b["gamma"] > 0 and abs(b["clean"] - (b["dirty"] - b["accrued"])) <= 1e-12 * b["dirty"]
              for b in frb), "27a val01, gamma or clean price")
    zero_gap = max(
        [abs(b["forward"]["npv"]) / b["notional"] for b in results["inflation_bond"]]
        + [abs(s["at_fair"]) / s["notional"] for s in results["inflation_swap"]]
        + [abs(f["at_forward"]) / f["notional"] for f in results["fra"]])
    sign_gap = max(
        [abs(b["long"] + b["short"]) / abs(b["long"]) for b in results["inflation_bond"]]
        + [abs(s["pay"] + s["receive"]) / abs(s["pay"]) for s in results["inflation_swap"]]
        + [abs(f["long"] + f["short"]) / abs(f["long"]) for f in results["fra"]])
    check(zcb_gap <= 1e-12, f"27a ZCB PV vs face e^(-rT): {zcb_gap:.3e} > 1e-12")
    check(round_trip <= 1e-10, f"27a YTM round trip: {round_trip:.3e} > 1e-10")
    check(zero_gap <= 1e-8, f"27a NPV at the fair strike or rate: {zero_gap:.3e} > 1e-8 of notional")
    check(sign_gap <= 1e-12, f"27a long vs short: {sign_gap:.3e} > 1e-12")
    emit("host_remainder_bonds", zero_coupon=len(zcb_kw), fixed_rate=len(frb_kw), ex_coupon=sum(ex),
         inflation_bonds=len(ilb_kw), inflation_swaps=len(ils_kw), fras=len(fra_kw), ms=ms_by,
         book_ms=sum(ms_by.values()), zcb_vs_closed_form=zcb_gap, ytm_round_trip=round_trip,
         fair_npv_over_notional=zero_gap, long_plus_short=sign_gap,
         ytm_range=[min(b["ytm"] for b in frb), max(b["ytm"] for b in frb)],
         limits={"zcb": 1e-12, "ytm_round_trip": 1e-10, "fair_npv": 1e-8, "long_short": 1e-12},
         **device_use("27a"), **card)
    wall["27a bonds"] = time.perf_counter() - t_phase

    # 27b. PCA ------------------------------------------------------------------------
    t_phase = time.perf_counter()
    panel = host_remainder_panel(rng)
    info, pca_ms = measured("27b", lambda: cal.calibrate_pca_interest_rate(panel, num_factors=REM_PCA_FACTORS))
    full, full_ms = measured("27b full",
                             lambda: cal.calibrate_pca_interest_rate(panel, num_factors=len(REM_PCA_TENORS)))
    stats, correlation = cal.compute_curve_statistics(panel)[:2]
    vols = stats["Reversion Volatility"]
    covariance = np.outer(vols, vols) * correlation.values
    aki = full.correlation_coef.T
    recon = float(np.abs(aki @ aki.T - covariance).max() / np.abs(covariance).max())
    evals = [e["Eigenvalue"] for e in full.param["Eigenvectors"]]
    check(bool(np.isfinite(covariance).all()), "27b covariance not finite")
    check(all(a >= b for a, b in zip(evals, evals[1:])), "27b eigenvalues do not descend")
    check(recon <= 1e-10, f"27b aki aki^T vs covariance: {recon:.3e} > 1e-10")
    top = [e["Eigenvalue"] for e in info.param["Eigenvectors"]]
    emit("host_remainder_pca", days=len(panel.index), tenors=len(panel.columns), factors=REM_PCA_FACTORS,
         ms=pca_ms, full_rank_ms=full_ms, eigenvalues=top, explained=sum(top) / sum(evals),
         reversion_speed=info.param["Reversion_Speed"], reconstruction=recon, limits={"reconstruction": 1e-10},
         **device_use("27b"), **card)
    wall["27b PCA"] = time.perf_counter() - t_phase

    # 27c. GBM FX ---------------------------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = host_remainder_market(tmp, rng)
        out_dir = os.path.join(tmp, "csv")
        (calibrated, comparisons), fx_ms = measured(
            "27c", lambda: cal.run_gbm_fx_calibration(path, output_dir=out_dir))
        written = sorted(os.listdir(out_dir))
    worst = min(float(np.diff(np.array(c["expiries"]) * np.array([v for _, v in c["Vol"]]) ** 2).min())
                for c in calibrated.values())
    corrected = sorted(k for k, c in calibrated.items() if c["corrected"])
    check(sorted(calibrated) == sorted(REM_FX) and len(written) == 2 * len(REM_FX),
          f"27c currencies {sorted(calibrated)}, files {len(written)}")
    check(worst >= -1e-12, f"27c a corrected variance curve declines by {-worst:.3e} > 1e-12")
    check(bool(corrected), "27c no variance curve needed correcting")
    emit("host_remainder_gbm_fx", currencies=len(calibrated),
         expiries=len(next(iter(calibrated.values()))["expiries"]), moneyness=5, corrected=corrected, min_variance_step=worst, csv_files=len(written),
         comparison_rows=sum(len(r) for r in comparisons.values()), ms=fx_ms, limits={"variance_decline": 1e-12},
         **device_use("27c"), **card)
    wall["27c GBM FX"] = time.perf_counter() - t_phase

    # 27d. IR swap FA check -----------------------------------------------------------
    t_phase = time.perf_counter()
    fa, fa_ms = measured("27d", lambda: run_irswap_fa_check(*REM_FA_FIGURES, verbose=False))
    gaps = {k: abs(fa[k] - REM_FA_GOLDENS[k]) / abs(REM_FA_GOLDENS[k]) for k in REM_FA_GOLDENS}
    check(max(gaps.values()) <= 1e-12, f"27d pay/receive PV vs the goldens: {gaps}")
    emit("host_remainder_irswap_fa", pay_pv=fa["pay_pv"], receive_pv=fa["receive_pv"], total_pv=fa["total_pv"],
         vs_goldens=gaps, ms=fa_ms, limits={"vs_goldens": 1e-12}, **device_use("27d"), **card)
    wall["27d IR swap FA"] = time.perf_counter() - t_phase

    emit("host_remainder_phase_wall_s", **wall, total=sum(wall.values()), **card)
    return {k: sum(c.get(k, 0) for c in launches.values()) for k in kernels.launch_counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from finite_difference_tpu_torch import kernels
    from finite_difference_tpu_torch.models.pde import spike
    from finite_difference_tpu_torch.models.pde.batch import (
        _spike_schedule_impl,
        build_trade_batch,
        price_barrier_batch,
    )

    # the plain versions and the references use no reduced precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = {"name": name, "nvidia_smi": smi}
    t0 = time.perf_counter()
    log = kernels.build()
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    emit("device", name=name, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0, ptxas=ptxas)

    # 2. kernel against its plain version on the card -----------------------
    # (main width: one warp per trade at P=32, and P/32 warps at P=64, the
    # batch-size rule's choice for B=256, and at P=128)
    limits = {torch.float64: 1e-11, torch.float32: 2e-4}
    for label, kw_fn, n_nodes, p_list in (
        ("small", lambda: mixed_trades(8, 32, 127), 128, (None,)),
        ("main_width", lambda: bench_trades(B_CHECK)[0], N_NODES, SPIKE_P_CHECKED),
    ):
        for P_req in p_list:
            for dtype, limit in limits.items():
                tb = build_trade_batch(dtype=dtype, device=dev, **kw_fn())
                segments, set_defs = spike.default_segments(tb.n_steps)
                prep = spike.prepare_spike(tb, tb.sigma, n_nodes, P_req, set_defs)
                v_k, e_k = spike.march_segments(tb, prep, segments, step=kernels.spike_march_cuda)
                v_r, e_r = spike.march_segments(tb, prep, segments, step=spike.spike_march_reference)
                torch.cuda.synchronize()
                scale = float(v_r.abs().max())
                err = max(float((v_k - v_r).abs().max()), float((e_k - e_r).abs().max()))
                emit("kernel_vs_plain", size=label, dtype=str(dtype), B=tb.batch_size,
                     N=n_nodes, steps=tb.n_steps, P=prep.P, max_abs_err=err, max_abs_v=scale,
                     ratio=err / scale, limit=limit)
                check(math.isfinite(err) and err <= limit * scale,
                      f"kernel vs plain {label} P={prep.P} {dtype}: {err / scale:.3e} > {limit}")

    # 3. the main path ------------------------------------------------------
    kw, spots, sigmas = bench_trades(B_MAIN)
    tb = build_trade_batch(dtype=torch.float32, device=dev, **kw)
    kernels.reset_launch_counts()
    out_p = price_barrier_batch(tb, N_NODES, with_greeks=False, solver="spike")
    out_g = price_barrier_batch(tb, N_NODES, with_greeks=True, solver="spike")
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    check(launches["spike_march_f32"] > 0, "the main path launched no spike_march kernel")
    for key, val in {**out_p, **out_g}.items():
        check(val.shape == (B_MAIN,) and bool(torch.isfinite(val).all()), f"{key} not finite")
    price = out_p["price"].double().cpu().numpy()
    bs = black_scholes_call(spots, sigmas)
    bs_err = float(np.max(np.abs(price - bs) / np.maximum(bs, 1e-8)))

    tb64 = build_trade_batch(dtype=torch.float64, device=dev, **bench_trades(B_CHECK)[0])
    out64 = price_barrier_batch(tb64, N_NODES, with_greeks=True, dv_sigma=1e-2, solver="spike")
    f32_vs_f64 = {}
    for key, val in out64.items():
        ref = val.cpu().numpy()
        got = out_g[key][:B_CHECK].double().cpu().numpy()
        if key == "price":
            f32_vs_f64[key] = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-8)))
        else:
            f32_vs_f64[key] = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    limits_f64 = {"price": 1e-3, "delta": 1e-2, "gamma": 1e-2, "theta": 1e-2, "vega": 5e-2}
    emit("main_path", B=B_MAIN, N=N_NODES, steps=N_STEPS, dtype="float32", solver="spike",
         launches=launches, far_barrier_max_rel_err_vs_bs=bs_err,
         f32_vs_f64_first_256=f32_vs_f64, limits=limits_f64, **card)
    check(bs_err <= 1e-3, f"far-barrier price vs Black–Scholes {bs_err:.3e} > 1e-3")
    for key, lim in limits_f64.items():
        check(f32_vs_f64[key] <= lim, f"f32 vs f64 {key}: {f32_vs_f64[key]:.3e} > {lim}")

    # 4. timing -------------------------------------------------------------
    def grids_per_s(with_greeks: bool, iters: int) -> float:
        price_barrier_batch(tb, N_NODES, with_greeks=with_greeks, solver="spike")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            price_barrier_batch(tb, N_NODES, with_greeks=with_greeks, solver="spike")
        torch.cuda.synchronize()
        return B_MAIN * iters / (time.perf_counter() - t0)

    gps = grids_per_s(False, 10)
    gps_greeks = grids_per_s(True, 5)

    # where one price-only call's time goes: schedule inspection, host prep,
    # the kernel, the rest; on the main path's own segments and prep
    sched, sched_ms = host_ms(lambda: _spike_schedule_impl(tb, N_NODES))
    check(sched is not None, "the main path's batch is not SPIKE-eligible")
    segments, set_defs = sched[:2]
    prep, prep_ms = host_ms(lambda: spike.prepare_spike(tb, tb.sigma, N_NODES, None, set_defs))
    march = lambda step: spike.march_segments(tb, prep, segments, step=step)
    ms = cuda_ms(lambda: march(kernels.spike_march_cuda), reps=10)
    k0, k1, t_cn = segments[-1]
    ms_cn_launch = cuda_ms(
        lambda: kernels.spike_march_cuda(prep, t_cn, prep.v0, prep.edge0, k0, k1), reps=10
    )
    (v_r, e_r), plain_ms = host_ms(lambda: march(spike.spike_march_reference))

    # the kernel against its plain version at the main path's own shapes
    v_k, e_k = march(kernels.spike_march_cuda)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    main_err = max(float((v_k - v_r).abs().max()), float((e_k - e_r).abs().max()))
    emit("kernel_vs_plain", size="main_path", dtype=str(torch.float32), B=B_MAIN, N=N_NODES,
         steps=N_STEPS, P=prep.P, max_abs_err=main_err, max_abs_v=scale,
         ratio=main_err / scale, limit=limits[torch.float32])
    check(math.isfinite(main_err) and main_err <= limits[torch.float32] * scale,
          f"kernel vs plain main path: {main_err / scale:.3e} > {limits[torch.float32]}")
    del v_r, e_r, v_k, e_k

    bound_ms, bound_by, cost = bound(prep, segments)
    call_ms = B_MAIN / gps * 1e3
    emit("timing", grids_per_s=gps, greeks_grids_per_s=gps_greeks, call_ms=call_ms,
         schedule_ms=sched_ms, prep_ms=prep_ms,
         rest_ms=call_ms - sched_ms - prep_ms - ms, kernel_ms_per_march=ms,
         launches_per_march=len(segments), kernel_ms_per_cn_launch=ms_cn_launch,
         cn_launch_steps=k1 - k0, plain_ms_per_march=plain_ms, **cost, **residency(prep),
         bound_ms=bound_ms, bound_by=bound_by, B=B_MAIN, N=N_NODES, steps=N_STEPS, P=prep.P,
         **card)
    emit("profile", **profile_call(
        lambda: price_barrier_batch(tb, N_NODES, with_greeks=False, solver="spike"), call_ms), **card)
    del tb, prep
    k1 = dict(name="spike_march_f32", launches=launches["spike_march_f32"],
              replaces="finite_difference_tpu/models/pde/pallas_kernel.py:589",
              max_abs_err=main_err, max_abs_err_over_max_abs_v=main_err / scale,
              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    wall = {"1-4 build, K1 and the barrier path": time.perf_counter() - t0}

    # 4b. K5, the knock-in parity, on the barrier cells' own requests -------------
    t1 = time.perf_counter()
    k5 = ki_parity_phases(dev, card)
    wall["4b K5, knock-in parity"] = time.perf_counter() - t1

    # 5-8. the American path ------------------------------------------------
    t1 = time.perf_counter()
    k1a, k2 = american_phases(dev, card, limits)
    for k in (k1, k1a, k2):
        k["source"] = "finite_difference_tpu_torch/csrc/spike_march.cu"
    wall["5-8 the American path"] = time.perf_counter() - t1

    # 9-12. the fused marches -------------------------------------------------
    t1 = time.perf_counter()
    k3, k4 = fused_phases(dev, card, limits)
    wall["9-12 the fused marches"] = time.perf_counter() - t1
    ks = (k1, k1a, k2, k3, k4, k5)

    # 13-14. what the SPIKE P rule and the CR launch rest on ---------------------
    t1 = time.perf_counter()
    rule_phases(dev, card)
    wall["13-14 the P rule and the CR sweep"] = time.perf_counter() - t1

    # 15-18. the spectral route, ad greeks, surfaces, auto's rule ---------------
    t1 = time.perf_counter()
    spectral_phases(dev, card)
    wall["15-18 spectral, ad, surfaces, route sweep"] = time.perf_counter() - t1

    # 19. the serving path ------------------------------------------------------
    t1 = time.perf_counter()
    serving_launches = serving_phases(dev, card)
    for k in ks:
        k["serving_launches"] = serving_launches.get(k["name"], 0)
    wall["19 serving"] = time.perf_counter() - t1

    # 20. the FA-validation path ------------------------------------------------
    t1 = time.perf_counter()
    fa_launches = fa_phases(dev, card)
    for k in ks:
        k["fa_launches"] = fa_launches.get(k["name"], 0)
    wall["20 FA validation"] = time.perf_counter() - t1

    # 21. the rest of the FA-validation layer -------------------------------------
    t1 = time.perf_counter()
    fa_analytics_phases(dev, card)
    wall["21 FA analytics"] = time.perf_counter() - t1

    # 22. the Monte Carlo layer ----------------------------------------------------
    t1 = time.perf_counter()
    mc_phases(dev, card)
    wall["22 Monte Carlo"] = time.perf_counter() - t1

    # 23. the XVA exposure path -----------------------------------------------------
    t1 = time.perf_counter()
    xva_launches = xva_phases(dev, card)
    for k in ks:
        k["xva_launches"] = xva_launches.get(k["name"], 0)
    wall["23 XVA exposure"] = time.perf_counter() - t1

    # 24. the rest of the XVA engine ---------------------------------------------------
    t1 = time.perf_counter()
    xva_rest_launches = xva_rest_phases(dev, card)
    for k in ks:
        k["xva_rest_launches"] = xva_rest_launches.get(k["name"], 0)
    wall["24 rest of XVA"] = time.perf_counter() - t1

    # 25. the scenario layer and the CS and HW1F calibration ------------------------------
    t1 = time.perf_counter()
    scenario_launches = scenario_phases(dev, card)
    for k in ks:
        k["scenario_launches"] = scenario_launches.get(k["name"], 0)
    wall["25 scenarios and calibration"] = time.perf_counter() - t1

    # 26. the device mesh -----------------------------------------------------------------
    t1 = time.perf_counter()
    mesh_launches = mesh_phases(dev, card)
    for k in ks:
        k["mesh_launches"] = mesh_launches.get(k["name"], 0)
    check(all(mesh_launches.get(k["name"], 0) > 0 for k in (k1, k1a, k2)),
          f"phase 26 did not launch K1, K1a and K2 over the mesh: {mesh_launches}")
    wall["26 device mesh"] = time.perf_counter() - t1

    # 27. the host-only remainder -----------------------------------------------------------
    t1 = time.perf_counter()
    remainder_launches = host_remainder_phases(card)
    for k in ks:
        k["host_remainder_launches"] = remainder_launches.get(k["name"], 0)
    wall["27 host remainder"] = time.perf_counter() - t1
    emit("phase_wall_s", **wall, total=time.perf_counter() - t0)

    # 15. summary -----------------------------------------------------------
    # library_ms is null for every kernel: no PyTorch call computes these
    # marches, torch has no batched tridiagonal solve, and no library call
    # prices the knock-in parity's bumped vanilla legs
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", **k, "library_ms": None}
        for k in ks
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
