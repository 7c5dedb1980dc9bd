"""Batched Crank–Nicolson barrier and American pricing (counterpart of ``finite_difference_tpu.models.pde``).

- :mod:`.grid` — host numpy grids and schedules;
- :mod:`.batch` — the trade batch, ``build_trade_batch`` /
  ``price_barrier_batch`` and ``build_american_batch`` /
  ``price_american_batch`` (the main paths), ``solve_value_surfaces``;
- :mod:`.stepper` — the batched CN step loop (``solver="scan"``);
- :mod:`.spectral` — the sine-basis propagator (``solver="spectral"``,
  ``"spectral_x64dst"``, ``"spectral_mixed"``): DST matmuls between monitor
  dates;
- :mod:`.spike` — the SPIKE march host prep, its plain reference and the
  dispatch to the CUDA kernel (``solver="spike"``);
- :mod:`.fused` — the fused march with Hillis–Steele scans
  (``price_barrier_batch_fused``, ``cn_barrier_solve_fused``);
- :mod:`.cr` — the fused march with cyclic reduction
  (``cn_barrier_solve_cr``).
"""
