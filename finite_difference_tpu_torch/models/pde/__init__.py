"""Batched Crank–Nicolson barrier pricing (counterpart of ``finite_difference_tpu.models.pde``).

- :mod:`.grid` — host numpy grids and schedules;
- :mod:`.batch` — the trade batch, ``build_trade_batch`` and
  ``price_barrier_batch`` (the main path);
- :mod:`.stepper` — the batched CN step loop (``solver="scan"``);
- :mod:`.spike` — the SPIKE march host prep, its plain reference and the
  dispatch to the CUDA kernel (``solver="spike"``).
"""
