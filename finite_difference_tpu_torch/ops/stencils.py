"""Delta/gamma stencils on batched FD value grids.

Counterpart of ``finite_difference_tpu.ops.stencils.nonuniform_central``:
the 3-point non-uniform central stencil
(discrete_barrier_fdm_pricer.py:905-960, the live production path).
"""
from __future__ import annotations

import torch


def nonuniform_central(s: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
    """3-point non-uniform central (delta, gamma) at node ``idx`` of each row.

    ``s``, ``v``: (B, N) node locations and values; ``idx``: (B,) interior
    node indices (1 <= idx <= N-2). Returns two (B,) tensors.
    """
    at = lambda a, off: torch.gather(a, 1, (idx + off)[:, None])[:, 0]
    s_m, s_0, s_p = at(s, -1), at(s, 0), at(s, 1)
    v_m, v_0, v_p = at(v, -1), at(v, 0), at(v, 1)
    h1 = s_0 - s_m
    h2 = s_p - s_0
    delta = (
        -h2 / (h1 * (h1 + h2)) * v_m
        + (h2 - h1) / (h1 * h2) * v_0
        + h1 / (h2 * (h1 + h2)) * v_p
    )
    gamma = 2.0 * (
        v_m / (h1 * (h1 + h2)) - v_0 / (h1 * h2) + v_p / (h2 * (h1 + h2))
    )
    return delta, gamma
