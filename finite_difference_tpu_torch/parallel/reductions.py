"""Sharded reductions for MC and scenario-table aggregation.

Counterpart of ``finite_difference_tpu.parallel.reductions``. The
reference's only cross-path interaction is reduce-at-the-end (running
price/stderr sums, mc_discrete_barrier_option.py:392-415; EE/PFE
quantiles, cva.py:47-82). Each shard reduces on its own device; the
partials move to the mesh's first device and are added there (the JAX
package's ``psum``), and a quantile concatenates the shards there (its
``all_gather``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .mesh import Mesh, Sharded, shard_batch


def _sharded(values, mesh: Mesh, axis_name: str) -> Sharded:
    """``values`` split along dim 0 over ``axis_name`` of ``mesh``: as given
    where it already is, else (a plain tensor, or a Sharded value laid out
    otherwise) sharded first."""
    if (isinstance(values, Sharded) and values.mesh is mesh and values.axis_name == axis_name
            and values.dim == 0):
        return values
    return shard_batch(values, mesh, axis_name)


def sharded_mean_stderr(values, mesh: Mesh, axis_name: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, stderr) of a path-sharded 1-D sample, 0-d tensors on the
    first shard's device.

    Each shard sums n, s1 = sum(v) and s2 = sum(v^2) on its device; the
    partials are added on the first; then the JAX package's one-pass
    formula, var = max(s2/n - mean^2, 0) * n / max(n - 1, 1).
    """
    sh = _sharded(values, mesh, axis_name)
    home = sh.shards[0].device
    parts = [torch.stack([torch.tensor(float(v.shape[0]), dtype=v.dtype, device=v.device), v.sum(), (v * v).sum()])
             for v in sh.shards]
    n, s1, s2 = sum(p.to(home) for p in parts)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0) * n / torch.clamp_min(n - 1.0, 1.0)
    return mean, torch.sqrt(var / n)


def sharded_exposure_profile(
    mtm, mesh: Mesh, axis_name: str = "data", quantile: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(EE, PFE) per date of a path-sharded (n_paths, n_times) MTM, on the
    first shard's device.

    EE is the sum of the shards' per-date sums of max(MTM, 0) over n. The
    PFE quantile needs the whole distribution: the shards' exposures are
    concatenated on the first device and reduced there by
    ``xva.cva.quantile_linear`` (``jnp.quantile``'s linear rule, one sort;
    ``torch.quantile`` refuses more than 2^24 elements).
    """
    from ..xva.cva import quantile_linear  # xva imports the drivers, which import the mesh

    sh = _sharded(mtm, mesh, axis_name)
    home = sh.shards[0].device
    exposure = [torch.clamp_min(m, 0.0) for m in sh.shards]
    n = float(sum(sh.sizes))
    ee = sum(e.sum(dim=0).to(home) for e in exposure) / n
    pfe = quantile_linear(torch.cat([e.to(home) for e in exposure]), quantile, dim=0)
    return ee, pfe
