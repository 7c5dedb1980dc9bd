"""Device meshes and sharded reductions (counterpart of ``finite_difference_tpu.parallel``).

A mesh is a single-controller list of devices (:class:`mesh.Mesh`): the
drivers (``price_barrier_batch``, ``price_american_batch`` and its
Richardson twin, ``mesh=``), the services, the batched runners and the
device exposure engine (a path-sharded cube) split their trade or path
axis over it, one shard per device, and gather the results on the
caller's device.
"""
from .mesh import make_mesh, shard_batch, batch_pspec
from .reductions import sharded_exposure_profile, sharded_mean_stderr

__all__ = [
    "make_mesh",
    "shard_batch",
    "batch_pspec",
    "sharded_exposure_profile",
    "sharded_mean_stderr",
]
