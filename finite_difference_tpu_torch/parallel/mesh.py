"""Device meshes for trade- and path-sharded sweeps.

Counterpart of ``finite_difference_tpu.parallel.mesh``. The JAX package
builds a ``jax.sharding.Mesh`` and lets XLA place and partition the arrays;
torch has no SPMD partitioner and no single-process mesh
(``torch.distributed.DeviceMesh`` wants one process per card). The port's
mesh is a single-controller list of devices:

- a shard is a slice of the trade (or path) axis, placed on its device;
- the one host thread issues each shard's work to its device;
- a "psum" is per-shard partial sums moved to the mesh's first device and
  added there, an "all_gather" a ``torch.cat`` on that device.

Every pricing workload here is embarrassingly parallel across trades or
paths, so collectives appear only in the reductions
(:mod:`.reductions`).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """An N-D array of ``torch.device``\\ s with one name per axis; stands in
    for ``jax.sharding.Mesh``.

    A mesh may repeat a device. torch has no virtual devices (JAX's CPU
    backend can fake eight), so a mesh of ``["cpu"] * 8`` is how the CPU
    runs an 8-way split, and ``["cuda:0"] * 4`` how one card runs a 4-way
    one: the split, the padding, the per-shard launches and the gather are
    those of four cards, the overlap across cards is not. Every device is
    of one type (ValueError otherwise); a CUDA device must exist.
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        devs = np.empty(np.shape(self.devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            devs[i] = torch.device(d)
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {devs.shape} needs {devs.ndim} distinct axis names, got {names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs.flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        resolve_device(devs.flat[0])
        indices = {d.index for d in devs.flat if d.type == "cuda"} - {None}
        if indices and max(indices) >= torch.cuda.device_count():
            raise ValueError(f"mesh devices cuda:{sorted(indices)}: torch sees only "
                             f"{torch.cuda.device_count()} CUDA devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_devices(self, name: str) -> Tuple[torch.device, ...]:
        """The devices along axis ``name``, at index 0 of every other axis:
        sharding over one named axis of an N-D mesh places shard i there
        (and replicates nothing over the other axes)."""
        ax = self._axis(name)
        index = [0] * self.devices.ndim
        index[ax] = slice(None)
        return tuple(self.devices[tuple(index)])

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} is not one of the mesh's {self.axis_names}")
        return self.axis_names.index(name)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``.

    Default: a 1-D ``"data"`` mesh over every visible CUDA device (without
    a card this raises, as the port's entry points do). ``devices`` takes an
    explicit list, the only way to a CPU mesh or one that repeats a device
    (``["cpu"] * 8``, ``["cuda:0"] * 4``). ``shape`` + ``axis_names`` make an
    N-D mesh; the product of ``shape`` must be the device count.
    """
    if devices is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        if n_devices is not None and n_devices > count:
            raise ValueError(
                f"make_mesh({n_devices}) needs {n_devices} CUDA devices but torch sees "
                f"only {count}; a mesh that repeats a device, or one on the CPU, is "
                f"asked for by name: make_mesh({n_devices}, devices=['cuda:0'] * "
                f"{n_devices}) or devices=['cpu'] * {n_devices}"
            )
        devs = [torch.device("cuda", i) for i in range(count if n_devices is None else n_devices)]
    else:
        devs = list(devices)
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"make_mesh({n_devices}) was given only {len(devs)} devices")
            devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {math.prod(shape)} devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def check_mesh(mesh, device=None) -> Optional[Mesh]:
    """The :class:`Mesh` that ``mesh`` names, of ``device``'s type where one
    is given (ValueError otherwise), or None for None.

    A mesh may be named as data, as a configuration file holds it: an int
    n is ``make_mesh(n)``, a 1-D ``"data"`` mesh over the first n CUDA
    devices (without a card it raises as :func:`make_mesh` does); a list or
    tuple of device names is ``make_mesh(devices=...)``. A :class:`Mesh` is
    taken as it is. The JAX package's services take only a
    ``jax.sharding.Mesh``."""
    if mesh is None:
        return None
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        mesh = make_mesh(mesh)
    elif isinstance(mesh, (list, tuple)):
        mesh = make_mesh(devices=mesh)
    if not isinstance(mesh, Mesh):
        raise ValueError(
            f"mesh must be None, a device count, a list of device names or a "
            f"finite_difference_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}"
        )
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"the mesh's devices are {mesh.device_type}, the call's device is {device}")
    return mesh


class BatchSpec(NamedTuple):
    """Where a sharded axis goes: dim ``dim`` split over ``axis_name`` of
    ``mesh`` (the port's ``NamedSharding(mesh, P(axis_name))``)."""

    mesh: Mesh
    axis_name: str
    dim: int


def batch_pspec(mesh: Mesh, axis_name: str = "data", dim: int = 0) -> BatchSpec:
    """The spec that splits axis ``dim`` (the leading batch axis by default)
    across ``axis_name`` of ``mesh``."""
    mesh._axis(axis_name)
    return BatchSpec(mesh, axis_name, dim)


@dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor split along ``dim`` over ``axis_name`` of ``mesh``: the
    shards in order, shard i on the axis's i-th device."""

    shards: Tuple[torch.Tensor, ...]
    dim: int
    mesh: Mesh
    axis_name: str = "data"

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(s.shape[self.dim] for s in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's)."""
        dev = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.dim)


def split_rows(x: torch.Tensor, sizes: Sequence[int], devices: Sequence[torch.device], dim: int = 0):
    """``x`` split along ``dim`` into pieces of ``sizes``, piece i copied to
    ``devices[i]`` (contiguous)."""
    return tuple(p.to(d).contiguous() for p, d in zip(torch.split(x, list(sizes), dim=dim), devices))


def shard_sizes(n: int, k: int) -> Tuple[int, ...]:
    """``n`` rows over ``k`` shards as ``torch.tensor_split`` cuts them (the
    first ``n % k`` shards one row longer)."""
    return tuple(n // k + (i < n % k) for i in range(k))


def shard_batch(tree, mesh: Mesh, axis_name: str = "data", dim: int = 0):
    """Every tensor (or array) leaf of ``tree`` (a dict, list or tuple of
    them, or one) as a :class:`Sharded` value: axis ``dim`` split over
    ``axis_name``, shard i on the axis's i-th device (index 0 of the other
    axes). Shards are as even as ``torch.tensor_split`` makes them."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis_name, dim) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, axis_name, dim) for v in tree)
    devices = mesh.axis_devices(axis_name)
    x = tree.gather() if isinstance(tree, Sharded) else torch.as_tensor(tree)
    return Sharded(split_rows(x, shard_sizes(x.shape[dim], len(devices)), devices, dim), dim, mesh, axis_name)


def on_device(device: torch.device):
    """The context in which work for ``device`` is issued: that card
    current (its streams, graphs and kernels), nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k
