"""Device meshes and batch sharding (counterpart of parallel/mesh.py).

The JAX layer is single-controller: one process builds a ``Mesh`` of
devices, and its sharded programs place each shard on its position's
device. The port keeps that form in one process: a mesh is an array of
``torch.device``s under axis names, and a device may repeat (four
positions on ``cpu`` in the tests, four on ``cuda:0`` on a one-card
host), so every path runs, and is checked, with one device. Its uses:

  * data parallelism: a batch of bursts split over the 'data' axis
    (parallel/runner.py), and the DNN SR train step's batch
    (models/dnn_sr.py::make_train_step);
  * spatial parallelism: frame rows split over the 'spatial' axis with
    halo exchange (parallel/spatial.py);
  * tensor parallelism: DNN SR's conv channels on the 'model' axis
    (models/dnn_sr.py: each of a data shard's 'model' positions computes
    a block of a constrained activation's channels, ``model_rows``), as
    the JAX package's sharding constraint places them.

A sharded array is the list of its shards in the order of its axis's
positions, each on its position's device; ``gather`` concatenates them
on the first one's.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices (an object array of ``torch.device``, one axis per name)
    under axis names: JAX's ``jax.sharding.Mesh``, with ``shape`` the
    ordered {axis name: size} and ``devices`` the array."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} axes cannot take the names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, where tensors put on it land."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``s, repeats
    allowed), by default every CUDA device: without one it raises, and
    never falls back to the CPU. With no sizes given, all devices go on
    the first axis."""
    if devices is None:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError("make_mesh builds its default mesh over the CUDA devices and finds none; "
                               "name the devices (e.g. devices=['cpu'] * 4)")
    devices = [_indexed(torch.device(d)) for d in devices]
    if axis_sizes is None:
        axis_sizes = [len(devices)] + [1] * (len(axis_names) - 1)
    n = int(np.prod(axis_sizes))
    if n != len(devices):
        raise ValueError(f"mesh of {list(axis_sizes)} needs {n} devices, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(axis_sizes)), axis_names)


def data_model_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """2-D ('data', 'model') mesh over the first ``n_devices`` of
    ``devices`` (default: the CUDA devices): model axis 2 when the count
    is even, else 1."""
    devices = list(devices) if devices is not None else _cuda_devices()
    devices = devices[:n_devices] if n_devices else devices
    n = len(devices)
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh(("data", "model"), (n // model, model), devices or None)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """An array's place on a mesh: dimension ``dim`` split over the mesh
    axis ``axis`` (JAX's ``NamedSharding(mesh, P(..., axis))``), or, with
    ``axis`` None, the whole array on every position (``P()``)."""

    mesh: Mesh
    axis: Optional[str] = None
    dim: int = 0

    def devices(self) -> List[torch.device]:
        """The devices of the shards: the positions along ``axis``, every
        other axis at its first position; every position when replicated."""
        if self.axis is None:
            return list(self.mesh.devices.flat)
        at = self.mesh.axis_names.index(self.axis)
        index = [0] * self.mesh.devices.ndim
        index[at] = slice(None)
        return list(self.mesh.devices[tuple(index)])

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` split into equal blocks along ``dim``, each moved to its
        position's device (replicated: a copy on every position's)."""
        devices = self.devices()
        if self.axis is None:
            return [x.to(d) for d in devices]
        if x.shape[self.dim] % len(devices):
            raise ValueError(f"dimension {self.dim} of {tuple(x.shape)} does not split into "
                             f"{len(devices)} equal shards over mesh axis {self.axis!r}")
        return [block.to(d) for block, d in zip(x.chunk(len(devices), self.dim), devices)]


def model_rows(mesh: Mesh) -> List[List[torch.device]]:
    """For each 'data' position in order, the devices of its row along
    'model' (every other axis at its first position): one row when the
    mesh has no 'data' axis, rows of one device when it has no 'model'
    axis."""
    names = mesh.axis_names

    def at(i: int, j: int) -> torch.device:
        index = [0] * mesh.devices.ndim
        for axis, k in (("data", i), ("model", j)):
            if axis in names:
                index[names.index(axis)] = k
        return mesh.devices[tuple(index)]

    shape = mesh.shape
    return [[at(i, j) for j in range(shape.get("model", 1))] for i in range(shape.get("data", 1))]


def burst_batch_sharding(mesh: Mesh) -> Sharding:
    """A batch of bursts (B, F, H, W, C): the batch on 'data'."""
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``batch`` split on 'data', each shard on its position's device."""
    return burst_batch_sharding(mesh).shard(batch)


def gather(shards: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The array of a list of shards: concatenated along ``dim`` on the
    first shard's device."""
    return torch.cat([s.to(shards[0].device) for s in shards], dim=dim)
