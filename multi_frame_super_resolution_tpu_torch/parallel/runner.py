"""Batched execution of burst pipelines (counterpart of
parallel/runner.py): a per-burst function lifted to a batch of bursts,
the batch split over the mesh's 'data' axis. Burst SR is embarrassingly
parallel across bursts, so the positions exchange nothing but the final
gather. No kernel takes a batch axis: each burst runs the per-burst
function, and its kernels, once.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from multi_frame_super_resolution_tpu_torch.parallel.mesh import Mesh, Sharding, _cuda_devices, gather, make_mesh


def make_batched_pipeline(
    fn: Callable,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
    mode: Optional[str] = None,
):
    """Lift ``fn`` (one burst -> one output) to a batch (B, ...) -> (B,
    ...), the JAX function's: ``stack([fn(b) for b in batch])``.

    mode "scan" runs the bursts one after another in one call, on the
    mesh's first 'data' position; "vmap" splits the batch over the
    ``data_axis`` positions (B must divide) and runs each position's
    bursts on its device. With a mesh, ``fn`` is called with ``device=``
    its position's device (the handheld entry points take it); without
    one, as ``fn(burst)``, and the two modes are the same loop. Default:
    scan without a mesh, vmap with one (JAX's). The batch is a tensor or,
    from ``shard_batch``, the list of its shards; the output is gathered
    on the first position's device.
    """
    if mode is None:
        mode = "scan" if mesh is None else "vmap"
    if mode not in ("scan", "vmap"):
        raise ValueError(f"unknown mode {mode!r}")
    sharding = None if mesh is None else Sharding(mesh, data_axis)
    devices = [None] if mesh is None else sharding.devices()
    if mode == "scan":
        devices = devices[:1]

    def run(bursts: torch.Tensor, device) -> torch.Tensor:
        if device is None:
            return torch.stack([fn(b) for b in bursts])
        return torch.stack([fn(b, device=device) for b in bursts.to(device)])

    def batched(batch: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        is_shards = isinstance(batch, (list, tuple))
        if len(devices) == 1:
            return run(gather(batch) if is_shards else batch, devices[0])
        shards = list(batch) if is_shards else sharding.shard(batch)
        if len(shards) != len(devices):
            raise ValueError(f"{len(shards)} shards for the {len(devices)} positions of mesh axis {data_axis!r}")
        return gather([run(shard, d) for shard, d in zip(shards, devices)])

    return batched


def default_mesh(data_axis: str = "data") -> Optional[Mesh]:
    """1-D data mesh over every CUDA device; None with fewer than two."""
    devices = _cuda_devices()
    if len(devices) <= 1:
        return None
    return make_mesh((data_axis,), devices=devices)
