"""Spatial (row-block) sharding with halo exchange (counterpart of
parallel/spatial.py): a frame too large for one device is split by rows
over the mesh's 'spatial' axis; each position extends its block with
``halo`` rows of its neighbours' (a slice of the neighbour's block copied
to its own device), runs the single-device function on it, and crops.

The edge rule is JAX's, copied as it stands (spatial.py:45-46,
:100-103): a block at the global border repeats its own first or last
row ``halo`` times. On a RAW burst that repeats one CFA row, so the
halo's Bayer phase is broken there (ROADMAP, Queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from multi_frame_super_resolution_tpu_torch.parallel.mesh import Mesh, Sharding, gather


def _exchange_halos_axis(blocks: List[torch.Tensor], halo: int, dim: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(from_prev, from_next) for each local block, ``halo`` slices along
    ``dim``: the previous block's last and the next block's first, on the
    block's own device; the end blocks repeat their own edge slice."""
    if halo < 1 or any(b.shape[dim] < halo for b in blocks):
        raise ValueError(f"halo {halo} must be at least 1 and at most the blocks' {blocks[0].shape[dim]} rows")
    out = []
    for i, x in enumerate(blocks):
        n = x.shape[dim]
        prev = x.narrow(dim, 0, 1).repeat_interleave(halo, dim) if i == 0 else \
            blocks[i - 1].narrow(dim, blocks[i - 1].shape[dim] - halo, halo).to(x.device)
        nxt = x.narrow(dim, n - 1, 1).repeat_interleave(halo, dim) if i == len(blocks) - 1 else \
            blocks[i + 1].narrow(dim, 0, halo).to(x.device)
        out.append((prev, nxt))
    return out


def _exchange_halos(blocks: List[torch.Tensor], halo: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``_exchange_halos_axis`` on the leading (row) axis."""
    return _exchange_halos_axis(blocks, halo, 0)


def _extended(blocks: List[torch.Tensor], halo: int, dim: int) -> List[torch.Tensor]:
    """Each block with its halos on both sides along ``dim``."""
    return [torch.cat([prev, x, nxt], dim=dim)
            for x, (prev, nxt) in zip(blocks, _exchange_halos_axis(blocks, halo, dim))]


def spatial_map(
    fn: Callable[[torch.Tensor], torch.Tensor],
    halo: int,
    mesh: Mesh,
    axis: str = "spatial",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Lift a window op ``fn`` (a same-size H x W [-> x C] transform whose
    output row i depends on input rows within +-halo) to an image split
    by rows over ``axis``: ``fn`` runs on each halo-extended block on its
    position's device and the halo rows are cropped from its output. The
    result is gathered on the first position's device."""
    sharding = sharded_rows(mesh, axis)

    def lifted(x: torch.Tensor) -> torch.Tensor:
        outs = [fn(ext) for ext in _extended(sharding.shard(x), halo, 0)]
        return gather([out[halo : out.shape[0] - halo] for out in outs])

    return lifted


def sharded_rows(mesh: Mesh, axis: str = "spatial") -> Sharding:
    """An image's leading (row) axis on the spatial mesh axis."""
    return Sharding(mesh, axis)


def pipeline_halo(cfg, warp_bound: int = 16, prealign_px: int = 0) -> int:
    """Row halo (in input pixels) for running the handheld SR pipeline on
    a row shard: the tile-warp clamp bound, the LK window and its bounded
    warp, the merge tap window, the robustness 5x5 spread, the restore
    FIR's reach at scale 2 (radius 3 at output resolution) and
    ``prealign_px``, the global pre-alignment's reach about the global
    center (|theta| max(H, W)/2 + |scale - 1| max(H, W)/2 + |t| px), rounded
    up to whole alignment tiles so a shard's tile grid is the global one.
    The JAX function's arithmetic, copied."""
    t = cfg.align.tile_size
    restore_reach = math.ceil(3.0 / cfg.scale) if (cfg.final_restore and cfg.scale == 2) else 0
    reach = (
        warp_bound
        + 2 * cfg.lk.half_window + 2
        + cfg.merge.radius + math.ceil(cfg.residual_bound)
        + 5
        + restore_reach
        + int(prealign_px)
    )
    return t * math.ceil(reach / t)


def _check_shards(what: str, h: int, n: int, halo: int, unit: int, unit_name: str) -> None:
    if h % n or (h // n) % unit or halo % unit or halo > h // n:
        raise ValueError(f"{what} height {h} must split into {n} shards whose height ({h / n:g}) and the halo "
                         f"({halo}) are multiples of {unit_name} = {unit}, the halo no taller than a shard")


def handheld_superres_sharded(
    burst: torch.Tensor,
    cfg,
    mesh: Mesh,
    axis: str = "spatial",
    halo: int | None = None,
) -> torch.Tensor:
    """Row-sharded handheld burst SR: burst (F, H, W, 3) split by rows over
    ``axis``, each position running ``models.handheld.handheld_superres``
    on its halo-extended block on its device (``device=``), the scaled
    halo cropped from each output and the blocks gathered on the first
    position's device. The halo is whole alignment tiles, so each interior
    tile sees the data of a global run. With cfg.prealign the global
    similarity is estimated once, on the full luma on the first position's
    device, and every shard applies it about the global center
    (``prealign_override`` with its block's origin). H / n and the halo
    must be multiples of the tile size, else ValueError."""
    from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres

    n = mesh.shape[axis]
    f, h, w = burst.shape[:3]
    if halo is None:
        halo = pipeline_halo(cfg)
    _check_shards("burst", h, n, halo, cfg.align.tile_size, "tile_size")
    s, h_local = cfg.scale, h // n
    sharding = Sharding(mesh, axis, dim=1)
    devices = sharding.devices()
    overrides = [None] * n
    if cfg.prealign:
        from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
        from multi_frame_super_resolution_tpu_torch.registration.prealign import estimate_burst_similarity

        st = estimate_burst_similarity(rgb_to_gray(burst.to(devices[0])), cfg.prealign_cfg)
        overrides = [(st, (float(i * h_local - halo), 0.0), (h, w)) for i in range(n)]
    outs = [handheld_superres(ext, cfg, override, device=d)
            for ext, override, d in zip(_extended(sharding.shard(burst), halo, 1), overrides, devices)]
    return gather([out[halo * s : out.shape[0] - halo * s] for out in outs])


def handheld_superres_raw_sharded(
    raw_burst: torch.Tensor,
    cfg,
    mesh: Mesh,
    axis: str = "spatial",
    halo: int | None = None,
) -> torch.Tensor:
    """Row-sharded RAW handheld SR (see handheld_superres_sharded) of a
    Bayer burst (F, H, W): the halo and the shard height must be multiples
    of 2 * tile_size RAW rows (the alignment tiles live on the half-res
    grid and the CFA phase is kept across shard boundaries). With
    cfg.prealign the global similarity is estimated once on the full
    half-res luma; the override's units are half-res."""
    from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres_raw

    n = mesh.shape[axis]
    f, h, w = raw_burst.shape
    t2 = 2 * cfg.align.tile_size
    if halo is None:
        halo = 2 * pipeline_halo(cfg)
    _check_shards("RAW burst", h, n, halo, t2, "2 * tile_size")
    s, h_local = cfg.scale, h // n
    sharding = Sharding(mesh, axis, dim=1)
    devices = sharding.devices()
    overrides = [None] * n
    if cfg.prealign:
        from multi_frame_super_resolution_tpu_torch.models.fast_merge import raw_to_planes
        from multi_frame_super_resolution_tpu_torch.models.handheld import _subsample_from_planes
        from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
        from multi_frame_super_resolution_tpu_torch.registration.prealign import estimate_burst_similarity

        planes = raw_to_planes(raw_burst.to(devices[0]).contiguous())
        gray_half = rgb_to_gray(_subsample_from_planes(planes, cfg.cfa_pattern))
        st = estimate_burst_similarity(gray_half, cfg.prealign_cfg)
        overrides = [(st, ((i * h_local - halo) / 2.0, 0.0), (h // 2, w // 2)) for i in range(n)]
    outs = [handheld_superres_raw(ext, cfg, override, device=d)
            for ext, override, d in zip(_extended(sharding.shard(raw_burst), halo, 1), overrides, devices)]
    return gather([out[halo * s : out.shape[0] - halo * s] for out in outs])
