"""The multi-device layer (counterpart of multi_frame_super_resolution_tpu.parallel):
meshes and batch sharding (mesh.py), batched bursts (runner.py) and
row-sharded handheld SR with halo exchange (spatial.py), in one process
over a mesh of ``torch.device``s (see mesh.py)."""

from multi_frame_super_resolution_tpu_torch.parallel.mesh import (
    burst_batch_sharding,
    data_model_mesh,
    make_mesh,
    replicated,
    shard_batch,
)
from multi_frame_super_resolution_tpu_torch.parallel.spatial import (
    handheld_superres_raw_sharded,
    handheld_superres_sharded,
    pipeline_halo,
    sharded_rows,
    spatial_map,
)

__all__ = [
    "burst_batch_sharding", "data_model_mesh", "make_mesh", "replicated", "shard_batch",
    "handheld_superres_raw_sharded", "handheld_superres_sharded", "pipeline_halo", "sharded_rows", "spatial_map",
]
