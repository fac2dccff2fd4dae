from multi_frame_super_resolution_tpu_torch.data.synthetic import (  # noqa: F401
    mosaic_rggb,
    synthetic_burst,
    synthetic_raw_burst,
    synthetic_rgb_burst,
)
