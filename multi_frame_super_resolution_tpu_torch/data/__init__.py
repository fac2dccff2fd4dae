from multi_frame_super_resolution_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_burst,
    synthetic_rgb_burst,
)
