from multi_frame_super_resolution_tpu_torch.data.io import imwrite  # noqa: F401
from multi_frame_super_resolution_tpu_torch.data.synthetic import (  # noqa: F401
    CITY_ANGLES,
    mosaic_rggb,
    synthetic_burst,
    synthetic_polar_pair,
    synthetic_raw_burst,
    synthetic_rgb_burst,
)
