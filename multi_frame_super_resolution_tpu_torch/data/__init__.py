from multi_frame_super_resolution_tpu_torch.data.datasets import (  # noqa: F401
    DATASETS,
    FRAME_SIZE,
    burst_paths,
    load_burst,
    write_burst,
)
from multi_frame_super_resolution_tpu_torch.data.io import imread, imread_gray, imread_u16, imwrite  # noqa: F401
from multi_frame_super_resolution_tpu_torch.data.synthetic import (  # noqa: F401
    CITY_ANGLES,
    mosaic_rggb,
    synthetic_burst,
    synthetic_dataset_burst,
    synthetic_polar_pair,
    synthetic_raw_burst,
    synthetic_rgb_burst,
    true_hr_burst,
)
