from multi_frame_super_resolution_tpu_torch.utils.debug import (
    check_finite,
    debug_nans,
    dump_intermediates,
    guard_finite,
)
from multi_frame_super_resolution_tpu_torch.utils.metrics import mse, psnr, ssim
from multi_frame_super_resolution_tpu_torch.utils.profiling import annotate, trace
from multi_frame_super_resolution_tpu_torch.utils.timing import (
    BenchmarkResult,
    Timer,
    measure,
)

__all__ = [
    "mse", "psnr", "ssim", "BenchmarkResult", "Timer", "measure",
    "check_finite", "debug_nans", "dump_intermediates", "guard_finite",
    "annotate", "trace",
]
