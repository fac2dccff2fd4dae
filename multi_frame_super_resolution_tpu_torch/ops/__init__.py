"""Image operations (counterparts of multi_frame_super_resolution_tpu.ops),
with the names the JAX package re-exports here. Note: ``derivatives``
is then the function; import the module of that name with importlib."""

# ruff: noqa: F401
from multi_frame_super_resolution_tpu_torch.ops.color import (
    normalize_minmax,
    rgb_to_gray,
    srgb_degamma,
    srgb_gamma,
)
from multi_frame_super_resolution_tpu_torch.ops.debayer import (
    BGGR,
    GBRG,
    GRBG,
    RGGB,
    cfa_channel_map,
    debayer,
    debayer_subsample,
    scale_raw,
)
from multi_frame_super_resolution_tpu_torch.ops.derivatives import (
    derivative5_x,
    derivative5_y,
    derivatives,
    derivatives_pair,
    structure_tensor,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import (
    box_filter,
    conv2d,
    gaussian_blur,
    gaussian_kernel_1d,
    laplacian_sharpen,
    separable_filter,
    unsharp_mask,
)
from multi_frame_super_resolution_tpu_torch.ops.fourier import (
    apodization_window,
    conj_mul,
    cross_power_spectrum,
    fftshift2,
    fftshift_signflip,
    fourier_filter,
    fourier_filter_mask,
    high_pass_filter,
    ifftshift2,
)
from multi_frame_super_resolution_tpu_torch.ops.geometry import (
    downsample2,
    downscale,
    identity_grid,
    remap,
    remap_bicubic,
    remap_bilinear,
    resize,
    rotate,
    translate,
    upsample_zero,
    upscale,
    warp_backward,
)
from multi_frame_super_resolution_tpu_torch.ops.morphology import dilate, erode, min_channels
from multi_frame_super_resolution_tpu_torch.ops.reduce import (
    masked_channel_sums,
    top_k_channel_means,
    top_k_mask,
)
