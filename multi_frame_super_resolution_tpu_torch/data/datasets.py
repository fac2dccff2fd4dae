"""The reference's bundled bursts (counterpart of data/datasets.py's
DATASETS, burst_paths and load_burst; multi_frame_sr.cpp:151-163):

  * city: 5 frames ``img_%06d.png`` (512 x 256)
  * car:  4 frames ``car/%d.jpg``   (228 x 130)
  * iso:  4 frames ``iso/%06d.png`` (440 x 300)

read from a data root: ``data_dir``, else the ``MFSR_DATA_DIR``
environment variable at call time, else the reference checkout. Every
frame loads through the native reader (data/native.py) where it is built,
else through numpy (data/io.py), the car burst's JPEGs too.
``synthetic_burst`` and ``mosaic_rggb`` (of
data/synthetic.py) are re-exported here, where the JAX package defines
them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from multi_frame_super_resolution_tpu_torch.data import native
from multi_frame_super_resolution_tpu_torch.data.io import imread, imwrite
from multi_frame_super_resolution_tpu_torch.data.synthetic import mosaic_rggb, synthetic_burst  # noqa: F401

# the JAX package's default data root (data/datasets.py::DEFAULT_DATA_DIR)
REFERENCE_DIR = "/root/reference"

# dataset name -> (relative file pattern, frame count, first index)
DATASETS = {
    "city": ("test_opencv/img_{:06d}.png", 5, 0),
    "car": ("finalProject/Project/car/{:d}.jpg", 4, 1),
    "iso": ("finalProject/Project/iso/{:06d}.png", 4, 1),
}

# dataset name -> each frame's (height, width); synthetic_dataset_burst
# makes bursts of DATASETS' frame count at this size
FRAME_SIZE = {"city": (256, 512), "car": (130, 228), "iso": (300, 440)}


def burst_paths(name: str, data_dir: Optional[str] = None) -> List[str]:
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; expected one of {sorted(DATASETS)}")
    pattern, count, start = DATASETS[name]
    root = data_dir or os.environ.get("MFSR_DATA_DIR", REFERENCE_DIR)
    return [os.path.join(root, pattern.format(i + start)) for i in range(count)]


def load_burst(name: str, data_dir: Optional[str] = None) -> np.ndarray:
    """A named burst as float32 (F, H, W, 3) in [0, 1]: the native
    reader's threaded load where it is built, else imread frame by frame."""
    paths = burst_paths(name, data_dir)
    out = native.read_burst_native(paths)
    if out is not None:
        return out
    return np.stack([imread(p) for p in paths], axis=0)


def write_burst(name: str, burst: np.ndarray, data_dir: str) -> List[str]:
    """Write ``burst`` (F, H, W[, 3]) in [0, 1] as 8-bit frames at the paths
    ``load_burst(name, data_dir)`` reads (directories made as needed), so
    that a synthetic burst stands in for a missing reference burst: PNG
    for city and iso, JPEG (imwrite's, Pillow's defaults) for car."""
    paths = burst_paths(name, data_dir)
    if len(burst) != len(paths):
        raise ValueError(f"the {name} burst is {len(paths)} files {DATASETS[name][0]!r}; got {len(burst)} frames")
    for path, frame in zip(paths, burst):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imwrite(path, frame)
    return paths

