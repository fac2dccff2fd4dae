"""Test-data generator CLI (counterpart of apps/getimg.py, the reference's
getimg.py:5-28): crop ``count`` random center-jittered patches (and their
grayscale versions) from a large source PNG, and optionally synthesize a
burst of subpixel-shifted, rotated crops of each (the main.cpp:1877-1913
recipe of the bundled city burst). numpy only; it writes the JAX app's
files from the same draws of np.random.default_rng(0).

    python -m multi_frame_super_resolution_tpu_torch.apps.getimg source.png count [--size 1024] [--burst N] [--out DIR]
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("getimg source count [--size S] [--burst N] [--out DIR]")
        return -1
    source = argv[0]
    count = int(argv[1])
    size = 1024
    burst_n = 0
    out_dir = "."
    rest = argv[2:]
    while rest:
        flag = rest.pop(0)
        if flag == "--size":
            size = int(rest.pop(0))
        elif flag == "--burst":
            burst_n = int(rest.pop(0))
        elif flag == "--out":
            out_dir = rest.pop(0)
        else:
            print(f"unknown flag {flag}")
            return -1

    import numpy as np

    from multi_frame_super_resolution_tpu_torch.data import imread, imwrite
    from multi_frame_super_resolution_tpu_torch.data.synthetic import _rotate_translate_crop

    img = imread(source)
    h, w = img.shape[:2]
    if h < size or w < size:
        print(f"source {w}x{h} smaller than patch size {size}")
        return -1

    rng = np.random.default_rng(0)
    os.makedirs(out_dir, exist_ok=True)
    cy, cx = h // 2, w // 2
    for i in range(count):
        jy = int(rng.integers(-(h - size) // 2, (h - size) // 2 + 1)) if h > size else 0
        jx = int(rng.integers(-(w - size) // 2, (w - size) // 2 + 1)) if w > size else 0
        y0 = cy + jy - size // 2
        x0 = cx + jx - size // 2
        patch = img[y0 : y0 + size, x0 : x0 + size]
        imwrite(os.path.join(out_dir, f"subimg{i:04d}.png"), patch)
        gray = patch @ np.asarray([0.299, 0.587, 0.114], np.float32)
        imwrite(os.path.join(out_dir, f"subimg{i:04d}_gray.png"), gray)
        print(f"subimg{i:04d}.png ({size}x{size})")

        for b in range(burst_n):
            dy, dx = rng.uniform(-3.0, 3.0, 2)
            ang = rng.uniform(-0.02, 0.02)
            frame = _rotate_translate_crop(patch, dy, dx, ang, size, size)
            imwrite(os.path.join(out_dir, f"subimg{i:04d}_burst{b:02d}.png"), frame)
    return 0


if __name__ == "__main__":
    sys.exit(main())
