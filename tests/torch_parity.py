"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy input goes through the JAX function and its counterpart
in multi_frame_super_resolution_tpu_torch; the outputs come back as
numpy and are compared with a stated tolerance.

Importing this module pins torch to one thread (the suite runs several
xdist workers on few cores) and turns TF32 off, so that a test run on a
card compares in full float32.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def tt(x, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> contiguous torch tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device)


def nn(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def psnr(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


def cuda_device() -> torch.device:
    """The card for a test marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)
