"""multi_frame_super_resolution_tpu_torch — the PyTorch / CUDA port of
``multi_frame_super_resolution_tpu``.

The JAX package stays the reference; this package mirrors its layout and
function names, so each counterpart is found by path. Plain tensor code
is PyTorch and runs on the device of its inputs; the entry points
(``models.handheld.handheld_superres``, ``handheld_superres_raw`` and
its cascade, ``models.btvl1.btvl1_superres`` and ``btvl1_video``,
``models.dnn_sr.dnn_sr``, and the apps) run on cuda:0 unless the caller
asks for another device (``resolve_device``). Every Pallas kernel on a ported path becomes a
hand-written Hopper kernel under ``csrc/`` with its Python wrapper under
``kernels/``.

Ported so far: the RAW path ``models.handheld.handheld_superres_raw``
at every scale (``config.RAW_BENCH``, bench.py's configuration, and
without pre-alignment, with the windows-branch alignment, at
``config.RAW_SCALE4``) and the scale-4 cascade
``handheld_superres_raw_cascade``; the RGB pipeline
``models.handheld.handheld_superres`` on its default branch
(``config.RGB_DEFAULT``, order 0 or ``rgb_order=1``, every scale) and on
its ``use_pallas`` branch (``config.RGB_PALLAS``), with or without
pre-alignment; the gather oracle of both entry points (``fast=False``:
``config.RAW_ORACLE``, ``config.RGB_ORACLE``), the exact 3x3 solve on
both fast paths (``config.RAW_EXACT``, ``config.RGB_EXACT``) and the RAW
order-0 merge (``config.RAW_ORDER0``); the polarization defog with its
app; and BTV-L1
multi-frame super-resolution (``models.btvl1``) with its four dense
optical flows (``registration.optical_flow``), the PNG burst loader
(``data.load_burst``) and the ``multi_frame_sr`` and ``runall`` apps
(every knob of the handheld configurations runs; ``config.check_supported_raw``
and ``config.check_supported`` name the values the port refuses, as the
JAX package does or as a kernel limit); single-image DNN SR
(``models.dnn_sr``: the four architectures, flax-layout checkpoints,
inference and the train step) with its app, the ``handheld_sr`` and
``getimg`` apps, and ``utils`` (metrics, timing, profiling, debug); the
multi-device layer ``parallel`` (a mesh of ``torch.device``s in one
process: batched bursts, row-sharded handheld SR with halo exchange, and
DNN SR's train step and inference with the batch on 'data' and the
constrained activations' channels on 'model',
``models.dnn_sr.make_train_step(..., mesh=)`` and ``dnn_sr(..., mesh=)``);
and the readers ``data.imread_gray`` and ``data.imread_u16``
(with a numpy baseline TIFF reader), the native C++ loader's binding
``data.native`` and the defog app's TIFF inputTypes 1 and 2.
"""

__version__ = "0.1.0"

from multi_frame_super_resolution_tpu_torch import config  # noqa: E402,F401


def resolve_device(device, who: str, hint: str):
    """The device an entry point runs on: ``device`` where the caller names
    one (a string or a ``torch.device``), else cuda:0. Without a card and
    without such a request it raises, naming ``hint`` (how to ask for the
    CPU), and never falls back to the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on cuda:0 and finds no CUDA device; ask for the CPU with {hint}")
    return torch.device("cuda", 0)
