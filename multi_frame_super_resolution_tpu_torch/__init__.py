"""multi_frame_super_resolution_tpu_torch — the PyTorch / CUDA port of
``multi_frame_super_resolution_tpu``.

The JAX package stays the reference; this package mirrors its layout and
function names, so each counterpart is found by path. Plain tensor code
is PyTorch and runs on the device of its inputs; the entry points
(``models.handheld.handheld_superres``, ``handheld_superres_raw``, the
defog app) run on cuda:0 unless the caller asks for another device
(``resolve_device``). Every Pallas kernel on a ported path becomes a
hand-written Hopper kernel under ``csrc/`` with its Python wrapper under
``kernels/``.

Ported so far: the RAW main path ``models.handheld.handheld_superres_raw``
under ``config.RAW_BENCH`` (and without pre-alignment, and with the
windows-branch alignment), the RGB pipeline
``models.handheld.handheld_superres`` under ``config.RGB_PALLAS`` (and
without pre-alignment), and the polarization defog with its app (see
``config.check_supported_raw`` and ``config.check_supported`` for the
knobs that still raise).
"""

__version__ = "0.1.0"


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
