"""multi_frame_super_resolution_tpu_torch — the PyTorch / CUDA port of
``multi_frame_super_resolution_tpu``.

The JAX package stays the reference; this package mirrors its layout and
function names, so each counterpart is found by path. Plain tensor code
is PyTorch and runs on the device of its inputs; every Pallas kernel on
a ported path becomes a hand-written Hopper kernel under ``csrc/`` with
its Python wrapper under ``kernels/``.

Ported so far: the RAW main path ``models.handheld.handheld_superres_raw``
under ``config.RAW_PORT_DEFAULT`` (and its windows-branch alignment), and
the RGB pipeline ``models.handheld.handheld_superres`` under
``HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True))``
(see ``config.check_supported_raw`` and ``config.check_supported`` for the
knobs that still raise).
"""

__version__ = "0.1.0"
