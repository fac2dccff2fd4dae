#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. The card: name and power limit (nvidia-smi).
2. Build: compiles the five kernels of csrc/ with nvcc for sm_90a, one
   nvcc process each, all at once (timed as set-up).
3. Kernel checks, each kernel against its plain PyTorch version on the
   card at the shapes its path gives it, inputs from a seed:
   - merge (csrc/merge.cu): F=5, 256 x 512, radius 1, residual bound 1,
     in its five forms: interleaved at scale 2, k_max 1, taps at e^-6
     (the use_pallas branch); the phase layout at e^-1.5 at scale 2,
     k_max 1 and at scale 4, k_max 4 (the default branch, RGB_DEFAULT and
     scale 4); rtol and atol 1e-5; the plugin solve's order-1 moments at
     scale 2 (rgb_order=1) and the exact solve's 9 moments at scales 2
     and 4 (RGB_EXACT), rtol and atol 1e-4 (ORDER1_TOL); the bfloat16
     order 0 in the phase layout (RGB_BF16) at scales 2 and 4, BF16_TOL;
   - tile warp (csrc/tile_warp.cu): 4 frames x 4 CFA planes of 128 x 256,
     T=16; separable map with shifts in +-20 (the +-16 clip acts), block
     map with shifts in +-5; the one-hot map (warp_matmul=False) with
     shifts in +-20; and RAW_SCALE4's warp at T=8 (8 frames x 5
     planes of 128 x 256) as the same path hands it over; bit-exact;
   - tile search (csrc/tile_search.cu): 4 alternates of 128 x 256 and
     of 64 x 128 (the RAW main path's two pyramid levels), T=16, R=4,
     both modes, on a synthetic burst shifted by up to 3 px, with noise,
     and predictions within 2 px of each shift; in "image" mode a tenth
     of the tiles predicted at 17-20 px (the +-16 warp clip acts); and a
     ragged 79 x 111, R=9 "tile" case. Integer parts (subpixel off) equal
     on every tile, subpixel shifts within 1e-3 px. And RAW_SCALE4's two
     searches (8 alternates of 128 x 256 and 64 x 128, T=8, R=4, "image")
     as its path hands them over on a 9-frame burst rotated 0/0/5/10/-15
     degrees (repeated): the same limits outside the tiles whose argmin,
     or whose subpixel fit, float32 rounding decides
     (tiles.float32_undecided), which are counted;
   - RAW merge (csrc/merge_raw.cu): 128 x 256 half-res, the RAW path's
     21 taps: F=5 at scales 1, 2 (the main path) and 3, k_max (s/2)^2;
     F=9 at scale 4, k_max 4, wider R/B kernels (RAW_SCALE4); rtol and
     atol 1e-5; its order-0 form (RAW_ORDER0) at S=2 (F=5) and S=4
     (F=9), rtol and atol 1e-5, its 9-moment form (RAW_EXACT) and its
     per-cell plugin form (RAW_CERT) at the same shapes, ORDER1_TOL; and
     at S=2 each of the four forms on guided difference planes (the guide
     green_guide_planes of the planes, RAW_GUIDED), each at its form's
     tolerance; the merge knobs' variants at S=2 (F=5) and S=4 (F=9):
     exact_weights at 4 and 9 slots (RAW_EXACT_WEIGHTS), the per-cell
     centroid's block, shared-residual, pruned and bfloat16 forms
     (RAW_CERT_BLOCK, _SHARED, _PRUNE, _BF16) and the bfloat16 order 0
     (RAW_ORDER0_BF16), guided too, at ORDER1_TOL, and the bfloat16 ones
     at BF16_TOL / CBF16_TOL (at most 0.1% of the values beyond float32
     rounding); each bfloat16 form against its float32 form, which most
     values must differ from (the form rounds);
   - defog (csrc/defog.cu): 1024 x 1224 x 3, P and A_inf from the seed;
     rtol 1e-5, atol 1e-6 (the kernel is expected to match bit for bit);
   - the general forms, where the templated kernels' layouts are not
     built for the call, at the same shapes and tolerances:
     merge_fast_general (merge_fast_kernel<0, form>) at scale 5 in its
     five forms, and the templated merge at tap radii 9 and 11 (361 and
     529 taps); merge_fast_unstaged (the general form past a tap reach of
     34: radius 35, s=1, F=5 at 16 x 32 and F=4 at 64 x 128, bands of tap
     rows, frames and bands over grid z); tile_search_general at T=12, radius 0 and
     radius 30; merge_raw_general (the S = 0 instantiations of
     merge_raw_kernel and merge_raw_cells_kernel) at scale 5 in every form
     and knob, guided, 109 taps and the bfloat16 order 0 on 40 frames;
     merge_raw_nonbayer on the pattern ((0, 1), (2, 1)) in the certless
     form, order 0, 9 slots and the per-cell 4, and on a Bayer merge's 9
     slots at 3,721 taps (3 x 64 x 128; its plain version timed once); and merge_raw's
     streamed form (merge_raw_stream: the certless and order-0 forms past
     their frame caps, 40 frames at S=2 and 70 at S=4).
3b. The public surface: each function named after a JAX function that
   takes the JAX call forms (images (H, W) and (H, W, C), two (H, W)
   images for the registration functions; the JAX-ordered parameters:
   restore_image(img, k), separable_filter(border=), the default
   interleaved merge_burst_raw_planes, ...) called in each form on
   cuda:0 and on the CPU with the same inputs at 64 x 96 or smaller,
   |card - cpu| <= 1e-5 (1 + |cpu|); tile_warp_int on the card runs the
   tile-warp kernel's block map (one launch a call, checked) against its
   plain version on the CPU; and the names ops, models and registration
   re-export, imported. Seconds; it runs after phase 6, so that the
   paths' runs and profiles are those of a process that has not run it,
   and its launches are no path's.
4. Paths on the card, each driven with the launch counts set to 0 just
   before and read just after (the former port limits among them: each
   value a general or streamed form runs, at the city geometry (taps
   past a reach of 34 on a 4 x 64 x 128 burst), its launch
   set exact, 60 dB against its plain-kernel run):
   - polar_defog on a synthetic fog pair at 1024 x 1224 x 3 (one
     polarization angle of a 2448 x 2048 division-of-focal-plane sensor;
     defog kernel): R finite and in [r_min, r_max], agreeing (PSNR >=
     60 dB) with the run through the plain version, and a small pair on
     the card with the port on the CPU; the same size through
     stokes_synthesis from synthetic 0/45/90-degree frames; the defog app
     (apps/polar_defog.py) on its 300 x 400 demo;
   - handheld_superres at config.RGB_PALLAS (pre-alignment; merge,
     tile-warp and tile-search kernels) on a synthetic 5 x 256 x 512 x 3 RGB burst
     rotated as the city burst is (0/0/5/10/-15 degrees), and at
     config.PORT_DEFAULT (no pre-alignment) on the same burst unrotated;
   - handheld_superres_raw on that burst mosaicked to 5 x 256 x 512 at
     config.RAW_BENCH (bench.py's configuration; tile-warp, tile-search
     and RAW merge kernels), and on the unrotated burst at config.RAW_PORT_DEFAULT and
     its windows-branch variant align.fast_extract=False;
   - the default RGB branch on the rotated burst: config.RGB_DEFAULT
     (-> 512 x 1024 x 3), HandheldConfig(scale=4) (-> 1024 x 2048 x 3)
     and RGB_DEFAULT with rgb_order=1 (merge kernel in the phase layout,
     order 0 or 1);
   - config.RAW_SCALE4 on a 9-frame 256 x 512 mosaicked burst rotated
     within +-0.01 rad (-> 1024 x 2048 x 3; the RAW merge at scale 4),
     and handheld_superres_raw_cascade at RAW_SCALE4 on 5 such frames (a
     scale-2 and a scale-4 run). Every path runs the tile search once per
     pyramid level of each run. RAW_SCALE4 on the 5-15 degree burst of
     phase 3: its agreement with the plain kernels and with the CPU is
     printed without a limit (rounding-ranked tiles move whole tiles).
   - the correctness bar's paths on the rotated burst (5 x 256 x 512, RAW
     mosaicked), each -> 512 x 1024 x 3: config.RAW_ORACLE and
     config.RGB_ORACLE (the gather oracle, fast=False: the tile search is
     its one kernel of csrc/), config.RAW_EXACT and config.RGB_EXACT (the
     exact 3x3 solve: the 9-moment merge forms) and config.RAW_ORDER0
     (the order-0 RAW merge form); and the true-HR PSNR on the card of
     the oracle, exact, plugin-2 (RAW_BENCH with plugin_iters=2), default
     (RAW_BENCH), guided (RAW_GUIDED), per-cell centroid (RAW_CERT) and
     demosaic + bicubic rows on data.true_hr_burst (the tracked city
     scene, 5 x 256 x 512 RAW at factor 2), printed without a limit;
   - the handheld knobs on the rotated burst, each -> 512 x 1024 x 3 with
     its launch set checked: config.RAW_GUIDED (the RAW merge on colour
     differences), config.RAW_CERT (its per-cell form), config.RAW_CONSISTENT
     and config.RGB_CONSISTENT (the consistency solve: a tile search per
     level for each first frame of a measured pair, F-1 of them),
     config.RAW_FFT (FFT surfaces: no tile search) and RAW_BENCH with
     lk.warp_tile=16; the merge and warp knobs: RAW_EXACT_WEIGHTS,
     RAW_CERT_BLOCK, RAW_CERT_SHARED, RAW_CERT_PRUNE, RAW_CERT_BF16,
     RAW_ORDER0_BF16, RAW_ONEHOT_WARP, RGB_BF16, RGB_HALF_STATS and
     RGB_ONEHOT_WARP (the true-HR rows take the RAW ones too);
   - btvl1_video (models/btvl1.py, plain PyTorch: BTV-L1 reaches no kernel
     of csrc/, as the JAX path reaches no Pallas kernel) at the app's
     configuration, BTVConfig(scale=2, iterations=10, temporal_radius=1),
     with each of the four flows (pyrlk, farneback, tvl1, brox) on the
     rotated city burst (-> 5 x 512 x 1024 x 3), a small burst (3 x 64 x
     96 x 3) on the card against the port on the CPU, and the app
     (apps/multi_frame_sr.py pyrlk city 10) on the city burst written as
     PNGs to a temporary MFSR_DATA_DIR, 4 cycles; on the same PNGs the
     handheld app (apps/handheld_sr.py city 2, and --raw), which prints
     its BenchmarkResult;
   - single-image DNN SR (models/dnn_sr.py: cuDNN convolutions in
     float32 with TF32 off, no kernel of csrc/, as the JAX package
     computes them in XLA): each bundled x2 checkpoint (espcn, fsrcnn,
     lapsrn, edsr at the JAX package's widths) through dnn_sr on the
     tracked city scene (city_handheld_sr.png, 512 x 1024, as HR; its
     bilinear half as LR): the output on cuda:0, (512, 1024, 3), finite,
     in [0, 1]; its PSNR against HR beside bilinear's, which it must
     beat by 0.5 dB on the scene's luma in three channels (the gray
     scenes the checkpoints were trained on; tests/test_dnn_sr.py's
     margin) and which is printed without a limit on the colour scene
     (the checkpoints lose to bilinear there, in the JAX package too);
     a 64 x 96 crop on the card against the port on the CPU (60 dB).
     The train step at the app's protocol (batch 8, LR 32 x 32): 50
     steps of each architecture from init_state's torch.Generator seed
     0, the loss falling, the first 3 losses within rtol 1e-4 of the
     port's on the CPU from the same parameters, ms per step; and the
     dnn_sr app (train, 5 steps, then inference on a PNG with that
     checkpoint and a bundled one).
   - the multi-device layer (parallel/) on one card, every mesh 4
     positions on cuda:0 (2 for the data-parallel train step and split
     inference): make_batched_pipeline at
     RAW_BENCH on B = 4 and 8 city bursts, scan and vmap, each output
     equal to its single call bit for bit; handheld_superres_raw_sharded
     at RAW_BENCH and handheld_superres_sharded at RGB_DEFAULT_NOPRE on a
     5 x 1024 x 1536 burst rotated within +-0.01 rad, 4 shards of 256
     rows, the interior (2 halo output rows trimmed) above 40 dB against
     the unsharded run; spatial_map of gaussian_blur at halo 2 within
     1e-5 of the unsharded blur; the data-parallel ESPCN train step on 2
     positions and the split train step of each DNN SR family on
     ('data', 'model') (2, 2) positions (the constrained activations'
     channels split over 'model') against the one-device step over 3
     steps (losses within 1e-6 relative, gradients GRAD_RTOL, parameters
     by the card test's Adam rule, ADAM_DECIDED); split inference of the
     four bundled checkpoints at 1080 x 1920 -> 2160 x 3840 on (1, 2)
     positions within 1e-5 max abs of the unsplit call; each timed in
     in-call pairs against its single-device or unsplit form, with device
     ops. And the readers: which served
     (the native library or numpy), 16-bit gray and 8-bit RGB baseline
     TIFFs written with struct read back exactly on each route, and the
     defog app's inputType 1 on a 16-bit TIFF pair through the defog
     kernel, against the plain version on the CPU (60 dB); then, on the
     numpy route (reader_files): every committed file of
     tests/torch_reader_files (JPEG, PNG and TIFF forms) decoded to its
     MANIFEST.json digest (Pillow's decode) with its host ms per frame;
     the car burst's committed JPEGs through load_burst into the
     multi_frame_sr app (pyrlk) and the handheld_sr app (car 2) on the
     card, with their launches; the defog app on a 1024 x 1224 16-bit
     Deflate + Predictor 2 TIFF pair, R equal bit for bit to the
     uncompressed pair's; the dnn_sr app from a JPEG to a .jpg read back
     through the port; and the JPEG encoder and decoder at 1080p.
   The entry points get CUDA tensors and no device argument: they run on
   cuda:0, their default. Each burst output must lie there, have its
   shape, be finite and in [0, 1], agree (PSNR >= 60 dB) with the same
   run with every kernel swapped for its plain version, and a small burst
   on the card must agree with the port run with device="cpu".
5. Timing with CUDA events after warm-up, each input distinct: ms per
   burst and output MP/s of each slice (bursts scaled by 1 - 1e-5 i); ms
   per frame and FPS of polar_defog under the reference protocol (32
   warm-up and 256 timed frames, each fenced by a scalar readback) and,
   labeled, its device time per frame back to back; ms per call of each
   kernel variant beside its plain version, the kernel's device time
   from the profiler, and its bound: the larger of the bytes it must move (each
   input read once, each output written once) over 3.35 TB/s and its
   operations at the checked shape (WORK) over the card's peak for
   their type (67 TFLOP/s f32 and 133.8 TFLOP/s bfloat16 outside the
   tensor cores, which share the pipes and so add, and exp at 16 a clock
   on each of 132 SMs at 1.98 GHz); the plain tile search's device time and device-op
   count beside the kernel's (the search's yardstick); merge_fast's
   device time at F=1 beside F=5 (the part that does not grow with the
   frames), and its interleaved form beside the phase layout plus the
   interleave, at RGB_PALLAS's merge (every device op); the registers and spills (ptxas -v) of every instantiation
   (printed at the build); for the copy kernel (tile_warp) the copy floor: the
   profiler's device time of dst.copy_(src) moving the kernel's bytes;
   the runall matrix of BTV-L1, 4 flows x the geometries of the city, car
   and iso bursts (synthetic): FPS under the app's protocol (10 cycles,
   the last 5 timed, each fenced by a scalar readback), and the device ms
   and device ops of one cycle (the profiler's raw device events alone,
   a light read) with the card's busy share; at the city geometry one
   more cycle under the full profiler, split as phase 6 splits a burst,
   its totals beside the light read's. The new configurations' paths are
   timed and profiled as the others (RAW_CONSISTENT's mfsr.align stage
   with the searches of its seven pairs). DNN SR at 1920 x 1080 -> 3840
   x 2160 (a seeded synthetic scene) through each checkpoint: ms per
   image (CUDA events, each input distinct), output MP/s, device ms and
   ops of one call and the card's busy share; the same under TF32 as a
   labelled measurement, with the PSNR of its output against float32's
   and its fidelity on the city luma beside float32's.
6. Where the time goes: one burst (frame) of each path under
   torch.profiler: host and device ms of each stage (the mfsr.* ranges
   of models/handheld.py and models/defog.py, with each kernel's own
   profiler row added to its stage, and the CUDA-event time around its
   launches beside it), and the card's busy share; BTV-L1's cycles are
   split by the mfsr.btv.* ranges (flow, init, iterate) in phase 5.

The last lines are a JSON line of the kernels (each kernel's entry holds
the variant its main path runs, and every timed variant under
"variants"; the three forms of the correctness bar's paths, the
per-cell form of RAW_CERT and the knobs' forms have entries of their
own, their launches from their paths' runs), the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

F, H, W, SCALE = 5, 256, 512, 2
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)  # expf and FMA contraction vs torch ops
# the order-1 merge's m01 and m02 sum w c dy and w c dx, whose factors
# reach +-(r + rb) s in either sign: their rounding does not cancel
ORDER1_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=0.0, atol=0.0)  # the copies move values, they compute nothing
# the bfloat16 forms against their plain versions (tests/test_torch_cuda.py's
# rules): a weight that ex2.approx and torch.exp round to neighbouring
# bfloat16 values moves one term by a bfloat16 step, and the bfloat16 sums
# after it may round the other way. At most "share" of the values may lie
# beyond float32 rounding (1e-4), none beyond rtol/atol: a few bfloat16
# steps of the sums (order 0), or of one product S rho (w c) (centroid)
BF16_TOL = dict(rtol=2**-5, atol=2**-6, share=1e-3)
CBF16_TOL = dict(rtol=1e-4, atol=2**-4, share=1e-3)
SHIFT_TOL = dict(rtol=0.0, atol=1e-3)  # px: SSD sums in another order, through the subpixel fit
DEFOG_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX spec's tolerance; expected exact
DEFOG_H, DEFOG_W = 1024, 1224  # one polarization angle of a 2448 x 2048 DoFP sensor
PSNR_MIN = 60.0
BTV_FLOWS = ("pyrlk", "farneback", "tvl1", "brox")
PKG = "multi_frame_super_resolution_tpu_torch"
KERNELS = {  # name -> (source, the TPU kernel or JAX function it replaces)
    "merge_fast": (f"{PKG}/csrc/merge.cu", "multi_frame_super_resolution_tpu/pallas_ops/merge.py:132"),
    "tile_warp": (f"{PKG}/csrc/tile_warp.cu", "multi_frame_super_resolution_tpu/pallas_ops/tile_warp.py:58"),
    "tile_search": (f"{PKG}/csrc/tile_search.cu", "multi_frame_super_resolution_tpu/pallas_ops/tile_gather.py:52"),
    "merge_raw": (f"{PKG}/csrc/merge_raw.cu", "multi_frame_super_resolution_tpu/models/fast_merge.py:301"),
    "defog": (f"{PKG}/csrc/defog.cu", "multi_frame_super_resolution_tpu/pallas_ops/defog.py:35"),
}
# the general forms (the RGB one's launches past a tap reach of 34 under
# merge_fast_unstaged, the name of the kernel they ran on before), the
# RAW merge's streamed and non-Bayer ones: each in its templated kernel's
# source, replacing the same function
KERNELS.update({f"{name}_general": KERNELS[name] for name in ("merge_fast", "tile_search", "merge_raw")})
KERNELS["merge_fast_unstaged"] = KERNELS["merge_fast"]
KERNELS["merge_raw_stream"] = KERNELS["merge_raw_nonbayer"] = KERNELS["merge_raw"]
# the profiler's names of the kernels' __global__ functions (the general
# forms: the S = 0 instantiations, "<0, ...>" in the demangled names)
KERNEL_SYMBOLS = {
    # merge_fast: the templated kernel and form 4's merge_fast_bf16_kernel
    "merge_fast": "merge_fast_", "tile_warp": "tile_warp_kernel",
    "tile_search": "tile_search_kernel", "merge_raw": "merge_raw",  # every RAW kernel
    "defog": "defog_kernel",
    # the general form and, where it splits frames or taps over blocks,
    # the kernel that adds the parts: both in a call's time
    "merge_fast_general": "merge_fast_", "merge_fast_unstaged": "merge_fast_",
    "tile_search_general": "tile_search_general_kernel", "merge_raw_general": "_kernel<0",
    "merge_raw_stream": "merge_raw_stream_kernel", "merge_raw_nonbayer": "merge_raw_nonbayer_kernel",
}
# each kernel's stage in the profile
STAGE_OF = {"merge_fast": "mfsr.merge", "merge_raw": "mfsr.merge", "tile_warp": "mfsr.tile_warp",
            "tile_search": "mfsr.align", "defog": "mfsr.defog.pixels"}
# published H100 SXM peaks: HBM3, f32 and bfloat16 outside the tensor
# cores, and the SFU's exp (16 a clock per SM, 132 SMs, 1.98 GHz boost)
HBM_BYTES_S, F32_FLOPS_S, BF16_FLOPS_S, EXP_S = 3.35e12, 67e12, 133.8e12, 16 * 132 * 1.98e9
# operations per work item of each kernel's function: (f32 flops, exp),
# and where the kernel computes in bfloat16, a third field: its bfloat16
# flops (a lane's multiply or add one), which share the f32 pipes.
# A term shared by several items is spread over them: a tap's terms over
# its phases, a phase row's over the row's columns, a phase column's over
# the column's rows.
WORK = {
    # per (frame, input pixel, tap, phase): the quadratic as 2 FMAs on the
    # folded omega 4 + 1 exp; per channel w c 1, its sum 1 and w c v as an
    # FMA 2: 12 (no value x certainty: the value enters as it is); per
    # column dx 1 / s rows; per row dy, dy^2 o_yy, dy o_xy 4 / s columns;
    # per tap dy0, dx0 4 / s^2 phases: at s = 2 4 + 12 + 0.5 + 2 + 1 (both
    # order-0 forms)
    "merge_fast": (19.5, 1),
    # the same at s = 4: 4 + 12 + 0.25 + 1 + 0.25
    "merge_fast s=4": (17.5, 1),
    # order 1 at s = 2: the quadratic 4 + 1 exp; per channel w c 1, its
    # sum 1 and w c dy, w c dx, w c v as FMAs 6: 24 (no product of w
    # shared by the channels); per column 1 / 2, per row 4 / 2, per tap 4
    # / 4: 4 + 24 + 0.5 + 2 + 1
    "merge_fast order 1": (31.5, 1),
    # order 1 with 9 slots at s = 2: the quadratic 4 + 1 exp; per channel
    # w c, w c dy and w c dx as products and m00, m01, m02 as their sums
    # 6, m11, m12, m22 and b0, b1, b2 as FMAs of them with dy, dx and the
    # value 12: 3 x 18; per column 1 / 2, per row 4 / 2, per tap dy0, dx0
    # 4 / 4 (no product of w shared by the channels, and no value x
    # certainty: the value enters b0, b1, b2 as it is)
    "merge_fast 9 slots": (4 + 54 + 0.5 + 2 + 1, 1),
    "merge_fast 9 slots s=4": (4 + 54 + 0.25 + 1 + 0.25, 1),
    # per (frame, half-res pixel, tap, phase): two quadratics 8 + 2 exp,
    # two chain triples 10, four parities 2 FMAs each 16; per column dx 1
    # / S rows; per row dy, dy^2 and four products 6 / S columns; per tap
    # dy0, dx0 4 / S^2 phases: at S = 2 8 + 10 + 16 + 0.5 + 3 + 1
    "merge_raw": (38.5, 2),
    "merge_raw S=1": (34 + 1 + 6 + 4, 2),
    "merge_raw S=3": (34 + 1 / 3 + 2 + 4 / 9, 2),
    "merge_raw S=4": (34 + 0.25 + 1.5 + 0.25, 2),
    # order 0: two quadratics 8 + 2 exp, four parities' w c, w c v and two
    # sums 16; per column 1 / S, per row 6 / S, per tap 4 / S^2
    "merge_raw order 0": (8 + 16 + 0.5 + 3 + 1, 2),
    "merge_raw order 0 S=4": (8 + 16 + 0.25 + 1.5 + 0.25, 2),
    # 9 slots: two quadratics 8 + 2 exp; four parities' w c, dy w c and
    # dx w c 3, then m00, m01, m02 as sums 3 and m11, m12, m22, b0, b1, b2
    # as FMAs 12: 4 x 18; per parity row (column) the blended residual and
    # its displacement 8 / S (columns, rows)
    "merge_raw 9 slots": (8 + 72 + 8 / 2 + 8 / 2, 2),
    "merge_raw 9 slots S=4": (8 + 72 + 8 / 4 + 8 / 4, 2),
    # the per-cell plugin's 4 slots, reckoned as the 9: two quadratics 8 +
    # 2 exp; four parities' w c, w c v and four sums (two as FMAs) 4 x 8;
    # per parity row (column) the blended residual and its displacement
    "merge_raw cert4": (8 + 32 + 8 / 2 + 8 / 2, 2),
    "merge_raw cert4 S=4": (8 + 32 + 8 / 4 + 8 / 4, 2),
    # the knobs' variants of the per-cell form, reckoned as cert4: the exact
    # weights evaluate four quadratics (16) and four exp an item, the
    # residual blends at the weights' rows and columns as for the moments;
    # block and shared centroid's moment origins are per-frame choices;
    # the shared residual adds two FMAs a parity (8) and the fold per
    # output; the bfloat16 centroid rounds w c and forms two more products
    # per parity (4 x 4)
    "merge_raw exact4": (16 + 32 + 8 / 2 + 8 / 2, 4),
    "merge_raw exact4 S=4": (16 + 32 + 8 / 4 + 8 / 4, 4),
    "merge_raw exact9": (16 + 72 + 8 / 2 + 8 / 2, 4),
    "merge_raw exact9 S=4": (16 + 72 + 8 / 4 + 8 / 4, 4),
    "merge_raw shared": (8 + 40 + 8 / 2 + 8 / 2, 2),
    "merge_raw shared S=4": (8 + 40 + 8 / 4 + 8 / 4, 2),
    "merge_raw cbf16": (8 + 48 + 8 / 2 + 8 / 2, 2),
    # the pruned centroid: its 9 inner taps of the 21 at S=2 as cert4, the
    # other 12 m00 and b0 alone (4 x 4); at S=4 (k_max 4) e^-1 keeps all 21
    "merge_raw prune": (8 + (9 * 32 + 12 * 16) / 21 + 8 / 2 + 8 / 2, 2),
    "merge_raw prune S=4": (8 + 32 + 8 / 4 + 8 / 4, 2),
    "merge_raw cbf16 S=4": (8 + 48 + 8 / 4 + 8 / 4, 2),
    # the bfloat16 order 0: w c twice (the value's path rounded), the
    # weight's rounding and (w c) v, the two sums: 4 x 6 + 2 roundings
    "merge_raw order 0 bf16": (8 + 26 + 0.5 + 3 + 1, 2),
    "merge_raw order 0 bf16 S=4": (8 + 26 + 0.25 + 1.5 + 0.25, 2),
    # the RGB bfloat16 order 0 at s = 2: the weight's rounding in f32, and
    # per channel in bfloat16 w c (1), (v, 1) x (w c, w c) (2) and the
    # pair's add (2): 15; per tap dy0, dx0 4 / s^2 as for the f32 form
    "merge_fast bf16": (4 + 1 + 0.5 + 2 + 1, 1, 15),
    "merge_fast bf16 s=4": (4 + 1 + 0.25 + 1 + 0.25, 1, 15),
    # per element: A, t and R with their clips
    "defog": (11, 0),
    # per (frame, tile, offset, pixel): the cross term's multiply-add
    "tile_search": (2, 0),
    # a copy
    "tile_warp": (0, 0),
}
# the forms at scale 5 (the general kernels' scale on the paths): the same
# terms an item, the per-column, per-row and per-tap ones spread over s = 5
WORK.update({
    "merge_fast s=5": (4 + 12 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast order 1 s=5": (4 + 24 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast 9 slots s=5": (4 + 54 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast bf16 s=5": (4 + 1 + 1 / 5 + 4 / 5 + 4 / 25, 1, 15),
    "merge_raw S=5": (34 + 1 / 5 + 6 / 5 + 4 / 25, 2),
    "merge_raw order 0 S=5": (8 + 16 + 1 / 5 + 6 / 5 + 4 / 25, 2),
    "merge_raw order 0 bf16 S=5": (8 + 26 + 1 / 5 + 6 / 5 + 4 / 25, 2),
    "merge_raw 9 slots S=5": (8 + 72 + 8 / 5 + 8 / 5, 2),
    "merge_raw cert4 S=5": (8 + 32 + 8 / 5 + 8 / 5, 2),
    "merge_raw exact4 S=5": (16 + 32 + 8 / 5 + 8 / 5, 4),
    "merge_raw exact9 S=5": (16 + 72 + 8 / 5 + 8 / 5, 4),
    "merge_raw shared S=5": (8 + 40 + 8 / 5 + 8 / 5, 2),
    "merge_raw cbf16 S=5": (8 + 48 + 8 / 5 + 8 / 5, 2),
    # reckoned as cert4 (an upper bound: the taps outside the centroid add
    # m00 and b0 alone)
    "merge_raw prune S=5": (8 + 32 + 8 / 5 + 8 / 5, 2),
    # the general form's checks at s = 1 (a tap reach of 35): each
    # column's, row's and tap's terms on one phase
    "merge_fast s=1": (4 + 12 + 1 + 4 + 4, 1),
})


def ptxas_table(log: str) -> list:
    """One line per kernel instantiation of an nvcc -Xptxas -v log: the
    __global__ function with its template arguments, its registers and its
    spill stores and loads."""
    import re

    rows, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            # the nested name's parts in order, each <length><name> (the
            # namespace's may hold digits): the first ending in _kernel
            base, at = None, 3 if mangled.startswith("_ZN") else 2
            while base is None and (part := re.match(r"\d+", mangled[at:])):
                name_at = at + part.end()
                at = name_at + int(part.group())
                base = mangled[name_at:at] if mangled[name_at:at].endswith("_kernel") else None
            args = re.findall(r"L([ib])(\d+)E", mangled.split("_kernel", 1)[-1].split("EEv")[0] + "E")
            name = (base or mangled) + (
                "<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v for t, v in args) + ">"
                if args else "")
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            rows.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spills}")
            name = None
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(label: str, got, want, tol: dict, keep=None) -> float:
    """Print max abs and max rel error of ``got`` against ``want`` (tuples
    of tensors) beside the tolerance, raise outside it; return max abs.
    ``keep``: a bool mask over the outputs' leading axes; the comparison
    holds on the kept entries, and the others' count and largest
    difference are printed beside it."""
    worst = 0.0
    for i, (g, w_) in enumerate(zip(got, want)):
        note = ""
        if keep is not None:
            out = (g[~keep].double() - w_[~keep].double()).abs().flatten(1)
            differ = int((out > tol["atol"] + tol["rtol"] * w_[~keep].double().abs().flatten(1)).any(1).sum())
            note = (f"; {int((~keep).sum())} of {keep.numel()} tiles left out, {differ} of them beyond the "
                    f"tolerance, largest difference there {out.max().item() if out.numel() else 0.0:.3e}")
            g, w_ = g[keep], w_[keep]
        diff = (g.double() - w_.double()).abs()
        abs_err = diff.max().item()
        rel_err = (diff / w_.double().abs().clamp_min(1e-6)).max().item()
        if "share" in tol:
            beyond = (diff > 1e-4 + 1e-4 * w_.double().abs()).double().mean().item()
            note += f"; {beyond:.2e} of the values beyond 1e-4 (at most {tol['share']})"
            if beyond > tol["share"]:
                raise RuntimeError(f"{label}[{i}]: {beyond:.2e} of the values beyond float32 rounding")
        print(f"kernel check {label}[{i}]: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
              f"(tolerance rtol {tol['rtol']}, atol {tol['atol']}){note}")
        torch.testing.assert_close(g, w_, rtol=tol["rtol"], atol=tol["atol"])
        worst = max(worst, abs_err)
    return worst


def check_output(label: str, out: torch.Tensor, shape: tuple, lo: float = 0.0, hi: float = 1.0) -> None:
    if tuple(out.shape) != shape:
        raise RuntimeError(f"{label}: output shape {tuple(out.shape)}, expected {shape}")
    if not bool(torch.isfinite(out).all()) or out.min() < lo or out.max() > hi:
        raise RuntimeError(f"{label}: output not finite or outside [{lo}, {hi}]")


def polar_frames(rng: np.random.Generator, h: int, w: int):
    """Synthetic 0/45/90-degree polarization frames (H, W): a scene s under
    partial polarization of degree d and angle phi, I(a) = s/2 (1 + d
    cos 2(a - phi))."""
    s = (0.25 + 0.5 * rng.random((h, w))).astype(np.float32)
    d = np.linspace(0.1, 0.6, w, dtype=np.float32)[None, :]
    phi = (np.pi * rng.random((h, w))).astype(np.float32)
    return tuple((0.5 * s * (1.0 + d * np.cos(2.0 * (a - phi)))).astype(np.float32)
                 for a in (0.0, np.pi / 4, np.pi / 2))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from multi_frame_super_resolution_tpu_torch.apps import handheld_sr as handheld_app
    from multi_frame_super_resolution_tpu_torch.apps import multi_frame_sr as sr_app
    from multi_frame_super_resolution_tpu_torch.apps import polar_defog as defog_app
    from multi_frame_super_resolution_tpu_torch.config import (
        PORT_DEFAULT,
        RAW_BENCH,
        RAW_CERT,
        RAW_CERT_BF16,
        RAW_CERT_BLOCK,
        RAW_CERT_PRUNE,
        RAW_CERT_SHARED,
        RAW_CONSISTENT,
        RAW_EXACT,
        RAW_EXACT_WEIGHTS,
        RAW_FFT,
        RAW_GUIDED,
        RAW_ONEHOT_WARP,
        RAW_ORACLE,
        RAW_ORDER0,
        RAW_ORDER0_BF16,
        RAW_PORT_DEFAULT,
        RAW_SCALE4,
        RGB_BF16,
        RGB_CONSISTENT,
        RGB_DEFAULT,
        RGB_EXACT,
        RGB_HALF_STATS,
        RGB_ONEHOT_WARP,
        RGB_ORACLE,
        RGB_PALLAS,
        AlignConfig,
        BTVConfig,
        HandheldConfig,
        LKConfig,
        MergeConfig,
        PolarDefogConfig,
    )
    from multi_frame_super_resolution_tpu_torch.data import (
        CITY_ANGLES,
        DATASETS,
        mosaic_rggb,
        synthetic_burst,
        synthetic_dataset_burst,
        synthetic_polar_pair,
        synthetic_raw_burst,
        synthetic_rgb_burst,
        true_hr_burst,
        write_burst,
    )
    from multi_frame_super_resolution_tpu_torch.data import imread as read_png
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.kernels import defog as kdefog
    from multi_frame_super_resolution_tpu_torch.kernels import merge as kmerge
    from multi_frame_super_resolution_tpu_torch.kernels import merge_raw as kmerge_raw
    from multi_frame_super_resolution_tpu_torch.kernels import tile_search as ktile_search
    from multi_frame_super_resolution_tpu_torch.kernels import tile_warp as ktile_warp
    from multi_frame_super_resolution_tpu_torch.kernels.build import build_all
    from multi_frame_super_resolution_tpu_torch.models import btvl1
    from multi_frame_super_resolution_tpu_torch.models import defog as mdefog
    from multi_frame_super_resolution_tpu_torch.models import fast_merge, handheld
    from multi_frame_super_resolution_tpu_torch.ops import warp_fast
    from multi_frame_super_resolution_tpu_torch.ops.debayer import debayer
    from multi_frame_super_resolution_tpu_torch.ops.geometry import upscale
    from multi_frame_super_resolution_tpu_torch.ops.warp_fast import interleave_phases_planes
    from multi_frame_super_resolution_tpu_torch.registration import align, tiles
    from multi_frame_super_resolution_tpu_torch.registration.prealign import estimate_burst_similarity

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # 2. build, all five sources at once
    modules = (kmerge, ktile_warp, ktile_search, kmerge_raw, kdefog)
    t0 = time.perf_counter()
    libs = build_all(m.library for m in modules)
    print(f"build: {', '.join(m.SOURCE for m in modules)} in "
          f"{time.perf_counter() - t0:.2f} s (set-up, one nvcc each, in parallel)")
    ptxas = {m.NAME: ptxas_table(lib.build_log) for m, lib in zip(modules, libs)}
    for name, rows in ptxas.items():
        for row in rows or ["ptxas -v printed nothing (library already built)"]:
            print(f"  ptxas {name}: {row}")

    # plain versions with the wrappers' signatures
    def plain_tile_warp(imgs, shifts, t, bound=16, onehot=False):
        if onehot:
            return warp_fast.tile_warp_select(imgs, shifts[:, None], t, bound)
        return warp_fast.tile_warp_matmul(imgs, shifts, t, bound)

    # 3. each kernel against its plain version at its path's shapes
    rng = np.random.default_rng(0)
    merge_args = (SCALE, 1, 1.0, 1.0)
    rgb_ins = [torch.from_numpy(x).to(dev) for x in (
        rng.random((F, H, W, 3)).astype(np.float32),
        (rng.random((F, H, W, 2)) * 2.0 - 1.0).astype(np.float32),
        rng.random((F, H, W, 3)).astype(np.float32),
        np.concatenate([0.5 + rng.random((H, W, 2)), 0.1 * (0.5 + rng.random((H, W, 1)))], -1).astype(np.float32),
    )]
    hh, hw = H // 2, W // 2
    nty, ntx = hh // 16, hw // 16
    planes4 = torch.from_numpy(rng.random((F - 1, 4, hh, hw)).astype(np.float32)).to(dev)
    sep_shifts = torch.from_numpy(rng.integers(-20, 21, (F - 1, nty, ntx, 2)).astype(np.int32)).to(dev)
    blk_shifts = torch.from_numpy(rng.integers(-5, 6, (F - 1, nty, ntx, 2)).astype(np.int32)).to(dev)
    omega = 0.5 + rng.random((hh, hw, 3))
    omega[..., 2] *= 0.1
    raw_ins = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.random((F, 2, 2, hh, hw)), (rng.random((F, hh, hw, 2)) - 0.5) * 4.0,
        rng.random((F, hh, hw, 3)), omega, omega,
    )]
    cfa = RAW_PORT_DEFAULT.cfa_pattern
    raw_args = (cfa, SCALE, 1, 1.0, 1.0, RAW_PORT_DEFAULT.merge.prune_exp)
    # RAW_SCALE4's merge: 9 frames, k_max 4, R/B kernels wider
    raw9_ins = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.random((9, 2, 2, hh, hw)), (rng.random((9, hh, hw, 2)) - 0.5) * 4.0,
        rng.random((9, hh, hw, 3)), omega, omega * 0.5,
    )]
    prune = RGB_DEFAULT.merge.prune_exp
    # the timed variants of the two merges: (label, positional args,
    # keyword args, WORK key, tolerance) and (label, inputs, args, WORK key)
    phase = dict(phase_output=True, prune_exp=prune)
    merge_variants = [
        ("interleaved, e^-6 (use_pallas)", merge_args, {}, "merge_fast", KERNEL_TOL),
        ("phase layout, e^-1.5 (RGB_DEFAULT)", (2, 1, 1.0, 1.0), phase, "merge_fast", KERNEL_TOL),
        ("phase layout, e^-1.5, s=4", (4, 1, 1.0, 4.0), phase, "merge_fast s=4", KERNEL_TOL),
        ("order 1, e^-1.5 (rgb_order=1)", (2, 1, 1.0, 1.0),
         dict(phase, order=1), "merge_fast order 1", ORDER1_TOL),
        ("9 slots, e^-1.5 (RGB_EXACT)", (2, 1, 1.0, 1.0),
         dict(phase, order=1, moment_slots=9), "merge_fast 9 slots", ORDER1_TOL),
        ("9 slots, e^-1.5, s=4", (4, 1, 1.0, 4.0),
         dict(phase, order=1, moment_slots=9), "merge_fast 9 slots s=4", ORDER1_TOL),
        ("phase layout bf16, e^-1.5 (RGB_BF16)", (2, 1, 1.0, 1.0), dict(phase, bf16=True), "merge_fast bf16",
         BF16_TOL),
        ("phase layout bf16, e^-1.5, s=4", (4, 1, 1.0, 4.0), dict(phase, bf16=True), "merge_fast bf16 s=4",
         BF16_TOL),
        # tap radii 9 and 11 (k_max 64 at e^-6: 361 and 529 taps), past the
        # first build's 8: the templated layout, its staged halo raised
        ("phase layout, e^-6, tap radius 9", (2, 8, 1.0, 64.0), dict(phase, prune_exp=6.0), "merge_fast",
         KERNEL_TOL),
        ("phase layout, e^-6, tap radius 11", (2, 10, 1.0, 64.0), dict(phase, prune_exp=6.0), "merge_fast",
         KERNEL_TOL),
    ]
    # (label, inputs, args, keyword args, WORK key, tolerance)
    raw4_args = (cfa, 4, 1, 1.0, 4.0, prune)
    order0, slots9 = dict(order=0), dict(order=1, moment_slots=9)
    cert4 = dict(order=1, moment_slots=4, centroid_cert=True)
    guided = dict(guide=fast_merge.green_guide_planes(raw_ins[0], cfa).contiguous())
    # the knobs' kernel variants: (label, configuration, keyword arguments,
    # WORK key, tolerance), each at S=2 and (unguided) at S=4, F=9
    exact_w = dict(order=1, moment_slots=4, exact_weights=True)
    order0_bf16 = dict(order=0, bf16=True)
    knob_forms = [
        ("exact_weights", "RAW_EXACT_WEIGHTS", exact_w, "merge_raw exact4", ORDER1_TOL),
        ("exact_weights 9 slots", None, dict(slots9, exact_weights=True), "merge_raw exact9", ORDER1_TOL),
        ("cert block", "RAW_CERT_BLOCK", dict(cert4, centroid_block=True), "merge_raw cert4", ORDER1_TOL),
        ("cert shared", "RAW_CERT_SHARED", dict(cert4, centroid_shared_res=True), "merge_raw shared", ORDER1_TOL),
        ("cert prune", "RAW_CERT_PRUNE", dict(cert4, centroid_prune=1.0), "merge_raw prune", ORDER1_TOL),
        ("cert bf16", "RAW_CERT_BF16", dict(cert4, centroid_bf16=True), "merge_raw cbf16", CBF16_TOL),
        ("order 0 bf16", "RAW_ORDER0_BF16", order0_bf16, "merge_raw order 0 bf16", BF16_TOL),
        ("guided exact_weights", None, dict(guided, **exact_w), "merge_raw exact4", ORDER1_TOL),
        ("guided order 0 bf16", None, dict(guided, **order0_bf16), "merge_raw order 0 bf16", BF16_TOL),
    ]
    raw_variants = [
        ("S=2 (RAW_BENCH)", raw_ins, raw_args, {}, "merge_raw", KERNEL_TOL),
        ("S=1", raw_ins, (cfa, 1, 1, 1.0, 0.25, prune), {}, "merge_raw S=1", KERNEL_TOL),
        ("S=3", raw_ins, (cfa, 3, 1, 1.0, 2.25, prune), {}, "merge_raw S=3", KERNEL_TOL),
        ("S=4, F=9 (RAW_SCALE4)", raw9_ins, raw4_args, {}, "merge_raw S=4", KERNEL_TOL),
        ("order 0, S=2 (RAW_ORDER0)", raw_ins, raw_args, order0, "merge_raw order 0", KERNEL_TOL),
        ("order 0, S=4, F=9", raw9_ins, raw4_args, order0, "merge_raw order 0 S=4", KERNEL_TOL),
        ("9 slots, S=2 (RAW_EXACT)", raw_ins, raw_args, slots9, "merge_raw 9 slots", ORDER1_TOL),
        ("9 slots, S=4, F=9", raw9_ins, raw4_args, slots9, "merge_raw 9 slots S=4", ORDER1_TOL),
        ("cert4, S=2 (RAW_CERT)", raw_ins, raw_args, cert4, "merge_raw cert4", ORDER1_TOL),
        ("cert4, S=4, F=9", raw9_ins, raw4_args, cert4, "merge_raw cert4 S=4", ORDER1_TOL),
        ("guided, S=2 (RAW_GUIDED)", raw_ins, raw_args, guided, "merge_raw", KERNEL_TOL),
        ("guided order 0, S=2", raw_ins, raw_args, dict(guided, **order0), "merge_raw order 0", KERNEL_TOL),
        ("guided 9 slots, S=2", raw_ins, raw_args, dict(guided, **slots9), "merge_raw 9 slots", ORDER1_TOL),
        ("guided cert4, S=2", raw_ins, raw_args, dict(guided, **cert4), "merge_raw cert4", ORDER1_TOL),
        *((f"{label}, S=2 ({cfg_name})" if cfg_name else f"{label}, S=2", raw_ins, raw_args, kw, key, tol)
          for label, cfg_name, kw, key, tol in knob_forms),
        *((f"{label}, S=4, F=9", raw9_ins, raw4_args, kw, f"{key} S=4", tol)
          for label, _, kw, key, tol in knob_forms if "guided" not in label),
    ]
    # the general kernel forms: the values the templated kernels are not
    # built for, at the path's shapes: scale 5 (k_max (s/2)^2) in every
    # form and knob, taps past +-4, a non-Bayer pattern, the bfloat16
    # order 0 past its frame cap; the RGB forms at scale 5 and at tap
    # radii 9 and 11 (k_max 64 at e^-6: 361 and 529 taps); the search at
    # T=12, radius 0 and radius 30. And the RAW merge's streamed form:
    # bursts past the certless and order-0 frame caps (30 frames at S=2,
    # 66 at S=4)
    raw5_args = (cfa, 5, 1, 1.0, 2.5**2, prune)
    raw40_ins = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.random((40, 2, 2, hh, hw)), (rng.random((40, hh, hw, 2)) - 0.5) * 4.0, rng.random((40, hh, hw, 3)),
    )] + raw_ins[3:]
    raw70_ins = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.random((70, 2, 2, hh, hw)), (rng.random((70, hh, hw, 2)) - 0.5) * 4.0, rng.random((70, hh, hw, 3)),
    )] + raw9_ins[3:]
    raw_general = [  # (label, inputs, args, keyword args, WORK key, tolerance)
        ("general S=5 (RAW_BENCH scale 5)", raw_ins, raw5_args, {}, "merge_raw S=5", KERNEL_TOL),
        ("general order 0, S=5", raw_ins, raw5_args, order0, "merge_raw order 0 S=5", KERNEL_TOL),
        ("general 9 slots, S=5 (RAW_EXACT scale 5)", raw_ins, raw5_args, slots9, "merge_raw 9 slots S=5", ORDER1_TOL),
        ("general cert4, S=5 (RAW_CERT scale 5)", raw_ins, raw5_args, cert4, "merge_raw cert4 S=5", ORDER1_TOL),
        *((f"general {label}, S=5", raw_ins, raw5_args, kw, f"{key} S=5", tol)
          for label, _, kw, key, tol in knob_forms if "guided" not in label),
        ("general guided, S=5", raw_ins, raw5_args, guided, "merge_raw S=5", KERNEL_TOL),
        ("general order 0 bf16, F=40, S=2 (RAW_ORDER0_BF16 on 40 frames)", raw40_ins, raw_args, order0_bf16,
         "merge_raw order 0 bf16", BF16_TOL),
        ("general 109 taps, S=2", raw_ins, (cfa, SCALE, 5, 1.0, 1.0, 40.0), {}, "merge_raw", KERNEL_TOL),
    ]
    # the 9 slots of a Bayer merge at 3,721 taps (to +-30 at e^-1e4), past
    # any general block, on 3 frames of 64 x 128 (its plain version loops
    # over the taps, ~8.5 s a call: timed once, in its check)
    raw3721_ins = [x[:3, :, :, :64, :128].contiguous() if x.ndim == 5 else
                   (x[:3, :64, :128].contiguous() if x.shape[0] == F else x[:64, :128].contiguous())
                   for x in raw_ins]
    column = ((0, 1), (2, 1))
    raw_nonbayer = [  # (label, inputs, args, keyword args, WORK key, tolerance)
        ("nonbayer cfa ((0, 1), (2, 1)), S=2", raw_ins, (column, SCALE, 1, 1.0, 1.0, prune), {},
         "merge_raw", KERNEL_TOL),
        ("nonbayer order 0, cfa ((0, 1), (2, 1)), S=2", raw_ins, (column, SCALE, 1, 1.0, 1.0, prune), order0,
         "merge_raw order 0", KERNEL_TOL),
        ("nonbayer 9 slots, cfa ((0, 1), (2, 1)), S=2", raw_ins, (column, SCALE, 1, 1.0, 1.0, prune), slots9,
         "merge_raw 9 slots", ORDER1_TOL),
        ("nonbayer cert4, cfa ((0, 1), (2, 1)), S=2", raw_ins, (column, SCALE, 1, 1.0, 1.0, prune), cert4,
         "merge_raw cert4", ORDER1_TOL),
        ("nonbayer 3,721 taps 9 slots, S=2, 3 x 64 x 128", raw3721_ins, (cfa, SCALE, 29, 1.0, 1.0, 1e4), slots9,
         "merge_raw 9 slots", ORDER1_TOL),
    ]
    slow_plain, slow_out = {"merge_raw nonbayer 3,721 taps 9 slots, S=2, 3 x 64 x 128": None}, []
    raw_stream = [  # (label, inputs, args, keyword args, WORK key, tolerance)
        ("stream F=40, S=2 (RAW_BENCH on 40 frames)", raw40_ins, raw_args, {}, "merge_raw", KERNEL_TOL),
        ("stream order 0, F=40, S=2 (RAW_ORDER0 on 40 frames)", raw40_ins, raw_args, order0, "merge_raw order 0",
         KERNEL_TOL),
        ("stream F=70, S=4 (RAW_SCALE4 on 70 frames)", raw70_ins, raw4_args, {}, "merge_raw S=4", KERNEL_TOL),
        ("stream order 0, F=70, S=4", raw70_ins, raw4_args, order0, "merge_raw order 0 S=4", KERNEL_TOL),
    ]
    phase5 = (5, 1, 1.0, 2.5**2)
    merge_general = [  # (label, args, keyword args, WORK key, tolerance)
        ("general phase layout, e^-1.5, s=5 (RGB_DEFAULT scale 5)", phase5, phase, "merge_fast s=5", KERNEL_TOL),
        ("general interleaved, e^-6, s=5 (use_pallas scale 5)", phase5, {}, "merge_fast s=5", KERNEL_TOL),
        ("general order 1, e^-1.5, s=5", phase5, dict(phase, order=1), "merge_fast order 1 s=5", ORDER1_TOL),
        ("general 9 slots, e^-1.5, s=5", phase5, dict(phase, order=1, moment_slots=9), "merge_fast 9 slots s=5",
         ORDER1_TOL),
        ("general phase layout bf16, e^-1.5, s=5", phase5, dict(phase, bf16=True), "merge_fast bf16 s=5", BF16_TOL),
    ]
    # taps reaching past 34 (5,041 taps; the plain version loops over
    # them), the general form staged in bands of tap rows, launched as
    # merge_fast_unstaged (the kernel these merges ran on before): at s=1
    # on 5 x 16 x 32 (frames and bands spread over grid z) and on the limit
    # path's 4 x 64 x 128
    def crop(f, h, w):
        return [x[:f, :h, :w].contiguous() for x in rgb_ins[:3]] + [rgb_ins[3][:h, :w].contiguous()]

    merge_unstaged = [  # (label, inputs, args, keyword args, WORK key, tolerance)
        ("general phase layout, e^-6, tap reach 35, s=1, 16 x 32", crop(F, 16, 32), (1, 34, 1.0, 1e4),
         dict(phase, prune_exp=6.0), "merge_fast s=1", KERNEL_TOL),
        ("general phase layout, e^-6, tap reach 35, s=1, 4 x 64 x 128", crop(4, 64, 128), (1, 34, 1.0, 1e4),
         dict(phase, prune_exp=6.0), "merge_fast s=1", KERNEL_TOL),
    ]
    iper_np, ipar_np = synthetic_polar_pair(rng, DEFOG_H, DEFOG_W)
    defog_ins = [torch.from_numpy(x).to(dev) for x in (
        iper_np, ipar_np,
        (0.2 + 0.4 * rng.random(3)).astype(np.float32), (0.6 + 0.3 * rng.random(3)).astype(np.float32),
    )]

    def search_case(h, w, outliers, t=16):
        """(ref, alts, rounded) on the card: a synthetic burst of 5 frames
        shifted by up to 3 px, with noise, and predictions within 2 px of
        each alternate's shift (alt_f(p - d_f) = ref(p) for the crop
        offsets d_f) over the grid of tile size t; with ``outliers``, a
        tenth of the tiles predicted at 17-20 px instead, as a coarse
        level's miss would be."""
        burst, offsets = synthetic_burst(rng, F, h, w, 3.0)
        burst = burst + 0.01 * rng.standard_normal(burst.shape)
        grid = (F - 1, -(-h // t), -(-w // t))
        rounded = np.round(-offsets[1:])[:, None, None, :] + rng.integers(-2, 3, grid + (2,))
        if outliers:
            miss = rng.random(grid) < 0.1
            rounded[miss] = rng.choice([-1, 1], (miss.sum(), 2)) * rng.integers(17, 21, (miss.sum(), 2))
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (burst[0], burst[1:], rounded))

    # (label, inputs, radius, mode): the RAW main path's two levels
    search_cases = [
        ("tile_search image 4x128x256", search_case(hh, hw, True), 4, "image"),
        ("tile_search image 4x64x128", search_case(hh // 2, hw // 2, True), 4, "image"),
        ("tile_search tile 4x128x256", search_case(hh, hw, False), 4, "tile"),
        ("tile_search tile 4x64x128", search_case(hh // 2, hw // 2, False), 4, "tile"),
        ("tile_search tile 4x79x111 R=9", search_case(79, 111, False), 9, "tile"),
    ]

    def search_checks(label, ins, radius, mode, t=16, threshold=0.0, masks=None):
        """The subpixel and integer checks of one search; ``masks``: the
        (argmin, fit) masks of tiles.float32_undecided, whose tiles are
        left out of the integer check (argmin) and the subpixel check
        (either)."""
        def call(fn, sub):
            return lambda: (fn(*ins, t, radius, threshold, sub, mode),)
        undecided, ill = masks if masks is not None else (None, None)
        return [(label, call(ktile_search.tile_search, True), call(tiles.tile_search, True), SHIFT_TOL,
                 None if masks is None else ~(undecided | ill)),
                (f"{label} integer parts", call(ktile_search.tile_search, False),
                 call(tiles.tile_search, False), EXACT, None if masks is None else ~undecided)]

    def capture(run, targets):
        """run()'s result and the arguments, cloned, of every call it makes
        of the wrappers ``targets`` (name -> (module, attribute))."""
        seen = {name: [] for name in targets}
        with contextlib.ExitStack() as stack:
            for name, (module, attr) in targets.items():
                def record(*args, _fn=getattr(module, attr), _name=name, **kwargs):
                    seen[_name].append((tuple(a.clone() if torch.is_tensor(a) else a for a in args), kwargs))
                    return _fn(*args, **kwargs)
                stack.enter_context(mock.patch.object(module, attr, record))
            out = run()
        return out, seen

    def raw_burst_of(seed, n, h, w, angles):
        rgb, _ = synthetic_rgb_burst(np.random.default_rng(seed), n, h, w, 3.0, angles=angles)
        return torch.from_numpy(np.stack([mosaic_rggb(f, cfa) for f in rgb]))

    # RAW_SCALE4's searches (T=8, 8 alternates at 128 x 256 and 64 x 128)
    # and tile warp, as its path hands them over on a 9-frame burst
    # rotated as the city burst is (0/0/5/10/-15 degrees, repeated).
    # Pre-alignment clamps each rotated frame to its edge, so alternates
    # hold rows that repeat each other to within an ulp, and some SSD
    # surfaces are flat along one axis below float32 rounding: there the
    # argmin (and the border gate after it) is ranked by each
    # implementation's own rounding, the JAX function's too. Those tiles,
    # and subpixel fits of near-singular curvature, are left out by
    # tiles.float32_undecided (a float64 surface and float32's rounding
    # bound) and counted.
    city_angles9 = CITY_ANGLES + CITY_ANGLES[1:]
    raw9_city = raw_burst_of(2, 9, H, W, city_angles9).to(dev)
    LAUNCHES.clear()
    city_out, city_calls = capture(
        lambda: handheld.handheld_superres_raw(raw9_city, RAW_SCALE4),
        {"tile_search": (align, "tile_search"), "tile_warp": (handheld, "tile_warp")})
    torch.cuda.synchronize()
    city_launches = dict(LAUNCHES)
    for args, _ in city_calls["tile_search"]:
        c_ref, c_alts, c_rounded, c_t, c_radius, c_threshold, _, c_mode = args
        c_masks = tiles.float32_undecided(c_ref, c_alts, c_rounded, c_t, c_radius, c_threshold, c_mode)
        n_alts, c_h, c_w = c_alts.shape
        search_cases.append((f"tile_search {c_mode} {n_alts}x{c_h}x{c_w} T={c_t} (RAW_SCALE4, rotated)",
                             (c_ref, c_alts, c_rounded), c_radius, c_mode, c_t, c_threshold, c_masks))
    (w_imgs, w_shifts, w_t), w_kw = city_calls["tile_warp"][0]
    # the general search: (label, inputs, radius, mode, tile size), the
    # tiles float32 rounding decides left out of the checks past radius 0
    search_general = []
    for label, ins, radius, mode, t in (
            ("tile_search_general image 4x128x256 T=12", search_case(hh, hw, True, 12), 4, "image", 12),
            ("tile_search_general image 4x64x128 T=12", search_case(hh // 2, hw // 2, True, 12), 4, "image", 12),
            ("tile_search_general tile 4x128x256 R=0", search_case(hh, hw, False), 0, "tile", 16),
            ("tile_search_general image 4x128x256 R=0", search_case(hh, hw, True), 0, "image", 16),
            ("tile_search_general tile 4x128x256 R=30", search_case(hh, hw, False), 30, "tile", 16),
            ("tile_search_general tile 4x64x128 R=30", search_case(hh // 2, hw // 2, False), 30, "tile", 16)):
        masks = None if radius == 0 else tiles.float32_undecided(*ins, t, radius, 0.0, mode)
        search_general.append((label, ins, radius, mode, t, 0.0, masks))

    def merge_call(fn, args, kw):
        return lambda: fn(*rgb_ins, *args, **kw)

    def raw_call(fn, ins, args, kw):
        return lambda: fn(*ins, *args, **kw)

    calls = {  # name -> [(label, kernel call, plain call, tolerance)]
        "merge_fast": [(f"merge {label}", merge_call(kmerge.merge_fast, args, kw),
                        merge_call(kmerge.merge_fast_plain, args, kw), tol)
                       for label, args, kw, _, tol in merge_variants],
        "tile_warp": [
            ("tile_warp separable", lambda: (ktile_warp.tile_warp(planes4, sep_shifts, 16),),
             lambda: (plain_tile_warp(planes4, sep_shifts, 16),), EXACT),
            ("tile_warp block", lambda: (ktile_warp.tile_warp_block(planes4, blk_shifts, 16),),
             lambda: (warp_fast.tile_warp_block(planes4, blk_shifts, 16),), EXACT),
            ("tile_warp onehot (RAW_ONEHOT_WARP)", lambda: (ktile_warp.tile_warp(planes4, sep_shifts, 16, onehot=True),),
             lambda: (plain_tile_warp(planes4, sep_shifts, 16, onehot=True),), EXACT),
            (f"tile_warp {'x'.join(map(str, w_imgs.shape))} T={w_t} (RAW_SCALE4, rotated)",
             lambda: (ktile_warp.tile_warp(w_imgs, w_shifts, w_t, **w_kw),),
             lambda: (plain_tile_warp(w_imgs, w_shifts, w_t, **w_kw),), EXACT),
        ],
        "tile_search": [check for case in search_cases for check in search_checks(*case)],
        "merge_raw": [(f"merge_raw {label}", raw_call(kmerge_raw.merge_raw, ins, args, kw),
                       raw_call(kmerge_raw.merge_raw_plain, ins, args, kw), tol)
                      for label, ins, args, kw, _, tol in raw_variants],
        "defog": [("defog", lambda: kdefog.defog(*defog_ins),
                   lambda: kdefog.defog_pixels(*defog_ins), DEFOG_TOL)],
        "merge_fast_general": [(f"merge {label}", merge_call(kmerge.merge_fast, args, kw),
                                merge_call(kmerge.merge_fast_plain, args, kw), tol)
                               for label, args, kw, _, tol in merge_general],
        "tile_search_general": [check for case in search_general for check in search_checks(*case)],
        "merge_raw_general": [(f"merge_raw {label}", raw_call(kmerge_raw.merge_raw, ins, args, kw),
                               raw_call(kmerge_raw.merge_raw_plain, ins, args, kw), tol)
                              for label, ins, args, kw, _, tol in raw_general],
        "merge_raw_stream": [(f"merge_raw {label}", raw_call(kmerge_raw.merge_raw, ins, args, kw),
                              raw_call(kmerge_raw.merge_raw_plain, ins, args, kw), tol)
                             for label, ins, args, kw, _, tol in raw_stream],
        "merge_raw_nonbayer": [(f"merge_raw {label}", raw_call(kmerge_raw.merge_raw, ins, args, kw),
                                raw_call(kmerge_raw.merge_raw_plain, ins, args, kw), tol)
                               for label, ins, args, kw, _, tol in raw_nonbayer],
        "merge_fast_unstaged": [(f"merge {label}", raw_call(kmerge.merge_fast, ins, args, kw),
                                 raw_call(kmerge.merge_fast_plain, ins, args, kw), tol)
                                for label, ins, args, kw, _, tol in merge_unstaged],
    }
    max_abs_err, out_bytes = {}, {}
    for name, checks in calls.items():
        max_abs_err[name] = 0.0
        for label, kernel_call, plain_call, tol, *keep in checks:
            got = kernel_call()
            torch.cuda.synchronize()
            if label in slow_plain:  # its one timed call is this check's
                slow_plain[label] = time_cuda(lambda: slow_out.append(plain_call()), iters=1, warmup=0)
                want = slow_out.pop()
            else:
                want = plain_call()
            max_abs_err[label] = compare(label, got, want, tol, *keep)
            max_abs_err[name] = max(max_abs_err[name], max_abs_err[label])
            out_bytes[label] = sum(t.numel() * t.element_size() for t in got)
    # the bfloat16 forms against their float32 forms at the same inputs:
    # another function, most values apart beyond float32 rounding, by
    # about bfloat16's steps
    by_label = {check[0]: check for checks in calls.values() for check in checks}
    # (the bfloat16 centroid changes m01 and m02 alone: outputs 1 and 2)
    for b16, f32, outs in (
            ("merge phase layout bf16, e^-1.5 (RGB_BF16)", "merge phase layout, e^-1.5 (RGB_DEFAULT)", (0, 1)),
            ("merge_raw order 0 bf16, S=2 (RAW_ORDER0_BF16)", "merge_raw order 0, S=2 (RAW_ORDER0)", (0, 1)),
            ("merge_raw cert bf16, S=2 (RAW_CERT_BF16)", "merge_raw cert4, S=2 (RAW_CERT)", (1, 2))):
        b16_out, f32_out = by_label[b16][1](), by_label[f32][1]()
        for i in outs:
            g, f = b16_out[i], f32_out[i]
            diff = (g.double() - f.double()).abs()
            beyond = (diff > 1e-4 + 1e-4 * f.double().abs()).double().mean().item()
            rel = (diff / f.double().abs().clamp_min(1e-2)).max().item()
            print(f"bf16 against float32 {b16}[{i}]: max abs {diff.max().item():.3e}, max rel {rel:.3e} "
                  f"(denominators at least 1e-2), {beyond:.3f} of the values beyond 1e-4")
            if beyond < 0.5:
                raise RuntimeError(f"{b16} does not round as bfloat16: {beyond:.3f} of the values apart")

    # what each implementation gave on the tiles whose integer parts
    # differ: a zero shift is the border gate's (at threshold 0 the other
    # gate, min + 0 > max, cannot hold), or a minimum at the center
    for label, (c_ref, c_alts, c_rounded), c_radius, c_mode, c_t, c_threshold, masks in search_cases[-2:]:
        k_int, p_int = (fn(c_ref, c_alts, c_rounded, c_t, c_radius, c_threshold, False, c_mode)
                        for fn in (ktile_search.tile_search, tiles.tile_search))
        differ = (k_int != p_int).any(-1)
        kept = [int(((x == c_rounded).all(-1) & differ).sum()) for x in (k_int, p_int)]
        print(f"{label}: {int(differ.sum())} tiles' integer parts differ, {int((differ & ~masks[0]).sum())} "
              f"outside the argmin mask; a zero shift on {kept[0]} of them from the kernel, on {kept[1]} "
              f"from the plain version (threshold {c_threshold})")

    # the timed variants, each with its bound: its input and output bytes,
    # and its work items (WORK gives the operations per item); the other
    # kernels have one, their first check
    def n_taps(s, k_max, prune_exp, radius=1):
        return len(fast_merge._active_taps(radius + 1, 1.0, s, k_max, prune_exp))

    search_ins = search_cases[0][1]
    city_search = search_cases[-1]  # RAW_SCALE4's fine level
    timed = [  # (kernel, check label, inputs, work items, WORK key)
        *(("merge_fast", f"merge {label}", rgb_ins,
           F * H * W * n_taps(args[0], args[3], kw.get("prune_exp", 6.0), args[1]) * args[0] ** 2, key)
          for label, args, kw, key, _ in merge_variants),
        ("tile_warp", calls["tile_warp"][0][0], (planes4, sep_shifts), 0, "tile_warp"),
        ("tile_warp", calls["tile_warp"][3][0], (w_imgs, w_shifts), 0, "tile_warp"),
        ("tile_warp", calls["tile_warp"][2][0], (planes4, sep_shifts), 0, "tile_warp"),
        ("tile_search", calls["tile_search"][0][0], search_ins,
         search_ins[2].shape[0] * nty * ntx * (2 * search_cases[0][2] + 1) ** 2 * 16**2, "tile_search"),
        ("tile_search", city_search[0], city_search[1],
         city_search[1][2][..., 0].numel() * (2 * city_search[2] + 1) ** 2 * city_search[4] ** 2, "tile_search"),
        *(("merge_raw", f"merge_raw {label}", ins,
           ins[0].shape[0] * hh * hw * n_taps(args[1], args[4], args[5]) * args[1] ** 2, key)
          for label, ins, args, _, key, _ in raw_variants),
        ("defog", "defog", defog_ins, DEFOG_H * DEFOG_W * 3, "defog"),
        *(("merge_fast_general", f"merge {label}", rgb_ins,
           F * H * W * n_taps(args[0], args[3], kw.get("prune_exp", 6.0), args[1]) * args[0] ** 2, key)
          for label, args, kw, key, _ in merge_general),
        *(("tile_search_general", label, ins, ins[2][..., 0].numel() * (2 * radius + 1) ** 2 * t**2, "tile_search")
          for label, ins, radius, _, t, *_ in search_general),
        *((name, f"merge_raw {label}", ins,
           ins[0].shape[0] * ins[0].shape[3] * ins[0].shape[4] * n_taps(args[1], args[4], args[5], args[2])
           * args[1] ** 2, key)
          for name, variants in (("merge_raw_general", raw_general), ("merge_raw_stream", raw_stream),
                                 ("merge_raw_nonbayer", raw_nonbayer))
          for label, ins, args, _, key, _ in variants),
        *(("merge_fast_unstaged", f"merge {label}", ins,
           ins[0].shape[:3].numel() * n_taps(args[0], args[3], kw.get("prune_exp", 6.0), args[1]) * args[0] ** 2,
           key)
          for label, ins, args, kw, key, _ in merge_unstaged),
    ]
    # the variant each kernel's main path runs: its entry in the kernels line
    main_variant = {name: label for name, label, *_ in reversed(timed)}
    main_variant.update({"merge_fast": "merge phase layout, e^-1.5 (RGB_DEFAULT)",
                         "merge_raw": "merge_raw S=2 (RAW_BENCH)"})
    bounds, moved_bytes = {}, {}
    for name, label, ins, n_items, key in timed:
        moved = moved_bytes[label] = sum(t.numel() * t.element_size() for t in ins) + out_bytes[label]
        flops, exps, bf16_flops = (n * n_items for n in (*WORK[key], 0)[:3])
        bytes_ms = moved / HBM_BYTES_S * 1e3
        ops_ms = max(flops / F32_FLOPS_S + bf16_flops / BF16_FLOPS_S, exps / EXP_S) * 1e3
        bounds[label] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")
        bf16_part = f", {bf16_flops / 1e9:.3f} bfloat16 GFLOP" if bf16_flops else ""
        print(f"bound {label}: {moved / 1e6:.2f} MB moved ({bytes_ms * 1e3:.2f} us), {flops / 1e9:.3f} GFLOP"
              f"{bf16_part} and {exps / 1e6:.1f} M exp ({ops_ms * 1e3:.2f} us): {bounds[label][0] * 1e3:.2f} us, "
              f"bound by {bounds[label][1]}")

    # 4. the paths end to end on the card
    # each kernel -> the (module, attribute) its path calls its wrapper
    # through, and the plain version with the wrapper's signature
    wrappers = {
        "merge_fast": (handheld, "merge_fast", kmerge.merge_fast_plain),
        "tile_warp": (handheld, "tile_warp", plain_tile_warp),
        "merge_raw": (handheld, "merge_raw", kmerge_raw.merge_raw_plain),
        "tile_search": (align, "tile_search", tiles.tile_search),
        "defog": (mdefog, "defog", kdefog.defog_pixels),
    }

    @contextlib.contextmanager
    def plain_kernels():
        with contextlib.ExitStack() as stack:
            for module, attr, plain in wrappers.values():
                stack.enter_context(mock.patch.object(module, attr, plain))
            yield

    def drive(fn, inp, cfg, expect):
        """Run one path with the counts at 0 just before, read just after."""
        LAUNCHES.clear()
        out = fn(inp, cfg)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        missing = [k for k in expect if launches.get(k, 0) < 1]
        if missing:
            raise RuntimeError(f"the path did not launch {missing}: {launches}")
        return out, launches

    def against_plain(fn, inp, cfg):
        with plain_kernels():
            LAUNCHES.clear()
            out_plain = fn(inp, cfg)
            if LAUNCHES:
                raise RuntimeError(f"the plain run launched kernels: {dict(LAUNCHES)}")
        return out_plain

    def check_slice(label, fn, burst, cfg, expect, small_burst, runs=1, searches=None):
        """``runs``: the entry-point runs the path makes (2 for the
        cascade), each searching every pyramid level once; ``searches``,
        where the path makes another number of tile searches."""
        searches = runs * cfg.align.levels if searches is None else searches
        out, launches = drive(fn, burst, cfg, expect + (("tile_search",) if searches else ()))
        if launches.get("tile_search", 0) != searches:
            raise RuntimeError(f"{label}: {launches.get('tile_search', 0)} tile searches, {searches} expected")
        if out.device != dev:
            raise RuntimeError(f"{label}: the output lies on {out.device}, not on the default {dev}")
        check_output(label, out, (cfg.scale * burst.shape[1], cfg.scale * burst.shape[2], 3))
        p_plain = psnr(out, against_plain(fn, burst, cfg))
        p_cpu = psnr(fn(small_burst.to(dev), cfg).cpu(), fn(small_burst, cfg, device="cpu"))
        print(f"slice {label}: {tuple(burst.shape)} -> {tuple(out.shape)}, launches {launches}, "
              f"PSNR vs plain kernels {p_plain:.2f} dB, small burst card vs CPU {p_cpu:.2f} dB "
              f"(limit {PSNR_MIN} dB)")
        if p_plain < PSNR_MIN or p_cpu < PSNR_MIN:
            raise RuntimeError(f"slice {label} disagrees with its reference")
        return launches

    # the defog path: polar_defog on (Iper, Ipar) stacked as one input
    defog_cfg = PolarDefogConfig(beta=1.55)

    def run_defog(pair, cfg):
        return mdefog.polar_defog(pair[0], pair[1], cfg)

    pair = torch.stack([torch.from_numpy(iper_np), torch.from_numpy(ipar_np)]).to(dev)
    small_pair = torch.stack([torch.from_numpy(x) for x in synthetic_polar_pair(np.random.default_rng(1), 96, 136)])
    r_out, defog_launches = drive(run_defog, pair, defog_cfg, ("defog",))
    check_output("defog", r_out, (DEFOG_H, DEFOG_W, 3), defog_cfg.r_min, defog_cfg.r_max)
    p_plain = psnr(r_out, against_plain(run_defog, pair, defog_cfg))
    p_cpu = psnr(run_defog(small_pair.to(dev), defog_cfg).cpu(), run_defog(small_pair, defog_cfg))
    print(f"path defog: 2 x {DEFOG_H} x {DEFOG_W} x 3 -> R {tuple(r_out.shape)}, launches {defog_launches}, "
          f"R in [{r_out.min().item():.6f}, {r_out.max().item():.6f}], PSNR of R vs plain version "
          f"{p_plain:.2f} dB, small pair card vs CPU {p_cpu:.2f} dB (limit {PSNR_MIN} dB)")
    if p_plain < PSNR_MIN or p_cpu < PSNR_MIN:
        raise RuntimeError("the defog path disagrees with its reference")
    i0, i45, i90 = (torch.from_numpy(x).to(dev) for x in polar_frames(rng, DEFOG_H, DEFOG_W))
    stokes_cfg = PolarDefogConfig(beta=10.0)
    LAUNCHES.clear()
    s_per, s_par = mdefog.stokes_synthesis(i0, i45, i90)
    r_stokes = mdefog.polar_defog(s_per, s_par, stokes_cfg)
    torch.cuda.synchronize()
    check_output("defog (Stokes synthesis)", r_stokes, (DEFOG_H, DEFOG_W, 3), stokes_cfg.r_min, stokes_cfg.r_max)
    if LAUNCHES["defog"] != 1:
        raise RuntimeError(f"the Stokes input did not launch the defog kernel once: {dict(LAUNCHES)}")
    print(f"path defog from stokes_synthesis: 3 x {DEFOG_H} x {DEFOG_W} -> R finite in "
          f"[{r_stokes.min().item():.6f}, {r_stokes.max().item():.6f}], beta 10")
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            print("app polar_defog 0 3 1.55 (300 x 400 demo):")
            if defog_app.main(["0", "3", "1.55"]) != 0 or not os.path.getsize("R_gpu.png"):
                raise RuntimeError("the defog app failed")
        finally:
            os.chdir(cwd)

    rgb_np, _ = synthetic_rgb_burst(np.random.default_rng(0), F, H, W, 3.0, angles=CITY_ANGLES)
    rgb_burst = torch.from_numpy(rgb_np).to(dev)
    small_angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    rgb_small = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(1), 4, 64, 128, 2.5, angles=small_angles)[0])
    rgb_launches = check_slice("rgb (RGB_PALLAS)", handheld.handheld_superres, rgb_burst, RGB_PALLAS,
                               ("merge_fast", "tile_warp"), rgb_small)

    still_np, _ = synthetic_rgb_burst(np.random.default_rng(0), F, H, W, 3.0)
    rgb_still = torch.from_numpy(still_np).to(dev)
    rgb_still_small = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(1), 4, 64, 128, 2.5)[0])
    rgb_default_launches = check_slice("rgb (PORT_DEFAULT)", handheld.handheld_superres, rgb_still,
                                       PORT_DEFAULT, ("merge_fast", "tile_warp"), rgb_still_small)

    raw_rot = torch.from_numpy(np.stack([mosaic_rggb(f, cfa) for f in rgb_np])).to(dev)
    raw_small_rot = torch.from_numpy(
        synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5, angles=small_angles)[0])
    bench_launches = check_slice("raw (RAW_BENCH)", handheld.handheld_superres_raw, raw_rot, RAW_BENCH,
                                 ("tile_warp", "merge_raw"), raw_small_rot)

    # the pre-alignment estimates the two slices start from, card vs CPU
    gray_half = handheld.rgb_to_gray(handheld._subsample_from_planes(handheld.raw_to_planes(raw_rot), cfa))
    for label, gray, cfg in (("rgb", handheld.rgb_to_gray(rgb_burst), RGB_PALLAS),
                             ("raw half-res", gray_half, RAW_BENCH)):
        estimate_agreement(label, gray, cfg.prealign_cfg, estimate_burst_similarity)

    raw_burst = torch.from_numpy(np.stack([mosaic_rggb(f, cfa) for f in still_np])).to(dev)
    raw_small = torch.from_numpy(synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5)[0])
    raw_windows_cfg = dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(
        tile_size=16, search_radius=4, levels=2, fast_extract=False))
    stats = []
    noise_stat = handheld.temporal_noise_stat

    def recording_stat(gray, residual=None):
        stat = noise_stat(gray, residual=residual)
        stats.append(float(stat))
        return stat

    with mock.patch.object(handheld, "temporal_noise_stat", recording_stat):
        raw_launches = check_slice("raw (RAW_PORT_DEFAULT)", handheld.handheld_superres_raw, raw_burst,
                                   RAW_PORT_DEFAULT, ("tile_warp", "merge_raw"), raw_small)
    print(f"raw restore gate: temporal noise statistic {stats[0]:.6f} "
          f"(gate {RAW_PORT_DEFAULT.restore_gate_lo}-{RAW_PORT_DEFAULT.restore_gate_hi})")
    win_launches = check_slice("raw windows", handheld.handheld_superres_raw, raw_burst,
                               raw_windows_cfg, ("tile_warp", "merge_raw"), raw_small)

    # the default RGB branch, and RAW at scale 4 and as the cascade
    rgb_scale4 = HandheldConfig(scale=4)
    rgb_order1 = dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(rgb_order=1))
    default_launches = check_slice("rgb (RGB_DEFAULT)", handheld.handheld_superres, rgb_burst, RGB_DEFAULT,
                                   ("merge_fast", "tile_warp"), rgb_small)
    scale4_launches = check_slice("rgb scale 4", handheld.handheld_superres, rgb_burst, rgb_scale4,
                                  ("merge_fast", "tile_warp"), rgb_small)
    order1_launches = check_slice("rgb order 1", handheld.handheld_superres, rgb_burst, rgb_order1,
                                  ("merge_fast", "tile_warp"), rgb_small)
    # RAW_SCALE4's bursts: rotations within +-0.01 rad, as the JAX
    # package's scale-4 protocol draws them (tools/eval_fidelity.py::
    # make_hr_burst). On the city burst's 5-15 degrees the search's
    # rounding-ranked tiles (phase 3) move whole tiles' shifts, so that
    # run's agreement is stated below without a limit
    def small_angles(n):
        return (0.0,) + tuple(np.random.default_rng(3).uniform(-0.01, 0.01, n - 1).tolist())

    raw9 = raw_burst_of(2, 9, H, W, small_angles(9)).to(dev)
    raw4_launches = check_slice("raw (RAW_SCALE4)", handheld.handheld_superres_raw, raw9, RAW_SCALE4,
                                ("tile_warp", "merge_raw"), raw_burst_of(1, 9, 64, 128, small_angles(9)))
    cascade = handheld.handheld_superres_raw_cascade
    raw5 = raw_burst_of(2, 5, H, W, small_angles(5)).to(dev)
    cascade_launches = check_slice("raw cascade (RAW_SCALE4)", cascade, raw5, RAW_SCALE4,
                                   ("tile_warp", "merge_raw"), raw_burst_of(1, 5, 64, 128, small_angles(5)), runs=2)
    check_output("raw (RAW_SCALE4, rotated 5-15 degrees)", city_out, (4 * H, 4 * W, 3))
    city_small = raw_burst_of(1, 9, 64, 128, city_angles9)
    p_plain = psnr(city_out, against_plain(handheld.handheld_superres_raw, raw9_city, RAW_SCALE4))
    p_cpu = psnr(handheld.handheld_superres_raw(city_small.to(dev), RAW_SCALE4).cpu(),
                 handheld.handheld_superres_raw(city_small, RAW_SCALE4, device="cpu"))
    print(f"slice raw (RAW_SCALE4) on the 5-15 degree rotations, stated without a limit: "
          f"{tuple(raw9_city.shape)} -> {tuple(city_out.shape)}, launches {city_launches}, PSNR vs plain "
          f"kernels {p_plain:.2f} dB, small burst card vs CPU {p_cpu:.2f} dB (the tiles the search's "
          f"rounding ranks: phase 3)")
    del city_out, raw9_city  # out of the timed paths' peak memory
    if cascade_launches["merge_raw"] != 2:
        raise RuntimeError(f"the cascade launched merge_raw {cascade_launches['merge_raw']} times, not 2")

    # the correctness bar's paths (PARITY.md): the gather oracle, whose one
    # kernel of csrc/ is the tile search, the exact 3x3 solve through the
    # 9-moment merge forms, and the RAW order-0 merge form
    bar_paths = (
        ("raw (RAW_ORACLE)", handheld.handheld_superres_raw, raw_rot, RAW_ORACLE, (), raw_small_rot),
        ("raw (RAW_EXACT)", handheld.handheld_superres_raw, raw_rot, RAW_EXACT, ("tile_warp", "merge_raw"),
         raw_small_rot),
        ("raw (RAW_ORDER0)", handheld.handheld_superres_raw, raw_rot, RAW_ORDER0, ("tile_warp", "merge_raw"),
         raw_small_rot),
        ("rgb (RGB_ORACLE)", handheld.handheld_superres, rgb_burst, RGB_ORACLE, (), rgb_small),
        ("rgb (RGB_EXACT)", handheld.handheld_superres, rgb_burst, RGB_EXACT, ("merge_fast", "tile_warp"), rgb_small),
    )
    bar_launches = {}
    for label, fn, burst, cfg, expect, small in bar_paths:
        bar_launches[label] = check_slice(label, fn, burst, cfg, expect, small)
        if set(bar_launches[label]) != set(expect) | {"tile_search"}:
            raise RuntimeError(f"{label} launched {bar_launches[label]}, expected {expect} and the tile search")
        if any(bar_launches[label][k] != 1 for k in expect):
            raise RuntimeError(f"{label} launched {bar_launches[label]}, each of {expect} once expected")

    # the handheld knobs (ROADMAP Queue 1 items 7 and 13, lk.warp_tile):
    # the guided and per-cell merge forms, the consistency solve (a search
    # per level for each first frame of a measured pair: F-1 of them),
    # the FFT surfaces (no tile search) and LK's tile-decomposed warp.
    # The consistent RGB path's small burst is 128 x 256: at 64 x 128 one
    # edge tile's outlier decision is float32 rounding's (PERF.md)
    rgb_small_wide = torch.from_numpy(synthetic_rgb_burst(
        np.random.default_rng(1), 4, 128, 256, 2.5, angles=CITY_ANGLES[:2] + CITY_ANGLES[3:])[0])
    raw_warp_tile = dataclasses.replace(RAW_BENCH, lk=LKConfig(warp_tile=16))
    raw_kernels = ("tile_warp", "merge_raw")
    knob_paths = (  # (label, entry point, burst, config, kernels, small burst, tile searches)
        ("raw (RAW_GUIDED)", handheld.handheld_superres_raw, raw_rot, RAW_GUIDED, raw_kernels, raw_small_rot, None),
        ("raw (RAW_CERT)", handheld.handheld_superres_raw, raw_rot, RAW_CERT, raw_kernels, raw_small_rot, None),
        ("raw (RAW_CONSISTENT)", handheld.handheld_superres_raw, raw_rot, RAW_CONSISTENT, raw_kernels,
         raw_small_rot, (F - 1) * RAW_CONSISTENT.align.levels),
        ("raw (RAW_FFT)", handheld.handheld_superres_raw, raw_rot, RAW_FFT, raw_kernels, raw_small_rot, 0),
        ("raw lk.warp_tile=16", handheld.handheld_superres_raw, raw_rot, raw_warp_tile, raw_kernels,
         raw_small_rot, None),
        ("rgb (RGB_CONSISTENT)", handheld.handheld_superres, rgb_burst, RGB_CONSISTENT, ("merge_fast", "tile_warp"),
         rgb_small_wide, (F - 1) * RGB_CONSISTENT.align.levels),
        # the merge and warp knobs: the per-cell form's variants, the
        # bfloat16 order-0 forms, the one-hot tile warp, half-res statistics
        *((f"raw ({name})", handheld.handheld_superres_raw, raw_rot, cfg, raw_kernels, raw_small_rot, None)
          for name, cfg in (("RAW_EXACT_WEIGHTS", RAW_EXACT_WEIGHTS), ("RAW_CERT_BLOCK", RAW_CERT_BLOCK),
                            ("RAW_CERT_SHARED", RAW_CERT_SHARED), ("RAW_CERT_PRUNE", RAW_CERT_PRUNE),
                            ("RAW_CERT_BF16", RAW_CERT_BF16), ("RAW_ORDER0_BF16", RAW_ORDER0_BF16),
                            ("RAW_ONEHOT_WARP", RAW_ONEHOT_WARP))),
        *((f"rgb ({name})", handheld.handheld_superres, rgb_burst, cfg, ("merge_fast", "tile_warp"), rgb_small, None)
          for name, cfg in (("RGB_BF16", RGB_BF16), ("RGB_HALF_STATS", RGB_HALF_STATS),
                            ("RGB_ONEHOT_WARP", RGB_ONEHOT_WARP))),
    )
    knob_launches = {}
    for label, fn, burst, cfg, expect, small, searches in knob_paths:
        launches = knob_launches[label] = check_slice(label, fn, burst, cfg, expect, small, searches=searches)
        if set(launches) != set(expect) | ({"tile_search"} if searches != 0 else set()):
            raise RuntimeError(f"{label} launched {launches}, expected {expect} and its tile searches")
        if any(launches[k] != 1 for k in expect):
            raise RuntimeError(f"{label} launched {launches}, each of {expect} once expected")

    # the port's former limits, each a value the JAX function computes and
    # the templated kernels are not built for, through the general kernel
    # forms at the city geometry (taps past a reach of 34 on the small
    # burst): the run's launches exactly (the general
    # form once per merge and once per pyramid level), the output's shape,
    # finite values in [0, 1], and 60 dB against the same path on the
    # plain versions
    def check_limit(label, fn, burst, cfg, merge_name, searches=None):
        levels = cfg.align.levels
        want = {"tile_warp": 1, merge_name: 1, **(searches or {"tile_search": levels})}
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn(burst, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in LAUNCHES.items() if v}
        if launches != want:
            raise RuntimeError(f"{label} launched {launches}, expected {want}")
        check_output(label, out, (cfg.scale * burst.shape[1], cfg.scale * burst.shape[2], 3))
        p_plain = psnr(out, against_plain(fn, burst, cfg))
        print(f"limit {label}: {tuple(burst.shape)} -> {tuple(out.shape)}, launches {launches}, PSNR vs plain "
              f"kernels {p_plain:.2f} dB (limit {PSNR_MIN} dB), {host_ms:.1f} ms host clock (first run)  [{card}]")
        if p_plain < PSNR_MIN:
            raise RuntimeError(f"limit {label} disagrees with its plain run")
        return launches

    raw_fn, rgb_fn = handheld.handheld_superres_raw, handheld.handheld_superres
    raw40 = raw_burst_of(3, 40, H, W, None).to(dev)
    raw70 = raw_burst_of(4, 70, H, W, small_angles(70)).to(dev)
    cfa_ng = ((0, 1), (2, 1))
    raw_ng = torch.from_numpy(np.stack([mosaic_rggb(f, cfa_ng) for f in rgb_np])).to(dev)
    port_align = dict(tile_size=16, search_radius=4, levels=2)
    limit_paths = (  # (label, entry point, burst, configuration, merge kernel, tile searches)
        ("raw (RAW_BENCH scale 5)", raw_fn, raw_rot, dataclasses.replace(RAW_BENCH, scale=5), "merge_raw_general",
         None),
        ("rgb (RGB_DEFAULT scale 5)", rgb_fn, rgb_burst, dataclasses.replace(RGB_DEFAULT, scale=5),
         "merge_fast_general", None),
        ("raw (RAW_BENCH on 40 frames)", raw_fn, raw40, RAW_BENCH, "merge_raw_stream", None),
        ("raw (RAW_ORDER0 on 40 frames)", raw_fn, raw40, RAW_ORDER0, "merge_raw_stream", None),
        ("raw (RAW_ORDER0_BF16 on 40 frames)", raw_fn, raw40, RAW_ORDER0_BF16, "merge_raw_general", None),
        ("raw (RAW_SCALE4 on 70 frames)", raw_fn, raw70, RAW_SCALE4, "merge_raw_stream", None),
        ("raw (RAW_BENCH radius 5, e^-40: 109 taps)", raw_fn, raw_rot,
         dataclasses.replace(RAW_BENCH, merge=MergeConfig(radius=5, prune_exp=40.0)), "merge_raw_general", None),
        ("rgb (RGB_DEFAULT radius 8: tap radius 9)", rgb_fn, rgb_burst,
         dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(radius=8)), "merge_fast", None),
        ("rgb (RGB_DEFAULT radius 10: tap radius 11)", rgb_fn, rgb_burst,
         dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(radius=10)), "merge_fast", None),
        ("raw (RAW_PORT_DEFAULT tile_size=12)", raw_fn, raw_burst,
         dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(**{**port_align, "tile_size": 12})), "merge_raw",
         {"tile_search_general": 2}),
        ("raw (RAW_PORT_DEFAULT fine_radius=0)", raw_fn, raw_burst,
         dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(**port_align, fine_radius=0)), "merge_raw",
         {"tile_search": 1, "tile_search_general": 1}),
        ("raw windows (RAW_PORT_DEFAULT search_radius=30)", raw_fn, raw_burst,
         dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(**{**port_align, "search_radius": 30},
                                                                 fast_extract=False)), "merge_raw",
         {"tile_search_general": 2}),
        ("raw (RAW_BENCH cfa ((0, 1), (2, 1)))", raw_fn, raw_ng, dataclasses.replace(RAW_BENCH, cfa_pattern=cfa_ng),
         "merge_raw_nonbayer", None),
        ("raw (RAW_CERT scale 5)", raw_fn, raw_rot, dataclasses.replace(RAW_CERT, scale=5), "merge_raw_general", None),
        ("raw (RAW_EXACT scale 5)", raw_fn, raw_rot, dataclasses.replace(RAW_EXACT, scale=5), "merge_raw_general",
         None),
        # taps past a reach of 34 (35: 5,041 taps, the general form in bands
        # of tap rows) on the small burst: the plain run loops over every tap
        ("rgb (RGB_DEFAULT scale 1, radius 34, e^-1e4: tap radius 35) on 4 x 64 x 128", rgb_fn, rgb_small.to(dev),
         dataclasses.replace(RGB_DEFAULT, scale=1, merge=MergeConfig(radius=34, prune_exp=1e4)),
         "merge_fast_unstaged", None),
    )
    t_limits = time.perf_counter()
    limit_launches = {label: check_limit(label, fn, burst, cfg, merge_name, searches)
                      for label, fn, burst, cfg, merge_name, searches in limit_paths}
    print(f"limit paths: {time.perf_counter() - t_limits:.1f} s")
    del raw40, raw70, raw_ng

    # the correctness bar on the card: true-HR PSNR (16 px margin) of each
    # row on data.true_hr_burst, beside PARITY.md's (another scene); no limit
    raw_hr_np, hr_np = true_hr_burst()
    raw_hr, hr = torch.from_numpy(raw_hr_np).to(dev), torch.from_numpy(hr_np).to(dev)

    def hr_psnr(sr, margin=16):
        return psnr(sr[margin:-margin, margin:-margin], hr[margin:-margin, margin:-margin])

    bar_rows = (
        ("oracle (RAW_ORACLE)", RAW_ORACLE, "28.09"),
        ("fast + exact 3x3 solve (RAW_EXACT)", RAW_EXACT, "27.90"),
        ("fast + plugin, 2 iterations", dataclasses.replace(RAW_BENCH, merge=MergeConfig(plugin_iters=2)), "27.84"),
        ("fast default (RAW_BENCH)", RAW_BENCH, "27.75"),
        ("fast + guided R/B (RAW_GUIDED)", RAW_GUIDED, None),
        ("fast + per-cell centroid (RAW_CERT)", RAW_CERT, None),
        ("fast + exact weights (RAW_EXACT_WEIGHTS)", RAW_EXACT_WEIGHTS, None),
        ("fast + block-centre centroid (RAW_CERT_BLOCK)", RAW_CERT_BLOCK, None),
        ("fast + shared-residual centroid (RAW_CERT_SHARED)", RAW_CERT_SHARED, None),
        ("fast + pruned centroid (RAW_CERT_PRUNE)", RAW_CERT_PRUNE, None),
        ("fast + bf16 centroid (RAW_CERT_BF16)", RAW_CERT_BF16, None),
        ("fast order 0 bf16 (RAW_ORDER0_BF16)", RAW_ORDER0_BF16, None),
        ("fast + one-hot tile warp (RAW_ONEHOT_WARP)", RAW_ONEHOT_WARP, None),
    )
    for label, cfg, parity_db in bar_rows:
        sr = handheld.handheld_superres_raw(raw_hr, cfg)
        check_output(f"true-HR {label}", sr, tuple(hr.shape))
        beside = "no PARITY.md row" if parity_db is None else f"PARITY.md, another scene: {parity_db} dB"
        print(f"correctness bar {label}: true-HR PSNR {hr_psnr(sr):.4f} dB on {tuple(raw_hr.shape)} -> "
              f"{tuple(sr.shape)} ({beside})  [{card}]")
    base = upscale(debayer(raw_hr[0], cfa), 2, "bicubic").clamp(0.0, 1.0)
    print(f"correctness bar demosaic + bicubic (frame 0): true-HR PSNR {hr_psnr(base):.4f} dB "
          f"(tests/test_fidelity.py, another scene: 25.39 dB)  [{card}]")
    del raw_hr, hr, sr, base

    # BTV-L1 (models/btvl1.py) at the app's configuration, each flow on the
    # city burst (rgb_np is synthetic_dataset_burst("city")): plain
    # PyTorch, no kernel of csrc/ (the JAX path reaches no Pallas kernel)
    btv_cfgs = {flow: BTVConfig(scale=2, iterations=10, temporal_radius=1, optical_flow=flow) for flow in BTV_FLOWS}
    btv_small = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(1), 3, 64, 96, 2.0)[0])
    btv_launches = {}
    t_btv = time.perf_counter()
    for flow, cfg in btv_cfgs.items():
        LAUNCHES.clear()
        out = btvl1.btvl1_video(rgb_burst, cfg)
        torch.cuda.synchronize()
        btv_launches[flow] = dict(LAUNCHES)
        if out.device != dev:
            raise RuntimeError(f"btvl1 {flow}: the output lies on {out.device}, not on the default {dev}")
        check_output(f"btvl1 {flow}", out, (F, 2 * H, 2 * W, 3))
        p_cpu = psnr(btvl1.btvl1_video(btv_small.to(dev), cfg).cpu(), btvl1.btvl1_video(btv_small, cfg, device="cpu"))
        print(f"path btvl1_video {flow}: {tuple(rgb_burst.shape)} -> {tuple(out.shape)} in [{out.min().item():.4f}, "
              f"{out.max().item():.4f}], launches {btv_launches[flow]} (none of csrc/), small burst "
              f"{tuple(btv_small.shape)} card vs CPU {p_cpu:.2f} dB (limit {PSNR_MIN} dB)")
        if p_cpu < PSNR_MIN:
            raise RuntimeError(f"btvl1_video {flow} on the card disagrees with the port on the CPU")
    del out
    with tempfile.TemporaryDirectory() as tmp:
        write_burst("city", rgb_np, os.path.join(tmp, "data"))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            print("app multi_frame_sr pyrlk city 10 (the city burst as PNGs, MFSR_SR_CYCLES=4):")
            with mock.patch.dict(os.environ, {"MFSR_DATA_DIR": os.path.join(tmp, "data"), "MFSR_SR_CYCLES": "4"}):
                rc = sr_app.main(["pyrlk", "city", "10"])
            if rc != 0 or not all(os.path.getsize(f"city_pyrlk_{k}_result.png") for k in ("sr", "sr2")):
                raise RuntimeError("the multi_frame_sr app failed")
            # the handheld app on the same PNGs, under its own protocol
            for argv in (["city", "2"], ["city", "2", "--raw"]):
                print(f"app handheld_sr {' '.join(argv)} (the city burst as PNGs):")
                with mock.patch.dict(os.environ, {"MFSR_DATA_DIR": os.path.join(tmp, "data")}):
                    rc = handheld_app.main(argv)
                out_png = read_png("city_handheld_sr.png")
                if rc != 0 or out_png.shape != (2 * H, 2 * W, 3):
                    raise RuntimeError(f"the handheld_sr app failed on {argv}: {out_png.shape}")
        finally:
            os.chdir(cwd)
    print(f"btvl1 paths and apps: {time.perf_counter() - t_btv:.1f} s")

    # single-image DNN SR (models/dnn_sr.py): cuDNN convolutions in
    # float32 (the JAX package computes them in XLA), no kernel of csrc/
    dnn_launches = dnn_sr_paths(dev, card)

    # the multi-device layer and the readers, meshes of positions on cuda:0
    mesh_launches = multi_device_paths(dev, card, raw_rot)

    # 5. timing: kernels beside their plain versions, then the paths
    kernel_ms, plain_ms, device_ms, plain_device = {}, {}, {}, {}
    checks_by_label = {check[0]: check for checks in calls.values() for check in checks}
    for name, label, *_ in timed:
        _, kernel_call, plain_call, *_ = checks_by_label[label]
        k1 = time_cuda(kernel_call, iters=50, warmup=5)
        p = slow_plain[label] if label in slow_plain else time_cuda(plain_call, iters=5, warmup=2)
        k2 = time_cuda(kernel_call, iters=50, warmup=5)
        kernel_ms[label], plain_ms[label] = k1, p
        device_ms[label] = device_time(kernel_call, KERNEL_SYMBOLS[name])[0]
        print(f"kernel {name} ({label}): kernel {k1:.4f} / {k2:.4f} ms per call, "
              f"{device_ms[label]:.5f} ms device time (profiler), bound {bounds[label][0]:.5f} ms "
              f"({bounds[label][1]}): {100.0 * bounds[label][0] / device_ms[label]:.1f}% of bound; "
              f"plain {p:.4f} ms per call  [{card}]")
    # the search's yardstick: every device op of the plain search it replaces
    plain_device["tile_search"] = device_time(calls["tile_search"][0][2])
    search_ms = device_ms[main_variant["tile_search"]]
    print(f"tile_search against the plain search ({calls['tile_search'][0][0]}): kernel "
          f"{search_ms:.5f} ms device time in 1 launch; plain "
          f"{plain_device['tile_search'][0]:.5f} ms device time over {plain_device['tile_search'][1]:.0f} "
          f"device ops per call ({plain_device['tile_search'][0] / search_ms:.1f}x)  [{card}]")
    # the merge's time that does not grow with the frames: one frame beside F
    one_frame = [t[:1].contiguous() if t.ndim == 4 else t for t in rgb_ins]
    for label, args, kw, *_ in merge_variants[:2]:
        ms_one = device_time(lambda: kmerge.merge_fast(*one_frame, *args, **kw), KERNEL_SYMBOLS["merge_fast"])[0]
        ms_f = device_ms[f"merge {label}"]
        print(f"merge_fast {label} by frames: {ms_one:.5f} ms device time at F=1, {ms_f:.5f} at F={F}: "
              f"{(ms_f - ms_one) / (F - 1):.5f} ms per further frame  [{card}]")
    # merge_fast's form 0 (interleaved, outputs parked) against form 1
    # (phase layout) plus the interleave the default branch runs after
    # it, at RGB_PALLAS's merge: every device op of each
    def form1_interleaved():
        return tuple(interleave_phases_planes(x)
                     for x in kmerge.merge_fast(*rgb_ins, *merge_args, phase_output=True))

    form0 = merge_call(kmerge.merge_fast, merge_args, {})
    compare("merge form 1 + interleave against form 0", form1_interleaved(), form0(), KERNEL_TOL)
    ms0, ops0 = device_time(form0)
    ms1, ops1 = device_time(form1_interleaved)
    print(f"merge_fast form 0 (interleaved, e^-6): {ms0:.5f} ms device time over {ops0:.0f} device ops; form 1 "
          f"(phase layout, e^-6) + interleave_phases_planes: {ms1:.5f} ms over {ops1:.0f}  [{card}]")
    # the copy floor of the copy kernel: a plain device-to-device copy of
    # half the kernel's moved bytes, rounded down to 64 KiB (a tensor of
    # its input's shape), so it reads and writes as many bytes. The
    # unrounded size is timed beside it: past 2 MiB the copy can take
    # another, slower path.
    copy_floor_ms = {}
    for name in ("tile_warp",):
        label = main_variant[name]
        sizes = (max(moved_bytes[label] // 8 // 16384, 1) * 16384, moved_bytes[label] // 8)
        copy_ms = []
        for numel in sizes:
            src = torch.rand(numel, device=dev)
            dst = torch.empty_like(src)
            copy_ms.append(device_time(lambda: dst.copy_(src))[0])
            del src, dst  # out of the paths' peak memory
        copy_floor_ms[name] = copy_ms[0]
        print(f"copy floor {name}: dst.copy_(src) of {sizes[0]} float32 ({2 * sizes[0] * 4 / 1e6:.2f} MB moved, the "
              f"kernel's bytes) {copy_ms[0]:.5f} ms device time (profiler; {sizes[1]} floats unrounded: "
              f"{copy_ms[1]:.5f} ms); the kernel {device_ms[label]:.5f} ms, "
              f"{100.0 * (device_ms[label] / copy_floor_ms[name] - 1.0):+.1f}% against it, "
              f"{100.0 * bounds[label][0] / device_ms[label]:.1f}% of its bound {bounds[label][0]:.5f} ms  [{card}]")

    def time_slice(label, fn, burst, cfg):
        bursts = [burst * (1.0 - 1e-5 * i) for i in range(13)]
        times = []
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(bursts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            start.record()
            fn(b, cfg)
            end.record()
            end.synchronize()
            if i >= 3:  # the first three are warm-up
                times.append((start.elapsed_time(end), (time.perf_counter() - t_host) * 1e3))
        ms = statistics.median(t[0] for t in times)
        host_ms = statistics.median(t[1] for t in times)
        mp_s = cfg.scale * burst.shape[1] * cfg.scale * burst.shape[2] / (ms * 1e-3) / 1e6
        print(f"slice timing {label}: median {ms:.3f} ms/burst (host clock {host_ms:.3f} ms) over "
              f"{len(times)} bursts, {mp_s:.2f} output MP/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB  [{card}]")
        return ms

    def defog_frame(scale):
        return mdefog.polar_defog(pair[0] * scale, pair[1], defog_cfg)

    defog_ms, defog_dev_ms = defog_app.time_frames(defog_frame, warmup=32, frames=256)
    print(f"defog timing: {defog_ms:.4f} ms per frame, {1e3 / defog_ms:.1f} FPS over 256 frames after "
          f"32 warm-up (reference protocol: per-frame dispatch and scalar readback, host clock); "
          f"{defog_dev_ms:.4f} ms per frame, {1e3 / defog_dev_ms:.1f} FPS back to back between CUDA "
          f"events (not the reference protocol)  [{card}]")
    paths = (
        ("rgb (RGB_PALLAS)", handheld.handheld_superres, rgb_burst, RGB_PALLAS),
        ("rgb (PORT_DEFAULT)", handheld.handheld_superres, rgb_still, PORT_DEFAULT),
        ("raw (RAW_BENCH)", handheld.handheld_superres_raw, raw_rot, RAW_BENCH),
        ("raw (RAW_PORT_DEFAULT)", handheld.handheld_superres_raw, raw_burst, RAW_PORT_DEFAULT),
        ("raw windows", handheld.handheld_superres_raw, raw_burst, raw_windows_cfg),
        ("rgb (RGB_DEFAULT)", handheld.handheld_superres, rgb_burst, RGB_DEFAULT),
        ("rgb scale 4", handheld.handheld_superres, rgb_burst, rgb_scale4),
        ("rgb order 1", handheld.handheld_superres, rgb_burst, rgb_order1),
        ("raw (RAW_SCALE4)", handheld.handheld_superres_raw, raw9, RAW_SCALE4),
        ("raw cascade (RAW_SCALE4)", cascade, raw5, RAW_SCALE4),
        *((label, fn, burst, cfg) for label, fn, burst, cfg, *_ in bar_paths),
        *((label, fn, burst, cfg) for label, fn, burst, cfg, *_ in knob_paths),
    )
    slice_ms = [time_slice(label, fn, burst, cfg) for label, fn, burst, cfg in paths]

    # the runall matrix: 4 flows x the three datasets' geometries, each a
    # synthetic burst; FPS under the app's protocol (10 cycles of
    # btvl1_video over the burst, the last 5 timed, each fenced by a
    # scalar readback), the device time and device ops of one cycle
    # (profiler), and the card's busy share of a cycle
    t_btv = time.perf_counter()
    for ds in DATASETS:
        burst = rgb_burst if ds == "city" else torch.from_numpy(synthetic_dataset_burst(ds)).to(dev)
        for flow, cfg in btv_cfgs.items():
            seconds, n_timed, _ = sr_app.time_cycles(lambda scale: btvl1.btvl1_video(burst * scale, cfg), 10)
            cycle_ms = seconds * 1e3 / n_timed
            # the cycles above are the warm-up
            dev_ms, ops = device_busy(lambda: btvl1.btvl1_video(burst, cfg))
            if ds == "city":
                # one cycle under the profiler: its stages (phase 6's split),
                # its totals beside the light read's
                full_ms, full_ops = profile_stages(f"btvl1 {flow} {ds}", btvl1.btvl1_video, burst, cfg, cycle_ms,
                                                   card, wrappers)
                print(f"btvl1 matrix {flow} {ds}: device {full_ms:.3f} ms over {full_ops} device ops (profile "
                      f"with CPU ops) against {dev_ms:.3f} ms over {ops} (raw device events alone)")
            print(f"btvl1 matrix {flow} {ds} {tuple(burst.shape)}: {burst.shape[0] * n_timed / seconds:.2f} FPS "
                  f"(app protocol, {n_timed} of 10 cycles timed), {cycle_ms:.3f} ms per cycle; device "
                  f"{dev_ms:.3f} ms over {ops:.0f} device ops per cycle; card busy "
                  f"{100.0 * dev_ms / cycle_ms:.1f}%  [{card}]")
        del burst
    print(f"btvl1 matrix: {time.perf_counter() - t_btv:.1f} s")
    dnn_sr_timing(dev, card)

    # 6. where the time goes
    profile_stages("defog", run_defog, pair, defog_cfg, defog_ms, card, wrappers)
    for (label, fn, burst, cfg), ms in zip(paths, slice_ms):
        profile_stages(label, fn, burst, cfg, ms, card, wrappers)

    def numbers(label):
        return {"max_abs_err": max_abs_err[label], "ms": kernel_ms[label], "plain_ms": plain_ms[label],
                "device_ms": device_ms[label], "bound_ms": bounds[label][0], "bound_by": bounds[label][1]}

    # 3b. the public surface at the JAX call forms, on the card against
    # the CPU (tile_warp_int: the kernel against its plain version); run
    # after the paths' runs and profiles, so that it leaves them as they
    # were, and its launches are no path's
    public_surface(dev, card)
    LAUNCHES.clear()

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": launches.get(name, 0),
        **numbers(main_variant[name]),
        "max_abs_err": max_abs_err[name],  # over every check of the kernel
        "library_ms": None,  # no one PyTorch call computes any of these functions
        "variant": main_variant[name],
        "variants": [{"label": label, **numbers(label)} for kernel, label, *_ in timed if kernel == name],
        "copy_floor_ms": copy_floor_ms.get(name),  # the copy kernel only
        # the search only: the plain version's device time and device ops
        "plain_device_ms": plain_device.get(name, (None, None))[0],
        "plain_device_ops": plain_device.get(name, (None, None))[1],
    } for name, launches in (
        ("merge_fast", default_launches), ("tile_warp", bench_launches),
        ("tile_search", bench_launches), ("merge_raw", bench_launches),
        ("defog", defog_launches),
    )] + [{
        # a form of the correctness bar's paths: its launches in its path's run
        "name": form,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": replaces,
        "launches": {**bar_launches, **knob_launches, **limit_launches}[path].get(name, 0),
        **numbers(labels[0]),
        "max_abs_err": max(max_abs_err[label] for label in labels),
        "library_ms": None,
        "variant": labels[0],
        "variants": [{"label": label, **numbers(label)} for label in labels],
        "path": path,
    } for form, name, replaces, path, labels in (
        # the general forms: their launches in a limit path's run
        ("merge_raw general", "merge_raw_general", KERNELS["merge_raw"][1], "raw (RAW_BENCH scale 5)",
         [f"merge_raw {label}" for label, *_ in raw_general]),
        ("merge_fast general", "merge_fast_general", KERNELS["merge_fast"][1], "rgb (RGB_DEFAULT scale 5)",
         [f"merge {label}" for label, *_ in merge_general]),
        ("tile_search general", "tile_search_general", KERNELS["tile_search"][1], "raw (RAW_PORT_DEFAULT tile_size=12)",
         [label for label, *_ in search_general]),
        ("merge_raw stream", "merge_raw_stream", KERNELS["merge_raw"][1], "raw (RAW_BENCH on 40 frames)",
         [f"merge_raw {label}" for label, *_ in raw_stream]),
        ("merge_raw nonbayer", "merge_raw_nonbayer", KERNELS["merge_raw"][1], "raw (RAW_BENCH cfa ((0, 1), (2, 1)))",
         [f"merge_raw {label}" for label, *_ in raw_nonbayer]),
        ("merge_fast unstaged", "merge_fast_unstaged", KERNELS["merge_fast"][1],
         "rgb (RGB_DEFAULT scale 1, radius 34, e^-1e4: tap radius 35) on 4 x 64 x 128",
         [f"merge {label}" for label, *_ in merge_unstaged]),
        ("merge_fast 9 slots", "merge_fast", "multi_frame_super_resolution_tpu/models/fast_merge.py:80",
         "rgb (RGB_EXACT)", ["merge 9 slots, e^-1.5 (RGB_EXACT)", "merge 9 slots, e^-1.5, s=4"]),
        ("merge_raw order 0", "merge_raw", KERNELS["merge_raw"][1], "raw (RAW_ORDER0)",
         ["merge_raw order 0, S=2 (RAW_ORDER0)", "merge_raw order 0, S=4, F=9"]),
        ("merge_raw 9 slots", "merge_raw", KERNELS["merge_raw"][1], "raw (RAW_EXACT)",
         ["merge_raw 9 slots, S=2 (RAW_EXACT)", "merge_raw 9 slots, S=4, F=9"]),
        ("merge_raw cert4", "merge_raw", KERNELS["merge_raw"][1], "raw (RAW_CERT)",
         ["merge_raw cert4, S=2 (RAW_CERT)", "merge_raw cert4, S=4, F=9", "merge_raw guided cert4, S=2"]),
        ("merge_raw exact_weights", "merge_raw", KERNELS["merge_raw"][1], "raw (RAW_EXACT_WEIGHTS)",
         ["merge_raw exact_weights, S=2 (RAW_EXACT_WEIGHTS)", "merge_raw exact_weights, S=4, F=9",
          "merge_raw exact_weights 9 slots, S=2", "merge_raw exact_weights 9 slots, S=4, F=9",
          "merge_raw guided exact_weights, S=2"]),
        *((f"merge_raw {label}", "merge_raw", KERNELS["merge_raw"][1], f"raw ({cfg_name})",
           [f"merge_raw {label}, S=2 ({cfg_name})", f"merge_raw {label}, S=4, F=9"]
           + (["merge_raw guided order 0 bf16, S=2"] if label == "order 0 bf16" else []))
          for label, cfg_name in (("cert block", "RAW_CERT_BLOCK"), ("cert shared", "RAW_CERT_SHARED"),
                                  ("cert prune", "RAW_CERT_PRUNE"), ("cert bf16", "RAW_CERT_BF16"),
                                  ("order 0 bf16", "RAW_ORDER0_BF16"))),
        ("merge_fast bf16", "merge_fast", "multi_frame_super_resolution_tpu/models/fast_merge.py:80",
         "rgb (RGB_BF16)", ["merge phase layout bf16, e^-1.5 (RGB_BF16)", "merge phase layout bf16, e^-1.5, s=4"]),
        ("tile_warp onehot", "tile_warp", "multi_frame_super_resolution_tpu/ops/warp_fast.py:549",
         "raw (RAW_ONEHOT_WARP)",
         ["tile_warp onehot (RAW_ONEHOT_WARP)"]),
    )]}))
    print(f"launches per path: defog {defog_launches}, rgb pallas {rgb_launches}, "
          f"rgb port default {rgb_default_launches}, raw bench {bench_launches}, "
          f"raw default {raw_launches}, raw windows {win_launches}, rgb default {default_launches}, "
          f"rgb scale 4 {scale4_launches}, rgb order 1 {order1_launches}, raw scale 4 {raw4_launches}, "
          f"raw cascade {cascade_launches}, "
          + ", ".join(f"{label} {launches}" for label, launches in
                      {**bar_launches, **knob_launches, **limit_launches}.items())
          + "; btvl1_video (no kernel of csrc/ on its path) "
          + ", ".join(f"{flow} {launches}" for flow, launches in btv_launches.items())
          + "; dnn_sr (no kernel of csrc/ on its path) "
          + ", ".join(f"{algo} {launches}" for algo, launches in dnn_launches.items())
          + "; " + ", ".join(f"{label} {launches}" for label, launches in mesh_launches.items()))
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


# the bundled DNN SR checkpoints, read as data (npz files; nothing of the
# JAX package is imported)
CHECKPOINTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "multi_frame_super_resolution_tpu", "data", "checkpoints")
DNN_TRAIN_STEPS = 50
DNN_LOSS_RTOL = 1e-4  # tests/test_torch_dnn_sr.py's: float32 sums in other orders
DNN_BEAT_DB = 0.5  # tests/test_dnn_sr.py::test_bundled_checkpoint_beats_bilinear's margin


def bundled_model(algo: str):
    """The bundled x2 checkpoint of ``algo`` in its module, on the CPU."""
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr

    state_dict, meta = dnn_sr.load_params(os.path.join(CHECKPOINTS, f"{algo}_x2.npz"))
    if meta.get("algo") != algo:
        raise RuntimeError(f"{algo}_x2.npz was trained as {meta.get('algo')!r}")
    model = dnn_sr.create_sr_model(algo, 2)
    model.load_state_dict(state_dict)
    return model


def tf32_sr(model, img: torch.Tensor) -> torch.Tensor:
    """dnn_sr's function with cuDNN's TF32 on: a labelled measurement only,
    the port computes in float32."""
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic, allow_tf32=True):
        return model(img.permute(2, 0, 1)[None])[0].permute(1, 2, 0).clamp(0.0, 1.0)


def dnn_sr_paths(dev, card) -> dict:
    """Single-image DNN SR on the card through its entry points: each
    bundled checkpoint through dnn_sr on the tracked city scene
    (city_handheld_sr.png as HR, its bilinear half as LR), the train step
    at the app's protocol, and the app's two forms. Returns each
    checkpoint's launches of csrc/ kernels (none expected)."""
    from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as dnn_app
    from multi_frame_super_resolution_tpu_torch.data import imread, imwrite
    from multi_frame_super_resolution_tpu_torch.data.synthetic import CITY_HR_SCENE
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr
    from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
    from multi_frame_super_resolution_tpu_torch.ops.geometry import resize

    t0 = time.perf_counter()
    with dnn_sr.float32_convs():
        if torch.backends.cudnn.allow_tf32:
            raise RuntimeError("float32_convs left cuDNN's TF32 on")
    scene = torch.from_numpy(imread(CITY_HR_SCENE)).to(dev)
    hh, ww = scene.shape[:2]
    # the checkpoints were trained on gray scenes (R = G = B, the JAX app's
    # data): the scene's BT.601 luma in three channels is their domain,
    # where each must beat bilinear; on the colour scene they lose to it,
    # in the JAX package too, so the RGB rows carry no limit
    luma = rgb_to_gray(scene)[..., None].expand(hh, ww, 3).contiguous()
    launches = {}
    for form, hr in (("luma", luma), ("rgb", scene)):
        lr = resize(hr, hh // 2, ww // 2, "bilinear")
        p_base = psnr(resize(lr, hh, ww, "bilinear").clamp(0.0, 1.0), hr)
        for algo in dnn_sr.SR_ALGORITHMS:
            model = bundled_model(algo)
            LAUNCHES.clear()
            out = dnn_sr.dnn_sr(model, lr)
            torch.cuda.synchronize()
            if form == "luma":
                launches[algo] = dict(LAUNCHES)
            if out.device != dev:
                raise RuntimeError(f"dnn_sr {algo}: the output lies on {out.device}, not on the default {dev}")
            check_output(f"dnn_sr {algo} ({form})", out, tuple(hr.shape))
            p_model = psnr(out, hr)
            crop = lr[:64, :96]
            on_card = dnn_sr.dnn_sr(model, crop).cpu()
            on_cpu = dnn_sr.dnn_sr(model, crop.cpu(), device="cpu")
            p_cpu, worst = psnr(on_card, on_cpu), (on_card - on_cpu).abs().max().item()
            limit = (f"limit bilinear + {DNN_BEAT_DB} dB" if form == "luma"
                     else "no limit: trained on gray scenes, they lose to bilinear on colour, in JAX too")
            print(f"path dnn_sr {algo} ({form} city scene): {tuple(lr.shape)} -> {tuple(out.shape)}, launches "
                  f"{dict(LAUNCHES)} (none of csrc/), PSNR vs HR {p_model:.4f} dB, bilinear {p_base:.4f} dB "
                  f"({limit}); 64 x 96 crop card vs CPU {p_cpu:.2f} dB, max abs {worst:.3e} "
                  f"(limit {PSNR_MIN} dB)  [{card}]")
            if p_cpu < PSNR_MIN:
                raise RuntimeError(f"dnn_sr {algo} on the card disagrees with the port on the CPU")
            if form == "luma" and p_model <= p_base + DNN_BEAT_DB:
                raise RuntimeError(f"dnn_sr {algo} does not beat bilinear on its domain: {p_model} vs {p_base}")

    # the train step at the app's protocol (batch 8, LR 32 x 32, its 12
    # batches cycled), from init_state's torch.Generator seed 0
    data = [tuple(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev) for x in pair)
            for pair in dnn_app.train_data(2)]
    for algo in dnn_sr.SR_ALGORITHMS:
        model, cpu_model = dnn_sr.create_sr_model(algo, 2), dnn_sr.create_sr_model(algo, 2)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), data[0][0][:1])
        cpu_state, cpu_opt = dnn_sr.init_state(cpu_model, torch.Generator().manual_seed(0), data[0][0][:1].cpu())
        step, cpu_step = dnn_sr.make_train_step(model, opt), dnn_sr.make_train_step(cpu_model, cpu_opt)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        LAUNCHES.clear()
        losses = []
        for i in range(DNN_TRAIN_STEPS):
            if i == 10:  # the first ten are warm-up
                start.record()
            state, loss = step(state, *data[i % len(data)])
            losses.append(loss)
        end.record()
        end.synchronize()
        ms_step = start.elapsed_time(end) / (DNN_TRAIN_STEPS - 10)
        losses = [float(x) for x in losses]
        cpu_losses = [float(cpu_step(cpu_state, lr_b.cpu(), hr_b.cpu())[1]) for lr_b, hr_b in data[:3]]
        rel = max(abs(a / b - 1.0) for a, b in zip(losses[:3], cpu_losses))
        print(f"train dnn_sr {algo}: {DNN_TRAIN_STEPS} steps of batch 8 (LR 32 x 32), loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} (mean of the last 5 {statistics.mean(losses[-5:]):.6f}), launches {dict(LAUNCHES)}; "
              f"first 3 losses card vs CPU rel {rel:.2e} (limit {DNN_LOSS_RTOL}); {ms_step:.4f} ms per step "
              f"(CUDA events over steps 10-{DNN_TRAIN_STEPS - 1})  [{card}]")
        if rel > DNN_LOSS_RTOL:
            raise RuntimeError(f"train step {algo}: losses {losses[:3]} on the card, {cpu_losses} on the CPU")
        if not statistics.mean(losses[-5:]) < losses[0]:
            raise RuntimeError(f"train step {algo}: the loss did not fall: {losses}")

    # the app: train a few steps, then inference with that checkpoint and
    # a bundled one on a PNG (the luma LR image)
    with tempfile.TemporaryDirectory() as tmp:
        ck, inp = os.path.join(tmp, "fsrcnn_x2.npz"), os.path.join(tmp, "in.png")
        imwrite(inp, resize(luma, hh // 2, ww // 2, "bilinear").cpu().numpy())
        print("app dnn_sr train (5 steps):")
        if dnn_app.main(["train", ck, "fsrcnn", "2", "5"]) != 0:
            raise RuntimeError("the dnn_sr app's train form failed")
        for path, algo in ((ck, "fsrcnn"), (os.path.join(CHECKPOINTS, "lapsrn_x2.npz"), "lapsrn")):
            outp = os.path.join(tmp, f"{algo}.png")
            if dnn_app.main([path, algo, "2", inp, outp]) != 0 or imread(outp).shape != (hh, ww, 3):
                raise RuntimeError(f"the dnn_sr app's inference form failed with {path}")
    print(f"dnn_sr paths, train steps and app: {time.perf_counter() - t0:.1f} s")
    return launches


def dnn_sr_timing(dev, card) -> None:
    """ms per image of each bundled checkpoint through dnn_sr at 1920 x
    1080 -> 3840 x 2160 (a seeded synthetic scene; CUDA events around
    each call after 3 warm-up calls, each input distinct), output MP/s,
    device ms and ops of one call and the card's busy share; the same
    under TF32, labelled, with its PSNR against the float32 output and its
    fidelity on the city luma beside float32's."""
    from multi_frame_super_resolution_tpu_torch.data import imread, synthetic_rgb_burst
    from multi_frame_super_resolution_tpu_torch.data.synthetic import CITY_HR_SCENE
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr
    from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
    from multi_frame_super_resolution_tpu_torch.ops.geometry import resize

    t0 = time.perf_counter()
    x = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(0), 1, 1080, 1920, 0.0)[0][0]).to(dev)
    images = [x * (1.0 - 1e-5 * i) for i in range(13)]
    scene = torch.from_numpy(imread(CITY_HR_SCENE)).to(dev)
    luma = rgb_to_gray(scene)[..., None].expand(*scene.shape[:2], 3).contiguous()
    luma_lr = resize(luma, luma.shape[0] // 2, luma.shape[1] // 2, "bilinear")

    def per_image(sr) -> float:
        times = []
        for i, img in enumerate(images):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            sr(img)
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    for algo in dnn_sr.SR_ALGORITHMS:
        model = bundled_model(algo).to(dev)
        for label, sr in (("float32", lambda img: dnn_sr.dnn_sr(model, img)),
                          ("TF32, a measurement only", lambda img: tf32_sr(model, img))):
            torch.cuda.reset_peak_memory_stats()
            ms = per_image(sr)
            dev_ms, ops, rows = device_busy(lambda: sr(x), by_name=True)
            top = "; ".join(f"{name[:60]} x{n} {row_ms:.3f} ms" for name, n, row_ms in rows[:4])
            print(f"dnn_sr timing {algo} ({label}): 1080 x 1920 -> 2160 x 3840, median {ms:.4f} ms per image over "
                  f"10 images, {2160 * 3840 / (ms * 1e-3) / 1e6:.1f} output MP/s; device {dev_ms:.4f} ms over "
                  f"{ops} device ops per image, card busy {100.0 * dev_ms / ms:.1f}%; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; the largest device rows: {top}  [{card}]")
        gap = psnr(tf32_sr(model, x), dnn_sr.dnn_sr(model, x))
        p32 = psnr(dnn_sr.dnn_sr(model, luma_lr), luma)
        ptf = psnr(tf32_sr(model, luma_lr), luma)
        print(f"dnn_sr TF32 against float32 {algo}: PSNR of the TF32 output against the float32 output "
              f"{gap:.2f} dB at 2160 x 3840; city luma vs HR {ptf:.4f} dB (TF32) against {p32:.4f} dB "
              f"(float32), {ptf - p32:+.4f} dB  [{card}]")
    print(f"dnn_sr timing: {time.perf_counter() - t0:.1f} s")


MESH_POSITIONS = 4  # every mesh of the multi-device phase: positions on cuda:0 (one card)
SHARD_H, SHARD_W = 1024, 1536  # the row-sharded bursts: 4 shards of 256 rows
INTERIOR_DB = 40.0  # tests/test_parallel.py's interior limit, sharded against unsharded
BLUR_TOL = 1e-5  # tests/test_parallel.py::test_spatial_map_blur_parity's
TRAIN_RTOL = 1e-6  # the data-parallel and split train steps against the one-device step
# Adam (eps 1e-8) moves a parameter by lr m / (sqrt(v) + eps): a gradient
# at float32 rounding level (zero in one summation order, not in another)
# moves it by rounding's share of a step, and moments that nearly
# cancel over the steps scale a gradient's rounding up. So the parameters
# are held to tests/test_torch_cuda.py::test_dnn_train_step_on_card_matches_cpu's
# rule: within PARAM_ATOL where the one-device gradient is at least
# ADAM_DECIDED, within 2 lr elsewhere; the losses to TRAIN_RTOL. The
# gradients the step sums are weight gradients over 8 x 32 x 32 pixels and
# more: two float32 summation orders of ~1e4 terms part by up to ~eps
# sqrt(n) ~ 6e-6 of the largest, so GRAD_RTOL.
ADAM_DECIDED, PARAM_ATOL, GRAD_RTOL = 1e-4, 1e-5, 1e-5
OUT_TOL = 1e-5  # tests/test_torch_dnn_sr.py's: max abs of DNN SR outputs in [0, 1]


def event_ms(call) -> float:
    """ms of one call between CUDA events on the current card, every card
    idle at the start (the call's host time included where it outlasts its
    device work)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    start.record()
    call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def in_call_pairs(first, second, reps: int = 3) -> tuple:
    """Median ms of two calls timed in turns (first, second; then second,
    first; ...) within this run."""
    a, b = [], []
    for rep in range(reps):
        order = ((first, a), (second, b)) if rep % 2 == 0 else ((second, b), (first, a))
        for call, times in order:
            times.append(event_ms(call))
    return statistics.median(a), statistics.median(b)


def train_on_mesh(algo: str, mesh, label: str, data: list, card: str) -> dict:
    """``algo``'s x2 train step on ``mesh`` against the one-device step from
    the same parameters over ``data``'s 3 batches (losses TRAIN_RTOL,
    gradients GRAD_RTOL, parameters by ADAM_DECIDED's rule), then both
    timed in in-call pairs of 10 steps, with device ops and ms of one step
    each. Raises on a disagreement; returns the mesh step's launches of
    csrc/ kernels (none expected)."""
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr

    models, steps = [], []
    for m in (None, mesh):
        model = dnn_sr.create_sr_model(algo, 2)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), data[0][0][:1])
        models.append(model)
        steps.append((state, dnn_sr.make_train_step(model, opt, mesh=m)))
    worst = dict(loss=0.0, grad=0.0, param=0.0, param_rel=0.0, undecided=0.0)
    LAUNCHES.clear()
    for lr_b, hr_b in data:
        (s1, one), (s2, on_mesh) = steps
        want, got = float(one(s1, lr_b, hr_b)[1]), float(on_mesh(s2, lr_b, hr_b)[1])
        worst["loss"] = max(worst["loss"], abs(got / want - 1.0))
        with torch.no_grad():
            for p, q in zip(models[1].parameters(), models[0].parameters()):
                worst["grad"] = max(worst["grad"], ((p.grad - q.grad).abs().max() / q.grad.abs().max()).item())
                diff, decided = (p - q).abs(), q.grad.abs() >= ADAM_DECIDED
                if decided.any():
                    worst["param"] = max(worst["param"], diff[decided].max().item())
                    worst["param_rel"] = max(worst["param_rel"], (diff[decided].max() / q.abs().max()).item())
                if not decided.all():
                    worst["undecided"] = max(worst["undecided"], diff[~decided].max().item())
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ten = [lambda st=st, step=step: [step(st, *data[i % 3]) for i in range(10)] for st, step in steps]
    ms_one, ms_mesh = (ms / 10 for ms in in_call_pairs(*ten))
    (dev_one, ops_one), (dev_mesh, ops_mesh) = (device_busy(lambda st=st, step=step: step(st, *data[0]))
                                                 for st, step in steps)
    lr = 1e-3  # init_state's Adam learning rate
    print(f"train dnn_sr {algo} {label} (batch 8, LR 32 x 32), 3 steps against the "
          f"one-device step: losses within {worst['loss']:.2e} relative (limit {TRAIN_RTOL}), gradients within "
          f"{worst['grad']:.2e} of the largest (limit {GRAD_RTOL}); parameters within {worst['param']:.2e} "
          f"({worst['param_rel']:.2e} of the tensor's largest) where the one-device gradient is at least "
          f"{ADAM_DECIDED} (limit {PARAM_ATOL}), {worst['undecided']:.2e} elsewhere (limit 2 lr = {2 * lr}); "
          f"launches {launches}; {ms_mesh:.4f} ms per step against {ms_one:.4f} one-device (in-call pairs of 10 "
          f"steps, CUDA events, medians of 3); device ops {ops_mesh} against {ops_one}, device ms {dev_mesh:.4f} "
          f"against {dev_one:.4f} per step  [{card}]")
    if (worst["loss"] > TRAIN_RTOL or worst["grad"] > GRAD_RTOL or worst["param"] > PARAM_ATOL
            or worst["undecided"] > 2 * lr):
        raise RuntimeError(f"the {label} train step of {algo} differs from the one-device step: {worst}")
    return launches


def split_inference(devices: list, card) -> dict:
    """Each bundled x2 checkpoint through dnn_sr(mesh=) on ('data', 'model')
    (1, m) positions on ``devices`` at 1080 x 1920 -> 2160 x 3840 (a
    seeded synthetic scene) against the unsplit call on the first device
    within OUT_TOL max abs; ms per image in in-call pairs against the
    unsplit call, device ops and ms, the first device's peak memory of
    each. Returns each split call's launches of csrc/ kernels (none
    expected)."""
    from multi_frame_super_resolution_tpu_torch.data import synthetic_rgb_burst
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr
    from multi_frame_super_resolution_tpu_torch.parallel import make_mesh

    dev, m = devices[0], len(devices)
    mesh = make_mesh(("data", "model"), (1, m), devices)
    where = f"(1, {m}) positions on {', '.join(str(d) for d in devices)}"
    x = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(0), 1, 1080, 1920, 0.0)[0][0]).to(dev)
    launches = {}
    for algo in dnn_sr.SR_ALGORITHMS:
        model = bundled_model(algo).to(dev)
        LAUNCHES.clear()
        got = dnn_sr.dnn_sr(model, x, mesh=mesh)
        for d in set(devices):
            torch.cuda.synchronize(d)
        key = f"split dnn_sr {algo} (1, {m})"
        launches[key] = dict(LAUNCHES)
        want = dnn_sr.dnn_sr(model, x)
        check_output(f"split dnn_sr {algo}", got, (2160, 3840, 3))
        err = (got - want).abs().max().item()
        del got, want
        calls = (lambda: dnn_sr.dnn_sr(model, x, mesh=mesh), lambda: dnn_sr.dnn_sr(model, x))
        peak = []
        for call in calls:
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            peak.append(torch.cuda.max_memory_allocated() / 2**20)
        ms_split, ms_one = in_call_pairs(*calls)
        (dev_split, ops_split), (dev_one, ops_one) = (device_busy(call) for call in calls)
        print(f"split dnn_sr {algo} on ('data', 'model') {where}: 1080 x 1920 -> 2160 x 3840, "
              f"max abs {err:.3e} against the unsplit call (limit {OUT_TOL}); launches "
              f"{launches[key]}; {ms_split:.4f} ms per image against {ms_one:.4f} unsplit "
              f"(in-call pairs, CUDA events, medians of 3); device ops {ops_split} against {ops_one}, device ms "
              f"{dev_split:.4f} against {dev_one:.4f}; peak memory {peak[0]:.1f} MiB against {peak[1]:.1f} MiB  "
              f"[{card}]")
        if err > OUT_TOL:
            raise RuntimeError(f"split dnn_sr {algo} differs from the unsplit call by {err}")
    return launches


def write_tiff(path: str, arr: np.ndarray, compression: int = 1, predictor: int = 1) -> None:
    """A little-endian TIFF of ``arr`` (H, W) or (H, W, 3), uint8 or
    uint16, in one chunky strip (the host has no Pillow): uncompressed, or
    deflated (``compression`` 8), with horizontal differencing per sample
    under ``predictor`` 2."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w, c).astype(np.int64)
    if predictor == 2:
        rows = np.concatenate([rows[:, :1], np.diff(rows, axis=1)], 1) % (1 << (8 * arr.dtype.itemsize))
    pixels = rows.astype(f"<u{arr.dtype.itemsize}").tobytes()
    if compression == 8:
        pixels = zlib.compress(pixels)
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8 * arr.dtype.itemsize), (259, 3, compression),
               (262, 3, 1 if c == 1 else 2), (273, 4, 8), (277, 3, c), (278, 4, h), (279, 4, len(pixels)),
               (284, 3, 1)] + ([(317, 3, predictor)] if predictor != 1 else [])
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, kind, 1) + (struct.pack("<HH", v, 0) if kind == 3 else struct.pack("<I", v))
        for tag, kind, v in entries) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8 + len(pixels)) + pixels + ifd)


def multi_device_paths(dev, card, raw_city: torch.Tensor) -> dict:
    """The multi-device layer (parallel/) and the readers on one card,
    every mesh MESH_POSITIONS positions on ``dev`` (2 for the data-parallel
    train step and split inference):
    what the layer costs where it has no device to gain. Each path is
    driven with the launch counts at 0 just before and read just after.
    Returns each path's launches."""
    from functools import partial

    from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as dnn_app
    from multi_frame_super_resolution_tpu_torch.apps import polar_defog as defog_app
    from multi_frame_super_resolution_tpu_torch.config import RAW_BENCH, RGB_DEFAULT_NOPRE, PolarDefogConfig
    from multi_frame_super_resolution_tpu_torch.data import imread_u16, mosaic_rggb, native, synthetic_rgb_burst
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.models import defog as mdefog
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr, handheld
    from multi_frame_super_resolution_tpu_torch.ops.filters import gaussian_blur
    from multi_frame_super_resolution_tpu_torch.parallel import (
        handheld_superres_raw_sharded,
        handheld_superres_sharded,
        make_mesh,
        pipeline_halo,
        spatial_map,
    )
    from multi_frame_super_resolution_tpu_torch.parallel.runner import make_batched_pipeline

    t0 = time.perf_counter()
    mesh = make_mesh(("data",), (MESH_POSITIONS,), [dev] * MESH_POSITIONS)
    rows = make_mesh(("spatial",), (MESH_POSITIONS,), [dev] * MESH_POSITIONS)
    launches = {}

    def counted(call):
        LAUNCHES.clear()
        out = call()
        torch.cuda.synchronize()
        return out, dict(LAUNCHES)

    # batched bursts at RAW_BENCH: B distinct city-geometry bursts, both modes
    single = partial(handheld.handheld_superres_raw, cfg=RAW_BENCH)
    _, one_launches = counted(lambda: single(raw_city))
    one_ms, one_ops = device_busy(lambda: single(raw_city))
    for b in (4, 8):
        bursts = torch.stack([raw_city * (1.0 - 1e-5 * i) for i in range(b)])
        singles = [single(x) for x in bursts]
        for mode, m in (("scan", None), ("vmap", mesh)):
            batched = make_batched_pipeline(single, m, mode=mode)
            out, got = counted(lambda: batched(bursts))
            launches[f"batched {mode} B={b}"] = got
            if got != {k: b * n for k, n in one_launches.items()}:
                raise RuntimeError(f"batched {mode} B={b} launched {got}, {b} x {one_launches} expected")
            differ = [i for i in range(b) if not torch.equal(out[i], singles[i])]
            if out.device != dev or differ:
                raise RuntimeError(f"batched {mode} B={b}: bursts {differ} differ from their single calls")
            ms_single, ms_batch = in_call_pairs(lambda: [single(x) for x in bursts], lambda: batched(bursts))
            dev_ms, ops = device_busy(lambda: batched(bursts))
            where = "no mesh" if m is None else f"{MESH_POSITIONS} positions on {dev}"
            print(f"batched {mode} B={b} (RAW_BENCH, {where}"
                  f"): every burst equal to its single call bit for bit; launches {got}; {ms_batch / b:.3f} ms per "
                  f"burst batched against {ms_single / b:.3f} ms in {b} single calls (in-call pairs, CUDA events, "
                  f"medians of 3); {ops / b:.1f} device ops and {dev_ms / b:.3f} device ms per burst against {one_ops} "
                  f"and {one_ms:.3f} single  [{card}]")
        del bursts, singles, out

    # row-sharded RAW and RGB on a 5 x 1024 x 1536 burst rotated within
    # +-0.01 rad (RAW_SCALE4's protocol), 4 shards of 256 rows
    angles = (0.0,) + tuple(np.random.default_rng(3).uniform(-0.01, 0.01, 4).tolist())
    rgb_np, _ = synthetic_rgb_burst(np.random.default_rng(5), 5, SHARD_H, SHARD_W, 3.0, angles=angles)
    rgb = torch.from_numpy(rgb_np).to(dev)
    raw = torch.from_numpy(np.stack([mosaic_rggb(f) for f in rgb_np])).to(dev)
    del rgb_np
    for label, sharded, entry, burst, cfg, halo in (
        ("raw (RAW_BENCH)", handheld_superres_raw_sharded, handheld.handheld_superres_raw, raw, RAW_BENCH,
         2 * pipeline_halo(RAW_BENCH, prealign_px=8)),
        ("rgb (RGB_DEFAULT_NOPRE)", handheld_superres_sharded, handheld.handheld_superres, rgb, RGB_DEFAULT_NOPRE,
         pipeline_halo(RGB_DEFAULT_NOPRE)),
    ):
        out_sh, got = counted(lambda: sharded(burst, cfg, rows, halo=halo))
        out_1, got_1 = counted(lambda: entry(burst, cfg))
        launches[f"sharded {label}"] = got
        if got != {k: MESH_POSITIONS * n for k, n in got_1.items()}:
            raise RuntimeError(f"sharded {label} launched {got}, {MESH_POSITIONS} x {got_1} expected")
        if out_sh.device != dev:
            raise RuntimeError(f"sharded {label}: the output lies on {out_sh.device}")
        check_output(f"sharded {label}", out_sh, (2 * SHARD_H, 2 * SHARD_W, 3))
        m = 2 * halo
        p = psnr(out_sh[m:-m], out_1[m:-m])
        scaled = [burst * (1.0 - 1e-5 * i) for i in range(1, 7)]
        ms_sh, ms_1 = in_call_pairs(lambda: sharded(scaled.pop(), cfg, rows, halo=halo),
                                    lambda: entry(scaled.pop(), cfg))
        (dev_sh, ops_sh), (dev_1, ops_1) = (device_busy(lambda: sharded(burst, cfg, rows, halo=halo)),
                                            device_busy(lambda: entry(burst, cfg)))
        print(f"sharded {label}: {tuple(burst.shape)} over {MESH_POSITIONS} shards of {SHARD_H // MESH_POSITIONS} "
              f"rows, "
              f"halo {halo} rows -> {tuple(out_sh.shape)}; launches {got} (unsharded {got_1}); interior ({m} output "
              f"rows trimmed at each end) vs unsharded {p:.2f} dB (limit {INTERIOR_DB} dB), whole image "
              f"{psnr(out_sh, out_1):.2f} dB; {ms_sh:.3f} ms per burst sharded, {ms_1:.3f} unsharded (in-call pairs, "
              f"CUDA events, medians of 3); device ops {ops_sh} sharded, {ops_1} unsharded; device ms {dev_sh:.3f} "
              f"sharded, {dev_1:.3f} unsharded  [{card}]")
        if p <= INTERIOR_DB:
            raise RuntimeError(f"sharded {label}: interior {p} dB against the unsharded run")
        del out_sh, out_1, scaled
    del rgb, raw

    # the halo-exchange blur
    img = torch.from_numpy(np.random.default_rng(6).random((SHARD_H, SHARD_W)).astype(np.float32)).to(dev)
    blur = spatial_map(lambda x: gaussian_blur(x, 1.0, size=5), halo=2, mesh=rows)
    err = (blur(img) - gaussian_blur(img, 1.0, size=5)).abs().max().item()
    print(f"spatial_map gaussian_blur(sigma 1, size 5), halo 2, {MESH_POSITIONS} shards of {tuple(img.shape)}: "
          f"max abs {err:.3e} against the unsharded blur (limit {BLUR_TOL})")
    if err > BLUR_TOL:
        raise RuntimeError(f"spatial_map blur differs from the unsharded blur by {err}")

    # the data-parallel ESPCN train step and the split train step of each
    # family (the app's batch 8, LR 32 x 32), then split inference at 1080p
    data = [tuple(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev) for x in pair)
            for pair in dnn_app.train_data(2, batches=3)]
    train_on_mesh("espcn", make_mesh(("data",), (2,), [dev] * 2), f"data-parallel on 2 positions of {dev}", data,
                  card)
    split = make_mesh(("data", "model"), (2, 2), [dev] * 4)
    for algo in dnn_sr.SR_ALGORITHMS:
        launches[f"split train {algo} (2, 2)"] = train_on_mesh(
            algo, split, f"split on ('data', 'model') (2, 2) positions of {dev}", data, card)
    launches.update(split_inference([dev] * 2, card))

    # the readers: which one served, baseline TIFFs read back, the defog
    # app's inputType 1 on a 16-bit pair
    if native.available():
        print(f"readers: the native library built ({native.LIBRARY}) and serves imread, imread_u16 and load_burst")
    else:
        lines = native.build_error().splitlines()
        why = next((line.strip() for line in lines if "error:" in line), lines[0])
        print(f"readers: numpy (the native library is not built: {why})")
    rng = np.random.default_rng(7)
    gray16 = (rng.random((96, 136)) * 65535).astype(np.uint16)
    rgb8 = (rng.random((96, 136, 3)) * 255).astype(np.uint8)
    scale16, scale8 = np.float32(1.0 / 65535.0), np.float32(1.0 / 255.0)
    v = gray16.astype(np.float32) * scale16
    want_gray = np.float32(0.299) * v + np.float32(0.587) * v + np.float32(0.114) * v  # the native luma
    with tempfile.TemporaryDirectory() as tmp:
        write_tiff(os.path.join(tmp, "gray16.tiff"), gray16)
        write_tiff(os.path.join(tmp, "rgb8.tiff"), rgb8)
        routes = [("native", contextlib.nullcontext())] if native.available() else []
        routes.append(("numpy", mock.patch.object(native, "_library", lambda: (None, "switched off"))))
        for route, ctx in routes:
            with ctx:
                g, c = imread_u16(os.path.join(tmp, "gray16.tiff")), imread_u16(os.path.join(tmp, "rgb8.tiff"))
            if not (np.array_equal(g, want_gray) and np.array_equal(c, rgb8.astype(np.float32) * scale8)):
                raise RuntimeError(f"the {route} reader did not read the TIFFs back exactly")
            print(f"readers ({route}): 16-bit gray {gray16.shape} and 8-bit RGB {rgb8.shape} baseline TIFFs read "
                  f"back exactly (gray as the luma of the sample, max {np.abs(g - v).max():.2e} from it)")
        s = 0.25 + 0.5 * rng.random((DEFOG_H // 2, DEFOG_W // 2))
        write_tiff(os.path.join(tmp, "ImageWorst_tiff16.tiff"), ((s * 0.9 + 0.05) * 65535).astype(np.uint16))
        write_tiff(os.path.join(tmp, "ImageBest_tiff16.tiff"), (s * 0.6 * 65535).astype(np.uint16))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            LAUNCHES.clear()
            if defog_app.main(["1", "1", "1.55"]) != 0:
                raise RuntimeError("the defog app failed on inputType 1")
            torch.cuda.synchronize()
            launches["polar_defog inputType 1"] = dict(LAUNCHES)
            r = np.load("polar_defog_debug.npz")["R"]
            iper, ipar = defog_app._load_inputs(1, "cpu")
        finally:
            os.chdir(cwd)
    plain = mdefog.polar_defog(iper, ipar, PolarDefogConfig(beta=1.55)).numpy()
    p = psnr(torch.from_numpy(r), torch.from_numpy(plain))
    print(f"app polar_defog 1 1 1.55 on a {s.shape} 16-bit TIFF pair: R {r.shape}, launches "
          f"{launches['polar_defog inputType 1']}, against the plain version on the CPU {p:.2f} dB "
          f"(limit {PSNR_MIN} dB)")
    if launches["polar_defog inputType 1"].get("defog") != 1 or p < PSNR_MIN:
        raise RuntimeError("the defog app's TIFF input did not run through the defog kernel as expected")
    launches.update(reader_files(dev, card))
    print(f"multi-device paths and readers: {time.perf_counter() - t0:.1f} s")
    return launches


READER_FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_reader_files")


def sample_digest(samples: np.ndarray) -> str:
    """sha256 of samples (H, W, C) as little-endian bytes in C order (the
    digests of tests/torch_reader_files/MANIFEST.json)."""
    import hashlib

    arr = np.asarray(samples)
    return hashlib.sha256(np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<"))).tobytes()).hexdigest()


def host_ms(call, reps: int = 3) -> tuple:
    """(median host ms of ``reps`` calls, the last result)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = call()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), out


def reader_files(dev, card) -> dict:
    """The numpy readers and writers on the card host, which has no Pillow
    and no native library: every committed file of tests/torch_reader_files
    decodes to its manifest digest (Pillow's decode, taken where Pillow
    is); the car burst's JPEGs through load_burst into the BTV-L1 app
    (pyrlk) and the handheld app on ``dev``; the defog app on a 16-bit
    Deflate + Predictor 2 TIFF pair, R bit for bit with the uncompressed
    pair; the DNN SR app from a JPEG to a .jpg; and the host ms per frame
    of each decoder, of the encoder and decoder at 1080p and of the
    defog-size Deflate TIFF. Returns the apps' launches."""
    from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as dnn_app
    from multi_frame_super_resolution_tpu_torch.apps import handheld_sr as hh_app
    from multi_frame_super_resolution_tpu_torch.apps import multi_frame_sr as sr_app
    from multi_frame_super_resolution_tpu_torch.apps import polar_defog as defog_app
    from multi_frame_super_resolution_tpu_torch.data import burst_paths, imread, imread_u16, imwrite, jpeg, load_burst
    from multi_frame_super_resolution_tpu_torch.data import native, png, tiff
    from multi_frame_super_resolution_tpu_torch.data.synthetic import CITY_HR_SCENE
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    numpy_route = mock.patch.object(native, "_library", lambda: (None, "switched off"))
    with open(os.path.join(READER_FILES, "MANIFEST.json")) as f:
        manifest = json.load(f)["files"]
    decoders = {".jpg": jpeg.decode, ".png": lambda b, n: png.decode(b, n)[0], ".tif": lambda b, n: tiff.decode(b, n)[0]}
    for name, entry in manifest.items():
        with open(os.path.join(READER_FILES, name), "rb") as f:
            blob = f.read()
        ms, samples = host_ms(lambda: decoders[os.path.splitext(name)[1]](blob, name))
        if (list(samples.shape) != entry["shape"] or samples.dtype.newbyteorder("=") != np.dtype(entry["dtype"])
                or sample_digest(samples) != entry["sha256"]):
            raise RuntimeError(f"reader {name}: {samples.shape} {samples.dtype} does not match the manifest {entry}")
        print(f"reader {name} ({entry['written_by']}): {tuple(samples.shape)} {entry['dtype']}, sha256 equal to "
              f"Pillow's decode (the manifest); {ms:.3f} ms host per frame (median of 3)  [{card}]")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp, numpy_route:
        # (c) the car burst: the committed JPEGs at the dataset's paths
        for i, path in enumerate(burst_paths("car", tmp)):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(os.path.join(READER_FILES, f"car/{i + 1}.jpg"), "rb") as src, open(path, "wb") as dst:
                dst.write(src.read())
        frames = load_burst("car", tmp)
        for i, frame in enumerate(frames):
            samples = jpeg.decode(open(burst_paths("car", tmp)[i], "rb").read())
            if (sample_digest(samples) != manifest[f"car/{i + 1}.jpg"]["sha256"]
                    or not np.array_equal(frame, samples.astype(np.float32) * np.float32(1.0 / 255.0))):
                raise RuntimeError(f"load_burst('car') frame {i} differs from the manifest")
        cwd = os.getcwd()
        os.chdir(tmp)
        env = {"MFSR_DATA_DIR": tmp, "MFSR_SR_CYCLES": "4", "MFSR_BENCH_WARMUP": "1", "MFSR_BENCH_ITERS": "2",
               "MFSR_BENCH_AMORTIZED": "0"}
        try:
            with mock.patch.dict(os.environ, env):
                for label, run, out in (
                        ("multi_frame_sr pyrlk car 10", lambda: sr_app.main(["pyrlk", "car", "10"]),
                         "car_pyrlk_sr_result.png"),
                        ("handheld_sr car 2", lambda: hh_app.main(["car", "2"]), "car_handheld_sr.png")):
                    LAUNCHES.clear()
                    if run() != 0:
                        raise RuntimeError(f"the app {label} failed on the car burst")
                    torch.cuda.synchronize()
                    launches[f"app {label}"] = dict(LAUNCHES)
                    result = imread(out)
                    if result.shape != (260, 456, 3) or not np.isfinite(result).all():
                        raise RuntimeError(f"the app {label} wrote {out} of {result.shape}")
                    print(f"app {label} on the car burst (4 JPEGs of 130 x 228 read on the numpy route, "
                          f"equal to the manifest) on {dev}: {out} {result.shape}, launches {dict(LAUNCHES)}  "
                          f"[{card}]")
        finally:
            os.chdir(cwd)
        if not {"merge_fast", "tile_search"} <= set(launches["app handheld_sr car 2"]):
            raise RuntimeError(f"the handheld app on the car burst did not launch its kernels: {launches}")

        # (d) the defog app's inputType 1 on a Deflate + Predictor 2 pair and
        # on the same pair uncompressed: R bit for bit
        rng = np.random.default_rng(8)
        s = 0.25 + 0.5 * rng.random((DEFOG_H, DEFOG_W))
        pair = {"ImageWorst_tiff16.tiff": ((s * 0.9 + 0.05) * 65535).astype(np.uint16),
                "ImageBest_tiff16.tiff": (s * 0.6 * 65535).astype(np.uint16)}
        rs = {}
        for form, kw in (("deflate", dict(compression=8, predictor=2)), ("raw", {})):
            os.makedirs(os.path.join(tmp, form))
            for name, arr in pair.items():
                write_tiff(os.path.join(tmp, form, name), arr, **kw)
            os.chdir(os.path.join(tmp, form))
            try:
                LAUNCHES.clear()
                if defog_app.main(["1", "1", "1.55"]) != 0:
                    raise RuntimeError(f"the defog app failed on the {form} TIFF pair")
                torch.cuda.synchronize()
                launches[f"polar_defog inputType 1 ({form} TIFF)"] = dict(LAUNCHES)
                rs[form] = np.load("polar_defog_debug.npz")["R"]
            finally:
                os.chdir(cwd)
        path = os.path.join(tmp, "deflate", "ImageWorst_tiff16.tiff")
        ms_tiff, u16 = host_ms(lambda: imread_u16(path))
        if not np.array_equal(rs["deflate"], rs["raw"]) or launches["polar_defog inputType 1 (deflate TIFF)"].get(
                "defog") != 1:
            raise RuntimeError("the defog app's R from the Deflate + Predictor 2 pair differs from the raw pair's")
        print(f"app polar_defog 1 1 1.55 on a {DEFOG_H} x {DEFOG_W} 16-bit Deflate + Predictor 2 TIFF pair: R "
              f"{rs['deflate'].shape} equal bit for bit to the uncompressed pair's, launches "
              f"{launches['polar_defog inputType 1 (deflate TIFF)']}; imread_u16 of one such file "
              f"{u16.shape}: {ms_tiff:.3f} ms host per frame (median of 3)  [{card}]")

        # (e) the DNN SR app from a JPEG to a .jpg, read back through the port
        scene = imread(CITY_HR_SCENE)
        inp, outp = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.jpg")
        imwrite(inp, scene[::4, ::4])
        LAUNCHES.clear()
        if dnn_app.main([os.path.join(CHECKPOINTS, "lapsrn_x2.npz"), "lapsrn", "2", inp, outp]) != 0:
            raise RuntimeError("the dnn_sr app failed on a JPEG input")
        launches["app dnn_sr lapsrn 2 (jpg -> jpg)"] = dict(LAUNCHES)
        with open(outp, "rb") as f:
            blob = f.read()
        back = imread(outp)
        want = (scene.shape[0] // 4 * 2, scene.shape[1] // 4 * 2, 3)
        if blob[:3] != b"\xff\xd8\xff" or blob[-2:] != b"\xff\xd9" or b"\xff\xc0" not in blob or back.shape != want:
            raise RuntimeError(f"the dnn_sr app's .jpg output is not a baseline JPEG of {want}: {back.shape}")
        print(f"app dnn_sr lapsrn 2 {scene[::4, ::4].shape} JPEG -> {outp.rsplit('/', 1)[1]}: SOI, SOF0 and EOI "
              f"markers, read back {back.shape}, launches {dict(LAUNCHES)} (none of csrc/)  [{card}]")

        # the encoder and decoder at 1080p (the city scene tiled)
        img = (np.tile(scene, (3, 2, 1))[:1080, :1920] * 255.0 + 0.5).astype(np.uint8)
        ms_enc, blob = host_ms(lambda: jpeg.encode(img), reps=2)
        ms_dec, dec = host_ms(lambda: jpeg.decode(blob), reps=2)
        p = psnr(torch.from_numpy(dec / np.float32(255.0)), torch.from_numpy(img / np.float32(255.0)))
        if dec.shape != img.shape or p < 30.0:
            raise RuntimeError(f"the 1080p JPEG round trip: {dec.shape}, {p:.2f} dB")
        print(f"jpeg 1080 x 1920 (quality 75, 4:2:0, {len(blob)} bytes): encode {ms_enc:.1f} ms, decode "
              f"{ms_dec:.1f} ms host per frame (median of 2), {p:.2f} dB against the samples  [{card}]")
    print(f"readers and writers: {time.perf_counter() - t0:.1f} s")
    return launches


def estimate_agreement(label, gray, cfg, estimate) -> None:
    """The similarity estimates of a burst's luma gray (F, H, W) on the
    card against the port on the CPU: exact agreements per field, and the
    largest difference in refine cells of the matrix-DFT peak (rotation
    pi / (size - 1) / peak_upsample rad, translation ds / peak_upsample
    px; both shapes here take ds = cfg.downsample). More than one cell
    raises."""
    on_card = estimate(gray, cfg)
    on_cpu = estimate(gray.cpu(), cfg)
    ds = cfg.downsample
    size = max(gray.shape[-2], gray.shape[-1]) // ds
    cells = {"rotation": np.pi / (size - 1) / cfg.peak_upsample, "translation": ds / cfg.peak_upsample}
    parts = []
    for field, cell in cells.items():
        a = getattr(on_card, field).cpu().double()
        b = getattr(on_cpu, field).double()
        exact = int((a == b).reshape(a.shape[0], -1).all(dim=1).sum())
        worst = float((a - b).abs().max()) / cell
        parts.append(f"{field} equal in {exact}/{a.shape[0]} frames, max diff {worst:.3f} cells")
        if worst > 1.0 + 1e-3:
            raise RuntimeError(f"prealign estimate {label}: {field} differs by {worst:.3f} refine cells")
    degrees = ", ".join(f"{d:.3f}" for d in np.degrees(on_card.rotation.cpu().numpy()))
    print(f"prealign estimate {label} {tuple(gray.shape)}, card vs CPU: {'; '.join(parts)}; "
          f"rotations {degrees} deg")


def device_time(call, symbol: str | None = None, iters: int = 20) -> tuple:
    """(ms, ops): mean device time and device ops per call of the kernel
    ``symbol`` (with None: of all the device work) over ``iters`` calls
    under torch.profiler: the kernel alone, without the host's launch
    cost that a loop timed with events includes when the wrapper is
    slower than the kernel. A profile that recorded no device work at all
    (seen once in a run of many profiles) is taken again, with a note,
    up to twice. Each call given a ``symbol`` launches each kernel whose
    name holds it once (the general RGB merge: its form and the kernel
    that adds its parts), so its time is their total over the launches
    the profile recorded of the most recorded one: a profile that
    recorded fewer launches than calls (seen as a time 40-60% under the
    kernel's other readings) is noted, not divided by the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        device_rows = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        rows = device_rows if symbol is None else [e for e in device_rows if symbol in e.key]
        if rows or device_rows:
            break
        print(f"device_time: profile {attempt + 1} of {symbol or 'the call'} recorded no device work; again")
    if not rows:
        raise RuntimeError(f"the profiler saw no {symbol or 'device work'} among "
                           f"{[e.key[:80] for e in device_rows]}")
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if symbol is None:
        return total_ms / iters, sum(e.count for e in rows) / iters
    by_name = {}
    for e in rows:  # the profile's rows of one kernel name (its instantiations) together
        by_name[e.key] = by_name.get(e.key, 0) + e.count
    launches = max(by_name.values())
    if launches != iters:
        print(f"device_time: the profile recorded {launches} launches of {symbol} in {iters} calls; "
              f"the time per launch is kept")
    return total_ms / launches, launches / iters


def device_busy(call, by_name: bool = False) -> tuple:
    """(ms, ops) of one call, made after a warm-up: the summed device time
    and the count of the kernels, copies and memsets it ran, read from the
    profiler's raw events with the CUDA activity alone. The light form of
    profile_stages' totals for a call of thousands of ops: no CPU op
    records and no event tree, which cost seconds per call. ``by_name``
    adds the rows by kernel name, (name, count, ms), largest first. The
    profiler can miss a call's device work (PERF.md §6): a call it sees
    none of is profiled again, up to 3 times, before this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rows = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        if rows:
            break
    else:
        raise RuntimeError("the profiler saw no device work in 3 tries")
    total = (sum(e.duration_ns() for e in rows) / 1e6, len(rows))
    if not by_name:
        return total
    named = {}
    for e in rows:
        count, ns = named.get(e.name(), (0, 0))
        named[e.name()] = (count + 1, ns + e.duration_ns())
    return (*total, sorted(((k, n, ns / 1e6) for k, (n, ns) in named.items()), key=lambda r: -r[2]))


def profile_stages(label, fn, inp, cfg, ms, card, wrappers) -> tuple:
    """Host and device ms of each stage over one profiled burst (frame),
    each kernel's CUDA-event time in it (the events bracket the wrapper's
    launch), the profiler's own rows for the kernels, and the share of an
    unprofiled burst (``ms``) the card is busy; returns the run's device
    ms and device ops. ``wrappers`` maps each kernel to the (module,
    attribute, plain version) its path calls it through."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events = []

    def timed(name, wrapper):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapper(*args, **kwargs)
            end.record()
            events.append((name, start, end))
            return out
        return call

    with contextlib.ExitStack() as stack:
        for name, (module, attr, _) in wrappers.items():
            stack.enter_context(mock.patch.object(module, attr, timed(name, getattr(module, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(inp, cfg)
            torch.cuda.synchronize()
    event_ms = {}
    for name, start, end in events:
        event_ms[name] = event_ms.get(name, 0.0) + start.elapsed_time(end)

    stages, kernels_us, launches, kernel_rows = {}, 0.0, 0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("mfsr."):
            # the host-side range carries the device time of its kernels
            if evt.cpu_time_total > stages.get(evt.key, (0.0, 0.0))[0]:
                stages[evt.key] = (evt.cpu_time_total, evt.device_time_total)
        elif evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            kernels_us += evt.self_device_time_total  # kernels and copies
            launches += evt.count
            for name, symbol in KERNEL_SYMBOLS.items():
                if symbol in evt.key:  # one row per template instantiation
                    count, us = kernel_rows.get(name, (0, 0.0))
                    kernel_rows[name] = (count + evt.count, us + evt.self_device_time_total)
    # the ctypes launches run under no ATen op, so the ranges' device time
    # leaves the kernels out; their own profiler rows are added to their
    # stage here, and the events around each launch are shown beside
    for name, (host_us, dev_us) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        extra = ""
        for k in event_ms:
            if STAGE_OF[k] == name:
                count, k_us = kernel_rows.get(k, (0, 0.0))
                dev_us += k_us
                extra += (f"; kernel {k}: {count} launches, {k_us / 1e3:.4f} ms device time "
                          f"(profiler row), {event_ms[k]:.4f} ms between CUDA events around them")
        print(f"stage {label} {name}: host {host_us / 1e3:.3f} ms, device {dev_us / 1e3:.3f} ms{extra}")
    print(f"profile {label}: {launches} device ops, {kernels_us / 1e3:.3f} ms device time per run; "
          f"card busy {100.0 * kernels_us / 1e3 / ms:.1f}% of {ms:.3f} ms  [{card}]")
    return kernels_us / 1e3, launches



# the public surface's limit, card against CPU: |card - cpu| <= 1e-5 (1 +
# |cpu|), the same float32 ops in another order: 1e-5 max abs on image
# data in [0, 1], relative on the RAW merge's unnormalized sums (tens)
SURFACE_TOL = 1e-5


def public_surface(dev, card) -> None:
    """Phase 3b: each function that takes a JAX function's name and was
    repaired or added for the JAX call forms, called in each of those
    forms on cuda:0 and on the CPU with the same inputs (64 x 96 or
    smaller, from a seed), the results held to SURFACE_TOL max abs; and
    the three packages' re-exported names imported. tile_warp_int runs
    the tile-warp kernel on the card and its plain version on the CPU."""
    import importlib
    import inspect

    from multi_frame_super_resolution_tpu_torch.config import PREALIGN_FAST, RegistrationConfig
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.models import fast_merge, robustness
    from multi_frame_super_resolution_tpu_torch.ops import filters, geometry, morphology, restore, warp_fast
    from multi_frame_super_resolution_tpu_torch.registration import align, logpolar, phase_correlation, subpixel
    from multi_frame_super_resolution_tpu_torch.registration import tiles

    t0 = time.perf_counter()
    derivatives = importlib.import_module("multi_frame_super_resolution_tpu_torch.ops.derivatives")
    counts = {}
    for pkg in ("ops", "models", "registration"):
        module = importlib.import_module(f"multi_frame_super_resolution_tpu_torch.{pkg}")
        names = list(module.__all__) if hasattr(module, "__all__") else [
            n for n, v in vars(module).items() if not n.startswith("_") and not inspect.ismodule(v)]
        for n in names:
            getattr(module, n)
        counts[pkg] = len(names)
    rng = np.random.default_rng(21)

    def img(form, h=64, w=96):
        return rng.random((h, w) if form == "hw" else (h, w, 3)).astype(np.float32)

    def field(shape, lo, hi):
        return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)

    def on(x, device):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        return x

    def out_tensors(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if dataclasses.is_dataclass(out):
            return [getattr(out, f.name) for f in dataclasses.fields(out)]
        return [t for o in out for t in out_tensors(o)]

    worst, worst_rel, n_checks = 0.0, 0.0, 0
    k5 = rng.standard_normal((5, 5)).astype(np.float32) * 0.1
    k5[2, 2] += 1.0
    k35 = rng.standard_normal((3, 5)).astype(np.float32)
    ky, kx = rng.random(5).astype(np.float32), rng.random(3).astype(np.float32)

    def check(label, fn, *args, **kw):
        nonlocal worst, worst_rel, n_checks
        got = out_tensors(fn(*(on(a, dev) for a in args), **{k: on(v, dev) for k, v in kw.items()}))
        want = out_tensors(fn(*(on(a, "cpu") for a in args), **{k: on(v, "cpu") for k, v in kw.items()}))
        for g, w_ in zip(got, want):
            if g.device != dev or tuple(g.shape) != tuple(w_.shape):
                raise RuntimeError(f"public surface {label}: {g.device} {tuple(g.shape)} against {tuple(w_.shape)}")
            diff = (g.detach().cpu().double() - w_.double()).abs()
            scale = 1.0 + w_.double().abs()
            err = diff.max().item() if g.numel() else 0.0
            rel = (diff / scale).max().item() if g.numel() else 0.0
            if not rel <= SURFACE_TOL:
                raise RuntimeError(f"public surface {label}: max abs {err:.3e}, {rel:.3e} of 1 + |cpu| against the "
                                   f"CPU (limit {SURFACE_TOL})")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            if err > SURFACE_TOL:
                print(f"public surface {label}: max abs {err:.3e} on values up to {w_.abs().max().item():.3g}, "
                      f"{rel:.3e} of 1 + |cpu|")
        n_checks += 1

    for form in ("hw", "hwc"):
        x, y = img(form), img(form)
        h, w = x.shape[:2]
        flow = field((h, w, 2), -3.0, 3.0)
        check(f"gaussian_blur {form}", filters.gaussian_blur, x, 1.3)
        for border in ("replicate", "zero"):
            check(f"separable_filter {form} {border}", filters.separable_filter, x, ky, kx, border)
            check(f"conv2d {form} {border}", filters.conv2d, x, k35, border)
        for size in (3, 9):
            check(f"box_filter {form} {size}", filters.box_filter, x, size)
        for name in ("derivative5_x", "derivative5_y", "derivatives"):
            check(f"{name} {form}", getattr(derivatives, name), x)
        check(f"derivatives_pair {form}", derivatives.derivatives_pair, x, y)
        check(f"dilate {form}", morphology.dilate, x, 3)
        check(f"erode {form}", morphology.erode, x, 3)
        check(f"downsample2 {form}", geometry.downsample2, x)
        for method in ("bilinear", "bicubic", "nearest"):
            check(f"resize {form} {method}", geometry.resize, x, 37, 53, method)
            check(f"warp_backward {form} {method}", geometry.warp_backward, x, flow, method)
        check(f"upscale {form}", geometry.upscale, img(form, 16, 24), 3)
        ys, xs = field((40, 50), -4.0, h + 4.0), field((40, 50), -4.0, w + 4.0)
        check(f"remap_bilinear {form}", geometry.remap_bilinear, x, ys, xs)
        check(f"remap_bicubic {form}", geometry.remap_bicubic, x, ys, xs)
        small = img(form, 16, 24)
        check(f"upsample_int {form}", warp_fast.upsample_int, small, 3, "bicubic")
        check(f"upsample_nearest {form}", warp_fast.upsample_nearest, small, 3)
        check(f"upsample_int_phases {form}", warp_fast.upsample_int_phases, small, 2, "bilinear")
        check(f"interleave_phases {form}", warp_fast.interleave_phases,
              warp_fast.upsample_int_phases(torch.from_numpy(small), 3, "bicubic").numpy())
        check(f"warp_bounded {form}", warp_fast.warp_bounded, x, flow, 2)
        for t, amp in ((16, 5), (12, 40)):
            ints = rng.integers(-amp, amp + 1, (-(-h // t), -(-w // t), 2)).astype(np.int32)
            LAUNCHES.clear()
            check(f"tile_warp_int {form} T={t} shifts +-{amp} (kernel against plain)", warp_fast.tile_warp_int,
                  x, ints, t)
            if LAUNCHES["tile_warp"] != 1:
                raise RuntimeError(f"tile_warp_int launched {dict(LAUNCHES)} on the card, expected one tile_warp")
        ints = rng.integers(-5, 6, (4, 6, 2)).astype(np.int32)
        check(f"warp_decomposed {form}", warp_fast.warp_decomposed, x, ints, field((h, w, 2), -1.5, 1.5), 16)
        check(f"restore_image {form} (img, k)", restore.restore_image, x, k5)
        check(f"restore_image {form} (img, k, gain)", restore.restore_image, x, k5, torch.tensor(0.6))
    grids = geometry.identity_grid(64, 96)
    check("similarity_warp_fast (C, H, W), batch_dims=1", warp_fast.similarity_warp_fast,
          img("hw")[None].repeat(3, 0), grids[0].numpy() * 0.998 + 0.05 * grids[1].numpy() + 0.7,
          grids[1].numpy() * 0.998 - 0.05 * grids[0].numpy() - 1.2, None, 1)
    check("restore_phases (kernel=)", restore.restore_phases, field((2, 2, 3, 10, 14), 0.0, 1.0), kernel=k5)
    gray = img("hw")[None].repeat(3, 0) + field((3, 64, 96), 0.0, 0.02)
    check("temporal_noise_stat (gray, flows)", restore.temporal_noise_stat, gray, field((3, 64, 96, 2), -1.5, 1.5))
    a = img("hw")
    rolled = np.roll(a, (-4, 7), axis=(0, 1))
    check("phase_correlate (a, b), integer peak", phase_correlation.phase_correlate, a, rolled, subpixel=False)
    for cfg in (RegistrationConfig(), PREALIGN_FAST):
        label = "default" if cfg == RegistrationConfig() else "PREALIGN_FAST"
        check(f"register_translation (a, b) {label}", logpolar.register_translation, a, rolled, cfg)
        check(f"register_rotation_scale (a, b) {label}", logpolar.register_rotation_scale, a, rolled, cfg)
        check(f"register_similarity (a, b) {label}", logpolar.register_similarity, a, rolled, cfg)
    shifts = field((4, 6, 2), -4.0, 4.0)
    for smooth in (True, False):
        check(f"flow_from_tile_shifts smooth={smooth}", align.flow_from_tile_shifts, shifts, 16, 60, 90, smooth)
    pre = (rng.integers(-12, 13, (4, 6, 2)) * 0.5).astype(np.float32)
    check("extract_search_windows (img, T, R, float pre_shift)", tiles.extract_search_windows, a, 16, 4, pre)
    check("extract_search_windows_fast (img, T, R, int pre_shift)", tiles.extract_search_windows_fast, a, 16, 4,
          rng.integers(-6, 7, (4, 6, 2)).astype(np.int32))
    check("quadratic_subpixel_max", subpixel.quadratic_subpixel_max, field((7, 3, 3), 0.0, 1.0))
    f, hh, hw = 3, 16, 24
    planes_in = (field((f, 2, 2, hh, hw), 0.0, 1.0), field((f, hh, hw, 2), -0.8, 0.8), field((f, hh, hw, 3), 0.0, 1.0),
                 field((hh, hw, 3), 0.5, 1.0), field((hh, hw, 3), 0.4, 0.9))
    check("merge_burst_raw_planes (interleaved, order 0)", fast_merge.merge_burst_raw_planes, *planes_in,
          ((0, 1), (1, 2)), 2, radius=1, prune_exp=1.5, order=0)
    check("robustness_mask (bounded=0 default)", robustness.robustness_mask, img("hwc", 32, 48), img("hwc", 32, 48),
          field((32, 48, 2), -4.0, 4.0))
    torch.cuda.synchronize()
    print(f"public surface: {n_checks} calls in the JAX call forms on cuda:0 against the CPU, max abs {worst:.3e}, "
          f"max {worst_rel:.3e} of 1 + |cpu| (limit {SURFACE_TOL}); re-exports {counts}; "
          f"{time.perf_counter() - t0:.2f} s  [{card}]")


if __name__ == "__main__":
    sys.exit(main())
