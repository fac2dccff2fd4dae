// Static-tap kernel-regression merge for Hopper (sm_90a), RGB: the
// templated kernel (scales 1-4, taps within +-25), described first; its
// general form (S = 0: any scale, any taps, staged in pieces) after it.
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// merge.py::merge_fast_pallas (kernel body _make_kernel), and the default
// merge branch the JAX package computes in XLA with the same skeleton
// (models/fast_merge.py::merge_burst_fast with phase_output, order 1 and
// 4 or 9 moment slots). It computes the same function as the plain PyTorch
// version multi_frame_super_resolution_tpu_torch/models/fast_merge.py::
// merge_burst_fast: for every input pixel (y, x), every frame f, every
// static tap (ky, kx) and every output phase (py, px),
//
//   d   = (k - clip(res_f(y, x), -rb, rb)) * s - phi * s
//   w   = exp(-1/2 (dx^2 Oxx + dy^2 Oyy + 2 dx dy Oxy))      Omega^-1 at (y, x)
//   cw  = w * cert_f(y', x', c),  cwv = cw * val_f(y', x', c)
//
// with (y', x') = (y + ky, x + kx) clamped to the image (edge semantics),
// summed into one of four output forms (the taps are the host's list,
// so the prune threshold only changes the list):
//
//   form 0, order 0, interleaved: num[s*y+py, s*x+px, c] += cwv, den += cw
//   form 1, order 0, phase layout: num[py, px, c, y, x] += cwv, den += cw
//   form 2, order 1, phase layout: m00 += cw, m01 += cw dy, m02 += cw dx,
//     b0 += cwv, each (s, s, 3, H, W): the plugin solve's moments
//   form 3, order 1, phase layout: m00, m01, m02 as form 2, m11 += cw dy^2,
//     m12 += cw dy dx, m22 += cw dx^2, b0 += cwv, b1 += cwv dy,
//     b2 += cwv dx: the exact 3x3 solve's 9 moments (solve_order1)
//   form 4, order 0, phase layout, bfloat16 (merge.bf16): num and den as
//     form 1's, with val and cert rounded to bfloat16, w evaluated in f32
//     and rounded, cw = w cert and cwv = val cw bfloat16 products, each
//     frame's sums over the taps bfloat16, and the frames added in f32
//     (fast_merge.py:134-136, :165-195)
//
// Form 0 is the merge_fast_pallas path; the default RGB branch runs form 1
// (order 0), form 4 (order 0, merge.bf16), form 2 (order 1, plugin solve)
// or form 3 (order 1, merge.solver='exact'). The outputs of a form are consecutive arrays of
// s^2 * 3 * H * W floats each (one allocation).
//
// Bound, at chip_smoke.py's check (F=5, 256 x 512, s=2, 25 taps): 65.5 M
// (frame, pixel, tap, phase) items at 20.25 flops and one exp each, every
// shared term counted once (chip_smoke.py's WORK table): 1.33 GFLOP,
// 19.8 us at 67 TFLOP/s f32; the exps alone 15.7 us on the SFUs; the
// 35 MB of inputs and outputs 10.5 us at 3.35 TB/s. The operations bind.
//
// Design (the first version ran a thread per pixel that read six strided
// floats from device memory per frame and tap and evaluated the full
// quadratic, an IEEE expf and value x certainty per phase: ~30 issue
// slots an item, 0.095 ms):
// - One thread per input pixel holding all s^2 phases (s^2 * 3 num and
//   den accumulators in registers). -1/2 log2(e) (and the cross term's
//   2) are folded into omega once per pixel, so w = 2^(dx (dx o0 + B) +
//   A) with A = dy^2 o_yy and B = dy o_xy; per frame the thread forms
//   ry s + phi_y s and rx s + phi_x s per phase once.
// - The taps travel as runs: consecutive taps of one row, kx rising by
//   1 (_active_taps gives one run per tap row). Per run and phase row
//   the thread forms dy = ky s - (ry s + phi_y s), A and B once; per tap
//   of the run it reads its site (two shared loads, the address a loop
//   induction), forms dx per phase column (kx s an induction), and each
//   item is two FMAs for the exponent, one ex2.approx and six FMAs: ~11.5
//   issue slots an item at s = 2, 9 of them the item's own. The loops
//   are not unrolled: unrolled they ran slower under the 64-register
//   budget. (A thread per (pixel, phase row) reads each site and forms
//   dx twice; it measured slower too.)
// - A block is 32 x 8 pixels (256 threads, four blocks an SM at s <= 2).
//   For every frame it stages its tile plus the taps' halo in shared
//   memory with cp.async, edge-clamped like the plain version's padding,
//   as a float4 (v0 c0, v1 c1, v2 c2, c0) and a float2 (c1, c2) per site:
//   a tap is two shared loads. Each thread multiplies value by certainty
//   on the sites it copied itself, once per frame, after its own copies
//   land.
// - Frames are the outer loop and taps the inner one, the order of
//   _make_kernel and of the plain version. The staging is double-buffered
//   across frames: frame f + 1's copies are in flight while frame f
//   accumulates. Two frames' buffers are resident at once, so a burst has
//   no frame cap: 24 B x 2 per staged site, 20.7 KB at halo 2, 55 KB at
//   halo 8 (above 48 KB the launch opts in).
// - Stores go through shared memory: each thread parks its values of one
//   output array, and the block writes whole output rows of the
//   interleaved (sH, sW, 3) arrays, consecutive threads on consecutive
//   floats. Written straight from the accumulators, each warp store
//   touched a 24-byte stride (6x the L2 transactions), and every block of
//   the one wave stores at the same moment, behind no compute.
//   chip_smoke.py prints the kernel's time at one frame beside five: the
//   part that does not grow with the frames.
// - The run table travels by value in the kernel's parameters (the
//   constant bank, read uniformly by every thread). The residual is read
//   per pixel and frame from device memory, one 8-byte load.
// - Rounding differs from the plain version in four places: the
//   exponent's form and ex2.approx, dy and dx formed as k s - (r s +
//   phi s), value x certainty formed before the weight is applied, and
//   one accumulator over frames (the plain version sums each frame's
//   taps, then the frames). rtol/atol 1e-5 at every shape of
//   tests/test_torch_cuda.py.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 64
//   registers at s <= 2, no spills; see PERF.md for its time against the
//   first version's 0.096 ms and its bound.
//
// The phase-layout forms:
// - Form 1 is form 0's thread and loop with another store: a (py, px, c)
//   plane row of a block is 32 contiguous floats, so each warp writes
//   its accumulators straight to device memory, coalesced, with no
//   parking.
// - Form 2 holds 4 moments per (phase, channel): 48 accumulators at s = 2
//   and 192 at s = 4 for a thread holding all phases. So a thread holds
//   one phase row (a thread per pixel and phase row, 12 s accumulators),
//   and a block is 32 pixels x kTileH(s) rows x s phase rows (256
//   threads at s = 1, 2 and 4, 192 at s = 3). Each thread reads the
//   staged sites itself; per item it forms w dy and w dx once and adds
//   four FMAs per channel. Its m01 and m02 sum terms of mixed sign (dy
//   and dx reach +-(r + rb) s), so their rounding against the plain
//   version is checked at rtol/atol 1e-4.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): form 1
//   62, 64, 117 and 167 registers at s = 1-4, the s = 2 build (four
//   blocks an SM, 64 registers) spilling 8 bytes; form 2 72, 88, 96 and
//   113, no spills. Times against their bounds in PERF.md.
//
// Form 3 (9 moments): 27 accumulators per phase. A thread holds one phase
// row and, where the scale is even, two of its phase columns (54
// accumulators; a row's four at s = 4 would need ~200 registers), else
// one phase: a tap's two shared loads, its row terms and the loop's own
// work then serve two phases. A block is 32 pixels x kTileH rows x the
// threads of a pixel: 32 x 8 at s = 1 (256 threads), 32 x 2 x 2 at s = 2
// (128), 32 x 1 x 9 (288) at s = 3 and 32 x 1 x 8 (256) at s = 4, where
// one pixel row stages 3-5 rows of halo; two blocks an SM at s = 3-4,
// four at s = 2 (by registers). Per item it forms w dy, w dx and their
// three products once and adds nine FMAs per channel, frames outermost
// and taps in list order. Its bound at chip_smoke.py's check (F=5, 256 x
// 512, s=2, the 21 taps at e^-1.5): 56.6 MB of moments written and 22.5
// MB read (23.6 us at 3.35 TB/s) against 55 M items at 61.5 flops (3.4
// GFLOP, 50.6 us at 67 TFLOP/s): the operations bind. Its moments are
// checked at rtol/atol 1e-4, as form 2's. Measured (tools/ab_main_kernels.py
// and chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 88, 118, 86 and
// 112 registers at s = 1-4, no spills; its times against their bounds in
// PERF.md.
//
// Form 4 (bfloat16; at s = 1-4 merge_fast_bf16_kernel<S>, at S = 0 the
// general form's merge_fast_kernel<0, 4>) rounds as the JAX function
// does, jitted or not: val and cert rounded to bfloat16, w evaluated in
// f32 and rounded, cw = bf16(w c), cwv = bf16(v cw), each frame's sums
// over the taps in bfloat16 in the list's order, the frames added in f32.
// The lanes of a bfloat16x2 instruction round each as the scalar one
// does, so the templated kernel runs a thread's phases in lane pairs:
// two phase columns of a pixel at even s, two phase rows (then two
// columns, and one phase alone) at s = 3, two pixels four rows apart at
// s = 1. Per (tap, pair) the two weights round in one cvt.rn.bf16x2.f32;
// per channel bf16(w c) is one __hmul2_rn against (c, c), bf16(v w c) one
// against (v, v), and the num and den pairs take one __hadd2 each: 4
// bfloat16x2 instructions for two phases and a channel, where the first
// design (a phase at a time, (v, 1) x (w c, w c)) took 3 for one phase,
// and one cvt for two weights where it took one a phase and six a tap
// for the staged values. (The _rn forms keep the compiler from fusing a
// product into the add, which would round once where JAX rounds twice.)
// The frame is staged as the loop reads it: its f32 sites land by
// cp.async in one buffer and, after a barrier, the block rounds them once
// into a second, a uint4 (v0, v1, v2, c0) and a uint2 (c1, c2) of
// bfloat16 pairs per element, the lanes its two sites (at s = 1 four rows
// apart, else the same site twice): a tap is two shared loads and no
// conversion. The two buffers take 24 B a site each, the bytes of the
// first design's two frame buffers, so the wide-tap limit below holds;
// the next frame's copies land while the block accumulates. At s = 4 a
// pixel's phase rows split over two threads (512-thread blocks, 128
// registers): one thread a pixel took 217 registers, one block an SM.
// SASS (tools/kernel_stats.py, cuobjdump): per (frame, tap) the tap loop
// issues 30 instructions at s = 1 for two items (2 MUFU, 1 F2FP, 12
// bfloat16x2), 49 at s = 2 for four (4 MUFU, 2 F2FP, 24 bfloat16x2, 8
// FFMA; 46.5 with two taps an iteration, as built), 105 at s = 3 for
// nine and 89 at s = 4 for a thread's eight: 15, 11.6, 11.7 and 11.1 an
// item, where the first design took 30, 16.75, 14.2 and 13.3 (form 1 at
// s = 2: 12.5).
// ptxas: 86, 96, 128 and 128 registers at s = 1-4, no spills (the first
// design 64, 89, 150 and 240).
// Measured (tools/ab_main_kernels.py, F = 5, 256 x 512, e^-1.5; NVIDIA
// H100 80GB HBM3, 700.00 W): s = 1-4 0.0119, 0.0424, 0.0809 and 0.1428
// ms, against the first design's 0.0162, 0.0528, 0.1163 and 0.1832 in
// the same call; s = 2 31.0% of its 13.2 us bound (the operations), s = 4
// 36.9% of 52.7 us. At s = 2 the loop issues fewer instructions an item
// than form 1 yet takes 10% longer; three blocks an SM, two threads a
// pixel and loading the next tap ahead were each slower.
//
// Wide taps on the templated layouts: the staged halo is the taps' reach,
// up to kMaxRadius = 25, where two frame buffers of the widest tile (8 +
// 50 rows of 32 + 50 sites, 48 B a site) take 228,288 of the 232,448
// bytes a block may opt in to. At tap radius 11 (529 taps, s = 2) they
// take 77.8 KB, two blocks an SM.
//
// The general form (merge_fast_kernel<0, form>, S = 0, and
// merge_fast_pieces_kernel<form>): scales past 4, and taps reaching past
// 25 at any scale, any reach. It is the kernel above with the scale at
// run time and a thread per (input pixel, output phase) in every form (6,
// 12, 27 or 6 + 3 bfloat16x2 accumulators a thread, the form a template
// parameter), in a flat block of tw x th pixels x `rows` phase rows (Geometry, from
// kernels/merge.py::general_plan): 8 x 1 pixels x all 5 phase rows at
// s = 5, 200 threads, several blocks an SM. A warp holds 8 pixels at 4
// phases, so a tap's two shared loads read 8 sites, each broadcast to 4
// lanes (one wavefront each; a warp of 32 pixels of one phase took six,
// and measured slower). Staging (cp.async, double-buffered, edge-clamped),
// the exponent (-1/2 log2(e) folded into omega, two FMAs and ex2.approx),
// the accumulation and the rounding are the templated kernel's, so it
// matches the plain version within the same tolerances; form 0 parks each
// output array's rows of the block's phase rows in shared memory and
// stores whole rows.
// - Pieces. Where the whole tile and halo fit half the shared memory
//   (every reach up to 22, the check's s = 5 among them) and the grid needs
//   no split (below), the block stages them every frame and reads the runs
//   from its parameters, as the templated kernel does
//   (merge_fast_kernel<0, form>). Else the taps travel as pieces of the run
//   list, in its order (merge_fast_pieces_kernel<form>; the whole tile is
//   then one piece): a piece is a band of consecutive runs
//   whose tap rows and columns span at most the plan's band x cols (bands
//   of tap rows, and past any band a tap row in column chunks). Per
//   (frame, piece) step the block stages the piece's (th + rows - 1) x (tw
//   + cols - 1) sites and its runs (from the device table) into one of two
//   buffers, the next step's copies in flight while this one accumulates.
//   Each thread walks the runs of every piece in list order, so its taps
//   keep the list's order. (One body for both, the whole tile as a
//   single piece, cost the s = 5 forms up to 23% on an H100, and frame
//   chunks inside merge_fast_kernel<0, form> its 9 slots 19%: the whole
//   tile without a split keeps that kernel as it was.)
// - Filling the card. Where the grid of pixel tiles and phase-row groups
//   holds less than about one wave (132 SMs), grid z also spreads the
//   frames (in chunks) and, except for bfloat16 (its per-frame bfloat16
//   sums are one chain), the pieces (in groups) over blocks. Each block
//   then writes its sums to a scratch slot, and merge_fast_combine_kernel
//   adds the slots in a fixed order, frame chunks in frame order and the
//   tap groups within each in list order: the result is deterministic.
// Bound at chip_smoke.py's check (F=5, 256 x 512, s=5, 25 taps at
// e^-1.5): 410 M (frame, pixel, tap, phase) items at 16.3 flops and one
// exp (WORK): 105.6 us of operations; order 1 191.2 us, 9 slots 393.0
// us, bfloat16 98.0 us; at s = 1 and a reach of 35 (5,041 taps, 4 x 64 x
// 128) 165 M items at 28 flops, 69 us. Staged bytes: a block stages (1 +
// 2 halo) x (8 + 2 halo) sites of 24 B a frame for its 8 pixels' 192 B
// of values and certainties, 7.5x the input bytes at halo 2 (118 MB from
// L2 over the call, against 15.7 MB of values and certainties read once).
// Measured (tools/ab_main_kernels.py; NVIDIA H100 80GB HBM3, 700.00
// W): at s = 5 the phase layout takes 0.462 ms (22.7% of its bound, 3.0x
// under the first general kernel), 9 slots 1.007 (39.0%, 1.9x); tap
// radius 11 on the templated layout 0.706 (59.3%, 6.8x); all times, the
// banded reach-35 form's among them, in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>

namespace {

// the templated layouts' largest staged halo: two frame buffers of 8 + 2
// x 25 rows of 32 + 2 x 25 sites, 24 B x 2 a site, are 228,288 bytes
constexpr int kMaxRadius = 25;
constexpr int kTileW = 32;  // input columns of a block (one warp)
constexpr int kMaxSmem = 232448;  // shared memory a block can opt in to (sm_90)

constexpr int kMaxRuns = 2 * kMaxRadius + 1;  // _active_taps gives one run per tap row

// The taps as runs: consecutive taps of one row, kx rising by 1.
struct Taps {
  int n;                 // runs
  float kys[kMaxRuns];   // ky * s
  float kxs0[kMaxRuns];  // the run's first kx * s
  int off0[kMaxRuns];    // its first staged offset, ky * staged row length + kx
  int len[kMaxRuns];     // its taps
};

// The thread layout of a form. Order 0 (forms 0, 1): a thread per input
// pixel holding all s^2 phases, 32 x 8 pixels a block. Form 2: a thread
// per pixel and phase row, 32 x tile_h pixels x s phase rows a block.
// Form 3: a thread per pixel and phase, 32 x tile_h pixels x s^2 phases.
// S = 0 is the general form (any scale, runtime): a thread per pixel and
// phase, the block's shape chosen by the host (kernels/merge.py::
// general_tile) within kThreads.
template <int S, int kForm>
struct Layout {
  static constexpr bool kBf16 = kForm == 4;
  static constexpr bool kOrder1 = kForm == 2 || kForm == 3;
  static constexpr bool kPhase = kForm >= 1;  // the phase layout
  static constexpr int kSlots = kForm == 3 ? 9 : (kOrder1 ? 4 : 2);
  static constexpr int kRows = kOrder1 || S == 0 ? 1 : S;      // phase rows a thread holds
  // phase columns a thread holds: form 3 two where the scale is even
  static constexpr int kCols = S == 0 ? 1 : (kForm == 3 ? (S % 2 ? 1 : 2) : S);
  static constexpr int kColGroups = S == 0 ? 1 : S / kCols;    // threads a phase row
  static constexpr int kZ = S == 0 ? 1 : (S / kRows) * kColGroups;  // threads a pixel
  static constexpr int kTileH = kForm == 3 ? (S == 1 ? 8 : (S == 2 ? 2 : 1))
                                           : (kOrder1 ? (S == 1 ? 8 : (S == 2 ? 4 : 2)) : 8);
  // the general form: 1024 threads (64 registers), form 3's 27
  // accumulators 512 (128)
  static constexpr int kThreads = S == 0 ? (kForm == 3 ? 512 : 1024) : kTileW * kTileH * kZ;
  // blocks an SM the launch bound asks for: order 0's s^2 * 6 accumulators
  // grow with s (at s <= 2 four blocks, 64 registers a thread, hold the
  // 256 x 512 check in one wave); form 2's 12 s and form 3's 27 stay
  // under 128 registers (form 3 at s = 4: one block of 512 threads)
  static constexpr int kMinBlocks = S == 0 ? 1 : kOrder1 ? (kThreads > 288 ? 1 : 2)
                                            : (S <= 2 ? 4 : (S == 3 ? 2 : 1));
};

// The general form's plan (kernels/merge.py::general_plan): a block of
// tw x th pixels x `rows` phase rows of the scale s, one thread each, flat
// (threadIdx.x); grid z walks the row_groups groups of `rows` phase rows,
// the frame_chunks chunks of frames and the tap_groups groups of pieces.
// In pieces, table (device int32) holds n_pieces pieces, each {ky_lo,
// kx_lo, staged row length, staged sites} and {first run, runs, 0, 0},
// then the runs in list order, each {ky s, kx0 s (float bits), its first
// site's offset from the piece's, len}. A buffer holds max_sites staged
// sites and max_runs runs.
struct Geometry {
  int s, tw, th, rows;
  int row_groups, frame_chunks, tap_groups;
  int n_pieces, max_sites, max_runs;
  const int* table;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22; subnormal results
// flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Issues this thread's cp.async copies of one frame's staged sites
// (frame offset fbase into the (F, H, W, 3) arrays) and commits them as
// one group. Site s sits at row s / sw, column s % sw of the staged tile.
template <int kThreads>
__device__ __forceinline__ void stage_frame(const float* __restrict__ img,
                                            const float* __restrict__ cert,
                                            float4* a, float2* b, long long fbase,
                                            int y0, int x0, int h, int w, int halo,
                                            int sw, int sites, int tid, int n_threads = kThreads) {
  for (int s = tid; s < sites; s += (kThreads ? kThreads : n_threads)) {
    const int r = min(max(y0 - halo + s / sw, 0), h - 1);
    const int c = min(max(x0 - halo + s % sw, 0), w - 1);
    const long long g = fbase + ((long long)r * w + c) * 3;
    cp_async4(&a[s].x, img + g);
    cp_async4(&a[s].y, img + g + 1);
    cp_async4(&a[s].z, img + g + 2);
    cp_async4(&a[s].w, cert + g);
    cp_async4(&b[s].x, cert + g + 1);
    cp_async4(&b[s].y, cert + g + 2);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Form 0: writes one output array's block: each thread parks its s^2 x 3
// values in shared memory (the frame buffers, free by now), then the
// block writes its s * kTileH output rows of s * kTileW * 3 contiguous
// floats, consecutive threads on consecutive floats.
template <int S>
__device__ __forceinline__ void park_and_store(const float (&acc)[S][S][3], float* park,
                                               float* __restrict__ out, int y0, int x0,
                                               int h, int w, bool inside, int tid) {
  using L = Layout<S, 0>;
  constexpr int kRow = kTileW * S * 3;  // floats in a parked output row
  if (inside) {
#pragma unroll
    for (int py = 0; py < S; ++py)
#pragma unroll
      for (int px = 0; px < S; ++px)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          park[(threadIdx.y * S + py) * kRow + (threadIdx.x * S + px) * 3 + c] = acc[py][px][c];
        }
  }
  __syncthreads();
  const int rows = min(L::kTileH, h - y0) * S;
  const int row_len = min(kTileW, w - x0) * S * 3;
  const long long out_row = (long long)w * S * 3;
  float* dst = out + (long long)y0 * S * out_row + (long long)x0 * S * 3;
  for (int i = tid; i < rows * kRow; i += L::kThreads) {
    const int r = i / kRow, col = i % kRow;
    if (col < row_len) dst[r * out_row + col] = park[i];
  }
}

// The general form's form 0: each thread parks its 3 values of one output
// array, then the block writes its output rows (th pixel rows x the
// group's `rows` phase rows, from row_lo) of tw * s * 3 contiguous floats.
__device__ __forceinline__ void park_and_store_general(const float (&v)[3], float* park,
                                                       float* __restrict__ out, const Geometry& g,
                                                       int y0, int x0, int h, int w, int row_lo, int ty,
                                                       int tx, int py, int px, bool inside, int tid,
                                                       int n_threads) {
  const int row_len = g.tw * g.s * 3;  // floats in a parked output row
  if (inside) {
#pragma unroll
    for (int c = 0; c < 3; ++c) park[(ty * g.rows + py - row_lo) * row_len + (tx * g.s + px) * 3 + c] = v[c];
  }
  __syncthreads();
  const int valid = min(g.tw, w - x0) * g.s * 3;
  const long long out_row = (long long)w * g.s * 3;
  for (int i = tid; i < g.th * g.rows * row_len; i += n_threads) {
    const int r = i / row_len, col = i % row_len;
    const int yy = y0 + r / g.rows, pr = row_lo + r % g.rows;
    if (col < valid && yy < h && pr < g.s) {
      out[((long long)yy * g.s + pr) * out_row + (long long)x0 * g.s * 3 + col] = park[i];
    }
  }
}

// The general form in pieces (merge_fast_pieces_kernel<kForm>): a thread
// per (pixel, phase), frames and pieces of the tap list split over grid z
// as the plan says (see the file's head); a step stages a piece and its
// runs from the device table, each run {ky s, kx0 s, its staged offset,
// len} as the host computed it.
constexpr int kPiecesThreads = 512;  // the pieces kernel's bound: up to 128 registers a thread

template <int kForm>
__global__ void __launch_bounds__(kPiecesThreads)
merge_fast_pieces_kernel(const float* __restrict__ warped, const float* __restrict__ residual,
                         const float* __restrict__ certainty, const float* __restrict__ omega,
                         float* __restrict__ out, int frames, int h, int w, float rb, const Geometry geo) {
  using L = Layout<0, kForm>;
  const int sc = geo.s, tw = geo.tw, th = geo.th;
  const float sf = (float)sc;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int tx = tid % tw, ty = tid / tw % th;
  // grid z: (frame chunk, tap group, group of phase rows), the last fastest
  int z = blockIdx.z;
  const int rg = z % geo.row_groups;
  z /= geo.row_groups;
  const int tg = z % geo.tap_groups, fc = z / geo.tap_groups;
  const int ph = rg * geo.rows * sc + tid / (tw * th);
  const int row0 = ph / sc, col0 = ph % sc;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w && row0 < sc;
  const long long plane = (long long)h * w;
  const long long pix = (long long)min(y, h - 1) * w + min(x, w - 1);

  // the block's frames [f_lo, f_hi) and pieces [p_lo, p_lo + np), evenly;
  // step k is frame f_lo + k / np, piece p_lo + k % np
  const int f_lo = fc * frames / geo.frame_chunks, f_hi = (fc + 1) * frames / geo.frame_chunks;
  const int p_lo = tg * geo.n_pieces / geo.tap_groups;
  const int np = (tg + 1) * geo.n_pieces / geo.tap_groups - p_lo;
  const int steps = (f_hi - f_lo) * np;
  // a piece: {ky_lo, kx_lo, staged row length, sites}, {first run, runs}
  const int4* pieces = reinterpret_cast<const int4*>(geo.table);
  const int4* runs = pieces + 2 * geo.n_pieces;  // {ky s, kx0 s (float bits), offset, len}

  // two buffers: float4 sites [2][max_sites], float2 sites [2][max_sites],
  // runs [2][max_runs]
  extern __shared__ float4 smem[];
  float2* smem2 = reinterpret_cast<float2*>(smem + 2 * geo.max_sites);
  int4* sruns = reinterpret_cast<int4*>(smem2 + 2 * geo.max_sites);
  const auto stage = [&](int k, int buf) {
    const int4 pc = __ldg(pieces + 2 * (p_lo + k % np));  // ky_lo, kx_lo, sw, sites
    const int sw = pc.z, sites = pc.w;
    float4* a = smem + buf * geo.max_sites;
    float2* b = smem2 + buf * geo.max_sites;
    const long long fbase = (long long)(f_lo + k / np) * plane * 3;
    for (int s = tid; s < sites; s += n_threads) {
      const int r = min(max(y0 + pc.x + s / sw, 0), h - 1);
      const int c = min(max(x0 + pc.y + s % sw, 0), w - 1);
      const long long g = fbase + ((long long)r * w + c) * 3;
      cp_async4(&a[s].x, warped + g);
      cp_async4(&a[s].y, warped + g + 1);
      cp_async4(&a[s].z, warped + g + 2);
      cp_async4(&a[s].w, certainty + g);
      cp_async4(&b[s].x, certainty + g + 1);
      cp_async4(&b[s].y, certainty + g + 2);
    }
    const int2 rr = __ldg(reinterpret_cast<const int2*>(pieces + 2 * (p_lo + k % np) + 1));
    for (int i = tid; i < rr.y; i += n_threads) cp_async16(sruns + buf * geo.max_runs + i, runs + rr.x + i);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float o0 = -0.5f * kL * omega[pix * 3 + 0];
  const float o1 = -0.5f * kL * omega[pix * 3 + 1];
  const float o2 = -kL * omega[pix * 3 + 2];
  const float phis_x = (((float)col0 + 0.5f) / sf - 0.5f) * sf;
  const float phis_y = (((float)row0 + 0.5f) / sf - 0.5f) * sf;

  float acc[L::kSlots][3];
#pragma unroll
  for (int k = 0; k < L::kSlots; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  __nv_bfloat162 fsum[3];  // form 4: this frame's bfloat16 (num, den) sums per channel
  float ey = 0.0f, ex = 0.0f;
  const float2* res = reinterpret_cast<const float2*>(residual) + pix;
  if (steps > 0) stage(0, 0);
  for (int k = 0; k < steps; ++k) {
    const int buf = k & 1, kp = k % np;
    float2 r = make_float2(0.0f, 0.0f);
    if (kp == 0) r = res[(f_lo + k / np) * plane];
    if (k + 1 < steps) {
      stage(k + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    const int4 pc = __ldg(pieces + 2 * (p_lo + kp));
    const int sw = pc.z, sites = pc.w;
    const int n_runs = __ldg(reinterpret_cast<const int*>(pieces + 2 * (p_lo + kp) + 1) + 1);
    float4* a = smem + buf * geo.max_sites;
    float2* b = smem2 + buf * geo.max_sites;
    // value x certainty on the sites this thread copied, or for bfloat16
    // both rounded; the barrier then publishes the step to the block
    for (int s = tid; s < sites; s += n_threads) {
      const float4 v = a[s];
      const float2 c = b[s];
      if constexpr (L::kBf16) {
        const auto rnd = [](float x) { return __bfloat162float(__float2bfloat16_rn(x)); };
        a[s] = make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w));
        b[s] = make_float2(rnd(c.x), rnd(c.y));
      } else {
        a[s] = make_float4(v.x * v.w, v.y * c.x, v.z * c.y, v.w);
      }
    }
    __syncthreads();

    if (kp == 0) {  // a frame's first piece: its residual terms
      ey = fminf(fmaxf(r.x, -rb), rb) * sf + phis_y;
      ex = fminf(fmaxf(r.y, -rb), rb) * sf + phis_x;
      if constexpr (L::kBf16) fsum[0] = fsum[1] = fsum[2] = __float2bfloat162_rn(0.0f);
    }
    if (inside) {
      const int4* sr = sruns + buf * geo.max_runs;
      const int my_site = ty * sw + tx;  // the run offsets count from the piece's first site
#pragma unroll 1
      for (int run = 0; run < n_runs; ++run) {
        const int4 rn = sr[run];
        // the row's terms, shared by its taps: A = dy^2 o_yy, B = dy o_xy
        const float dy = __int_as_float(rn.x) - ey;
        const float qa = dy * dy * o1;
        const float qb = dy * o2;
        const float4* pa = a + my_site + rn.z;
        const float2* pb = b + my_site + rn.z;
        float kxs = __int_as_float(rn.y);
#pragma unroll 1
        for (int t = 0; t < rn.w; ++t, kxs += sf) {
          const float4 va = pa[t];  // v0 c0, v1 c1, v2 c2, c0 (form 4: v0, v1, v2, c0)
          const float2 vb = pb[t];  // c1, c2
          const float dx = kxs - ex;
          const float wgt = exp2_approx(fmaf(dx, fmaf(dx, o0, qb), qa));
          if constexpr (L::kBf16) {
            const __nv_bfloat16 wb = __float2bfloat16_rn(wgt);
            const float vs[3] = {va.x, va.y, va.z}, cs[3] = {va.w, vb.x, vb.y};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const __nv_bfloat16 cw = __hmul_rn(wb, __float2bfloat16_rn(cs[c]));
              fsum[c] = __hadd2(fsum[c], __hmul2_rn(__floats2bfloat162_rn(vs[c], 1.0f), __bfloat162bfloat162(cw)));
            }
          } else if constexpr (kForm == 3) {
            const float wdy = wgt * dy, wdx = wgt * dx;
            const float wm[6] = {wgt, wdy, wdx, wdy * dy, wdy * dx, wdx * dx};
            const float cs[3] = {va.w, vb.x, vb.y};
            const float vs[3] = {va.x, va.y, va.z};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
#pragma unroll
              for (int m = 0; m < 6; ++m) acc[m][c] = fmaf(wm[m], cs[c], acc[m][c]);
#pragma unroll
              for (int m = 0; m < 3; ++m) acc[6 + m][c] = fmaf(wm[m], vs[c], acc[6 + m][c]);
            }
          } else if constexpr (L::kOrder1) {
            const float wdy = wgt * dy, wdx = wgt * dx;
            acc[0][0] = fmaf(wgt, va.w, acc[0][0]);
            acc[0][1] = fmaf(wgt, vb.x, acc[0][1]);
            acc[0][2] = fmaf(wgt, vb.y, acc[0][2]);
            acc[1][0] = fmaf(wdy, va.w, acc[1][0]);
            acc[1][1] = fmaf(wdy, vb.x, acc[1][1]);
            acc[1][2] = fmaf(wdy, vb.y, acc[1][2]);
            acc[2][0] = fmaf(wdx, va.w, acc[2][0]);
            acc[2][1] = fmaf(wdx, vb.x, acc[2][1]);
            acc[2][2] = fmaf(wdx, vb.y, acc[2][2]);
            acc[3][0] = fmaf(wgt, va.x, acc[3][0]);
            acc[3][1] = fmaf(wgt, va.y, acc[3][1]);
            acc[3][2] = fmaf(wgt, va.z, acc[3][2]);
          } else {
            acc[0][0] = fmaf(wgt, va.x, acc[0][0]);
            acc[0][1] = fmaf(wgt, va.y, acc[0][1]);
            acc[0][2] = fmaf(wgt, va.z, acc[0][2]);
            acc[1][0] = fmaf(wgt, va.w, acc[1][0]);
            acc[1][1] = fmaf(wgt, vb.x, acc[1][1]);
            acc[1][2] = fmaf(wgt, vb.y, acc[1][2]);
          }
        }
      }
      if constexpr (L::kBf16) {
        if (kp == np - 1) {  // the frame's sums join the f32 totals
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            acc[0][c] += __low2float(fsum[c]);
            acc[1][c] += __high2float(fsum[c]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is restaged for step k + 2 (or parks the outputs)
  }

  const long long slot = (long long)sc * sc * 3 * plane;  // floats of one output array
  if (geo.frame_chunks * geo.tap_groups > 1) {
    // a partial sum: its slot of the scratch, in the phase layout, for
    // merge_fast_combine_kernel
    if (inside) {
      float* dst = out + (long long)(fc * geo.tap_groups + tg) * L::kSlots * slot +
                   ((long long)row0 * sc + col0) * 3 * plane + (long long)y * w + x;
#pragma unroll
      for (int k = 0; k < L::kSlots; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[k * slot + c * plane] = acc[k][c];
    }
  } else if constexpr (L::kPhase) {
    if (inside) {
      float* dst = out + ((long long)row0 * sc + col0) * 3 * plane + (long long)y * w + x;
#pragma unroll
      for (int k = 0; k < L::kSlots; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[k * slot + c * plane] = acc[k][c];
    }
  } else {
    float* park = reinterpret_cast<float*>(smem);
    const int row_lo = rg * geo.rows;
    park_and_store_general(acc[0], park, out, geo, y0, x0, h, w, row_lo, ty, tx, row0, col0, inside, tid,
                           n_threads);
    __syncthreads();
    park_and_store_general(acc[1], park, out + slot, geo, y0, x0, h, w, row_lo, ty, tx, row0, col0, inside,
                           tid, n_threads);
  }
}

template <int S, int kForm>
__global__ void __launch_bounds__(Layout<S, kForm>::kThreads, Layout<S, kForm>::kMinBlocks)
merge_fast_kernel(const float* __restrict__ warped,
                  const float* __restrict__ residual,
                  const float* __restrict__ certainty,
                  const float* __restrict__ omega,
                  float* __restrict__ out,
                  int frames, int h, int w, int halo, float rb,
                  const Taps taps, const Geometry geo) {
  using L = Layout<S, kForm>;
  constexpr bool kOrder1 = L::kOrder1;
  constexpr int R = L::kRows, C = L::kCols;
  // S = 0: the general form, its scale and block shape from geo
  constexpr bool kGeneral = S == 0;
  const int sc = kGeneral ? geo.s : S;
  const int tile_w = kGeneral ? geo.tw : kTileW, tile_h = kGeneral ? geo.th : L::kTileH;
  const int n_threads = kGeneral ? (int)blockDim.x : L::kThreads;
  // two frame buffers: float4 sites [2][sites], then float2 sites [2][sites]
  extern __shared__ float4 smem[];
  const int sw = tile_w + 2 * halo;
  const int sites = (tile_h + 2 * halo) * sw;
  float2* smem2 = reinterpret_cast<float2*>(smem + 2 * sites);

  // the thread's first phase row and column; order 0's blocks are flat,
  // so both are the constant 0 there (its phis fold into constants), and
  // form 2's first column is 0. The general form: a flat block of
  // (phase, row, column), its phases from grid z's group of rows on
  int row0, col0, tid, tx, ty;
  if constexpr (kGeneral) {
    tid = threadIdx.x;
    tx = tid % tile_w;
    ty = tid / tile_w % tile_h;
    const int ph = blockIdx.z * geo.rows * sc + tid / (tile_w * tile_h);
    row0 = ph / sc;
    col0 = ph % sc;
  } else {
    const int z = L::kZ == 1 ? 0 : (int)threadIdx.z;
    row0 = (z / L::kColGroups) * R;
    col0 = (z % L::kColGroups) * C;
    tid = (z * L::kTileH + threadIdx.y) * kTileW + threadIdx.x;
    tx = threadIdx.x;
    ty = threadIdx.y;
  }
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w && (!kGeneral || row0 < sc);
  const long long plane = (long long)h * w;
  const long long pix = (long long)min(y, h - 1) * w + min(x, w - 1);
  const int my_site = (ty + halo) * sw + tx + halo;

  // exp(q) = 2^(q log2 e): -1/2 log2(e), and the cross term's 2, folded
  // into omega
  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float o0 = -0.5f * kL * omega[pix * 3 + 0];
  const float o1 = -0.5f * kL * omega[pix * 3 + 1];
  const float o2 = -kL * omega[pix * 3 + 2];
  // phis[p] = phi[p] * s with phi[p] = (p + 0.5) / s - 0.5, in the f32
  // operations of fast_merge._output_phase_offsets: the thread's columns
  // and rows
  float phis[C], phis_y[R];
#pragma unroll
  for (int p = 0; p < C; ++p) phis[p] = (((float)(col0 + p) + 0.5f) / (float)sc - 0.5f) * (float)sc;
#pragma unroll
  for (int p = 0; p < R; ++p) phis_y[p] = (((float)(row0 + p) + 0.5f) / (float)sc - 0.5f) * (float)sc;

  float acc[L::kSlots][R][C][3];
#pragma unroll
  for (int k = 0; k < L::kSlots; ++k)
#pragma unroll
    for (int py = 0; py < R; ++py)
#pragma unroll
      for (int px = 0; px < C; ++px)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[k][py][px][c] = 0.0f;

  const float2* res = reinterpret_cast<const float2*>(residual) + pix;
  constexpr int kStageThreads = kGeneral ? 0 : L::kThreads;  // 0: n_threads
  stage_frame<kStageThreads>(warped, certainty, smem, smem2, 0, y0, x0, h, w, halo, sw, sites, tid, n_threads);
  for (int f = 0; f < frames; ++f) {
    const float2 r = res[f * plane];
    float4* a = smem + (f & 1) * sites;
    float2* b = smem2 + (f & 1) * sites;
    if (f + 1 < frames) {
      const int nb = (f + 1) & 1;
      stage_frame<kStageThreads>(warped, certainty, smem + nb * sites, smem2 + nb * sites,
                                 (f + 1) * plane * 3, y0, x0, h, w, halo, sw, sites, tid, n_threads);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    // value x certainty on the sites this thread copied (its own copies
    // have landed), or for bfloat16 both rounded; the barrier then
    // publishes the frame to the block
    for (int s = tid; s < sites; s += n_threads) {
      const float4 v = a[s];
      const float2 c = b[s];
      if constexpr (L::kBf16) {
        const auto rnd = [](float x) { return __bfloat162float(__float2bfloat16_rn(x)); };
        a[s] = make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w));
        b[s] = make_float2(rnd(c.x), rnd(c.y));
      } else {
        a[s] = make_float4(v.x * v.w, v.y * c.x, v.z * c.y, v.w);
      }
    }
    __syncthreads();

    if (inside) {
      // dy = ky s - (ry s + phis[py]), dx likewise: the tap table holds
      // ky s and kx s
      const float ry = fminf(fmaxf(r.x, -rb), rb);
      const float rx = fminf(fmaxf(r.y, -rb), rb);
      float ey[R], ex[C];
#pragma unroll
      for (int p = 0; p < R; ++p) ey[p] = ry * (float)sc + phis_y[p];
#pragma unroll
      for (int p = 0; p < C; ++p) ex[p] = rx * (float)sc + phis[p];
      // form 4: this frame's bfloat16 (num, den) sums per phase and channel
      __nv_bfloat162 fsum[R][C][3];
      if constexpr (L::kBf16) {
#pragma unroll
        for (int py = 0; py < R; ++py)
#pragma unroll
          for (int px = 0; px < C; ++px)
#pragma unroll
            for (int c = 0; c < 3; ++c) fsum[py][px][c] = __float2bfloat162_rn(0.0f);
      }
#pragma unroll 1
      for (int run = 0; run < taps.n; ++run) {
        // the row's terms, shared by its taps: A = dy^2 o_yy, B = dy o_xy
        float qa[R], qb[R], dys[R];
#pragma unroll
        for (int py = 0; py < R; ++py) {
          dys[py] = taps.kys[run] - ey[py];
          qa[py] = dys[py] * dys[py] * o1;
          qb[py] = dys[py] * o2;
        }
        const float4* pa = a + my_site + taps.off0[run];
        const float2* pb = b + my_site + taps.off0[run];
        float kxs = taps.kxs0[run];
        const int len = taps.len[run];
#pragma unroll 1
        for (int k = 0; k < len; ++k, kxs += (float)sc) {
          const float4 va = pa[k];  // v0 c0, v1 c1, v2 c2, c0 (form 4: v0, v1, v2, c0)
          const float2 vb = pb[k];  // c1, c2
          // form 4: (v, 1) per channel and c, bfloat16 (exact: staged rounded)
          __nv_bfloat162 v1[3];
          __nv_bfloat16 cb[3];
          if constexpr (L::kBf16) {
            v1[0] = __floats2bfloat162_rn(va.x, 1.0f);
            v1[1] = __floats2bfloat162_rn(va.y, 1.0f);
            v1[2] = __floats2bfloat162_rn(va.z, 1.0f);
            cb[0] = __float2bfloat16_rn(va.w);
            cb[1] = __float2bfloat16_rn(vb.x);
            cb[2] = __float2bfloat16_rn(vb.y);
          }
#pragma unroll
          for (int px = 0; px < C; ++px) {
            const float dx = kxs - ex[px];
#pragma unroll
            for (int py = 0; py < R; ++py) {
              const float wgt = exp2_approx(fmaf(dx, fmaf(dx, o0, qb[py]), qa[py]));
              if constexpr (L::kBf16) {
                const __nv_bfloat16 wb = __float2bfloat16_rn(wgt);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                  const __nv_bfloat16 cw = __hmul_rn(wb, cb[c]);
                  fsum[py][px][c] = __hadd2(fsum[py][px][c], __hmul2_rn(v1[c], __bfloat162bfloat162(cw)));
                }
              } else if constexpr (kForm == 3) {
                // the nine moments: w dy, w dx and their products once,
                // then nine FMAs per channel against (c, v c)
                const float wdy = wgt * dys[py], wdx = wgt * dx;
                const float wm[6] = {wgt, wdy, wdx, wdy * dys[py], wdy * dx, wdx * dx};
                const float cs[3] = {va.w, vb.x, vb.y};
                const float vs[3] = {va.x, va.y, va.z};
#pragma unroll
                for (int c = 0; c < 3; ++c) {
#pragma unroll
                  for (int k = 0; k < 6; ++k) acc[k][py][px][c] = fmaf(wm[k], cs[c], acc[k][py][px][c]);
#pragma unroll
                  for (int k = 0; k < 3; ++k) {
                    acc[6 + k][py][px][c] = fmaf(wm[k], vs[c], acc[6 + k][py][px][c]);
                  }
                }
              } else if constexpr (kOrder1) {
                const float wdy = wgt * dys[py], wdx = wgt * dx;
                acc[0][py][px][0] = fmaf(wgt, va.w, acc[0][py][px][0]);
                acc[0][py][px][1] = fmaf(wgt, vb.x, acc[0][py][px][1]);
                acc[0][py][px][2] = fmaf(wgt, vb.y, acc[0][py][px][2]);
                acc[1][py][px][0] = fmaf(wdy, va.w, acc[1][py][px][0]);
                acc[1][py][px][1] = fmaf(wdy, vb.x, acc[1][py][px][1]);
                acc[1][py][px][2] = fmaf(wdy, vb.y, acc[1][py][px][2]);
                acc[2][py][px][0] = fmaf(wdx, va.w, acc[2][py][px][0]);
                acc[2][py][px][1] = fmaf(wdx, vb.x, acc[2][py][px][1]);
                acc[2][py][px][2] = fmaf(wdx, vb.y, acc[2][py][px][2]);
                acc[3][py][px][0] = fmaf(wgt, va.x, acc[3][py][px][0]);
                acc[3][py][px][1] = fmaf(wgt, va.y, acc[3][py][px][1]);
                acc[3][py][px][2] = fmaf(wgt, va.z, acc[3][py][px][2]);
              } else {
                acc[0][py][px][0] = fmaf(wgt, va.x, acc[0][py][px][0]);
                acc[0][py][px][1] = fmaf(wgt, va.y, acc[0][py][px][1]);
                acc[0][py][px][2] = fmaf(wgt, va.z, acc[0][py][px][2]);
                acc[1][py][px][0] = fmaf(wgt, va.w, acc[1][py][px][0]);
                acc[1][py][px][1] = fmaf(wgt, vb.x, acc[1][py][px][1]);
                acc[1][py][px][2] = fmaf(wgt, vb.y, acc[1][py][px][2]);
              }
            }
          }
        }
      }
      if constexpr (L::kBf16) {  // the frame's sums join the f32 totals
#pragma unroll
        for (int py = 0; py < R; ++py)
#pragma unroll
          for (int px = 0; px < C; ++px)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              acc[0][py][px][c] += __low2float(fsum[py][px][c]);
              acc[1][py][px][c] += __high2float(fsum[py][px][c]);
            }
      }
    }
    __syncthreads();  // this buffer is restaged for frame f + 2 (or parks the outputs)
  }

  const long long slot = (long long)sc * sc * 3 * plane;  // floats of one output array
  if constexpr (L::kPhase) {
    // plane (py, px, c) of each output at (y, x): a warp writes 32
    // consecutive floats of one plane row. The thread's planes of one
    // phase row of an output follow each other, so one pointer steps by
    // a plane.
    if (inside) {
#pragma unroll
      for (int k = 0; k < L::kSlots; ++k) {
#pragma unroll
        for (int py = 0; py < R; ++py) {
          float* dst = out + k * slot + ((long long)(row0 + py) * sc + col0) * 3 * plane +
                       (long long)y * w + x;
#pragma unroll
          for (int px = 0; px < C; ++px)
#pragma unroll
            for (int c = 0; c < 3; ++c, dst += plane) *dst = acc[k][py][px][c];
        }
      }
    }
  } else if constexpr (kGeneral) {
    float* park = reinterpret_cast<float*>(smem);
    const int row_lo = blockIdx.z * geo.rows;
    park_and_store_general(acc[0][0][0], park, out, geo, y0, x0, h, w, row_lo, ty, tx, row0, col0, inside,
                           tid, n_threads);
    __syncthreads();
    park_and_store_general(acc[1][0][0], park, out + slot, geo, y0, x0, h, w, row_lo, ty, tx, row0, col0,
                           inside, tid, n_threads);
  } else {
    park_and_store<S>(acc[0], reinterpret_cast<float*>(smem), out, y0, x0, h, w, inside, tid);
    __syncthreads();
    park_and_store<S>(acc[1], reinterpret_cast<float*>(smem), out + slot, y0, x0, h, w, inside, tid);
  }
}

// Form 4 on the templated layouts (S = 1-4): a thread's output phases in
// lane pairs, two lanes of one bfloat16x2 instruction each (see the
// file's head). Pair i's lanes are (pixel, phase row, phase column): at
// even S two phase columns of one pixel, at S = 3 two phase rows (pairs
// 0-2), then (2, 0) with (2, 1) and (2, 2) alone (its high lane repeats
// the low one and is never stored), at S = 1 two pixels kRowsT rows apart.
template <int S>
struct Bf16Layout {
  static constexpr int kPix = S == 1 ? 2 : 1;       // pixels a thread holds
  static constexpr int kRowsT = 8 / kPix;           // thread rows of a 32 x 8-pixel block
  static constexpr int kD = S == 1 ? kRowsT : 0;    // rows from a pair's low lane's site to its high one's
  // threads a pixel, each kRowsP phase rows: at S = 4 two (one took 217
  // registers, one block an SM; at S = 2 two measured slower)
  static constexpr int kZ = S == 4 ? 2 : 1;
  static constexpr int kRowsP = S / kZ;
  static constexpr int kPairs = S == 1 ? 1 : S == 3 ? 5 : kRowsP * S / 2;
  static constexpr int kThreads = kTileW * kRowsT * kZ;
  // blocks an SM: S = 1 four of 128 threads; S = 2 two (three, at 80
  // registers, measured slower); S = 3 two, at 128 registers (one took
  // 141); S = 4 one of 512 threads
  static constexpr int kMinBlocks = S == 1 ? 4 : (S <= 3 ? 2 : 1);
  // lane l (0 low, 1 high) of pair i: its pixel, phase row (of the
  // thread's kRowsP), phase column
  __host__ __device__ static constexpr int pix(int i, int l) { return S == 1 ? l : 0; }
  __host__ __device__ static constexpr int py(int i, int l) {
    return S == 1 ? 0 : S == 3 ? (i < 3 ? l : 2) : i / (S / 2);
  }
  __host__ __device__ static constexpr int px(int i, int l) {
    return S == 1 ? 0 : S == 3 ? (i < 3 ? i : (i == 3 ? l : 2)) : 2 * (i % (S / 2)) + l;
  }
  __host__ __device__ static constexpr bool lone(int i) { return S == 3 && i == 4; }  // the high lane repeats the low
};

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}
__device__ __forceinline__ __nv_bfloat162 bf16x2_from(unsigned x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

template <int S>
__global__ void __launch_bounds__(Bf16Layout<S>::kThreads, Bf16Layout<S>::kMinBlocks)
merge_fast_bf16_kernel(const float* __restrict__ warped, const float* __restrict__ residual,
                       const float* __restrict__ certainty, const float* __restrict__ omega,
                       float* __restrict__ out, int frames, int h, int w, int halo, float rb,
                       const Taps taps) {
  using L = Bf16Layout<S>;
  constexpr int P = L::kPix, NP = L::kPairs;
  constexpr int kTileH = 8;
  // the frame's f32 sites (cp.async's target) [sites], then the pairs
  // [elems]: float4 / uint4 (v0, v1, v2, c0), then float2 / uint2 (c1, c2)
  extern __shared__ float4 smem[];
  const int sw = kTileW + 2 * halo;
  const int sites = (kTileH + 2 * halo) * sw;
  const int elems = (L::kRowsT + 2 * halo) * sw;
  float4* raw_a = smem;
  uint4* pair_a = reinterpret_cast<uint4*>(raw_a + sites);
  float2* raw_b = reinterpret_cast<float2*>(pair_a + elems);
  uint2* pair_b = reinterpret_cast<uint2*>(raw_b + sites);

  const int tx = threadIdx.x, ty = threadIdx.y, z = L::kZ == 1 ? 0 : (int)threadIdx.z;
  const int tid = (z * L::kRowsT + ty) * kTileW + tx;
  const int row0 = z * L::kRowsP;  // the thread's first phase row
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int x = x0 + tx;
  // pixel k sits at row ty + k kRowsT of the tile; the first is inside
  // wherever the second is
  const bool active = y0 + ty < h && x < w;
  const long long plane = (long long)h * w;
  long long pixel[P];
  const float2* res[P];
  float o0[P], o1[P], o2[P];
  constexpr float kL = 1.4426950408889634f;  // log2(e)
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pixel[k] = (long long)min(y0 + ty + k * L::kRowsT, h - 1) * w + min(x, w - 1);
    res[k] = reinterpret_cast<const float2*>(residual) + pixel[k];
    o0[k] = -0.5f * kL * omega[pixel[k] * 3 + 0];
    o1[k] = -0.5f * kL * omega[pixel[k] * 3 + 1];
    o2[k] = -kL * omega[pixel[k] * 3 + 2];
  }
  // phis[p] = phi[p] * s, phi[p] = (p + 0.5) / s - 0.5: columns, the thread's rows
  float phis[S], phis_y[L::kRowsP];
#pragma unroll
  for (int p = 0; p < S; ++p) phis[p] = (((float)p + 0.5f) / (float)S - 0.5f) * (float)S;
#pragma unroll
  for (int p = 0; p < L::kRowsP; ++p) phis_y[p] = (((float)(row0 + p) + 0.5f) / (float)S - 0.5f) * (float)S;
  const int my_elem = (ty + halo) * sw + tx + halo;

  float acc[2][P][L::kRowsP][S][3];  // f32 num, den over the frames
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int py = 0; py < L::kRowsP; ++py)
#pragma unroll
      for (int px = 0; px < S; ++px)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[0][k][py][px][c] = acc[1][k][py][px][c] = 0.0f;

  stage_frame<L::kThreads>(warped, certainty, raw_a, raw_b, 0, y0, x0, h, w, halo, sw, sites, tid);
  for (int f = 0; f < frames; ++f) {
    float2 r[P];
#pragma unroll
    for (int k = 0; k < P; ++k) r[k] = res[k][f * plane];
    // the frame's sites have landed and the block is done with the pairs
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // the pairs, rounded to bfloat16 once: element e holds (site e, site
    // e + kD rows) per value and certainty, a lane each
    for (int e = tid; e < elems; e += L::kThreads) {
      const int hi = e + L::kD * sw;
      const float4 al = raw_a[e], ah = raw_a[hi];
      const float2 bl = raw_b[e], bh = raw_b[hi];
      pair_a[e] = make_uint4(bf16x2_bits(__floats2bfloat162_rn(al.x, ah.x)),
                             bf16x2_bits(__floats2bfloat162_rn(al.y, ah.y)),
                             bf16x2_bits(__floats2bfloat162_rn(al.z, ah.z)),
                             bf16x2_bits(__floats2bfloat162_rn(al.w, ah.w)));
      pair_b[e] = make_uint2(bf16x2_bits(__floats2bfloat162_rn(bl.x, bh.x)),
                             bf16x2_bits(__floats2bfloat162_rn(bl.y, bh.y)));
    }
    __syncthreads();
    // the next frame's copies land while this one accumulates
    if (f + 1 < frames) {
      stage_frame<L::kThreads>(warped, certainty, raw_a, raw_b, (f + 1) * plane * 3, y0, x0, h, w, halo, sw,
                               sites, tid);
    }
    if (!active) continue;

    float ey[P][L::kRowsP], ex[P][S];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float ry = fminf(fmaxf(r[k].x, -rb), rb), rx = fminf(fmaxf(r[k].y, -rb), rb);
#pragma unroll
      for (int p = 0; p < L::kRowsP; ++p) ey[k][p] = ry * (float)S + phis_y[p];
#pragma unroll
      for (int p = 0; p < S; ++p) ex[k][p] = rx * (float)S + phis[p];
    }
    // this frame's bfloat16 sums, a lane per phase: num = sum bf16(v
    // bf16(w c)), den = sum bf16(w c), each pair per channel
    __nv_bfloat162 num[NP][3], den[NP][3];
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) num[i][c] = den[i][c] = __float2bfloat162_rn(0.0f);
#pragma unroll 1
    for (int run = 0; run < taps.n; ++run) {
      // the row's terms, shared by its taps: A = dy^2 o_yy, B = dy o_xy
      float qa[P][L::kRowsP], qb[P][L::kRowsP];
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int p = 0; p < L::kRowsP; ++p) {
          const float dy = taps.kys[run] - ey[k][p];
          qa[k][p] = dy * dy * o1[k];
          qb[k][p] = dy * o2[k];
        }
      const uint4* pa = pair_a + my_elem + taps.off0[run];
      const uint2* pb = pair_b + my_elem + taps.off0[run];
      float kxs = taps.kxs0[run];
      const int len = taps.len[run];
      // two taps an iteration at S = 2 give its short chains (cvt, two
      // products, the add) more to overlap: 2% (not at S = 1, 3, 4)
#pragma unroll (S == 2 ? 2 : 1)
      for (int t = 0; t < len; ++t, kxs += (float)S) {
        const uint4 va = pa[t];
        const uint2 vb = pb[t];
        const __nv_bfloat162 vs[3] = {bf16x2_from(va.x), bf16x2_from(va.y), bf16x2_from(va.z)};
        const __nv_bfloat162 cs[3] = {bf16x2_from(va.w), bf16x2_from(vb.x), bf16x2_from(vb.y)};
        float dx[P][S];
#pragma unroll
        for (int k = 0; k < P; ++k)
#pragma unroll
          for (int p = 0; p < S; ++p) dx[k][p] = kxs - ex[k][p];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          float wl[2];
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const int k = L::pix(i, l), py = L::py(i, l), px = L::px(i, l);
            wl[l] = l && L::lone(i) ? wl[0]
                                    : exp2_approx(fmaf(dx[k][px], fmaf(dx[k][px], o0[k], qb[k][py]), qa[k][py]));
          }
          // the pair's weights rounded by one cvt; per channel bf16(w c)
          // and bf16(v w c) one _rn product each (two roundings, as JAX's)
          const __nv_bfloat162 w2 = __floats2bfloat162_rn(wl[0], wl[1]);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const __nv_bfloat162 cw = __hmul2_rn(w2, cs[c]);
            num[i][c] = __hadd2(num[i][c], __hmul2_rn(vs[c], cw));
            den[i][c] = __hadd2(den[i][c], cw);
          }
        }
      }
    }
    // the frame's sums join the f32 totals
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int l = 0; l < (L::lone(i) ? 1 : 2); ++l)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = L::pix(i, l), py = L::py(i, l), px = L::px(i, l);
          acc[0][k][py][px][c] += l ? __high2float(num[i][c]) : __low2float(num[i][c]);
          acc[1][k][py][px][c] += l ? __high2float(den[i][c]) : __low2float(den[i][c]);
        }
  }

  // plane (py, px, c) of each output at the pixel: a warp writes 32
  // consecutive floats of one plane row
  const long long slot = (long long)S * S * 3 * plane;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int y = y0 + ty + k * L::kRowsT;
    if (y >= h || x >= w) continue;
    float* dst = out + (long long)y * w + x;
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int py = 0; py < L::kRowsP; ++py)
#pragma unroll
        for (int px = 0; px < S; ++px)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            dst[o * slot + (((row0 + py) * S + px) * 3 + c) * plane] = acc[o][k][py][px][c];
          }
  }
}

template <int S>
int launch_bf16(const float* warped, const float* residual, const float* certainty, const float* omega,
                float* out, int frames, int h, int w, int halo, float rb, const Taps& taps, cudaStream_t stream) {
  using L = Bf16Layout<S>;
  const int sw = kTileW + 2 * halo;
  // the f32 sites and the bfloat16 pairs, 24 B each
  const size_t bytes = ((size_t)(8 + 2 * halo) * sw + (size_t)(L::kRowsT + 2 * halo) * sw) *
                       (sizeof(float4) + sizeof(float2));
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(merge_fast_bf16_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kTileW, L::kRowsT, L::kZ);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + 7) / 8);
  merge_fast_bf16_kernel<S><<<grid, block, bytes, stream>>>(warped, residual, certainty, omega, out, frames, h, w,
                                                            halo, rb, taps);
  return (int)cudaGetLastError();
}

template <int S, int kForm>
int launch(const float* warped, const float* residual, const float* certainty,
           const float* omega, float* out, int frames, int h, int w, int halo,
           float rb, const Taps& taps, cudaStream_t stream) {
  using L = Layout<S, kForm>;
  const int sites = (L::kTileH + 2 * halo) * (kTileW + 2 * halo);
  // two frame buffers, or (form 0) one parked output array, whichever is larger
  const size_t park = L::kPhase ? 0 : (size_t)L::kThreads * S * S * 3 * sizeof(float);
  const size_t bytes = std::max((size_t)sites * 2 * (sizeof(float4) + sizeof(float2)), park);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_fast_kernel<S, kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kTileW, L::kTileH, L::kZ);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + L::kTileH - 1) / L::kTileH);
  merge_fast_kernel<S, kForm><<<grid, block, bytes, stream>>>(
      warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, Geometry{});
  return (int)cudaGetLastError();
}

// merge_fast_combine_kernel: adds the general form's partial sums (n_parts
// slots of n floats, each the outputs in the phase layout) in slot order,
// frame chunks in frame order and each chunk's tap groups in list order
// (the plan's fixed order, so the result is deterministic), and writes
// them in the output's layout: form 0 interleaved (sH, sW, 3), the others
// as they are.
__global__ void __launch_bounds__(256)
merge_fast_combine_kernel(const float* __restrict__ parts, float* __restrict__ out, long long n, int n_parts,
                          int interleave, int s, int h, int w) {
  const long long plane = (long long)h * w, slot = (long long)s * s * 3 * plane;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n; e += (long long)gridDim.x * 256) {
    float total = parts[e];
    for (int p = 1; p < n_parts; ++p) total += parts[p * n + e];
    long long at = e;
    if (interleave) {  // (k, py, px, c, y, x) -> (k, s y + py, s x + px, c)
      const long long k = e / slot, rem = e % slot, pixel = rem % plane;
      const int ph = (int)(rem / (3 * plane)), c = (int)(rem / plane % 3);
      at = k * slot + ((pixel / w * s + ph / s) * ((long long)w * s) + pixel % w * s + ph % s) * 3 + c;
    }
    out[at] = total;
  }
}

// The general form's launch: geo's block (its threads within the form's
// bound) and grid, the host's shared bytes (kernels/merge.py::
// general_plan: two buffers of the whole tile's or the largest piece's
// sites and runs, or form 0's parked output rows) within kMaxSmem; the
// whole tile (merge_fast_kernel<0, form>, the runs in taps) or pieces
// (merge_fast_pieces_kernel<form>, the runs in geo.table). Where the plan
// splits frames or pieces over grid z, the blocks write their sums to
// `parts` and merge_fast_combine_kernel adds them into out.
template <int kForm>
int launch_general(const float* warped, const float* residual, const float* certainty,
                   const float* omega, float* out, int frames, int h, int w, int halo, float rb,
                   const Taps& taps, const Geometry& geo, int bytes, float* parts, cudaStream_t stream) {
  using L = Layout<0, kForm>;
  const bool pieces = geo.table != nullptr;
  const int threads = geo.tw * geo.th * geo.rows * geo.s;
  const int n_parts = geo.frame_chunks * geo.tap_groups;
  if (pieces && threads > kPiecesThreads) return (int)cudaErrorInvalidValue;
  const long long sites = pieces ? geo.max_sites : (long long)(geo.th + 2 * halo) * (geo.tw + 2 * halo);
  if (geo.tw < 1 || geo.th < 1 || geo.rows < 1 || geo.rows > geo.s || threads > L::kThreads ||
      geo.row_groups < 1 || (long long)geo.row_groups * geo.rows < geo.s ||
      (long long)(geo.row_groups - 1) * geo.rows >= geo.s || geo.frame_chunks < 1 ||
      geo.frame_chunks > (pieces ? frames : 1) || geo.tap_groups < 1 || geo.tap_groups > (pieces ? geo.n_pieces : 1) ||
      geo.max_sites < sites || (pieces && geo.max_runs < 1) || (n_parts > 1 && parts == nullptr) ||
      sites * 48 + (pieces ? (long long)geo.max_runs * 32 : 0) > bytes || bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long gz = (long long)geo.row_groups * n_parts;
  const dim3 grid((w + geo.tw - 1) / geo.tw, (h + geo.th - 1) / geo.th, (unsigned)gz);
  if (grid.y > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  float* dst = n_parts > 1 ? parts : out;
  if (pieces) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_fast_pieces_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    merge_fast_pieces_kernel<kForm><<<grid, threads, bytes, stream>>>(
        warped, residual, certainty, omega, dst, frames, h, w, rb, geo);
  } else {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_fast_kernel<0, kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    merge_fast_kernel<0, kForm><<<grid, threads, bytes, stream>>>(
        warped, residual, certainty, omega, dst, frames, h, w, halo, rb, taps, geo);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return (int)err;
  const long long n = (long long)L::kSlots * geo.s * geo.s * 3 * h * w;
  const long long blocks = std::min((n + 255) / 256, 132LL * 16);
  merge_fast_combine_kernel<<<(unsigned)blocks, 256, 0, stream>>>(parts, out, n, n_parts, kForm == 0, geo.s, h, w);
  return (int)cudaGetLastError();
}

template <int S>
int launch_form(int form, const float* warped, const float* residual, const float* certainty,
                const float* omega, float* out, int frames, int h, int w, int halo,
                float rb, const Taps& taps, cudaStream_t stream) {
  switch (form) {
    case 0: return launch<S, 0>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    case 1: return launch<S, 1>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    case 2: return launch<S, 2>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    case 3: return launch<S, 3>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    case 4: return launch_bf16<S>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The taps' reach, max |ky|, |kx| (-1 for a bad count).
int tap_halo(const int* yx, int n_taps) {
  if (n_taps < 0) return -1;
  int halo = 0;
  for (int t = 0; t < 2 * n_taps; ++t) halo = std::max(halo, std::abs(yx[t]));
  return halo;
}

// The taps as runs of one row with kx rising by 1 (any list of
// _active_taps is one run per row), for a staged row of sw sites; false
// past kMaxRuns.
bool build_runs(const int* yx, int n_taps, int scale, int sw, Taps* taps) {
  taps->n = 0;
  for (int t = 0; t < n_taps; ++t) {
    const int ky = yx[2 * t], kx = yx[2 * t + 1];
    if (t > 0 && ky == yx[2 * t - 2] && kx == yx[2 * t - 1] + 1) {
      ++taps->len[taps->n - 1];
      continue;
    }
    if (taps->n == kMaxRuns) return false;
    taps->kys[taps->n] = (float)(ky * scale);
    taps->kxs0[taps->n] = (float)(kx * scale);
    taps->off0[taps->n] = ky * sw + kx;
    taps->len[taps->n++] = 1;
  }
  return true;
}

}  // namespace

extern "C" {

// Launches the merge on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays:
// warped (F, H, W, 3), residual (F, H, W, 2) (8-byte aligned: it is read
// as float2), certainty (F, H, W, 3), omega (H, W, 3). out holds the
// form's outputs one after another, S*S*3*H*W floats each: form 0 num and
// den as (S*H, S*W, 3); form 1 the same as (S, S, 3, H, W); form 2 m00,
// m01, m02, b0, each (S, S, 3, H, W); form 3 m00, m01, m02, m11, m12,
// m22, b0, b1, b2, each (S, S, 3, H, W); form 4 (bfloat16) num and den
// as (S, S, 3, H, W). Every output is written in full. S = 1..4.
// taps_yx is a HOST array of n_taps (ky, kx) pairs, each within
// +-kMaxRadius, in at most kMaxRuns runs of one row with kx rising by 1
// (any list of _active_taps is one run per row).
int mfsr_merge_fast(const void* warped, const void* residual,
                    const void* certainty, const void* omega, void* out, int frames,
                    int h, int w, int scale, int form, const void* taps_yx, int n_taps,
                    float rb, void* stream) {
  if (frames < 1 || h < 1 || w < 1 || reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* yx = static_cast<const int*>(taps_yx);
  const int halo = tap_halo(yx, n_taps);
  Taps taps;
  if (halo < 0 || halo > kMaxRadius || !build_runs(yx, n_taps, scale, kTileW + 2 * halo, &taps)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* a = static_cast<const float*>(warped);
  const float* r = static_cast<const float*>(residual);
  const float* c = static_cast<const float*>(certainty);
  const float* o = static_cast<const float*>(omega);
  float* outs = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 1: return launch_form<1>(form, a, r, c, o, outs, frames, h, w, halo, rb, taps, st);
    case 2: return launch_form<2>(form, a, r, c, o, outs, frames, h, w, halo, rb, taps, st);
    case 3: return launch_form<3>(form, a, r, c, o, outs, frames, h, w, halo, rb, taps, st);
    case 4: return launch_form<4>(form, a, r, c, o, outs, frames, h, w, halo, rb, taps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the general form on `stream` and returns cudaGetLastError():
// merge_fast_kernel<0, form> on the whole tile and halo where table is
// null (taps_yx, a HOST array of n_taps (ky, kx) pairs in at most
// kMaxRuns runs of one row, staged whole), else merge_fast_pieces_kernel
// <form> on the plan's DEVICE int32 table of n_pieces pieces (Geometry);
// and where the plan splits frames or pieces, merge_fast_combine_kernel
// after it. The arrays, out and forms are mfsr_merge_fast's, at any scale
// >= 1 and any taps. The block is tile_w x tile_h pixels x `rows` phase
// rows, grid z row_groups x frame_chunks x tap_groups, each buffer
// max_sites sites and max_runs runs within smem_bytes of dynamic shared
// memory; parts is DEVICE scratch of frame_chunks * tap_groups times
// out's floats where that is past 1 (kernels/merge.py::general_plan gives
// all of it).
int mfsr_merge_fast_general(const void* warped, const void* residual, const void* certainty,
                            const void* omega, void* out, int frames, int h, int w, int scale,
                            int form, const void* taps_yx, int n_taps, float rb, const void* table,
                            int n_pieces, int tile_w, int tile_h, int rows, int row_groups,
                            int frame_chunks, int tap_groups, int max_sites, int max_runs,
                            int smem_bytes, void* parts, void* stream) {
  if (frames < 1 || h < 1 || w < 1 || scale < 1 || tile_w < 1 ||
      reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0 ||
      reinterpret_cast<std::uintptr_t>(table) % 16 != 0 || (table != nullptr && n_pieces < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Taps taps{};
  int halo = 0;
  if (table == nullptr) {
    const int* yx = static_cast<const int*>(taps_yx);
    halo = tap_halo(yx, n_taps);
    if (halo < 0 || !build_runs(yx, n_taps, scale, tile_w + 2 * halo, &taps)) return (int)cudaErrorInvalidValue;
  }
  const Geometry geo{scale, tile_w, tile_h, rows, row_groups, frame_chunks, tap_groups,
                     n_pieces, max_sites, max_runs, static_cast<const int*>(table)};
  const float* a = static_cast<const float*>(warped);
  const float* r = static_cast<const float*>(residual);
  const float* c = static_cast<const float*>(certainty);
  const float* o = static_cast<const float*>(omega);
  float* outs = static_cast<float*>(out);
  float* p = static_cast<float*>(parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch_general<0>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, p, st);
    case 1: return launch_general<1>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, p, st);
    case 2: return launch_general<2>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, p, st);
    case 3: return launch_general<3>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, p, st);
    case 4: return launch_general<4>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
