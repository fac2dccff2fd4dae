// RAW plane-domain merges for Hopper (sm_90a) in four forms: the order-1
// certless plugin branch (form 0, merge_raw_kernel, described first), the
// order-0 merge (form 1: the same kernel without its centroid chains), the
// exact solve's 9 order-1 moments (form 2, merge_raw_cells_kernel,
// described after them) and the per-cell plugin moments (form 3: that
// kernel with 4 slots). These templated kernels take scales 1-4, Bayer
// patterns and taps within +-4; their general form (the S = 0
// instantiations, described after them) takes every form and knob at any
// scale, tap list and frame count on Bayer patterns; the non-Bayer kernel
// (merge_raw_nonbayer_kernel, described last) takes any other 2 x 2
// pattern, and the Bayer merges whose taps no general block fits. A guided merge (R/B as colour differences) runs any form on
// difference planes that the wrapper forms beforehand
// (kernels/merge_raw.py), which also chooses between the kernels.
//
// Replaces: the JAX package computes this accumulate outside Pallas
// (multi_frame_super_resolution_tpu/models/fast_merge.py::
// merge_burst_raw_planes with order=1, moment_slots=4,
// centroid_cert=False, phase_output=True; fast_merge.py:301-511 and the
// certless branch of _merge_planes_order1). It has the skeleton of the
// TPU kernel pallas_ops/merge.py::merge_fast_pallas: a static tap loop
// over F frames with the accumulators kept on chip. The plain PyTorch
// version is multi_frame_super_resolution_tpu_torch/models/fast_merge.py::
// merge_burst_raw_planes.
//
// Inputs, all contiguous float32: planes (F, 2, 2, hh, hw) warped CFA
// planes; residual (F, hh, hw, 2) in RAW units, clipped to +-rb here;
// certainty (F, hh, hw, 3); omega and omega_rb (hh, hw, 3), the inverse
// kernel covariances of green and R/B. For each half-res pixel (i, j),
// output parity (a, b), tap (ky, kx) and phase (py, px):
//
//   u = (ky - ry_f) * s,  v = (kx - rx_f) * s                 per frame f
//   dy = u - phi[py] * s, dx = v - phi[px] * s
//   w_g  = exp(-1/2 (dx^2 Og_xx + dy^2 Og_yy + 2 dx dy Og_xy))
//   w_rb = the same with omega_rb
//   cell (a, b, ch): the tap reads plane (qa, qb) = ((a+ky)%2, (b+kx)%2)
//     of channel ch = cfa[qa][qb] at (i + (a+ky)//2, j + (b+kx)//2),
//     edge-clamped; m00 += sum_f w*c, b0 += sum_f w*c*v, w = w_g for
//     green, w_rb for R/B
//   certless centroid chains, keyed by tap parity: ("g", (ky+kx)%2) with
//     w_g and ("rb", ky%2, kx%2) with w_rb accumulate sum_f w,
//     s*((ky - phi[py]) sum_f w - sum_f ry*w) and the same in x
//
// and finally cy = clip(m01 / sum w, +-2), cx likewise (0 where
// sum w <= 1e-8), each cell reading the chain of its channel. Outputs
// m00, cy, cx, b0 are (2s, 2s, 3, hh, hw), phase index (a*s+py, b*s+px).
//
// Bound, at chip_smoke.py's check (F=5, 128 x 256 half-res, 21 taps):
// 6.7 MB read (planes 2.6, residual 1.3, certainty 2.0, two omegas 0.8)
// and 25.2 MB written (4 moments x 48 values x 32,768 pixels) are 9.5 us
// at 3.35 TB/s; the 13.8 M (pixel, frame, tap, phase) items at 38.5
// flops and 2 exp each (chip_smoke.py's WORK table) are 0.53 GFLOP
// (7.9 us at 67 TFLOP/s f32) and 27.5 M exp (6.6 us on the SFUs). The
// bytes bind.
//
// Design:
// - One thread per (half-res pixel, phase row py), holding both x phases:
//   each Gaussian pair w_g, w_rb is evaluated once per (pixel, frame,
//   tap, phase), 27.5 M exp, and shared by the four output parities, and
//   a thread's two phases share the frame's residual, dy and the four
//   staged reads. (The first version ran a thread per (pixel, parity)
//   and evaluated every pair four times: 110 M exp, 131 registers,
//   0.18 ms.)
// - The host sorts the taps into the four tap-parity groups
//   g = 2*(ky%2) + (kx%2). Within a group each parity reads one fixed
//   plane and the taps feed one green chain ((ky+kx)%2) and one R/B
//   chain (ky%2, kx%2). The groups run in two pairs, {0, 3} and {1, 2}:
//   on a Bayer pattern the two groups of a pair read, for every parity,
//   two diagonally opposite planes (both green, or R and B), and the
//   pair's green chain and its two R/B chains are fed by it alone. So an
//   R or B cell is complete after its group and a green cell after its
//   pair; each is stored then, which spreads the stores and bounds the
//   live accumulators by one pair's. The green planes' place
//   (kGreenDiag) is a template parameter, so each read's weight family
//   is known at compile time; R and B may swap.
// - Per tap the frame sum is formed first and then added (the JAX
//   order). What differs from the plain version is rounding: the taps of
//   a green cell's two groups are summed group by group, the exponent is
//   evaluated as 2^(dx (dx o0 + dy o2) + dy^2 o1) with -1/2 log2(e) in
//   omega, by ex2.approx, and a site's value is staged as value *
//   certainty. Max abs error 1.4e-6 at the check, inside rtol/atol 1e-5
//   at every shape of tests/test_torch_cuda.py.
// - A block is 32 x 4 pixels x 2 phase rows (256 threads). It stages,
//   for every frame, its tile plus the tap halo (1 or 2 sites,
//   edge-clamped like the plain version's padding) in shared memory with
//   cp.async: one (value * certainty, certainty of the site's channel)
//   float2 per RAW site, so a parity's read is one 64-bit load at a
//   plain 2-D offset, and the clipped residual of its own pixels. The
//   tap loop runs over the frames innermost, so every frame is resident
//   at once (there is nothing to double-buffer across frames); 7.4 KB a
//   frame at halo 1 (30 frames fit), 10 KB at halo 2 (22). Omega and
//   omega_rb stay in registers.
// - Longer bursts (the float32 forms past the frame cap) run
//   merge_raw_stream_kernel: the same tap loop (add_group_taps) and
//   rounding, the frames streamed through two shared-memory slots of
//   `chunk` frames (stream_chunk: the most that leave room for two blocks
//   an SM, e.g. 16 at S = 2, halo 1), the next chunk's cp.async copies in
//   flight while a chunk accumulates, one barrier a chunk. A thread keeps
//   one tap group's cells and chains (28 sums at S = 2, against a pair's
//   50, which spilled 180-260 bytes at 128 registers), so the frames
//   stream once and a pair's green cells add its second group's sums,
//   passed through shared memory, to its first's at the end; at S = 4,
//   where four threads for each of Layout<4>'s eight would not fit two
//   blocks an SM, a block holds 16 pixels and half the phases (grid z the
//   other half). The order 0 at S = 4 has no chains to spill and keeps a
//   tap-group pair a thread, as merge_raw_kernel does, streaming the
//   frames once a pair (the split form took it 11% longer). A tap's frame
//   sum rounds chunk by chunk. A kernel of its own: one loop for every
//   length cost the resident case 128 registers, spills and 7% at S=2
//   (PERF.md). The bfloat16 order 0 past the cap runs the general form.
// - Stores: each warp writes 32 consecutive pixels of one output plane,
//   in the (4, 4, 3, hh, hw) layout the solve reads.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 122-126
//   registers, no spills, 2 blocks an SM; 0.032 ms against 0.18 ms for
//   the first version, ~29% of the bound. The staging at the start and
//   the output stores, which all blocks of the one wave issue at the
//   same points, are not hidden behind the tap loop.
//
// Scales: the scale S is a template parameter. A thread holds one phase
// row and kPX of its S phase columns (Layout<S>), so its accumulators
// are those of S = 2's thread at kPX = 2 and half of them at kPX = 1:
// - S = 1: kPX = 1, 32 x 4 pixels a block (128 threads);
// - S = 2: kPX = 2, 32 x 4 pixels x 2 phase rows (256 threads), the
//   layout above, unchanged;
// - S = 3: kPX = 1 (three columns would need ~170 registers), 32 x 1
//   pixels x 9 phases (288 threads);
// - S = 4: kPX = 2, 32 x 1 pixels x 16 phases in 8 threads (256).
// Rows of one pixel at S >= 3 keep the block at ~256 threads; its staged
// halo then costs 3-5 staged rows for one row of pixels. Measured
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 87, 122-126, 90-91
// and 126 registers at S = 1-4, no spills; times against their bounds in
// PERF.md.
//
// Form 1 replaces the JAX function's order-0 branch (fast_merge.py:
// 433-501, reached from handheld.py:891-899): num = sum w c v and den =
// sum w c per cell, which are form 0's b0 and m00. So it is form 0's
// kernel (kChains false): the same loop, layout, staging and rounding,
// without the centroid chains, storing den and num. Its bound at
// chip_smoke.py's check (S=2): 12.6 MB written and 6.7 MB read, 5.8 us at
// 3.35 TB/s, against 27.5 M exp (6.6 us on the SFUs). Measured
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 72, 96, 80 and 108
// registers at S = 1-4, no spills.
//
// The bfloat16 order 0 (form 1 with kBf16Flag, RAW_ORDER0_BF16) rounds
// as the jitted JAX function does (fast_merge.py:365-374, :445-474): w in
// f32 rounded to bfloat16; the frame sums of w c and of bf16(w c) v in
// f32 (both products exact there); each tap's sums rounded and added to
// its cell in bfloat16, each cell's taps in the list's order. A cell is
// fed by one tap-group pair, so the host lists each pair's taps in the
// list's order (TapTable::order) and the kernel runs the pairs in turn:
// every parity's weight family and a green parity's cell are then
// compile-time, an R/B parity's cell is the tap's group in the pair
// (ky % 2), chosen once a tap, and the (b0, m00) accumulators are a
// pair's six cells, __nv_bfloat162 each. Per (frame, tap) the weights
// round two to a cvt.rn.bf16x2.f32 (the two x phases at kPX = 2, w_g with
// w_rb at kPX = 1) and bf16(w c) is one mul.rn.bf16x2 for two phases (or
// two parities); w c enters the den's sum as an FMA, exact. At S = 1 a
// thread holds one pair (kPairThreads), doubling that grid's warps.
// Measured (tools/ab_main_kernels.py; NVIDIA H100 80GB HBM3, 700.00 W):
// S=2 0.0309 ms (25.6% of its 7.9 us bound; the first design, a tap at a
// time in the list's order with every rounding a cvt of its own, 0.0554),
// S=4, F=9 0.177 (30.0% of 53.2 us; 0.331), S=1 0.0091 (0.0126), S=3
// 0.088 (0.130); 68-91 registers, no spills. The frame loop issues 37
// instructions an item at S=2 (cuobjdump).
//
// Form 2 (merge_raw_cells_kernel) replaces the order-1 branch with
// moment_slots=9 (_merge_planes_order1 with certless False,
// fast_merge.py:513-913, the exact 3x3 solve). For each half-res pixel
// (i, j), output parity (a, b), phase (py, px), tap and frame, with the
// cell (a, b, ch) as above:
//
//   w = w_g or w_rb of the block-centre residual, as above
//   rho_y = clip((1 - g) ry(i, j) + g ry(i + sgn, j), +-rb) + phi[py]
//     with g = |a + phi[py] - 0.5| / 2 and sgn its sign (the residual
//     interpolated at the phase row's place in its Bayer block), rho_x
//     likewise along x with b and px;
//   dy = s (ky - rho_y), dx = s (kx - rho_x);
//   m00 += sum_f w c, m01 += sum_f dy w c, m02 += dx w c,
//   m11 += dy^2 w c, m12 += dy dx w c, m22 += dx^2 w c,
//   b0 += sum_f w c v, b1 += dy w c v, b2 += dx w c v
//
// Outputs are nine (2s, 2s, 3, hh, hw) arrays.
//
// Bound, at chip_smoke.py's check (F=5, 128 x 256 half-res, 21 taps,
// S=2): 56.6 MB written and 6.7 MB read (18.9 us at 3.35 TB/s), against
// 13.8 M (pixel, frame, tap, phase) items at 88 flops and 2 exp
// (chip_smoke.py's WORK table: 18.1 us): the bytes bind, just.
//
// Form 3 (merge_raw_cells_kernel with kSlots = 4) replaces the order-1
// branch with moment_slots=4 and centroid_cert=True (_merge_planes_order1's
// per-cell compact-rho branch, fast_merge.py:767-795): m00, m01 = s (ky
// sum_f w c - sum_f rho_y w c), m02 likewise in x, and b0, which are the
// 9-moment form's slots 0, 1, 2 and 6 (sum_f dy w c = s (ky sum_f w c -
// sum_f rho_y w c)). Its bound at chip_smoke.py's check (S=2): 25.2 MB
// written and 6.7 MB read, 9.5 us at 3.35 TB/s, against 13.8 M items at
// 48 flops and 2 exp (WORK, 9.9 us): the operations bind, just.
//
// Design of merge_raw_cells_kernel (forms 2 and 3):
// - Work split. A tap of group g feeds, for each parity z, the cell
//   (z, channel of plane z ^ g). The two groups of a pair {0, 3} or
//   {1, 2} read diagonally opposite planes, so for two parities both
//   read green (one cell) and for the other two one reads R, the other B:
//   each of the 12 cells (4 parities x 3 channels) of a (pixel, phase) is
//   fed by one pair alone, six cells a pair. A thread holds one (pixel,
//   output phase) and one pair (form 2: 54 accumulators, two threads a
//   pixel and phase) or both (form 3: 48; at S = 3 one pair, below).
//   Parities are relabelled z' = z ^ flip, flip = pair ^ !green_diag
//   (flip swaps b), so that z' = 0 and 3 are a pair's green cells and the
//   register indices are compile-time for either Bayer diagonal.
// - Weights. Each Gaussian pair w_g, w_rb of a (pixel, frame, tap, phase)
//   is evaluated once, by the thread that holds the tap's pair, and feeds
//   all four parities: 2 exp an item (the first version: 4, a thread
//   per parity evaluating its own), 2^(dx (dx o0 + dy o2) + dy^2 o1)
//   by ex2.approx as in form 0. Per parity 18 flops for the 9 moments
//   (dy w c and dx w c shared by the products), 8 for the 4.
// - Tile. A block owns a kTW x kTH pixel tile (CellTile) and every
//   (a, b, py, px) of it: 32 x 4, 16 x 2, 32 x 1 and 8 x 1 pixels at S =
//   1-4 for form 2 (256 threads; 576 at S = 3), 32 x 4, 16 x 4 and 8 x 2
//   for form 3 (128, 256, 256 threads; S = 3 runs form 2's layout: 9 warps
//   of 128 registers would leave a block alone on an SM). A warp holds
//   kTW pixels of a row at 32 / kTW phases of one pair, so its reads of a
//   staged site are shared by its phases (one shared-memory wavefront
//   where a warp of 32 pixels takes two) and its stores are rows of kTW
//   consecutive pixels of an output plane.
// - Frames stream through a ring of three shared-memory slots: frame f
//   is read while f + 1 and f + 2 are in flight (cp.async, one commit
//   group a frame, one barrier a frame), so any number of frames runs and
//   the copies overlap the taps. A slot holds, edge-clamped like the plain
//   version's padding, the tile plus the taps' halo of each plane as
//   (value, certainty of the plane's channel) float2s, copied as two
//   4-byte cp.async each (certainty is interleaved by 3: no wider copy
//   lines up; a parity's read is one 8-byte load), and the residual with
//   a one-site halo (8-byte copies; the displacements read the
//   neighbouring block's). A thread stages the same sites every frame, so
//   their clamped indices are computed once. Staged bytes against the
//   input bytes (planes, residual, certainty, omegas) at chip_smoke.py's
//   shape, halo 1: S=2, F=5 14.7 MB (form 2) and 11.1 MB (form 3) against
//   6.7 MB, 2.2x and 1.7x; S=4, F=9 44.2 and 29.5 MB against 11.4 MB,
//   3.9x and 2.6x (the first version staged each tile once per output
//   phase row: 55.7 MB, 8.3x, and 301 MB, 26x).
// - Taps. A block builds its tap table in shared memory: per relabelling,
//   each tap's S ky, S kx and the staged site z' = 0 reads; within a
//   group ky and kx keep their parities, so the other parities' sites
//   sit at fixed offsets from it, four numbers a group. A tap costs one
//   table load and four value loads.
// - Rounding: frames are summed in order, a frame's taps group by group,
//   a green cell's two groups into one sum (the plain version sums each
//   tap's frames first); max abs error 6.7e-6 and 2.3e-5 (form 2, S=2
//   and S=4, F=9), 2.4e-6 and 3.8e-6 (form 3) against ORDER1_TOL's 1e-4
//   (chip_smoke.py).
// - Balance: at the check's 21 taps form 2's pairs hold 9 and 12, so the
//   {0, 3} warps wait at each frame's barrier; a thread holding both
//   pairs would need 108 accumulators.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): ptxas
//   111, 115, 96 and 115 registers at S = 1-4 for form 2 (16 bytes
//   spilled at S = 3, where 18 warps leave 96 a thread), 126, 126, 86 and
//   126 for form 3, no other spills. Form 2 0.064-0.065 ms at S=2 (29% of
//   18.9 us) and 0.407-0.410 ms at S=4, F=9 (30% of 124.2 us); form 3
//   0.039 ms (25% of 9.9 us) and 0.250 ms (26% of 65.1 us); the first
//   version in the same call 0.138-0.140, 0.850-0.856, 0.111-0.113 and
//   0.663-0.674 ms. Device time follows the items (4.1-4.7 ps an item
//   for form 2, 2.5-2.9 for form 3): the taps, not the staging, set it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <type_traits>
#include <vector>

namespace {

constexpr int kMaxTaps = 81;     // the templated forms' taps: within +-4
constexpr int kMaxSmem = 232448;  // shared memory a block can opt in to (sm_90)
constexpr int kTileW = 32;       // half-res columns of a block (one warp)

// The thread layout at scale S: a thread per (half-res pixel, phase row,
// group of kPX phase columns), kTileH pixel rows a block.
template <int S>
struct Layout;
template <>
struct Layout<1> {
  static constexpr int kPX = 1, kTileH = 4, kMinBlocks = 4;
};
template <>
struct Layout<2> {
  static constexpr int kPX = 2, kTileH = 4, kMinBlocks = 2;
};
template <>
struct Layout<3> {
  static constexpr int kPX = 1, kTileH = 1, kMinBlocks = 2;
};
template <>
struct Layout<4> {
  static constexpr int kPX = 2, kTileH = 1, kMinBlocks = 2;
};
// S = 0: the general form, the scale at run time: a thread per (pixel,
// phase), tw x th pixels (blockDim.x, blockDim.y) x a group of phases
// (blockDim.z; grid z over the groups), at most 512 threads
template <>
struct Layout<0> {
  static constexpr int kPX = 1, kTileH = 0, kMinBlocks = 1;
};

template <int S>
struct Shape {
  static constexpr int kPX = Layout<S>::kPX;
  static constexpr int kTileH = Layout<S>::kTileH;
  static constexpr int kTW = S ? kTileW : 0;            // columns a block (S = 0: blockDim.x)
  static constexpr int kCols = S ? S / kPX : 1;         // threads a phase row
  static constexpr int kZ = S * kCols;                  // threads a pixel
  static constexpr int kPix = kTW * kTileH;             // pixels a block
  static constexpr int kThreads = S ? kPix * kZ : 512;
};

// The general form's run-time shape (S = 0): the scale, the staged halo,
// the phases of a block (grid z: phase groups) and the tap rows on the
// card (the host table's, (ky, kx, aux) a row, copied to shared memory).
struct General {
  int s, halo, phases;
  const int* rows;
};

// The general form's block, chosen by the host (kernels/merge_raw.py::
// general_block, which sizes the shared bytes of the layouts here): tw x
// th pixels x `phases` phases, grid z over `groups` of phases (the cells
// forms: x 2, one tap-group pair a block), `chunk` frames staged at once
// (forms 0 and 1) and the block's dynamic shared bytes.
struct Block {
  int tw, th, phases, groups, chunk, bytes;
};

struct TapTable {
  int group_end[4];  // group g holds taps [group_end[g-1], group_end[g])
  int chan[4];       // channel of plane q = 2*qa + qb
  signed char ky[kMaxTaps];
  signed char kx[kMaxTaps];
  int centroid_end[4];  // group g's taps before centroid_end[g] feed the centroid (centroid_prune)
  // the bfloat16 order 0's tap order: the sorted index of each tap of the
  // pair {0, 3} in the list's order, then of each tap of {1, 2}
  unsigned char order[kMaxTaps];
};

// The variant bits of a launch (mfsr_merge_raw's flags).
constexpr int kExactWeights = 1;  // forms 2, 3: weights at the moments' displacement
constexpr int kBf16Flag = 2;      // form 1: bfloat16 order 0; form 3: bfloat16 centroid products
constexpr int kBlockFlag = 4;     // form 3: the block-centre centroid
constexpr int kSharedFlag = 8;    // form 3: the shared-residual centroid (block implied)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22; subnormal results
// flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the plane parity z = 2a + b reads in tap group g
__host__ __device__ constexpr int plane_of(int z, int g) {
  return 2 * (((z >> 1) + (g >> 1)) & 1) + (((z & 1) + (g & 1)) & 1);
}

template <bool kGreenDiag>
__device__ constexpr bool is_green(int q) {
  return kGreenDiag ? (q == 0 || q == 3) : (q == 1 || q == 2);
}

// Writes cell (parity z, channel c) of phase (py, px): the weight sum m,
// the value sum b and, with the chains, the finalized centroid n / w of
// its chain.
template <int S, bool kChains>
__device__ __forceinline__ void store_cell(float* __restrict__ m00_out,
                                           float* __restrict__ cy_out,
                                           float* __restrict__ cx_out,
                                           float* __restrict__ b0_out, long long plane,
                                           long long out_pix, int z, int py, int px, int c,
                                           float m, float b, float w, float n1, float n2, int s_rt = 0) {
  const int sc = S ? S : s_rt;  // S = 0: the general form's run-time scale
  const int row = (z >> 1) * sc + py, col = (z & 1) * sc + px;
  const long long o = (((long long)row * 2 * sc + col) * 3 + c) * plane + out_pix;
  m00_out[o] = m;
  b0_out[o] = b;
  if constexpr (kChains) {
    const float inv = w > 1e-8f ? 1.0f / fmaxf(w, 1e-8f) : 0.0f;
    cy_out[o] = fminf(fmaxf(n1 * inv, -2.0f), 2.0f);
    cx_out[o] = fminf(fmaxf(n2 * inv, -2.0f), 2.0f);
  }
}

// The accumulator slot of plane q for a parity in the bfloat16 order-0
// loop: 0 green, 1 and 2 the R/B planes in plane order.
template <bool kGreenDiag>
__device__ __forceinline__ int rb_slot(int q) {
  return is_green<kGreenDiag>(q) ? 0 : (kGreenDiag ? q : (q == 0 ? 1 : 2));
}

// bfloat16 pairs in a 32-bit register: (hi, lo) rounded to nearest even
// by one cvt, their product rounded once (mul.rn.bf16x2: bf16(a b) per
// lane, as the product of two bfloat16 values is exact in f32 and then
// rounded), and each half back to float32
__device__ __forceinline__ unsigned bf16x2_pack(float hi, float lo) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ unsigned bf16x2_mul(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ float bf16x2_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16x2_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }
// two bfloat16-valued floats (low 16 bits zero) as one pair (hi, lo)
__device__ __forceinline__ unsigned bf16x2_of(float hi, float lo) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Adds the taps of group g (slot k of its pair) over the nf staged frames
// to the thread's accumulators: per tap the frame sums first (the JAX
// order), then added to m00 and b0 and, with the chains, to the pair's
// green chain (0) and the group's R/B chain (1 + k). The resident and the
// streamed forms of merge_raw_kernel share it.
// A tap row of the general form's table in shared memory: ky in the high
// 16 bits, kx in the low.
__device__ __forceinline__ int2 unpack_tap(int r) { return make_int2(r >> 16, (int)(short)(r & 0xffff)); }

// exp(-1/2 q), q = (dx^2 o.x + dy2 o.y) + 2 dx dy o.z, dy2 = dy^2: q in the
// plain version's products and sums, each rounded where it rounds them,
// then 2^(q * -1/2 log2(e)) by ex2.approx (chip_smoke.py's S = 5 check,
// 128 x 256, NVIDIA H100 80GB HBM3, 700.00 W: 3.3e-6 from the plain
// version's centroids, against 1.28e-5 with the templated exponent and
// 2.0e-6 with expf, which cost the form 17% more time)
__device__ __forceinline__ float gauss_plain(float dx, float dy, float dy2, float3 o) {
  const float q = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(dx, dx), o.x), __fmul_rn(dy2, o.y)),
                            __fmul_rn(__fmul_rn(__fmul_rn(2.0f, dx), dy), o.z));
  return exp2_approx(__fmul_rn(q, -0.72134752044448170368f));
}

// The general form (S = 0) passes its run-time staged row length sw_rt,
// plane sites sa_rt, pixels a block pix_rt, scale s_rt and the tap rows
// s_rows; the templated forms' are compile-time. With the chains it also
// passes the two inverse covariances as read (om_g, om_rb): its weights'
// quadratic and its chain sums take the plain version's roundings
// (gauss_plain, no contracted products), since a centroid divides chain
// sums that cancel and their rounding grows with S (S = 5: 1.1-1.3e-5
// from the plain version at 4 of 9.8 M values with the templated
// arithmetic).
template <int S, int kHalo, bool kGreenDiag, bool kChains, int kPX, int kTileHt = Shape<S>::kTileH,
          int kTWt = kTileW>
__device__ __forceinline__ void add_group_taps(
    const TapTable& taps, int g, int k, int nf, const float2* my_res, const float2* my_sv,
    float phi_y, float phis_y, const float (&phi_x)[kPX], float og0, float og1, float og2,
    float or0, float or1, float or2, float (&m00)[4][2][kPX], float (&b0)[4][2][kPX],
    float (&cw)[3][kPX], float (&c1)[3][kPX], float (&c2)[3][kPX],
    int sw_rt = 0, int sa_rt = 0, int pix_rt = 0, int s_rt = 0, const int* s_rows = nullptr,
    float3 om_g = float3{}, float3 om_rb = float3{}) {
  constexpr bool kPlainChains = S == 0 && kChains;
  constexpr int kSWc = kTWt + 2 * kHalo;
  constexpr int kSAc = (kTileHt + 2 * kHalo) * kSWc;
  const int kSW = S ? kSWc : sw_rt;
  const int kSA = S ? kSAc : sa_rt;
  const int kPix = S ? kTWt * kTileHt : pix_rt;
  const float sf = S ? (float)S : (float)s_rt;
  for (int t = g ? taps.group_end[g - 1] : 0; t < taps.group_end[g]; ++t) {
    int kyi, kxi;
    if constexpr (S != 0) {
      kyi = taps.ky[t];
      kxi = taps.kx[t];
    } else {
      const int2 kk = unpack_tap(s_rows[t]);
      kyi = kk.x;
      kxi = kk.y;
    }
    const float ky = (float)kyi, kx = (float)kxi;
    int off[4];
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      off[z] = plane_of(z, g) * kSA + (((z >> 1) + kyi) >> 1) * kSW + (((z & 1) + kxi) >> 1);
    }
    float sm[4][kPX], sb[4][kPX];
    float sw_g[kPX], sry_g[kPX], srx_g[kPX], sw_r[kPX], sry_r[kPX], srx_r[kPX];
#pragma unroll
    for (int px = 0; px < kPX; ++px) {
#pragma unroll
      for (int z = 0; z < 4; ++z) sm[z][px] = sb[z][px] = 0.0f;
      sw_g[px] = sry_g[px] = srx_g[px] = sw_r[px] = sry_r[px] = srx_r[px] = 0.0f;
    }
#pragma unroll 2
    for (int f = 0; f < nf; ++f) {
      const float2 res = my_res[f * kPix];
      float wg[kPX], wr[kPX];
      if constexpr (kPlainChains) {
#pragma unroll
        for (int px = 0; px < kPX; ++px) {
          const float dy = __fsub_rn(__fmul_rn(ky - res.x, sf), phis_y);
          const float dx = __fsub_rn(__fmul_rn(kx - res.y, sf), __fmul_rn(phi_x[px], sf));
          const float dy2 = __fmul_rn(dy, dy);
          wg[px] = gauss_plain(dx, dy, dy2, om_g);
          wr[px] = gauss_plain(dx, dy, dy2, om_rb);
          sw_g[px] += wg[px];
          sry_g[px] = __fadd_rn(sry_g[px], __fmul_rn(res.x, wg[px]));
          srx_g[px] = __fadd_rn(srx_g[px], __fmul_rn(res.y, wg[px]));
          sw_r[px] += wr[px];
          sry_r[px] = __fadd_rn(sry_r[px], __fmul_rn(res.x, wr[px]));
          srx_r[px] = __fadd_rn(srx_r[px], __fmul_rn(res.y, wr[px]));
        }
      } else {
      const float dy = (ky - res.x) * sf - phis_y;
      const float dyy = dy * dy;
      const float gy = dy * og2, gyy = dyy * og1, rby = dy * or2, rbyy = dyy * or1;
#pragma unroll
      for (int px = 0; px < kPX; ++px) {
        const float dx = (kx - res.y) * sf - phi_x[px] * sf;
        wg[px] = exp2_approx(fmaf(dx, fmaf(dx, og0, gy), gyy));
        wr[px] = exp2_approx(fmaf(dx, fmaf(dx, or0, rby), rbyy));
        if constexpr (kChains) {
          sw_g[px] += wg[px];
          sry_g[px] += res.x * wg[px];
          srx_g[px] += res.y * wg[px];
          sw_r[px] += wr[px];
          sry_r[px] += res.x * wr[px];
          srx_r[px] += res.y * wr[px];
        }
      }
      }
      const float2* fsv = my_sv + f * 4 * kSA;
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const float2 vc = fsv[off[z]];  // (value * certainty, certainty)
        const bool green = is_green<kGreenDiag>(plane_of(z, g));
#pragma unroll
        for (int px = 0; px < kPX; ++px) {
          const float w = green ? wg[px] : wr[px];
          sm[z][px] = fmaf(w, vc.y, sm[z][px]);
          sb[z][px] = fmaf(w, vc.x, sb[z][px]);
        }
      }
    }
#pragma unroll
    for (int px = 0; px < kPX; ++px) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        m00[z][k][px] += sm[z][px];
        b0[z][k][px] += sb[z][px];
      }
      if constexpr (kPlainChains) {
        cw[0][px] += sw_g[px];
        c1[0][px] += __fmul_rn(sf, __fsub_rn(__fmul_rn(ky - phi_y, sw_g[px]), sry_g[px]));
        c2[0][px] += __fmul_rn(sf, __fsub_rn(__fmul_rn(kx - phi_x[px], sw_g[px]), srx_g[px]));
        cw[1 + k][px] += sw_r[px];
        c1[1 + k][px] += __fmul_rn(sf, __fsub_rn(__fmul_rn(ky - phi_y, sw_r[px]), sry_r[px]));
        c2[1 + k][px] += __fmul_rn(sf, __fsub_rn(__fmul_rn(kx - phi_x[px], sw_r[px]), srx_r[px]));
      } else if constexpr (kChains) {
        cw[0][px] += sw_g[px];
        c1[0][px] += sf * ((ky - phi_y) * sw_g[px] - sry_g[px]);
        c2[0][px] += sf * ((kx - phi_x[px]) * sw_g[px] - srx_g[px]);
        cw[1 + k][px] += sw_r[px];
        c1[1 + k][px] += sf * ((ky - phi_y) * sw_r[px] - sry_r[px]);
        c2[1 + k][px] += sf * ((kx - phi_x[px]) * sw_r[px] - srx_r[px]);
      }
    }
  }
}

// kChains: form 0 (the certless centroid chains); without them form 1,
// in float32 or (kBf16) in bfloat16. The templated scales (S = 1-4) stage
// every frame at once (bursts past that run merge_raw_stream_kernel,
// below). S = 0 (the general form, kHalo 0): the scale, halo, phases and
// tap rows of `gen` at run time, the tile blockDim.x x blockDim.y pixels,
// the frames in chunks of `chunk` (the most that fit shared memory at
// once), each staged in turn for each tap-group pair (the bfloat16 order
// 0: for each pass of kPass taps), so any number of frames runs; one
// chunk is staged once.
// The bfloat16 order 0's threads a (pixel, phase thread) at S = 1: one a
// tap-group pair (its cells are the pair's alone), so that the S = 1 grid,
// a thread a pixel, holds twice the warps; else 1, both pairs a thread
template <int S, bool kBf16>
constexpr int kPairThreads = kBf16 && S == 1 ? 2 : 1;

template <int S, int kHalo, bool kGreenDiag, bool kChains, bool kBf16>
__global__ void __launch_bounds__(Shape<S>::kThreads * kPairThreads<S, kBf16>,
                                  kPairThreads<S, kBf16> == 2 ? 2 : Layout<S>::kMinBlocks)
merge_raw_kernel(const float* __restrict__ planes,
                 const float* __restrict__ residual,
                 const float* __restrict__ certainty,
                 const float* __restrict__ omega,
                 const float* __restrict__ omega_rb,
                 float* __restrict__ m00_out, float* __restrict__ cy_out,
                 float* __restrict__ cx_out, float* __restrict__ b0_out,
                 int frames, int hh, int hw, float rb, const TapTable taps, int chunk,
                 const General gen) {
  using L = Shape<S>;
  constexpr bool kGeneral = S == 0;
  constexpr int kPX = L::kPX;
  const int kTW = kGeneral ? (int)blockDim.x : L::kTW;
  static_assert(!kGeneral || kHalo == 0, "the general form's halo is gen.halo");
  const int sc = kGeneral ? gen.s : S;
  const int halo = kGeneral ? gen.halo : kHalo;
  const int kTileH = kGeneral ? (int)blockDim.y : L::kTileH;
  const int kPix = kGeneral ? kTW * kTileH : L::kPix;
  constexpr int kPT = kPairThreads<S, kBf16>;
  const int kThreads = kGeneral ? kPix * (int)blockDim.z : L::kThreads * kPT;
  const int kSW = kTW + 2 * halo;                  // staged row length
  const int kSA = (kTileH + 2 * halo) * kSW;       // staged sites per plane
  const int staged = kGeneral ? chunk : frames;    // frames resident at once
  extern __shared__ float2 smem[];
  float2* sv = smem;                               // (F, 4, kSA): value, cert
  float2* sres = smem + (size_t)staged * 4 * kSA;  // (F, kPix): ry, rx
  // the general form's tap rows: by group (s_rows), and in list order
  // (s_list, the bfloat16 order 0's)
  int* s_rows = reinterpret_cast<int*>(sres + (size_t)staged * kPix);
  int* s_list = s_rows + taps.group_end[3];

  const int tx = threadIdx.x, ty = threadIdx.y, zz = threadIdx.z;
  // the thread's phase row and first phase column (the general form: its
  // phase, from grid z's group)
  const int ph = kGeneral ? blockIdx.z * gen.phases + zz : 0;
  const int zph = kPT == 2 ? zz % L::kZ : zz;  // the phase thread (kPT == 2: and zz / kZ the pair)
  const int py = kGeneral ? ph / sc : zph / L::kCols;
  const int px0 = kGeneral ? ph % sc : (zph % L::kCols) * kPX;
  const int tid = (zz * kTileH + ty) * kTW + tx;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTW;
  const long long plane = (long long)hh * hw;
  if constexpr (kGeneral) {
    for (int t = tid; t < taps.group_end[3]; t += kThreads) {
      const int ky = gen.rows[3 * t], kx = gen.rows[3 * t + 1], n = gen.rows[3 * t + 2] >> 1;
      s_rows[t] = s_list[n] = (ky << 16) | (kx & 0xffff);
    }
    __syncthreads();
  }

  // stages frames [f0, f0 + nf) into the first nf slots: the tile and
  // halo, edge-clamped, and the clipped residual; each site's value
  // becomes value * certainty (or, for bfloat16, both are rounded: w c
  // rounds before it meets the value)
  const auto stage = [&](int f0, int nf) {
    for (int e = tid; e < nf * 4 * kSA; e += kThreads) {
      const int site = e % kSA;
      const int fq = e / kSA;
      const int q = fq & 3;
      const int f = f0 + (fq >> 2);
      const int r = min(max(i0 - halo + site / kSW, 0), hh - 1);
      const int c = min(max(j0 - halo + site % kSW, 0), hw - 1);
      const long long rc = (long long)r * hw + c;
      cp_async4(&sv[e].x, planes + ((long long)f * 4 + q) * plane + rc);
      cp_async4(&sv[e].y, certainty + ((long long)f * plane + rc) * 3 + taps.chan[q]);
    }
    for (int e = tid; e < nf * kPix; e += kThreads) {
      const int p = e % kPix;
      const int f = f0 + e / kPix;
      const int r = min(i0 + p / kTW, hh - 1);
      const int c = min(j0 + p % kTW, hw - 1);
      cp_async8(&sres[e], residual + ((long long)f * plane + (long long)r * hw + c) * 2);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int e = tid; e < nf * kPix; e += kThreads) {
      sres[e] = make_float2(fminf(fmaxf(sres[e].x, -rb), rb), fminf(fmaxf(sres[e].y, -rb), rb));
    }
    for (int e = tid; e < nf * 4 * kSA; e += kThreads) {
      if constexpr (kBf16) {
        sv[e] = __bfloat1622float2(__float22bfloat162_rn(sv[e]));
      } else {
        sv[e].x *= sv[e].y;
      }
    }
    __syncthreads();
  };
  if constexpr (!kGeneral) stage(0, frames);  // every frame at once

  const int i = i0 + ty, j = j0 + tx;
  const bool inside = i < hh && j < hw && (!kGeneral || ph < sc * sc);
  const long long pix = (long long)min(i, hh - 1) * hw + min(j, hw - 1);
  const long long out_pix = (long long)i * hw + j;
  // phi[p] = (p + 0.5) / s - 0.5 in the f32 operations of
  // fast_merge._output_phase_offsets; phis = phi * s. The x phases are
  // the thread's kPX columns (constants where one thread holds a row).
  const float phi_y = ((float)py + 0.5f) / (float)sc - 0.5f;
  const float phis_y = phi_y * (float)sc;
  float phi_x[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) phi_x[p] = ((float)(px0 + p) + 0.5f) / (float)sc - 0.5f;
  // exp(q) = 2^(q log2 e): -1/2 log2(e) and the cross term's -log2(e)
  // folded into omega, so w = 2^(dx (dx o0 + dy o2) + dy^2 o1)
  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float og0 = -0.5f * kL * omega[pix * 3 + 0], og1 = -0.5f * kL * omega[pix * 3 + 1],
              og2 = -kL * omega[pix * 3 + 2];
  const float or0 = -0.5f * kL * omega_rb[pix * 3 + 0],
              or1 = -0.5f * kL * omega_rb[pix * 3 + 1], or2 = -kL * omega_rb[pix * 3 + 2];
  const float2* my_res = sres + ty * kTW + tx;
  const float2* my_sv = sv + (ty + halo) * kSW + (tx + halo);

  if constexpr (kBf16) {
    // bfloat16 order 0 in the jitted JAX function's rounding: the taps in
    // the list's order (each cell's sum rounds tap by tap); per tap and
    // parity w rounded to bfloat16; the frame sums in f32 of w c and of
    // bf16(w c) v, products exact in f32 (two bfloat16 factors), which is
    // how XLA forms a product that feeds a float32 sum; each sum rounded
    // to bfloat16 and added to its cell in bfloat16. A parity's cells are
    // its slots: green, and the two R/B planes'; (b0, m00) per slot and x
    // phase as one __nv_bfloat162.
    __nv_bfloat162 acc[4][3][kPX];
#pragma unroll
    for (int z = 0; z < 4; ++z)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int px = 0; px < kPX; ++px) acc[z][k][px] = __float2bfloat162_rn(0.0f);
    const int n_taps = taps.group_end[3];
    if constexpr (kGeneral) {
      // the general form's passes: tap (kyi, kxi)'s frame sums over the nf
      // staged frames, added to sm and sb, per parity and x phase (the
      // templated loop below, its frames inside each tap)
      const auto tap_frames = [&](int kyi, int kxi, int nf, float (&sm)[4][kPX], float (&sb)[4][kPX]) {
        const int g = 2 * (kyi & 1) + (kxi & 1);
        const float ky = (float)kyi, kx = (float)kxi;
        int off[4];
        bool green[4];
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          off[z] = plane_of(z, g) * kSA + (((z >> 1) + kyi) >> 1) * kSW + (((z & 1) + kxi) >> 1);
          green[z] = is_green<kGreenDiag>(plane_of(z, g));
        }
#pragma unroll 2
        for (int f = 0; f < nf; ++f) {
          const float2 res = my_res[f * kPix];
          const float dy = (ky - res.x) * (float)sc - phis_y;
          const float dyy = dy * dy;
          const float gy = dy * og2, gyy = dyy * og1, rby = dy * or2, rbyy = dyy * or1;
          float wg[kPX], wr[kPX];  // rounded to bfloat16
#pragma unroll
          for (int px = 0; px < kPX; ++px) {
            const float dx = (kx - res.y) * (float)sc - phi_x[px] * (float)sc;
            wg[px] = __bfloat162float(__float2bfloat16_rn(exp2_approx(fmaf(dx, fmaf(dx, og0, gy), gyy))));
            wr[px] = __bfloat162float(__float2bfloat16_rn(exp2_approx(fmaf(dx, fmaf(dx, or0, rby), rbyy))));
          }
          const float2* fsv = my_sv + f * 4 * kSA;
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const float2 vc = fsv[off[z]];  // (value, certainty), bfloat16 values
#pragma unroll
            for (int px = 0; px < kPX; ++px) {
              const float wc = (green[z] ? wg[px] : wr[px]) * vc.y;  // exact
              sm[z][px] += wc;
              sb[z][px] += __bfloat162float(__float2bfloat16_rn(wc)) * vc.x;  // exact product
            }
          }
        }
      };
      // a tap's sums rounded to bfloat16 and added to its cells
      const auto add_tap = [&](int kyi, int kxi, const float (&sm)[4][kPX], const float (&sb)[4][kPX]) {
        const int g = 2 * (kyi & 1) + (kxi & 1);
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int slot = rb_slot<kGreenDiag>(plane_of(z, g));
#pragma unroll
          for (int px = 0; px < kPX; ++px) {
            const __nv_bfloat162 sum = __floats2bfloat162_rn(sb[z][px], sm[z][px]);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (slot == k) acc[z][k][px] = __hadd2(acc[z][k][px], sum);
            }
          }
        }
      };
      // kPass taps at a time in the list's order, their frame sums kept
      // across the chunks (each chunk staged once a pass; one chunk once)
      constexpr int kPass = 4;
      const bool one_chunk = frames <= chunk;
      if (one_chunk) stage(0, frames);
#pragma unroll 1
      for (int n0 = 0; n0 < n_taps; n0 += kPass) {
        float sm[kPass][4][kPX], sb[kPass][4][kPX];
#pragma unroll
        for (int b = 0; b < kPass; ++b)
#pragma unroll
          for (int z = 0; z < 4; ++z) sm[b][z][0] = sb[b][z][0] = 0.0f;
#pragma unroll 1
        for (int f0 = 0; f0 < frames; f0 += chunk) {
          if (!one_chunk) {
            __syncthreads();
            stage(f0, min(chunk, frames - f0));
          }
#pragma unroll
          for (int b = 0; b < kPass; ++b) {
            if (n0 + b < n_taps) {
              const int2 kk = unpack_tap(s_list[n0 + b]);
              // the chunk's frames start at my_res / my_sv's frame 0
              tap_frames(kk.x, kk.y, min(chunk, frames - f0), sm[b], sb[b]);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kPass; ++b) {
          if (n0 + b < n_taps) {
            const int2 kk = unpack_tap(s_list[n0 + b]);
            add_tap(kk.x, kk.y, sm[b], sb[b]);
          }
        }
      }
    } else {
      // The templated scales: each tap-group pair's taps in the list's
      // order (taps.order: pair {0, 3}'s, then {1, 2}'s), which is each
      // cell's order, as a cell is fed by one pair. Within a pair every
      // parity's weight family is fixed (its two planes are both green or
      // both R/B), so it is known at compile time, as is the slot of a
      // green parity; an R/B parity's slot is the tap's group in the pair,
      // ky % 2, chosen once a tap. Per (frame, tap): the weights rounded to
      // bfloat16 two to a cvt (the two x phases at kPX = 2, w_g with w_rb
      // at kPX = 1), w c exact in f32 as an FMA into the den's sum, and
      // bf16(w c) as one mul.rn.bf16x2 of two parities' or phases' pairs.
      const int n_pair0 = taps.group_end[0] + taps.group_end[3] - taps.group_end[2];
      float phis_x[kPX];
#pragma unroll
      for (int p = 0; p < kPX; ++p) phis_x[p] = phi_x[p] * (float)S;
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        if (kPT == 2 && pair != zz / L::kZ) continue;  // the other pair's thread
        // green[z]: parity z reads green in this pair (plane_of(z, pair),
        // plane z ^ pair); at kPX = 1 the green parities e, 3 ^ e are coupled
        // with the R/B ones 1 ^ e, 2 ^ e
        const int e = pair ^ (kGreenDiag ? 0 : 1);
        bool green[4];
#pragma unroll
        for (int z = 0; z < 4; ++z) green[z] = z == e || z == (3 ^ e);
        // (b0, m00) per parity, slot (green: 0; R/B: the group k) and x phase
        __nv_bfloat162 cell[4][2][kPX];
#pragma unroll
        for (int z = 0; z < 4; ++z)
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int px = 0; px < kPX; ++px) cell[z][k][px] = __float2bfloat162_rn(0.0f);
#pragma unroll 1
        for (int n = pair ? n_pair0 : 0; n < (pair ? n_taps : n_pair0); ++n) {
          const int t = taps.order[n];
          const int kyi = taps.ky[t], kxi = taps.kx[t];
          const int k = kyi & 1;  // the tap's group in the pair: pair or 3 - pair
          const int g = pair ? 1 + k : 3 * k;
          const float ky = (float)kyi, kx = (float)kxi;
          int off[4];
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            off[z] = plane_of(z, g) * kSA + (((z >> 1) + kyi) >> 1) * kSW + (((z & 1) + kxi) >> 1);
          }
          float sm[4][kPX], sb[4][kPX];
#pragma unroll
          for (int z = 0; z < 4; ++z)
#pragma unroll
            for (int px = 0; px < kPX; ++px) sm[z][px] = sb[z][px] = 0.0f;
#pragma unroll 2
          for (int f = 0; f < frames; ++f) {
            const float2 res = my_res[f * kPix];
            const float dy = (ky - res.x) * (float)S - phis_y;
            const float dyy = dy * dy;
            const float gy = dy * og2, gyy = dyy * og1, rby = dy * or2, rbyy = dyy * or1;
            float eg[kPX], er[kPX];
#pragma unroll
            for (int px = 0; px < kPX; ++px) {
              const float dx = (kx - res.y) * (float)S - phis_x[px];
              eg[px] = exp2_approx(fmaf(dx, fmaf(dx, og0, gy), gyy));
              er[px] = exp2_approx(fmaf(dx, fmaf(dx, or0, rby), rbyy));
            }
            const float2* fsv = my_sv + f * 4 * kSA;
            float2 vc[4];  // (value, certainty), bfloat16 values
#pragma unroll
            for (int z = 0; z < 4; ++z) vc[z] = fsv[off[z]];
            if constexpr (kPX == 2) {
              const unsigned w2g = bf16x2_pack(eg[1], eg[0]), w2r = bf16x2_pack(er[1], er[0]);
#pragma unroll
              for (int z = 0; z < 4; ++z) {
                const unsigned w2 = green[z] ? w2g : w2r;
                sm[z][0] = fmaf(bf16x2_lo(w2), vc[z].y, sm[z][0]);  // exact products
                sm[z][1] = fmaf(bf16x2_hi(w2), vc[z].y, sm[z][1]);
                const unsigned wc2 = bf16x2_mul(w2, bf16x2_of(vc[z].y, vc[z].y));
                sb[z][0] = fmaf(bf16x2_lo(wc2), vc[z].x, sb[z][0]);
                sb[z][1] = fmaf(bf16x2_hi(wc2), vc[z].x, sb[z][1]);
              }
            } else {
              const unsigned w2 = bf16x2_pack(er[0], eg[0]);  // (w_rb, w_g)
              const float wg = bf16x2_lo(w2), wr = bf16x2_hi(w2);
#pragma unroll
              for (int z = 0; z < 4; ++z) sm[z][0] = fmaf(green[z] ? wg : wr, vc[z].y, sm[z][0]);
#pragma unroll
              for (int n2 = 0; n2 < 2; ++n2) {
                const int zg = n2 ? 3 ^ e : e, zr = n2 ? 2 ^ e : 1 ^ e;
                const unsigned wc2 = bf16x2_mul(w2, bf16x2_of(vc[zr].y, vc[zg].y));
                sb[zg][0] = fmaf(bf16x2_lo(wc2), vc[zg].x, sb[zg][0]);
                sb[zr][0] = fmaf(bf16x2_hi(wc2), vc[zr].x, sb[zr][0]);
              }
            }
          }
          // the tap's sums rounded and added to its cells in bfloat16
#pragma unroll
          for (int z = 0; z < 4; ++z) {
#pragma unroll
            for (int px = 0; px < kPX; ++px) {
              const __nv_bfloat162 sum = __floats2bfloat162_rn(sb[z][px], sm[z][px]);
              if (green[z] || k == 0) {
                cell[z][0][px] = __hadd2(cell[z][0][px], sum);
              } else {
                cell[z][1][px] = __hadd2(cell[z][1][px], sum);
              }
            }
          }
        }
        if (inside) {
#pragma unroll
          for (int z = 0; z < 4; ++z) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              if (green[z] && k == 1) continue;
              const int c = green[z] ? 1 : taps.chan[plane_of(z, pair ? 1 + k : 3 * k)];
#pragma unroll
              for (int px = 0; px < kPX; ++px) {
                store_cell<S, false>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px, c,
                                     __high2float(cell[z][k][px]), __low2float(cell[z][k][px]), 0.f, 0.f, 0.f);
              }
            }
          }
        }
      }
      return;
    }
    if (inside) {
#pragma unroll
      for (int z = 0; z < 4; ++z)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = k == 0 ? 1 : taps.chan[kGreenDiag ? k : (k == 1 ? 0 : 3)];
#pragma unroll
          for (int px = 0; px < kPX; ++px) {
            store_cell<S, false>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px, c,
                                 __high2float(acc[z][k][px]), __low2float(acc[z][k][px]), 0.f, 0.f, 0.f, sc);
          }
        }
    }
    return;
  }

#pragma unroll
  for (int pair = 0; pair < 2; ++pair) {
    // [parity z][group of the pair][x phase]
    float m00[4][2][kPX], b0[4][2][kPX];
    // [the pair's green chain, its groups' R/B chains][x phase]
    float cw[3][kPX], c1[3][kPX], c2[3][kPX];
#pragma unroll
    for (int px = 0; px < kPX; ++px) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        m00[z][0][px] = m00[z][1][px] = b0[z][0][px] = b0[z][1][px] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) cw[k][px] = c1[k][px] = c2[k][px] = 0.0f;
    }

    // stores the R and B cells that group k of the pair completed (the
    // parities that read R or B in it)
    const auto store_rb = [&](int k) {
      const int g = pair == 0 ? 3 * k : 1 + k;
      if (inside) {
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          if (is_green<kGreenDiag>(plane_of(z, g))) continue;
#pragma unroll
          for (int px = 0; px < kPX; ++px) {
            store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py,
                                   px0 + px, taps.chan[plane_of(z, g)], m00[z][k][px], b0[z][k][px],
                                   cw[1 + k][px], c1[1 + k][px], c2[1 + k][px], sc);
          }
        }
      }
    };
    if constexpr (kGeneral) {
      // each chunk staged in turn, once every thread is done with the
      // last, for both groups of the pair
      for (int f0 = 0; f0 < frames; f0 += chunk) {
        const int nf = min(chunk, frames - f0);
        if (frames > chunk || pair == 0) {  // one chunk is staged once
          __syncthreads();
          stage(f0, nf);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          add_group_taps<S, kHalo, kGreenDiag, kChains, kPX>(
              taps, pair == 0 ? 3 * k : 1 + k, k, nf, my_res, my_sv, phi_y, phis_y, phi_x, og0, og1, og2,
              or0, or1, or2, m00, b0, cw, c1, c2, kSW, kSA, kPix, sc, s_rows,
              make_float3(omega[pix * 3], omega[pix * 3 + 1], omega[pix * 3 + 2]),
              make_float3(omega_rb[pix * 3], omega_rb[pix * 3 + 1], omega_rb[pix * 3 + 2]));
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) store_rb(k);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // groups {0, 3}, then {1, 2}
        add_group_taps<S, kHalo, kGreenDiag, kChains, kPX>(
            taps, pair == 0 ? 3 * k : 1 + k, k, frames, my_res, my_sv, phi_y, phis_y, phi_x, og0, og1, og2,
            or0, or1, or2, m00, b0, cw, c1, c2);
        store_rb(k);  // now, so their registers free up and the stores spread over the kernel
      }
    }

    // the green cells of this pair, their two groups in group order
    if (inside) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        if (!is_green<kGreenDiag>(plane_of(z, pair == 0 ? 0 : 1))) continue;
#pragma unroll
        for (int px = 0; px < kPX; ++px) {
          store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px, 1,
                                 m00[z][0][px] + m00[z][1][px], b0[z][0][px] + b0[z][1][px],
                                 cw[0][px], c1[0][px], c2[0][px], sc);
        }
      }
    }
  }
}

// The certless and float32 order-0 forms on bursts past the frame cap
// (merge_raw_stream_kernel; see the file's head): add_group_taps, its
// rounding and the stores of merge_raw_kernel, the frames streamed through
// two shared-memory slots of `chunk` frames each (stream_chunk). A thread
// stages the same sites of every frame; at each step, once its own copies
// of the chunk at hand have landed, it forms their value * certainty and
// clips its residual, and the step's one barrier publishes the slot and
// frees the other, which takes the next chunk by cp.async while the block
// accumulates. StreamShape<S, chains> gives the layout: a thread per
// (pixel, phase thread of Layout<S>, tap group), each group in warps of
// its own (kSplit; threadIdx.z = phase thread + kZB group), 32 x 2 pixels
// a block at S = 1, 32 x 1 at S = 2-3 (S = 3: a third of the phases a
// block, grid z the rest) and 16 x 1 at S = 4 (half the phases); or, for
// the order 0 at S = 4, Layout<4>'s thread per tap-group pair, the frames
// streamed once a pair.
constexpr int kStreamSlots = 2;

template <int S, bool kChains>
struct StreamShape {
  // a thread per tap group: at S = 1-3, and with the chains at S = 4
  static constexpr bool kSplit = S <= 3 || kChains;
  static constexpr int kPX = Layout<S>::kPX, kCols = S / kPX, kZ = S * kCols;  // Layout<S>'s phase threads
  static constexpr int kTileH = kSplit ? (S == 1 ? 2 : 1) : Layout<S>::kTileH;
  static constexpr int kTW = S == 4 && kSplit ? 16 : kTileW;  // pixels a tile row
  // phase threads a block, grid z over the rest
  static constexpr int kZB = kSplit && S >= 3 ? (S == 3 ? 3 : 4) : kZ;
  static constexpr int kPhaseBlocks = kZ / kZB;
  static constexpr int kPix = kTW * kTileH;
  static constexpr int kThreads = kPix * kZB * (kSplit ? 4 : 1);
  static constexpr int kMinBlocks = 2;
};

// The bytes of one frame in a slot: the tile and halo of four planes and
// the tile's residuals, a float2 a site.
template <int S, int kHalo, bool kChains>
constexpr size_t stream_frame_bytes() {
  using L = StreamShape<S, kChains>;
  return (size_t)(4 * (L::kTileH + 2 * kHalo) * (L::kTW + 2 * kHalo) + L::kPix) * sizeof(float2);
}

// The ring's chunk: the most frames whose kStreamSlots slots leave room
// for the kMinBlocks blocks an SM that the launch bound asks for (228 KB
// of shared memory an SM, 1 KB of it reserved for each block).
constexpr int kSmSmem = 233472;

template <int S, int kHalo, bool kChains>
constexpr int stream_chunk() {
  return (int)((kSmSmem / StreamShape<S, kChains>::kMinBlocks - 1024) /
               (kStreamSlots * stream_frame_bytes<S, kHalo, kChains>()));
}

template <int S, int kHalo, bool kGreenDiag, bool kChains>
__global__ void __launch_bounds__(StreamShape<S, kChains>::kThreads, StreamShape<S, kChains>::kMinBlocks)
merge_raw_stream_kernel(const float* __restrict__ planes,
                        const float* __restrict__ residual,
                        const float* __restrict__ certainty,
                        const float* __restrict__ omega,
                        const float* __restrict__ omega_rb,
                        float* __restrict__ m00_out, float* __restrict__ cy_out,
                        float* __restrict__ cx_out, float* __restrict__ b0_out,
                        int frames, int hh, int hw, float rb, const TapTable taps, int chunk) {
  using L = StreamShape<S, kChains>;
  static_assert(S >= 1 && S <= 4, "the templated scales");
  constexpr int kPX = L::kPX, kTW = L::kTW, kTileH = L::kTileH, kPix = L::kPix, kThreads = L::kThreads;
  constexpr int kSW = kTW + 2 * kHalo;             // staged row length
  constexpr int kSA = (kTileH + 2 * kHalo) * kSW;  // staged sites per plane
  constexpr int kSitesPT = (kSA + kThreads - 1) / kThreads;
  static_assert(kPix <= kThreads, "a thread stages at most one pixel's residual");
  extern __shared__ float2 smem[];
  // a slot: (chunk, 4, kSA) (value, certainty) sites, then (chunk, kPix)
  // clipped residuals
  const int slot_sz = chunk * (4 * kSA + kPix);

  const int tx = threadIdx.x, ty = threadIdx.y, zz = threadIdx.z;
  // the phase thread (Layout<S>'s numbering) and, split, the tap group
  // slot gz: groups 0, 3 (pair 0), 1, 2 (pair 1)
  const int zb = zz % L::kZB, gz = zz / L::kZB;
  const int zp = zb + (int)blockIdx.z * L::kZB;
  const int py = zp / L::kCols, px0 = (zp % L::kCols) * kPX;
  const int tid = (zz * kTileH + ty) * kTW + tx;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTW;
  const long long plane = (long long)hh * hw;

  // this thread's sites, the same in every frame (edge-clamped like the
  // plain version's padding): site tid + n kThreads of each plane (-1
  // past the tile and halo) and pixel tid's residual (-1 past the tile)
  int site_rc[kSitesPT];
#pragma unroll
  for (int n = 0; n < kSitesPT; ++n) {
    const int site = tid + n * kThreads;
    site_rc[n] = site < kSA ? min(max(i0 - kHalo + site / kSW, 0), hh - 1) * hw +
                                  min(max(j0 - kHalo + site % kSW, 0), hw - 1)
                            : -1;
  }
  const int pix_rc = tid < kPix ? min(i0 + tid / kTW, hh - 1) * hw + min(j0 + tid % kTW, hw - 1) : -1;
  // copies the chunk of frames [f0, f0 + chunk) into slot b
  const auto stage = [&](int f0, int b) {
    const int nf = min(chunk, frames - f0);
    float2* sv = smem + b * slot_sz;
#pragma unroll
    for (int n = 0; n < kSitesPT; ++n) {
      if (site_rc[n] < 0) break;
      const float* pf = planes + (long long)f0 * 4 * plane + site_rc[n];
      const float* cf = certainty + ((long long)f0 * plane + site_rc[n]) * 3;
      float2* d = sv + tid + n * kThreads;
      for (int fl = 0; fl < nf; ++fl, pf += 4 * plane, cf += 3 * plane, d += 4 * kSA) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async4(&d[q * kSA].x, pf + q * plane);
          cp_async4(&d[q * kSA].y, cf + taps.chan[q]);
        }
      }
    }
    if (pix_rc >= 0) {
      const float* rf = residual + ((long long)f0 * plane + pix_rc) * 2;
      float2* d = sv + chunk * 4 * kSA + tid;
      for (int fl = 0; fl < nf; ++fl, rf += 2 * plane) cp_async8(&d[fl * kPix], rf);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // value * certainty and the clipped residual on this thread's sites of
  // slot b, which holds frames [f0, f0 + chunk), once its copies landed
  const auto fix = [&](int f0, int b) {
    const int nf = min(chunk, frames - f0);
    float2* sv = smem + b * slot_sz;
#pragma unroll
    for (int n = 0; n < kSitesPT; ++n) {
      if (site_rc[n] < 0) break;
      for (int e = tid + n * kThreads; e < nf * 4 * kSA; e += kSA) sv[e].x *= sv[e].y;
    }
    if (pix_rc >= 0) {
      float2* d = sv + chunk * 4 * kSA + tid;
      for (int fl = 0; fl < nf; ++fl) {
        const float2 r = d[fl * kPix];
        d[fl * kPix] = make_float2(fminf(fmaxf(r.x, -rb), rb), fminf(fmaxf(r.y, -rb), rb));
      }
    }
  };
  stage(0, 0);

  const int i = i0 + ty, j = j0 + tx;
  const bool inside = i < hh && j < hw;
  const long long pix = (long long)min(i, hh - 1) * hw + min(j, hw - 1);
  const long long out_pix = (long long)i * hw + j;
  // phi and the folded omegas as merge_raw_kernel forms them
  const float phi_y = ((float)py + 0.5f) / (float)S - 0.5f;
  const float phis_y = phi_y * (float)S;
  float phi_x[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) phi_x[p] = ((float)(px0 + p) + 0.5f) / (float)S - 0.5f;
  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float og0 = -0.5f * kL * omega[pix * 3 + 0], og1 = -0.5f * kL * omega[pix * 3 + 1],
              og2 = -kL * omega[pix * 3 + 2];
  const float or0 = -0.5f * kL * omega_rb[pix * 3 + 0],
              or1 = -0.5f * kL * omega_rb[pix * 3 + 1], or2 = -kL * omega_rb[pix * 3 + 2];

  int b = 0;  // the slot of the chunk at hand
  // a step: its chunk's copies landed (issued a step before), every
  // thread fixes its own sites, the barrier publishes them and frees the
  // other slot, which takes the next chunk, [f0 + chunk, ...) or, while
  // `more`, the first again
  const auto step = [&](int f0, bool more) -> const float2* {
    asm volatile("cp.async.wait_group 0;\n" ::);
    fix(f0, b);
    __syncthreads();
    if (f0 + chunk < frames) {
      stage(f0 + chunk, b ^ 1);
    } else if (more) {
      stage(0, b ^ 1);
    }
    return smem + b * slot_sz;
  };

  if constexpr (L::kSplit) {
    // this thread's group (gz: groups 0, 3, 1, 2): its cells m, bv
    // [parity z][x phase], the pair's green chain cg and its own R/B
    // chain cr (w, n1, n2), through add_group_taps' arrays step by step
    float m[4][kPX], bv[4][kPX], cg[3][kPX], cr[3][kPX];
#pragma unroll
    for (int px = 0; px < kPX; ++px) {
#pragma unroll
      for (int z = 0; z < 4; ++z) m[z][px] = bv[z][px] = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) cg[c][px] = cr[c][px] = 0.0f;
    }
    const auto run = [&](auto pair_c, auto k_c, const float2* sv, int nf) {
      constexpr int pair = decltype(pair_c)::value, k = decltype(k_c)::value;
      float m00[4][2][kPX] = {}, b0[4][2][kPX] = {}, cw[3][kPX] = {}, c1[3][kPX] = {}, c2[3][kPX] = {};
#pragma unroll
      for (int px = 0; px < kPX; ++px) {
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          m00[z][k][px] = m[z][px];
          b0[z][k][px] = bv[z][px];
        }
        cw[0][px] = cg[0][px], c1[0][px] = cg[1][px], c2[0][px] = cg[2][px];
        cw[1 + k][px] = cr[0][px], c1[1 + k][px] = cr[1][px], c2[1 + k][px] = cr[2][px];
      }
      add_group_taps<S, kHalo, kGreenDiag, kChains, kPX, kTileH, kTW>(
          taps, pair == 0 ? 3 * k : 1 + k, k, nf, sv + chunk * 4 * kSA + ty * kTW + tx,
          sv + (ty + kHalo) * kSW + (tx + kHalo), phi_y, phis_y, phi_x, og0, og1, og2, or0, or1, or2, m00, b0,
          cw, c1, c2);
#pragma unroll
      for (int px = 0; px < kPX; ++px) {
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          m[z][px] = m00[z][k][px];
          bv[z][px] = b0[z][k][px];
        }
        cg[0][px] = cw[0][px], cg[1][px] = c1[0][px], cg[2][px] = c2[0][px];
        cr[0][px] = cw[1 + k][px], cr[1][px] = c1[1 + k][px], cr[2][px] = c2[1 + k][px];
      }
    };
    using I0 = std::integral_constant<int, 0>;
    using I1 = std::integral_constant<int, 1>;
#pragma unroll 1
    for (int f0 = 0; f0 < frames; f0 += chunk) {
      const float2* sv = step(f0, false);
      const int nf = min(chunk, frames - f0);
      switch (gz) {
        case 0: run(I0{}, I0{}, sv, nf); break;
        case 1: run(I0{}, I1{}, sv, nf); break;
        case 2: run(I1{}, I0{}, sv, nf); break;
        default: run(I1{}, I1{}, sv, nf); break;
      }
      b ^= 1;
    }
    // the group's R and B cells
    const auto finish = [&](auto pair_c, auto k_c) {
      constexpr int pair = decltype(pair_c)::value, k = decltype(k_c)::value;
      constexpr int g = pair == 0 ? 3 * k : 1 + k;
      if (!inside) return;
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        if (is_green<kGreenDiag>(plane_of(z, g))) continue;
#pragma unroll
        for (int px = 0; px < kPX; ++px) {
          store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px,
                                 taps.chan[plane_of(z, g)], m[z][px], bv[z][px], cr[0][px], cr[1][px], cr[2][px]);
        }
      }
    };
    // a pair's green cells add its second group's sums, passed through
    // the ring (free now), to its first's, in group order: [pair][x
    // phase][the four parities' (m00, b0), the green chain's (w, n1,
    // n2)][phase thread, pixel]
    constexpr int kXN = L::kZB * kTileH * kTW;
    float* xs = reinterpret_cast<float*>(smem) + (zb * kTileH + ty) * kTW + tx;
    __syncthreads();
    if (gz & 1) {
#pragma unroll
      for (int px = 0; px < kPX; ++px) {
        float* row = xs + ((gz >> 1) * 11 * kPX + 11 * px) * kXN;
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          row[2 * z * kXN] = m[z][px];
          row[(2 * z + 1) * kXN] = bv[z][px];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) row[(8 + c) * kXN] = cg[c][px];
      }
    }
    switch (gz) {
      case 0: finish(I0{}, I0{}); break;
      case 1: finish(I0{}, I1{}); break;
      case 2: finish(I1{}, I0{}); break;
      default: finish(I1{}, I1{}); break;
    }
    __syncthreads();
    if (!(gz & 1) && inside) {
      const float* row = xs + (gz >> 1) * 11 * kPX * kXN;
      const bool pair1 = gz != 0;
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        // parity z reads green in the pair's groups (plane_of(z, 0) for
        // pair 0, plane_of(z, 1) for pair 1)
        if (!is_green<kGreenDiag>(plane_of(z, pair1 ? 1 : 0))) continue;
#pragma unroll
        for (int px = 0; px < kPX; ++px) {
          const float* r = row + 11 * px * kXN;
          store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px, 1,
                                 m[z][px] + r[2 * z * kXN], bv[z][px] + r[(2 * z + 1) * kXN],
                                 cg[0][px] + r[8 * kXN], cg[1][px] + r[9 * kXN], cg[2][px] + r[10 * kXN]);
        }
      }
    }
  } else {
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      // [parity z][group of the pair][x phase]
      float m00[4][2][kPX], b0[4][2][kPX];
      // [the pair's green chain, its groups' R/B chains][x phase]
      float cw[3][kPX], c1[3][kPX], c2[3][kPX];
#pragma unroll
      for (int px = 0; px < kPX; ++px) {
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          m00[z][0][px] = m00[z][1][px] = b0[z][0][px] = b0[z][1][px] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) cw[k][px] = c1[k][px] = c2[k][px] = 0.0f;
      }
#pragma unroll 1
      for (int f0 = 0; f0 < frames; f0 += chunk) {
        const float2* sv = step(f0, pair == 0);
        const int nf = min(chunk, frames - f0);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          add_group_taps<S, kHalo, kGreenDiag, kChains, kPX, kTileH, kTW>(
              taps, pair == 0 ? 3 * k : 1 + k, k, nf, sv + chunk * 4 * kSA + ty * kTW + tx,
              sv + (ty + kHalo) * kSW + (tx + kHalo), phi_y, phis_y, phi_x, og0, og1, og2, or0, or1, or2, m00, b0,
              cw, c1, c2);
        }
        b ^= 1;
      }
      if (inside) {
        // the R and B cells each group completed, then the pair's green
        // cells, their two groups in group order
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int g = pair == 0 ? 3 * k : 1 + k;
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            if (is_green<kGreenDiag>(plane_of(z, g))) continue;
#pragma unroll
            for (int px = 0; px < kPX; ++px) {
              store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px,
                                     taps.chan[plane_of(z, g)], m00[z][k][px], b0[z][k][px], cw[1 + k][px],
                                     c1[1 + k][px], c2[1 + k][px]);
            }
          }
        }
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          if (!is_green<kGreenDiag>(plane_of(z, pair == 0 ? 0 : 1))) continue;
#pragma unroll
          for (int px = 0; px < kPX; ++px) {
            store_cell<S, kChains>(m00_out, cy_out, cx_out, b0_out, plane, out_pix, z, py, px0 + px, 1,
                                   m00[z][0][px] + m00[z][1][px], b0[z][0][px] + b0[z][1][px], cw[0][px],
                                   c1[0][px], c2[0][px]);
          }
        }
      }
    }
  }
}

// The tile of merge_raw_cells_kernel: kTW x kTH half-res pixels at scale
// S, a thread per (pixel, output phase) holding kPairs tap-group pairs
// ({0, 3} and {1, 2}): the 9 and the 6 slots one pair (two threads a
// pixel and phase), the 4 slots both (at S = 3 one: 9 warps of 128
// registers would leave a block alone on an SM). A warp holds kTW pixels
// of a row at 32 / kTW phases, which read the same sites.
template <int S, int kPairs>
struct CellTile;
template <>
struct CellTile<1, 1> {
  static constexpr int kTW = 32, kTH = 4;
};
template <>
struct CellTile<2, 1> {
  static constexpr int kTW = 16, kTH = 2;
};
template <>
struct CellTile<3, 1> {
  static constexpr int kTW = 32, kTH = 1;
};
template <>
struct CellTile<4, 1> {
  static constexpr int kTW = 8, kTH = 1;
};
template <>
struct CellTile<1, 2> {
  static constexpr int kTW = 32, kTH = 4;
};
template <>
struct CellTile<2, 2> {
  static constexpr int kTW = 16, kTH = 4;
};
template <>
struct CellTile<4, 2> {
  static constexpr int kTW = 8, kTH = 2;
};
// S = 0, the general form: 8 x 1 pixels, one pair a thread, a group of
// phases (General::phases, padded to the warp's 4) a block, at most 512
// threads (128 registers)
template <>
struct CellTile<0, 1> {
  static constexpr int kTW = 8, kTH = 1;
};

template <int S, int kSlots>
struct CellShape {
  static constexpr int kPairs = kSlots != 4 || S == 3 || S == 0 ? 1 : 2;
  static constexpr int kTW = CellTile<S, kPairs>::kTW, kTH = CellTile<S, kPairs>::kTH;
  static constexpr int kPix = kTW * kTH;
  static constexpr int kPL = 32 / kTW;  // phases a warp holds
  static constexpr int kThreads = S ? (2 / kPairs) * S * S * kPix : 512;
  static constexpr int kMinBlocks = std::max(1, 65536 / (kThreads * 128));  // 128 registers
  // one ring stage, sized for the largest halo (2): the four planes'
  // (value, certainty) sites and the residual with a one-site halo
  static constexpr int kPlaneSites = (kTH + 4) * (kTW + 4);
  static constexpr int kResW = kTW + 2;
  static constexpr int kResSites = (kTH + 2) * kResW;
  static constexpr int kStage = 4 * kPlaneSites + kResSites;
  // the sites a thread stages each frame
  static constexpr int kSitesPT = (kPlaneSites + kThreads - 1) / kThreads;
  static constexpr int kResPT = (kResSites + kThreads - 1) / kThreads;
};
constexpr int kRing = 3;  // frames in flight: the one read, the next two staged

// Adds a (pixel, frame, tap, phase) term of one cell: wc = w c, v the
// value, dy and dx the cell's displacements; kSlots 9 in solve_order1's
// order (m00, m01, m02, m11, m12, m22, b0, b1, b2), 4 (m00, m01, m02, b0),
// 6 the 4 and the residual sums ry w c, rx w c (the shared-residual
// centroid; ry, rx the block-centre residual).
template <int kSlots>
__device__ __forceinline__ void add_moments(float* m, float wc, float v, float dy, float dx,
                                            float ry = 0.0f, float rx = 0.0f) {
  const float wcv = wc * v;
  m[0] += wc;
  if constexpr (kSlots == 4 || kSlots == 6) {
    m[1] = fmaf(dy, wc, m[1]);
    m[2] = fmaf(dx, wc, m[2]);
    m[3] += wcv;
    if constexpr (kSlots == 6) {
      m[4] = fmaf(ry, wc, m[4]);
      m[5] = fmaf(rx, wc, m[5]);
    }
  } else {
    const float ty = dy * wc, tx = dx * wc;
    m[1] += ty;
    m[2] += tx;
    m[3] = fmaf(dy, ty, m[3]);
    m[4] = fmaf(dx, ty, m[4]);
    m[5] = fmaf(dx, tx, m[5]);
    m[6] += wcv;
    m[7] = fmaf(dy, wcv, m[7]);
    m[8] = fmaf(dx, wcv, m[8]);
  }
}

// The centroid moments in bfloat16 (centroid_bf16): m01 += (S ky) w c -
// S bf16(rho_y) bf16(w c), m02 likewise: rho and w c rounded to bfloat16,
// their product exact in f32 and summed there, as the jitted JAX function
// computes it. sky and skx are S ky and S kx, ns is -S, and ryb and rxb
// are bf16(rho) as floats.
__device__ __forceinline__ void add_moments_cbf16(float* m, float wc, float v, float sky, float skx,
                                                  float ns, float ryb, float rxb) {
  const float wb = __bfloat162float(__float2bfloat16_rn(wc));
  m[0] += wc;
  m[1] = fmaf(sky, wc, fmaf(ns, ryb * wb, m[1]));
  m[2] = fmaf(skx, wc, fmaf(ns, rxb * wb, m[2]));
  m[3] += wc * v;
}

// 2^(dx (dx o0 + dy o2) + dy^2 o1): the Gaussian with -1/2 log2(e) folded
// into omega (o2 the cross term's -log2(e))
__device__ __forceinline__ float gauss(float dx, float dy, float o0, float o1, float o2) {
  return exp2_approx(fmaf(dx, fmaf(dx, o0, dy * o2), dy * dy * o1));
}

// A pair's six cells, (relabelled parity z', group k of the pair): z' = 0
// and 3 read green in both groups (one cell each), z' = 1 and 2 read R or
// B, a cell per group.
__host__ __device__ constexpr int cell_of(int zp, int k) {
  return zp == 0 ? 0 : (zp == 3 ? 1 : 2 + 2 * (zp - 1) + k);
}

// The staged offset (in sites) of what parity z reads for a tap (ky, kx)
// of group g: plane z ^ g at ((a + ky) // 2, (b + kx) // 2).
__device__ __forceinline__ int staged_offset(int z, int g, int ky, int kx, int sa, int sw) {
  return (z ^ g) * sa + (((z >> 1) + ky) >> 1) * sw + (((z & 1) + kx) >> 1);
}

// kSlots: 9 (form 2, solve_order1's order), 4 (form 3: m00, m01, m02, b0)
// or 6 (form 3 with the shared-residual centroid: the 4 and the phase's
// residual sums, folded before the store). kExact: the weights at each
// parity's moment displacement (exact_weights), four Gaussians an item.
// kCBf16: bfloat16 centroid products (centroid_bf16, 4 slots). kPrune:
// the taps of a group that the centroid leaves out (centroid_prune) run
// after the others, in a second loop, and add m00 and b0 alone; a
// template parameter because the second loop's code, even never
// entered, made form 3 3-4% slower on an H100 when it was a runtime
// bound. block: the centroid's displacement from the block-centre
// residual (centroid_block).
template <int S, int kSlots, bool kExact, bool kCBf16, bool kPrune>
__global__ void __launch_bounds__(CellShape<S, kSlots>::kThreads, CellShape<S, kSlots>::kMinBlocks)
merge_raw_cells_kernel(const float* __restrict__ planes,
                       const float* __restrict__ residual,
                       const float* __restrict__ certainty,
                       const float* __restrict__ omega,
                       const float* __restrict__ omega_rb,
                       float* __restrict__ out,
                       int frames, int hh, int hw, int halo, float rb, int green_diag,
                       int block, const TapTable taps, const General gen) {
  using L = CellShape<S, kSlots>;
  constexpr bool kGeneral = S == 0;  // the scale, phases and tap rows of gen at run time
  constexpr int kTW = L::kTW, kTH = L::kTH;
  constexpr int kPairs = L::kPairs, kRW = L::kResW;
  constexpr int kOut = kSlots == 6 ? 4 : kSlots;  // the slots stored
  static_assert(kSlots == 4 || kSlots == 6 || kSlots == 9, "the plugin's 4 (6) moments or the exact solve's 9");
  static_assert(!kCBf16 || kSlots == 4, "bfloat16 centroid products are the compact-rho form's");
  static_assert(!kPrune || kSlots != 9, "the pruned centroid is the per-cell form's");
  static_assert(kGeneral || S * S % L::kPL == 0, "a warp holds phases of one pair");
  const int sc = kGeneral ? gen.s : S;
  const int kThreads = kGeneral ? (int)blockDim.x : L::kThreads;
  __shared__ float2 ring_s[kGeneral ? 1 : kRing][kGeneral ? 1 : L::kStage];
  // [flip][tap]: (S ky, S kx, the staged offset z' = 0 reads as int bits)
  __shared__ float4 s_tap_s[2][kGeneral ? 1 : kMaxTaps];
  // [flip][group]: the offsets z' = 1, 2, 3 read, from z' = 0's (.x = 0)
  __shared__ int4 s_dz[2][4];

  const int sw = kTW + 2 * halo;                  // staged row length
  const int sa = (kTH + 2 * halo) * sw;           // staged sites per plane
  // the ring's stage: sized for the largest halo (2), or the general
  // form's own, in dynamic shared memory with its tap table after it
  const int plane_sites = kGeneral ? sa : L::kPlaneSites;
  const int stage_sz = kGeneral ? 4 * sa + L::kResSites : L::kStage;
  const int tap_row = taps.group_end[3];  // the general form's
  extern __shared__ float2 smem[];
  // frame f's ring slot, and relabelling fl's tap rows
  const auto ring = [&](int f) -> float2* {
    if constexpr (kGeneral) {
      return smem + (f % kRing) * stage_sz;
    } else {
      return ring_s[f % kRing];
    }
  };
  const auto s_tap = [&](int fl) -> float4* {
    if constexpr (kGeneral) {
      return reinterpret_cast<float4*>(smem + ((kRing * stage_sz + 1) & ~1)) + fl * tap_row;
    } else {
      return s_tap_s[fl];
    }
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp: pixel row ty, kPL phases of one pair (with one pair a thread,
  // groups {0, 3} or {1, 2}). The general form's block holds gen.phases
  // phases (padded to kPL), its first phase 0 in every group (the shared
  // centroid's anchor; stored by group 0 alone), then the group's share.
  constexpr int kPL = L::kPL;
  const int kPhaseWarps = kGeneral ? (gen.phases + kPL - 1) / kPL : S * S / kPL;
  const int tx = lane % kTW, ty = warp % kTH;
  const int ph_local = (warp / kTH) % kPhaseWarps * kPL + lane / kTW;
  // the general form: grid z = (phase group, pair), one pair a block
  const int zg = kGeneral ? (int)blockIdx.z >> 1 : 0;
  const int ph = !kGeneral || ph_local == 0 ? ph_local : 1 + zg * (gen.phases - 1) + ph_local - 1;
  const bool stores = !kGeneral || (ph_local < gen.phases && ph < sc * sc && (ph_local > 0 || zg == 0));
  const int pair1 = kPairs == 2 ? 0 : (kGeneral ? (int)blockIdx.z & 1 : warp / (kTH * kPhaseWarps));
  const int py = ph / sc, px = ph % sc;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const long long plane = (long long)hh * hw;
  const int n_taps = taps.group_end[3];

  // The relabelled parity z' = z ^ flip, flip = pair ^ !green_diag: the
  // parities whose two groups of a pair read green are z' = 0 and 3
  // (flip only swaps b). Within a group the four parities' sites keep
  // fixed offsets from each other, so a tap carries z' = 0's alone.
  for (int e = tid; e < 2 * n_taps; e += kThreads) {
    const int t = e >> 1, fl = e & 1;
    const int ky = kGeneral ? gen.rows[3 * t] : taps.ky[t], kx = kGeneral ? gen.rows[3 * t + 1] : taps.kx[t];
    const int o0 = staged_offset(fl, 2 * (ky & 1) + (kx & 1), ky, kx, sa, sw);
    s_tap(fl)[t] = make_float4((float)(sc * ky), (float)(sc * kx), __int_as_float(o0), 0.0f);
  }
  if (tid < 8) {
    const int fl = tid >> 2, g = tid & 3;
    const int o0 = staged_offset(fl, g, g >> 1, g & 1, sa, sw);  // a tap of the group
    s_dz[fl][g] = make_int4(0, staged_offset(1 ^ fl, g, g >> 1, g & 1, sa, sw) - o0,
                            staged_offset(2 ^ fl, g, g >> 1, g & 1, sa, sw) - o0,
                            staged_offset(3 ^ fl, g, g >> 1, g & 1, sa, sw) - o0);
  }

  // The sites this thread stages, the same every frame: their clamped
  // global site index (edge-clamped like the plain version's padding), or
  // -1. It copies each plane's (value, certainty of the plane's channel)
  // there and the residual with a one-site halo into frame f's ring slot.
  int g_site[kGeneral ? 1 : L::kSitesPT], g_res[kGeneral ? 1 : L::kResPT];
#pragma unroll
  for (int n = 0; n < (kGeneral ? 0 : L::kSitesPT); ++n) {
    const int site = tid + n * kThreads, r = site / sw, c = site - r * sw;
    g_site[n] = site < sa ? min(max(i0 - halo + r, 0), hh - 1) * hw + min(max(j0 - halo + c, 0), hw - 1) : -1;
  }
#pragma unroll
  for (int n = 0; n < (kGeneral ? 0 : L::kResPT); ++n) {
    const int e = tid + n * kThreads, r = e / kRW, c = e - r * kRW;
    g_res[n] = e < L::kResSites ? min(max(i0 - 1 + r, 0), hh - 1) * hw + min(max(j0 - 1 + c, 0), hw - 1) : -1;
  }
  auto stage = [&](int f) {
    float2* st = ring(f);
    const float* pf = planes + (long long)f * 4 * plane;
    const float* cf = certainty + (long long)f * 3 * plane;
    if constexpr (kGeneral) {  // the sites' indices formed each frame
      const float2* rf = reinterpret_cast<const float2*>(residual) + (long long)f * plane;
      for (int site = tid; site < sa; site += kThreads) {
        const int r = site / sw, c = site - r * sw;
        const int gs = min(max(i0 - halo + r, 0), hh - 1) * hw + min(max(j0 - halo + c, 0), hw - 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async4(&st[q * sa + site].x, pf + q * plane + gs);
          cp_async4(&st[q * sa + site].y, cf + 3 * (long long)gs + taps.chan[q]);
        }
      }
      for (int e = tid; e < L::kResSites; e += kThreads) {
        const int r = e / kRW, c = e - r * kRW;
        cp_async8(st + 4 * sa + e, rf + min(max(i0 - 1 + r, 0), hh - 1) * hw + min(max(j0 - 1 + c, 0), hw - 1));
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < L::kSitesPT; ++n) {
      if (g_site[n] < 0) continue;
      float2* dst = st + tid + n * kThreads;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cp_async4(&dst[q * sa].x, pf + q * plane + g_site[n]);
        cp_async4(&dst[q * sa].y, cf + 3 * (long long)g_site[n] + taps.chan[q]);
      }
    }
    const float2* rf = reinterpret_cast<const float2*>(residual) + (long long)f * plane;
#pragma unroll
    for (int n = 0; n < L::kResPT; ++n) {
      if (g_res[n] >= 0) cp_async8(st + 4 * L::kPlaneSites + tid + n * kThreads, rf + g_res[n]);
    }
  };
  stage(0);
  asm volatile("cp.async.commit_group;\n" ::);
  if (frames > 1) stage(1);
  asm volatile("cp.async.commit_group;\n" ::);

  const int i = i0 + ty, j = j0 + tx;
  const long long pix = (long long)min(i, hh - 1) * hw + min(j, hw - 1);
  // phi[p] = (p + 0.5) / s - 0.5 in the f32 operations of
  // fast_merge._output_phase_offsets
  const float phi_y = ((float)py + 0.5f) / (float)sc - 0.5f;
  const float phi_x = ((float)px + 0.5f) / (float)sc - 0.5f;
  const float phis_y = phi_y * (float)sc, phis_x = phi_x * (float)sc;
  // the parity-interpolated residual's blend weight with the
  // neighbouring block: parity 0 blends the block before (g < 0 at every
  // phase), parity 1 the block after
  const float ga_y0 = fabsf((phi_y - 0.5f) / 2.0f), ga_y1 = fabsf((1.0f + phi_y - 0.5f) / 2.0f);
  const float ga_x0 = fabsf((phi_x - 0.5f) / 2.0f), ga_x1 = fabsf((1.0f + phi_x - 0.5f) / 2.0f);
  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float og0 = -0.5f * kL * omega[pix * 3 + 0], og1 = -0.5f * kL * omega[pix * 3 + 1],
              og2 = -kL * omega[pix * 3 + 2];
  const float or0 = -0.5f * kL * omega_rb[pix * 3 + 0],
              or1 = -0.5f * kL * omega_rb[pix * 3 + 1], or2 = -kL * omega_rb[pix * 3 + 2];
  const int my_site = (ty + halo) * sw + (tx + halo);
  const int my_res = 4 * plane_sites + (ty + 1) * kRW + (tx + 1);

  float acc[6 * kPairs][kSlots];
#pragma unroll
  for (int c = 0; c < 6 * kPairs; ++c)
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[c][k] = 0.0f;

  for (int f = 0; f < frames; ++f) {
    // frame f has landed (f + 1 may be in flight); every thread is done
    // with frame f - 1, whose slot now takes frame f + 2
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if (f + 2 < frames) stage(f + 2);
    asm volatile("cp.async.commit_group;\n" ::);

    const float2* st = ring(f);
    const float2 res = st[my_res];
    const float ry = fminf(fmaxf(res.x, -rb), rb), rx = fminf(fmaxf(res.y, -rb), rb);
    const float ry_a = fminf(fmaxf(st[my_res - kRW].x, -rb), rb);
    const float ry_b = fminf(fmaxf(st[my_res + kRW].x, -rb), rb);
    const float rx_a = fminf(fmaxf(st[my_res - 1].y, -rb), rb);
    const float rx_b = fminf(fmaxf(st[my_res + 1].y, -rb), rb);
    // rho per parity (the blended residual, clipped, + phi) and S rho
    const float ry0 = fminf(fmaxf((1.0f - ga_y0) * ry + ga_y0 * ry_a, -rb), rb) + phi_y;
    const float ry1 = fminf(fmaxf((1.0f - ga_y1) * ry + ga_y1 * ry_b, -rb), rb) + phi_y;
    const float rx0 = fminf(fmaxf((1.0f - ga_x0) * rx + ga_x0 * rx_a, -rb), rb) + phi_x;
    const float rx1 = fminf(fmaxf((1.0f - ga_x1) * rx + ga_x1 * rx_b, -rb), rb) + phi_x;
    const float sy0 = (float)sc * ry0, sy1 = (float)sc * ry1, sx0 = (float)sc * rx0, sx1 = (float)sc * rx1;
    // the weights' block-centre displacement: dy_w = S ky - (S ry + S phi)
    const float wy = fmaf(ry, (float)sc, phis_y), wx = fmaf(rx, (float)sc, phis_x);
    // the moments' displacement origins: S rho per parity, the block
    // centre's S (ry + phi), or (shared residual) S phi alone, the
    // residual entering through the folded sums
    float my0 = sy0, my1 = sy1, mx0 = sx0, mx1 = sx1;
    if constexpr (kSlots == 6) {
      my0 = my1 = phis_y;
      mx0 = mx1 = phis_x;
    } else if (block) {
      my0 = my1 = wy;
      mx0 = mx1 = wx;
    }
    const float2* sv = st + my_site;

#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp) {
      const int pair = kPairs == 2 ? pp : pair1;
      const int flip = pair ^ (green_diag ? 0 : 1);
      // x in the order b' = b ^ flip
      const float sxp0 = flip ? sx1 : sx0, sxp1 = flip ? sx0 : sx1;
      const float mxp0 = flip ? mx1 : mx0, mxp1 = flip ? mx0 : mx1;
      float ryb0 = 0.f, ryb1 = 0.f, rxb0 = 0.f, rxb1 = 0.f;  // kCBf16: rho per parity, rounded
      if constexpr (kCBf16) {
        const auto bf = [](float x) { return __bfloat162float(__float2bfloat16_rn(x)); };
        ryb0 = bf(ry0);
        ryb1 = bf(ry1);
        rxb0 = bf(flip ? rx1 : rx0);
        rxb1 = bf(flip ? rx0 : rx1);
      }
      const float4* tab = s_tap(flip);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int g = pair ? 1 + k : 3 * k;
        const int4 d = s_dz[flip][g];
        float* a0 = acc[6 * pp + cell_of(0, k)];
        float* a1 = acc[6 * pp + cell_of(1, k)];
        float* a2 = acc[6 * pp + cell_of(2, k)];
        float* a3 = acc[6 * pp + cell_of(3, k)];
        // a tap of the centroid's (all of them without centroid_prune) adds
        // every moment; one outside it m00 and b0 alone (the host sorts
        // the former first within a group)
        const auto tap = [&](int t, auto centroid) {
          const float4 kk = tab[t];
          float w0, w1, w2, w3;  // the parities' weights, z' = 0 and 3 green
          if constexpr (kExact) {
            // at each parity's parity-interpolated displacement
            const float dya = kk.x - sy0, dyb = kk.x - sy1, dxa = kk.y - sxp0, dxb = kk.y - sxp1;
            w0 = gauss(dxa, dya, og0, og1, og2);
            w1 = gauss(dxb, dya, or0, or1, or2);
            w2 = gauss(dxa, dyb, or0, or1, or2);
            w3 = gauss(dxb, dyb, og0, og1, og2);
          } else {
            // the Gaussian pair at the block centre, once per (pixel,
            // frame, tap, phase), feeds all four parities
            const float dyw = kk.x - wy, dxw = kk.y - wx;
            w0 = w3 = gauss(dxw, dyw, og0, og1, og2);
            w1 = w2 = gauss(dxw, dyw, or0, or1, or2);
          }
          const float2* p0 = sv + __float_as_int(kk.z);
          const float2 v0 = p0[0], v1 = p0[d.y], v2 = p0[d.z], v3 = p0[d.w];  // (value, certainty)
          const float wc0 = w0 * v0.y, wc1 = w1 * v1.y, wc2 = w2 * v2.y, wc3 = w3 * v3.y;
          if constexpr (!decltype(centroid)::value) {
            float* const cells[4] = {a0, a1, a2, a3};
            const float wcs[4] = {wc0, wc1, wc2, wc3}, vs[4] = {v0.x, v1.x, v2.x, v3.x};
#pragma unroll
            for (int z = 0; z < 4; ++z) {
              cells[z][0] += wcs[z];
              cells[z][3] += wcs[z] * vs[z];
            }
          } else if constexpr (kCBf16) {
            const float ns = -(float)sc;
            add_moments_cbf16(a0, wc0, v0.x, kk.x, kk.y, ns, ryb0, rxb0);
            add_moments_cbf16(a1, wc1, v1.x, kk.x, kk.y, ns, ryb0, rxb1);
            add_moments_cbf16(a2, wc2, v2.x, kk.x, kk.y, ns, ryb1, rxb0);
            add_moments_cbf16(a3, wc3, v3.x, kk.x, kk.y, ns, ryb1, rxb1);
          } else {
            const float dy0 = kk.x - my0, dy1 = kk.x - my1, dx0 = kk.y - mxp0, dx1 = kk.y - mxp1;
            add_moments<kSlots>(a0, wc0, v0.x, dy0, dx0, ry, rx);
            add_moments<kSlots>(a1, wc1, v1.x, dy0, dx1, ry, rx);
            add_moments<kSlots>(a2, wc2, v2.x, dy1, dx0, ry, rx);
            add_moments<kSlots>(a3, wc3, v3.x, dy1, dx1, ry, rx);
          }
        };
        const int te = taps.group_end[g], tc = kPrune ? taps.centroid_end[g] : te;
#pragma unroll 1  // unrolled, the tap loop holds more registers and runs no faster
        for (int t = g ? taps.group_end[g - 1] : 0; t < tc; ++t) tap(t, std::true_type{});
        if constexpr (kPrune) {
#pragma unroll 1
          for (int t = tc; t < te; ++t) tap(t, std::false_type{});
        }
      }
    }
  }
  if constexpr (kSlots == 6) {
    // the shared residual folded into m01 and m02 (fast_merge.py:811-831):
    // m01 -= S R0 / m00_0 m00, R0 and m00_0 the cell's residual sum and
    // weight sum at phase 0, passed from the thread holding phase 0
    // through the (now idle) ring. A cell no centroid tap reached has R0 =
    // 0 and keeps its zero m01, m02, as the JAX function skips it.
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    float* xs = reinterpret_cast<float*>(ring(0));
    const int pix = ty * kTW + tx;
    if (ph == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int k = 0; k < 3; ++k) xs[((pair1 * 6 + c) * 3 + k) * L::kPix + pix] = acc[c][k == 0 ? 0 : 3 + k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float* x0 = xs + (pair1 * 6 + c) * 3 * L::kPix + pix;
      const float m0 = x0[0], r0y = x0[L::kPix], r0x = x0[2 * L::kPix];
      const float inv0 = m0 > 1e-8f ? 1.0f / fmaxf(m0, 1e-8f) : 0.0f;
      acc[c][1] -= (float)sc * r0y * inv0 * acc[c][0];
      acc[c][2] -= (float)sc * r0x * inv0 * acc[c][0];
    }
  }
  if (i >= hh || j >= hw || !stores) return;

  // stores: each warp writes rows of kTW consecutive pixels of a plane
  const long long slot = (long long)4 * sc * sc * 3 * plane;
  const long long out_pix = (long long)i * hw + j;
#pragma unroll
  for (int pp = 0; pp < kPairs; ++pp) {
    const int pair = kPairs == 2 ? pp : pair1;
    const int flip = pair ^ (green_diag ? 0 : 1);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      // cell c's relabelled parity and group (cell_of inverted)
      const int zp = c == 0 ? 0 : (c == 1 ? 3 : (c < 4 ? 1 : 2)), k = c < 2 ? 0 : c % 2;
      const int z = zp ^ flip;
      const int ch = c < 2 ? 1 : taps.chan[z ^ (pair ? 1 + k : 3 * k)];
      const int row = (z >> 1) * sc + py, col = (z & 1) * sc + px;
      float* dst = out + (((long long)row * 2 * sc + col) * 3 + ch) * plane + out_pix;
#pragma unroll
      for (int k2 = 0; k2 < kOut; ++k2) dst[k2 * slot] = acc[6 * pp + c][k2];
    }
  }
}

// The general form (S = 0): what the templated instantiations are not
// built for, on Bayer patterns: scales past 4, taps past +-4 (their
// table's 81 signed-char rows, a staged halo of 1 or 2) and the
// bfloat16 order 0 past its frame cap. The same two kernels, the scale,
// staged halo and tap rows at run time (General), the block the host's
// (Block, from kernels/merge_raw.py::general_block: the choice and the
// shared bytes there, tested on the CPU; the launch refuses a block the
// form cannot take):
// - merge_raw_kernel<0, 0, green diagonal, chains, bf16> (forms 0
//   and 1): a thread per (pixel, phase) (kPX = 1), tw x th pixels (16 x
//   4 to 16 phases; 8 x 1 past them: 200 threads at S = 5) x the phases,
//   grid z over groups of phases past 512 threads. It streams: chunks of
//   as many frames as fit beside the tap table in 227 KB (one chunk,
//   staged once, where the burst fits: 58 frames of a 16 x 4 tile at halo
//   1, 226 of 8 x 1), each tap-group pair walking the chunks; the
//   bfloat16 order 0 walks the taps in the list's order in passes of four,
//   their frame sums kept across the chunks, so it rounds as the resident
//   form does. The tap rows (by group, and in list order) sit in dynamic
//   shared memory after the frames, and the staged halo is the taps'
//   reach, so no tap count bounds it. Each Gaussian pair is evaluated once
//   a (pixel, frame, tap, phase) and feeds the four parities.
// - merge_raw_cells_kernel<0, slots, ...> (forms 2 and 3, every knob): 8
//   x 1 pixels, one tap-group pair a block (grid z: the pair, and groups
//   of at most 32 phases), the group's phases padded to a warp's 4: 224
//   threads at S = 5; past 32 phases each group's first phase is phase 0
//   (the shared centroid's anchor, stored by group 0 alone). The ring of three frame slots, sized for the taps' halo, and
//   the tap table (n_taps rows a relabelling) are in dynamic shared
//   memory; each thread forms its staged sites' indices every frame.
// Rounding is the templated kernels' (ex2.approx, FMAs, value x
// certainty staged), within the same tolerances, but for the certless
// form: its weights' quadratic and its chain sums take the plain
// version's roundings (gauss_plain), as each centroid divides sums that
// cancel by an error that grows with S (with the templated arithmetic,
// 1.1-1.3e-5 at 4 of 9.8 M values at S = 5, past rtol/atol 1e-5).
// Bound at chip_smoke.py's check (F=5, 128 x 256 half-res, S=5, 25
// taps): 102 M items; certless 54.4 us, order 0 49.0 us, form 3 66.0 us,
// 9 slots 127.2 us, all operations (WORK). Staged bytes: a certless block
// stages, per frame, 4 planes x 3 x 10 sites and 8 residuals (1 KB) for
// its 8 pixels' 288 B of inputs, 3.6x; a cells block 4 x 3 x 10 and 3 x
// 10 (1.2 KB) for each of its two pairs' blocks, 8.3x.
// Measured (tools/ab_main_kernels.py; NVIDIA H100 80GB HBM3, 700.00
// W): ptxas 88-89 registers (order 0), 121-122 (chains), 115-117
// (bfloat16) for merge_raw_kernel<0, ...>; 96-100 (4 slots), 106-113
// (6), 126-128 (9) for the cells kernel's; no spills. At S=5 the certless
// form takes 0.389 ms (14.0% of its bound), form 3 0.374 (17.7%), 5.2
// and 8.0x under the first general kernel; all times in PERF.md.
//
// The non-Bayer kernel (merge_raw_nonbayer_kernel): 2 x 2 patterns other
// than Bayer, whose two groups of a tap-group pair do not read the same
// cells (and Bayer merges past any general block: 3,721 taps to +-30 pass
// the cells block's 232,448 bytes), at any scale, tap list and frame
// count, in all four forms and with every knob of forms 1 and 3 (each
// plane's channel and each certless cell's chain from the host's
// CellTable; the block, ring and tap windows from the host's NbPlan,
// kernels/merge_raw.py::nonbayer_plan).
//
// Design:
// - A thread per (half-res pixel, output phase) holds the 12 cells (4
//   parities x 3 channels) of its phase in forms 0 and 1 (24 sums, and in
//   form 0 the six certless chains, 18 more), or a parity row's 6 cells
//   (threadIdx.z's half: parities 2a, 2a + 1) in forms 2 and 3 (54 sums
//   for the 9 moments, 24 for the per-cell 4). Each Gaussian pair w_g, w_rb
//   of a (pixel, frame, tap, phase) is evaluated once by the thread and
//   shared by its parities (forms 2 and 3: once a half).
// - Staging. The frames stream through a ring of shared-memory slots of
//   `chunk` frames (one slot, staged once, where the burst fits; two,
//   the next chunk's cp.async copies in flight while one accumulates,
//   where it does not). A slot holds, edge-clamped like the plain
//   version's padding, each plane's tile and the taps' halo (the rows of
//   the step's tap window, the columns of every tap) as (value,
//   certainty of the plane's channel) float2s (forms 0 and 1: value x
//   certainty; bfloat16: both rounded), and the clipped residual with a
//   one-site halo. A thread stages the same sites every frame and walks
//   them without a division.
// - Taps. A device table of (ky, kx, centroid bit) rows: the f32 forms'
//   sorted by tap-parity group, run group by group (a compile-time g, so
//   each parity's plane z ^ g and its offsets are constants and its
//   channel and weight family are chosen once a group), their frame sums
//   gathered in registers and added to their cells by a compile-time-
//   unrolled select on chan[z ^ g] once a group and chunk; the bfloat16
//   knobs' in the list's order, each tap's sums added to its cells in
//   that order. Rows whose staged span would not fit a slot are split
//   into windows (the host's), each staged in turn; so no scale, tap
//   count, reach or frame count is bounded by shared memory. The bfloat16
//   order 0 rounds each tap's whole frame sum: past one chunk its windows
//   hold one tap, its sums kept across the chunks.
// - Knobs. The form, the certless weights' rounding, the bfloat16 order
//   0, the centroid (compact, bfloat16, block, shared residual) and the
//   exact weights are template parameters; the pruned centroid is a
//   tap's bit, which zeroes its centroid displacements.
// - Rounding: the templated kernels' (the quadratic on the folded omega
//   by FMAs, ex2.approx, value x certainty staged), but for the certless
//   form at S >= 5: there the weights' quadratic and the chain sums take
//   the plain version's roundings (gauss_plain), as the general form's do.
//   Each f32 cell sums its taps group by group; the bfloat16 knobs keep
//   the list's order.
// Measured (tools/ab_main_kernels.py; NVIDIA H100 80GB HBM3, 700.00 W), at
// S=2 on ((0, 1), (2, 1)): certless 0.0473 ms (20.1% of 9.5 us; the first
// design, a thread per output value reading device memory, 0.290), order
// 0 0.0376 (0.187), 9 slots 0.102 (0.334), per-cell 4 0.0716 (0.425); S=3
// on ((1, 1), (0, 2)) 0.150 (0.629); the 9 slots of a Bayer merge at 3,721
// taps on 3 x 64 x 128 4.77 (9.13). 124-128 registers; the 9 slots spill
// 12 B (28 B with exact weights).
struct CellTable {
  int chan[4];    // channel of plane q = 2*qa + qb
  int chain[12];  // form 0: the chain cell (a, b, ch) reads, at 3 (2a + b) + ch: 0 and 1 the
                  // green chains of (ky + kx) % 2, 2 + 2 (ky % 2) + kx % 2 the R/B ones, -1 none
};

// The non-Bayer kernel's block (kernels/merge_raw.py::nonbayer_plan): tw x
// th pixels x `phases` phases (x 2 parity halves in forms 2 and 3), grid
// z over `groups` of phases (past one group each group's first phase is
// phase 0, stored by group 0 alone); `hx` staged columns each side of the
// tile, `rows` staged rows a plane (the largest window's); `chunk` frames
// a ring slot, `slots` slots (2 where the steps are more than one); n_win
// tap windows; the group ends of the table's rows.
struct NbPlan {
  int tw, th, phases, groups, hx, rows, chunk, slots, n_win, bytes;
  int group_end[4];
};

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The plain version's roundings, where a bfloat16 knob rounds what they
// produce (a weight or rho one ulp off would round to the neighbouring
// bfloat16 value): exp(-1/2 (dx^2 o0 + dy^2 o1 + 2 dx dy o2)) in its
// order by expf, and rho of parity a at phase offset phi: the clipped
// residual r blended with the one at the neighbouring Bayer block (nb),
// clipped, + phi (fast_merge.merge_burst_raw_planes' parity_rho)
__device__ __forceinline__ float quad_exp(float dx, float dy, float3 o) {
  const float q = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(dx, dx), o.x), __fmul_rn(__fmul_rn(dy, dy), o.y)),
                            __fmul_rn(__fmul_rn(__fmul_rn(2.0f, dx), dy), o.z));
  return expf(__fmul_rn(-0.5f, q));
}
__device__ __forceinline__ float blend_rho(float r, float nb, float ga, float phi, float rb) {
  const float m = __fadd_rn(__fmul_rn(1.0f - ga, r), __fmul_rn(ga, nb));
  return __fadd_rn(fminf(fmaxf(m, -rb), rb), phi);
}

template <int V>
using IC = std::integral_constant<int, V>;
// a group index given as an IC<g> (a constant) or an int
template <int V>
__device__ __forceinline__ constexpr int group_of(IC<V>) {
  return V;
}
__device__ __forceinline__ int group_of(int g) { return g; }

// kForm: the form (0-3). kMode: form 0: 0 the templated arithmetic, 1 the
// plain version's (S >= 5); form 1: 0 float32, 1 bfloat16; form 3: the
// centroid, 0 compact rho, 1 its bfloat16 products, 2 block, 3 shared
// residual. kExact: forms 2 and 3, the weights at each parity's moment
// displacement.
template <int kForm, int kMode, bool kExact>
__global__ void __launch_bounds__(512, 1)
merge_raw_nonbayer_kernel(const float* __restrict__ planes, const float* __restrict__ residual,
                          const float* __restrict__ certainty, const float* __restrict__ omega,
                          const float* __restrict__ omega_rb, float* __restrict__ out,
                          const int4* __restrict__ table, int n_taps, int frames, int hh, int hw, int S,
                          float rb, const CellTable cells, const NbPlan plan) {
  constexpr bool kBf16 = kForm == 1 && kMode == 1;
  constexpr bool kCBf16 = kForm == 3 && kMode == 1;
  constexpr bool kList = kBf16 || kCBf16;           // the list's order
  constexpr bool kPlain = kForm == 0 && kMode == 1;  // the plain version's roundings
  constexpr bool kShared = kForm == 3 && kMode == 3;
  constexpr bool kBlock = kForm == 3 && kMode >= 2;
  constexpr int kZ = kForm >= 2 ? 2 : 4;  // parities a thread
  constexpr int kSlots = kForm <= 1 ? 2 : (kForm == 2 ? 9 : (kShared ? 6 : 4));
  // the parity-interpolated rho: the 9 moments, the exact weights, the
  // compact centroid
  constexpr bool kRho = kForm == 2 || kExact || (kForm == 3 && !kBlock);
  static_assert(kForm >= 0 && kForm <= 3 && (!kExact || kForm >= 2), "the forms and their knobs");

  const int tw = plan.tw, th = plan.th, hx = plan.hx;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ph_local = (int)threadIdx.z % plan.phases, half = (int)threadIdx.z / plan.phases;
  const int nthreads = tw * th * (int)blockDim.z;
  const int tid = ((int)threadIdx.z * th + ty) * tw + tx;
  const int zg = blockIdx.z;
  const int ph = plan.groups == 1 || ph_local == 0 ? ph_local : 1 + zg * (plan.phases - 1) + ph_local - 1;
  const bool stores = ph < S * S && (ph_local > 0 || zg == 0);
  const int py = min(ph, S * S - 1) / S, px = min(ph, S * S - 1) % S;
  const int i0 = blockIdx.y * th, j0 = blockIdx.x * tw;
  const int i = i0 + ty, j = j0 + tx;
  const long long plane = (long long)hh * hw;
  const long long pix = (long long)min(i, hh - 1) * hw + min(j, hw - 1);
  const float sf = (float)S;

  // the ring: slot b holds chunk x (4 planes x rows x sw sites) and chunk
  // x the residual's (th + 2) x (tw + 2) sites
  const int sw = tw + 2 * hx, sa = plan.rows * sw, rw = tw + 2, rs = (th + 2) * rw;
  const int slot_sz = plan.chunk * (4 * sa + rs);
  extern __shared__ float2 smem[];
  // forms 2 and 3: each thread's per-frame record of the step's chunk,
  // [chunk][2][thread] float4s after the ring, formed once a step
  float4* rec = reinterpret_cast<float4*>(smem + ((plan.slots * slot_sz + 1) & ~1));
  const int n_chunks = (frames + plan.chunk - 1) / plan.chunk;
  const int n_steps = plan.n_win * n_chunks;
  const int4* wins = table + n_taps;  // (t0, t1, dylo, dyhi): the rows' windows

  // a step (window w, chunk c): copies its frames' sites into slot b; the
  // thread's own sites, walked without a division: site = tid + n
  // nthreads, its (row, column) stepped by nthreads' (dr, dc)
  const int dr = nthreads / sw, dc = nthreads % sw, rdr = nthreads / rw, rdc = nthreads % rw;
  const auto stage = [&](int step, int b) {
    const int4 win = __ldg(wins + step / n_chunks);
    const int f0 = step % n_chunks * plan.chunk, nf = min(plan.chunk, frames - f0);
    const int sites = (th + win.w - win.z) * sw;
    float2* sv = smem + b * slot_sz;
    for (int site = tid, r = tid / sw, c = tid % sw; site < sites; site += nthreads) {
      const long long rc = (long long)min(max(i0 + win.z + r, 0), hh - 1) * hw + min(max(j0 - hx + c, 0), hw - 1);
      const float* pf = planes + (long long)f0 * 4 * plane + rc;
      const float* cf = certainty + ((long long)f0 * plane + rc) * 3;
      float2* d = sv + site;
      for (int fl = 0; fl < nf; ++fl, pf += 4 * plane, cf += 3 * plane, d += 4 * sa) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async4(&d[q * sa].x, pf + q * plane);
          cp_async4(&d[q * sa].y, cf + cells.chan[q]);
        }
      }
      r += dr;
      c += dc;
      if (c >= sw) c -= sw, ++r;
    }
    float2* sr = sv + plan.chunk * 4 * sa;
    for (int p = tid, r = tid / rw, c = tid % rw; p < rs; p += nthreads) {
      const long long rc = (long long)min(max(i0 - 1 + r, 0), hh - 1) * hw + min(max(j0 - 1 + c, 0), hw - 1);
      const float* rf = residual + ((long long)f0 * plane + rc) * 2;
      for (int fl = 0; fl < nf; ++fl, rf += 2 * plane) cp_async8(&sr[fl * rs + p], rf);
      r += rdr;
      c += rdc;
      if (c >= rw) c -= rw, ++r;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // once the thread's copies of step's slot b landed: value x certainty
  // (forms 0 and 1; bfloat16: both rounded) and the clipped residual
  const auto fix = [&](int step, int b) {
    const int4 win = __ldg(wins + step / n_chunks);
    const int nf = min(plan.chunk, frames - step % n_chunks * plan.chunk);
    const int sites = (th + win.w - win.z) * sw;
    float2* sv = smem + b * slot_sz;
    if constexpr (kForm <= 1) {
      for (int site = tid; site < sites; site += nthreads) {
        for (int e = site; e < nf * 4 * sa; e += sa) {
          if constexpr (kBf16) {
            sv[e] = __bfloat1622float2(__float22bfloat162_rn(sv[e]));
          } else {
            sv[e].x *= sv[e].y;
          }
        }
      }
    }
    float2* sr = sv + plan.chunk * 4 * sa;
    for (int p = tid; p < rs; p += nthreads) {
      for (int e = p; e < nf * rs; e += rs) {
        sr[e] = make_float2(fminf(fmaxf(sr[e].x, -rb), rb), fminf(fmaxf(sr[e].y, -rb), rb));
      }
    }
  };
  stage(0, 0);

  // phi[p] = (p + 0.5) / s - 0.5 in the f32 operations of
  // fast_merge._output_phase_offsets; phis = phi s
  const float phi_y = ((float)py + 0.5f) / sf - 0.5f, phi_x = ((float)px + 0.5f) / sf - 0.5f;
  const float phis_y = phi_y * sf, phis_x = phi_x * sf;
  // exp(q) = 2^(q log2 e): -1/2 log2(e) and the cross term's -log2(e)
  // folded into omega (the plain roundings read omega as it is)
  constexpr float kL = 1.4426950408889634f;  // log2(e)
  const float3 om_g = make_float3(omega[pix * 3], omega[pix * 3 + 1], omega[pix * 3 + 2]);
  const float3 om_rb = make_float3(omega_rb[pix * 3], omega_rb[pix * 3 + 1], omega_rb[pix * 3 + 2]);
  const float3 fg = make_float3(-0.5f * kL * om_g.x, -0.5f * kL * om_g.y, -kL * om_g.z);
  const float3 fr = make_float3(-0.5f * kL * om_rb.x, -0.5f * kL * om_rb.y, -kL * om_rb.z);
  // forms 2 and 3: the half's parity row a = half, its blend with the
  // row before (a = 0) or after (a = 1), and each parity column's with
  // the column before (b = 0) or after (b = 1), as the plain parity_rho
  const int a = kZ == 2 ? half : 0;
  const float ga_y = fabsf(((float)a + phi_y - 0.5f) / 2.0f);
  const float ga_x0 = fabsf((phi_x - 0.5f) / 2.0f), ga_x1 = fabsf((1.0f + phi_x - 0.5f) / 2.0f);
  const int my_res = (ty + 1) * rw + tx + 1, nb_y = my_res + (a ? rw : -rw);

  // the cells: [parity][channel][slot], the f32 forms; (b0, m00) pairs,
  // the bfloat16 order 0; form 0's chains (w, folded m01, folded m02)
  float acc[kZ][3][kSlots];
  __nv_bfloat162 accb[kZ][3];
  float chain[6][3];
  // a group's (the bfloat16 knobs: a tap's) sums, [parity][slot]
  float tsum[kZ][kSlots];
#pragma unroll
  for (int z = 0; z < kZ; ++z) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      accb[z][c] = __float2bfloat162_rn(0.0f);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) acc[z][c][k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) tsum[z][k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) chain[k][0] = chain[k][1] = chain[k][2] = 0.0f;

  // a group's (or a tap's) constants: each parity's plane z ^ g, its
  // channel, its weight family and its site offset from the tap's base
  struct Group {
    int ch[kZ], dz[kZ];
    bool green[kZ];
  };
  // each plane's channel in registers, picked by selects (an index into
  // the parameter would copy the table to local memory)
  const int chan0 = cells.chan[0], chan1 = cells.chan[1], chan2 = cells.chan[2], chan3 = cells.chan[3];
  const auto group = [&](int g) {
    Group gr;
#pragma unroll
    for (int zi = 0; zi < kZ; ++zi) {
      const int z = kZ == 2 ? 2 * a + zi : zi, q = z ^ g;
      gr.ch[zi] = q == 0 ? chan0 : (q == 1 ? chan1 : (q == 2 ? chan2 : chan3));
      gr.green[zi] = gr.ch[zi] == 1;
      gr.dz[zi] = q * sa + ((z >> 1) & (g >> 1)) * sw + ((z & 1) & (g & 1));
    }
    return gr;
  };
  // adds the group's (tap's) sums to their cells and clears them
  const auto flush = [&](const Group& gr) {
#pragma unroll
    for (int zi = 0; zi < kZ; ++zi) {
      // every channel's cell adds the sums or a zero (a select, not a
      // branch: the compiler turned the branches into an indexed array in
      // local memory)
      if constexpr (kBf16) {
        // each tap's sums rounded, then added in bfloat16 (the list's order)
        const __nv_bfloat162 sum = __floats2bfloat162_rn(tsum[zi][1], tsum[zi][0]);
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c) accb[zi][c] = __hadd2(accb[zi][c], gr.ch[zi] == c ? sum : zero);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int k = 0; k < kSlots; ++k) acc[zi][c][k] += gr.ch[zi] == c ? tsum[zi][k] : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) tsum[zi][k] = 0.0f;
    }
  };

  // tap t of group g (an IC<g> where g is the group loop's, an int in the
  // list's order) over the nf frames of slot sv: its terms into tsum
  const auto tap = [&](int t, auto gc, const Group& gr, const float2* sv, int nf, int site0) {
    const int g = group_of(gc);
    const int4 row = __ldg(table + t);
    const int kyi = row.x, kxi = row.y;
    const float ky = (float)kyi, kx = (float)kxi, sky = sf * ky, skx = sf * kx;
    // the pruned centroid: a tap outside it adds m00 and b0 alone
    const bool cen = row.z != 0;
    const int base = site0 + (kyi >> 1) * sw + (kxi >> 1);
    const float2* sr = sv + plan.chunk * 4 * sa;
    // form 0: this tap's frame sums of each chain, (w, ry w, rx w) for
    // the green and the R/B weights
    float cs[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    float3 omz[kZ];  // the exact weights' omega per parity
    if constexpr (kExact) {
#pragma unroll
      for (int zi = 0; zi < kZ; ++zi) omz[zi] = gr.green[zi] ? fg : fr;
    }
#pragma unroll 2
    for (int fl = 0; fl < nf; ++fl) {
      const float2* fsv = sv + fl * 4 * sa + base;
      const float2 res = kForm <= 1 ? sr[fl * rs + my_res] : float2{};
      float wg = 0.0f, wr = 0.0f;  // the block-centre weights
      if constexpr (kPlain) {
        const float dy = __fsub_rn(__fmul_rn(ky - res.x, sf), phis_y);
        const float dx = __fsub_rn(__fmul_rn(kx - res.y, sf), phis_x);
        const float dy2 = __fmul_rn(dy, dy);
        wg = gauss_plain(dx, dy, dy2, om_g);
        wr = gauss_plain(dx, dy, dy2, om_rb);
        cs[0][0] += wg;
        cs[0][1] = __fadd_rn(cs[0][1], __fmul_rn(res.x, wg));
        cs[0][2] = __fadd_rn(cs[0][2], __fmul_rn(res.y, wg));
        cs[1][0] += wr;
        cs[1][1] = __fadd_rn(cs[1][1], __fmul_rn(res.x, wr));
        cs[1][2] = __fadd_rn(cs[1][2], __fmul_rn(res.y, wr));
      } else if constexpr (kBf16) {
        const float dy = __fsub_rn(__fmul_rn(ky - res.x, sf), phis_y);
        const float dx = __fsub_rn(__fmul_rn(kx - res.y, sf), phis_x);
        wg = quad_exp(dx, dy, om_g);
        wr = quad_exp(dx, dy, om_rb);
      } else if constexpr (kForm <= 1) {
        const float dy = (ky - res.x) * sf - phis_y, dx = (kx - res.y) * sf - phis_x;
        const float dyy = dy * dy;
        wg = exp2_approx(fmaf(dx, fmaf(dx, fg.x, dy * fg.z), dyy * fg.y));
        wr = exp2_approx(fmaf(dx, fmaf(dx, fr.x, dy * fr.z), dyy * fr.y));
        if constexpr (kForm == 0) {
          cs[0][0] += wg;
          cs[0][1] += res.x * wg;
          cs[0][2] += res.y * wg;
          cs[1][0] += wr;
          cs[1][1] += res.x * wr;
          cs[1][2] += res.y * wr;
        }
      }
      if constexpr (kBf16) {
        const unsigned w2 = bf16x2_pack(wr, wg);
        wg = bf16x2_lo(w2);
        wr = bf16x2_hi(w2);
      }
      if constexpr (kForm <= 1) {
#pragma unroll
        for (int zi = 0; zi < kZ; ++zi) {
          const float2 vc = fsv[gr.dz[zi]];
          const float w = gr.green[zi] ? wg : wr;
          if constexpr (kBf16) {
            // (value, certainty) bfloat16: w c exact in f32, bf16(w c) v too
            const float wc = w * vc.y;
            tsum[zi][0] += wc;
            tsum[zi][1] = fmaf(bf16r(wc), vc.x, tsum[zi][1]);
          } else {
            // (value x certainty, certainty)
            tsum[zi][0] = fmaf(w, vc.y, tsum[zi][0]);
            tsum[zi][1] = fmaf(w, vc.x, tsum[zi][1]);
          }
        }
      } else {
        // the frame's record (ry, rx, S ry + S phi_y, S rx + S phi_x) and
        // (S rho_y, S rho_x for b = 0, 1; the bfloat16 centroid: rho)
        const float4 ra = rec[2 * fl * nthreads + tid], rc = rec[(2 * fl + 1) * nthreads + tid];
        const float ry = ra.x, rx = ra.y, sy = rc.x, sx[2] = {rc.y, rc.z};
        if constexpr (kCBf16 && !kExact) {
          const float dyw = __fsub_rn(__fmul_rn(ky - ry, sf), phis_y);
          const float dxw = __fsub_rn(__fmul_rn(kx - rx, sf), phis_x);
          wg = quad_exp(dxw, dyw, om_g);
          wr = quad_exp(dxw, dyw, om_rb);
        } else if constexpr (!kExact) {
          // the block-centre weights: dy = S ky - (S ry + S phi)
          const float dyw = sky - ra.z, dxw = skx - ra.w;
          wg = gauss(dxw, dyw, fg.x, fg.y, fg.z);
          wr = gauss(dxw, dyw, fr.x, fr.y, fr.z);
        }
        // the moments' displacements per parity row and column
        float my = 0.0f, mx[2] = {0.0f, 0.0f};
        if constexpr (kForm == 2 || (kForm == 3 && kMode == 0)) {
          my = sky - sy;
          mx[0] = skx - sx[0];
          mx[1] = skx - sx[1];
        } else if constexpr (kMode == 2) {
          my = sky - ra.z;
          mx[0] = mx[1] = skx - ra.w;
        } else if constexpr (kShared) {
          my = sky - phis_y;
          mx[0] = mx[1] = skx - phis_x;
        }
        if constexpr (kForm == 3) {
          if (!cen) my = mx[0] = mx[1] = 0.0f;
        }
#pragma unroll
        for (int zi = 0; zi < kZ; ++zi) {
          const float2 vc = fsv[gr.dz[zi]];  // (value, certainty)
          float w;
          if constexpr (kExact && kCBf16) {
            w = quad_exp(__fmul_rn(sf, __fsub_rn(kx, sx[zi])), __fmul_rn(sf, __fsub_rn(ky, sy)),
                         gr.green[zi] ? om_g : om_rb);
          } else if constexpr (kExact) {
            w = gauss(skx - sx[zi], sky - sy, omz[zi].x, omz[zi].y, omz[zi].z);
          } else {
            w = gr.green[zi] ? wg : wr;
          }
          const float wc = kCBf16 ? __fmul_rn(w, vc.y) : w * vc.y;
          if constexpr (kCBf16) {
            const float c = cen ? 1.0f : 0.0f;
            add_moments_cbf16(tsum[zi], wc, vc.x, c * sky, c * skx, -c * sf, bf16r(sy), bf16r(sx[zi]));
          } else if constexpr (kShared) {
            add_moments<6>(tsum[zi], wc, vc.x, my, mx[zi], cen ? ry : 0.0f, cen ? rx : 0.0f);
          } else {
            add_moments<kSlots>(tsum[zi], wc, vc.x, my, mx[zi]);
          }
        }
      }
    }
    if constexpr (kForm == 0) {
      // the tap's chain sums join the green chain of (ky + kx) % 2 and the
      // R/B chain of (ky % 2, kx % 2), constants of its group
      const int cid[2] = {(g >> 1) ^ (g & 1), 2 + g};
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        float* ch = chain[cid[f]];
        if constexpr (kPlain) {
          ch[0] = __fadd_rn(ch[0], cs[f][0]);
          ch[1] = __fadd_rn(ch[1], __fmul_rn(sf, __fsub_rn(__fmul_rn(ky - phi_y, cs[f][0]), cs[f][1])));
          ch[2] = __fadd_rn(ch[2], __fmul_rn(sf, __fsub_rn(__fmul_rn(kx - phi_x, cs[f][0]), cs[f][2])));
        } else {
          ch[0] += cs[f][0];
          ch[1] += sf * ((ky - phi_y) * cs[f][0] - cs[f][1]);
          ch[2] += sf * ((kx - phi_x) * cs[f][0] - cs[f][2]);
        }
      }
    }
  };

  // the steps: wait for the slot's copies, fix its own sites, publish
  // (and free the other slot for the next step's copies), accumulate
  int b = 0;
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    fix(step, b);
    __syncthreads();
    if (plan.slots == 2 && step + 1 < n_steps) stage(step + 1, b ^ 1);
    const int4 win = __ldg(wins + step / n_chunks);
    const int chunk_i = step % n_chunks;
    const int nf = min(plan.chunk, frames - chunk_i * plan.chunk);
    const float2* sv = smem + b * slot_sz;
    // the pixel's site in the window, at column hx of its row
    const int site0 = (ty - win.z) * sw + tx + hx;
    if constexpr (kForm >= 2) {
      // the residual's terms each tap of a frame reads: ry, rx, the weights'
      // origins S r + S phi, and the half's rho (its row's blend with the
      // row before or after, each column's with its neighbour) as S rho (the
      // bfloat16 centroid: rho, in the plain roundings)
      const float2* sr = sv + plan.chunk * 4 * sa;
      for (int fl = 0; fl < nf; ++fl) {
        const float2* rf = sr + fl * rs;
        const float ry = rf[my_res].x, rx = rf[my_res].y;
        float sy = 0.0f, sx0 = 0.0f, sx1 = 0.0f;
        if constexpr (kCBf16) {
          sy = blend_rho(ry, rf[nb_y].x, ga_y, phi_y, rb);
          sx0 = blend_rho(rx, rf[my_res - 1].y, ga_x0, phi_x, rb);
          sx1 = blend_rho(rx, rf[my_res + 1].y, ga_x1, phi_x, rb);
        } else if constexpr (kRho) {
          sy = sf * (fminf(fmaxf((1.0f - ga_y) * ry + ga_y * rf[nb_y].x, -rb), rb) + phi_y);
          sx0 = sf * (fminf(fmaxf((1.0f - ga_x0) * rx + ga_x0 * rf[my_res - 1].y, -rb), rb) + phi_x);
          sx1 = sf * (fminf(fmaxf((1.0f - ga_x1) * rx + ga_x1 * rf[my_res + 1].y, -rb), rb) + phi_x);
        }
        rec[2 * fl * nthreads + tid] = make_float4(ry, rx, fmaf(ry, sf, phis_y), fmaf(rx, sf, phis_x));
        rec[(2 * fl + 1) * nthreads + tid] = make_float4(sy, sx0, sx1, 0.0f);
      }
    }
    if constexpr (kList) {
#pragma unroll 1
      for (int t = win.x; t < win.y; ++t) {
        const int4 row = __ldg(table + t);
        const int g = 2 * (row.x & 1) + (row.y & 1);
        const Group gr = group(g);
        tap(t, g, gr, sv, nf, site0);
        // a tap's sums whole over the frames: added once its last chunk ran
        // (past one chunk the host's windows hold one tap each)
        if (chunk_i == n_chunks - 1) flush(gr);
      }
    } else {
      // group by group, the group a constant (a macro, not a generic
      // lambda calling the generic tap: nvcc has crashed on such nesting)
#define MFSR_NB_GROUP(G)                                                                          \
  {                                                                                               \
    const int ta = max(win.x, (G) ? plan.group_end[(G) - 1] : 0), tb = min(win.y, plan.group_end[G]); \
    if (ta < tb) {                                                                                \
      const Group gr = group(G);                                                                  \
      _Pragma("unroll 1") for (int t = ta; t < tb; ++t) tap(t, IC<G>{}, gr, sv, nf, site0);      \
      flush(gr);                                                                                  \
    }                                                                                             \
  }
      MFSR_NB_GROUP(0)
      MFSR_NB_GROUP(1)
      MFSR_NB_GROUP(2)
      MFSR_NB_GROUP(3)
#undef MFSR_NB_GROUP
    }
    if (step + 1 < n_steps) {
      if (plan.slots == 2) {
        b ^= 1;
      } else {
        __syncthreads();
        stage(step + 1, b);
      }
    }
  }

  if constexpr (kShared) {
    // the shared residual folded into m01 and m02 (fast_merge.py:811-831):
    // m01 -= S R0 / m00_0 m00, R0 and m00_0 the cell's residual sum and
    // weight sum at phase 0, passed from the thread holding phase 0
    // through the (now idle) ring. A cell no centroid tap reached has R0 =
    // 0 and keeps its zero m01, m02, as the JAX function skips it.
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    float* xs = reinterpret_cast<float*>(smem);
    const int np = tw * th, p = ty * tw + tx;
    if (ph_local == 0) {
#pragma unroll
      for (int zi = 0; zi < kZ; ++zi)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int k = 0; k < 3; ++k) xs[(((half * kZ + zi) * 3 + c) * 3 + k) * np + p] = acc[zi][c][k ? 3 + k : 0];
    }
    __syncthreads();
#pragma unroll
    for (int zi = 0; zi < kZ; ++zi)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* x0 = xs + ((half * kZ + zi) * 3 + c) * 3 * np + p;
        const float m0 = x0[0], r0y = x0[np], r0x = x0[2 * np];
        const float inv0 = m0 > 1e-8f ? 1.0f / fmaxf(m0, 1e-8f) : 0.0f;
        acc[zi][c][1] -= sf * r0y * inv0 * acc[zi][c][0];
        acc[zi][c][2] -= sf * r0x * inv0 * acc[zi][c][0];
      }
  }
  if (i >= hh || j >= hw || !stores) return;

  // outputs: (n_out, 2S, 2S, 3, hh, hw), phase index (a S + py, b S + px)
  const long long slot = 4LL * S * S * 3 * plane;
  const long long out_pix = (long long)i * hw + j;
#pragma unroll
  for (int zi = 0; zi < kZ; ++zi) {
    const int z = kZ == 2 ? 2 * a + zi : zi;
    const int row = (z >> 1) * S + py, col = (z & 1) * S + px;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* dst = out + (((long long)row * 2 * S + col) * 3 + c) * plane + out_pix;
      if constexpr (kForm == 0) {
        // the cell's chain by selects (compile-time indices: the chains stay
        // in registers); none: w = 0, so cy = cx = 0
        const int kc = cells.chain[3 * z + c];
        float w = 0.0f, n1 = 0.0f, n2 = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          w = k == kc ? chain[k][0] : w;
          n1 = k == kc ? chain[k][1] : n1;
          n2 = k == kc ? chain[k][2] : n2;
        }
        const float inv = w > 1e-8f ? 1.0f / fmaxf(w, 1e-8f) : 0.0f;
        const float cy = fminf(fmaxf(n1 * inv, -2.0f), 2.0f), cx = fminf(fmaxf(n2 * inv, -2.0f), 2.0f);
        dst[0] = acc[zi][c][0];
        dst[slot] = cy;
        dst[2 * slot] = cx;
        dst[3 * slot] = acc[zi][c][1];
      } else if constexpr (kBf16) {
        dst[0] = __low2float(accb[zi][c]);  // num
        dst[slot] = __high2float(accb[zi][c]);  // den
      } else if constexpr (kForm == 1) {
        dst[0] = acc[zi][c][1];
        dst[slot] = acc[zi][c][0];
      } else {
#pragma unroll
        for (int k = 0; k < (kForm == 2 ? 9 : 4); ++k) dst[k * slot] = acc[zi][c][k];
      }
    }
  }
}

template <int S, int kHalo>
size_t smem_bytes(int frames) {
  const size_t sites = (size_t)(Shape<S>::kTileH + 2 * kHalo) * (kTileW + 2 * kHalo);
  return (size_t)frames * (4 * sites + Shape<S>::kPix) * sizeof(float2);
}

template <int S>
int max_frames(int halo, int form) {
  // forms 2 and 3 stream frames through a ring: any number
  if (form == 2 || form == 3) return std::numeric_limits<int>::max();
  return (int)(227 * 1024 / (halo <= 1 ? smem_bytes<S, 1>(1) : smem_bytes<S, 2>(1)));
}

template <int S, int kSlots, bool kExact, bool kCBf16, bool kPrune>
int launch_cells(const void* planes, const void* residual, const void* certainty,
                 const void* omega, const void* omega_rb, void* out, int frames, int hh,
                 int hw, int halo, bool green_diag, float rb, bool block,
                 const TapTable& taps, cudaStream_t stream, const General& gen = General{},
                 const Block& blk = Block{}) {
  using L = CellShape<S, kSlots>;
  dim3 grid((hw + L::kTW - 1) / L::kTW, (hh + L::kTH - 1) / L::kTH);
  int threads = L::kThreads;
  size_t bytes = 0;
  if constexpr (S == 0) {
    // the host's block: the tile, the phases (padded to a warp's kPL;
    // every group's first one phase 0) covering the scale's, the bytes
    threads = (blk.phases + L::kPL - 1) / L::kPL * L::kTH * 32;
    if (blk.tw != L::kTW || blk.th != L::kTH || blk.phases < 1 || blk.groups < 1 || threads > L::kThreads ||
        1 + blk.groups * (blk.phases - 1) < gen.s * gen.s || blk.bytes < 1 || blk.bytes > kMaxSmem ||
        grid.y > 65535 || 2 * blk.groups > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    grid.z = 2 * blk.groups;
    bytes = blk.bytes;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(merge_raw_cells_kernel<S, kSlots, kExact, kCBf16, kPrune>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
  }
  merge_raw_cells_kernel<S, kSlots, kExact, kCBf16, kPrune><<<grid, threads, bytes, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega),
      static_cast<const float*>(omega_rb), static_cast<float*>(out), frames, hh, hw, halo, rb,
      green_diag ? 1 : 0, block ? 1 : 0, taps, gen);
  return (int)cudaGetLastError();
}

// The resident forms (every frame staged at once).
template <int S, int kHalo, bool kGreenDiag, bool kChains, bool kBf16>
int launch(const void* planes, const void* residual, const void* certainty,
           const void* omega, const void* omega_rb, void* m00, void* cy,
           void* cx, void* b0, int frames, int hh, int hw, float rb,
           const TapTable& taps, cudaStream_t stream) {
  using L = Shape<S>;
  const size_t bytes = smem_bytes<S, kHalo>(frames);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_raw_kernel<S, kHalo, kGreenDiag, kChains, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kTileW, L::kTileH, L::kZ * kPairThreads<S, kBf16>);
  const dim3 grid((hw + kTileW - 1) / kTileW, (hh + L::kTileH - 1) / L::kTileH, 1);
  merge_raw_kernel<S, kHalo, kGreenDiag, kChains, kBf16><<<grid, block, bytes, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega),
      static_cast<const float*>(omega_rb), static_cast<float*>(m00),
      static_cast<float*>(cy), static_cast<float*>(cx),
      static_cast<float*>(b0), frames, hh, hw, rb, taps, 0, General{});
  return (int)cudaGetLastError();
}

// The streamed forms: the ring of kStreamSlots slots of stream_chunk
// frames in dynamic shared memory.
template <int S, int kHalo, bool kGreenDiag, bool kChains>
int launch_stream(const void* planes, const void* residual, const void* certainty,
                  const void* omega, const void* omega_rb, void* m00, void* cy,
                  void* cx, void* b0, int frames, int hh, int hw, float rb,
                  const TapTable& taps, cudaStream_t stream) {
  using L = StreamShape<S, kChains>;
  constexpr int chunk = stream_chunk<S, kHalo, kChains>();
  constexpr int bytes = (int)(kStreamSlots * chunk * stream_frame_bytes<S, kHalo, kChains>());
  // the ring, which at the end holds the split groups' green sums
  constexpr size_t kExchange = L::kSplit ? 2 * 11 * L::kPX * L::kZB * L::kPix * sizeof(float) : 0;
  static_assert(chunk >= 1 && bytes <= kMaxSmem && (size_t)bytes >= kExchange, "the ring fits a block");
  static_assert(L::kMinBlocks * (bytes + 1024) <= kSmSmem, "the ring leaves room for kMinBlocks blocks an SM");
  const auto kernel = merge_raw_stream_kernel<S, kHalo, kGreenDiag, kChains>;
  if constexpr (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(L::kTW, L::kTileH, L::kZB * (L::kSplit ? 4 : 1));
  const dim3 grid((hw + L::kTW - 1) / L::kTW, (hh + L::kTileH - 1) / L::kTileH, L::kPhaseBlocks);
  kernel<<<grid, block, bytes, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega),
      static_cast<const float*>(omega_rb), static_cast<float*>(m00),
      static_cast<float*>(cy), static_cast<float*>(cx),
      static_cast<float*>(b0), frames, hh, hw, rb, taps, chunk);
  return (int)cudaGetLastError();
}

template <bool kGreenDiag, bool kChains, bool kBf16>
int launch_general(const void* planes, const void* residual, const void* certainty,
                   const void* omega, const void* omega_rb, void* m00, void* cy, void* cx, void* b0,
                   int frames, int hh, int hw, float rb, const TapTable& taps, const General& gen,
                   const Block& blk, cudaStream_t stream) {
  // the host's block: within Shape<0>'s threads and a block's 64 z, its
  // phase groups covering the scale's phases, a chunk of at least a frame
  if (blk.tw < 1 || blk.th < 1 || blk.phases < 1 || blk.phases > 64 ||
      blk.tw * blk.th * blk.phases > Shape<0>::kThreads || blk.phases * blk.groups < gen.s * gen.s ||
      blk.chunk < 1 || blk.bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(blk.tw, blk.th, blk.phases);
  const dim3 grid((hw + blk.tw - 1) / blk.tw, (hh + blk.th - 1) / blk.th, blk.groups);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (blk.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(merge_raw_kernel<0, 0, kGreenDiag, kChains, kBf16>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, blk.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  merge_raw_kernel<0, 0, kGreenDiag, kChains, kBf16><<<grid, block, blk.bytes, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega),
      static_cast<const float*>(omega_rb), static_cast<float*>(m00),
      static_cast<float*>(cy), static_cast<float*>(cx),
      static_cast<float*>(b0), frames, hh, hw, rb, taps, blk.chunk, gen);
  return (int)cudaGetLastError();
}

template <int S>
int launch_scale(int form, int flags, int halo, bool green_diag, const void* planes,
                 const void* residual, const void* certainty, const void* omega,
                 const void* omega_rb, void* out, int frames, int hh, int hw, float rb,
                 const TapTable& taps, cudaStream_t stream, const General& gen = General{},
                 const Block& blk = Block{}) {
  const bool exact = flags & kExactWeights, bf16 = flags & kBf16Flag;
  if (form == 2 || form == 3) {
    // the centroid is pruned where a group has taps outside it (form 3)
    bool prune = false;
    for (int g = 0; g < 4; ++g) prune = prune || taps.centroid_end[g] != taps.group_end[g];
#define MFSR_CELLS(K, E, B, P)                                                                       \
  launch_cells<S, K, E, B, P>(planes, residual, certainty, omega, omega_rb, out, frames, hh, hw, halo, \
                              green_diag, rb, (flags & kBlockFlag) != 0, taps, stream, gen, blk)
#define MFSR_PRUNE(K, E, B) (prune ? MFSR_CELLS(K, E, B, true) : MFSR_CELLS(K, E, B, false))
    if (form == 2) return exact ? MFSR_CELLS(9, true, false, false) : MFSR_CELLS(9, false, false, false);
    if (flags & kSharedFlag) return exact ? MFSR_PRUNE(6, true, false) : MFSR_PRUNE(6, false, false);
    if (bf16) return exact ? MFSR_PRUNE(4, true, true) : MFSR_PRUNE(4, false, true);
    return exact ? MFSR_PRUNE(4, true, false) : MFSR_PRUNE(4, false, false);
#undef MFSR_PRUNE
#undef MFSR_CELLS
  }
  // form 0's four outputs (m00, cy, cx, b0) one after another; form 1's
  // two (num, den) are its b0 and m00
  float* base = static_cast<float*>(out);
  const long long slot = (long long)4 * (S ? S : gen.s) * (S ? S : gen.s) * 3 * hh * hw;
  if constexpr (S == 0) {
    // the general form: one instantiation streams every length (one
    // chunk staged once)
    if (form == 0) {
      return green_diag ? launch_general<true, true, false>(planes, residual, certainty, omega, omega_rb, base,
                                                            base + slot, base + 2 * slot, base + 3 * slot, frames,
                                                            hh, hw, rb, taps, gen, blk, stream)
                        : launch_general<false, true, false>(planes, residual, certainty, omega, omega_rb, base,
                                                             base + slot, base + 2 * slot, base + 3 * slot, frames,
                                                             hh, hw, rb, taps, gen, blk, stream);
    }
    if (form != 1) return (int)cudaErrorInvalidValue;
#define MFSR_GENERAL(G, B)                                                                                   \
  launch_general<G, false, B>(planes, residual, certainty, omega, omega_rb, base + slot, nullptr, nullptr, \
                              base, frames, hh, hw, rb, taps, gen, blk, stream)
    if (bf16) return green_diag ? MFSR_GENERAL(true, true) : MFSR_GENERAL(false, true);
    return green_diag ? MFSR_GENERAL(true, false) : MFSR_GENERAL(false, false);
#undef MFSR_GENERAL
  } else {
    // past the frames that fit shared memory at once the float32 forms
    // stream (mfsr_merge_raw_stream)
    if (frames > max_frames<S>(halo, form) || (form != 0 && form != 1)) return (int)cudaErrorInvalidValue;
#define MFSR_LAUNCH(H, G, C, B, M00, CY, CX, B0)                                                   \
  launch<S, H, G, C, B>(planes, residual, certainty, omega, omega_rb, M00, CY, CX, B0, frames, hh, hw, \
                        rb, taps, stream)
#define MFSR_FORM(H, G)                                                                                 \
  (form == 0 ? MFSR_LAUNCH(H, G, true, false, base, base + slot, base + 2 * slot, base + 3 * slot) \
   : bf16    ? MFSR_LAUNCH(H, G, false, true, base + slot, nullptr, nullptr, base)              \
             : MFSR_LAUNCH(H, G, false, false, base + slot, nullptr, nullptr, base))
    if (halo == 1) return green_diag ? MFSR_FORM(1, true) : MFSR_FORM(1, false);
    return green_diag ? MFSR_FORM(2, true) : MFSR_FORM(2, false);
#undef MFSR_FORM
#undef MFSR_LAUNCH
  }
}

// The launch arguments every form checks: the residual's alignment (it
// is copied as float2), the sizes, the form and its flags.
bool check_launch(const void* residual, int frames, int hh, int hw, int form, int flags) {
  const int allowed[4] = {0, kBf16Flag, kExactWeights,
                          kExactWeights | kBf16Flag | kBlockFlag | kSharedFlag};
  return frames >= 1 && hh >= 1 && hw >= 1 && reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) == 0 &&
         form >= 0 && form <= 3 && !(flags & ~allowed[form]) &&
         !((flags & kBf16Flag) && (flags & (kBlockFlag | kSharedFlag)) && form == 3);
}

// Reads the host table (mfsr_merge_raw's): the channels (a Bayer
// pattern), the group ends, the centroid's ends and the staged halo of the
// rows; `templated` also fills the rows (taps within +-4) and the list
// order into the TapTable. False on a malformed table.
bool parse_table(const int* tab, int n_taps, bool templated, TapTable* taps, int* halo, bool* green_diag) {
  if (n_taps < 0) return false;
  for (int q = 0; q < 4; ++q) taps->chan[q] = tab[q];
  *green_diag = taps->chan[0] == 1 && taps->chan[3] == 1;
  const bool green_anti = taps->chan[1] == 1 && taps->chan[2] == 1;
  const int o0 = *green_diag ? 1 : 0, o1 = *green_diag ? 2 : 3;  // the R/B planes
  if (*green_diag == green_anti || taps->chan[o0] + taps->chan[o1] != 2 || taps->chan[o0] == 1) {
    return false;  // not a Bayer pattern
  }
  for (int g = 0; g < 4; ++g) {
    taps->group_end[g] = tab[4 + g];
    if (tab[4 + g] < (g ? tab[3 + g] : 0) || tab[4 + g] > n_taps) return false;
  }
  if (taps->group_end[3] != n_taps) return false;
  const int* rows = tab + 8;
  *halo = 1;
  std::vector<char> listed(n_taps, 0);
  std::vector<int> at(n_taps, 0);  // the sorted index of the list's n-th tap
  for (int g = 0; g < 4; ++g) taps->centroid_end[g] = taps->group_end[g];
  // the general form packs ky and kx into 16 bits each
  const int reach = templated ? 4 : 32767;
  for (int t = 0; t < n_taps; ++t) {
    const int ky = rows[3 * t], kx = rows[3 * t + 1], aux = rows[3 * t + 2];
    const int n = aux >> 1;
    if (ky < -reach || ky > reach || kx < -reach || kx > reach || aux < 0 || n >= n_taps || listed[n]) {
      return false;
    }
    const int g = 2 * (ky & 1) + (kx & 1);
    if (t < (g ? taps->group_end[g - 1] : 0) || t >= taps->group_end[g]) return false;
    // within a group the centroid's taps come first
    if (aux & 1) {
      if (taps->centroid_end[g] != taps->group_end[g]) return false;
    } else if (taps->centroid_end[g] == taps->group_end[g]) {
      taps->centroid_end[g] = t;
    }
    if (templated) {
      taps->ky[t] = (signed char)ky;
      taps->kx[t] = (signed char)kx;
      at[n] = t;
    }
    listed[n] = 1;
    for (int a = 0; a < 2; ++a) {
      *halo = std::max({*halo, std::abs((a + ky) >> 1), std::abs((a + kx) >> 1)});
    }
  }
  if (templated) {
    int m = 0;
    for (int pair = 0; pair < 2; ++pair) {
      for (int n = 0; n < n_taps; ++n) {
        const int t = at[n], g = 2 * (rows[3 * t] & 1) + (rows[3 * t + 1] & 1);
        if ((g == 1 || g == 2) == (pair == 1)) taps->order[m++] = (unsigned char)t;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Launches the RAW merge on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to the contiguous float32 arrays
// described above; out holds the form's outputs (2s, 2s, 3, hh, hw) one
// after another, each written in full, s = scale in 1..4, forms 0 and 1
// on at most mfsr_merge_raw_max_frames frames (more: mfsr_merge_raw_stream),
// forms 2 and 3 on any number: form 0 (m00,
// cy, cx, b0), form 1 (num, den), form 2 (m00, m01, m02, m11, m12, m22,
// b0, b1, b2), form 3 (m00, m01, m02, b0). table is a HOST int array: the channel of each
// plane q = 2*qa + qb (4, a Bayer pattern: green on one diagonal, R and B
// on the other), the end of each tap-parity group (4), then n_taps rows
// (ky, kx, aux) sorted by group g = 2*(ky%2) + (kx%2), aux = c + 2 n with
// c = 1 where the tap feeds the centroid moments (form 3's
// centroid_prune; 1 for every tap without it; within a group those with
// c = 1 first) and n its index in the tap list; taps within +-4. flags: kExactWeights (forms 2, 3), kBf16Flag (form 1: the
// bfloat16 order 0; form 3: bfloat16 centroid products, not with the
// block or shared centroid), kBlockFlag, kSharedFlag (form 3).
int mfsr_merge_raw(const void* planes, const void* residual,
                   const void* certainty, const void* omega,
                   const void* omega_rb, void* out, int frames, int hh, int hw,
                   int scale, int form, float rb, const void* table, int n_taps,
                   int flags, void* stream) {
  TapTable taps;
  int halo;
  bool green_diag;
  if (n_taps > kMaxTaps || !check_launch(residual, frames, hh, hw, form, flags) ||
      !parse_table(static_cast<const int*>(table), n_taps, true, &taps, &halo, &green_diag)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFSR_SCALE(S)                                                                           \
  launch_scale<S>(form, flags, halo, green_diag, planes, residual, certainty, omega, omega_rb, \
                  out, frames, hh, hw, rb, taps, s)
  switch (scale) {
    case 1: return MFSR_SCALE(1);
    case 2: return MFSR_SCALE(2);
    case 3: return MFSR_SCALE(3);
    case 4: return MFSR_SCALE(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MFSR_SCALE
}

// Launches the streamed form (merge_raw_stream_kernel) of the float32
// forms 0 and 1 on `stream` and returns cudaGetLastError(): mfsr_merge_raw's
// arguments (no flags), any number of frames, streamed through a ring of
// kStreamSlots slots of mfsr_merge_raw_stream_chunk frames.
int mfsr_merge_raw_stream(const void* planes, const void* residual, const void* certainty,
                          const void* omega, const void* omega_rb, void* out, int frames, int hh, int hw,
                          int scale, int form, float rb, const void* table, int n_taps, void* stream) {
  TapTable taps;
  int halo;
  bool green_diag;
  if (n_taps > kMaxTaps || (form != 0 && form != 1) || !check_launch(residual, frames, hh, hw, form, 0) ||
      !parse_table(static_cast<const int*>(table), n_taps, true, &taps, &halo, &green_diag)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* base = static_cast<float*>(out);
  const long long slot = (long long)4 * scale * scale * 3 * hh * hw;
#define MFSR_STREAM(S, H, G)                                                                                     \
  (form == 0 ? launch_stream<S, H, G, true>(planes, residual, certainty, omega, omega_rb, base, base + slot,    \
                                            base + 2 * slot, base + 3 * slot, frames, hh, hw, rb, taps, st)    \
             : launch_stream<S, H, G, false>(planes, residual, certainty, omega, omega_rb, base + slot, nullptr, \
                                             nullptr, base, frames, hh, hw, rb, taps, st))
#define MFSR_HALO(S) \
  (halo == 1 ? (green_diag ? MFSR_STREAM(S, 1, true) : MFSR_STREAM(S, 1, false)) \
             : (green_diag ? MFSR_STREAM(S, 2, true) : MFSR_STREAM(S, 2, false)))
  switch (scale) {
    case 1: return MFSR_HALO(1);
    case 2: return MFSR_HALO(2);
    case 3: return MFSR_HALO(3);
    case 4: return MFSR_HALO(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MFSR_HALO
#undef MFSR_STREAM
}

// Launches the general form (the S = 0 instantiations of merge_raw_kernel,
// streamed, and of merge_raw_cells_kernel) on `stream` and returns
// cudaGetLastError(). The arrays, out, flags and the HOST table are
// mfsr_merge_raw's (a Bayer pattern), at any scale >= 1, any number of
// frames and taps at any offset; rows is a DEVICE copy of the table's
// n_taps (ky, kx, aux) rows (table + 8). The block (tile_w x tile_h
// pixels x `phases` phases in `groups` over grid z, `chunk` frames staged
// at once by forms 0 and 1, smem_bytes of dynamic shared memory) is
// kernels/merge_raw.py::general_block's; a block the form cannot take
// (past its threads, short of the scale's phases, past kMaxSmem) is
// refused.
int mfsr_merge_raw_general(const void* planes, const void* residual, const void* certainty,
                           const void* omega, const void* omega_rb, void* out, int frames, int hh,
                           int hw, int scale, int form, float rb, const void* table, const void* rows,
                           int n_taps, int flags, int tile_w, int tile_h, int phases, int groups, int chunk,
                           int smem_bytes, void* stream) {
  TapTable taps;
  int halo;
  bool green_diag;
  if (scale < 1 || !check_launch(residual, frames, hh, hw, form, flags) ||
      !parse_table(static_cast<const int*>(table), n_taps, false, &taps, &halo, &green_diag)) {
    return (int)cudaErrorInvalidValue;
  }
  const General gen{scale, halo, phases, static_cast<const int*>(rows)};
  const Block blk{tile_w, tile_h, phases, groups, chunk, smem_bytes};
  return launch_scale<0>(form, flags, halo, green_diag, planes, residual, certainty, omega, omega_rb, out, frames,
                         hh, hw, rb, taps, static_cast<cudaStream_t>(stream), gen, blk);
}

// Launches the non-Bayer form (merge_raw_nonbayer_kernel) on `stream` and
// returns cudaGetLastError(). The arrays, out and flags are
// mfsr_merge_raw's, at any scale >= 1 and any number of frames. table is
// a DEVICE int32 array of n_taps rows (ky, kx, c, 0), c = 1 where the tap
// feeds the per-cell centroid (form 3's centroid_prune; 1 for every tap
// without it), in the list's order for the bfloat16 knobs (form 1's
// bfloat16 order 0, form 3's centroid_bf16) and else sorted by tap-parity
// group, then n_win rows (t0, t1, dylo, dyhi): the windows, each a run of
// rows whose staged rows (dylo, dyhi the least (a + ky) // 2 and the most)
// the plan's take. cells is a HOST int array: the channel (0..2) of each
// plane q = 2*qa + qb (4, any pattern), then the certless chain of each
// cell (a, b, ch) at 3 (2a + b) + ch (12; 0, 1 green by (ky + kx) % 2,
// 2 + 2 (ky % 2) + kx % 2 R/B, -1 none). plan is a HOST int array of
// kernels/merge_raw.py::nonbayer_plan: tile_w, tile_h, phases, groups, hx,
// rows, chunk, slots, n_win, smem_bytes and the table's four group ends;
// a plan the kernel cannot take is refused.
int mfsr_merge_raw_nonbayer(const void* planes, const void* residual, const void* certainty,
                            const void* omega, const void* omega_rb, void* out, int frames, int hh,
                            int hw, int scale, int form, float rb, const void* table, int n_taps,
                            const void* cells, const void* plan_tab, int flags, void* stream) {
  if (n_taps < 0 || frames < 1 || hh < 1 || hw < 1 || scale < 1 ||
      reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0 ||
      reinterpret_cast<std::uintptr_t>(table) % sizeof(int4) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int allowed[4] = {0, kBf16Flag, kExactWeights,
                          kExactWeights | kBf16Flag | kBlockFlag | kSharedFlag};
  if (form < 0 || form > 3 || (flags & ~allowed[form])) return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(cells);
  CellTable ct;
  for (int q = 0; q < 4; ++q) {
    ct.chan[q] = tab[q];
    if (tab[q] < 0 || tab[q] > 2) return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < 12; ++k) {
    ct.chain[k] = tab[4 + k];
    if (tab[4 + k] < -1 || tab[4 + k] > 5) return (int)cudaErrorInvalidValue;
  }
  const int* pt = static_cast<const int*>(plan_tab);
  NbPlan plan{pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], pt[6], pt[7], pt[8], pt[9], {pt[10], pt[11], pt[12], pt[13]}};
  const int halves = form >= 2 ? 2 : 1;
  const long long threads = (long long)plan.tw * plan.th * plan.phases * halves;
  const int grid_y = (hh + std::max(plan.th, 1) - 1) / std::max(plan.th, 1);
  if (plan.tw < 1 || plan.th < 1 || plan.phases < 1 || plan.groups < 1 || threads > 512 || plan.phases * halves > 64 ||
      (plan.groups == 1 ? plan.phases < scale * scale
                        : 1 + (long long)plan.groups * (plan.phases - 1) < (long long)scale * scale) ||
      plan.hx < 1 || plan.rows < plan.th || plan.chunk < 1 || (plan.slots != 1 && plan.slots != 2) ||
      plan.n_win < 1 || plan.bytes < 1 || plan.bytes > kMaxSmem || grid_y > 65535 || plan.groups > 65535 ||
      ((long long)plan.slots * plan.chunk * (4LL * plan.rows * (plan.tw + 2 * plan.hx) + (plan.th + 2) * (plan.tw + 2)) *
               (long long)sizeof(float2) + 15) / 16 * 16 +
              (form >= 2 ? (long long)plan.chunk * 2 * sizeof(float4) * threads : 0) > plan.bytes ||
      plan.group_end[3] != n_taps) {
    return (int)cudaErrorInvalidValue;
  }
  const bool exact = flags & kExactWeights, bf16 = flags & kBf16Flag;
  const bool shared = flags & kSharedFlag, block = (flags & kBlockFlag) || shared;
  const dim3 grid((hw + plan.tw - 1) / plan.tw, grid_y, plan.groups);
  const dim3 blk(plan.tw, plan.th, plan.phases * halves);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto kernel) {
    if (plan.bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, blk, plan.bytes, st>>>(
        static_cast<const float*>(planes), static_cast<const float*>(residual), static_cast<const float*>(certainty),
        static_cast<const float*>(omega), static_cast<const float*>(omega_rb), static_cast<float*>(out),
        static_cast<const int4*>(table), n_taps, frames, hh, hw, scale, rb, ct, plan);
    return (int)cudaGetLastError();
  };
  switch (form) {
    case 0: return scale >= 5 ? run(merge_raw_nonbayer_kernel<0, 1, false>) : run(merge_raw_nonbayer_kernel<0, 0, false>);
    case 1: return bf16 ? run(merge_raw_nonbayer_kernel<1, 1, false>) : run(merge_raw_nonbayer_kernel<1, 0, false>);
    case 2: return exact ? run(merge_raw_nonbayer_kernel<2, 0, true>) : run(merge_raw_nonbayer_kernel<2, 0, false>);
    default: {
      const int mode = shared ? 3 : (block ? 2 : (bf16 ? 1 : 0));
#define MFSR_NB3(M) (exact ? run(merge_raw_nonbayer_kernel<3, M, true>) : run(merge_raw_nonbayer_kernel<3, M, false>))
      switch (mode) {
        case 0: return MFSR_NB3(0);
        case 1: return MFSR_NB3(1);
        case 2: return MFSR_NB3(2);
        default: return MFSR_NB3(3);
      }
#undef MFSR_NB3
    }
  }
}

// The most frames a launch of the form stages at once at the given scale
// (1..4) with taps of the given halo (1 or 2): forms 0 and 1 stage every
// frame's tile at once, which must fit a block's shared memory (past it
// their float32 forms run mfsr_merge_raw_stream; the bfloat16 order 0
// the general form); forms 2 and 3 stream frames through a ring
// (INT_MAX). 0 for another scale.
int mfsr_merge_raw_max_frames(int scale, int halo, int form) {
  switch (scale) {
    case 1: return max_frames<1>(halo, form);
    case 2: return max_frames<2>(halo, form);
    case 3: return max_frames<3>(halo, form);
    case 4: return max_frames<4>(halo, form);
    default: return 0;
  }
}

// The frames in each slot of the streamed kernel's ring at `scale` (1..4)
// with taps of the given halo (1 or 2), for form 0 (certless) or 1
// (order 0); 0 for another scale, halo or form.
int mfsr_merge_raw_stream_chunk(int scale, int halo, int form) {
  if ((halo != 1 && halo != 2) || (form != 0 && form != 1)) return 0;
#define MFSR_CHUNK(S)                                                                   \
  (halo == 1 ? (form == 0 ? stream_chunk<S, 1, true>() : stream_chunk<S, 1, false>()) \
             : (form == 0 ? stream_chunk<S, 2, true>() : stream_chunk<S, 2, false>()))
  switch (scale) {
    case 1: return MFSR_CHUNK(1);
    case 2: return MFSR_CHUNK(2);
    case 3: return MFSR_CHUNK(3);
    case 4: return MFSR_CHUNK(4);
    default: return 0;
  }
#undef MFSR_CHUNK
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
