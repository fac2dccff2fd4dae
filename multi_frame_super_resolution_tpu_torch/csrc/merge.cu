// Static-tap kernel-regression merge for Hopper (sm_90a), RGB: the
// templated kernel (scales 1-4, taps within +-25), described first; its
// general form (S = 0: any scale, taps within +-34) after it; and the
// unstaged kernel for taps past any staged tile, described last.
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
// Form 3 (9 moments): 27 accumulators per phase. A thread holds one
// phase (a thread per pixel and phase, 27 accumulators at every scale;
// 27 s per phase row would need ~200 registers at s = 4), and a block is
// 32 pixels x kTileH rows x s^2 phases: 32 x 8 at s = 1, 32 x 2 x 4 at
// s = 2 (256 threads), 32 x 1 x 9 (288) at s = 3 and 32 x 1 x 16 (512)
// at s = 4, where one pixel row stages 3-5 rows of halo. Per item it
// forms w dy, w dx and their three products once and adds nine FMAs per
// channel. Its bound at chip_smoke.py's check (F=5, 256 x 512, s=2, the
// 21 taps at e^-1.5): 56.6 MB of moments written and 22.5 MB read
// (23.6 us at 3.35 TB/s) against 55 M items at 67.25 flops (3.7 GFLOP,
// 55 us at 67 TFLOP/s): the operations bind. Its moments are checked at
// rtol/atol 1e-4, as form 2's. Measured (chip_smoke.py; NVIDIA H100 80GB
// HBM3, 700.00 W): 88, 92, 86 and 88 registers at s = 1-4, no spills;
// its times against their bounds in PERF.md.
//
// Form 4 (bfloat16) is form 1's thread and loop in the JAX function's
// rounding order: the staged sites are rounded to bfloat16 instead of
// multiplied (w c must round before it meets the value), and per phase
// and channel a thread keeps the frame's (num, den) sums as one
// __nv_bfloat162 beside form 1's f32 accumulators, which take them at the
// end of each frame. Per item and channel: w c by __hmul_rn, then (v, 1)
// x (w c, w c) by __hmul2_rn and the add by __hadd2, each rounded to
// bfloat16 as the JAX function rounds its products and sums, jitted or
// not (the _rn forms keep the compiler from fusing a product into the
// add, which would round once where JAX rounds twice). The taps run
// in the list's order, so a frame's bfloat16 sums are the JAX function's
// up to the rare weight that ex2.approx and the plain version's exp round
// to neighbouring bfloat16 values. Two blocks an SM at s <= 2 (the
// bfloat16 sums take 12 more registers), one above.
//
// Wide taps on the templated layouts: the staged halo is the taps' reach,
// up to kMaxRadius = 25, where two frame buffers of the widest tile (8 +
// 50 rows of 32 + 50 sites, 48 B a site) take 228,288 of the 232,448
// bytes a block may opt in to. At tap radius 11 (529 taps, s = 2) they
// take 77.8 KB, two blocks an SM.
//
// The general form (S = 0, merge_fast_kernel<0, form>): scales past 4,
// and taps reaching past 25 at any scale, up to kMaxGeneralHalo = 34
// (where one staged site a block still fits). It is the kernel above
// with the scale at run time and a thread per (input pixel, output
// phase) in every form (kRows = kCols = 1: 6, 12, 27 or 6 + 3 bfloat16x2
// accumulators a thread, the form a template parameter), in a flat block
// of tw x th pixels x `rows` phase rows (Geometry, from
// kernels/merge.py::general_tile): 8 x 1 pixels x all 5 phase rows at
// s = 5, 200 threads, several blocks an SM; grid z walks the groups of
// phase rows past the form's thread bound (1024; form 3, 512), each
// group restaging the tile (s = 6-8: two groups). A warp holds 8 pixels
// at 4 phases, so a tap's two shared loads read 8 sites, each broadcast
// to 4 lanes (one wavefront each; a warp of 32 pixels of one phase took
// six, and measured slower). Staging (cp.async, double-buffered,
// edge-clamped), the run table, the exponent (-1/2 log2(e) folded into
// omega, two FMAs and ex2.approx), the accumulation and the rounding are
// the templated kernel's, so it matches the plain version within the
// same tolerances; form 0 parks each output array's rows of the block's
// phase rows in shared memory and stores whole rows.
// Bound at chip_smoke.py's check (F=5, 256 x 512, s=5, 25 taps at
// e^-1.5): 410 M (frame, pixel, tap, phase) items at 16.3 flops and one
// exp (WORK): 105.6 us of operations; order 1 191.2 us, 9 slots 393.0
// us, bfloat16 98.0 us. Staged bytes: a block stages (1 + 2 halo) x (8 +
// 2 halo) sites of 24 B a frame for its 8 pixels' 192 B of values and
// certainties, 7.5x the input bytes at halo 2 (118 MB from L2 over the
// call, against 15.7 MB of values and certainties read once).
// Measured (tools/ab_main_kernels.py; NVIDIA H100 80GB HBM3, 700.00
// W): ptxas 54, 56, 62, 77 and 52 registers for forms 0-4, no spills; at
// s = 5 the phase layout takes 0.462 ms (22.7% of its bound, 3.0x under
// the first general kernel), 9 slots 1.007 (39.0%, 1.9x); tap radius 11
// on the templated layout 0.706 (59.3%, 6.8x); all times in PERF.md.

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
// the general form's largest staged halo: one site a block (1 + 2 x 34)^2 x 48 B
constexpr int kMaxGeneralHalo = 34;

constexpr int kMaxRuns = 2 * kMaxGeneralHalo + 1;  // _active_taps gives one run per tap row

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
  static constexpr int kCols = kForm == 3 || S == 0 ? 1 : S;   // phase columns a thread holds
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
                                            : (kBf16 ? (S <= 2 ? 2 : 1) : (S <= 2 ? 4 : (S == 3 ? 2 : 1)));
};

// The general form's block (S = 0): tw x th pixels x `rows` phase rows of
// the scale s, one thread each, flat (threadIdx.x); grid z walks the
// groups of `rows` phase rows.
struct Geometry {
  int s, tw, th, rows;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
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

// The general form's launch: geo's block (its threads within the form's
// bound), grid z over the groups of phase rows, and the host's shared
// bytes (kernels/merge.py::general_tile: two frame buffers of the staged
// tile, or form 0's parked output rows) within kMaxSmem.
template <int kForm>
int launch_general(const float* warped, const float* residual, const float* certainty,
                   const float* omega, float* out, int frames, int h, int w, int halo,
                   float rb, const Taps& taps, const Geometry& geo, int bytes, cudaStream_t stream) {
  using L = Layout<0, kForm>;
  const int threads = geo.tw * geo.th * geo.rows * geo.s;
  if (geo.tw < 1 || geo.th < 1 || geo.rows < 1 || geo.rows > geo.s || threads > L::kThreads || bytes < 1 ||
      bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + geo.tw - 1) / geo.tw, (h + geo.th - 1) / geo.th, (geo.s + geo.rows - 1) / geo.rows);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_fast_kernel<0, kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  merge_fast_kernel<0, kForm><<<grid, threads, bytes, stream>>>(
      warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, geo);
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
    case 4: return launch<S, 4>(warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The unstaged form (merge_fast_unstaged_kernel): the taps past the
// general form's largest staged halo (kMaxGeneralHalo = 34, where not one
// staged site a block fits two frame buffers in shared memory). Written
// as the plain version reads: a thread per (input pixel, output phase)
// holds the phase's slots for the three channels; per frame it walks the
// taps in the list's order, reading value and certainty straight from
// device memory, sums the frame's terms and then adds the frame's sums to
// its totals, the weight by IEEE expf and each product and sum rounded
// where the plain version rounds it (round-to-nearest intrinsics, no
// FMAs; form 4 rounds each bfloat16 product and sum). Its time against
// its bound is in PERF.md.

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(256)
merge_fast_unstaged_kernel(const float* __restrict__ warped, const float* __restrict__ residual,
                          const float* __restrict__ certainty, const float* __restrict__ omega,
                          float* __restrict__ out, const int* __restrict__ taps, int n_taps,
                          int frames, int h, int w, int S, int form, float rb) {
  const int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 8 + threadIdx.y;
  if (y >= h || x >= w) return;  // no barrier below
  const int py = blockIdx.z / S, px = blockIdx.z % S;
  const long long plane = (long long)h * w, pix = (long long)y * w + x;
  const float sf = (float)S;
  const float phis_y = (((float)py + 0.5f) / sf - 0.5f) * sf;
  const float phis_x = (((float)px + 0.5f) / sf - 0.5f) * sf;
  const float o0 = omega[pix * 3], o1 = omega[pix * 3 + 1], o2 = omega[pix * 3 + 2];
  const int n_out = form == 2 ? 4 : (form == 3 ? 9 : 2);
  const float2* res2 = reinterpret_cast<const float2*>(residual);

  float tot[9][3];
#pragma unroll
  for (int k = 0; k < 9; ++k) tot[k][0] = tot[k][1] = tot[k][2] = 0.0f;
#pragma unroll 1
  for (int f = 0; f < frames; ++f) {
    const float2 rr = res2[f * plane + pix];
    const float ry = fminf(fmaxf(rr.x, -rb), rb), rx = fminf(fmaxf(rr.y, -rb), rb);
    float fs[9][3];
#pragma unroll
    for (int k = 0; k < 9; ++k) fs[k][0] = fs[k][1] = fs[k][2] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < n_taps; ++t) {
      const int ky = taps[2 * t], kx = taps[2 * t + 1];
      const long long g = ((long long)f * plane + (long long)min(max(y + ky, 0), h - 1) * w +
                           min(max(x + kx, 0), w - 1)) * 3;
      // dy = (ky - ry) s - phi s, dx likewise;
      // w = exp(-1/2 (dx^2 Oxx + dy^2 Oyy + 2 dx dy Oxy))
      const float dy = __fsub_rn(__fmul_rn(__fsub_rn((float)ky, ry), sf), phis_y);
      const float dx = __fsub_rn(__fmul_rn(__fsub_rn((float)kx, rx), sf), phis_x);
      const float q = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(dx, dx), o0), __fmul_rn(__fmul_rn(dy, dy), o1)),
                                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, dx), dy), o2));
      const float wgt = expf(__fmul_rn(-0.5f, q));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = warped[g + c], cert = certainty[g + c];
        if (form == 4) {
          // bfloat16 values, certainties, weight, products and sums
          const float cw = bf16r(__fmul_rn(bf16r(wgt), bf16r(cert)));
          fs[0][c] = bf16r(__fadd_rn(fs[0][c], bf16r(__fmul_rn(bf16r(v), cw))));
          fs[1][c] = bf16r(__fadd_rn(fs[1][c], cw));
          continue;
        }
        const float cw = __fmul_rn(wgt, cert), cwv = __fmul_rn(v, cw);
        if (form == 2) {
          fs[0][c] = __fadd_rn(fs[0][c], cw);
          fs[1][c] = __fadd_rn(fs[1][c], __fmul_rn(cw, dy));
          fs[2][c] = __fadd_rn(fs[2][c], __fmul_rn(cw, dx));
          fs[3][c] = __fadd_rn(fs[3][c], cwv);
        } else if (form == 3) {
          const float cwdy = __fmul_rn(cw, dy), cwdx = __fmul_rn(cw, dx);
          const float terms[9] = {cw, cwdy, cwdx, __fmul_rn(cwdy, dy), __fmul_rn(cwdy, dx), __fmul_rn(cwdx, dx),
                                  cwv, __fmul_rn(cwv, dy), __fmul_rn(cwv, dx)};
#pragma unroll
          for (int k = 0; k < 9; ++k) fs[k][c] = __fadd_rn(fs[k][c], terms[k]);
        } else {
          fs[0][c] = __fadd_rn(fs[0][c], cwv);
          fs[1][c] = __fadd_rn(fs[1][c], cw);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) tot[k][c] = __fadd_rn(tot[k][c], fs[k][c]);
  }

  const long long slot = (long long)S * S * 3 * plane;  // floats of one output array
  const long long at = form == 0
      ? (((long long)S * y + py) * ((long long)w * S) + (long long)S * x + px) * 3  // (sH, sW, 3)
      : (long long)(py * S + px) * 3 * plane + pix;                                  // (s, s, 3, H, W)
  const long long step = form == 0 ? 1 : plane;  // from one channel to the next
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k >= n_out) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[k * slot + at + c * step] = tot[k][c];
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

// Launches the general form (merge_fast_kernel<0, form>) on `stream` and
// returns cudaGetLastError(). The arrays, out, forms and taps_yx are
// mfsr_merge_fast's, at any scale >= 1 and taps within
// +-kMaxGeneralHalo; the block is tile_w x tile_h pixels x `rows` phase
// rows, grid z the groups of rows, with smem_bytes of dynamic shared
// memory (kernels/merge.py::general_tile's block and bytes).
int mfsr_merge_fast_general(const void* warped, const void* residual, const void* certainty,
                            const void* omega, void* out, int frames, int h, int w, int scale,
                            int form, const void* taps_yx, int n_taps, float rb, int tile_w,
                            int tile_h, int rows, int smem_bytes, void* stream) {
  if (frames < 1 || h < 1 || w < 1 || scale < 1 || reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* yx = static_cast<const int*>(taps_yx);
  const int halo = tap_halo(yx, n_taps);
  Taps taps;
  if (halo < 0 || halo > kMaxGeneralHalo || tile_w < 1 || !build_runs(yx, n_taps, scale, tile_w + 2 * halo, &taps)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry geo{scale, tile_w, tile_h, rows};
  const float* a = static_cast<const float*>(warped);
  const float* r = static_cast<const float*>(residual);
  const float* c = static_cast<const float*>(certainty);
  const float* o = static_cast<const float*>(omega);
  float* outs = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch_general<0>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, st);
    case 1: return launch_general<1>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, st);
    case 2: return launch_general<2>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, st);
    case 3: return launch_general<3>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, st);
    case 4: return launch_general<4>(a, r, c, o, outs, frames, h, w, halo, rb, taps, geo, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the unstaged form (merge_fast_unstaged_kernel) on `stream` and
// returns cudaGetLastError(). The arrays, out and forms are
// mfsr_merge_fast's, at any scale >= 1; taps is a DEVICE int32 array of
// n_taps (ky, kx) rows, any offsets, in the list's order.
int mfsr_merge_fast_unstaged(const void* warped, const void* residual, const void* certainty,
                             const void* omega, void* out, int frames, int h, int w, int scale,
                             int form, const void* taps, int n_taps, float rb, void* stream) {
  if (n_taps < 0 || frames < 1 || h < 1 || w < 1 || scale < 1 || (long long)scale * scale > 65535 ||
      (h + 7) / 8 > 65535 || form < 0 || form > 4 ||
      reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + 31) / 32, (h + 7) / 8, scale * scale);
  merge_fast_unstaged_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(warped), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega), static_cast<float*>(out),
      static_cast<const int*>(taps), n_taps, frames, h, w, scale, form, rb);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
