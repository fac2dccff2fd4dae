// Static-tap kernel-regression merge for Hopper (sm_90a), RGB: the
// templated kernel (scales 1-4, tap radius up to 8), described first, and
// the general form for every other scale and radius, described last.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kMaxRadius = 8;
constexpr int kMaxTaps = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr int kTileW = 32;  // input columns of a block (one warp)

constexpr int kMaxRuns = 64;  // _active_taps gives one run per tap row, at most 17

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
template <int S, int kForm>
struct Layout {
  static constexpr bool kBf16 = kForm == 4;
  static constexpr bool kOrder1 = kForm == 2 || kForm == 3;
  static constexpr bool kPhase = kForm >= 1;  // the phase layout
  static constexpr int kSlots = kForm == 3 ? 9 : (kOrder1 ? 4 : 2);
  static constexpr int kRows = kOrder1 ? 1 : S;      // phase rows a thread holds
  static constexpr int kCols = kForm == 3 ? 1 : S;   // phase columns a thread holds
  static constexpr int kColGroups = S / kCols;       // threads a phase row
  static constexpr int kZ = (S / kRows) * kColGroups;  // threads a pixel
  static constexpr int kTileH = kForm == 3 ? (S == 1 ? 8 : (S == 2 ? 2 : 1))
                                           : (kOrder1 ? (S == 1 ? 8 : (S == 2 ? 4 : 2)) : 8);
  static constexpr int kThreads = kTileW * kTileH * kZ;
  // blocks an SM the launch bound asks for: order 0's s^2 * 6 accumulators
  // grow with s (at s <= 2 four blocks, 64 registers a thread, hold the
  // 256 x 512 check in one wave); form 2's 12 s and form 3's 27 stay
  // under 128 registers (form 3 at s = 4: one block of 512 threads)
  static constexpr int kMinBlocks = kOrder1 ? (kThreads > 288 ? 1 : 2)
                                            : (kBf16 ? (S <= 2 ? 2 : 1) : (S <= 2 ? 4 : (S == 3 ? 2 : 1)));
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
                                            int sw, int sites, int tid) {
  for (int s = tid; s < sites; s += kThreads) {
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

template <int S, int kForm>
__global__ void __launch_bounds__(Layout<S, kForm>::kThreads, Layout<S, kForm>::kMinBlocks)
merge_fast_kernel(const float* __restrict__ warped,
                  const float* __restrict__ residual,
                  const float* __restrict__ certainty,
                  const float* __restrict__ omega,
                  float* __restrict__ out,
                  int frames, int h, int w, int halo, float rb,
                  const Taps taps) {
  using L = Layout<S, kForm>;
  constexpr bool kOrder1 = L::kOrder1;
  constexpr int R = L::kRows, C = L::kCols;
  // two frame buffers: float4 sites [2][sites], then float2 sites [2][sites]
  extern __shared__ float4 smem[];
  const int sw = kTileW + 2 * halo;
  const int sites = (L::kTileH + 2 * halo) * sw;
  float2* smem2 = reinterpret_cast<float2*>(smem + 2 * sites);

  // the thread's first phase row and column; order 0's blocks are flat,
  // so both are the constant 0 there (its phis fold into constants), and
  // form 2's first column is 0
  const int z = L::kZ == 1 ? 0 : (int)threadIdx.z;
  const int row0 = (z / L::kColGroups) * R;
  const int col0 = (z % L::kColGroups) * C;
  const int tid = (z * L::kTileH + threadIdx.y) * kTileW + threadIdx.x;
  const int y0 = blockIdx.y * L::kTileH, x0 = blockIdx.x * kTileW;
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  const bool inside = y < h && x < w;
  const long long plane = (long long)h * w;
  const long long pix = (long long)min(y, h - 1) * w + min(x, w - 1);
  const int my_site = (threadIdx.y + halo) * sw + threadIdx.x + halo;

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
  for (int p = 0; p < C; ++p) phis[p] = (((float)(col0 + p) + 0.5f) / (float)S - 0.5f) * (float)S;
#pragma unroll
  for (int p = 0; p < R; ++p) phis_y[p] = (((float)(row0 + p) + 0.5f) / (float)S - 0.5f) * (float)S;

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
  stage_frame<L::kThreads>(warped, certainty, smem, smem2, 0, y0, x0, h, w, halo, sw, sites, tid);
  for (int f = 0; f < frames; ++f) {
    const float2 r = res[f * plane];
    float4* a = smem + (f & 1) * sites;
    float2* b = smem2 + (f & 1) * sites;
    if (f + 1 < frames) {
      const int nb = (f + 1) & 1;
      stage_frame<L::kThreads>(warped, certainty, smem + nb * sites, smem2 + nb * sites,
                               (f + 1) * plane * 3, y0, x0, h, w, halo, sw, sites, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    // value x certainty on the sites this thread copied (its own copies
    // have landed), or for bfloat16 both rounded; the barrier then
    // publishes the frame to the block
    for (int s = tid; s < sites; s += L::kThreads) {
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
      for (int p = 0; p < R; ++p) ey[p] = ry * (float)S + phis_y[p];
#pragma unroll
      for (int p = 0; p < C; ++p) ex[p] = rx * (float)S + phis[p];
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
        for (int k = 0; k < len; ++k, kxs += (float)S) {
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

  const long long slot = (long long)S * S * 3 * plane;  // floats of one output array
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
          float* dst = out + k * slot + ((long long)(row0 + py) * S + col0) * 3 * plane +
                       (long long)y * w + x;
#pragma unroll
          for (int px = 0; px < C; ++px)
#pragma unroll
            for (int c = 0; c < 3; ++c, dst += plane) *dst = acc[k][py][px][c];
        }
      }
    }
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
      warped, residual, certainty, omega, out, frames, h, w, halo, rb, taps);
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

// The general form (merge_fast_general_kernel): what the templated
// kernel above does not take. That kernel is built for scales 1-4 and
// taps within +-8 (its staged halo and run table); the wrapper
// (kernels/merge.py) launches this one at any scale and tap radius, in
// forms 0-4. (merge_fast_pallas itself asserts a tap radius of at most
// 8, so form 0 past it is refused by the wrapper, as in JAX.)
//
// Design: written simply, as the plain version reads. A thread per
// (input pixel, output phase (py, px)) holds the phase's slots for the
// three channels; per frame it walks the taps in the list's order,
// reading value and certainty straight from device memory (the
// neighbouring threads' reads hit the same lines in L1 and L2), sums the
// frame's terms and then adds the frame's sums to its totals: the plain
// version's order (each frame's taps, then the frames), with the weight
// by IEEE expf and each product and sum rounded where the plain version
// rounds it (round-to-nearest intrinsics, no contraction into FMAs; form
// 4 rounds each bfloat16 product and sum). Nothing is staged, so no scale
// or tap radius is bounded by shared memory. Each weight is evaluated
// once per (pixel, frame, tap, phase), as in the templated kernel, but
// each tap's value and certainty are read once per phase. Its time
// against its bound is in PERF.md.

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(256)
merge_fast_general_kernel(const float* __restrict__ warped, const float* __restrict__ residual,
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
// as (S, S, 3, H, W). Every output is written in full. taps_yx is a HOST array of n_taps (ky, kx) pairs, each
// within +-8, in at most kMaxRuns runs of one row with kx rising by 1
// (any list of _active_taps is one run per row).
int mfsr_merge_fast(const void* warped, const void* residual,
                    const void* certainty, const void* omega, void* out, int frames,
                    int h, int w, int scale, int form, const void* taps_yx, int n_taps,
                    float rb, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps || frames < 1 || h < 1 || w < 1 ||
      reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* yx = static_cast<const int*>(taps_yx);
  int halo = 0;
  for (int t = 0; t < n_taps; ++t) {
    if (std::abs(yx[2 * t]) > kMaxRadius || std::abs(yx[2 * t + 1]) > kMaxRadius) {
      return (int)cudaErrorInvalidValue;
    }
    halo = std::max({halo, std::abs(yx[2 * t]), std::abs(yx[2 * t + 1])});
  }
  Taps taps;
  taps.n = 0;
  for (int t = 0; t < n_taps; ++t) {
    const int ky = yx[2 * t], kx = yx[2 * t + 1];
    if (t > 0 && ky == yx[2 * t - 2] && kx == yx[2 * t - 1] + 1) {
      ++taps.len[taps.n - 1];
      continue;
    }
    if (taps.n == kMaxRuns) return (int)cudaErrorInvalidValue;
    taps.kys[taps.n] = (float)(ky * scale);
    taps.kxs0[taps.n] = (float)(kx * scale);
    taps.off0[taps.n] = ky * (kTileW + 2 * halo) + kx;
    taps.len[taps.n++] = 1;
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

// Launches the general form (merge_fast_general_kernel) on `stream` and
// returns cudaGetLastError(). The arrays, out and forms are
// mfsr_merge_fast's, at any scale >= 1; taps is a DEVICE int32 array of
// n_taps (ky, kx) rows, any offsets, in the list's order.
int mfsr_merge_fast_general(const void* warped, const void* residual, const void* certainty,
                            const void* omega, void* out, int frames, int h, int w, int scale,
                            int form, const void* taps, int n_taps, float rb, void* stream) {
  if (n_taps < 0 || frames < 1 || h < 1 || w < 1 || scale < 1 || (long long)scale * scale > 65535 ||
      (h + 7) / 8 > 65535 || form < 0 || form > 4 ||
      reinterpret_cast<std::uintptr_t>(residual) % sizeof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + 31) / 32, (h + 7) / 8, scale * scale);
  merge_fast_general_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(warped), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega), static_cast<float*>(out),
      static_cast<const int*>(taps), n_taps, frames, h, w, scale, form, rb);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
