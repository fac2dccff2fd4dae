// Order-0 static-tap kernel-regression merge for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// merge.py::merge_fast_pallas (kernel body _make_kernel). It computes the
// same function as the plain PyTorch version
// multi_frame_super_resolution_tpu_torch/models/fast_merge.py::
// merge_burst_fast: for every input pixel (y, x), every frame f, every
// static tap (ky, kx) and every output phase (py, px),
//
//   d   = (k - clip(res_f(y, x), -rb, rb)) * s - phi * s
//   w   = exp(-1/2 (dx^2 Oxx + dy^2 Oyy + 2 dx dy Oxy))      Omega^-1 at (y, x)
//   num[s*y+py, s*x+px, c] += w * cert_f(y', x', c) * val_f(y', x', c)
//   den[s*y+py, s*x+px, c] += w * cert_f(y', x', c)
//
// with (y', x') = (y + ky, x + kx) clamped to the image (edge semantics).
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

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kMaxRadius = 8;
constexpr int kMaxTaps = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr int kTileW = 32;  // input columns of a block (one warp)
constexpr int kTileH = 8;   // input rows of a block
constexpr int kThreads = kTileW * kTileH;

constexpr int kMaxRuns = 64;  // _active_taps gives one run per tap row, at most 17

// The taps as runs: consecutive taps of one row, kx rising by 1.
struct Taps {
  int n;                 // runs
  float kys[kMaxRuns];   // ky * s
  float kxs0[kMaxRuns];  // the run's first kx * s
  int off0[kMaxRuns];    // its first staged offset, ky * staged row length + kx
  int len[kMaxRuns];     // its taps
};

// blocks an SM the launch bound asks for: the s^2 * 6 accumulators grow
// with s (at s <= 2 four blocks, 64 registers a thread, hold the 256 x 512
// check in one wave)
template <int S>
constexpr int min_blocks() {
  return S <= 2 ? 4 : (S == 3 ? 2 : 1);
}

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

// Writes one output array's block: each thread parks its s^2 x 3 values
// in shared memory (the frame buffers, free by now), then the block
// writes its s * kTileH output rows of s * kTileW * 3 contiguous floats,
// consecutive threads on consecutive floats.
template <int S>
__device__ __forceinline__ void park_and_store(const float (&acc)[S][S][3], float* park,
                                               float* __restrict__ out, int y0, int x0,
                                               int h, int w, bool inside, int tid) {
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
  const int rows = min(kTileH, h - y0) * S;
  const int row_len = min(kTileW, w - x0) * S * 3;
  const long long out_row = (long long)w * S * 3;
  float* dst = out + (long long)y0 * S * out_row + (long long)x0 * S * 3;
  for (int i = tid; i < rows * kRow; i += kThreads) {
    const int r = i / kRow, col = i % kRow;
    if (col < row_len) dst[r * out_row + col] = park[i];
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, min_blocks<S>())
merge_fast_kernel(const float* __restrict__ warped,
                  const float* __restrict__ residual,
                  const float* __restrict__ certainty,
                  const float* __restrict__ omega,
                  float* __restrict__ num,
                  float* __restrict__ den,
                  int frames, int h, int w, int halo, float rb,
                  const Taps taps) {
  // two frame buffers: float4 sites [2][sites], then float2 sites [2][sites]
  extern __shared__ float4 smem[];
  const int sw = kTileW + 2 * halo;
  const int sites = (kTileH + 2 * halo) * sw;
  float2* smem2 = reinterpret_cast<float2*>(smem + 2 * sites);

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
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
  // operations of fast_merge._output_phase_offsets
  float phis[S];
#pragma unroll
  for (int p = 0; p < S; ++p) phis[p] = (((float)p + 0.5f) / (float)S - 0.5f) * (float)S;

  float acc_n[S][S][3];
  float acc_d[S][S][3];
#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc_n[py][px][c] = acc_d[py][px][c] = 0.0f;

  const float2* res = reinterpret_cast<const float2*>(residual) + pix;
  stage_frame(warped, certainty, smem, smem2, 0, y0, x0, h, w, halo, sw, sites, tid);
  for (int f = 0; f < frames; ++f) {
    const float2 r = res[f * plane];
    float4* a = smem + (f & 1) * sites;
    float2* b = smem2 + (f & 1) * sites;
    if (f + 1 < frames) {
      const int nb = (f + 1) & 1;
      stage_frame(warped, certainty, smem + nb * sites, smem2 + nb * sites,
                  (f + 1) * plane * 3, y0, x0, h, w, halo, sw, sites, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    // value x certainty on the sites this thread copied (its own copies
    // have landed); the barrier then publishes the frame to the block
    for (int s = tid; s < sites; s += kThreads) {
      const float4 v = a[s];
      const float2 c = b[s];
      a[s] = make_float4(v.x * v.w, v.y * c.x, v.z * c.y, v.w);
    }
    __syncthreads();

    if (inside) {
      // dy = ky s - (ry s + phis[py]), dx likewise: the tap table holds
      // ky s and kx s
      const float ry = fminf(fmaxf(r.x, -rb), rb);
      const float rx = fminf(fmaxf(r.y, -rb), rb);
      float ey[S], ex[S];
#pragma unroll
      for (int p = 0; p < S; ++p) {
        ey[p] = ry * (float)S + phis[p];
        ex[p] = rx * (float)S + phis[p];
      }
#pragma unroll 1
      for (int run = 0; run < taps.n; ++run) {
        // the row's terms, shared by its taps: A = dy^2 o_yy, B = dy o_xy
        float qa[S], qb[S];
#pragma unroll
        for (int py = 0; py < S; ++py) {
          const float dy = taps.kys[run] - ey[py];
          qa[py] = dy * dy * o1;
          qb[py] = dy * o2;
        }
        const float4* pa = a + my_site + taps.off0[run];
        const float2* pb = b + my_site + taps.off0[run];
        float kxs = taps.kxs0[run];
        const int len = taps.len[run];
#pragma unroll 1
        for (int k = 0; k < len; ++k, kxs += (float)S) {
          const float4 va = pa[k];  // v0 c0, v1 c1, v2 c2, c0
          const float2 vb = pb[k];  // c1, c2
#pragma unroll
          for (int px = 0; px < S; ++px) {
            const float dx = kxs - ex[px];
#pragma unroll
            for (int py = 0; py < S; ++py) {
              const float wgt = exp2_approx(fmaf(dx, fmaf(dx, o0, qb[py]), qa[py]));
              acc_n[py][px][0] = fmaf(wgt, va.x, acc_n[py][px][0]);
              acc_n[py][px][1] = fmaf(wgt, va.y, acc_n[py][px][1]);
              acc_n[py][px][2] = fmaf(wgt, va.z, acc_n[py][px][2]);
              acc_d[py][px][0] = fmaf(wgt, va.w, acc_d[py][px][0]);
              acc_d[py][px][1] = fmaf(wgt, vb.x, acc_d[py][px][1]);
              acc_d[py][px][2] = fmaf(wgt, vb.y, acc_d[py][px][2]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is restaged for frame f + 2 (or parks the outputs)
  }

  park_and_store<S>(acc_n, reinterpret_cast<float*>(smem), num, y0, x0, h, w, inside, tid);
  __syncthreads();
  park_and_store<S>(acc_d, reinterpret_cast<float*>(smem), den, y0, x0, h, w, inside, tid);
}

template <int S>
int launch(const float* warped, const float* residual, const float* certainty,
           const float* omega, float* num, float* den, int frames, int h,
           int w, int halo, float rb, const Taps& taps, cudaStream_t stream) {
  const int sites = (kTileH + 2 * halo) * (kTileW + 2 * halo);
  // two frame buffers, or one parked output array, whichever is larger
  const size_t bytes = std::max((size_t)sites * 2 * (sizeof(float4) + sizeof(float2)),
                                (size_t)kThreads * S * S * 3 * sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_fast_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  merge_fast_kernel<S><<<grid, block, bytes, stream>>>(
      warped, residual, certainty, omega, num, den, frames, h, w, halo, rb, taps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the merge on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays:
// warped (F, H, W, 3), residual (F, H, W, 2) (8-byte aligned: it is read
// as float2), certainty (F, H, W, 3), omega (H, W, 3); num and den
// (S*H, S*W, 3) are written in full. taps_yx is a HOST array of n_taps
// (ky, kx) pairs, each within +-8, in at most kMaxRuns runs of one row
// with kx rising by 1 (any list of _active_taps is one run per row).
int mfsr_merge_fast(const void* warped, const void* residual,
                    const void* certainty, const void* omega, void* num,
                    void* den, int frames, int h, int w, int scale,
                    const void* taps_yx, int n_taps, float rb, void* stream) {
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
  float* n = static_cast<float*>(num);
  float* d = static_cast<float*>(den);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 1: return launch<1>(a, r, c, o, n, d, frames, h, w, halo, rb, taps, st);
    case 2: return launch<2>(a, r, c, o, n, d, frames, h, w, halo, rb, taps, st);
    case 3: return launch<3>(a, r, c, o, n, d, frames, h, w, halo, rb, taps, st);
    case 4: return launch<4>(a, r, c, o, n, d, frames, h, w, halo, rb, taps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
