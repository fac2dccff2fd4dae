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
// Design: one thread per input pixel. It loops over the F frames and the
// tap list (passed by value in the kernel's parameters), keeps its
// s*s*3 num and den accumulators in registers for the whole burst, and
// writes them once, straight into the interleaved (sH, sW, 3) outputs:
// no partial sums and no phase-interleave pass go through device memory.
// None of the TPU kernel's block structure is carried over (its 8-row
// halos, 128-lane padding and double-buffered DMA exist for Mosaic).
//
// Bound: arithmetic, not bytes. Per input pixel it evaluates
// F * |taps| * s^2 expf and about ten FMAs each, 500 expf at the slice's
// F = 5, 25 taps, s = 2, against ~100 bytes of fresh input per frame and
// tap that the neighbouring threads share through L1. Making it fast
// (fast exp, phase-shared weight terms, tiling the taps through shared
// memory) is later work; this version is the simple, right one.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 289;  // (2 * 8 + 1)^2: tap radius up to 8

struct Taps {
  int n;
  signed char ky[kMaxTaps];
  signed char kx[kMaxTaps];
};

template <int S>
__global__ void merge_fast_kernel(const float* __restrict__ warped,
                                  const float* __restrict__ residual,
                                  const float* __restrict__ certainty,
                                  const float* __restrict__ omega,
                                  float* __restrict__ num,
                                  float* __restrict__ den,
                                  int frames, int h, int w, float rb,
                                  const Taps taps) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;

  // phi[p] * s with phi[p] = (p + 0.5) / s - 0.5, in the f32 operations
  // of fast_merge._output_phase_offsets
  float phis[S];
#pragma unroll
  for (int p = 0; p < S; ++p) {
    phis[p] = (((float)p + 0.5f) / (float)S - 0.5f) * (float)S;
  }

  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float oxx = omega[pix * 3 + 0];
  const float oyy = omega[pix * 3 + 1];
  const float oxy = omega[pix * 3 + 2];

  float acc_n[S][S][3];
  float acc_d[S][S][3];
#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc_n[py][px][c] = 0.0f;
        acc_d[py][px][c] = 0.0f;
      }

  for (int f = 0; f < frames; ++f) {
    const float* img = warped + f * plane * 3;
    const float* cert = certainty + f * plane * 3;
    const float ry = fminf(fmaxf(residual[(f * plane + pix) * 2 + 0], -rb), rb);
    const float rx = fminf(fmaxf(residual[(f * plane + pix) * 2 + 1], -rb), rb);
    for (int t = 0; t < taps.n; ++t) {
      const int ky = taps.ky[t];
      const int kx = taps.kx[t];
      const int sy = min(max(y + ky, 0), h - 1);
      const int sx = min(max(x + kx, 0), w - 1);
      const long long src = ((long long)sy * w + sx) * 3;
      const float v[3] = {img[src], img[src + 1], img[src + 2]};
      const float cv[3] = {cert[src], cert[src + 1], cert[src + 2]};
      const float dy0 = ((float)ky - ry) * (float)S;
      const float dx0 = ((float)kx - rx) * (float)S;
#pragma unroll
      for (int py = 0; py < S; ++py) {
        const float dy = dy0 - phis[py];
#pragma unroll
        for (int px = 0; px < S; ++px) {
          const float dx = dx0 - phis[px];
          const float q = dx * dx * oxx + dy * dy * oyy + 2.0f * dx * dy * oxy;
          const float wgt = expf(-0.5f * q);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float cw = wgt * cv[c];
            acc_n[py][px][c] += v[c] * cw;
            acc_d[py][px][c] += cw;
          }
        }
      }
    }
  }

  const long long out_w = (long long)w * S;
#pragma unroll
  for (int py = 0; py < S; ++py)
#pragma unroll
    for (int px = 0; px < S; ++px) {
      const long long o = (((long long)y * S + py) * out_w + (long long)x * S + px) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        num[o + c] = acc_n[py][px][c];
        den[o + c] = acc_d[py][px][c];
      }
    }
}

template <int S>
void launch(const float* warped, const float* residual, const float* certainty,
            const float* omega, float* num, float* den, int frames, int h,
            int w, float rb, const Taps& taps, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  merge_fast_kernel<S><<<grid, block, 0, stream>>>(
      warped, residual, certainty, omega, num, den, frames, h, w, rb, taps);
}

}  // namespace

extern "C" {

// Launches the merge on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays:
// warped (F, H, W, 3), residual (F, H, W, 2), certainty (F, H, W, 3),
// omega (H, W, 3); num and den (S*H, S*W, 3) are written in full.
// taps_yx is a HOST array of n_taps (ky, kx) pairs.
int mfsr_merge_fast(const void* warped, const void* residual,
                    const void* certainty, const void* omega, void* num,
                    void* den, int frames, int h, int w, int scale,
                    const void* taps_yx, int n_taps, float rb, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps || frames < 1 || h < 1 || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Taps taps;
  taps.n = n_taps;
  const int* yx = static_cast<const int*>(taps_yx);
  for (int t = 0; t < n_taps; ++t) {
    taps.ky[t] = (signed char)yx[2 * t];
    taps.kx[t] = (signed char)yx[2 * t + 1];
  }
  const float* a = static_cast<const float*>(warped);
  const float* r = static_cast<const float*>(residual);
  const float* c = static_cast<const float*>(certainty);
  const float* o = static_cast<const float*>(omega);
  float* n = static_cast<float*>(num);
  float* d = static_cast<float*>(den);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 1: launch<1>(a, r, c, o, n, d, frames, h, w, rb, taps, st); break;
    case 2: launch<2>(a, r, c, o, n, d, frames, h, w, rb, taps, st); break;
    case 3: launch<3>(a, r, c, o, n, d, frames, h, w, rb, taps, st); break;
    case 4: launch<4>(a, r, c, o, n, d, frames, h, w, rb, taps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
