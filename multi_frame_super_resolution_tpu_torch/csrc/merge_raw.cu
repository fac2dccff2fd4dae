// RAW plane-domain order-1 merge (certless plugin branch) for Hopper
// (sm_90a), scale 2.
//
// The JAX package computes this accumulate outside Pallas
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
// Per tap the frame sum is formed first and then added, the JAX order.
//
// Design: one thread per (half-res pixel, output parity): 4 x 128 x 256
// = 131,072 threads at the city geometry (one thread per pixel alone
// would be 32,768, a quarter wave on 132 SMs). A thread owns one parity's
// 4 phases x 3 channels of m00/b0 (24 registers) and the 3 centroid
// chains its channels read (36 registers), so nothing but the outputs
// goes to device memory. The tap list and the per-parity plane, offset,
// channel and chain tables are built on the host and passed by value.
// The chain sums are recomputed by each parity that reads them (a
// thread's chains depend only on the tap parity), which costs no extra
// exp: both weight families are needed for the cells anyway.
//
// Bound: arithmetic. Per thread F * |taps| * 4 phases * 2 expf: at F=5,
// 21 taps, 840 expf and ~34 flops per (frame, tap, phase), i.e. 110 M
// expf and ~1.9 GFLOP at the city geometry, against 6.7 MB of input
// (re-read through L1/L2 by neighbouring threads) and 25 MB of output.
// Measured 0.18 ms of device time there (NVIDIA H100 80GB HBM3,
// 700.00 W): ~10 TFLOP/s, ~15% of the f32 non-tensor peak.

#include <cuda_runtime.h>

namespace {

constexpr int kS = 2;           // scale
constexpr int kPh = kS * kS;    // output phases per parity cell
constexpr int kMaxTaps = 81;    // tap radius up to 4

struct TapTable {
  int n;
  signed char ky[kMaxTaps];
  signed char kx[kMaxTaps];
  // per output parity z = 2a + b and tap
  unsigned char plane[4][kMaxTaps];  // source plane 2*qa + qb
  signed char da[4][kMaxTaps];       // half-res row offset (a+ky)//2
  signed char db[4][kMaxTaps];       // half-res column offset (b+kx)//2
  unsigned char ch[4][kMaxTaps];     // channel of the cell the tap feeds
  unsigned char chain[4][kMaxTaps];  // bit c: feeds the chain of channel c
};

__global__ void merge_raw_kernel(const float* __restrict__ planes,
                                 const float* __restrict__ residual,
                                 const float* __restrict__ certainty,
                                 const float* __restrict__ omega,
                                 const float* __restrict__ omega_rb,
                                 float* __restrict__ m00_out,
                                 float* __restrict__ cy_out,
                                 float* __restrict__ cx_out,
                                 float* __restrict__ b0_out, int frames,
                                 int hh, int hw, float rb,
                                 const TapTable taps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;  // output parity 2a + b
  if (j >= hw || i >= hh) return;
  const int a = z >> 1;
  const int b = z & 1;

  // phi[p] = (p + 0.5) / s - 0.5 in the f32 operations of
  // fast_merge._output_phase_offsets; phis = phi * s
  float phi[kS], phis[kS];
#pragma unroll
  for (int p = 0; p < kS; ++p) {
    phi[p] = ((float)p + 0.5f) / (float)kS - 0.5f;
    phis[p] = phi[p] * (float)kS;
  }

  const long long plane = (long long)hh * hw;
  const long long pix = (long long)i * hw + j;
  const float og0 = omega[pix * 3 + 0], og1 = omega[pix * 3 + 1],
              og2 = omega[pix * 3 + 2];
  const float or0 = omega_rb[pix * 3 + 0], or1 = omega_rb[pix * 3 + 1],
              or2 = omega_rb[pix * 3 + 2];

  float m00[kPh][3], b0[kPh][3], cw[3][kPh], c1[3][kPh], c2[3][kPh];
#pragma unroll
  for (int ph = 0; ph < kPh; ++ph)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m00[ph][c] = 0.0f;
      b0[ph][c] = 0.0f;
      cw[c][ph] = 0.0f;
      c1[c][ph] = 0.0f;
      c2[c][ph] = 0.0f;
    }

  for (int t = 0; t < taps.n; ++t) {
    const float ky = (float)taps.ky[t];
    const float kx = (float)taps.kx[t];
    const int q = taps.plane[z][t];
    const int ch = taps.ch[z][t];
    const int mask = taps.chain[z][t];
    const int si = min(max(i + taps.da[z][t], 0), hh - 1);
    const int sj = min(max(j + taps.db[z][t], 0), hw - 1);
    const long long spix = (long long)si * hw + sj;

    // this tap's frame sums: weight families g / rb, and the cell's
    float sw_g[kPh], sry_g[kPh], srx_g[kPh], sw_r[kPh], sry_r[kPh], srx_r[kPh];
    float sm[kPh], sb[kPh];
#pragma unroll
    for (int ph = 0; ph < kPh; ++ph) {
      sw_g[ph] = sry_g[ph] = srx_g[ph] = 0.0f;
      sw_r[ph] = sry_r[ph] = srx_r[ph] = 0.0f;
      sm[ph] = sb[ph] = 0.0f;
    }
    for (int f = 0; f < frames; ++f) {
      const long long fp = (long long)f * plane;
      const float ry = fminf(fmaxf(residual[(fp + pix) * 2 + 0], -rb), rb);
      const float rx = fminf(fmaxf(residual[(fp + pix) * 2 + 1], -rb), rb);
      const float val = planes[((long long)f * 4 + q) * plane + spix];
      const float cv = certainty[(fp + spix) * 3 + ch];
      const float u = (ky - ry) * (float)kS;
      const float v = (kx - rx) * (float)kS;
#pragma unroll
      for (int py = 0; py < kS; ++py) {
        const float dy = u - phis[py];
#pragma unroll
        for (int px = 0; px < kS; ++px) {
          const int ph = py * kS + px;
          const float dx = v - phis[px];
          const float wg =
              expf(-0.5f * (dx * dx * og0 + dy * dy * og1 + 2.0f * dx * dy * og2));
          const float wr =
              expf(-0.5f * (dx * dx * or0 + dy * dy * or1 + 2.0f * dx * dy * or2));
          sw_g[ph] += wg;
          sry_g[ph] += ry * wg;
          srx_g[ph] += rx * wg;
          sw_r[ph] += wr;
          sry_r[ph] += ry * wr;
          srx_r[ph] += rx * wr;
          const float wc = (ch == 1 ? wg : wr) * cv;
          sm[ph] += wc;
          sb[ph] += wc * val;
        }
      }
    }
    // predicated adds keep the accumulators in registers (no dynamic
    // indexing by the runtime channel)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool cell = c == ch;
      const bool feeds = (mask >> c) & 1;
#pragma unroll
      for (int py = 0; py < kS; ++py)
#pragma unroll
        for (int px = 0; px < kS; ++px) {
          const int ph = py * kS + px;
          if (cell) {
            m00[ph][c] += sm[ph];
            b0[ph][c] += sb[ph];
          }
          if (feeds) {
            const float sw = c == 1 ? sw_g[ph] : sw_r[ph];
            const float sry = c == 1 ? sry_g[ph] : sry_r[ph];
            const float srx = c == 1 ? srx_g[ph] : srx_r[ph];
            cw[c][ph] += sw;
            c1[c][ph] += (float)kS * ((ky - phi[py]) * sw - sry);
            c2[c][ph] += (float)kS * ((kx - phi[px]) * sw - srx);
          }
        }
    }
  }

#pragma unroll
  for (int py = 0; py < kS; ++py)
#pragma unroll
    for (int px = 0; px < kS; ++px) {
      const int ph = py * kS + px;
      const int row = a * kS + py;
      const int col = b * kS + px;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long o = (((long long)row * 2 * kS + col) * 3 + c) * plane + pix;
        const float wsum = cw[c][ph];
        const float inv = wsum > 1e-8f ? 1.0f / fmaxf(wsum, 1e-8f) : 0.0f;
        m00_out[o] = m00[ph][c];
        b0_out[o] = b0[ph][c];
        cy_out[o] = fminf(fmaxf(c1[c][ph] * inv, -2.0f), 2.0f);
        cx_out[o] = fminf(fmaxf(c2[c][ph] * inv, -2.0f), 2.0f);
      }
    }
}

}  // namespace

extern "C" {

// Launches the RAW merge on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to the contiguous float32 arrays
// described above; the four outputs (2s, 2s, 3, hh, hw) are written in
// full. table is a HOST int array of n_taps rows of 22 ints:
// ky, kx, then for each parity z = 2a + b: plane, da, db, ch, chain mask.
int mfsr_merge_raw(const void* planes, const void* residual,
                   const void* certainty, const void* omega,
                   const void* omega_rb, void* m00, void* cy, void* cx,
                   void* b0, int frames, int hh, int hw, float rb,
                   const void* table, int n_taps, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps || frames < 1 || hh < 1 || hw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  TapTable taps;
  taps.n = n_taps;
  const int* row = static_cast<const int*>(table);
  for (int t = 0; t < n_taps; ++t, row += 22) {
    taps.ky[t] = (signed char)row[0];
    taps.kx[t] = (signed char)row[1];
    for (int z = 0; z < 4; ++z) {
      const int* e = row + 2 + 5 * z;
      if (e[0] < 0 || e[0] > 3 || e[3] < 0 || e[3] > 2) {
        return (int)cudaErrorInvalidValue;
      }
      taps.plane[z][t] = (unsigned char)e[0];
      taps.da[z][t] = (signed char)e[1];
      taps.db[z][t] = (signed char)e[2];
      taps.ch[z][t] = (unsigned char)e[3];
      taps.chain[z][t] = (unsigned char)e[4];
    }
  }
  const dim3 block(32, 8, 1);
  const dim3 grid((hw + block.x - 1) / block.x, (hh + block.y - 1) / block.y, 4);
  merge_raw_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(residual),
      static_cast<const float*>(certainty), static_cast<const float*>(omega),
      static_cast<const float*>(omega_rb), static_cast<float*>(m00),
      static_cast<float*>(cy), static_cast<float*>(cx),
      static_cast<float*>(b0), frames, hh, hw, rb, taps);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
