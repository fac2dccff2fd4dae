// Per-tile integer-shift warp for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// tile_warp.py::tile_warp_pallas (kernel body _make_kernel), which DMAs
// one shifted T x T block per tile. The kernel has three index maps over
// planes (B, N, H, W) whose N planes share the shift field
// shifts (B, nty, ntx, 2) of their batch entry:
//
//   block map (tile_warp_pallas's function; H, W multiples of T, shifts
//   not clipped):
//     y0 = clip(ty*T + sy(ty, tx), 0, H-T), x0 = clip(tx*T + sx(ty, tx), 0, W-T)
//     out[ty*T + i, tx*T + j] = img[y0 + i, x0 + j]
//
//   separable map (the function the pipelines run, ops/warp_fast.py::
//   tile_warp_matmul; shifts clipped to +-bound, clamps at the real H, W):
//     x' = clamp(x + sx(ty(y), tx(x)), 0, W-1)
//     out[y, x] = img[clamp(y + sy(ty(y), tx(x')), 0, H-1), x']
//   The y-shift comes from the SOURCE column's tile, as the selector
//   matmul's y pass (banded by column tile) followed by its x pass gives.
//
//   one-hot map (the function of the pipelines' warp_matmul=False,
//   ops/warp_fast.py::tile_warp_select: a row pass by the y-shift map,
//   then a column pass by the x-shift map, shifts clipped to +-bound):
//     out[y, x] = img[iy(y, ix(y, x)), ix(y, x)]
//   with each index the one-hot select's along its axis p for the shift
//   map s(p) of its line: clamp(p + s(p)) for windows 2 bound + 1 <= 13,
//   else the two-level decomposition s = c q + r, 0 <= r < c, c =
//   round(sqrt(2 bound + 1)) (6 at bound 16): clamp(p + r(p) + c q(p')),
//   p' = min(p + r(p), n - 1). Where a line's shift changes within c
//   positions (a tile seam) this differs from clamp(p + s(p)), by design
//   of that form. The plain version is ops/warp_fast.py::
//   tile_warp_select; the map costs two more shift reads an element.
//
// Bound: bytes. Each output value is one 4-byte read and one 4-byte
// write: at the RAW path's shapes (4 x 4 planes of 128 x 256) 4.2 MB,
// 1.25 us at 3.35 TB/s. chip_smoke.py times dst.copy_(src) of a tensor of
// the same shape beside the kernel: the floor a plain copy of these bytes
// reaches on the card, launch ramp included.
//
// Design (the first version ran a thread per output pixel, 131,072
// threads that each read their tile's shifts and copied one scalar of
// each plane: 2.8 us):
// - A thread writes 4 consecutive outputs of one row in every plane: a
//   quarter of the threads. It computes the 4 source offsets once (per
//   element, so a group that straddles a tile seam, or a tile size that
//   is not a multiple of 4, needs no special case) and shares them
//   across the N planes.
// - Tile indices are shifts when the tile size is a power of two (the
//   paths' 16 and 32): integer divisions by a runtime divisor, two per
//   element, measured slower.
// - It issues the loads of up to 5 planes (4 each) before any store, so
//   each thread has 16-20 independent loads in flight on the paths.
// - Stores are one float4 per plane when the rows are 16-byte aligned
//   (W a multiple of 4); otherwise 4 scalar stores with the row's end
//   masked. Loads stay scalar: a source row segment is contiguous but
//   starts at any shift, so it is not aligned. (Threads taking columns 32
//   apart, so that every warp access is 32 consecutive floats, measured
//   slower.)
// - The shifts are read through the read-only cache: a block's 256
//   threads share a handful of tiles. Staging them in shared memory put a
//   barrier into the same dependent chain (shift, then data) and measured
//   no faster.
// - A block is 32 x 8 threads: 128 columns by 8 rows; the RAW path's
//   4 x 4 x 128 x 256 warp is 128 blocks, one per SM.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 2.34 us
//   against 2.9 us for the first version in the same call, 54% of the
//   bound; the copy of the same bytes 1.5 us.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kGroup = 4;    // consecutive outputs a thread writes per row
// planes whose loads go out before their stores: the most a path warps
// (4 CFA planes and the pre-alignment's validity)
constexpr int kPlanes = 5;
constexpr int kBlockX = 32;  // threads along x (kBlockX * kGroup columns)
constexpr int kBlockY = 8;   // rows of a block

// The one-hot select's source index along an axis of n positions at p,
// s(.) the line's clipped shift map: direct below coarse = 0, else the
// two-level form (floor division: q rounds toward -infinity)
template <typename ShiftAt>
__device__ __forceinline__ int onehot_index(int p, int n, int coarse, ShiftAt shift_at) {
  const int s = shift_at(p);
  if (!coarse) return min(max(p + s, 0), n - 1);
  const auto floor_div = [&](int v) { return v >= 0 ? v / coarse : -((coarse - 1 - v) / coarse); };
  const int pr = p + s - coarse * floor_div(s);  // p + r(p), r in [0, coarse)
  return min(max(pr + coarse * floor_div(shift_at(min(pr, n - 1))), 0), n - 1);
}

constexpr int kSeparable = 0, kBlock = 1, kOnehot = 2;  // index maps

// kVec: rows are 16-byte aligned, so a thread's 4 outputs of a plane are
// one float4 store. kPow2: the tile size is 1 << lg_t, so tile indices
// are shifts.
template <bool kVec, bool kPow2>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tile_warp_kernel(const float* __restrict__ img, const int* __restrict__ shifts,
                 float* __restrict__ out, int n, int h, int w, int t, int lg_t,
                 int nty, int ntx, int bound, int index_map, int coarse) {
  const int x0 = (blockIdx.x * kBlockX + threadIdx.x) * kGroup;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (x0 >= w || y >= h) return;
  const auto tile_of = [&](int v) { return kPow2 ? v >> lg_t : (int)((unsigned)v / (unsigned)t); };

  const int* sh = shifts + (long long)b * nty * ntx * 2;
  const int ty = tile_of(y);
  int src[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int x = min(x0 + k, w - 1);  // past the row's end: a valid offset, never stored
    const int tx = tile_of(x);
    int ys, xs;
    if (index_map == kBlock) {
      const int* s = sh + (ty * ntx + tx) * 2;
      ys = min(max(ty * t + __ldg(s), 0), h - t) + (y - ty * t);
      xs = min(max(tx * t + __ldg(s + 1), 0), w - t) + (x - tx * t);
    } else if (index_map == kOnehot) {
      const auto clip = [&](int v) { return min(max(v, -bound), bound); };
      xs = onehot_index(x, w, coarse, [&](int c) { return clip(__ldg(sh + (ty * ntx + tile_of(c)) * 2 + 1)); });
      const int txs = tile_of(xs);
      ys = onehot_index(y, h, coarse, [&](int r) { return clip(__ldg(sh + (tile_of(r) * ntx + txs) * 2)); });
    } else {
      const int sx = min(max(__ldg(sh + (ty * ntx + tx) * 2 + 1), -bound), bound);
      xs = min(max(x + sx, 0), w - 1);
      const int sy = min(max(__ldg(sh + (ty * ntx + tile_of(xs)) * 2), -bound), bound);
      ys = min(max(y + sy, 0), h - 1);
    }
    src[k] = ys * w + xs;
  }

  const long long plane = (long long)h * w;
  const float* in = img + (long long)b * n * plane;
  float* o = out + (long long)b * n * plane + (long long)y * w + x0;
  for (int i0 = 0; i0 < n; i0 += kPlanes) {
    float v[kPlanes][kGroup];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) {
      if (i0 + j < n) {
        const float* p = in + (i0 + j) * plane;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[j][k] = __ldg(p + src[k]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) {
      if (i0 + j < n) {
        float* d = o + (i0 + j) * plane;
        if (kVec) {
          *reinterpret_cast<float4*>(d) = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (x0 + k < w) d[k] = v[j][k];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the warp on `stream` and returns cudaGetLastError() (0 on
// success). img and out are contiguous float32 (B, N, H, W); shifts is
// contiguous int32 (B, nty, ntx, 2) with nty = ceil(H/T), ntx = ceil(W/T).
// index_map selects the separable map (0, shifts clipped to +-bound),
// the block map (1, H and W multiples of T) or the one-hot map (2, shifts
// clipped to +-bound).
int mfsr_tile_warp(const void* img, const void* shifts, void* out, int batch,
                   int n, int h, int w, int t, int nty, int ntx, int bound,
                   int index_map, void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || h < 1 || w < 1 || t < 1 || bound < 0 ||
      nty * t < h || ntx * t < w || index_map < 0 || index_map > 2 ||
      (index_map == kBlock && (h % t || w % t))) {
    return (int)cudaErrorInvalidValue;
  }
  // the one-hot form's coarse step past a 13-wide window (ops/warp_fast.py::
  // _axis_onehot_shift): round(sqrt(2 bound + 1)), at least 2
  const int coarse =
      2 * bound + 1 <= 13 ? 0 : std::max(2, (int)std::lround(std::sqrt(2.0 * bound + 1.0)));
  const dim3 block(kBlockX, kBlockY);
  const int groups = (w + kGroup - 1) / kGroup;
  const dim3 grid((groups + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, batch);
  // float4 stores need every row start 16-byte aligned
  const bool vec = w % kGroup == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  int lg_t = 0;
  while ((1 << lg_t) < t) ++lg_t;
  const bool pow2 = (1 << lg_t) == t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(img);
  const int* sh = static_cast<const int*>(shifts);
  float* dst = static_cast<float*>(out);
#define MFSR_LAUNCH(V, P)                                                                      \
  tile_warp_kernel<V, P><<<grid, block, 0, s>>>(src, sh, dst, n, h, w, t, lg_t, nty, ntx, bound, \
                                                index_map, coarse)
  if (vec) {
    if (pow2) MFSR_LAUNCH(true, true); else MFSR_LAUNCH(true, false);
  } else {
    if (pow2) MFSR_LAUNCH(false, true); else MFSR_LAUNCH(false, false);
  }
#undef MFSR_LAUNCH
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
