// Per-tile integer-shift warp for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// tile_warp.py::tile_warp_pallas (kernel body _make_kernel), which DMAs
// one shifted T x T block per tile. The kernel has two index maps over
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
// Design: one thread per output pixel of a batch entry. It reads its
// tile's shifts (L1-cached: 256 threads share a handful), computes the
// source index once and copies that pixel of each of the N planes. The
// shifts stay on the device; nothing goes back to the host.
//
// Bound: bytes. Each output value is one 4-byte read and one 4-byte
// write, so at the RAW path's shapes (4 x 4 planes of 128 x 256) the
// kernel moves 4.2 MB; it measured 2.8 us of device time there
// (NVIDIA H100 80GB HBM3, 700.00 W), so launch latency dominates. Reads
// along a row are contiguous within a tile (the shift is constant there),
// so warps coalesce except at tile seams.

#include <cuda_runtime.h>

namespace {

__global__ void tile_warp_kernel(const float* __restrict__ img,
                                 const int* __restrict__ shifts,
                                 float* __restrict__ out, int n, int h, int w,
                                 int t, int nty, int ntx, int bound,
                                 int block_map) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;

  const int* sh = shifts + (long long)b * nty * ntx * 2;
  const int ty = y / t;
  const int tx = x / t;
  int ys, xs;
  if (block_map) {
    const int y0 = min(max(ty * t + sh[(ty * ntx + tx) * 2 + 0], 0), h - t);
    const int x0 = min(max(tx * t + sh[(ty * ntx + tx) * 2 + 1], 0), w - t);
    ys = y0 + (y - ty * t);
    xs = x0 + (x - tx * t);
  } else {
    const int sx = min(max(sh[(ty * ntx + tx) * 2 + 1], -bound), bound);
    xs = min(max(x + sx, 0), w - 1);
    const int sy = min(max(sh[(ty * ntx + xs / t) * 2 + 0], -bound), bound);
    ys = min(max(y + sy, 0), h - 1);
  }

  const long long plane = (long long)h * w;
  const float* src = img + (long long)b * n * plane + (long long)ys * w + xs;
  float* dst = out + (long long)b * n * plane + (long long)y * w + x;
  for (int i = 0; i < n; ++i) {
    dst[i * plane] = src[i * plane];
  }
}

}  // namespace

extern "C" {

// Launches the warp on `stream` and returns cudaGetLastError() (0 on
// success). img and out are contiguous float32 (B, N, H, W); shifts is
// contiguous int32 (B, nty, ntx, 2) with nty = ceil(H/T), ntx = ceil(W/T).
// block_map != 0 selects the block map (H, W multiples of T), else the
// separable map with shifts clipped to +-bound.
int mfsr_tile_warp(const void* img, const void* shifts, void* out, int batch,
                   int n, int h, int w, int t, int nty, int ntx, int bound,
                   int block_map, void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || h < 1 || w < 1 || t < 1 ||
      nty * t < h || ntx * t < w || (block_map && (h % t || w % t))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y,
                  batch);
  tile_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(shifts),
      static_cast<float*>(out), n, h, w, t, nty, ntx, bound, block_map);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
