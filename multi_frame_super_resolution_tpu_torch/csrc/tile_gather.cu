// Per-tile search windows for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// tile_gather.py::tile_gather_pallas (kernel body _make_kernel), which
// DMAs one (T+2p)^2 block per tile at its integer pre-shift with the
// block origin clamped into the image. This kernel computes the function
// that block copy approximates, the reference's
// convertToTilesOverlapPreShift as registration/tiles.py::
// extract_search_windows computes it, clamping every pixel:
//
//   out[n, ty, tx, u, v] = img[n, clip(ty*T + sy + u - p, 0, H-1),
//                                 clip(tx*T + sx + v - p, 0, W-1)]
//
// over the ceil-divided tile grid, with (sy, sx) = shifts[n, ty, tx].
// It equals tile_gather_pallas on interior tiles (where no clamp acts)
// and extract_search_windows everywhere; a GPU has no reason to copy the
// block-granular approximation, which exists for Mosaic's DMA.
//
// Design: one thread per output value, consecutive threads on
// consecutive v, so a warp reads one window row (contiguous in the
// image away from borders) and writes contiguously.
//
// Bound: bytes, and little of them: at the windows branch's finest level
// (4 frames x 8 x 16 tiles of 24 x 24 at T=16, p=4) it writes 1.2 MB and
// reads 0.5 MB of image through L2, in 3.5 us of device time (NVIDIA
// H100 80GB HBM3, 700.00 W); launch latency dominates.

#include <cuda_runtime.h>

namespace {

__global__ void tile_gather_kernel(const float* __restrict__ img,
                                   const int* __restrict__ shifts,
                                   float* __restrict__ out, long long total,
                                   int h, int w, int t, int pad, int nty,
                                   int ntx) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t2 = t + 2 * pad;
  const int v = (int)(idx % t2);
  long long rest = idx / t2;
  const int u = (int)(rest % t2);
  rest /= t2;
  const int tx = (int)(rest % ntx);
  rest /= ntx;
  const int ty = (int)(rest % nty);
  const long long n = rest / nty;

  const int* sh = shifts + ((n * nty + ty) * ntx + tx) * 2;
  const int yy = min(max(ty * t + sh[0] + u - pad, 0), h - 1);
  const int xx = min(max(tx * t + sh[1] + v - pad, 0), w - 1);
  out[idx] = img[n * h * w + (long long)yy * w + xx];
}

}  // namespace

extern "C" {

// Launches the window gather on `stream` and returns cudaGetLastError()
// (0 on success). img is contiguous float32 (N, H, W); shifts contiguous
// int32 (N, nty, ntx, 2); out contiguous float32 (N, nty, ntx, T+2p, T+2p).
int mfsr_tile_gather(const void* img, const void* shifts, void* out, int n,
                     int h, int w, int t, int pad, int nty, int ntx,
                     void* stream) {
  if (n < 0 || h < 1 || w < 1 || t < 1 || pad < 0 || nty * t < h ||
      ntx * t < w) {
    return (int)cudaErrorInvalidValue;
  }
  const long long t2 = t + 2 * pad;
  const long long total = (long long)n * nty * ntx * t2 * t2;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  tile_gather_kernel<<<(unsigned int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(shifts),
      static_cast<float*>(out), total, h, w, t, pad, nty, ntx);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
