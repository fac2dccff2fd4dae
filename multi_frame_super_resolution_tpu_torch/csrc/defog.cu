// Polarization defog, per pixel and channel, for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// defog.py::defog_pallas (kernel body _defog_kernel), the counterpart of
// the reference's defog_cuda2. For every element i of the (H, W, 3)
// interleaved inputs, with c = i % 3 and per-channel P, A_inf:
//
//   A = (Iper - Ipar) / P[c]
//   t = clip(1 - A / A_inf[c], t_min, t_max)
//   R = clip((Iper + Ipar - A) / t, r_min, r_max)
//
// The Pallas kernel moves the channels to the front so that W lies on the
// TPU's lanes; here neighbouring threads read neighbouring addresses of
// the interleaved arrays as they are, so no transpose is needed.
//
// Design: one thread per element, A, t and R written in one pass. The
// operations run in the order of the plain version (kernels/defog.py::
// defog_pixels) with IEEE division (no fast math) and contain no product
// that could contract into an FMA, so the outputs equal the plain
// version's bit for bit. The clip is written with comparisons so that a
// NaN passes through as it does in torch.clamp.
//
// Bound: bytes. Two 4-byte reads and three 4-byte writes per element:
// 75 MB at 1024 x 1224 x 3, about 22 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void defog_kernel(const float* __restrict__ iper,
                             const float* __restrict__ ipar,
                             const float* __restrict__ p,
                             const float* __restrict__ ainfi,
                             float* __restrict__ a_out,
                             float* __restrict__ t_out,
                             float* __restrict__ r_out, int n, float t_min,
                             float t_max, float r_min, float r_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = i % 3;
  const float per = iper[i];
  const float par = ipar[i];
  const float a = (per - par) / p[c];
  const float t = clip(1.0f - a / ainfi[c], t_min, t_max);
  const float r = clip((per + par - a) / t, r_min, r_max);
  a_out[i] = a;
  t_out[i] = t;
  r_out[i] = r;
}

}  // namespace

extern "C" {

// Launches the defog on `stream` and returns cudaGetLastError() (0 on
// success). iper, ipar, a, t and r are contiguous float32 arrays of n
// elements, (H, W, 3) interleaved, n = 3 H W; p and ainfi point to 3
// floats on the device.
int mfsr_defog(const void* iper, const void* ipar, const void* p,
               const void* ainfi, void* a, void* t, void* r, int n,
               float t_min, float t_max, float r_min, float r_max,
               void* stream) {
  if (n < 0 || n % 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const int block = 256;
  const int grid = (n + block - 1) / block;
  defog_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iper), static_cast<const float*>(ipar),
      static_cast<const float*>(p), static_cast<const float*>(ainfi),
      static_cast<float*>(a), static_cast<float*>(t), static_cast<float*>(r),
      n, t_min, t_max, r_min, r_max);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
