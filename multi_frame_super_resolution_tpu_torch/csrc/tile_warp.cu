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
//     out[y, x] = img[iy(y, ix), ix],  ix = ix(ty(y), x)
//   with each index the one-hot select's along its axis p for the shift
//   map s(p) of its line: clamp(p + s(p)) for windows 2 bound + 1 <= 13,
//   else the two-level decomposition s = c q + r, 0 <= r < c, c =
//   round(sqrt(2 bound + 1)) (6 at bound 16): clamp(p + r(p) + c q(p')),
//   p' = min(p + r(p), n - 1). Where a line's shift changes within c
//   positions (a tile seam) this differs from clamp(p + s(p)), by design
//   of that form. ix's line is row y, so it depends on the tile row and
//   x alone; iy's line is the source column, so it depends on y and the
//   source column's tile alone. The plain version is ops/warp_fast.py::
//   tile_warp_select.
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
// - The index map is a template parameter, so each map's instantiation
//   holds its own index code only (behind one runtime branch the
//   separable map, which every path runs, carried the one-hot map's
//   registers).
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
// - The separable and block maps read their shifts through the
//   read-only cache, per element: a block's 256 threads share a handful
//   of tiles, and the chain is one shift deep (the separable y: two).
//   Staging them in shared memory put a barrier into the same dependent
//   chain (shift, then data) and measured no faster.
// - The one-hot map's chain was four shifts deep per element (x's s(p),
//   s(p + r), then y's at the source column's tile, twice) before its
//   data load, and was repeated on every row. So a block builds its
//   indices once, in shared memory: ix at its 128 columns for each tile
//   row its 8 rows span (one where 8 divides T), and iy at its 8 rows
//   for each tile column an ix can reach (within bound + c - 1 of its
//   columns: 12 at T = 16, bound 16), about one entry of each a thread,
//   each entry's two shifts read through the read-only cache (staging
//   the shifts first would add a barrier to the build). After one
//   barrier an element is two table reads (ix an int4 for the thread's
//   4 columns, then iy at ix's tile) before its data: the separable
//   map's copy loop. Here shared memory held: 0.00296 ms at 4 x 4 x 128
//   x 256, bound 16, against 0.00559 for the per-element chain in the
//   same call.
// - The coarse step's floor division is a multiply-high by a host
//   magic number (kernels/tile_warp.py::floor_magic), not a division by
//   a runtime divisor. Where the iy table would pass 48 KB (past ~1,400
//   tile columns: T = 1 at bounds past ~640) the one-hot map computes
//   its indices per element as before (kOnehotDirect).
// - A block is 32 x 8 threads: 128 columns by 8 rows; the RAW path's
//   4 x 4 x 128 x 256 warp is 128 blocks, one per SM.
// - Measured (tools/ab_main_kernels.py, 4 x 4 x 128 x 256, T = 16;
//   NVIDIA H100 80GB HBM3, 700.00 W): separable 0.00232 ms (54.0% of the
//   bound; 0.00266 behind the runtime branch, in the same call), block
//   0.00223 (0.00248), one-hot at bound 16 0.00296 (42.3%; 0.00559).
//   ptxas: 58 and 80 registers (aligned rows or not) for the separable
//   and one-hot maps, 48-80 for the block map, no spills.

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
constexpr int kCols = kBlockX * kGroup;  // columns of a block
// the one-hot map's index tables: ix (kBlockY x kCols) and iy (kBlockY x
// the table's tile columns) within the 48 KB a block has without opting in
constexpr int kTableBytes = 48 * 1024;

constexpr int kSeparable = 0, kBlock = 1, kOnehot = 2;  // index maps (the C interface's)
constexpr int kOnehotDirect = 3;  // the one-hot map where its tables do not fit: indices per element

// The one-hot form's coarse step c (0: the direct select) and floor(v / c)
// for v >= -c k as a multiply-high: ((v + c k) m) >> 64 - k with m =
// ceil(2^64 / c) is exact for 0 <= v + c k < 2^34 (kernels/tile_warp.py::
// floor_magic computes k and m; tests/test_torch_ops.py checks them).
struct Coarse {
  int c, k;
  unsigned long long m;
};

__device__ __forceinline__ int floor_div(int v, const Coarse& q) {
  return (int)__umul64hi((unsigned long long)((long long)v + (long long)q.c * q.k), q.m) - q.k;
}

// The one-hot select's source index along an axis of n positions at p,
// s(.) the line's clipped shift map: direct below c = 0, else the
// two-level form (floor division: q rounds toward -infinity)
template <typename ShiftAt>
__device__ __forceinline__ int onehot_index(int p, int n, const Coarse& q, ShiftAt shift_at) {
  const int s = shift_at(p);
  if (!q.c) return min(max(p + s, 0), n - 1);
  const int pr = p + s - q.c * floor_div(s, q);  // p + r(p), r in [0, c)
  return min(max(pr + q.c * floor_div(shift_at(min(pr, n - 1)), q), 0), n - 1);
}

// kMap: the index map. kVec: rows are 16-byte aligned, so a thread's 4
// outputs of a plane are one float4 store. kPow2: the tile size is
// 1 << lg_t, so tile indices are shifts. table_cols: the iy table's tile
// columns (kOnehot).
template <int kMap, bool kVec, bool kPow2>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tile_warp_kernel(const float* __restrict__ img, const int* __restrict__ shifts,
                 float* __restrict__ out, int n, int h, int w, int t, int lg_t,
                 int nty, int ntx, int bound, const Coarse q, int table_cols) {
  const int xb = blockIdx.x * kCols, yb = blockIdx.y * kBlockY;
  const int x0 = xb + threadIdx.x * kGroup;
  const int y = yb + threadIdx.y;
  const int b = blockIdx.z;
  const auto tile_of = [&](int v) { return kPow2 ? v >> lg_t : (int)((unsigned)v / (unsigned)t); };
  const auto clip = [&](int v) { return min(max(v, -bound), bound); };
  const int* sh = shifts + (long long)b * nty * ntx * 2;
  int src[kGroup];
  if constexpr (kMap == kOnehot) {
    // The block's indices, once: ix(tile row, x) at its columns for each
    // tile row its rows span, iy(y, source tile column) at its rows for
    // each tile column an ix can reach (within bound + c - 1 of its
    // columns); then each element is two table reads
    extern __shared__ int4 tables[];
    int* ixs = reinterpret_cast<int*>(tables);  // [kBlockY][kCols], rows from tile row ty_lo
    int* iys = ixs + kBlockY * kCols;           // [kBlockY][table_cols], columns from tile column tc_lo
    const int tid = threadIdx.y * kBlockX + threadIdx.x;
    const int ty_lo = tile_of(yb);
    const int rows = tile_of(min(yb + kBlockY - 1, h - 1)) - ty_lo + 1;
    const int reach = bound + max(q.c - 1, 0);
    const int tc_lo = tile_of(max(xb - reach, 0));
    const int cols = tile_of(min(xb + kCols - 1 + reach, w - 1)) - tc_lo + 1;
    for (int e = tid; e < rows * kCols; e += kBlockX * kBlockY) {
      const int r = e / kCols, p = min(xb + e % kCols, w - 1);  // past the row's end: never stored
      const int* row = sh + (ty_lo + r) * ntx * 2 + 1;
      ixs[e] = onehot_index(p, w, q, [&](int c) { return clip(__ldg(row + tile_of(c) * 2)); });
    }
    for (int e = tid; e < kBlockY * cols; e += kBlockX * kBlockY) {
      const int r = e / cols, col = e % cols;
      const int* column = sh + (tc_lo + col) * 2;
      iys[r * table_cols + col] = onehot_index(min(yb + r, h - 1), h, q, [&](int v) {
        return clip(__ldg(column + tile_of(v) * ntx * 2));
      });
    }
    __syncthreads();
    if (x0 >= w || y >= h) return;
    const int4 ix = *reinterpret_cast<const int4*>(ixs + (tile_of(y) - ty_lo) * kCols + threadIdx.x * kGroup);
    const int* iy = iys + threadIdx.y * table_cols;
    src[0] = iy[tile_of(ix.x) - tc_lo] * w + ix.x;
    src[1] = iy[tile_of(ix.y) - tc_lo] * w + ix.y;
    src[2] = iy[tile_of(ix.z) - tc_lo] * w + ix.z;
    src[3] = iy[tile_of(ix.w) - tc_lo] * w + ix.w;
  } else {
    if (x0 >= w || y >= h) return;
    const int ty = tile_of(y);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int x = min(x0 + k, w - 1);  // past the row's end: a valid offset, never stored
      const int tx = tile_of(x);
      int ys, xs;
      if constexpr (kMap == kBlock) {
        const int* s = sh + (ty * ntx + tx) * 2;
        ys = min(max(ty * t + __ldg(s), 0), h - t) + (y - ty * t);
        xs = min(max(tx * t + __ldg(s + 1), 0), w - t) + (x - tx * t);
      } else if constexpr (kMap == kOnehotDirect) {
        xs = onehot_index(x, w, q, [&](int c) { return clip(__ldg(sh + (ty * ntx + tile_of(c)) * 2 + 1)); });
        const int txs = tile_of(xs);
        ys = onehot_index(y, h, q, [&](int r) { return clip(__ldg(sh + (tile_of(r) * ntx + txs) * 2)); });
      } else {
        xs = min(max(x + clip(__ldg(sh + (ty * ntx + tx) * 2 + 1)), 0), w - 1);
        ys = min(max(y + clip(__ldg(sh + (ty * ntx + tile_of(xs)) * 2)), 0), h - 1);
      }
      src[k] = ys * w + xs;
    }
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

template <int kMap>
void launch(dim3 grid, dim3 block, size_t bytes, cudaStream_t s, bool vec, bool pow2, const float* src,
            const int* sh, float* dst, int n, int h, int w, int t, int lg_t, int nty, int ntx, int bound,
            const Coarse& q, int table_cols) {
#define MFSR_LAUNCH(V, P)                                                                          \
  tile_warp_kernel<kMap, V, P><<<grid, block, bytes, s>>>(src, sh, dst, n, h, w, t, lg_t, nty, ntx, \
                                                          bound, q, table_cols)
  if (vec) {
    if (pow2) MFSR_LAUNCH(true, true); else MFSR_LAUNCH(true, false);
  } else {
    if (pow2) MFSR_LAUNCH(false, true); else MFSR_LAUNCH(false, false);
  }
#undef MFSR_LAUNCH
}

}  // namespace

extern "C" {

// Launches the warp on `stream` and returns cudaGetLastError() (0 on
// success). img and out are contiguous float32 (B, N, H, W); shifts is
// contiguous int32 (B, nty, ntx, 2) with nty = ceil(H/T), ntx = ceil(W/T).
// index_map selects the separable map (0, shifts clipped to +-bound),
// the block map (1, H and W multiples of T) or the one-hot map (2, shifts
// clipped to +-bound; offset and magic: kernels/tile_warp.py::floor_magic
// for its coarse step, past a 13-wide window).
int mfsr_tile_warp(const void* img, const void* shifts, void* out, int batch,
                   int n, int h, int w, int t, int nty, int ntx, int bound,
                   int index_map, int offset, unsigned long long magic, void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || h < 1 || w < 1 || t < 1 || bound < 0 ||
      nty * t < h || ntx * t < w || index_map < 0 || index_map > 2 ||
      (index_map == kBlock && (h % t || w % t))) {
    return (int)cudaErrorInvalidValue;
  }
  // the one-hot form's coarse step past a 13-wide window (ops/warp_fast.py::
  // _axis_onehot_shift): round(sqrt(2 bound + 1)), at least 2; its floor
  // division's magic must be ceil(2^64 / c), its offset reach -bound
  Coarse q{0, 0, 0};
  if (index_map == kOnehot && 2 * bound + 1 > 13) {
    q.c = std::max(2, (int)std::lround(std::sqrt(2.0 * bound + 1.0)));
    q.k = offset;
    q.m = magic;
    if (offset < 0 || (long long)q.c * offset < bound || magic <= ~0ULL / q.c || magic * q.c >= (unsigned)q.c) {
      return (int)cudaErrorInvalidValue;
    }
  }
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
  if (index_map == kOnehot) {
    // the iy table's tile columns: those of kCols columns widened by the
    // reach of an index, bound + c - 1, on each side
    const long long reach = bound + std::max(q.c - 1, 0);
    const int table_cols = (int)std::min<long long>(ntx, (kCols - 1 + 2 * reach) / t + 2);
    const size_t bytes = (size_t)kBlockY * (kCols + table_cols) * sizeof(int);
    if (bytes <= kTableBytes) {
      launch<kOnehot>(grid, block, bytes, s, vec, pow2, src, sh, dst, n, h, w, t, lg_t, nty, ntx, bound, q,
                      table_cols);
    } else {
      launch<kOnehotDirect>(grid, block, 0, s, vec, pow2, src, sh, dst, n, h, w, t, lg_t, nty, ntx, bound, q, 0);
    }
  } else if (index_map == kBlock) {
    launch<kBlock>(grid, block, 0, s, vec, pow2, src, sh, dst, n, h, w, t, lg_t, nty, ntx, bound, q, 0);
  } else {
    launch<kSeparable>(grid, block, 0, s, vec, pow2, src, sh, dst, n, h, w, t, lg_t, nty, ntx, bound, q, 0);
  }
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
