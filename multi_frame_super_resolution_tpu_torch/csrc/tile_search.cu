// Fused per-tile SSD search for Hopper (sm_90a): one launch per pyramid
// level of the tile alignment.
//
// Replaces the TPU kernel multi_frame_super_resolution_tpu/pallas_ops/
// tile_gather.py::tile_gather_pallas (kernel body _make_kernel), which
// DMAs one shifted (T+2R)^2 search window per tile into device memory for
// an SSD surface and an argmin outside the kernel to read back. Mosaic
// refused that DMA, so the JAX package built its fast branch from a tile
// warp and image-level SSD sums instead. A GPU has no such limit: this
// kernel stages each tile's window in shared memory, builds the SSD
// surface there, takes the argmin and the subpixel step, and writes only
// the shift. It computes the plain PyTorch version
// multi_frame_super_resolution_tpu_torch/registration/tiles.py::
// tile_search, for frame n and tile (ty, tx) of the ceil-divided grid:
//
//   ref tile   F[i, j] = ref[min(ty*T + i, H-1), min(tx*T + j, W-1)]
//   window     W[a, b], a, b in [0, T+2R), by mode:
//     tile  (extract_search_windows, the windows branch; (sy, sx) the
//            rounded prediction of the tile):
//            alt[n, clip(ty*T + sy + a - R, 0, H-1), clip(tx*T + sx + b - R, 0, W-1)]
//     image (the fast branch: ssd_surface_image over
//            S = tile_warp_select(alt, rounded, T, bound=16)):
//            S[n, clip(ty*T + a - R, 0, H-1), clip(tx*T + b - R, 0, W-1)]
//   SSD[u, v]  = (tsq + wsq[u, v]) - 2 cc[u, v], u, v in [0, 2R+1), with
//                tsq = sum F^2, wsq[u, v] = sum_ij W[u+i, v+j]^2 and
//                cc[u, v] = sum_ij F[i, j] W[u+i, v+j]
//   out[n, ty, tx] = rounded[n, ty, tx] + find_min_shift(SSD)
//
// find_min_shift: the first minimum in row-major order; a minimum on the
// surface's border, or a surface with min + threshold > max, gives a zero
// shift; otherwise the offset (py - R, px - R), plus the 3x3 quadratic
// fit around it when subpixel is set (quadratic_subpixel_min: negative
// curvatures clipped to 0, a negative determinant drops the cross term, a
// zero one gives 0, |mu| > 1 gives 0 per axis).
//
// S is never materialized: the window loader computes it per pixel from
// the shift table, with tile_warp_select's two-level one-hot indexing at
// bound 16 (a window 33 > 13 wide: s = 6 q + r, r in [0, 6)). The column
// pass moves x to x' = clip(x + r + 6 q(y, min(x + r, W-1)), 0, W-1) with
// the x-shift map; the row pass then reads row clip(y + r' + 6 q'(min(y +
// r', H-1), x'), 0, H-1) with the y-shift map at (y, x'). Near tile
// borders that differs from a plain shift by design (the TPU form's
// function, which the port reproduces).
//
// Bound, at the fine level of the RAW main path (4 alternates of
// 128 x 256, T = 16, R = 4: 512 (frame, tile) pairs): the cross term's
// 2 S^2 T^2 flops a pair are the irreducible work, 21.2 MFLOP, 0.32 us at
// 67 TFLOP/s f32; the bytes (alternates and reference read once, the
// shifts in and out) are 0.66 MB, 0.20 us at 3.35 TB/s. The operations
// bind; a launch of this size is latency-bound far above both, so its
// yardstick is the plain search's device time (chip_smoke.py prints both).
//
// Design:
// - One block of 256 threads per (tile, frame): 512 blocks at the fine
//   level, about four an SM. The reference tile (1 KB at T = 16) is
//   staged by each of its frames' blocks rather than once by a block
//   that loops over the frames: four times the blocks in flight for a
//   latency-bound launch (the other form was not measured).
// - The tile and the window are staged in shared memory by 4-byte
//   cp.async copies at per-pixel clamped addresses (every copy in flight
//   at once). The image-mode loader resolves each pixel's source through
//   four dependent reads of the shift table, through the read-only cache
//   (the table is 1 KB a frame at the fine level); the two levels cost
//   0.0128 ms in image mode against 0.0105 in tile mode (chip_smoke.py's
//   profile of RAW_BENCH and of the windows branch). Staging the part of
//   the table a window reaches in shared memory first measured no
//   faster: the extra round trip costs what the faster lookups save.
// - Window energies: one pass over every (window row, v) for the row's
//   T-wide sums of squares; wsq[u, v] is then a sum of T of them.
// - Cross term: a lane group of T lanes (T <= 32) owns one tile row each
//   and holds that reference row in registers. A work item is (u, three
//   consecutive v): each lane walks its window row once, T + 2 shared
//   loads for 3 T FMAs, then the group sums its T rows (cc and wsq) by
//   xor shuffles, a fixed order.
// - The argmin: one warp scans the surface (first minimum per lane, then
//   a shuffle reduction on (value, index), ties to the lower index) with
//   the maximum beside it; one thread gates, fits and writes.
// - Rounding differs from the plain version in the order of the sums
//   (direct sums in FMA form here; the windows branch's plain version
//   takes integral images) and in the 3x3 stencil sums. On chip_smoke.py's
//   burst the integer parts are equal and the subpixel shifts within
//   2.5e-4 px (its check allows 1e-3). An exact tie of identical clamped
//   patches stays exact here and goes to the first offset; the plain
//   windows branch's integral images rank it by rounding. A surface
//   flat along one axis below float32 rounding (window rows that
//   pre-alignment clamped to a rotated frame's edge) is ranked by each
//   implementation's own rounding; registration/tiles.py::
//   float32_undecided finds such tiles.
// - Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 48
//   registers at T = 16, 64 at T = 32, no spills; 0.0077 ms of device
//   time at the fine level against the plain search's 0.40 ms over 120
//   device ops (PERF.md).
// - Tile sizes 8, 16 and 32 (a lane group per tile row) and radii from 1
//   up to what fits 48 KB of shared memory (mfsr_tile_search_max_radius);
//   the general form, described last, takes any other tile size and
//   radius.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 3;                 // consecutive offsets v of a work item
constexpr int kMaxSmem = 48 * 1024;   // bytes, without the opt-in
constexpr int kWarpBound = 16;        // tile_warp_select's default bound
constexpr int kCoarse = 6;            // its c = round(sqrt(2 * 16 + 1))

__host__ __device__ constexpr int win_stride(int t2) { return (t2 + kV - 1) | 1; }

// floats of shared memory: the window (rows padded so a work item's reads
// stay in its row, odd for the banks), the reference tile (odd stride),
// the row energies and the surface
__host__ __device__ constexpr int smem_floats(int t, int radius) {
  return (t + 2 * radius) * win_stride(t + 2 * radius) + t * (t + 1) +
         (t + 2 * radius) * (2 * radius + 1) + (2 * radius + 1) * (2 * radius + 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// the 3x3 least-squares stencils of registration/subpixel.py, row-major
__constant__ float kFA11[9] = {0.25f, -0.5f, 0.25f, 0.5f, -1.0f, 0.5f, 0.25f, -0.5f, 0.25f};
__constant__ float kFA22[9] = {0.25f, 0.5f, 0.25f, -0.5f, -1.0f, -0.5f, 0.25f, 0.5f, 0.25f};
__constant__ float kFA12[9] = {0.25f, 0.0f, -0.25f, 0.0f, 0.0f, 0.0f, -0.25f, 0.0f, 0.25f};
__constant__ float kFB1[9] = {-0.125f, 0.0f, 0.125f, -0.25f, 0.0f, 0.25f, -0.125f, 0.0f, 0.125f};
__constant__ float kFB2[9] = {-0.125f, -0.25f, -0.125f, 0.0f, 0.0f, 0.0f, 0.125f, 0.25f, 0.125f};

// sum of patch x stencil in row-major order; every product is exact (the
// weights are powers of two), so only the sum's order rounds
__device__ __forceinline__ float stencil_sum(const float* p, const float* k) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) s = __fadd_rn(s, __fmul_rn(p[i], k[i]));
  return s;
}

__device__ __forceinline__ int floor_div_coarse(int s) {  // floor(s / 6), |s| <= 16
  return (s + 3 * kCoarse) / kCoarse - 3;
}

// The source offset in its frame of tile_warp_select(alt, shifts, T, 16)
// at (y, x); sh is the frame's (nty, ntx, 2) table of rounded shifts.
template <int kT>
__device__ __forceinline__ int warp_source(const float* __restrict__ sh, int y, int x, int h,
                                           int w, int ntx) {
  const auto shift = [&](int yy, int xx, int c) {
    const int s = (int)__ldg(sh + ((yy / kT) * ntx + xx / kT) * 2 + c);
    return min(max(s, -kWarpBound), kWarpBound);
  };
  int s = shift(y, x, 1);
  int pr = x + (s - kCoarse * floor_div_coarse(s));
  const int xs = min(max(pr + kCoarse * floor_div_coarse(shift(y, min(pr, w - 1), 1)), 0), w - 1);
  s = shift(y, xs, 0);
  pr = y + (s - kCoarse * floor_div_coarse(s));
  const int ys = min(max(pr + kCoarse * floor_div_coarse(shift(min(pr, h - 1), xs, 0)), 0), h - 1);
  return ys * w + xs;
}

template <int kT>
__global__ void __launch_bounds__(kThreads)
tile_search_kernel(const float* __restrict__ ref, const float* __restrict__ alts,
                   const float* __restrict__ rounded, float* __restrict__ out, int h, int w,
                   int ntx, int nty, int radius, float threshold, int subpixel, int image_mode) {
  constexpr int kL = kT < 32 ? kT : 32;  // lanes of a group, one tile row each
  constexpr int kG = 32 / kL;            // groups of a warp
  static_assert(kT <= 32 && 32 % kT == 0, "a tile row per lane of a group");
  extern __shared__ float smem[];
  const int s_n = 2 * radius + 1;
  const int t2 = kT + 2 * radius;
  const int ws = win_stride(t2);
  float* win = smem;
  float* tile = win + t2 * ws;
  float* row_e = tile + kT * (kT + 1);
  float* ssd = row_e + t2 * s_n;

  const int tid = threadIdx.x;
  const int tx = blockIdx.x % ntx;
  const int ty = blockIdx.x / ntx;
  const int n = blockIdx.y;
  const int y0 = ty * kT;
  const int x0 = tx * kT;
  const long long plane = (long long)h * w;
  const float* alt = alts + n * plane;
  const float* sh = rounded + (long long)n * nty * ntx * 2;
  const float* pre = sh + (ty * ntx + tx) * 2;
  const float pre_y = __ldg(pre);
  const float pre_x = __ldg(pre + 1);

  // 1. stage the reference tile and the window
  for (int k = tid; k < kT * kT; k += kThreads) {
    const int i = k / kT, j = k % kT;
    cp_async4(&tile[i * (kT + 1) + j], ref + (long long)min(y0 + i, h - 1) * w + min(x0 + j, w - 1));
  }
  const int oy = image_mode ? y0 - radius : y0 + (int)pre_y - radius;
  const int ox = image_mode ? x0 - radius : x0 + (int)pre_x - radius;
  for (int k = tid; k < t2 * t2; k += kThreads) {
    const int a = k / t2, b = k % t2;
    const int yy = min(max(oy + a, 0), h - 1);
    const int xx = min(max(ox + b, 0), w - 1);
    const int src = image_mode ? warp_source<kT>(sh, yy, xx, h, w, ntx) : yy * w + xx;
    cp_async4(&win[a * ws + b], alt + src);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. row energies: row_e[r, v] = sum_j W[r, v + j]^2
  for (int k = tid; k < t2 * s_n; k += kThreads) {
    const int r = k / s_n, v = k % s_n;
    const float* p = win + r * ws + v;
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < kT; ++j) e = fmaf(p[j], p[j], e);
    row_e[k] = e;
  }

  // each lane's tile row in registers, and tsq (every lane of a group
  // gets the same sum: each xor step adds the same two values)
  const int lane = tid & 31;
  const int i = lane % kL;
  float fr[kT];
  float tsq = 0.0f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    fr[j] = tile[i * (kT + 1) + j];
    tsq = fmaf(fr[j], fr[j], tsq);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) tsq += __shfl_xor_sync(0xffffffffu, tsq, off);
  __syncthreads();

  // 3. the surface: a group per work item (u, v0 .. v0 + kV - 1)
  const int chunks = (s_n + kV - 1) / kV;
  const int items = s_n * chunks;
  for (int base = (tid >> 5) * kG; base < items; base += kWarps * kG) {
    const int item = min(base + lane / kL, items - 1);  // warp-uniform loop: a spare group redoes the last item
    const int u = item / chunks;
    const int v0 = (item % chunks) * kV;
    const float* p = win + (u + i) * ws + v0;
    float cc[kV], wsq[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      cc[v] = 0.0f;
      wsq[v] = v0 + v < s_n ? row_e[(u + i) * s_n + v0 + v] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kT + kV - 1; ++q) {
      const float x = p[q];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        if (q - v >= 0 && q - v < kT) cc[v] = fmaf(fr[q - v], x, cc[v]);
      }
    }
#pragma unroll
    for (int off = kL / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        cc[v] += __shfl_xor_sync(0xffffffffu, cc[v], off);
        wsq[v] += __shfl_xor_sync(0xffffffffu, wsq[v], off);
      }
    }
    if (i == 0 && base + lane / kL < items) {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        if (v0 + v < s_n) ssd[u * s_n + v0 + v] = __fsub_rn(__fadd_rn(tsq, wsq[v]), 2.0f * cc[v]);
      }
    }
  }
  __syncthreads();

  // 4. argmin (first minimum), maximum, gates, the subpixel fit
  if (tid >= 32) return;
  float mn = __int_as_float(0x7f800000);
  float mx = -mn;
  int mi = INT_MAX;
  for (int k = lane; k < s_n * s_n; k += 32) {
    const float s = ssd[k];
    if (s < mn) { mn = s; mi = k; }
    mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, mn, off);
    const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (om < mn || (om == mn && oi < mi)) { mn = om; mi = oi; }
  }
  if (lane != 0) return;
  const int py = mi / s_n, px = mi % s_n;
  float dy = (float)(py - radius), dx = (float)(px - radius);
  if (subpixel) {
    const int cy = min(max(py, 1), s_n - 2), cx = min(max(px, 1), s_n - 2);
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = ssd[(cy - 1 + k / 3) * s_n + cx - 1 + k % 3];
    const float a11 = fmaxf(stencil_sum(p, kFA11), 0.0f);
    const float a22 = fmaxf(stencil_sum(p, kFA22), 0.0f);
    float a12 = stencil_sum(p, kFA12);
    const float b1 = stencil_sum(p, kFB1);
    const float b2 = stencil_sum(p, kFB2);
    float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
    if (det < 0.0f) {
      a12 = 0.0f;
      det = __fmul_rn(a11, a22);
    }
    float mu_x = 0.0f, mu_y = 0.0f;
    if (det != 0.0f) {
      mu_x = __fdiv_rn(__fsub_rn(__fmul_rn(a22, b1), __fmul_rn(a12, b2)), det);
      mu_y = __fdiv_rn(__fsub_rn(__fmul_rn(a11, b2), __fmul_rn(a12, b1)), det);
    }
    if (fabsf(mu_x) > 1.0f) mu_x = 0.0f;
    if (fabsf(mu_y) > 1.0f) mu_y = 0.0f;
    dy = __fsub_rn(dy, mu_y);
    dx = __fsub_rn(dx, mu_x);
  }
  const bool on_border = py < 1 || py >= s_n - 1 || px < 1 || px >= s_n - 1;
  if (on_border || __fadd_rn(mn, threshold) > mx) dy = dx = 0.0f;
  float* o = out + (((long long)n * nty + ty) * ntx + tx) * 2;
  o[0] = __fadd_rn(pre_y, dy);
  o[1] = __fadd_rn(pre_x, dx);
}

template <int kT>
cudaError_t launch(const float* ref, const float* alts, const float* rounded, float* out, int n,
                   int h, int w, int ntx, int nty, int radius, float threshold, int subpixel,
                   int image_mode, cudaStream_t stream) {
  const dim3 grid((unsigned)(nty * ntx), (unsigned)n);
  const size_t smem = sizeof(float) * (size_t)smem_floats(kT, radius);
  tile_search_kernel<kT><<<grid, kThreads, smem, stream>>>(
      ref, alts, rounded, out, h, w, ntx, nty, radius, threshold, subpixel, image_mode);
  return cudaGetLastError();
}

// The general form (tile_search_general_kernel): what the templated
// kernel above does not take. That kernel maps a lane group of T lanes
// to the tile's rows (T = 8, 16 or 32), stages the window in 48 KB of
// shared memory (radii up to mfsr_tile_search_max_radius: 27 at T = 16)
// and needs a 3 x 3 neighbourhood for the fit (radius >= 1). The wrapper
// (kernels/tile_search.py) launches this one for any other tile size and
// radius, radius 0 included (a 1 x 1 surface: its minimum lies on the
// border, so the shift is the prediction, as find_min_shift gives).
//
// Design (kernels/tile_search.py::search_plan sets its SearchPlan):
// - One block of 256 threads per (tile, frame), as above. The reference
//   tile and the window are staged in shared memory by cp.async, the
//   image-mode window resolving each pixel's source once, at staging (as
//   the templated kernel does). Where the whole (T + 2R)^2 window does not
//   fit (with the opt-in, 227 KB), it is staged in bands: bt tile rows at
//   a time with the window rows they meet, and past that bu offset rows
//   at a time, each band restaging.
// - A work item holds kGV = 4 consecutive offsets v of one offset row u:
//   per window column read it forms four differences against the
//   reference row (a four-value window of the row slides in registers),
//   so a pixel pair costs a quarter load and two FP operations. Where the
//   offset items alone would leave more than half the threads idle (2 s_n
//   ceil(s_n / 4) <= 256 with s_n = 2R + 1: radii up to 10), an item is
//   (offsets, tile row) and the rows' sums go to shared memory first.
// - Rounding: the direct form, SSD = sum_i (sum_j (F - W)^2), each
//   row's sum an FMA chain over j and the rows added in row order from 0,
//   whichever thread forms them (the expanded form tsq + wsq - 2 cc,
//   summed in one chain of T^2 terms, cancelled to 1.5e-3 px of subpixel
//   difference from the plain version at T = 12 on an H100), so the
//   integer parts and the subpixel steps are held to the same rules as
//   the templated kernel's.
// - The surface stays in shared memory where it fits beside the staging,
//   else in the wrapper's device scratch; after the block's barrier one
//   warp takes the argmin, the gates and the fit as above (the fit only
//   where the surface has a 3 x 3 neighbourhood).
// Its time against its bound is in PERF.md.

constexpr int kGV = 4;  // consecutive offsets v of a general work item

// The general form's staging (kernels/tile_search.py::search_plan): a
// stage holds bu offset rows and bt tile rows (the whole window where
// bu = 2R + 1 and bt = T); split: (offsets, tile row) items; surf_smem:
// the surface in shared memory.
struct SearchPlan {
  int bu, bt, split, surf_smem;
};

// floats of the general form's shared memory: the tile band (bt x T), the
// window band (bu + bt - 1 rows of all offset columns, odd stride), the
// rows' sums (split) and the surface (surf_smem)
__host__ __device__ constexpr int general_stride(int t, int radius) {
  return ((2 * radius + kGV) / kGV * kGV + t - 1) | 1;
}
__host__ __device__ constexpr long long general_floats(int t, int radius, SearchPlan p) {
  return (long long)p.bt * t + (long long)(p.bu + p.bt - 1) * general_stride(t, radius) +
         (p.split ? (long long)p.bt * p.bu * ((2 * radius + kGV) / kGV * kGV) : 0) +
         (p.surf_smem ? (long long)(2 * radius + 1) * (2 * radius + 1) : 0);
}

// warp_source with the tile size a runtime argument
__device__ __forceinline__ int warp_source_rt(const float* __restrict__ sh, int y, int x, int h, int w,
                                              int ntx, int t) {
  const auto shift = [&](int yy, int xx, int c) {
    const int s = (int)__ldg(sh + ((yy / t) * ntx + xx / t) * 2 + c);
    return min(max(s, -kWarpBound), kWarpBound);
  };
  int s = shift(y, x, 1);
  int pr = x + (s - kCoarse * floor_div_coarse(s));
  const int xs = min(max(pr + kCoarse * floor_div_coarse(shift(y, min(pr, w - 1), 1)), 0), w - 1);
  s = shift(y, xs, 0);
  pr = y + (s - kCoarse * floor_div_coarse(s));
  const int ys = min(max(pr + kCoarse * floor_div_coarse(shift(min(pr, h - 1), xs, 0)), 0), h - 1);
  return ys * w + xs;
}

// One tile row's sums for kGV consecutive offsets: r[v] = sum_j (fr[j] -
// wr[v + j])^2, an FMA chain over j in order. The window row slides
// through a kGV-value ring in registers (static indices once unrolled);
// whole groups of kGV columns first, then the row's last columns.
__device__ __forceinline__ void row_sums(const float* fr, const float* wr, int t, float (&r)[kGV]) {
  float c[kGV];
#pragma unroll
  for (int v = 0; v < kGV; ++v) {
    r[v] = 0.0f;
    if (v < kGV - 1) c[v] = wr[v];
  }
  // column j = j0 + q of the row, j0 a multiple of kGV: ring slot (q + v) % kGV holds wr[j + v]
  const auto column = [&](int j0, int q) {
    c[(q + kGV - 1) % kGV] = wr[j0 + q + kGV - 1];
    const float f = fr[j0 + q];
#pragma unroll
    for (int v = 0; v < kGV; ++v) {
      const float d = f - c[(q + v) % kGV];
      r[v] = fmaf(d, d, r[v]);
    }
  };
  int j0 = 0;
  for (; j0 + kGV <= t; j0 += kGV) {
#pragma unroll
    for (int q = 0; q < kGV; ++q) column(j0, q);
  }
#pragma unroll
  for (int q = 0; q < kGV - 1; ++q) {
    if (j0 + q < t) column(j0, q);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_search_general_kernel(const float* __restrict__ ref, const float* __restrict__ alts,
                           const float* __restrict__ rounded, float* __restrict__ out, float* surf,
                           int h, int w, int ntx, int nty, int t, int radius, float threshold,
                           int subpixel, int image_mode, const SearchPlan plan) {
  extern __shared__ float smem[];
  const int s_n = 2 * radius + 1;
  const int n_v = (s_n + kGV - 1) / kGV * kGV;  // offset columns, in groups of kGV
  const int ws = general_stride(t, radius);
  const int tid = threadIdx.x;
  const int tx = blockIdx.x % ntx, ty = blockIdx.x / ntx, n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;
  const float* alt = alts + n * (long long)h * w;
  const float* sh = rounded + (long long)n * nty * ntx * 2;
  const float* pre = sh + (ty * ntx + tx) * 2;
  const float pre_y = __ldg(pre), pre_x = __ldg(pre + 1);
  const int oy = image_mode ? y0 - radius : y0 + (int)pre_y - radius;
  const int ox = image_mode ? x0 - radius : x0 + (int)pre_x - radius;
  float* tile = smem;                               // bt x t
  float* win = tile + plan.bt * t;                  // (bu + bt - 1) x ws
  float* rows = win + (plan.bu + plan.bt - 1) * ws;  // split: bt x (n_v bu)
  float* ssd = plan.surf_smem ? rows + (plan.split ? plan.bt * plan.bu * n_v : 0)
                              : surf + ((long long)n * nty * ntx + blockIdx.x) * s_n * s_n;

  // 1. the surface, SSD = sum (F - W)^2 a row's sum at a time, the rows
  // added in order: per band of offset rows [u0, u0 + nu), per band of
  // tile rows [i0, i0 + nt)
  for (int u0 = 0; u0 < s_n; u0 += plan.bu) {
    const int nu = min(plan.bu, s_n - u0);
    for (int i0 = 0; i0 < t; i0 += plan.bt) {
      const int nt = min(plan.bt, t - i0);
      __syncthreads();  // the last band's reads are done
      for (int k = tid; k < nt * t; k += kThreads) {
        const int i = k / t, j = k % t;
        cp_async4(&tile[i * t + j], ref + (long long)min(y0 + i0 + i, h - 1) * w + min(x0 + j, w - 1));
      }
      const int wr = nu + nt - 1, wc = n_v + t - 1;  // window rows u0 + i0 .. , every offset column
      for (int k = tid; k < wr * wc; k += kThreads) {
        const int a = k / wc, b = k % wc;
        const int yy = min(max(oy + u0 + i0 + a, 0), h - 1);
        const int xx = min(max(ox + b, 0), w - 1);
        const int src = image_mode ? warp_source_rt(sh, yy, xx, h, w, ntx, t) : yy * w + xx;
        cp_async4(&win[a * ws + b], alt + src);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      const int groups = n_v / kGV;
      if (!plan.split) {
        // an item: offset row u, offsets v0 .. v0 + 3, every tile row of
        // the band, its running sums in registers
        for (int item = tid; item < nu * groups; item += kThreads) {
          const int ul = item % nu, v0 = item / nu * kGV;
          float* o = ssd + (u0 + ul) * s_n + v0;
          float sum[kGV];
#pragma unroll
          for (int v = 0; v < kGV; ++v) sum[v] = (i0 > 0 && v0 + v < s_n) ? o[v] : 0.0f;
          for (int il = 0; il < nt; ++il) {
            float r[kGV];
            row_sums(tile + il * t, win + (ul + il) * ws + v0, t, r);
#pragma unroll
            for (int v = 0; v < kGV; ++v) sum[v] += r[v];
          }
#pragma unroll
          for (int v = 0; v < kGV; ++v) {
            if (v0 + v < s_n) o[v] = sum[v];
          }
        }
      } else {
        // an item: offset row u, offsets v0 .. v0 + 3 and one tile row;
        // then a thread per offset adds the band's rows in order
        for (int item = tid; item < nu * groups * nt; item += kThreads) {
          const int ul = item % nu, v0 = item / nu % groups * kGV, il = item / (nu * groups);
          float r[kGV];
          row_sums(tile + il * t, win + (ul + il) * ws + v0, t, r);
#pragma unroll
          for (int v = 0; v < kGV; ++v) rows[(il * n_v + v0 + v) * nu + ul] = r[v];
        }
        __syncthreads();
        for (int item = tid; item < nu * s_n; item += kThreads) {
          const int ul = item % nu, v = item / nu;
          float* o = ssd + (u0 + ul) * s_n + v;
          float sum = i0 > 0 ? *o : 0.0f;
          for (int il = 0; il < nt; ++il) sum += rows[(il * n_v + v) * nu + ul];
          *o = sum;
        }
      }
    }
  }
  __syncthreads();  // the block's surface stores are visible to the block

  // 2. argmin (first minimum), maximum, gates, the subpixel fit
  if (tid >= 32) return;
  const int lane = tid;
  float mn = __int_as_float(0x7f800000);
  float mx = -mn;
  int mi = INT_MAX;
  for (int k = lane; k < s_n * s_n; k += 32) {
    const float s = ssd[k];
    if (s < mn) { mn = s; mi = k; }
    mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, mn, off);
    const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (om < mn || (om == mn && oi < mi)) { mn = om; mi = oi; }
  }
  if (lane != 0) return;
  const int py = mi / s_n, px = mi % s_n;
  float dy = (float)(py - radius), dx = (float)(px - radius);
  const bool on_border = py < 1 || py >= s_n - 1 || px < 1 || px >= s_n - 1;
  if (subpixel && s_n >= 3) {
    const int cy = min(max(py, 1), s_n - 2), cx = min(max(px, 1), s_n - 2);
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = ssd[(cy - 1 + k / 3) * s_n + cx - 1 + k % 3];
    const float a11 = fmaxf(stencil_sum(p, kFA11), 0.0f);
    const float a22 = fmaxf(stencil_sum(p, kFA22), 0.0f);
    float a12 = stencil_sum(p, kFA12);
    const float b1 = stencil_sum(p, kFB1);
    const float b2 = stencil_sum(p, kFB2);
    float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
    if (det < 0.0f) {
      a12 = 0.0f;
      det = __fmul_rn(a11, a22);
    }
    float mu_x = 0.0f, mu_y = 0.0f;
    if (det != 0.0f) {
      mu_x = __fdiv_rn(__fsub_rn(__fmul_rn(a22, b1), __fmul_rn(a12, b2)), det);
      mu_y = __fdiv_rn(__fsub_rn(__fmul_rn(a11, b2), __fmul_rn(a12, b1)), det);
    }
    if (fabsf(mu_x) > 1.0f) mu_x = 0.0f;
    if (fabsf(mu_y) > 1.0f) mu_y = 0.0f;
    dy = __fsub_rn(dy, mu_y);
    dx = __fsub_rn(dx, mu_x);
  }
  if (on_border || __fadd_rn(mn, threshold) > mx) dy = dx = 0.0f;
  float* o = out + (((long long)n * nty + ty) * ntx + tx) * 2;
  o[0] = __fadd_rn(pre_y, dy);
  o[1] = __fadd_rn(pre_x, dx);
}

}  // namespace

extern "C" {

// The largest search radius whose staging fits a block's shared memory at
// tile size t (8, 16 or 32), or -1 for a tile size the kernel does not take.
int mfsr_tile_search_max_radius(int t) {
  if (t != 8 && t != 16 && t != 32) return -1;
  int r = 0;
  while ((long long)sizeof(float) * smem_floats(t, r + 1) <= kMaxSmem) ++r;
  return r;
}

// Launches the search on `stream` and returns cudaGetLastError() (0 on
// success). ref is contiguous float32 (H, W); alts contiguous float32
// (N, H, W); rounded and out contiguous float32 (N, nty, ntx, 2) over the
// ceil-divided grid of tile size t. image_mode != 0 selects the image
// windows (the fast branch), else the tile windows.
int mfsr_tile_search(const void* ref, const void* alts, const void* rounded, void* out, int n,
                     int h, int w, int t, int radius, float threshold, int subpixel,
                     int image_mode, void* stream) {
  const int max_radius = mfsr_tile_search_max_radius(t);
  if (n < 0 || n > 65535 || h < 1 || w < 1 || radius < 1 || radius > max_radius) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nty = (h + t - 1) / t, ntx = (w + t - 1) / t;
  if (nty * ntx > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const float* r = static_cast<const float*>(ref);
  const float* a = static_cast<const float*>(alts);
  const float* s = static_cast<const float*>(rounded);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 8:
      return (int)launch<8>(r, a, s, o, n, h, w, (int)ntx, (int)nty, radius, threshold, subpixel,
                            image_mode, st);
    case 16:
      return (int)launch<16>(r, a, s, o, n, h, w, (int)ntx, (int)nty, radius, threshold, subpixel,
                             image_mode, st);
    default:
      return (int)launch<32>(r, a, s, o, n, h, w, (int)ntx, (int)nty, radius, threshold, subpixel,
                             image_mode, st);
  }
}

// Launches the general form (tile_search_general_kernel) on `stream` and
// returns cudaGetLastError(). The arrays are mfsr_tile_search's, at any
// tile size t >= 1 and radius >= 0; the staging (bu, bt, split,
// surf_smem: SearchPlan) in smem_bytes of dynamic shared memory
// (kernels/tile_search.py::search_plan); where the surface is not in
// shared memory, surf is device scratch of n * nty * ntx * (2 radius +
// 1)^2 floats.
int mfsr_tile_search_general(const void* ref, const void* alts, const void* rounded, void* out,
                             void* surf, int n, int h, int w, int t, int radius, float threshold,
                             int subpixel, int image_mode, int bu, int bt, int split, int surf_smem,
                             int smem_bytes, void* stream) {
  if (n < 0 || n > 65535 || h < 1 || w < 1 || t < 1 || radius < 0 || radius > 23000) {
    return (int)cudaErrorInvalidValue;  // (2 radius + 1)^2 stays an int
  }
  const SearchPlan plan{bu, bt, split != 0, surf_smem != 0};
  if (bu < 1 || bu > 2 * radius + 1 || bt < 1 || bt > t || (!plan.surf_smem && surf == nullptr) ||
      smem_bytes > 232448 || (long long)sizeof(float) * general_floats(t, radius, plan) > smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nty = (h + t - 1) / t, ntx = (w + t - 1) / t;
  if (nty * ntx > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  if (smem_bytes > kMaxSmem) {
    const cudaError_t err = cudaFuncSetAttribute(tile_search_general_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  tile_search_general_kernel<<<dim3((unsigned)(nty * ntx), (unsigned)n), kThreads, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(alts), static_cast<const float*>(rounded),
      static_cast<float*>(out), static_cast<float*>(surf), h, w, (int)ntx, (int)nty, t, radius, threshold,
      subpixel, image_mode, plan);
  return (int)cudaGetLastError();
}

const char* mfsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
