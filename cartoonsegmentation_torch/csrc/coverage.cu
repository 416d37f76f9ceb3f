// K2: autozoom coverage counts for a batch of candidate camera shifts.
//
// Replaces cartoonsegmentation_tpu/ops/pointcloud.py:
// render_coverage_fast as driven by ops/camera.py:_autozoom_search —
// for each candidate shift, the number of pixels that receive a
// positive bilinear weight from the shifted cloud (no z-test).
//
// Bound on the card: instruction issue. The main path scores 256
// candidates on the stride-2 miniature (~147 k points, 288x512
// raster): ~38 M (candidate, point) pairs, each two IEEE divisions, the
// corner tests and up to four bits to set.
//
// Design: one launch. A block owns the bitmaps of G candidates (one
// bit a pixel) in shared memory, zeroes them, walks the whole cloud and
// counts them with __popc at the end: no global scratch, no zero pass.
// The cloud comes in tiles of 4096 points (four a thread), copied by
// cp.async.bulk into two shared buffers on an mbarrier each, so a point
// is read from L2 once a block (not once a candidate) while the next
// tile is in flight. Each thread reads its points, applies the
// candidate-independent z/(z + 1e-7) once, and tests them against the
// G candidates (four independent chains of divisions in flight). The
// lanes of a warp take points 32 apart (skewed so that their reads hit
// 32 banks): in the grid-ordered cloud they land ~32 pixels apart, so
// their bits fall in different words and the shared atomicOr of a
// warp rarely collide; a thread merges the two corners of a row that
// share a word into one atomicOr. Combining the lanes' bits within the
// warp first (__match_any_sync + __reduce_or_sync a row, lanes on
// consecutive points, one atomicOr a distinct word) measured 2-3x
// slower on an H100 (0.435 against 0.207 ms on a synthetic miniature,
// 0.644 against 0.209 on a real clip's, 0.443 against 0.221 with a
// third of the points on one pixel): the two match and two reductions
// a (point, candidate) cost more than the atomics that spacing
// already keeps apart. A point whose corners all miss the frame (or
// the band) is dropped on u and v before any floor.
// A raster whose bitmap does not fit one block (coverage_plan in
// ops/pointcloud.py) takes the same kernel in row bands: block (group,
// band) keeps the corners in its rows and adds its counts with an
// integer atomicAdd, exact in any order.
//
// The arithmetic is the plain version's, one rounding at a time (built
// with -fmad=false; true divisions): a pixel is covered iff some corner
// weight is > 0, which is what the plain version's weight sum > 0
// tests (weights are never negative, and a sum of positive f32 stays
// positive).
#include "kb_common.cuh"

namespace {

// mirrored in ops/_cuda.py (COVER_*), which coverage_plan sizes against
constexpr int kThreads = 1024;
constexpr int kPer = 4;                    // points a thread a tile
constexpr int kTile = kThreads * kPer;     // points a tile
constexpr int kMaxGroup = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival on bar, expecting the bytes of a bulk copy of src to dst
// (none for an empty tile).
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 ::"r"(smem_addr(bar)) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The bulk copy of tile t: its points' bytes rounded down to 16 (the
// copy's unit); the last 1-3 floats of a ragged last tile are read
// from global memory by their thread.
__device__ __forceinline__ uint32_t tile_bytes(int N, int t) {
  const long long left = (long long)N - (long long)t * kTile;
  const int cnt = left < kTile ? (int)left : kTile;
  return (uint32_t)(12 * cnt) & ~15u;
}

// Bits b (left corner) and b + 1 (right corner) of a band bitmap.
__device__ __forceinline__ void set_row(uint32_t* bm, int b, bool left,
                                        bool right) {
  if (left && right && (b & 31) != 31) {
    atomicOr(bm + (b >> 5), 3u << (b & 31));
    return;
  }
  if (left) atomicOr(bm + (b >> 5), 1u << (b & 31));
  if (right) atomicOr(bm + ((b + 1) >> 5), 1u << ((b + 1) & 31));
}

// An integer-valued float of magnitude < 2^22 as an int: the sum with
// 1.5 * 2^23 holds it in its low mantissa bits (a full-rate add in
// place of a conversion).
__device__ __forceinline__ int small_int(float f) {
  return __float_as_int(f + 12582912.0f) - 0x4B400000;
}

__global__ void __launch_bounds__(kThreads, 1)
coverage_kernel(const float* __restrict__ pts, int N,
                const float* __restrict__ shifts, int K, int H, int W,
                float focal, int G, int band_rows,
                int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 16);   // 2 tiles of xyz
  uint32_t* bits = reinterpret_cast<uint32_t*>(buf + 2 * 3 * kTile);
  __shared__ float s_shift[3 * kMaxGroup];
  __shared__ int s_part[kThreads / 32][kMaxGroup];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * G;
  const int r0 = blockIdx.y * band_rows;
  const int r1 = min(H, r0 + band_rows);
  const int words = (band_rows * W + 31) >> 5;   // one band bitmap
  const int n_tiles = (N + kTile - 1) / kTile;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(smem_addr(bars)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(smem_addr(bars + 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < 2 && t < n_tiles; ++t)
      bulk_load(buf + 3 * kTile * t, pts + 3LL * kTile * t,
                tile_bytes(N, t), bars + t);
  }
  if (tid < 3 * G) {
    const int k = k0 + tid / 3;
    s_shift[tid] = k < K ? shifts[3 * k0 + tid] : 0.0f;
  }
  for (int j = tid; j < G * words; j += kThreads) bits[j] = 0u;
  __syncthreads();

  const float Wf = (float)W, r0f = (float)r0, r1f = (float)r1;
  const float cu = 0.5f * (float)W, cv = 0.5f * (float)H;
  const int ng = min(G, K - k0);
  // in each run of 1024 points of a tile, lane l of warp w takes point
  // 32 l + (w + l) mod 32
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = 32 * lane + ((warp + lane) & 31);
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    bar_wait(bars + b, (uint32_t)(t >> 1) & 1u);
    const float* tile = buf + 3 * kTile * b;
    const uint32_t copied = tile_bytes(N, t);
    float xr[kPer], yr[kPer], z[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads;
      const long long gi = (long long)t * kTile + p;
      float x = 0.0f, y = 0.0f;
      z[j] = 0.0f;
      if (gi < N) {
        const float* src = 12u * (uint32_t)(p + 1) <= copied
                               ? tile + 3 * p : pts + 3 * gi;
        x = src[0];
        y = src[1];
        z[j] = src[2];
      }
      xr[j] = x;
      yr[j] = y;
    }
    __syncthreads();   // every thread has read buffer b
    if (tid == 0 && t + 2 < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(buf + 3 * kTile * b, pts + 3LL * kTile * (t + 2),
                tile_bytes(N, t + 2), bars + b);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // shift_points: xy * z/(z + 1e-7) + shift, z + shift_z
      const float ratio = z[j] / (z[j] + 1e-7f);
      xr[j] = xr[j] * ratio;
      yr[j] = yr[j] * ratio;
    }
    for (int g = 0; g < ng; ++g) {
      const float sx = s_shift[3 * g], sy = s_shift[3 * g + 1];
      const float sz = s_shift[3 * g + 2];
      uint32_t* bm = bits + g * words;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if ((long long)t * kTile + p0 + j * kThreads >= N) continue;
        const float xs = xr[j] + sx, ys = yr[j] + sy, zs = z[j] + sz;
        if (!(zs >= 0.001f)) continue;   // kb_project's valid
        const float u = xs * focal / zs + cu - 0.5f;
        const float v = ys * focal / zs + cv - 0.5f;
        // some corner in the frame's columns and the band's rows:
        // floor(u) in [-1, W - 1], floor(v) in [r0 - 1, r1 - 1] (false
        // for NaN)
        if (!(u >= -1.0f && u < Wf && v >= r0f - 1.0f && v < r1f)) continue;
        const float x0 = floorf(u), y0 = floorf(v);
        const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
        const bool in_x0 = x0 >= 0.0f, in_x1 = x1 < Wf;
        const bool in_y0 = y0 >= r0f, in_y1 = y1 < r1f;
        // kb_corner's weights, NW NE SW SE
        const float fx = u - x0, fy = v - y0;
        const bool nw = (1.0f - fx) * (1.0f - fy) > 0.0f;
        const bool ne = fx * (1.0f - fy) > 0.0f;
        const bool sw = (1.0f - fx) * fy > 0.0f;
        const bool se = fx * fy > 0.0f;
        // (x0, y0)'s bit in the band bitmap, exact in f32 (< 2^22)
        const int b0 = small_int((y0 - r0f) * Wf + x0);
        if (in_y0) set_row(bm, b0, in_x0 && nw, in_x1 && ne);
        if (in_y1) set_row(bm, b0 + W, in_x0 && sw, in_x1 && se);
      }
    }
  }
  __syncthreads();

  for (int g = 0; g < ng; ++g) {
    int n = 0;
    for (int j = tid; j < words; j += kThreads) n += __popc(bits[g * words + j]);
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (lane == 0) s_part[warp][g] = n;
  }
  __syncthreads();
  if (tid < ng) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_part[w][tid];
    if (gridDim.y == 1)
      counts[k0 + tid] = total;
    else
      atomicAdd(counts + k0 + tid, total);
  }
}

}  // namespace

// points (N,3) f32, 16-byte aligned; shifts (K,3) f32; counts (K) int32
// out. G candidates a block, bands of band_rows rows (band_rows = H: one
// band), as ops/pointcloud.py:coverage_plan chooses them. Several bands
// add their counts into counts, zeroed here first. Returns
// cudaGetLastError().
extern "C" int kb_coverage(const float* points, int N, const float* shifts,
                           int K, int H, int W, float focal, int G,
                           int band_rows, int* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0) return (int)cudaGetLastError();
  if (G < 1 || G > kMaxGroup || band_rows < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int words = (band_rows * W + 31) / 32;
  const size_t smem = 16 + sizeof(float) * 2 * 3 * kTile +
                      sizeof(uint32_t) * (size_t)G * words;
  static size_t smem_set = 48 * 1024;   // raised as a plan needs it
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        coverage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int bands = (H + band_rows - 1) / band_rows;
  if (bands > 1) {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * K, s);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((K + G - 1) / G), (unsigned)bands);
  coverage_kernel<<<grid, kThreads, smem, s>>>(points, N, shifts, K, H, W,
                                               focal, G, band_rows, counts);
  return (int)cudaGetLastError();
}
