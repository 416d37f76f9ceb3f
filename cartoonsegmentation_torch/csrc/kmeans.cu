// K12a: k-means labels of the CRF's colour guide (Lloyd's algorithm).
//
// Replaces cartoonsegmentation_tpu/ops/crf.py:_kmeans_labels (:55-74):
// N points of 3 channels, k clusters (10 in the CRF), 8 iterations of
// assign + recentre, then a final assignment. The init is the points
// arange(k) * (N / k); the first minimum wins a tie (jnp.argmin); a
// cluster that gets no point keeps its centre.
//
// Bound on the card (chip_smoke.py's bound()): operations. The
// colours read once and the labels written once are 16 B a point
// (9.4 MB at 576 x 1024, 2.8 us at 3.35 TB/s); the arithmetic is ~9
// f32 operations a point and cluster in each of the 9 assignments and
// 4 a point in each of the 8 recentrings (0.50 G, 7.4 us at 67
// TFLOP/s). This kernel reads the colours once a pass, 9 times a
// call. The JAX
// version sums the clusters with a one-hot matmul; here the sums are
// repeatable from run to run (no atomics): each block of 256 threads
// owns 1024 consecutive points, every thread accumulates its 4 points
// per cluster in registers, a fixed shuffle tree and a fixed walk over
// the warps give the block's partial (sums and count per cluster), and
// one block adds the partials in block order into the new centres.
// Launches a call: 1 init + iters x (assign + reduce) + 1 final assign.
#include "kb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockPoints = kThreads * kPerThread;  // KMEANS_BLOCK_POINTS
constexpr int kMaxK = 16;                            // KMEANS_MAX_K
constexpr int kReduceThreads = 128;

__global__ void init_kernel(const float* __restrict__ colors, int N, int k,
                            float* __restrict__ centers) {
  const int c = threadIdx.x;
  if (c < k) {
    const long long i = (long long)c * (N / k);
    for (int d = 0; d < 3; ++d) centers[c * 3 + d] = colors[i * 3 + d];
  }
}

// Nearest centre of point p, strict < so the first minimum wins. The
// squared distance is fma(d2, d2, fma(d1, d1, d0 d0)): XLA's CPU code
// contracts the JAX version's sum of squares so, and exact ties
// between centres are common on flat colours.
__device__ __forceinline__ int nearest(const float* p, const float* cs,
                                       int k) {
  int best = 0;
  float bd = INFINITY;
  for (int c = 0; c < k; ++c) {
    const float d0 = p[0] - cs[c * 3], d1 = p[1] - cs[c * 3 + 1],
                d2 = p[2] - cs[c * 3 + 2];
    const float d = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, d0 * d0));
    if (d < bd) {
      bd = d;
      best = c;
    }
  }
  return best;
}

// One assignment pass over the block's points. With partials, writes
// the block's (sum x, sum y, sum z, count) per cluster; with labels,
// writes each point's label.
__global__ void __launch_bounds__(kThreads)
    assign_kernel(const float* __restrict__ colors, int N, int k,
                  const float* __restrict__ centers,
                  float* __restrict__ partials, int* __restrict__ labels) {
  __shared__ float cs[kMaxK * 3];
  __shared__ float warp_part[kThreads / 32][kMaxK * 4];
  if (threadIdx.x < k * 3) cs[threadIdx.x] = centers[threadIdx.x];
  __syncthreads();
  float acc[kMaxK][4];
#pragma unroll
  for (int c = 0; c < kMaxK; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.0f;
  const long long base = (long long)blockIdx.x * kBlockPoints;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i >= N) break;
    float p[3] = {colors[i * 3], colors[i * 3 + 1], colors[i * 3 + 2]};
    const int lbl = nearest(p, cs, k);
    if (labels) labels[i] = lbl;
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) {
      const bool m = c == lbl;
      acc[c][0] += m ? p[0] : 0.0f;
      acc[c][1] += m ? p[1] : 0.0f;
      acc[c][2] += m ? p[2] : 0.0f;
      acc[c][3] += m ? 1.0f : 0.0f;
    }
  }
  if (!partials) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxK; ++c) {
    if (c >= k) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[c][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_part[warp][c * 4 + j] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < k * 4) {
    float v = warp_part[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) v += warp_part[w][threadIdx.x];
    partials[(long long)blockIdx.x * k * 4 + threadIdx.x] = v;
  }
}

// New centres from the blocks' partials, added in block order:
// sum / max(count, 1) where the count is positive, else the old centre.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ partials, int n_blocks, int k,
                  float* __restrict__ centers) {
  __shared__ float warp_tot[kReduceThreads / 32][kMaxK * 4];
  __shared__ float tot[kMaxK * 4];
  float acc[kMaxK * 4];
#pragma unroll
  for (int v = 0; v < kMaxK * 4; ++v) acc[v] = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads) {
    const float* row = partials + (long long)b * k * 4;
#pragma unroll
    for (int v = 0; v < kMaxK * 4; ++v)
      if (v < k * 4) acc[v] += row[v];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < kMaxK * 4; ++v) {
    if (v >= k * 4) break;
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_tot[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < k * 4) {
    float x = warp_tot[0][threadIdx.x];
    for (int w = 1; w < kReduceThreads / 32; ++w)
      x += warp_tot[w][threadIdx.x];
    tot[threadIdx.x] = x;
  }
  __syncthreads();
  if (threadIdx.x < k * 3) {
    const int c = threadIdx.x / 3, d = threadIdx.x % 3;
    const float cnt = tot[c * 4 + 3];
    if (cnt > 0.0f) centers[c * 3 + d] = tot[c * 4 + d] / fmaxf(cnt, 1.0f);
  }
}

}  // namespace

// colors: (N, 3) f32; centers: (k, 3) f32 scratch; partials:
// (ceil(N / 1024), k, 4) f32 scratch; labels: (N,) int32 out.
// 1 <= k <= 16. Returns cudaGetLastError().
extern "C" int kb_kmeans(const float* colors, int N, int k, int iters,
                         float* centers, float* partials, int* labels,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + kBlockPoints - 1) / kBlockPoints;
  init_kernel<<<1, 32, 0, s>>>(colors, N, k, centers);
  for (int it = 0; it < iters; ++it) {
    assign_kernel<<<n_blocks, kThreads, 0, s>>>(colors, N, k, centers,
                                                partials, nullptr);
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, n_blocks, k,
                                               centers);
  }
  assign_kernel<<<n_blocks, kThreads, 0, s>>>(colors, N, k, centers, nullptr,
                                              labels);
  return (int)cudaGetLastError();
}
