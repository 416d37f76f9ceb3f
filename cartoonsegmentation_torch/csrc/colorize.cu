// K5b: the gray_r colorize of a depth map, (1 - (x - lo) / max(hi - lo,
// 1e-12)) * 255 with lo, hi the map's min and max.
//
// Replaces cartoonsegmentation_tpu/pipeline/depth.py:colorize_gray_r,
// which the frame loop runs on every filled frame's depth channel
// before the bokeh (and once more for the focal planes).
//
// Bound on the card: bytes (read the map twice in principle, once in
// the bound; write it once). Two launches on the caller's stream:
//   1. partials: a fixed grid of blocks, each the min and max of a
//      grid-strided share of the map;
//   2. normalise: every block first reduces the partials itself (a few
//      hundred values, so no third launch and no atomics), then maps
//      its share with a true division.
// Min and max do not depend on the order of the reduction, and the
// map repeats the plain version's operations one rounding at a time,
// so the result equals it bit for bit. The input may be a channel of
// an interleaved buffer (element stride > 1), read in place.
#include "kb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 264;  // two a streaming multiprocessor

// torch.min / torch.max propagate NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_lo[w] = lo;
    s_hi[w] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int k = 1; k < kThreads / 32; ++k) {
    lo = min_nan(lo, s_lo[k]);
    hi = max_nan(hi, s_hi[k]);
  }
}

__global__ void partial_kernel(const float* __restrict__ x, long long n,
                               int stride, float* __restrict__ partials) {
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float v = x[i * stride];
    lo = min_nan(lo, v);
    hi = max_nan(hi, v);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = lo;
    partials[kBlocks + blockIdx.x] = hi;
  }
}

__global__ void normalize_kernel(const float* __restrict__ x, long long n,
                                 int stride,
                                 const float* __restrict__ partials,
                                 float* __restrict__ out) {
  float lo = INFINITY, hi = -INFINITY;
  for (int k = threadIdx.x; k < kBlocks; k += kThreads) {
    lo = min_nan(lo, partials[k]);
    hi = max_nan(hi, partials[kBlocks + k]);
  }
  block_minmax(lo, hi);
  const float span = hi - lo;
  // clamp(min=1e-12) keeps a NaN
  const float d = span != span ? span : fmaxf(span, 1e-12f);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float norm = (x[i * stride] - lo) / d;
    out[i] = (1.0f - norm) * 255.0f;
  }
}

}  // namespace

// x: n f32 values, element i at x[i * stride]; partials: 2 * 264 f32
// scratch; out: n f32, contiguous. Returns cudaGetLastError().
extern "C" int kb_colorize(const float* x, long long n, int stride,
                           float* partials, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  partial_kernel<<<kBlocks, kThreads, 0, s>>>(x, n, stride, partials);
  normalize_kernel<<<kBlocks, kThreads, 0, s>>>(x, n, stride, partials, out);
  return (int)cudaGetLastError();
}
