// K5b: the gray_r colorize of a depth map, (1 - (x - lo) / max(hi - lo,
// 1e-12)) * 255 with lo, hi the map's min and max.
//
// Replaces cartoonsegmentation_tpu/pipeline/depth.py:colorize_gray_r,
// which the frame loop runs on every filled frame's depth channel
// before the bokeh (and once more for the focal planes).
//
// Bound on the card: bytes (read the map once, write it once). The
// frame loop's map is the depth channel of the filled RGBD frame, read
// in place (element stride 4), so a read fetches every sector of the
// buffer: 4x the map's own bytes.
//
// Design: one cooperative launch that reads the map once. The grid is
// blocks that are all resident at once (at most two a streaming
// multiprocessor, as many as the caller's scratch has room for); each
// thread keeps up to kHeld values of a grid-strided share in registers
// while it takes their min and max. Each block writes its min and max
// past the end of the output buffer (the caller allocates 2 floats a
// block there: no other scratch, so calls on different streams never
// share one), the grid meets at one grid-wide barrier
// (cooperative_groups, a launch that CUDA graphs capture), every block
// reduces the partials itself (a thread a partial: one round trip to
// L2) and maps its registers with a true division. A map larger than
// the grid holds reads its remainder again after the barrier. A
// channel of a 4-channel buffer is read as one 16-byte load a pixel
// from the buffer's own 16-byte alignment (the view itself starts 4c
// bytes into it): the same sectors as the strided 4-byte load, which
// measured 3% slower on an H100 (0.00748 against 0.00727 ms on a
// 576x1024 RGBD frame's depth channel).
//
// Min and max do not depend on the order of the reduction (NaN
// propagates, as torch.min/max), and the map repeats the plain
// version's operations one rounding at a time, so the result equals it
// bit for bit.
#include <cooperative_groups.h>

#include "kb_common.cuh"

namespace cg = cooperative_groups;

namespace {

// mirrored in ops/_cuda.py (COLORIZE_*), which colorize_plan sizes against
constexpr int kThreads = 512;
constexpr int kHeld = 8;   // values a thread keeps in registers

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

// Element i of the map: x[i * stride], or with VEC (stride 4) component
// c of the 16-byte pixel x4[i].
template <bool VEC>
__device__ __forceinline__ float load(const float* __restrict__ x,
                                      const float4* __restrict__ x4, int c,
                                      long long i, int stride) {
  if (VEC) {
    const float4 q = __ldg(x4 + i);
    return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
  }
  return __ldg(x + i * stride);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
colorize_kernel(const float* __restrict__ x, const float4* __restrict__ x4,
                int c, long long n, int stride, float* __restrict__ out) {
  const long long T = (long long)gridDim.x * kThreads;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  float v[kHeld];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int e = 0; e < kHeld; ++e) {
    const long long i = g + e * T;
    v[e] = i < n ? load<VEC>(x, x4, c, i, stride) : 0.0f;
    if (i < n) {
      lo = min_nan(lo, v[e]);
      hi = max_nan(hi, v[e]);
    }
  }
  for (long long i = g + kHeld * T; i < n; i += T) {
    const float w = load<VEC>(x, x4, c, i, stride);
    lo = min_nan(lo, w);
    hi = max_nan(hi, w);
  }
  block_minmax(lo, hi);
  float* part = out + n;   // 2 floats a block past the map
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = lo;
    part[2 * blockIdx.x + 1] = hi;
  }
  cg::this_grid().sync();

  lo = INFINITY;
  hi = -INFINITY;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    lo = min_nan(lo, __ldcg(part + 2 * k));
    hi = max_nan(hi, __ldcg(part + 2 * k + 1));
  }
  block_minmax(lo, hi);
  const float span = hi - lo;
  // clamp(min=1e-12) keeps a NaN
  const float d = span != span ? span : fmaxf(span, 1e-12f);
#pragma unroll
  for (int e = 0; e < kHeld; ++e) {
    const long long i = g + e * T;
    if (i < n) out[i] = (1.0f - (v[e] - lo) / d) * 255.0f;
  }
  for (long long i = g + kHeld * T; i < n; i += T)
    out[i] = (1.0f - (load<VEC>(x, x4, c, i, stride) - lo) / d) * 255.0f;
}

template <bool VEC>
cudaError_t launch(const float* x, const float4* x4, int c, long long n,
                   int stride, int blocks, float* out, cudaStream_t s) {
  // blocks a device holds at once, asked once a device
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, colorize_kernel<VEC>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident[dev] = per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  const int grid = blocks < resident[dev] ? blocks : resident[dev];
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, colorize_kernel<VEC>, x, x4, c, n, stride,
                            out);
}

}  // namespace

// x: n f32 values, element i at x[i * stride]; out: n f32, contiguous,
// followed by 2 * blocks f32 of scratch; blocks: the most blocks the
// grid may take (pipeline/depth.py:colorize_plan). Returns the launch's
// error.
extern "C" int kb_colorize(const float* x, long long n, int stride,
                           int blocks, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (stride == 4) {
    // the 16-byte pixel holding element 0, and the element's place in it
    const uintptr_t a = reinterpret_cast<uintptr_t>(x);
    const int c = (int)(a % 16) / 4;
    return (int)launch<true>(
        x, reinterpret_cast<const float4*>(a - 4 * c), c, n, stride, blocks,
        out, s);
  }
  return (int)launch<false>(x, nullptr, 0, n, stride, blocks, out, s);
}
