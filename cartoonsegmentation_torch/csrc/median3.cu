// K7, third entry: the 3x3 median with reflect padding.
//
// Replaces cartoonsegmentation_tpu/ops/filters.py:median_filter at size
// 3 (spatial_filter('median-3')): jnp.sort of the 9 reflected taps,
// element 4, in JAX's order -inf < finite < +inf < NaN with -0 equal to
// +0. So the output is NaN exactly where 5 or more of the taps are NaN,
// and the 5th tap in that order elsewhere.
//
// The order is csrc/median5.cu's: each tap becomes an int key (every NaN
// as +NaN, then b ^ ((b >> 31) & 0x7fffffff)), whose signed order is
// that order but for -0 just below +0, which only picks the sign of a
// zero output. The comparators are integer min and max.
//
// The selection: x is (B, H, W, C) channel-last; one thread an output,
// a block of 32x8 threads a 32x8 tile of one (b, c) plane. Each thread
// reads its 9 reflected taps (neighbouring threads read neighbouring
// columns; the L1 serves the 9 reads of each value) and selects their
// 5th with the 19 compare-exchanges of Paeth's median-of-9 network
// (KB_MEDIAN9); the compiler drops the halves that feed no output.
// tests/test_torch_utils_api.py reads the network from this file and
// proves it exact over all 2^9 inputs of 0s and 1s.
//
// Bound on the card: the bytes, each value read and written once
// (0.0014 ms at 576x1024x1); 19 compare-exchanges a pixel take less at
// the f32 rate.
#include "kb_common.cuh"

namespace {

constexpr int TX = 32;  // columns a block, a thread a column
constexpr int TY = 8;   // rows a block

// min to the first wire, max to the second
#define KB_CE(i, j)                          \
  {                                          \
    const int lo_ = min(v[i], v[j]);         \
    v[j] = max(v[i], v[j]);                  \
    v[i] = lo_;                              \
  }
// Paeth's median-of-9 network (19 comparators): v[4] is the 5th
#define KB_MEDIAN9(X)                                                  \
  X(1, 2) X(4, 5) X(7, 8) X(0, 1) X(3, 4) X(6, 7) X(1, 2) X(4, 5)      \
  X(7, 8) X(0, 3) X(5, 8) X(4, 7) X(3, 6) X(1, 4) X(2, 5) X(4, 7)      \
  X(2, 4) X(4, 6) X(2, 4)

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

__device__ __forceinline__ int order_key(float f) {
  int b = __float_as_int(f);
  b = (b & 0x7fffffff) > 0x7f800000 ? 0x7fc00000 : b;
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(TX * TY)
    median3_kernel(const float* __restrict__ x, int H, int W, int C,
                   float* __restrict__ out) {
  const int b = blockIdx.z / C, c = blockIdx.z - b * C;
  const long long plane = (long long)b * H * W * C + c;
  const int xx = blockIdx.x * TX + threadIdx.x;
  const int yy = blockIdx.y * TY + threadIdx.y;
  if (xx >= W || yy >= H) return;
  int v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const long long row = plane + (long long)reflect_index(yy + dy - 1, H) *
                                      W * C;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      v[3 * dy + dx] =
          order_key(x[row + (long long)reflect_index(xx + dx - 1, W) * C]);
  }
  KB_MEDIAN9(KB_CE)
  out[plane + ((long long)yy * W + xx) * C] = key_value(v[4]);
}

}  // namespace

// x, out (B, H, W, C) f32; H, W >= 2. Returns cudaGetLastError().
extern "C" int kb_median3(const float* x, int B, int H, int W, int C,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * H * W * C > 0)
    median3_kernel<<<dim3((W + TX - 1) / TX, (H + TY - 1) / TY, B * C),
                     dim3(TX, TY), 0, s>>>(x, H, W, C, out);
  return (int)cudaGetLastError();
}
