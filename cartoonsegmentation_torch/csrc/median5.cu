// K7, first half: the 5x5 median with reflect padding.
//
// Replaces cartoonsegmentation_tpu/ops/filters.py:median_filter (the
// median-5 gate of `existing` in the Inpaint net).
//
// x is (B, H, W, C) channel-last; a block covers a 32x8 tile of one
// (b, c) plane and stages it in shared memory with its halo (reflected
// indices), then one thread computes one pixel: the 25 taps go into
// registers and an odd-even transposition network sorts them; the 13th
// is the median, so the result equals the plain version's sort exactly.
// The network does 300 compare-exchanges a pixel where a median-of-25
// selection network needs 99: the function's bound counts the 99.
#include "kb_common.cuh"

namespace {

constexpr int TX = 32, TY = 8;

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

__global__ void median5_kernel(const float* __restrict__ x, int H, int W,
                               int C, float* __restrict__ out) {
  __shared__ float tile[TY + 4][TX + 4];
  const int b = blockIdx.z / C, c = blockIdx.z - b * C;
  const long long plane = (long long)b * H * W * C + c;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int i = threadIdx.y * TX + threadIdx.x; i < (TY + 4) * (TX + 4);
       i += TX * TY) {
    const int ty = i / (TX + 4), tx = i - ty * (TX + 4);
    const int sy = reflect_index(min(y0 + ty - 2, H + 1), H);
    const int sx = reflect_index(min(x0 + tx - 2, W + 1), W);
    tile[ty][tx] = x[plane + ((long long)sy * W + sx) * C];
  }
  __syncthreads();
  const int xx = x0 + threadIdx.x, yy = y0 + threadIdx.y;
  if (xx >= W || yy >= H) return;
  float v[25];
#pragma unroll
  for (int dy = 0; dy < 5; ++dy)
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
      v[dy * 5 + dx] = tile[threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
  for (int p = 0; p < 25; ++p)
#pragma unroll
    for (int i = p & 1; i + 1 < 25; i += 2) {
      const float a = v[i], e = v[i + 1];
      v[i] = fminf(a, e);
      v[i + 1] = fmaxf(a, e);
    }
  out[plane + ((long long)yy * W + xx) * C] = v[12];
}

}  // namespace

// x, out (B, H, W, C) f32; H, W >= 3. Returns cudaGetLastError().
extern "C" int kb_median5(const float* x, int B, int H, int W, int C,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * H * W * C > 0)
    median5_kernel<<<dim3((W + TX - 1) / TX, (H + TY - 1) / TY, B * C),
                     dim3(TX, TY), 0, s>>>(x, H, W, C, out);
  return (int)cudaGetLastError();
}
