// K7, second half: the asymmetric 3x3 laplacian with replicate padding.
//
// Replaces cartoonsegmentation_tpu/ops/filters.py:laplacian_filter (the
// point-cloud validity mask, valid_depth_mask).
//
// x is (B, H, W, C) channel-last; a block covers a 32x8 tile of one
// (b, c) plane and stages it in shared memory with its halo (clamped
// indices), then one thread computes 4x - up - up_right - left -
// down_left, left to right in f32 as the JAX expression is written (4x
// is exact, and the sources are built with -fmad=false).
//
// Bound on the card: the bytes, each value read and written once
// (0.0014 ms at 576x1024x1); the kernel takes ~0.005 ms, under half
// of cuDNN's convolution of the same stencil. A call's time is mostly
// the host's, so the launch path (ops/_cuda.py: entry points typed
// once, the raw stream handle) and the wrapper (no reshapes) are kept
// short.
#include "kb_common.cuh"

namespace {

constexpr int TX = 32, TY = 8;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

__global__ void laplacian_kernel(const float* __restrict__ x, int H, int W,
                                 int C, float* __restrict__ out) {
  __shared__ float tile[TY + 2][TX + 2];
  const int b = blockIdx.z / C, c = blockIdx.z - b * C;
  const long long plane = (long long)b * H * W * C + c;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int i = threadIdx.y * TX + threadIdx.x; i < (TY + 2) * (TX + 2);
       i += TX * TY) {
    const int ty = i / (TX + 2), tx = i - ty * (TX + 2);
    const int sy = clamp_index(y0 + ty - 1, H);
    const int sx = clamp_index(x0 + tx - 1, W);
    tile[ty][tx] = x[plane + ((long long)sy * W + sx) * C];
  }
  __syncthreads();
  const int xx = x0 + threadIdx.x, yy = y0 + threadIdx.y;
  if (xx >= W || yy >= H) return;
  const int ty = threadIdx.y + 1, tx = threadIdx.x + 1;
  // halo cells past the frame hold the clamped (edge) values
  float r = 4.0f * tile[ty][tx];
  r = r - tile[ty - 1][tx];
  r = r - tile[ty - 1][tx + 1];
  r = r - tile[ty][tx - 1];
  r = r - tile[ty + 1][tx - 1];
  out[plane + ((long long)yy * W + xx) * C] = r;
}

}  // namespace

// x, out (B, H, W, C) f32; H, W >= 3. Returns cudaGetLastError().
extern "C" int kb_laplacian(const float* x, int B, int H, int W, int C,
                            float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * H * W * C > 0)
    laplacian_kernel<<<dim3((W + TX - 1) / TX, (H + TY - 1) / TY, B * C),
                       dim3(TX, TY), 0, s>>>(x, H, W, C, out);
  return (int)cudaGetLastError();
}
