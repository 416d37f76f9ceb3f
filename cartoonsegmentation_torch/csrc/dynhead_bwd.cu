// K9t, backward: the gradients of the dynamic mask heads' logits
// (dynhead_fwd.cu) with respect to the mask features and the generated
// parameters, the VJP that JAX derives for
// cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads inside
// the detector loss (parallel/train.py:164). The priors and strides
// take no gradient (constants there).
//
// Given dlogits (B, K, h, w):
//   d mask_feat (B, h, w, 8): at each pixel, summed over the image's K
//     instances in order;
//   d kernels (B, K, 169): at each instance, summed over its h·w pixels.
// ReLU passes a gradient where its input is > 0, as JAX's and torch's.
//
// Two kernels, no float atomics, so the gradients are the same bits
// from run to run:
//   1. a block a tile of 256 pixels of one image (grid (tiles, B)), a
//      thread a pixel: for each instance in turn it recomputes the
//      forward in registers, forms the pixel's backward (the input
//      gradient added to its 8 feature sums) and stages the pixel's
//      layer values and gradients in shared memory; then threads
//      0..168 each sum one parameter's partial over the tile's pixels
//      in pixel order and write it to partials (B, K, tiles, 169);
//   2. a block an (image, instance), a thread a parameter: the sum of
//      its tiles' partials in tile order.
#include "dynhead_common.cuh"

namespace {

// a staged row of 256 pixels, padded so that rows start on other banks
constexpr int kRow = kDynTile + 1;

__global__ void __launch_bounds__(kDynTile)
    dynhead_bwd_tiles(const float* __restrict__ feat,
                      const float* __restrict__ kern,
                      const float* __restrict__ priors,
                      const float* __restrict__ strides,
                      const float* __restrict__ dlogits, int K, int h,
                      int w, float* __restrict__ partials,
                      float* __restrict__ dfeat) {
  __shared__ float k[kDynParams];
  // per pixel: the inputs, layer 1's output and its gradient, layer 2's
  // output and its gradient, the logit's gradient
  __shared__ float s_in[10 * kRow];
  __shared__ float s_h1[8 * kRow], s_d1[8 * kRow];
  __shared__ float s_h2[8 * kRow], s_d2[8 * kRow];
  __shared__ float s_g[kRow];
  const int b = blockIdx.y;
  const int tiles = gridDim.x;
  const int hw = h * w;
  const int t = threadIdx.x;
  const int p = blockIdx.x * kDynTile + t;
  const bool live = p < hw;
  float f[kDynProtos] = {};
  float df[kDynProtos] = {};
  float cx = 0.0f, cy = 0.0f;
  if (live) {
    const float* fp = feat + ((size_t)b * hw + p) * kDynProtos;
#pragma unroll
    for (int c = 0; c < kDynProtos; ++c) f[c] = fp[c];
    cx = (float)(p % w) * 8.0f;
    cy = (float)(p / w) * 8.0f;
  }
  for (int n = 0; n < K; ++n) {
    const int bn = b * K + n;
    __syncthreads();  // the last instance's sums have read the stage
    if (t < kDynParams) k[t] = kern[(size_t)bn * kDynParams + t];
    __syncthreads();
    DynAct a = {};
    float g = 0.0f;
    float d1[8] = {}, d2[8] = {};
    if (live) {
      dyn_inputs(a, priors[2 * bn], priors[2 * bn + 1], strides[bn], cx, cy,
                 f);
      dyn_forward(k, a);
      g = dlogits[(size_t)bn * hw + p];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        d2[c] = a.a2[c] > 0.0f ? g * k[kDynW3 + c] : 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float acc = d2[0] * k[kDynW2 + c];
#pragma unroll
        for (int o = 1; o < 8; ++o) acc = acc + d2[o] * k[kDynW2 + o * 8 + c];
        d1[c] = a.a1[c] > 0.0f ? acc : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kDynProtos; ++c) {
        float acc = d1[0] * k[kDynW1 + 2 + c];
#pragma unroll
        for (int o = 1; o < 8; ++o)
          acc = acc + d1[o] * k[kDynW1 + o * 10 + 2 + c];
        df[c] = df[c] + acc;
      }
    }
#pragma unroll
    for (int c = 0; c < 10; ++c) s_in[c * kRow + t] = a.in[c];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s_h1[c * kRow + t] = a.h1[c];
      s_d1[c * kRow + t] = d1[c];
      s_h2[c * kRow + t] = a.h2[c];
      s_d2[c * kRow + t] = d2[c];
    }
    s_g[t] = g;
    __syncthreads();
    if (t < kDynParams) {
      // parameter t's partial: a product of two staged rows (or one row
      // for a bias), summed over the tile's pixels in order
      const float* x;
      const float* y = nullptr;
      if (t < kDynW2) {
        x = s_d1 + (t / 10) * kRow;
        y = s_in + (t % 10) * kRow;
      } else if (t < kDynW3) {
        x = s_d2 + ((t - kDynW2) / 8) * kRow;
        y = s_h1 + ((t - kDynW2) % 8) * kRow;
      } else if (t < kDynB1) {
        x = s_g;
        y = s_h2 + (t - kDynW3) * kRow;
      } else if (t < kDynB2) {
        x = s_d1 + (t - kDynB1) * kRow;
      } else if (t < kDynB3) {
        x = s_d2 + (t - kDynB2) * kRow;
      } else {
        x = s_g;
      }
      float acc = 0.0f;
      if (y != nullptr) {
        for (int q = 0; q < kDynTile; ++q) acc = acc + x[q] * y[q];
      } else {
        for (int q = 0; q < kDynTile; ++q) acc = acc + x[q];
      }
      partials[((size_t)bn * tiles + blockIdx.x) * kDynParams + t] = acc;
    }
  }
  if (live) {
    float* dp = dfeat + ((size_t)b * hw + p) * kDynProtos;
#pragma unroll
    for (int c = 0; c < kDynProtos; ++c) dp[c] = df[c];
  }
}

__global__ void dynhead_bwd_sum(const float* __restrict__ partials,
                                int tiles, float* __restrict__ dkern) {
  const int bn = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= kDynParams) return;
  const float* src = partials + (size_t)bn * tiles * kDynParams + j;
  float acc = 0.0f;
  for (int q = 0; q < tiles; ++q) acc = acc + src[(size_t)q * kDynParams];
  dkern[(size_t)bn * kDynParams + j] = acc;
}

}  // namespace

// feat (B, h, w, 8), kern (B, K, 169), priors (B, K, 2), strides (B, K),
// dlogits (B, K, h, w) f32; partials (B, K, tiles, 169) f32 scratch
// (tiles = ceil(h·w / 256)); dfeat (B, h, w, 8) and dkern (B, K, 169) f32
// outputs. Returns cudaGetLastError().
extern "C" int kb_dynhead_bwd(const float* feat, const float* kern,
                              const float* priors, const float* strides,
                              const float* dlogits, int B, int K, int h,
                              int w, float* partials, float* dfeat,
                              float* dkern, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  const int tiles = (h * w + kDynTile - 1) / kDynTile;
  dynhead_bwd_tiles<<<dim3(tiles, B), kDynTile, 0, s>>>(
      feat, kern, priors, strides, dlogits, K, h, w, partials, dfeat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return 0;
  dynhead_bwd_sum<<<B * K, 192, 0, s>>>(partials, tiles, dkern);
  return (int)cudaGetLastError();
}
