// K9t, forward: the RTMDet-Ins dynamic mask heads' logits for training.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads
// as the detector loss (parallel/train.py:164) calls it, on a batch:
// mask_feat (B, h, w, 8), kernels (B, K, 169), priors (B, K, 2),
// strides (B, K) f32 → logits (B, K, h, w) f32. Its backward is
// dynhead_bwd.cu.
//
// The maths, one rounding at a time as the plain version
// (cartoonsegmentation_torch/models/rtmdet.py:dynamic_mask_heads):
//   rel = (prior_n - 8·(x, y)) / (stride_n · 8)   (a true f32 division)
//   in  = [rel_x, rel_y, feat[p, 0..7]]           (rel first)
//   10 → 8 (ReLU) → 8 (ReLU) → 1 with instance n's 169 generated
//   parameters (weights (cout, cin) row-major, then the biases); each
//   output the sum over the inputs in order, then the bias.
//
// A block takes a tile of 256 pixels of one image (grid (tiles, B)), a
// thread a pixel; the block stages each instance's 169 parameters in
// shared memory in turn and every thread writes that instance's logit
// of its pixel.
#include "dynhead_common.cuh"

namespace {

__global__ void __launch_bounds__(kDynTile)
    dynhead_fwd_kernel(const float* __restrict__ feat,
                       const float* __restrict__ kern,
                       const float* __restrict__ priors,
                       const float* __restrict__ strides, int K, int h,
                       int w, float* __restrict__ logits) {
  __shared__ float k[kDynParams];
  const int b = blockIdx.y;
  const int hw = h * w;
  const int p = blockIdx.x * kDynTile + threadIdx.x;
  const bool live = p < hw;
  float f[kDynProtos] = {};
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
    __syncthreads();
    if (threadIdx.x < kDynParams)
      k[threadIdx.x] = kern[(size_t)bn * kDynParams + threadIdx.x];
    __syncthreads();
    if (!live) continue;
    DynAct a;
    dyn_inputs(a, priors[2 * bn], priors[2 * bn + 1], strides[bn], cx, cy,
               f);
    logits[(size_t)bn * hw + p] = dyn_forward(k, a);
  }
}

}  // namespace

// feat (B, h, w, 8), kern (B, K, 169), priors (B, K, 2), strides (B, K)
// f32; logits (B, K, h, w) f32 output. Returns cudaGetLastError().
extern "C" int kb_dynhead_fwd(const float* feat, const float* kern,
                              const float* priors, const float* strides,
                              int B, int K, int h, int w, float* logits,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0 || h <= 0 || w <= 0) return 0;
  const int tiles = (h * w + kDynTile - 1) / kDynTile;
  dynhead_fwd_kernel<<<dim3(tiles, B), kDynTile, 0, s>>>(
      feat, kern, priors, strides, K, h, w, logits);
  return (int)cudaGetLastError();
}
