// K9t, forward: the RTMDet-Ins dynamic mask heads' logits for training.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads
// as the detector loss (parallel/train.py:164) calls it, on a batch:
// mask_feat (B, h, w, 8), kernels (B, K, 169), priors (B, K, 2),
// strides (B, K) f32 → logits (B, K, h, w) f32. Its backward is
// dynhead_bwd.cu.
//
// The maths (cartoonsegmentation_torch/models/rtmdet.py:
// dynamic_mask_heads):
//   rel = (prior_n - 8·(x, y)) / (stride_n · 8)
//   in  = [rel_x, rel_y, feat[p, 0..7]]
//   10 → 8 (ReLU) → 8 (ReLU) → 1 with instance n's 169 generated
//   parameters.
// Each output starts at its bias and adds its inputs' products in
// order by FMA, where the plain version adds rounded products and then
// the bias: a logit is continuous in the layers' values, so the two
// agree to a few ulps of them, not bit for bit.
//
// What bounds it on the H100: operations, 152 multiply-adds a (pixel,
// instance), ~1.9 µs at B = 8, K = 8, 80x80 against the f32 peak (the
// features in and logits out take ~1 µs of HBM). What the design does:
// - a warp takes one instance over a run of `chunk` pixels of its
//   image (models/rtmdet.py:dynhead_fwd_plan: B·K·chunks ≈ 8 warps an
//   SM, one wave; 1,024 warps of 13 pixels a lane at the training
//   shape), a lane every 32nd pixel;
// - the instance's 169 parameters sit in registers, loaded once a warp
//   (read coalesced into shared memory, then 43 16-byte broadcasts,
//   against ~2,400 FMA-pipe instructions a lane), so no product reads a
//   weight through the shared-memory pipe, whose 32 words a cycle an SM
//   feed only a quarter of the FMA rate;
// - 152 FMAs a (pixel, instance) where 304 unfused instructions would
//   run; the next pixel's features load while this one computes.
// Route: FMAs on the CUDA cores. On the tensor cores layers 1-2 would
// need 3xTF32 (9 mma.sync m16n8k8 a 16-pixel tile of an instance) and
// the per-pixel inputs moved into fragment layouts, for products that
// take 144 FMAs a pixel here. Measured on an H100 80GB HBM3 at 700 W:
// 0.0071 ms of device time at the training shape, 27% of the bound;
// a warp spends ~3,000 SM cycles loading its weights and ~8,800 on its
// 13 pixels a lane (kernel_phases.py).
#include "dynhead_common.cuh"

namespace {

// one pixel's logit under parameters k (registers)
__device__ __forceinline__ float dyn_logit(const float (&k)[kDynParams],
                                           const float (&in)[10]) {
  float h1[8], h2[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = k[kDynB1 + o];
#pragma unroll
    for (int c = 0; c < 10; ++c)
      acc = __fmaf_rn(in[c], k[kDynW1 + 10 * o + c], acc);
    h1[o] = dyn_relu(acc);
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = k[kDynB2 + o];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc = __fmaf_rn(h1[c], k[kDynW2 + 8 * o + c], acc);
    h2[o] = dyn_relu(acc);
  }
  float logit = k[kDynB3];
#pragma unroll
  for (int c = 0; c < 8; ++c) logit = __fmaf_rn(h2[c], k[kDynW3 + c], logit);
  return logit;
}

__global__ void __launch_bounds__(32)
    dynhead_fwd_kernel(const float* __restrict__ feat,
                       const float* __restrict__ kern,
                       const float* __restrict__ priors,
                       const float* __restrict__ strides, int K, int h,
                       int w, int chunk, int chunks,
                       float* __restrict__ logits) {
  __shared__ __align__(16) float s_k[172];
  const int lane = threadIdx.x;
  const size_t bn = blockIdx.x / chunks;  // b · K + n
  const int b = (int)(bn / K);
  const int hw = h * w;
  const int q0 = (blockIdx.x % chunks) * chunk;
  const int len = min(chunk, hw - q0);
  // the instance's parameters: read once by the warp (coalesced), then
  // into every lane's registers as 16-byte broadcasts
  for (int j = lane; j < kDynParams; j += 32)
    s_k[j] = __ldg(kern + bn * kDynParams + j);
  __syncwarp();
  float k[kDynParams];
#pragma unroll
  for (int j = 0; j < 168; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s_k + j);
    k[j] = v.x;
    k[j + 1] = v.y;
    k[j + 2] = v.z;
    k[j + 3] = v.w;
  }
  k[168] = s_k[168];
  const DynPrior d = dyn_prior(priors, strides, bn);
  const float4* f4 = reinterpret_cast<const float4*>(feat) +
                     2 * ((size_t)b * hw + q0);
  float* out = logits + bn * hw + q0;
  int x = (q0 + lane) % w, y = (q0 + lane) / w;
  float4 fa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), fb = fa;
  if (lane < len) {
    fa = __ldg(f4 + 2 * lane);
    fb = __ldg(f4 + 2 * lane + 1);
  }
  for (int q = lane; q < len; q += 32) {
    const float in[10] = {dyn_rel(d.px, (float)x * 8.0f, d),
                          dyn_rel(d.py, (float)y * 8.0f, d),
                          fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
    // the next pixel's features load while this one computes
    fa = fb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q + 32 < len) {
      fa = __ldg(f4 + 2 * (q + 32));
      fb = __ldg(f4 + 2 * (q + 32) + 1);
    }
    out[q] = dyn_logit(k, in);
    dyn_advance(x, y, 32, w);
  }
}

}  // namespace

// feat (B, h, w, 8) 16-byte aligned, kern (B, K, 169), priors (B, K,
// 2), strides (B, K) f32; chunk the pixels a warp takes
// (models/rtmdet.py:dynhead_fwd_plan); logits (B, K, h, w) f32 output.
// Returns cudaGetLastError().
extern "C" int kb_dynhead_fwd(const float* feat, const float* kern,
                              const float* priors, const float* strides,
                              int B, int K, int h, int w, int chunk,
                              float* logits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || h <= 0 || w <= 0) return 0;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const int chunks = (h * w + chunk - 1) / chunk;
  const long long blocks = (long long)B * K * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dynhead_fwd_kernel<<<(unsigned)blocks, 32, 0, s>>>(
      feat, kern, priors, strides, K, h, w, chunk, chunks, logits);
  return (int)cudaGetLastError();
}
