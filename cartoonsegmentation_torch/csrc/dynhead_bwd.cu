// K9t, backward: the gradients of the dynamic mask heads' logits
// (dynhead_fwd.cu) with respect to the mask features and the generated
// parameters, the VJP that JAX derives for
// cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads inside
// the detector loss (parallel/train.py:164). The priors and strides
// take no gradient (constants there).
//
// Given dlogits (B, K, h, w):
//   d mask_feat (B, h, w, 8): at each pixel, summed over the image's K
//     instances in instance order;
//   d kernels (B, K, 169): at each instance, summed over its h·w pixels.
// ReLU passes a gradient where its input is > 0, as JAX's and torch's.
// Layers 1-2 are recomputed in the plain version's rounding (the first
// product, each further rounded product added in order, then the bias;
// -fmad=false keeps them unfused), so the ReLU masks are the plain
// version's bit for bit: with FMA a pre-activation within an ulp of 0
// flips its mask, which moved one pixel's feature gradient by 1.6% of
// the largest in one of three seeded training-shape calls. The sums
// after the masks fuse (__fmaf_rn).
//
// What bounds it on the H100: operations, ~455 multiply-adds a (pixel,
// instance), ~5.6 µs at B = 8, K = 8, 80x80 against the f32 peak. One
// call, two kernels, no float atomics, the same bits from run to run:
// - a block takes a tile of one image's pixels (models/rtmdet.py:
//   dynhead_bwd_plan: B · tiles ≈ three blocks an SM, one wave) under
//   its instances, 8 at a time, with 4 warps, a warp 2 of the 8 in turn;
// - a warp takes 8 pixels at a time, a lane two of the 8 units of a
//   layer for one of them (units 2u, 2u + 1, u = lane % 4): it holds
//   their 74 weights in registers (w1 and w2 rows, w2 and w1 columns,
//   biases, w3), computes its units of each layer and gathers the
//   pixel's other units from its 4 lanes by shuffle (3 x 8 a pixel), so
//   no weight goes through the shared-memory pipe;
// - a lane keeps its units' 43 parameter sums (w1 rows, b1, w2 rows,
//   b2, w3, b3) in registers, each added by FMA over its pixels in
//   order; at the end of the tile the 8 pixel slots are added by the
//   fixed tree ^4, ^8, ^16 into the (instance, tile) partial, written to
//   partials (B, K, tiles, 169);
// - a lane's 2 feature-gradient channels go to shared memory by
//   instance; after a block barrier the block adds the instances in
//   order (a running sum in shared memory when K > 8) and writes
//   d mask_feat;
// - a second kernel, a block an (image, instance), adds its partials
//   over the tiles in tile order into d kernels (the last block of an
//   image doing it alone took ~19 µs).
// Measured on an H100 80GB HBM3 at 700 W: 0.0387 ms of device time at
// the training shape, 14% of the bound; the pixel loop takes 90% of a
// block's SM cycles (kernel_phases.py); without its shuffles it runs
// 13% faster, with layers 1-2 fused 4% (kernel_variants.py). Route:
// FMAs; on the tensor cores the masks would not be the plain version's.
#include "dynhead_common.cuh"

namespace {

constexpr int kBwdWarps = 4;      // warps a block
constexpr int kBwdInst = 8;       // instances a block takes at a time
constexpr int kBwdMaxTile = 256;  // pixels a block at most (the plan's cap)
constexpr int kBwdSlots = 8;      // pixels a warp takes at a time
constexpr unsigned kFull = 0xffffffffu;
// a lane's parameter sums, a unit j = 0, 1 each: w1 row (10), b1, w2
// row (8), b2, w3; then b3
constexpr int kAccUnit = 21;
constexpr int kAccW1 = 0, kAccB1 = 10, kAccW2 = 11, kAccB2 = 19, kAccW3 = 20;
constexpr int kAccB3 = 2 * kAccUnit, kAcc = 2 * kAccUnit + 1;

// the pixel's 8 units (2 from each of its 4 lanes base..base + 3), in
// unit order
__device__ __forceinline__ void dyn_gather(const float (&v)[2], int base,
                                           float (&out)[8]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    out[2 * u] = __shfl_sync(kFull, v[0], base + u);
    out[2 * u + 1] = __shfl_sync(kFull, v[1], base + u);
  }
}

// dynamic shared memory: [min(K, 8)][tile][8] feature gradients, then
// [tile][8] the running sum (K > 8)
__global__ void __launch_bounds__(32 * kBwdWarps, 3)
    dynhead_bwd_kernel(const float* __restrict__ feat,
                       const float* __restrict__ kern,
                       const float* __restrict__ priors,
                       const float* __restrict__ strides,
                       const float* __restrict__ dlogits, int K, int h,
                       int w, int tile, int tiles,
                       float* __restrict__ partials,
                       float* __restrict__ dfeat) {
  extern __shared__ float s_df[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = lane & 3, slot = lane >> 2, base = lane & ~3;
  const int inst = min(K, kBwdInst);
  float* s_run = s_df + (size_t)inst * tile * 8;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int hw = h * w;
  const int q0 = t * tile;
  const int len = min(tile, hw - q0);
  const int steps = (len + kBwdSlots - 1) / kBwdSlots;
  const int groups = (K + kBwdInst - 1) / kBwdInst;
  const float4* f4 =
      reinterpret_cast<const float4*>(feat) + 2 * ((size_t)b * hw + q0);

  for (int grp = 0; grp < groups; ++grp) {
    const int ng = min(kBwdInst, K - grp * kBwdInst);
    for (int i = warp; i < ng; i += warps) {
      const size_t bn = (size_t)b * K + grp * kBwdInst + i;
      const float* kp = kern + bn * kDynParams;
      // units 2u and 2u + 1's weights
      float w1[2][10], w2[2][8], w2c[2][8], w1c[2][8], b1[2], b2[2], w3[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = 2 * u + j;
#pragma unroll
        for (int c = 0; c < 10; ++c) w1[j][c] = __ldg(kp + kDynW1 + 10 * o + c);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          w2[j][c] = __ldg(kp + kDynW2 + 8 * o + c);
          w2c[j][c] = __ldg(kp + kDynW2 + 8 * c + o);
          w1c[j][c] = __ldg(kp + kDynW1 + 10 * c + 2 + o);
        }
        b1[j] = __ldg(kp + kDynB1 + o);
        b2[j] = __ldg(kp + kDynB2 + o);
        w3[j] = __ldg(kp + kDynW3 + o);
      }
      const DynPrior d = dyn_prior(priors, strides, bn);
      const float* gp = dlogits + bn * hw + q0;
      float acc[kAcc];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
      int x = (q0 + slot) % w, y = (q0 + slot) / w;
      float4 fa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), fb = fa;
      float g = 0.0f;
      if (slot < len) {
        fa = __ldg(f4 + 2 * slot);
        fb = __ldg(f4 + 2 * slot + 1);
        g = __ldg(gp + slot);
      }
      // every lane runs every step (the shuffles need the whole warp);
      // a lane past the tile's end adds and stages nothing
      for (int s = 0; s < steps; ++s) {
        const int q = kBwdSlots * s + slot, qn = q + kBwdSlots;
        const bool live = q < len;
        float4 na = make_float4(0.0f, 0.0f, 0.0f, 0.0f), nb = na;
        float gn = 0.0f;
        if (qn < len) {
          na = __ldg(f4 + 2 * qn);
          nb = __ldg(f4 + 2 * qn + 1);
          gn = __ldg(gp + qn);
        }
        const float in[10] = {dyn_rel(d.px, (float)x * 8.0f, d),
                              dyn_rel(d.py, (float)y * 8.0f, d),
                              fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
        // layer 1, units 2u + j, in the plain version's rounding
        float h1o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = in[0] * w1[j][0];
#pragma unroll
          for (int c = 1; c < 10; ++c) a = a + in[c] * w1[j][c];
          h1o[j] = dyn_relu(a + b1[j]);
        }
        float h1[8];
        dyn_gather(h1o, base, h1);
        // layer 2 and layer 3's gradient: d2 = relu'(a2) · g · w3
        float d2o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = h1[0] * w2[j][0];
#pragma unroll
          for (int c = 1; c < 8; ++c) a = a + h1[c] * w2[j][c];
          const float h2o = dyn_relu(a + b2[j]);
          d2o[j] = h2o > 0.0f ? g * w3[j] : 0.0f;
          if (live) {
            const int r = kAccUnit * j;
            acc[r + kAccW3] = __fmaf_rn(g, h2o, acc[r + kAccW3]);
            acc[r + kAccB2] = acc[r + kAccB2] + d2o[j];
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r + kAccW2 + c] = __fmaf_rn(d2o[j], h1[c], acc[r + kAccW2 + c]);
          }
        }
        if (live) acc[kAccB3] = acc[kAccB3] + g;
        // layer 2's gradient: d1 = relu'(a1) · Σ_c d2[c] w2(c, o)
        float d2[8];
        dyn_gather(d2o, base, d2);
        float d1o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float sum = 0.0f;
#pragma unroll
          for (int c = 0; c < 8; ++c) sum = __fmaf_rn(d2[c], w2c[j][c], sum);
          d1o[j] = h1o[j] > 0.0f ? sum : 0.0f;
          if (live) {
            const int r = kAccUnit * j;
            acc[r + kAccB1] = acc[r + kAccB1] + d1o[j];
#pragma unroll
            for (int c = 0; c < 10; ++c)
              acc[r + kAccW1 + c] = __fmaf_rn(d1o[j], in[c], acc[r + kAccW1 + c]);
          }
        }
        // feature channels 2u + j's gradient: Σ_c d1[c] w1(c, 2 + o)
        float d1[8];
        dyn_gather(d1o, base, d1);
        float df[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float sum = 0.0f;
#pragma unroll
          for (int c = 0; c < 8; ++c) sum = __fmaf_rn(d1[c], w1c[j][c], sum);
          df[j] = sum;
        }
        if (live)
          *reinterpret_cast<float2*>(
              s_df + ((size_t)i * tile + q) * 8 + 2 * u) =
              make_float2(df[0], df[1]);
        fa = na;
        fb = nb;
        g = gn;
        dyn_advance(x, y, kBwdSlots, w);
      }
      // the 8 pixel slots' sums, by the tree ^4, ^8, ^16; lanes 0..3
      // write units 2u and 2u + 1's parameters
#pragma unroll
      for (int m = 4; m <= 16; m <<= 1) {
#pragma unroll
        for (int j = 0; j < kAcc; ++j)
          acc[j] = acc[j] + __shfl_xor_sync(kFull, acc[j], m);
      }
      if (lane < 4) {
        float* dst = partials + (bn * tiles + t) * kDynParams;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = 2 * u + j, r = kAccUnit * j;
#pragma unroll
          for (int c = 0; c < 10; ++c)
            dst[kDynW1 + 10 * o + c] = acc[r + kAccW1 + c];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            dst[kDynW2 + 8 * o + c] = acc[r + kAccW2 + c];
          dst[kDynB1 + o] = acc[r + kAccB1];
          dst[kDynB2 + o] = acc[r + kAccB2];
          dst[kDynW3 + o] = acc[r + kAccW3];
        }
        if (u == 0) dst[kDynB3] = acc[kAccB3];
      }
    }
    __syncthreads();
    // the tile's feature gradients, the group's instances in order
    const bool last_grp = grp == groups - 1;
    float* out = dfeat + ((size_t)b * hw + q0) * 8;
    for (int e = threadIdx.x; e < 8 * len; e += blockDim.x) {
      float r = s_df[e];
      if (grp > 0) r = s_run[e] + r;
      for (int v = 1; v < ng; ++v) r = r + s_df[(size_t)v * tile * 8 + e];
      if (last_grp) out[e] = r;
      else s_run[e] = r;
    }
    if (!last_grp) __syncthreads();
  }

}

// d kernels: a block an (image, instance), a thread a parameter, its
// tiles' partials added in tile order (loaded 8 at a time)
__global__ void __launch_bounds__(192)
    dynhead_bwd_sum(const float* __restrict__ partials, int tiles,
                    float* __restrict__ dkern) {
  const size_t bn = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= kDynParams) return;
  const float* src = partials + bn * tiles * kDynParams + j;
  float s = src[0];
  int t = 1;
  for (; t + 8 <= tiles; t += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[(size_t)(t + i) * kDynParams];
#pragma unroll
    for (int i = 0; i < 8; ++i) s = s + v[i];
  }
  for (; t < tiles; ++t) s = s + src[(size_t)t * kDynParams];
  dkern[bn * kDynParams + j] = s;
}

// the dynamic shared memory of a block over `tile` pixels and K
// instances
size_t dyn_bwd_smem(int tile, int K) {
  size_t floats = (size_t)(K < kBwdInst ? K : kBwdInst) * tile * 8;
  if (K > kBwdInst) floats += (size_t)tile * 8;
  return floats * sizeof(float);
}

}  // namespace

// feat (B, h, w, 8) 16-byte aligned, kern (B, K, 169), priors (B, K,
// 2), strides (B, K), dlogits (B, K, h, w) f32; tile the pixels a block
// takes (models/rtmdet.py:dynhead_bwd_plan, at most 256); partials
// (B, K, tiles, 169) f32 scratch (tiles = ceil(h·w / tile)); dfeat (B,
// h, w, 8) and dkern (B, K, 169) f32 outputs. Two kernels. Returns
// cudaGetLastError().
extern "C" int kb_dynhead_bwd(const float* feat, const float* kern,
                              const float* priors, const float* strides,
                              const float* dlogits, int B, int K, int h,
                              int w, int tile, float* partials, float* dfeat,
                              float* dkern, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  if (tile <= 0 || tile > kBwdMaxTile) return (int)cudaErrorInvalidValue;
  if (K <= 0)
    return (int)cudaMemsetAsync(
        dfeat, 0, (size_t)B * h * w * kDynProtos * sizeof(float), s);
  const int tiles = (h * w + tile - 1) / tile;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL || (long long)B * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the staged feature gradients may take more than the default 48 KB
  // a block: raised once a device, to the most a plan asks for
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        dynhead_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn_bwd_smem(kBwdMaxTile, kBwdInst + 1));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int warps = K < kBwdWarps ? K : kBwdWarps;
  dynhead_bwd_kernel<<<(unsigned)blocks, 32 * warps, dyn_bwd_smem(tile, K),
                       s>>>(
      feat, kern, priors, strides, dlogits, K, h, w, tile, tiles, partials,
      dfeat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dynhead_bwd_sum<<<(unsigned)((long long)B * K), 192, 0, s>>>(partials,
                                                               tiles, dkern);
  return (int)cudaGetLastError();
}
