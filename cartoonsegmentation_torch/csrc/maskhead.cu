// K9: the RTMDet-Ins dynamic mask heads and their epilogue.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads
// (the per-instance 1x1 conv stack as batched einsums) and the end of
// postprocess: sigmoid, the x8 'linear' resize to the input size, the
// mask threshold and the valid gate.
//
// Launch 1, one thread per (instance n, stride-8 pixel p):
//   rel = (prior_n - 8·(x, y)) / (stride_n · 8)   (a true f32 division)
//   in  = [rel_x, rel_y, feat[p, 0..7]]           (rel first)
//   10 → 8 (ReLU) → 8 (ReLU) → 1 with the 169 generated parameters of
//   instance n unpacked as at rtmdet.py:241-251 (weights (cout, cin)
//   row-major, then the biases); each output is the sum over the inputs
//   in order, then the bias; then the sigmoid. probs (N, h·w) f32.
// Launch 2, one thread per output pixel: bilinear resampling with
//   half-pixel centres and clamped edges (torch's bilinear formula and
//   order of operations, which jax.image.resize 'linear' equals when it
//   upsamples), then > mask_thr and the valid gate. masks (N, H, W).
//
// Bound on the card: launch 2 writes N·H·W bytes (41 MB at N = 100,
// 640x640); launch 1 is 350 flops a thread over 640 k threads. The
// parameters of an instance are read by its threads from L1.
#include "kb_common.cuh"

namespace {

constexpr int kProtos = 8;
constexpr int kParams = 169;
// offsets of the weights and biases in the 169 generated parameters
constexpr int kW1 = 0, kW2 = 80, kW3 = 144, kB1 = 152, kB2 = 160, kB3 = 168;

__global__ void heads_kernel(const float* __restrict__ feat,
                             const float* __restrict__ params,
                             const float* __restrict__ priors,
                             const float* __restrict__ strides, int N,
                             int h, int w, float* __restrict__ probs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * h * w) return;
  const int n = (int)(t / (h * w));
  const int p = (int)(t - (long long)n * h * w);
  const int y = p / w, x = p - y * w;
  const float* k = params + (long long)n * kParams;
  const float s8 = strides[n] * 8.0f;
  float in[kProtos + 2];
  in[0] = (priors[2 * n] - (float)x * 8.0f) / s8;
  in[1] = (priors[2 * n + 1] - (float)y * 8.0f) / s8;
#pragma unroll
  for (int c = 0; c < kProtos; ++c) in[2 + c] = feat[p * kProtos + c];
  float h1[8], h2[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = in[0] * k[kW1 + o * 10];
#pragma unroll
    for (int c = 1; c < 10; ++c) acc = acc + in[c] * k[kW1 + o * 10 + c];
    acc = acc + k[kB1 + o];
    h1[o] = fmaxf(acc, 0.0f);
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = h1[0] * k[kW2 + o * 8];
#pragma unroll
    for (int c = 1; c < 8; ++c) acc = acc + h1[c] * k[kW2 + o * 8 + c];
    acc = acc + k[kB2 + o];
    h2[o] = fmaxf(acc, 0.0f);
  }
  float logit = h2[0] * k[kW3];
#pragma unroll
  for (int c = 1; c < 8; ++c) logit = logit + h2[c] * k[kW3 + c];
  logit = logit + k[kB3];
  probs[t] = 1.0f / (1.0f + expf(-logit));
}

// torch's area_pixel_compute_source_index for bilinear, no align_corners
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float s = scale * ((float)dst + 0.5f) - 0.5f;
  return s < 0.0f ? 0.0f : s;
}

__global__ void upsample_kernel(const float* __restrict__ probs,
                                const uint8_t* __restrict__ valid, int N,
                                int h, int w, int H, int W, float thr,
                                uint8_t* __restrict__ masks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * H * W) return;
  const int n = (int)(t / ((long long)H * W));
  const int q = (int)(t - (long long)n * H * W);
  const int Y = q / W, X = q - Y * W;
  if (!valid[n]) {
    masks[t] = 0;
    return;
  }
  const float sy = source_index((float)h / (float)H, Y);
  const float sx = source_index((float)w / (float)W, X);
  const int y1 = (int)sy, x1 = (int)sx;
  const int y1p = y1 < h - 1 ? 1 : 0, x1p = x1 < w - 1 ? 1 : 0;
  const float ly1 = sy - (float)y1, ly0 = 1.0f - ly1;
  const float lx1 = sx - (float)x1, lx0 = 1.0f - lx1;
  const float* P = probs + (long long)n * h * w;
  const float a = P[y1 * w + x1], b = P[y1 * w + x1 + x1p];
  const float c = P[(y1 + y1p) * w + x1], d = P[(y1 + y1p) * w + x1 + x1p];
  const float v = ly0 * (lx0 * a + lx1 * b) + ly1 * (lx0 * c + lx1 * d);
  masks[t] = v > thr;
}

}  // namespace

// feat (h, w, 8), params (N, 169), priors (N, 2), strides (N,) f32;
// valid (N,) u8; probs (N, h*w) f32 and masks (N, H, W) u8 outputs.
// Returns cudaGetLastError().
extern "C" int kb_mask_heads(const float* feat, const float* params,
                             const float* priors, const float* strides,
                             const uint8_t* valid, int N, int h, int w,
                             int H, int W, float thr, float* probs,
                             uint8_t* masks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = 256;
  const long long n1 = (long long)N * h * w, n2 = (long long)N * H * W;
  if (n1 > 0)
    heads_kernel<<<(unsigned)((n1 + T - 1) / T), T, 0, s>>>(
        feat, params, priors, strides, N, h, w, probs);
  if (n2 > 0 && n1 > 0)
    upsample_kernel<<<(unsigned)((n2 + T - 1) / T), T, 0, s>>>(
        probs, valid, N, h, w, H, W, thr, masks);
  return (int)cudaGetLastError();
}
