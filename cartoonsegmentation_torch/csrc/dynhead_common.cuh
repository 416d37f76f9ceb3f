// K9t's shared device code: the dynamic mask heads of one pixel and
// one instance, forward (dynhead_fwd.cu) and recomputed for the
// backward (dynhead_bwd.cu). The sums run in the plain version's order
// (cartoonsegmentation_torch/models/rtmdet.py:dynamic_mask_heads), and
// the sources are built with -fmad=false, so no product is contracted
// into an FMA.
#pragma once

#include "kb_common.cuh"

constexpr int kDynProtos = 8;
constexpr int kDynParams = 169;
// offsets of the weights and biases in the 169 generated parameters
constexpr int kDynW1 = 0, kDynW2 = 80, kDynW3 = 144;
constexpr int kDynB1 = 152, kDynB2 = 160, kDynB3 = 168;
// pixels a block, a thread a pixel (models/rtmdet.py:DYNHEAD_TILE)
constexpr int kDynTile = 256;

// one pixel's inputs and its pre-activations and activations under
// one instance
struct DynAct {
  float in[kDynProtos + 2];
  float a1[8], h1[8], a2[8], h2[8];
};

// rel = (prior - coord) / (stride * 8), then the pixel's features
__device__ __forceinline__ void dyn_inputs(DynAct& a, float px, float py,
                                           float stride, float cx, float cy,
                                           const float* f) {
  const float s8 = stride * 8.0f;
  a.in[0] = (px - cx) / s8;
  a.in[1] = (py - cy) / s8;
#pragma unroll
  for (int c = 0; c < kDynProtos; ++c) a.in[2 + c] = f[c];
}

// the three layers on instance parameters k (shared memory); returns
// the logit and keeps the layers' values in a
__device__ __forceinline__ float dyn_forward(const float* k, DynAct& a) {
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = a.in[0] * k[kDynW1 + o * 10];
#pragma unroll
    for (int c = 1; c < 10; ++c) acc = acc + a.in[c] * k[kDynW1 + o * 10 + c];
    a.a1[o] = acc + k[kDynB1 + o];
    a.h1[o] = a.a1[o] > 0.0f ? a.a1[o] : 0.0f;
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = a.h1[0] * k[kDynW2 + o * 8];
#pragma unroll
    for (int c = 1; c < 8; ++c) acc = acc + a.h1[c] * k[kDynW2 + o * 8 + c];
    a.a2[o] = acc + k[kDynB2 + o];
    a.h2[o] = a.a2[o] > 0.0f ? a.a2[o] : 0.0f;
  }
  float out = a.h2[0] * k[kDynW3];
#pragma unroll
  for (int c = 1; c < 8; ++c) out = out + a.h2[c] * k[kDynW3 + c];
  return out + k[kDynB3];
}
