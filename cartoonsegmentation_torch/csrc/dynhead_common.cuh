// K9t's shared device code: the dynamic mask heads' generated
// parameters and relative coordinates, for the forward (dynhead_fwd.cu)
// and the backward (dynhead_bwd.cu).
//
// The relative coordinates are a true f32 division, taken as a multiply
// by the exact reciprocal when stride * 8 is a power of two (the
// training strides 8, 16 and 32): both round the same real quotient
// once, so the bits are the division's.
#pragma once

#include "kb_common.cuh"

constexpr int kDynProtos = 8;
constexpr int kDynParams = 169;
// offsets of the weights and biases in the 169 generated parameters:
// w1 (8, 10), w2 (8, 8), w3 (1, 8) row-major (cout, cin), then b1 (8),
// b2 (8), b3 (1)
constexpr int kDynW1 = 0, kDynW2 = 80, kDynW3 = 144;
constexpr int kDynB1 = 152, kDynB2 = 160, kDynB3 = 168;

// an instance's prior and stride
struct DynPrior {
  float px, py, s8, inv;
  bool exact;  // s8 a power of two: inv = 1 / s8 exactly
};

__device__ __forceinline__ DynPrior dyn_prior(const float* __restrict__ priors,
                                              const float* __restrict__ strides,
                                              size_t bn) {
  DynPrior d;
  d.px = priors[2 * bn];
  d.py = priors[2 * bn + 1];
  d.s8 = strides[bn] * 8.0f;
  const unsigned bits = __float_as_uint(d.s8);
  const unsigned e = (bits >> 23) & 0xffu;
  d.exact = (bits & 0x7fffffu) == 0u && e >= 1u && e <= 254u;
  d.inv = d.exact ? 1.0f / d.s8 : 0.0f;
  return d;
}

// (prior - coord) / (stride * 8)
__device__ __forceinline__ float dyn_rel(float prior, float coord,
                                         const DynPrior& d) {
  const float num = prior - coord;
  return d.exact ? num * d.inv : num / d.s8;
}

__device__ __forceinline__ float dyn_relu(float a) {
  return a > 0.0f ? a : 0.0f;
}

// column x, row y moved `step` pixels on along rows w wide
__device__ __forceinline__ void dyn_advance(int& x, int& y, int step, int w) {
  x += step;
  while (x >= w) {
    x -= w;
    ++y;
  }
}
