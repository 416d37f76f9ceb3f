// Shared device helpers of the Ken Burns kernels.
//
// Every float expression here repeats the plain PyTorch version's
// operation order one rounding at a time (the sources are built with
// -fmad=false, so no multiply-add is contracted into an FMA): one ulp
// in a projected coordinate flips a nearest corner, a z-test or a
// rounded sample offset against the plain version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KB_BIG 1000000.0f

extern "C" const char* kb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns at once: the host cost of a call into a kernel library with
// nothing behind it (chip_smoke.py's [host] phase).
extern "C" int kb_noop(void) { return 0; }

// Projection of ops/pointcloud.py:_project. err is the z-buffer key
// 1e6 - f*b/(z + 1e-7), computed from the unclamped z.
struct KbProj {
  float u, v, err;
  bool valid;
};

__device__ __forceinline__ KbProj kb_project(float x, float y, float z,
                                             int H, int W, float focal,
                                             float baseline) {
  KbProj p;
  p.valid = z >= 0.001f;
  float zs = p.valid ? z : 1.0f;
  p.u = x * focal / zs + 0.5f * (float)W - 0.5f;
  p.v = y * focal / zs + 0.5f * (float)H - 0.5f;
  p.err = KB_BIG - (focal * baseline) / (z + 1e-7f);
  return p;
}

// Bilinear corner c (0..3 = NW, NE, SW, SE) of (u, v): its pixel
// index, or -1 when it lies outside the H x W frame, and its weight.
// The bounds test runs on the floats, so a far-off point never goes
// through an out-of-range int conversion, and a NaN coordinate fails
// it as it fails the plain version's.
__device__ __forceinline__ int kb_corner(float u, float v, int c, int H,
                                         int W, float* w) {
  float x0 = floorf(u), y0 = floorf(v);
  float fx = u - x0, fy = v - y0;
  float cx = x0, cy = y0;
  switch (c) {
    case 0: *w = (1.0f - fx) * (1.0f - fy); break;
    case 1: *w = fx * (1.0f - fy); cx = x0 + 1.0f; break;
    case 2: *w = (1.0f - fx) * fy; cy = y0 + 1.0f; break;
    default: *w = fx * fy; cx = x0 + 1.0f; cy = y0 + 1.0f; break;
  }
  if (!(cx >= 0.0f && cx < (float)W && cy >= 0.0f && cy < (float)H))
    return -1;
  return (int)cy * W + (int)cx;
}
