// K14a: legacy (aligned=False) multi-level RoIAlign over a flattened
// FPN pyramid.
//
// Replaces cartoonsegmentation_tpu/models/maskrcnn.py:roi_align_pyramid
// (the gather over the flattened P2..P5 table that serves Mask R-CNN's
// box head at 7x7 and its mask head at 14x14).
//
// flat (sum H_l*W_l, C) f32 is P2..P5 channel-last, level after level;
// boxes (N, 4) xyxy image pixels; lvl (N,) int32 the level index 0..3
// from models/maskrcnn.py:roi_levels (torch computes the level map, so
// the kernel and the plain version read the same one). Per box, as the
// plain version computes them, one rounding at a time:
//   scale = 1/stride, x1 = b0*scale, rw = max(b2*scale - x1, 1),
//   bin = rw / out, sample g: x1 + ((g + 0.5) / sampling) * bin;
// a sample outside [-1, size] reads 0; else clamp at 0, x0 =
// min((int)x, W-1), x1 = min(x0 + 1, W-1), and a tap collapsed at the
// edge (x1 == x0) gets weight 0; the four taps weighted
// (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx summed in that order. Each
// output is the mean of its sampling x sampling samples.
//
// Bound on the card: bytes (the pyramid and the (N, C, out, out)
// output; 87.7 MB + 50.2 MB at 1000 boxes of 7x7 on the 768x1344
// canvas). One block per (box, output row), threads over the channels:
// every tap of a sample reads C consecutive floats of the channel-last
// table (coalesced); the block's samples' coordinates are computed once
// into shared memory; the row is staged in shared memory and written
// as runs of `out` consecutive floats of the NCHW output.
#include "kb_common.cuh"

namespace {

constexpr int kMaxSamples = 64;  // out * sampling of one axis

struct Tap {
  int i0, i1;    // the two source indices (row or column)
  float l;       // the weight of i1
  bool oob;      // the sample lies outside [-1, size]
};

__device__ __forceinline__ Tap make_tap(float v, int n) {
  Tap t;
  t.oob = v < -1.0f || v > (float)n;
  const float c = fmaxf(v, 0.0f);
  t.i0 = min((int)c, n - 1);
  t.i1 = min(t.i0 + 1, n - 1);
  t.l = t.i1 > t.i0 ? fminf(fmaxf(c - (float)t.i0, 0.0f), 1.0f) : 0.0f;
  return t;
}

__global__ void roi_align_kernel(const float* __restrict__ flat,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ lvl, int C,
                                 int4 hs, int4 ws, int out, int sampling,
                                 float* __restrict__ res) {
  extern __shared__ float row[];  // (C, out)
  __shared__ Tap xt[kMaxSamples];
  __shared__ Tap yt[kMaxSamples];
  const int n = blockIdx.x, ph = blockIdx.y;
  const int l = lvl[n];
  const int Hs[4] = {hs.x, hs.y, hs.z, hs.w};
  const int Ws[4] = {ws.x, ws.y, ws.z, ws.w};
  long long base = 0;
  for (int k = 0; k < l; ++k) base += (long long)Hs[k] * Ws[k];
  const int Hn = Hs[l], Wn = Ws[l];
  const float scale = 1.0f / (float)(4 << l);
  const int g = out * sampling;
  const int t = threadIdx.x;
  if (t < g || t < sampling) {
    const float* b = boxes + 4 * n;
    const float x1 = b[0] * scale, y1 = b[1] * scale;
    const float rw = fmaxf(b[2] * scale - x1, 1.0f);
    const float rh = fmaxf(b[3] * scale - y1, 1.0f);
    const float bin_w = rw / (float)out, bin_h = rh / (float)out;
    if (t < g) {
      const float idx = ((float)t + 0.5f) / (float)sampling;
      xt[t] = make_tap(x1 + idx * bin_w, Wn);
    }
    if (t < sampling) {
      const float idx = ((float)(ph * sampling + t) + 0.5f) / (float)sampling;
      yt[t] = make_tap(y1 + idx * bin_h, Hn);
    }
  }
  __syncthreads();

  const float inv = 1.0f / (float)(sampling * sampling);
  for (int c = t; c < C; c += blockDim.x) {
    const float* f = flat + base * C + c;
    for (int pw = 0; pw < out; ++pw) {
      float acc = 0.0f;
      for (int iy = 0; iy < sampling; ++iy) {
        const Tap ty = yt[iy];
        for (int ix = 0; ix < sampling; ++ix) {
          const Tap tx = xt[pw * sampling + ix];
          if (ty.oob || tx.oob) continue;
          const float hy = 1.0f - ty.l, hx = 1.0f - tx.l;
          const float v =
              f[((long long)ty.i0 * Wn + tx.i0) * C] * (hy * hx) +
              f[((long long)ty.i0 * Wn + tx.i1) * C] * (hy * tx.l) +
              f[((long long)ty.i1 * Wn + tx.i0) * C] * (ty.l * hx) +
              f[((long long)ty.i1 * Wn + tx.i1) * C] * (ty.l * tx.l);
          acc += v;
        }
      }
      row[c * out + pw] = acc * inv;
    }
  }
  __syncthreads();
  float* o = res + (long long)n * C * out * out + ph * out;
  for (int k = t; k < C * out; k += blockDim.x) {
    const int c = k / out, pw = k - c * out;
    o[(long long)c * out * out + pw] = row[k];
  }
}

}  // namespace

// flat (sum H_l*W_l, C), boxes (N, 4) f32, lvl (N,) int32 in 0..3, the
// four levels' (H, W); res (N, C, out, out) f32, out * sampling <= 64.
// Returns cudaGetLastError().
extern "C" int kb_roi_align(const float* flat, const float* boxes,
                            const int* lvl, int N, int C, int h0, int w0,
                            int h1, int w1, int h2, int w2, int h3, int w3,
                            int out, int sampling, float* res, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out < 1 || sampling < 1 || out * sampling > kMaxSamples || C < 1 ||
      out > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const size_t shm = sizeof(float) * (size_t)C * out;
  if (shm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        roi_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  roi_align_kernel<<<dim3(N, out), 256, shm, s>>>(
      flat, boxes, lvl, C, make_int4(h0, h1, h2, h3),
      make_int4(w0, w1, w2, w3), out, sampling, res);
  return (int)cudaGetLastError();
}
