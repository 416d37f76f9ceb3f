// K13a: the push-pull hole fill of the style flow's background.
//
// Replaces cartoonsegmentation_tpu/ops/inpaint_fill.py:push_pull_fill.
//
// image (H, W, 3) f32 and hole (H, W) bool. The pyramid's levels
// 1..L (each the ceil half of the one before, L = ceil(log2 max(H, W)),
// so level L is one pixel) live one after the other in a scratch of 4
// floats a pixel: the premultiplied colour sums and the weight sum.
//
// - pull: one launch a level. A thread sums the 2x2 block of one
//   output pixel in the order (0,0) + (0,1) + (1,0) + (1,1), adding the
//   zero padding of an odd size like the plain version does; level 1
//   premultiplies the image by w0 = !hole on the fly.
// - top: level L's colour becomes c / max(w, 1e-8), in place.
// - push: one launch a level, L-1 down to 1. A thread upsamples the
//   coarser level's filled colour bilinearly (half-pixel centres,
//   clamped edges: jax.image.resize 'linear' for a size step up) and
//   blends col * clip(w, 0, 1) + up * (1 - clip(w, 0, 1)), in place.
// - final: level 0 the same way, written into the hole pixels only;
//   the others take the image.
//
// 2L + 1 launches from one call. Every float step repeats the plain
// version's order (built with -fmad=false). Bound by bytes: the image
// and hole read, the pyramid (1/3 of H x W x 16 B) written and read,
// the result written; the small levels are launch latency.
#include "kb_common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr float TINY = 1e-8f;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 image_w(const float* img,
                                          const unsigned char* hole, int H,
                                          int W, int y, int x) {
  if (y >= H || x >= W) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long i = (long long)y * W + x;
  const float w0 = hole[i] ? 0.0f : 1.0f;
  return make_float4(img[3 * i] * w0, img[3 * i + 1] * w0,
                     img[3 * i + 2] * w0, w0);
}

__device__ __forceinline__ float4 level_at(const float4* lv, int h, int w,
                                           int y, int x) {
  if (y >= h || x >= w) return make_float4(0.f, 0.f, 0.f, 0.f);
  return lv[(long long)y * w + x];
}

__global__ void pull_first(const float* __restrict__ img,
                           const unsigned char* __restrict__ hole, int H,
                           int W, float4* __restrict__ out, int h, int w) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  float4 s = image_w(img, hole, H, W, 2 * y, 2 * x);
  s = add4(s, image_w(img, hole, H, W, 2 * y, 2 * x + 1));
  s = add4(s, image_w(img, hole, H, W, 2 * y + 1, 2 * x));
  s = add4(s, image_w(img, hole, H, W, 2 * y + 1, 2 * x + 1));
  out[i] = s;
}

__global__ void pull(const float4* __restrict__ in, int hi, int wi,
                     float4* __restrict__ out, int h, int w) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  float4 s = level_at(in, hi, wi, 2 * y, 2 * x);
  s = add4(s, level_at(in, hi, wi, 2 * y, 2 * x + 1));
  s = add4(s, level_at(in, hi, wi, 2 * y + 1, 2 * x));
  s = add4(s, level_at(in, hi, wi, 2 * y + 1, 2 * x + 1));
  out[i] = s;
}

__global__ void top_level(float4* __restrict__ lv, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float4 v = lv[i];
  const float d = fmaxf(v.w, TINY);
  v.x = v.x / d;
  v.y = v.y / d;
  v.z = v.z / d;
  lv[i] = v;
}

// one axis of the half-pixel linear taps, as the plain version's _taps
struct Tap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Tap tap(int d, int n_in, float scale) {
  float src = ((float)d + 0.5f) * scale - 0.5f;
  src = fmaxf(src, 0.0f);
  Tap t;
  t.i0 = min((int)floorf(src), n_in - 1);
  t.i1 = min(t.i0 + 1, n_in - 1);
  t.l1 = src - (float)t.i0;
  t.l0 = 1.0f - t.l1;
  return t;
}

// ly0 * (lx0 * a00 + lx1 * a01) + ly1 * (lx0 * a10 + lx1 * a11)
__device__ __forceinline__ float bilerp(float a00, float a01, float a10,
                                        float a11, const Tap& ty,
                                        const Tap& tx) {
  const float top = tx.l0 * a00 + tx.l1 * a01;
  const float bot = tx.l0 * a10 + tx.l1 * a11;
  return ty.l0 * top + ty.l1 * bot;
}

__device__ __forceinline__ float blend(float c, float w, float up) {
  const float wgt = fminf(fmaxf(w, 0.0f), 1.0f);
  const float col = c / fmaxf(w, TINY);
  return col * wgt + up * (1.0f - wgt);
}

// level lv in place from its coarser neighbour's filled colour
__global__ void push(const float4* __restrict__ coarse, int hc, int wc,
                     float sy, float sx, float4* __restrict__ lv, int h,
                     int w) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  const Tap ty = tap(y, hc, sy), tx = tap(x, wc, sx);
  const float4 a00 = coarse[(long long)ty.i0 * wc + tx.i0];
  const float4 a01 = coarse[(long long)ty.i0 * wc + tx.i1];
  const float4 a10 = coarse[(long long)ty.i1 * wc + tx.i0];
  const float4 a11 = coarse[(long long)ty.i1 * wc + tx.i1];
  float4 v = lv[i];
  v.x = blend(v.x, v.w, bilerp(a00.x, a01.x, a10.x, a11.x, ty, tx));
  v.y = blend(v.y, v.w, bilerp(a00.y, a01.y, a10.y, a11.y, ty, tx));
  v.z = blend(v.z, v.w, bilerp(a00.z, a01.z, a10.z, a11.z, ty, tx));
  lv[i] = v;
}

// level 0: hole pixels take the fill, the others the image; coarse is
// null for a one-pixel image (no level above it)
__global__ void final_level(const float* __restrict__ img,
                            const unsigned char* __restrict__ hole, int H,
                            int W, const float4* __restrict__ coarse,
                            int hc, int wc, float sy, float sx,
                            float* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= H * W) return;
  if (!hole[i]) {
    out[3 * i] = img[3 * i];
    out[3 * i + 1] = img[3 * i + 1];
    out[3 * i + 2] = img[3 * i + 2];
    return;
  }
  const int y = i / W, x = i - y * W;
  const float c[3] = {img[3 * i] * 0.0f, img[3 * i + 1] * 0.0f,
                      img[3 * i + 2] * 0.0f};
  if (coarse == nullptr) {
    for (int k = 0; k < 3; ++k) out[3 * i + k] = c[k] / TINY;
    return;
  }
  const Tap ty = tap(y, hc, sy), tx = tap(x, wc, sx);
  const float4 a00 = coarse[(long long)ty.i0 * wc + tx.i0];
  const float4 a01 = coarse[(long long)ty.i0 * wc + tx.i1];
  const float4 a10 = coarse[(long long)ty.i1 * wc + tx.i0];
  const float4 a11 = coarse[(long long)ty.i1 * wc + tx.i1];
  out[3 * i] = blend(c[0], 0.0f, bilerp(a00.x, a01.x, a10.x, a11.x, ty, tx));
  out[3 * i + 1] =
      blend(c[1], 0.0f, bilerp(a00.y, a01.y, a10.y, a11.y, ty, tx));
  out[3 * i + 2] =
      blend(c[2], 0.0f, bilerp(a00.z, a01.z, a10.z, a11.z, ty, tx));
}

inline int blocks(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

// the plain version's f32 scale: the double quotient rounded once
inline float step_scale(int n_in, int n_out) {
  return (float)((double)n_in / (double)n_out);
}

}  // namespace

// image, out (H, W, 3) f32; hole (H, W) bool; scratch holds levels
// 1..L at 4 floats a pixel (L = `levels`, each level the ceil half of
// the one before). Returns cudaGetLastError().
extern "C" int kb_pushpull(const float* image, const unsigned char* hole,
                           int H, int W, int levels, float* scratch,
                           float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  if (levels > 62) return (int)cudaErrorInvalidValue;
  int hs[64], ws[64];
  float4* lv[64];
  hs[0] = H;
  ws[0] = W;
  long long off = 0;
  for (int k = 1; k <= levels; ++k) {
    hs[k] = (hs[k - 1] + 1) / 2;
    ws[k] = (ws[k - 1] + 1) / 2;
    lv[k] = reinterpret_cast<float4*>(scratch) + off;
    off += (long long)hs[k] * ws[k];
  }
  if (levels == 0) {
    final_level<<<blocks((long long)H * W), BLOCK, 0, s>>>(
        image, hole, H, W, nullptr, 0, 0, 0.f, 0.f, out);
    return (int)cudaGetLastError();
  }
  pull_first<<<blocks((long long)hs[1] * ws[1]), BLOCK, 0, s>>>(
      image, hole, H, W, lv[1], hs[1], ws[1]);
  for (int k = 2; k <= levels; ++k)
    pull<<<blocks((long long)hs[k] * ws[k]), BLOCK, 0, s>>>(
        lv[k - 1], hs[k - 1], ws[k - 1], lv[k], hs[k], ws[k]);
  top_level<<<blocks((long long)hs[levels] * ws[levels]), BLOCK, 0, s>>>(
      lv[levels], hs[levels] * ws[levels]);
  for (int k = levels - 1; k >= 1; --k)
    push<<<blocks((long long)hs[k] * ws[k]), BLOCK, 0, s>>>(
        lv[k + 1], hs[k + 1], ws[k + 1], step_scale(hs[k + 1], hs[k]),
        step_scale(ws[k + 1], ws[k]), lv[k], hs[k], ws[k]);
  final_level<<<blocks((long long)H * W), BLOCK, 0, s>>>(
      image, hole, H, W, lv[1], hs[1], ws[1], step_scale(hs[1], H),
      step_scale(ws[1], W), out);
  return (int)cudaGetLastError();
}
