// K14a: legacy (aligned=False) multi-level RoIAlign over a flattened
// FPN pyramid.
//
// Replaces cartoonsegmentation_tpu/models/maskrcnn.py:roi_align_pyramid
// (the gather over the flattened P2..P5 table that serves Mask R-CNN's
// box head at 7x7 and its mask head at 14x14).
//
// flat (sum H_l*W_l, C) f32 is P2..P5 channel-last, level after level;
// boxes (N, 4) xyxy image pixels. The level of a box is
// models/maskrcnn.py:roi_levels' map, computed here with its roundings:
// floor(4 + f32(log2(double(sqrt(area) / 224 + 1e-6)))) clamped to
// [2, 5], the area (w)+ * (h)+ in f32, so no torch op runs before the
// kernel. Per box, as the plain version computes them, one
// rounding at a time:
//   scale = 1/stride, x1 = b0*scale, rw = max(b2*scale - x1, 1),
//   bin = rw / out, sample g: x1 + ((g + 0.5) / sampling) * bin;
// a sample outside [-1, size] is left out of the sum (selected out, so a
// NaN in a pixel it would read cannot reach the output); else clamp at
// 0, x0 = min((int)x, W-1), x1 = min(x0 + 1, W-1), and a tap collapsed
// at the edge (x1 == x0) gets weight 0; the four taps weighted
// (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx summed in that order, the
// samples in order. Each output is the mean of its sampling x sampling
// samples.
//
// Bound on the card: bytes (the pyramid rows the samples touch and the
// (N, C, out, out) output: 50.2 MB written at 1000 boxes of 7x7). A
// block owns a box and a group of channels whose (channels, out, out)
// tile fits ~52 KB of shared memory: all 256 channels at 7x7 (1,000
// blocks for the box head), 64 at 14x14 (400 blocks for the mask head's
// 100 boxes). The box's x and y taps (offsets, weights, out-of-bounds
// flags) are computed once into shared memory. Lanes run over the
// channels, 4 a lane as one float4 where C % 4 == 0 and the table is
// 16-byte aligned (scalars otherwise): a tap of a sample is a coalesced
// read of the group's channels of one pixel. A thread takes every
// (threads / lanes)-th bin and issues a bin's 16 loads before its sums.
// The tile is kept channel-major in shared memory, so the block's output
// is one contiguous run of (channels, out, out) floats, written with
// 16-byte stores.
#include "kb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 64;        // out * sampling of one axis
constexpr int kTileBytes = 52 * 1024;  // a block's output tile, at most
constexpr int kMaxDevices = 64;

struct Tap {
  long long o0, o1;  // the two taps' offsets into flat (row * C)
  float l, h;        // the weights of o1 and o0
  bool oob;          // the sample lies outside [-1, size]
};

__device__ __forceinline__ Tap make_tap(float v, int n, long long base,
                                        long long step) {
  Tap t;
  t.oob = v < -1.0f || v > (float)n;
  const float c = fmaxf(v, 0.0f);
  const int i0 = min((int)c, n - 1);
  const int i1 = min(i0 + 1, n - 1);
  t.l = i1 > i0 ? fminf(fmaxf(c - (float)i0, 0.0f), 1.0f) : 0.0f;
  t.h = 1.0f - t.l;
  t.o0 = base + (long long)i0 * step;
  t.o1 = base + (long long)i1 * step;
  return t;
}

// models/maskrcnn.py:roi_levels of one box, 0..3
__device__ __forceinline__ int box_level(const float* b) {
  const float area = fmaxf(b[2] - b[0], 0.0f) * fmaxf(b[3] - b[1], 0.0f);
  const float r =
      __fadd_rn(__fdiv_rn(__fsqrt_rn(area), 224.0f), 1e-6f);
  const float k = floorf(__fadd_rn(4.0f, (float)log2((double)r)));
  return (int)fminf(fmaxf(k, 2.0f), 5.0f) - 2;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

// One output bin of VEC channels at f: the S x S samples (S = 0: the
// runtime `sampling`), their taps loaded before the sums.
template <int S, int VEC>
__device__ __forceinline__ void bin_value(const float* f, const Tap* yt,
                                          const Tap* xt, int sampling,
                                          float inv, float* res) {
  constexpr int kS = S > 0 ? S : 1;
  const int s = S > 0 ? S : sampling;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  for (int iy0 = 0; iy0 < s; iy0 += kS) {
    for (int ix0 = 0; ix0 < s; ix0 += kS) {
      float v[kS][kS][4][VEC];
      bool in[kS][kS];
#pragma unroll
      for (int iy = 0; iy < kS; ++iy)
#pragma unroll
        for (int ix = 0; ix < kS; ++ix) {
          const Tap& ty = yt[iy0 + iy];
          const Tap& tx = xt[ix0 + ix];
          in[iy][ix] = !(ty.oob || tx.oob);
          if (in[iy][ix]) {
            Vec<VEC>::load(f + ty.o0 + tx.o0, v[iy][ix][0]);
            Vec<VEC>::load(f + ty.o0 + tx.o1, v[iy][ix][1]);
            Vec<VEC>::load(f + ty.o1 + tx.o0, v[iy][ix][2]);
            Vec<VEC>::load(f + ty.o1 + tx.o1, v[iy][ix][3]);
          }
        }
#pragma unroll
      for (int iy = 0; iy < kS; ++iy)
#pragma unroll
        for (int ix = 0; ix < kS; ++ix) {
          if (!in[iy][ix]) continue;
          const Tap& ty = yt[iy0 + iy];
          const Tap& tx = xt[ix0 + ix];
          const float w00 = ty.h * tx.h, w01 = ty.h * tx.l;
          const float w10 = ty.l * tx.h, w11 = ty.l * tx.l;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] += v[iy][ix][0][k] * w00 + v[iy][ix][1][k] * w01 +
                      v[iy][ix][2][k] * w10 + v[iy][ix][3][k] * w11;
        }
      if (S > 0) break;
    }
    if (S > 0) break;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) res[k] = acc[k] * inv;
}

template <int S, int VEC>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(const float* __restrict__ flat,
                     const float* __restrict__ boxes,
                     int* __restrict__ lvl_out, int C, int cg, int4 hs,
                     int4 ws, int out, int sampling,
                     float* __restrict__ res) {
  extern __shared__ float4 tile4[];  // (channels of the group, out, out)
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ Tap xt[kMaxSamples];
  __shared__ Tap yt[kMaxSamples];
  const int n = blockIdx.x, c0 = blockIdx.y * cg;
  const int cn = min(cg, C - c0);
  const int t = threadIdx.x;
  const int g = out * sampling;
  if (t < 2 * g) {
    const float* b = boxes + 4 * n;
    const int l = box_level(b);
    if (lvl_out && t == 0 && blockIdx.y == 0) lvl_out[n] = l;
    const int Hs[4] = {hs.x, hs.y, hs.z, hs.w};
    const int Ws[4] = {ws.x, ws.y, ws.z, ws.w};
    long long base = 0;
    for (int k = 0; k < l; ++k) base += (long long)Hs[k] * Ws[k];
    const float scale = 1.0f / (float)(4 << l);
    const bool is_x = t < g;
    const int i = is_x ? t : t - g;
    const float lo = (is_x ? b[0] : b[1]) * scale;
    const float len = fmaxf((is_x ? b[2] : b[3]) * scale - lo, 1.0f);
    const float bin = len / (float)out;
    const float idx = ((float)i + 0.5f) / (float)sampling;
    if (is_x)
      xt[i] = make_tap(lo + idx * bin, Ws[l], (long long)c0, C);
    else
      yt[i] = make_tap(lo + idx * bin, Hs[l], base * C,
                       (long long)Ws[l] * C);
  }
  __syncthreads();

  const float inv = 1.0f / (float)(sampling * sampling);
  const int bins = out * out;
  const int lanes = cn / VEC;  // channel vectors of the group
  const int cv = t % lanes, b0 = t / lanes, bstep = kThreads / lanes;
  const float* f = flat + cv * VEC;
  for (int bn = b0; bn < bins && b0 < bstep; bn += bstep) {
    const int ph = bn / out, pw = bn - ph * out;
    float v[VEC];
    bin_value<S, VEC>(f, yt + ph * sampling, xt + pw * sampling, sampling,
                      inv, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) tile[(cv * VEC + k) * bins + bn] = v[k];
  }
  __syncthreads();

  // the group's (cn, out, out) floats are one contiguous run of res
  const long long first = ((long long)n * C + c0) * bins;
  const int total = cn * bins;
  float* o = res + first;
  if ((first & 3) == 0 && (total & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(res) & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int k = t; k < total / 4; k += kThreads) o4[k] = tile4[k];
  } else {
    for (int k = t; k < total; k += kThreads) o[k] = tile[k];
  }
}

using Kernel = void (*)(const float*, const float*, int*, int, int, int4,
                        int4, int, int, float*);

// the largest dynamic shared memory each kernel was allowed on each
// card so far: the attribute is set once per kernel, card and size
int shm_allowed[kMaxDevices][2][2];

}  // namespace

// flat (sum H_l*W_l, C), boxes (N, 4) f32; the four levels' (H, W);
// lvl_out (N,) int32 or null: the levels (0..3) the kernel used;
// res (N, C, out, out) f32, out * sampling <= 64. Returns
// cudaGetLastError().
extern "C" int kb_roi_align(const float* flat, const float* boxes,
                            int* lvl_out, int N, int C,
                            int h0, int w0, int h1, int w1, int h2, int w2,
                            int h3, int w3, int out, int sampling, float* res,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out < 1 || sampling < 1 || out * sampling > kMaxSamples || C < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const bool vec4 =
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(flat) & 15) == 0;
  const int vec = vec4 ? 4 : 1;
  const int bins = out * out;
  // channels a block: the tile in ~kTileBytes, a multiple of 4, at most
  // a channel vector a thread
  int cg = (kTileBytes / (4 * bins)) & ~3;
  cg = min(C, min(vec * kThreads, max(4, cg)));
  const int groups = (C + cg - 1) / cg;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t shm = sizeof(float) * (size_t)cg * bins;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const bool two = sampling == 2;
  const Kernel k =
      two ? (vec4 ? roi_align_kernel<2, 4> : roi_align_kernel<2, 1>)
          : (vec4 ? roi_align_kernel<0, 4> : roi_align_kernel<0, 1>);
  int& allowed = shm_allowed[dev][two][vec4];
  if (shm > 48 * 1024 && (int)shm > allowed) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return (int)err;
    allowed = (int)shm;
  }
  k<<<dim3(N, groups), kThreads, shm, s>>>(
      flat, boxes, lvl_out, C, cg, make_int4(h0, h1, h2, h3),
      make_int4(w0, w1, w2, w3), out, sampling, res);
  return (int)cudaGetLastError();
}
