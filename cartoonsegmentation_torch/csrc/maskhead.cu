// K9: the RTMDet-Ins dynamic mask heads and their epilogue.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:dynamic_mask_heads
// (the per-instance 1x1 conv stack as batched einsums) and the end of
// postprocess: sigmoid, the x8 'linear' resize to the input size, the
// mask threshold and the valid gate.
//
// The maths, one rounding at a time as the plain version:
//   rel = (prior_n - 8·(x, y)) / (stride_n · 8)   (a true f32 division)
//   in  = [rel_x, rel_y, feat[p, 0..7]]           (rel first)
//   10 → 8 (ReLU) → 8 (ReLU) → 1 with the 169 generated parameters of
//   instance n unpacked as at rtmdet.py:241-251 (weights (cout, cin)
//   row-major, then the biases); each output is the sum over the inputs
//   in order, then the bias; then the sigmoid: probs (N, h·w) f32.
//   The bilinear resample with half-pixel centres and clamped edges
//   (torch's bilinear formula and order of operations, which
//   jax.image.resize 'linear' equals when it upsamples), then
//   > mask_thr and the valid gate: masks (N, H, W) u8.
//
// One launch, a block a (band of kRows = 128 output rows, instance):
// grid (ceil(H / 128), N). A block
//   - holds its instance's 169 parameters and the band's row taps in
//     shared memory;
//   - of a valid instance, computes the source rows its band reads
//     (128 / 8 + 2 at x8) into shared memory, two pixels a thread (each
//     parameter read once for both, behind an opaque offset, so that the
//     compiler does not hoist all 169 into registers), and writes to
//     `probs` the source rows it owns (each row owned by one band: from
//     the first row the band reads to the first row the next band
//     reads);
//   - forms each mask row's values from two horizontally resampled
//     source rows: a thread takes 8 consecutive columns and a slice of
//     the band's rows, keeps the two source rows resampled to its columns
//     in registers while they stay the same (~8 output rows at x8; the
//     columns' taps are formed again where they change) and stores its 8
//     mask bytes at once, each the sign of thr - v (prmt), byte stores
//     where a row's width is not a multiple of 8;
//   - of an invalid instance, computes only the source rows it owns
//     (for `probs`) and writes zeros to its band, 16 bytes a store.
// The value of a mask byte is the plain version's,
//   ly0 * (lx0 * a + lx1 * b) + ly1 * (lx0 * c + lx1 * d),
// in that order: the two parenthesised sums are the resampled rows.
//
// Bound on the card: the N·H·W mask bytes written (41 MB at N = 100,
// 640x640); the heads are ~350 f32 operations a source pixel.
#include "kb_common.cuh"

namespace {

constexpr int kProtos = 8;
constexpr int kParams = 169;
// offsets of the weights and biases in the 169 generated parameters
constexpr int kW1 = 0, kW2 = 80, kW3 = 144, kB1 = 152, kB2 = 160, kB3 = 168;
// output rows a band (64 and 32 measured slower, PERF.md §6)
constexpr int kRows = 128;
constexpr int kMaxThreads = 256;
// mask columns a thread: 8 bytes a store (16 and 4 measured slower,
// PERF.md §6)
constexpr int kCols = 8;

// torch's area_pixel_compute_source_index for bilinear, no align_corners
__host__ __device__ __forceinline__ float source_index(float scale,
                                                       int dst) {
  const float s = scale * ((float)dst + 0.5f) - 0.5f;
  return s < 0.0f ? 0.0f : s;
}

// band b's source rows: those it reads, [s_lo, s_hi], and those it
// owns, [o_lo, o_hi) (a partition of [0, h) over the bands)
struct BandRows {
  int s_lo, s_hi, o_lo, o_hi;
};

__host__ __device__ __forceinline__ BandRows band_rows(int b, int h, int H,
                                                       float scale) {
  const int nb = (H + kRows - 1) / kRows;
  const int Y0 = b * kRows, Y1 = min(H, Y0 + kRows) - 1;
  const int first = (int)source_index(scale, Y0);
  const int last = (int)source_index(scale, Y1);
  BandRows r;
  r.o_lo = b == 0 ? 0 : first;
  r.o_hi = b == nb - 1 ? h : (int)source_index(scale, Y1 + 1);
  r.s_lo = min(first, r.o_lo);
  r.s_hi = max(last + (last < h - 1 ? 1 : 0), r.o_hi - 1);
  return r;
}

// sigmoid of the dynamic heads at NP source pixels (xs[q], ys[q]), each
// parameter read once for all of them; k in shared memory
template <int NP>
__device__ __forceinline__ void head_probs(const float* k,
                                           const float* __restrict__ feat,
                                           float px, float py, float s8,
                                           const int* xs, const int* ys,
                                           int w, float* out) {
  float in[NP][kProtos + 2];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int p = ys[q] * w + xs[q];
    in[q][0] = (px - (float)xs[q] * 8.0f) / s8;
    in[q][1] = (py - (float)ys[q] * 8.0f) / s8;
#pragma unroll
    for (int c = 0; c < kProtos; ++c) in[q][2 + c] = feat[p * kProtos + c];
  }
  float h1[NP][8], h2[NP][8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[q] = in[q][0] * k[kW1 + o * 10];
#pragma unroll
    for (int c = 1; c < 10; ++c) {
      const float wt = k[kW1 + o * 10 + c];
#pragma unroll
      for (int q = 0; q < NP; ++q) acc[q] = acc[q] + in[q][c] * wt;
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) h1[q][o] = fmaxf(acc[q] + k[kB1 + o], 0.0f);
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[q] = h1[q][0] * k[kW2 + o * 8];
#pragma unroll
    for (int c = 1; c < 8; ++c) {
      const float wt = k[kW2 + o * 8 + c];
#pragma unroll
      for (int q = 0; q < NP; ++q) acc[q] = acc[q] + h1[q][c] * wt;
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) h2[q][o] = fmaxf(acc[q] + k[kB2 + o], 0.0f);
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    float logit = h2[q][0] * k[kW3];
#pragma unroll
    for (int c = 1; c < 8; ++c) logit = logit + h2[q][c] * k[kW3 + c];
    logit = logit + k[kB3];
    out[q] = 1.0f / (1.0f + expf(-logit));
  }
}

// the probabilities of the n source pixels from row y0 (row-major, w a
// row), two a thread at a time: pixels i and i + half, i = t, t + T, ...
// (cursors moved by T, no division a pixel); out(i, value) takes each
template <typename Out>
__device__ __forceinline__ void heads_range(const float* k, const float* feat,
                                            float px, float py, float s8,
                                            int y0, int w, int n, int t,
                                            int T, Out out) {
  const int half = (n + 1) >> 1;
  const int dy = T / w, dx = T - dy * w;
  int ya = t / w, xa = t - ya * w;
  int yb = (t + half) / w, xb = t + half - yb * w;
  for (int i = t; i < half; i += T) {
    // an opaque offset: the compiler cannot hoist the 169 parameter
    // loads out of the loop into registers
    int off = 0;
    asm volatile("" : "+r"(off));
    const bool second = i + half < n;
    const int xs[2] = {xa, second ? xb : xa};
    const int ys[2] = {y0 + ya, y0 + (second ? yb : ya)};
    float v[2];
    head_probs<2>(k + off, feat, px, py, s8, xs, ys, w, v);
    out(i, v[0]);
    if (second) out(i + half, v[1]);
    xa += dx;
    ya += dy;
    if (xa >= w) {
      xa -= w;
      ++ya;
    }
    xb += dx;
    yb += dy;
    if (xb >= w) {
      xb -= w;
      ++yb;
    }
  }
}

// zero bytes [0, n) of p, 16 bytes a store where aligned
__device__ __forceinline__ void zero_bytes(uint8_t* p, long long n, int t,
                                           int T) {
  const long long head =
      min(n, (long long)((16 - ((uintptr_t)p & 15)) & 15));
  const long long body = (n - head) >> 4;
  if (t < head) p[t] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (long long i = t; i < body; i += T) q[i] = make_uint4(0, 0, 0, 0);
  const long long tail = head + (body << 4);
  if (tail + t < n) p[tail + t] = 0;
}

// the sign bytes of four floats: 1 where the float is negative, else 0
// (prmt replicating each float's sign byte's top bit)
__device__ __forceinline__ unsigned int sign_bytes(float a, float b, float c,
                                                   float d) {
  unsigned int ab, cd, r;
  asm("prmt.b32 %0, %1, %2, 0x00FB;"
      : "=r"(ab) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  asm("prmt.b32 %0, %1, %2, 0x00FB;"
      : "=r"(cd) : "r"(__float_as_uint(c)), "r"(__float_as_uint(d)));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(r) : "r"(ab), "r"(cd));
  return r & 0x01010101u;
}

// kCols mask bytes from kCols differences thr - v (a byte is 1 where
// negative): one 8-byte store where vec, else the first n bytes one by
// one
__device__ __forceinline__ void store_group(uint8_t* dst, const float* d,
                                            int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(sign_bytes(d[0], d[1], d[2], d[3]),
                   sign_bytes(d[4], d[5], d[6], d[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < n) dst[j] = d[j] < 0.0f;
  }
}

// four blocks an SM (64 registers a thread): faster than three or two
// on the shipped default's calls (PERF.md §6)
__global__ void __launch_bounds__(kMaxThreads, 4)
    maskhead_kernel(const float* __restrict__ feat,
                    const float* __restrict__ params,
                    const float* __restrict__ priors,
                    const float* __restrict__ strides,
                    const uint8_t* __restrict__ valid, int h, int w, int H,
                    int W, float thr, int S, bool vec,
                    float* __restrict__ probs, uint8_t* __restrict__ masks) {
  extern __shared__ float P[];  // the band's source rows of probs
  __shared__ __align__(16) float k[kParams];
  // a row's first source row from s_lo, and its second's offset (0 or 1)
  // in bit 16; its second row's weight
  __shared__ int ry[kRows];
  __shared__ float rly[kRows];
  const int n = blockIdx.y, b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const float sy = (float)h / (float)H, sx = (float)w / (float)W;
  const BandRows br = band_rows(b, h, H, sy);
  const int Y0 = b * kRows, rows = min(kRows, H - Y0);
  for (int i = t; i < kParams; i += T)
    k[i] = params[(long long)n * kParams + i];
  for (int i = t; i < rows; i += T) {
    const float s = source_index(sy, Y0 + i);
    const int y1 = (int)s;
    ry[i] = (y1 - br.s_lo) | (y1 < h - 1 ? 1 << 16 : 0);
    rly[i] = s - (float)y1;
  }
  const float px = priors[2 * n], py = priors[2 * n + 1];
  const float s8 = strides[n] * 8.0f;
  float* prow = probs + (long long)n * h * w;
  uint8_t* mplane = masks + (long long)n * H * W;
  __syncthreads();

  if (!valid[n]) {
    heads_range(k, feat, px, py, s8, br.o_lo, w, (br.o_hi - br.o_lo) * w, t,
                T, [&](int i, float v) { prow[br.o_lo * w + i] = v; });
    zero_bytes(mplane + (long long)Y0 * W, (long long)rows * W, t, T);
    return;
  }
  const int own0 = (br.o_lo - br.s_lo) * w, own1 = (br.o_hi - br.s_lo) * w;
  heads_range(k, feat, px, py, s8, br.s_lo, w, (br.s_hi - br.s_lo + 1) * w,
              t, T, [&](int i, float v) {
                P[i] = v;
                if (i >= own0 && i < own1) prow[br.s_lo * w + i] = v;
              });
  __syncthreads();

  // the mask rows: a thread kCols columns of a slice of the band's rows; the
  // columns' taps are formed again where the source rows change
  const int G = (W + kCols - 1) / kCols;
  for (int it = t; it < S * G; it += T) {
    const int sl = it / G, g = it - sl * G;
    const int i0 = sl * rows / S, i1 = (sl + 1) * rows / S;
    const int X0 = g * kCols, nx = min(kCols, W - X0);
    float h0[kCols], h1[kCols];
    int ya = -1, yb = -1;
    uint8_t* dst = mplane + (long long)(Y0 + i0) * W + X0;
    for (int i = i0; i < i1; ++i, dst += W) {
      const int na = ry[i] & 0xffff, nb = na + (ry[i] >> 16);
      if (na != ya || nb != yb) {
        // the second row becomes the first (the same bits: the same
        // row and taps), or both are formed
        const bool both = na != yb;
        const float* r0 = P + na * w;
        const float* r1 = P + nb * w;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float s = source_index(sx, min(X0 + j, W - 1));
          const int x1 = (int)s, x2 = x1 + (x1 < w - 1 ? 1 : 0);
          const float lx1 = s - (float)x1, lx0 = 1.0f - lx1;
          h0[j] = both ? lx0 * r0[x1] + lx1 * r0[x2] : h1[j];
          h1[j] = lx0 * r1[x1] + lx1 * r1[x2];
        }
        ya = na;
        yb = nb;
      }
      const float ly1 = rly[i], ly0 = 1.0f - ly1;
      // thr - v < 0 exactly when v > thr (a difference of finite floats
      // rounds to 0 only when they are equal): its sign is the byte
      float d[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        d[j] = thr - (ly0 * h0[j] + ly1 * h1[j]);
      store_group(dst, d, nx, vec);
    }
  }
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
  if (N > 65535) return (int)cudaErrorInvalidValue;
  if (N <= 0 || h <= 0 || w <= 0 || H <= 0 || W <= 0) return 0;
  if (thr == 0.0f) thr = 0.0f;  // -0 as +0: thr - v is then -0 for no v
  // the most source rows a band reads, by the kernel's own arithmetic
  const float sy = (float)h / (float)H;
  const int nb = (H + kRows - 1) / kRows;
  int cap = 0;
  for (int b = 0; b < nb; ++b) {
    const BandRows br = band_rows(b, h, H, sy);
    cap = max(cap, br.s_hi - br.s_lo + 1);
  }
  const size_t smem = (size_t)cap * w * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int G = (W + kCols - 1) / kCols;
  const int S = max(1, kMaxThreads / G);
  const int T = min(kMaxThreads, S * G);
  const bool vec = W % kCols == 0 && (uintptr_t)masks % kCols == 0;
  maskhead_kernel<<<dim3(nb, N), T, smem, s>>>(feat, params, priors, strides,
                                               valid, h, w, H, W, thr, S, vec,
                                               probs, masks);
  return (int)cudaGetLastError();
}
