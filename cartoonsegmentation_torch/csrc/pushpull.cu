// K13a: the push-pull hole fill of the style flow's background.
//
// Replaces cartoonsegmentation_tpu/ops/inpaint_fill.py:push_pull_fill.
//
// image (H, W, 3) f32 and hole (H, W) bool. The pyramid's levels
// 1..L (each the ceil half of the one before; L = ceil(log2 max(H, W))
// unless given, so level L is one pixel) live one after the other in a
// scratch of 4 floats a pixel: the premultiplied colour sums and the
// weight sum. A level's 2x2 sum adds (0,0) + (0,1) + (1,0) + (1,1),
// with the zero padding of an odd size added as the plain version adds
// it; the fill of level k is its own colour c / max(w, 1e-8) blended
// with the bilinear upsample (half-pixel centres, clamped edges:
// jax.image.resize 'linear' for a size step up) of level k+1's fill as
// col * clip(w, 0, 1) + up * (1 - clip(w, 0, 1)); the top level's fill
// is its own colour; hole pixels of level 0 take the fill.
//
// One cooperative launch (a grid of at most the blocks the card holds
// at once, each walking tiles of 32x32 level-0 pixels), in two phases
// split by a grid barrier:
// 1. pull: a block reads its tile of the image and hole once, writes
//    the tile's non-hole pixels to the output, and sums the tile's
//    pyramid down to the level where it is one pixel (T = min(L, 5)),
//    in shared memory, writing each level's sums to the scratch (L2
//    resident: 1.8 MB at 448x768);
// 2. push: a block whose tile holds a hole pixel loads at once the
//    sums of the window of each level 1..T that the next finer level's
//    bilinear taps read (the tile plus a halo of 1-3 pixels, its
//    neighbours' sums among them), level T whole, and its hole pixels;
//    sums levels T+1..L from level T in shared memory, takes the top's
//    colour and pushes it down to level T+1 (every such block does, so
//    no second barrier: those levels are ~1/1000 of the pyramid at
//    448x768); then fills the windows level by level from T down to 1
//    and its hole pixels, without waiting for its neighbours.
// Where levels T..L exceed kCoarseBytes (1,536 pixels together:
// images past ~1,000x1,000), block 0 computes them in the scratch
// behind a second grid barrier instead, and the push reads level
// T+1's fill from there.
// Every float step repeats the plain version's order (built with
// -fmad=false); the taps' scale is the plain version's f32 quotient.
// Bound by bytes: the image and hole read, the pyramid (1/3 of H x W x
// 16 B) written and read, the result written.
#include <cooperative_groups.h>

#include "kb_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileLog = 5;                 // levels a tile sums alone
constexpr int kTile = 1 << kTileLog;        // level-0 pixels a tile side
constexpr int kMaxLevels = 62;
// dynamic shared memory, every block: the push's windows (the pull's
// tile pyramid before them), then the coarse levels T..L
constexpr int kWinBytes = 16 * 1024;
constexpr int kCoarseBytes = 24 * 1024;
constexpr int kSmemBytes = kWinBytes + kCoarseBytes;
constexpr float TINY = 1e-8f;

struct Plan {
  int L, T;                   // levels above 0; levels a tile sums
  int tiles_x, n_tiles;
  int coarse_in_smem;         // levels T..L fit in kCoarseBytes
  int h[kMaxLevels + 1], w[kMaxLevels + 1];
  long long off[kMaxLevels + 1];    // float4 offset of level k >= 1
  float sy[kMaxLevels + 1], sx[kMaxLevels + 1];  // level k+1 -> k
  int cap_h[kTileLog + 1], cap_w[kTileLog + 1];  // window sides, 1..T
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
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

// where c = w = 0 (a pixel whose children are all holes) the plain
// version's (0 / 1e-8) * 0 + up * 1 is c * 0 + up, the same bits,
// without the division (three in series a pixel, each behind its range
// check: the longest part of a level's step)
__device__ __forceinline__ float blend(float c, float w, float up) {
  if (w == 0.0f && c == 0.0f) return c * 0.0f + up;
  const float wgt = fminf(fmaxf(w, 0.0f), 1.0f);
  const float col = c / fmaxf(w, TINY);
  return col * wgt + up * (1.0f - wgt);
}

// the upsample of a fill at taps (ty, tx), the taps' indices taken
// relative to (y0, x0) in a fill of row length `stride`
template <bool kGlobal>
__device__ __forceinline__ float3 up_at(const float4* f, int stride, int y0,
                                        int x0, const Tap& ty,
                                        const Tap& tx) {
  const float4* r0 = f + (long long)(ty.i0 - y0) * stride - x0;
  const float4* r1 = f + (long long)(ty.i1 - y0) * stride - x0;
  float4 a00, a01, a10, a11;
  if (kGlobal) {
    a00 = __ldcg(r0 + tx.i0);
    a01 = __ldcg(r0 + tx.i1);
    a10 = __ldcg(r1 + tx.i0);
    a11 = __ldcg(r1 + tx.i1);
  } else {
    a00 = r0[tx.i0];
    a01 = r0[tx.i1];
    a10 = r1[tx.i0];
    a11 = r1[tx.i1];
  }
  return make_float3(bilerp(a00.x, a01.x, a10.x, a11.x, ty, tx),
                     bilerp(a00.y, a01.y, a10.y, a11.y, ty, tx),
                     bilerp(a00.z, a01.z, a10.z, a11.z, ty, tx));
}

__device__ __forceinline__ float4 blend4(float4 v, float3 up) {
  return make_float4(blend(v.x, v.w, up.x), blend(v.y, v.w, up.y),
                     blend(v.z, v.w, up.z), v.w);
}

__device__ __forceinline__ float top1(float c, float w) {
  return w == 0.0f && c == 0.0f ? c : c / fmaxf(w, TINY);   // as blend
}

__device__ __forceinline__ float4 top4(float4 v) {
  return make_float4(top1(v.x, v.w), top1(v.y, v.w), top1(v.z, v.w), v.w);
}

// i = y * n + x for 0 <= i < 2^24: y from a float reciprocal rn ~ 1 / n,
// corrected by one step (an integer division is ~20 dependent steps)
__device__ __forceinline__ void divmod(int i, int n, float rn, int& y,
                                       int& x) {
  y = (int)((float)i * rn);
  x = i - y * n;
  if (x < 0) {
    --y;
    x += n;
  } else if (x >= n) {
    ++y;
    x -= n;
  }
}

// a level-0 pixel premultiplied by w0 = !hole (zero outside the image)
__device__ __forceinline__ float4 image_w(const float* img,
                                          const unsigned char* hole,
                                          const Plan& p, int y, int x) {
  if (y >= p.h[0] || x >= p.w[0]) return zero4();
  const long long i = (long long)y * p.w[0] + x;
  const float w0 = hole[i] ? 0.0f : 1.0f;
  return make_float4(img[3 * i] * w0, img[3 * i + 1] * w0,
                     img[3 * i + 2] * w0, w0);
}

// phase 1 for one tile: levels 1..T of the tile in shared memory
// (16x16, 8x8, ... 1x1 float4 one after the other), each written to
// the scratch where it lies inside its level; non-hole pixels copied.
// Returns whether the tile holds a hole pixel (the whole block).
__device__ bool pull_tile(const float* __restrict__ img,
                          const unsigned char* __restrict__ hole,
                          const Plan& p, int tile, float4* scratch,
                          float* __restrict__ out, float4* sm) {
  const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  bool holes = false;
  if (p.T == 0) {  // a one-pixel image: nothing to sum
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int y = ty * kTile + e / kTile, x = tx * kTile + e % kTile;
      if (y >= p.h[0] || x >= p.w[0]) continue;
      const long long i = (long long)y * p.w[0] + x;
      holes |= hole[i] != 0;
      if (!hole[i])
        for (int c = 0; c < 3; ++c) out[3 * i + c] = img[3 * i + c];
    }
    return __syncthreads_or(holes);
  }
  {  // level 1: a thread a pixel of the tile's 16x16
    const int ly = threadIdx.x / 16, lx = threadIdx.x % 16;
    const int y = ty * 16 + ly, x = tx * 16 + lx;
    float4 s = zero4();
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int cy = 2 * y + (d >> 1), cx = 2 * x + (d & 1);
      const float4 v = image_w(img, hole, p, cy, cx);
      s = d == 0 ? v : add4(s, v);
      if (v.w != 0.0f) {  // a pixel inside the image, not a hole
        const long long i = (long long)cy * p.w[0] + cx;
        out[3 * i] = img[3 * i];
        out[3 * i + 1] = img[3 * i + 1];
        out[3 * i + 2] = img[3 * i + 2];
      } else {
        holes |= cy < p.h[0] && cx < p.w[0];
      }
    }
    sm[threadIdx.x] = s;
    if (y < p.h[1] && x < p.w[1])
      scratch[p.off[1] + (long long)y * p.w[1] + x] = s;
  }
  holes = __syncthreads_or(holes);
  float4* prev = sm;
  int side = 16;
  for (int k = 2; k <= p.T; ++k) {
    __syncthreads();
    float4* cur = prev + side * side;
    const int n = side / 2;
    if (threadIdx.x < n * n) {
      const int ly = threadIdx.x / n, lx = threadIdx.x % n;
      const float4* r0 = prev + (2 * ly) * side + 2 * lx;
      const float4* r1 = r0 + side;
      float4 s = add4(add4(add4(r0[0], r0[1]), r1[0]), r1[1]);
      cur[threadIdx.x] = s;
      const int y = ty * n + ly, x = tx * n + lx;
      if (y < p.h[k] && x < p.w[k])
        scratch[p.off[k] + (long long)y * p.w[k] + x] = s;
    }
    prev = cur;
    side = n;
  }
  return holes;
}

// levels T+1..L summed from level T (the top's colour taken as it is
// summed), the fill pushed down to level T+1, in place. Level k lies at lv + off[k] - off[T] (the
// scratch's layout from level T on), in shared memory or in the
// scratch; loads from the scratch go through L2.
template <bool kGlobal>
__device__ void coarse(const Plan& p, float4* lv) {
  lv -= p.off[p.T];
  for (int k = p.T + 1; k <= p.L; ++k) {
    const int hi = p.h[k - 1], wi = p.w[k - 1], n = p.h[k] * p.w[k];
    const float4* in = lv + p.off[k - 1];
    const float rn = 1.0f / (float)p.w[k];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int y, x;
      divmod(i, p.w[k], rn, y, x);
      float4 s = zero4();
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int cy = 2 * y + (d >> 1), cx = 2 * x + (d & 1);
        float4 v = zero4();
        if (cy < hi && cx < wi) {
          const float4* q = in + (long long)cy * wi + cx;
          v = kGlobal ? __ldcg(q) : *q;
        }
        s = d == 0 ? v : add4(s, v);
      }
      lv[p.off[k] + i] = k == p.L ? top4(s) : s;
    }
    __syncthreads();
  }
  for (int k = p.L - 1; k > p.T; --k) {
    const int n = p.h[k] * p.w[k];
    float4* cur = lv + p.off[k];
    const float rn = 1.0f / (float)p.w[k];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int y, x;
      divmod(i, p.w[k], rn, y, x);
      const Tap ty = tap(y, p.h[k + 1], p.sy[k]);
      const Tap tx = tap(x, p.w[k + 1], p.sx[k]);
      cur[i] = blend4(cur[i], up_at<false>(lv + p.off[k + 1], p.w[k + 1], 0,
                                           0, ty, tx));
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}

// phase 2 for one tile holding a hole pixel. Loads first, all in
// flight at once: level T whole where the coarse levels are the
// block's own, then the windows' sums of levels 1..T (two cp.async
// groups into shared memory), then the tile's hole bytes and image
// (registers); the coarse levels start once level T has landed, while
// the windows' sums are still on their way; then the chain in shared
// memory. sm: the windows (cap_h x cap_w each, level T first), then the
// coarse levels T..L from kWinBytes.
constexpr int kPix = kTile * kTile / kThreads;   // level-0 pixels a thread

__device__ void push_tile(const float* __restrict__ img,
                          const unsigned char* __restrict__ hole,
                          const Plan& p, int tile,
                          const float4* __restrict__ scratch,
                          float* __restrict__ out, float4* sm, int* win,
                          bool& coarse_done) {
  const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  const int y0 = ty * kTile, x0 = tx * kTile;
  float4* lv = sm + kWinBytes / 16;      // the block's coarse levels
  const bool coarse_here = p.L > p.T && p.coarse_in_smem && !coarse_done;
  if (coarse_here) {
    const int n = p.h[p.T] * p.w[p.T];
    const float4* src = scratch + p.off[p.T];
    for (int i = threadIdx.x; i < n; i += kThreads)
      cp_async16(lv + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the window [lo, hi) of each level k = 0..T that the finer level's
  // taps read: thread q < 4 follows one bound (rows lo, hi, columns
  // lo, hi) up the levels
  if (threadIdx.x < 4) {
    const int q = threadIdx.x;
    const bool rows = q < 2, hi = q & 1;
    const int o = rows ? y0 : x0, n0 = rows ? p.h[0] : p.w[0];
    int v = hi ? min(o + kTile, n0) : o;
    win[q] = v;
    for (int k = 1; k <= p.T; ++k) {
      const int n = rows ? p.h[k] : p.w[k];
      const float sc = rows ? p.sy[k - 1] : p.sx[k - 1];
      v = hi ? tap(v - 1, n, sc).i1 + 1 : tap(v, n, sc).i0;
      win[4 * k + q] = v;
    }
  }
  __syncthreads();
  {  // the windows' sums
    float4* slot = sm;
    for (int k = p.T; k >= 1; --k) {
      const int ylo = win[4 * k], xlo = win[4 * k + 2];
      const int nx = win[4 * k + 3] - xlo, n = (win[4 * k + 1] - ylo) * nx;
      const float4* sums = scratch + p.off[k];
      const float rn = 1.0f / (float)nx;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        int y, x;
        divmod(i, nx, rn, y, x);
        cp_async16(slot + i, sums + (long long)(ylo + y) * p.w[k] + xlo + x);
      }
      slot += p.cap_h[k] * p.cap_w[k];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // pixel e = j * kThreads + threadIdx.x of the tile: its hole byte and
  // its colour times w0 = 0 (the plain version's image * w0)
  bool hp[kPix];
  float3 c[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int e = j * kThreads + threadIdx.x;
    const int y = y0 + e / kTile, x = x0 + e % kTile;
    hp[j] = false;
    if (y >= p.h[0] || x >= p.w[0]) continue;
    const long long i = (long long)y * p.w[0] + x;
    hp[j] = hole[i] != 0;
    c[j] = make_float3(img[3 * i] * 0.0f, img[3 * i + 1] * 0.0f,
                       img[3 * i + 2] * 0.0f);
  }
  if (coarse_here) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // level T
    __syncthreads();
    coarse<false>(p, lv);       // ends in a barrier
    coarse_done = true;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const bool own_coarse = p.L > p.T && p.coarse_in_smem;
  // the fill of each window in place over its sums, k = T..1
  const float4* fine = nullptr;   // level k+1's window fill
  int fy = 0, fx = 0, fw = 0;
  float4* slot = sm;
  for (int k = p.T; k >= 1; --k) {
    const int ylo = win[4 * k], xlo = win[4 * k + 2];
    const int nx = win[4 * k + 3] - xlo, n = (win[4 * k + 1] - ylo) * nx;
    const float rn = 1.0f / (float)nx;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int y, x;
      divmod(i, nx, rn, y, x);
      y += ylo;
      x += xlo;
      if (k == p.L) {
        slot[i] = top4(slot[i]);
        continue;
      }
      const Tap tyy = tap(y, p.h[k + 1], p.sy[k]);
      const Tap txx = tap(x, p.w[k + 1], p.sx[k]);
      float3 up;
      if (k < p.T)
        up = up_at<false>(fine, fw, fy, fx, tyy, txx);
      else if (own_coarse)
        up = up_at<false>(lv + p.off[k + 1] - p.off[k], p.w[k + 1], 0, 0,
                          tyy, txx);
      else
        up = up_at<true>(scratch + p.off[k + 1], p.w[k + 1], 0, 0, tyy, txx);
      slot[i] = blend4(slot[i], up);
    }
    __syncthreads();
    fine = slot;
    fy = ylo;
    fx = xlo;
    fw = nx;
    slot += p.cap_h[k] * p.cap_w[k];
  }
  // level 0: the tile's hole pixels. With w = 0 the blend is
  // (c / 1e-8) * 0 + up * 1, and c = image * 0 is +-0 or NaN, so that
  // is c + up, the same bits
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!hp[j]) continue;
    const int e = j * kThreads + threadIdx.x;
    const int y = y0 + e / kTile, x = x0 + e % kTile;
    const long long i = (long long)y * p.w[0] + x;
    if (p.L == 0) {
      out[3 * i] = c[j].x / TINY;
      out[3 * i + 1] = c[j].y / TINY;
      out[3 * i + 2] = c[j].z / TINY;
      continue;
    }
    const Tap tyy = tap(y, p.h[1], p.sy[0]), txx = tap(x, p.w[1], p.sx[0]);
    const float3 up = up_at<false>(fine, fw, fy, fx, tyy, txx);
    out[3 * i] = c[j].x + up.x;
    out[3 * i + 1] = c[j].y + up.y;
    out[3 * i + 2] = c[j].z + up.z;
  }
}

__global__ void __launch_bounds__(kThreads)
    pushpull_kernel(const float* __restrict__ img,
                    const unsigned char* __restrict__ hole,
                    const __grid_constant__ Plan p,
                    float4* scratch, float* __restrict__ out) {
  extern __shared__ float4 sm[];
  __shared__ int win[4 * (kTileLog + 1)];
  cg::grid_group grid = cg::this_grid();

  // the block's tiles that hold a hole pixel, one bit each (the 64th
  // bit and on: any of the block's further tiles)
  unsigned long long holes = 0;
  for (int t = blockIdx.x, j = 0; t < p.n_tiles; t += gridDim.x, ++j) {
    if (pull_tile(img, hole, p, t, scratch, out, sm))
      holes |= 1ull << min(j, 63);
    __syncthreads();  // the shared tile is rewritten by the next one
  }
  grid.sync();

  // coarse levels too large for a block's shared memory: block 0 runs
  // them in the scratch, behind a second barrier
  if (p.L > p.T && !p.coarse_in_smem) {
    if (blockIdx.x == 0) coarse<true>(p, scratch + p.off[p.T]);
    grid.sync();
  }

  // a tile without a hole pixel was written whole by the pull
  bool coarse_done = false;
  for (int t = blockIdx.x, j = 0; t < p.n_tiles; t += gridDim.x, ++j) {
    if (!((holes >> min(j, 63)) & 1)) continue;
    push_tile(img, hole, p, t, scratch, out, sm, win, coarse_done);
    __syncthreads();
  }
}

// the plain version's f32 scale: the double quotient rounded once
inline float step_scale(int n_in, int n_out) {
  return (float)((double)n_in / (double)n_out);
}

}  // namespace

// image, out (H, W, 3) f32; hole (H, W) bool; scratch holds levels
// 1..L at 4 floats a pixel (L = `levels`, each level the ceil half of
// the one before). Returns the launch's error.
extern "C" int kb_pushpull(const float* image, const unsigned char* hole,
                           int H, int W, int levels, float* scratch,
                           float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  if (levels < 0 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Plan p;
  p.L = levels;
  p.T = levels < kTileLog ? levels : kTileLog;
  p.tiles_x = (W + kTile - 1) / kTile;
  const long long n_tiles = (long long)((H + kTile - 1) / kTile) * p.tiles_x;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  p.h[0] = H;
  p.w[0] = W;
  long long off = 0, n_coarse = 0;
  for (int k = 1; k <= levels; ++k) {
    p.h[k] = (p.h[k - 1] + 1) / 2;
    p.w[k] = (p.w[k - 1] + 1) / 2;
    p.off[k] = off;
    off += (long long)p.h[k] * p.w[k];
    p.sy[k - 1] = step_scale(p.h[k], p.h[k - 1]);
    p.sx[k - 1] = step_scale(p.w[k], p.w[k - 1]);
  }
  for (int k = p.T; k <= levels; ++k)
    n_coarse += (long long)p.h[k] * p.w[k];
  p.coarse_in_smem = n_coarse * 16 <= kCoarseBytes;
  // window sides, a bound on the taps' spread: n_k <= ceil((n_{k-1} -
  // 1) * s) + 3 (one for each floor, one for the f32 rounding)
  long long win = 0;
  int nh = H < kTile ? H : kTile, nw = W < kTile ? W : kTile;
  for (int k = 1; k <= p.T; ++k) {
    const double sy = (double)p.h[k] / p.h[k - 1];
    const double sx = (double)p.w[k] / p.w[k - 1];
    nh = (int)ceil((nh - 1) * sy) + 3;
    nw = (int)ceil((nw - 1) * sx) + 3;
    nh = nh < p.h[k] ? nh : p.h[k];
    nw = nw < p.w[k] ? nw : p.w[k];
    p.cap_h[k] = nh;
    p.cap_w[k] = nw;
    win += (long long)nh * nw;
  }
  // the pull's tile levels (16x16 down to 1x1) take 341 float4
  if (win * 16 > kWinBytes) return (int)cudaErrorInvalidValue;

  // blocks the card holds at once, asked once a device
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pushpull_kernel, kThreads, kSmemBytes);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  const int grid = p.n_tiles < resident[dev] ? p.n_tiles : resident[dev];
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, pushpull_kernel, image, hole, p,
                                 reinterpret_cast<float4*>(scratch), out);
}
