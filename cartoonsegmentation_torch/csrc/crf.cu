// K12b: mean-field steps of the binary dense CRF, and its norm pass.
//
// Replaces the loop body of cartoonsegmentation_tpu/ops/crf.py:
// densecrf_binary (:128-136) with clustered_bilateral (:77-91),
// _wide_blur (:41-52) and _blur2d (:25-38):
//   m_gauss = (blur5(q) - q) / gauss_norm
//   m_bilat = (bilat(q) - q) / bilat_norm
//   q' = softmax(-unary - swap(3 m_gauss + 40 m_bilat))
// where bilat(q) at a pixel of colour cluster c is the wide blur of
// q * 1[label = c]: a sum pool onto a lattice of s x s cells, an
// unnormalised Gaussian of radius R there (zero padding), and JAX's
// linear upsample (half-pixel centres, border weights renormalised)
// back to the pixel. The norm pass computes gauss_norm and bilat_norm
// the same way from q = 1 (one channel): blur - 1, as the JAX version
// runs under jit (XLA folds its "- 1 + 1e-8" into "+ (1e-8 - 1)",
// which is -1 in f32), and raises a flag where a norm is 0: there the
// JAX version divides by zero and its NaN empties the whole mask from
// the second step on, so a step writes an empty mask where it is set.
//
// Bound on the card (chip_smoke.py's bound()): bytes, 37 B a pixel
// for a step (q 8, the labels 4, the unary 8 and the norms 8 read once,
// q' 8 and the mask 1 written once; 21.8 MB at 576 x 1024, 6.5 us at
// 3.35 TB/s), against ~0.12 G f32 operations (1.8 us at 67 TFLOP/s);
// 12 B a pixel for the norm pass (the labels read, the norms written),
// so 12 + 4 x 36 + 37 for a densecrf_binary of 5 steps, whose steps
// before the last write no mask.
// One entry point runs the norm pass and any number of steps (a whole
// densecrf_binary after its k-means), three kernels a pass, each the
// plain version's arithmetic in its order (built with -fmad=false):
//  1. pool: a block owns one lattice row band and a run of cells, a
//     thread a pixel column (neighbouring threads on neighbouring
//     pixels: the labels and q load coalesced, each pixel once). The
//     thread loads its column's rows of the band (24 at once: a 23-px
//     cell in one round trip) and adds each q to its own label's sum,
//     0.0 to the others: the K x C (<= 32) sums stay in registers. An
//     added 0.0 leaves an f32 sum of non-negative values as it is (the
//     plain version adds the same zeros), so each sum is the plain
//     _pool_sum's column sum bit for bit. The column sums go to shared
//     memory, and a thread a (cluster, channel, cell) adds its s
//     columns in order (the plain version's across-columns sum);
//  2. lattice blur: a block a (plane, lattice row): each column's sum
//     over the row taps once into shared memory, then each cell's sum
//     over the column taps (the plain _blur2d's two passes);
//  3. pixel: a block stages its 32 x 8 tile of q with a 2-pixel halo
//     (zeros outside the frame; ones in the norm pass) in shared
//     memory, and issues its pixels' other loads (labels, unary, norms,
//     upsample taps, the own cluster's four lattice values) before the
//     barrier; the 5 x 5 Gaussian's first pass runs once a tile column
//     (halo columns included), the second from those sums, an
//     out-of-frame tap adding 0.0 as the plain version's zero padding;
//     each pixel writes q' and, on the last step, the mask q1 > q0
//     (empty where the flag is set).
// On the CRF clip's crops (16 x 176 to 419 x 101 px) a pass is a few
// microseconds of launches and one block's latency chain, not bytes;
// 8 rows loaded ahead, or 4 pixel rows a thread, measured slower there
// (PERF.md).
// The tap tables (the Gaussians' and the upsample's) are one buffer on
// the card per (H, W, sxy) (ops/crf.py:_crf_table_buffer); a step
// allocates nothing.
#include "kb_common.cuh"

namespace {

constexpr int kGaussR = 2;      // GAUSS_RADIUS
constexpr int kMaxRadius = 15;  // CRF_MAX_RADIUS
constexpr int kMaxK = 16;       // KMEANS_MAX_K
constexpr int kPoolColumns = 256;  // threads a pool block, at most
constexpr int kBatch = 24;         // rows a pool thread loads ahead
// a pixel block: kTileX x kTileY threads, a pixel each
constexpr int kTileX = 32, kTileY = 8;
constexpr int kSmemMax = 232448;   // ops/_cuda.py:SMEM_BYTES
constexpr int kMaxLatticeW = 8192; // the blur's row in shared memory

// the tap tables, one buffer of 4-byte words (ops/crf.py:
// _crf_table_buffer): g5 (5 f32), glat (2R + 1 f32), ri (H i32), rw
// (H x 2 f32), ci (W i32), cw (W x 2 f32)
struct Tables {
  const float* g5;
  const float* glat;
  const int* ri;
  const float* rw;
  const int* ci;
  const float* cw;
};

Tables tables_of(const void* buf, int H, int W, int R) {
  const float* f = static_cast<const float*>(buf);
  Tables t;
  t.g5 = f;
  t.glat = f + 2 * kGaussR + 1;
  t.ri = reinterpret_cast<const int*>(t.glat + 2 * R + 1);
  t.rw = reinterpret_cast<const float*>(t.ri + H);
  t.ci = reinterpret_cast<const int*>(t.rw + 2 * H);
  t.cw = reinterpret_cast<const float*>(t.ci + W);
  return t;
}

// C = 2: q (H, W, 2); C = 1: the norm pass, q = 1 (q unused). A block
// owns lattice row band blockIdx.y and the cells from blockIdx.x *
// cells on: cells * s pixel columns, a thread each (or a few, where a
// cell is wider than the block).
template <int C>
__global__ void __launch_bounds__(kPoolColumns)
    pool_kernel(const float* __restrict__ q, const int* __restrict__ labels,
                int H, int W, int K, int s, int cells, int gh, int gw,
                float* __restrict__ pooled) {
  extern __shared__ float cols[];  // (K C, cells s) column sums
  const int ncols = cells * s;
  const int gy = blockIdx.y, gx0 = blockIdx.x * cells;
  const int y0 = gy * s, rows = min(s, H - y0);
  for (int xl = threadIdx.x; xl < ncols; xl += blockDim.x) {
    const int x = gx0 * s + xl;
    float sum[kMaxK * C];
#pragma unroll
    for (int i = 0; i < kMaxK * C; ++i) sum[i] = 0.0f;
    for (int d0 = 0; x < W && d0 < rows; d0 += kBatch) {
      int lbl[kBatch];
      float2 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        lbl[b] = -1;
        v[b] = make_float2(1.0f, 0.0f);
        if (d0 + b < rows) {
          const long long p = (long long)(y0 + d0 + b) * W + x;
          lbl[b] = __ldg(labels + p);
          if (C == 2) v[b] = __ldg(reinterpret_cast<const float2*>(q) + p);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const bool own = lbl[b] == k;
          sum[C * k] = sum[C * k] + (own ? v[b].x : 0.0f);
          if (C == 2) sum[C * k + 1] = sum[C * k + 1] + (own ? v[b].y : 0.0f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxK * C; ++i)
      if (i < K * C) cols[i * ncols + xl] = sum[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K * C * cells; j += blockDim.x) {
    const int plane = j / cells, cell = j - plane * cells;
    const int gx = gx0 + cell;
    if (gx >= gw) continue;
    const float* c = cols + plane * ncols + cell * s;
    float out = c[0];
    for (int dx = 1; dx < s; ++dx) out = out + c[dx];
    pooled[((long long)plane * gh + gy) * gw + gx] = out;
  }
}

// Separable blur of lattice row gy of plane blockIdx.x: each column's
// sum over the row taps i (out1), then each cell's sum over the column
// taps j of its row's out1, each from 0 in tap order; taps over the
// border add 0 (the zero padding). out1 is formed once a column, as
// the plain version's first pass does.
__global__ void blur_kernel(const float* __restrict__ pooled, int gh,
                            int gw, int R, const float* __restrict__ taps,
                            float* __restrict__ blurred) {
  extern __shared__ float out1[];  // (gw,) the row's column sums
  __shared__ float k[2 * kMaxRadius + 1];
  const int gy = blockIdx.y;
  const float* src = pooled + (long long)blockIdx.x * gh * gw;
  if (threadIdx.x <= 2 * R) k[threadIdx.x] = taps[threadIdx.x];
  __syncthreads();
  for (int x = threadIdx.x; x < gw; x += blockDim.x) {
    float o = 0.0f;
    for (int i = 0; i <= 2 * R; ++i) {
      const int y = gy + i - R;
      o = o + k[i] * ((y >= 0 && y < gh) ? src[y * gw + x] : 0.0f);
    }
    out1[x] = o;
  }
  __syncthreads();
  float* dst = blurred + ((long long)blockIdx.x * gh + gy) * gw;
  for (int gx = threadIdx.x; gx < gw; gx += blockDim.x) {
    float out2 = 0.0f;
    for (int j = 0; j <= 2 * R; ++j) {
      const int x = gx + j - R;
      out2 = out2 + k[j] * ((x >= 0 && x < gw) ? out1[x] : 0.0f);
    }
    dst[gx] = out2;
  }
}

struct PixelArgs {
  const float* q;  // (H, W, 2); unused by the norm pass (q = 1)
  const int* labels;
  const float* unary;  // (H, W, 2)
  float* norms;        // (H, W, 2): written by the norm pass, else read
  int* dead;           // set by the norm pass where a norm is 0
  int H, W, gh, gw;
  Tables tab;
  const float* blurred;  // (K C, gh, gw)
  float gauss_compat, bilat_compat;
  float* q_out;          // (H, W, 2)
  unsigned char* mask;   // (H, W) or null
  int mask_dead;         // the mask is empty where dead is set
};

template <int C>
__global__ void __launch_bounds__(kTileX * kTileY)
    pixel_kernel(PixelArgs a) {
  constexpr int kTh = kTileY;                 // the tile's rows
  constexpr int kTw = kTileX + 2 * kGaussR;   // its columns with the halo
  __shared__ float2 tile[kTh + 2 * kGaussR][kTw];
  __shared__ float2 col[kTh][kTw];  // the Gaussian's first pass
  const int bx = blockIdx.x * kTileX, by = blockIdx.y * kTh;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  for (int i = tid; i < (kTh + 2 * kGaussR) * kTw; i += kTileX * kTileY) {
    const int ly = i / kTw, lx = i - ly * kTw;
    const int y = by + ly - kGaussR, x = bx + lx - kGaussR;
    float2 v = make_float2(0.0f, 0.0f);
    if (y >= 0 && y < a.H && x >= 0 && x < a.W)
      v = C == 2 ? __ldg(reinterpret_cast<const float2*>(a.q) +
                         (long long)y * a.W + x)
                 : make_float2(1.0f, 0.0f);
    tile[ly][lx] = v;
  }
  // the pixels' own loads before the barrier, so that they overlap the
  // tile's
  const int ty = threadIdx.y;
  const int x = min(bx + (int)threadIdx.x, a.W - 1);
  const int y = min(by + ty, a.H - 1);
  const long long p = (long long)y * a.W + x;
  const int jx0 = __ldg(a.tab.ci + x), jx1 = min(jx0 + 1, a.gw - 1);
  const float wx0 = __ldg(a.tab.cw + 2 * x), wx1 = __ldg(a.tab.cw + 2 * x + 1);
  const int lbl = __ldg(a.labels + p);
  const int iy0 = __ldg(a.tab.ri + y), iy1 = min(iy0 + 1, a.gh - 1);
  const float wy0 = __ldg(a.tab.rw + 2 * y);
  const float wy1 = __ldg(a.tab.rw + 2 * y + 1);
  float bilat[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float* B = a.blurred + (long long)(lbl * C + ch) * a.gh * a.gw;
    const float t0 = wy0 * B[iy0 * a.gw + jx0] + wy1 * B[iy1 * a.gw + jx0];
    const float t1 = wy0 * B[iy0 * a.gw + jx1] + wy1 * B[iy1 * a.gw + jx1];
    bilat[ch] = wx0 * t0 + wx1 * t1;
  }
  float2 un = make_float2(0.0f, 0.0f), nm = un;
  if (C == 2) {
    un = __ldg(reinterpret_cast<const float2*>(a.unary) + p);
    nm = __ldg(reinterpret_cast<const float2*>(a.norms) + p);
  }
  float g5[2 * kGaussR + 1];
#pragma unroll
  for (int i = 0; i <= 2 * kGaussR; ++i) g5[i] = __ldg(a.tab.g5 + i);
  __syncthreads();
  // the 5 x 5 Gaussian's first pass (down the rows) once a column of
  // the tile, halo columns included: out1, as the plain version forms
  // it before its second pass
  for (int i = tid; i < kTh * kTw; i += kTileX * kTileY) {
    const int ly = i / kTw, lx = i - ly * kTw;
    float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
    for (int k = 0; k <= 2 * kGaussR; ++k) {
      const float2 v = tile[ly + k][lx];
      o0 = o0 + g5[k] * v.x;
      if (C == 2) o1 = o1 + g5[k] * v.y;
    }
    col[ly][lx] = make_float2(o0, o1);
  }
  __syncthreads();
  if (bx + (int)threadIdx.x >= a.W || by + ty >= a.H) return;
  // the second pass (across the columns)
  float gauss0 = 0.0f, gauss1 = 0.0f;
#pragma unroll
  for (int j = 0; j <= 2 * kGaussR; ++j) {
    const float2 v = col[ty][threadIdx.x + j];
    gauss0 = gauss0 + g5[j] * v.x;
    if (C == 2) gauss1 = gauss1 + g5[j] * v.y;
  }
  if (C == 1) {
    const float gn = gauss0 - 1.0f, bn = bilat[0] - 1.0f;
    reinterpret_cast<float2*>(a.norms)[p] = make_float2(gn, bn);
    if (gn == 0.0f || bn == 0.0f) atomicOr(a.dead, 1);
    return;
  }
  const float2 qc = tile[ty + kGaussR][threadIdx.x + kGaussR];
  const float gn = nm.x, bn = nm.y;
  const float msg0 = a.gauss_compat * ((gauss0 - qc.x) / gn) +
                     a.bilat_compat * ((bilat[0] - qc.x) / bn);
  const float msg1 = a.gauss_compat * ((gauss1 - qc.y) / gn) +
                     a.bilat_compat * ((bilat[C - 1] - qc.y) / bn);
  // Potts: each label is penalised by the other label's message
  const float a0 = -un.x - msg1;
  const float a1 = -un.y - msg0;
  const float m = fmaxf(a0, a1);
  const float e0 = expf(a0 - m), e1 = expf(a1 - m);
  const float sum = e0 + e1;
  const float q0 = e0 / sum, q1 = e1 / sum;
  reinterpret_cast<float2*>(a.q_out)[p] = make_float2(q0, q1);
  if (a.mask)
    a.mask[p] = (q1 > q0 && !(a.mask_dead && *a.dead != 0)) ? 1 : 0;
}

// shared memory above 48 KB must be asked for once per kernel
template <int C>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      pool_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  done = e == cudaSuccess;
  return e;
}

// one pass: the pool, the lattice blur and the pixel kernel of q
// (C = 2) or of q = 1 (C = 1, the norm pass)
template <int C>
cudaError_t pass(PixelArgs a, int K, int s, int R, float* pooled,
                 float* blurred, cudaStream_t st) {
  const int cells = s >= kPoolColumns ? 1 : kPoolColumns / s;
  const int threads = min(cells * s, kPoolColumns);
  const size_t smem = sizeof(float) * K * C * cells * s;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<C>();
    if (e != cudaSuccess) return e;
  }
  const dim3 pgrid((a.gw + cells - 1) / cells, a.gh);
  pool_kernel<C><<<pgrid, threads, smem, st>>>(
      a.q, a.labels, a.H, a.W, K, s, cells, a.gh, a.gw, pooled);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // at least a warp: the block's first 2R + 1 threads load the taps
  const int bthreads = 32 * ((min(a.gw, 256) + 31) / 32);
  blur_kernel<<<dim3(K * C, a.gh), bthreads, sizeof(float) * a.gw, st>>>(
      pooled, a.gh, a.gw, R, a.tab.glat, blurred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.blurred = blurred;
  const dim3 grid((a.W + kTileX - 1) / kTileX, (a.H + kTileY - 1) / kTileY);
  pixel_kernel<C><<<grid, dim3(kTileX, kTileY), 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The norm pass (norm_pass = 1) and then `steps` mean-field steps.
// q: (H, W, 2) f32, the first step's input (unused without steps);
// labels: (H, W) int32 in [0, K); unary: (H, W, 2) f32 (-log(1 - p),
// -log p); norms: (H, W, 2) f32, written by the norm pass, read by the
// steps; dead: one int32, zeroed and set by the norm pass where a norm
// is 0; s, gh, gw, R: the lattice (cells of s <= 1024 pixels, gh x gw
// cells, blur radius R <= 15); tables: the tap tables (above); work:
// 4 K gh gw f32 scratch (the lattice sums and their blur), and 2 H W
// more with two steps or more (the steps' q alternate between it and
// q_out, so that the last step writes q_out); q_out: (H, W, 2) f32, the
// last step's q; mask: (H, W) uint8 or null, the last step's q1 > q0,
// empty where dead is set if mask_dead. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int kb_crf(const float* q, const int* labels, const float* unary,
                      float* norms, int* dead, int H, int W, int K, int s,
                      int gh, int gw, int R, const void* tables,
                      float gauss_compat, float bilat_compat, int norm_pass,
                      int steps, int mask_dead, float* work, float* q_out,
                      unsigned char* mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (R > kMaxRadius || R < 0 || K < 1 || K > kMaxK || s < 1 || s > 1024 ||
      gw > kMaxLatticeW || steps < 0)
    return (int)cudaErrorInvalidValue;
  PixelArgs a{};
  a.labels = labels;
  a.unary = unary;
  a.norms = norms;
  a.dead = dead;
  a.H = H;
  a.W = W;
  a.gh = gh;
  a.gw = gw;
  a.tab = tables_of(tables, H, W, R);
  a.gauss_compat = gauss_compat;
  a.bilat_compat = bilat_compat;
  a.mask_dead = mask_dead;
  float* pooled = work;
  float* blurred = work + 2 * K * gh * gw;
  float* q_tmp = work + 4 * K * gh * gw;
  cudaError_t e;
  if (norm_pass) {
    e = cudaMemsetAsync(dead, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    e = pass<1>(a, K, s, R, pooled, blurred, st);
    if (e != cudaSuccess) return (int)e;
  }
  for (int i = 0; i < steps; ++i) {
    a.q = i == 0 ? q : a.q_out;
    a.q_out = (steps - 1 - i) % 2 == 0 ? q_out : q_tmp;
    a.mask = i == steps - 1 ? mask : nullptr;
    e = pass<2>(a, K, s, R, pooled, blurred, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
