// K15a: SAM's encoder attention with decomposed relative positions,
// softmax((q * hd^-0.5) . k^T + bh[.., key_row] + bw[.., key_col]) . v.
//
// Replaces the core of cartoonsegmentation_tpu/models/sam.py:
// SamAttention (:91-107), which materialises the (N, N) score matrix
// of every head: 14x14 windows (N = 196, 25 of them at 1024^2) in 8
// blocks and the whole 64x64 grid (N = 4096) in the 4 global ones.
//
// Bound on the card: the two products, 4 n N^2 hd operations a call
// (51.5 G at N = 4096 with 12 heads of 64), on the tensor cores in
// 3xTF32, so 3 x 51.5 G at 495 TFLOP/s: 0.312 ms; the global block's
// bytes take 0.0225 ms. At the 25 windows of 196 the bytes bind (66.9
// MB with the rel-pos terms: 0.0200 ms against 0.0179 for the
// products).
//
// Precision: the JAX version runs in f32 and the port holds the kernel
// to 1e-5 of the output's range. Single-pass TF32 misses that (5e-4 of
// the range in the CPU emulation of this schedule,
// tests/test_torch_attn_tf32.py); three passes (mma_tf32.cuh) meet it
// at ~1e-6 there and ~4e-6 on the card.
//
// Design: flash attention on mma.sync.m16n8k8 TF32. A block of 8 warps
// takes one (batch row, head, tile of 128 queries); each warp owns 16
// query rows, the row count of an mma fragment. q is read from the
// qkv projection (B, N, 3, heads, hd) in place, scaled and split into
// hi/lo registers once (at hd 80 into shared memory, each lane reading
// back its own: so that nothing spills, hd 80 also takes tiles of 32
// keys). Tiles of 64 keys of K and V come in by 16-byte cp.async, read
// in place at their token stride 3 heads hd (keys past N zero-filled:
// src-size 0); the block then splits the tile once into
// hi/lo fragments in shared memory, (hi, hi, lo, lo) of two
// neighbouring elements as one 16-byte word (K's elements 2p, 2p + 1
// of a key; V's keys 2q, 2q + 1 of a dim), so that each B fragment is
// one read and no warp splits what the 7 others split too. The copy of
// the next tile runs under this tile's products. Split rows are padded
// to 16 (K) and 8 (V) floats mod 32: the fragment reads are free of
// bank conflicts.
//
// Each tile's 16 x 64 scores of a warp live in registers in the
// accumulator layout. The rel-pos terms of the block's 128 rows (bw's
// Ws then bh's Hs, 70 KB at the global grid, 20 KB at 14 x 14) are
// staged in shared memory once and added per key: where Ws is a
// multiple of 64 (the global grid) a tile lies in one grid row, one bh
// term a row and bw as float2; elsewhere (Ws = 14: a tile spans 4.6
// grid rows) each key's row j / Ws comes from a float reciprocal. The
// online softmax reduces each row's max over the 4 lanes that share it
// (-inf past N), uses expf, and keeps per-lane row sums until the end.
// The score fragment is the p fragment of p . v as it stands
// (mma_tf32.cuh); a tile's p . v sums in fresh accumulators and is
// added to the rescaled output in f32, since the tensor cores truncate
// as they accumulate: 64 tiles of 24 steps in one accumulator drifted
// by 3e-5 of the range at N = 4096 on the H100. hd 64 is 8 k-steps and
// 8 output fragments, hd 80 10 and 10.
#include "kb_common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace kbmma;

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // queries a block
constexpr int kThreads = 32 * kWarps;

template <int HD>
struct Shape {
  // hd 80: q's fragments in shared memory, 32 keys a tile (no spills)
  static constexpr bool QSM = HD > 64;
  static constexpr int QF = QSM ? 2 * kRows * HD : 0;  // floats of q
  static constexpr int KEYS = QSM ? 32 : 64;
  static constexpr int KF = KEYS / 8;        // score fragments a tile
  static constexpr int KS = HD / 8;          // k-steps of q.k; o fragments
  static constexpr int CH = HD / 4;          // 16-byte chunks a row
  static constexpr int RAW = KEYS * HD;      // floats of a raw K or V tile
  static constexpr int KSR = 2 * HD + 16;    // floats a split K row (key)
  static constexpr int VSR = 4 * HD + 8;     // floats a split V row (keys
                                             // 2q, 2q + 1)
  static constexpr int SPLIT = KEYS * KSR + KEYS / 2 * VSR;
};

// floats a row of rel-pos terms (bw's Ws, then bh's Hs), padded to 8
// mod 32: the float2 reads of a tile's row-aligned terms are then free
// of bank conflicts
__host__ __device__ inline int bias_stride(int Hs, int Ws) {
  const int hw = Hs + Ws;
  return hw + (40 - hw % 32) % 32;
}

template <int HD>
size_t smem_bytes(int Hs, int Ws) {
  using S = Shape<HD>;
  return sizeof(float) * (2 * S::RAW + S::SPLIT + S::QF +
                          (size_t)kRows * bias_stride(Hs, Ws));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    samattn_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ bh,
                   const float* __restrict__ bw, int N, int heads, int Hs,
                   int Ws, float scale, float* __restrict__ out) {
  using S = Shape<HD>;
  extern __shared__ float4 smem4[];
  constexpr int KEYS = S::KEYS;
  float* kraw = reinterpret_cast<float*>(smem4);  // [KEYS][HD]
  float* vraw = kraw + S::RAW;                     // [KEYS][HD]
  float* ksp = vraw + S::RAW;                      // [KEYS][KSR]
  float* vsp = ksp + KEYS * S::KSR;                // [KEYS / 2][VSR]
  float* bias = vsp + KEYS / 2 * S::VSR;           // [kRows][BS]
  const int HW = Hs + Ws, BS = bias_stride(Hs, Ws);
  // (QSM) [warp][k-step][hi, lo][lane]
  uint4* qsm = reinterpret_cast<uint4*>(bias + kRows * BS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const long long tok = 3LL * heads * HD;  // floats between tokens
  const float* qbase = qkv + (long long)b * N * tok + (long long)h * HD;
  const float* kbase = qbase + (long long)heads * HD;
  const float* vbase = kbase + (long long)heads * HD;

  auto load_tile = [&](int j0) {
    for (int idx = threadIdx.x; idx < KEYS * S::CH; idx += kThreads) {
      const int r = idx / S::CH, c = idx - r * S::CH;
      const bool ok = j0 + r < N;
      const long long off = (long long)(ok ? j0 + r : 0) * tok + 4 * c;
      cp_async16(kraw + r * HD + 4 * c, kbase + off, ok);
      cp_async16(vraw + r * HD + 4 * c, vbase + off, ok);
    }
    cp_async_commit();
  };
  const int ntiles = (N + KEYS - 1) / KEYS;
  load_tile(0);

  // the rel-pos terms of the block's rows (zeros past N)
  const long long bhw = (long long)b * heads + h;
  for (int idx = threadIdx.x; idx < kRows * HW; idx += kThreads) {
    const int r = idx / HW, c = idx - r * HW, i = i0 + r;
    float x = 0.0f;
    if (i < N)
      x = c < Ws ? __ldg(bw + (bhw * N + i) * Ws + c)
                 : __ldg(bh + (bhw * N + i) * Hs + (c - Ws));
    bias[r * BS + c] = x;
  }

  // this warp's rows r0 and r0 + 8: q scaled, split once
  const int r0 = warp * 16 + g;
  const bool ok0 = i0 + r0 < N, ok1 = i0 + r0 + 8 < N;
  Frag4 qf[S::QSM ? 1 : S::KS];
  {
    const float* q0 = qbase + (long long)(i0 + r0) * tok + 2 * t;
    const float* q1 = q0 + 8 * tok;
    const float2 z = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const float2 x0 =
          ok0 ? *reinterpret_cast<const float2*>(q0 + 8 * kk) : z;
      const float2 x1 =
          ok1 ? *reinterpret_cast<const float2*>(q1 + 8 * kk) : z;
      const Frag4 f(x0.x * scale, x1.x * scale, x0.y * scale,
                    x1.y * scale);
      if constexpr (S::QSM) {
        uint4* dst = qsm + (warp * S::KS + kk) * 64 + lane;
        dst[0] = make_uint4(f.hi[0], f.hi[1], f.hi[2], f.hi[3]);
        dst[32] = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
      } else {
        qf[kk] = f;
      }
    }
  }
  const float* b0 = bias + r0 * BS;  // row r0's terms; r0 + 8's at 8 BS
  const float* b1 = b0 + 8 * BS;
  // a tile lies in one grid row when Ws is a multiple of it (the global
  // blocks: Ws = 64), and then N is too
  const bool row_tiles = Ws % KEYS == 0;
  const float inv_ws = 1.0f / (float)Ws;

  float o[S::KS][4];
#pragma unroll
  for (int nf = 0; nf < S::KS; ++nf)
    o[nf][0] = o[nf][1] = o[nf][2] = o[nf][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int tile = 0; tile < ntiles; ++tile) {
    // the raw tile has landed and every warp is done with the last
    // split tile: split this one
    cp_async_wait<0>();
    __syncthreads();
    for (int idx = threadIdx.x; idx < KEYS * HD / 2; idx += kThreads) {
      const int r = idx / (HD / 2), p = idx - r * (HD / 2);
      const float2 x =
          *reinterpret_cast<const float2*>(kraw + r * HD + 2 * p);
      uint32_t h0, h1, q0, q1;
      split(x.x, h0, q0);
      split(x.y, h1, q1);
      *reinterpret_cast<uint4*>(ksp + r * S::KSR + 4 * p) =
          make_uint4(h0, h1, q0, q1);
    }
    for (int idx = threadIdx.x; idx < KEYS / 2 * HD; idx += kThreads) {
      const int q = idx / HD, d = idx - q * HD;
      uint32_t h0, h1, q0, q1;
      split(vraw[2 * q * HD + d], h0, q0);
      split(vraw[(2 * q + 1) * HD + d], h1, q1);
      *reinterpret_cast<uint4*>(vsp + q * S::VSR + 4 * d) =
          make_uint4(h0, h1, q0, q1);
    }
    __syncthreads();
    if (tile + 1 < ntiles) load_tile((tile + 1) * KEYS);
    const int j0 = tile * KEYS;

    // s = (q * scale) . k^T: 16 x KEYS a warp, key 8 nf + 2t + e
    float s[S::KF][4];
#pragma unroll
    for (int nf = 0; nf < S::KF; ++nf)
      s[nf][0] = s[nf][1] = s[nf][2] = s[nf][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      Frag4 a;
      if constexpr (S::QSM) {
        const uint4* src = qsm + (warp * S::KS + kk) * 64 + lane;
        const uint4 hi = src[0], lo = src[32];
        a.hi[0] = hi.x, a.hi[1] = hi.y, a.hi[2] = hi.z, a.hi[3] = hi.w;
        a.lo[0] = lo.x, a.lo[1] = lo.y, a.lo[2] = lo.z, a.lo[3] = lo.w;
      } else {
        a = qf[kk];
      }
#pragma unroll
      for (int nf = 0; nf < S::KF; ++nf) {
        const uint4 kf = *reinterpret_cast<const uint4*>(
            ksp + (8 * nf + g) * S::KSR + 4 * (4 * kk + t));
        const uint32_t kh[2] = {kf.x, kf.y}, kl[2] = {kf.z, kf.w};
        mma3(s[nf], a.hi, a.lo, kh, kl);
      }
    }

    // + bh[i, j / Ws] + bw[i, j % Ws]; -inf past N
    if (row_tiles) {
      const int jr = j0 / Ws, c0 = j0 - jr * Ws;
      const float h0 = b0[Ws + jr], h1 = b1[Ws + jr];
#pragma unroll
      for (int nf = 0; nf < S::KF; ++nf) {
        const int c = c0 + 8 * nf + 2 * t;
        const float2 w0 = *reinterpret_cast<const float2*>(b0 + c);
        const float2 w1 = *reinterpret_cast<const float2*>(b1 + c);
        s[nf][0] = (s[nf][0] + h0) + w0.x;
        s[nf][1] = (s[nf][1] + h0) + w0.y;
        s[nf][2] = (s[nf][2] + h1) + w1.x;
        s[nf][3] = (s[nf][3] + h1) + w1.y;
      }
    } else {
#pragma unroll
      for (int nf = 0; nf < S::KF; ++nf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * nf + 2 * t + e;
          if (j < N) {
            // j / Ws by the reciprocal: j + 0.5 stays 0.5 / Ws from a
            // multiple of Ws, more than the product's error for j < 2^22
            const int jr = (int)(((float)j + 0.5f) * inv_ws);
            const int jc = j - jr * Ws;
            s[nf][e] = (s[nf][e] + b0[Ws + jr]) + b0[jc];
            s[nf][2 + e] = (s[nf][2 + e] + b1[Ws + jr]) + b1[jc];
          } else {
            s[nf][e] = s[nf][2 + e] = -INFINITY;
          }
        }
      }
    }

    // online softmax: every tile holds a real key, so the maxima are
    // finite
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nf = 0; nf < S::KF; ++nf) {
      mx0 = fmaxf(mx0, fmaxf(s[nf][0], s[nf][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nf][2], s[nf][3]));
    }
    const float n0 = fmaxf(m0, quad_max(mx0));
    const float n1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int nf = 0; nf < S::KF; ++nf) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nf][e] = expf(s[nf][e] - n0);
        s[nf][2 + e] = expf(s[nf][2 + e] - n1);
        p0 = p0 + s[nf][e];
        p1 = p1 + s[nf][2 + e];
      }
    }
    l0 = l0 * c0 + p0;
    l1 = l1 * c1 + p1;

    // o = o * c + p . v, the tile's p . v in fresh accumulators; keys
    // 8 kk + 2t and 8 kk + 2t + 1 are this lane's
    float pv[S::KS][4];
#pragma unroll
    for (int nf = 0; nf < S::KS; ++nf)
      pv[nf][0] = pv[nf][1] = pv[nf][2] = pv[nf][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < S::KF; ++kk) {
      const Frag4 pf(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* vrow = vsp + (4 * kk + t) * S::VSR + 4 * g;
#pragma unroll
      for (int nf = 0; nf < S::KS; ++nf) {
        const uint4 vf = *reinterpret_cast<const uint4*>(vrow + 32 * nf);
        const uint32_t vh[2] = {vf.x, vf.y}, vl[2] = {vf.z, vf.w};
        mma3(pv[nf], pf.hi, pf.lo, vh, vl);
      }
    }
#pragma unroll
    for (int nf = 0; nf < S::KS; ++nf) {
      o[nf][0] = o[nf][0] * c0 + pv[nf][0];
      o[nf][1] = o[nf][1] * c0 + pv[nf][1];
      o[nf][2] = o[nf][2] * c1 + pv[nf][2];
      o[nf][3] = o[nf][3] * c1 + pv[nf][3];
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const long long ost = (long long)heads * HD;
  float* o0 = out + ((long long)b * N + i0 + r0) * ost + (long long)h * HD +
              2 * t;
  float* o1 = o0 + 8 * ost;
#pragma unroll
  for (int nf = 0; nf < S::KS; ++nf) {
    if (ok0)
      *reinterpret_cast<float2*>(o0 + 8 * nf) =
          make_float2(o[nf][0] / l0, o[nf][1] / l0);
    if (ok1)
      *reinterpret_cast<float2*>(o1 + 8 * nf) =
          make_float2(o[nf][2] / l1, o[nf][3] / l1);
  }
}

template <int HD>
int launch(const float* qkv, const float* bh, const float* bw, int B, int N,
           int heads, int Hs, int Ws, float scale, float* out,
           cudaStream_t s) {
  static size_t allowed = 48 * 1024;  // dynamic shared memory set so far
  const size_t bytes = smem_bytes<HD>(Hs, Ws);
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        samattn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  dim3 grid((N + kRows - 1) / kRows, heads, B);
  samattn_kernel<HD><<<grid, kThreads, bytes, s>>>(qkv, bh, bw, N, heads, Hs,
                                                   Ws, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, N, 3, heads, hd) f32, 16-byte aligned; bh: (B, heads, N, Hs)
// and bw: (B, heads, N, Ws) f32 with N = Hs * Ws; out: (B, N, heads *
// hd) f32. hd is 64 (ViT-B) or 80 (ViT-L/H), N < 2^22. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another hd or N.
extern "C" int kb_sam_attention(const float* qkv, const float* bh,
                                const float* bw, int B, int N, int heads,
                                int hd, int Hs, int Ws, float scale,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (N >= (1 << 22) || Hs * Ws != N) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(qkv, bh, bw, B, N, heads, Hs, Ws, scale, out, s);
  if (hd == 80)
    return launch<80>(qkv, bh, bw, B, N, heads, Hs, Ws, scale, out, s);
  return (int)cudaErrorInvalidValue;
}
