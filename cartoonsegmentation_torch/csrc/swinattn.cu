// K15b: SwinV2's scaled cosine window attention,
// softmax(cos(q, k) * scale[h] + bias[h] + mask[w]) . v.
//
// Replaces the core of cartoonsegmentation_tpu/models/swinv2.py:
// WindowAttentionV2 (:150-176): q and k L2-normalised (norm clamped at
// 1e-12), their dot products times the head's exp(min(logit_scale,
// log 100)), plus the head's 16 sigmoid(CPB) bias and, in shifted
// blocks, the window's 0 / -100 mask; softmax over the keys; the
// probabilities times v. The qkv and output projections stay dense
// layers outside the kernel, as in the JAX version.
//
// Bound on the card: bytes. A (window, head) of SwinV2-B (N = 64
// tokens, hd = 32) reads 24 KB of q, k, v and writes 8 KB for 0.54
// MFLOP of products, 1.6 M in 3xTF32 at 495 TFLOP/s: a 448^2 crop's
// 24 launches are 1.4 to 8.6 us of HBM traffic each, so the design
// aims at bytes in flight and few serial phases, not at operations.
//
// Precision: the JAX version runs in f32 and the port holds the kernel
// to 1e-5 of the output's range. At a logit scale of 100 single-pass
// TF32 misses that by far (3e-3 of the range in the CPU emulation of
// this schedule, tests/test_torch_attn_tf32.py); three passes
// (mma_tf32.cuh) meet it at ~4e-6. The hi·hi pass and the two small
// ones sum in accumulators of their own: the tensor cores truncate as
// they accumulate, and in one accumulator the two small passes add
// two truncations a step at the scale of the whole sum (on the H100,
// chip_smoke's worst stage: 6e-6 of the range in one, 3.4e-6 in two).
//
// Design: a block of 4 warps takes one (window, head); each warp owns
// 16 query rows against all 64 keys, 32 score floats a lane in the mma
// accumulator layout. One window a block puts the most blocks in
// flight at the small stages (stage 3: 128 windows x heads), whose time
// is the serial phases' latency; the head's bias is re-read from L2 by
// each window rather than shared. The
// head's 64 x 64 bias and the window's q, k and v come into shared
// memory in one pass of cp.async (16 bytes a copy when hd, N and the
// pointers allow, else 4), zero-filled past N and hd; the shift mask's
// rows start on their way to L2 meanwhile and are read from there.
// Each row's norm is a pair of lanes' partial sums joined by a shuffle;
// scale / |q| is folded into q and 1 / |k| into k in shared memory (a
// multiply by the reciprocal, not a divide: within the 1e-5 gate, see
// the emulation). q . k^T is 4 k-steps of 3xTF32 mma, p . v 8; the
// whole 64-key row is in registers, so the softmax is exact, its max
// and sum reduced over the 4 lanes of a row, one reciprocal a row;
// padded keys get -inf. No score goes to shared memory. Rows are
// padded (q, k to 40 floats, v to 36, bias to 72) so that the fragment
// reads are free of bank conflicts.
#include "kb_common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace kbmma;

constexpr int kN = 64;    // tokens a window, at most
constexpr int kHD = 32;   // head width, at most
constexpr int kThreads = 128;
constexpr int QST = kHD + 8;  // floats a q or k row in shared memory
constexpr int VST = kHD + 4;  // floats a v row
constexpr int BST = kN + 8;   // floats a bias row

// VEC: 16-byte copies (hd and N multiples of 4, 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    swinattn_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int N, int heads,
                    int hd, int nW, float* __restrict__ out) {
  __shared__ __align__(16) float bs[kN * BST];
  __shared__ __align__(16) float qs[kN * QST];
  __shared__ __align__(16) float ks[kN * QST];
  __shared__ __align__(16) float vs[kN * VST];
  const int b = blockIdx.x, h = blockIdx.y, tw = threadIdx.x;
  const long long tok = 3LL * heads * hd;  // floats between tokens
  const float* base = qkv + (long long)b * N * tok + (long long)h * hd;
  const float* hbias = bias + (long long)h * N * N;

  // 1. the head's bias and the window's q, k, v
  if constexpr (VEC) {
    constexpr int CH = kN / 4;
    for (int idx = tw; idx < kN * CH; idx += kThreads) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = r < N && 4 * c < N;
      cp_async16(bs + r * BST + 4 * c, ok ? hbias + r * N + 4 * c : hbias,
                 ok);
    }
    constexpr int HC = kHD / 4;
    for (int idx = tw; idx < 3 * kN * HC; idx += kThreads) {
      const int m = idx / (kN * HC), r = (idx / HC) % kN, c = idx % HC;
      const bool ok = r < N && 4 * c < hd;
      float* dst = (m == 0 ? qs : m == 1 ? ks : vs) +
                   r * (m == 2 ? VST : QST) + 4 * c;
      cp_async16(dst, ok ? base + r * tok + m * heads * hd + 4 * c : base,
                 ok);
    }
  } else {
    for (int idx = tw; idx < kN * kN; idx += kThreads) {
      const int r = idx / kN, c = idx % kN;
      const bool ok = r < N && c < N;
      cp_async4(bs + r * BST + c, ok ? hbias + r * N + c : hbias, ok);
    }
    for (int idx = tw; idx < 3 * kN * kHD; idx += kThreads) {
      const int m = idx / (kN * kHD), r = (idx / kHD) % kN, c = idx % kHD;
      const bool ok = r < N && c < hd;
      float* dst = (m == 0 ? qs : m == 1 ? ks : vs) +
                   r * (m == 2 ? VST : QST) + c;
      cp_async4(dst, ok ? base + r * tok + m * heads * hd + c : base, ok);
    }
  }
  cp_async_commit();
  // the shift mask is read after the products: its rows (two 128-byte
  // lines each at N = 64) start on their way to L2 now
  if (mask && (tw >> 1) < N)
    prefetch_l2(mask + ((long long)(b % nW) * N + (tw >> 1)) * N +
                32 * (tw & 1));
  cp_async_wait<0>();
  __syncthreads();

  // 2. norms: two lanes a row (16 dims each), q rows then k rows; q
  // takes scale / max(|q|, 1e-12), k 1 / max(|k|, 1e-12)
  const float sc = __ldg(scale + h);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* row = (m == 0 ? qs : ks) + (tw >> 1) * QST + 16 * (tw & 1);
    float4 x[4];
    float ss = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      x[p] = reinterpret_cast<const float4*>(row)[p];
      ss = ss + x[p].x * x[p].x + x[p].y * x[p].y + x[p].z * x[p].z +
           x[p].w * x[p].w;
    }
    ss = ss + __shfl_xor_sync(0xffffffffu, ss, 1);
    const float f = (m == 0 ? sc : 1.0f) / fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      reinterpret_cast<float4*>(row)[p] =
          make_float4(x[p].x * f, x[p].y * f, x[p].z * f, x[p].w * f);
  }
  __syncthreads();

  // 3. s = q^ . k^T for rows r0 = 16 wi + g and r0 + 8
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wi + g;
  // (hi·hi in s, the small passes in s_lo)
  float s[8][4], s_lo[8][4];
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
    for (int e = 0; e < 4; ++e) s[nf][e] = s_lo[nf][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    const float2 x0 =
        *reinterpret_cast<const float2*>(qs + r0 * QST + 8 * kk + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(
        qs + (r0 + 8) * QST + 8 * kk + 2 * t);
    const Frag4 qf(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const float2 kv = *reinterpret_cast<const float2*>(
          ks + (8 * nf + g) * QST + 8 * kk + 2 * t);
      mma3(s[nf], s_lo[nf], qf, Frag2(kv.x, kv.y));
    }
  }
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
    for (int e = 0; e < 4; ++e) s[nf][e] = s[nf][e] + s_lo[nf][e];

  // 4. + bias (+ mask), -inf past N; exact softmax over the 64 keys
  const bool ok0 = r0 < N, ok1 = r0 + 8 < N;
  const float* m0 = mask && ok0
                        ? mask + ((long long)(b % nW) * N + r0) * N : nullptr;
  const float* m1 = mask && ok1
                        ? mask + ((long long)(b % nW) * N + r0 + 8) * N
                        : nullptr;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * nf + 2 * t + e;
      if (j < N) {
        s[nf][e] = s[nf][e] + bs[r0 * BST + j];
        s[nf][2 + e] = s[nf][2 + e] + bs[(r0 + 8) * BST + j];
        if (m0) s[nf][e] = s[nf][e] + __ldg(m0 + j);
        if (m1) s[nf][2 + e] = s[nf][2 + e] + __ldg(m1 + j);
      } else {
        s[nf][e] = s[nf][2 + e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, s[nf][e]);
      mx1 = fmaxf(mx1, s[nf][2 + e]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nf][e] = expf(s[nf][e] - mx0);
      s[nf][2 + e] = expf(s[nf][2 + e] - mx1);
      l0 = l0 + s[nf][e];
      l1 = l1 + s[nf][2 + e];
    }
  }
  const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);

  // 5. o = p . v over the 64 keys (keys 8 kk + 2t, + 1 this lane's)
  float o[kHD / 8][4], o_lo[kHD / 8][4];
#pragma unroll
  for (int nf = 0; nf < kHD / 8; ++nf)
    for (int e = 0; e < 4; ++e) o[nf][e] = o_lo[nf][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const Frag4 pf(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
    const float* v0 = vs + (8 * kk + 2 * t) * VST + g;
#pragma unroll
    for (int nf = 0; nf < kHD / 8; ++nf)
      mma3(o[nf], o_lo[nf], pf, Frag2(v0[8 * nf], v0[VST + 8 * nf]));
  }
#pragma unroll
  for (int nf = 0; nf < kHD / 8; ++nf)
    for (int e = 0; e < 4; ++e) o[nf][e] = o[nf][e] + o_lo[nf][e];

  // 6. out (B, N, heads hd): row r, dims 8 nf + 2t, + 1
  const long long ost = (long long)heads * hd;
  float* o0 = out + ((long long)b * N + r0) * ost + (long long)h * hd;
  float* o1 = o0 + 8 * ost;
#pragma unroll
  for (int nf = 0; nf < kHD / 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * nf + 2 * t + e;
      if (d < hd) {
        if (ok0) o0[d] = o[nf][e] * inv0;
        if (ok1) o1[d] = o[nf][2 + e] * inv1;
      }
    }
  }
}

}  // namespace

// qkv: (B, N, 3, heads, hd) f32; scale: (heads,) f32; bias: (heads, N,
// N) f32; mask: (nW, N, N) f32 or null, window b % nW for row b of
// the batch; out: (B, N, heads * hd) f32. N <= 64, hd <= 32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a larger N or hd.
extern "C" int kb_swin_attention(const float* qkv, const float* scale,
                                 const float* bias, const float* mask, int B,
                                 int N, int heads, int hd, int nW, float* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (N > kN || hd > kHD || hd <= 0 || (mask && nW <= 0))
    return (int)cudaErrorInvalidValue;
  const bool vec = hd % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(qkv) |
                    reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  const dim3 grid(B, heads);
  nW = nW > 0 ? nW : 1;
  if (vec)
    swinattn_kernel<true><<<grid, kThreads, 0, s>>>(qkv, scale, bias, mask,
                                                    N, heads, hd, nW, out);
  else
    swinattn_kernel<false><<<grid, kThreads, 0, s>>>(qkv, scale, bias, mask,
                                                     N, heads, hd, nW, out);
  return (int)cudaGetLastError();
}
