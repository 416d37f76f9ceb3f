// K15b: SwinV2's scaled cosine window attention,
// softmax(cos(q, k) * scale[h] + bias[h] + mask[w]) . v.
//
// Replaces the core of cartoonsegmentation_tpu/models/swinv2.py:
// WindowAttentionV2 (:150-175): q and k L2-normalised (norm clamped at
// 1e-12), their dot products times the head's exp(min(logit_scale,
// log 100)), plus the head's 16 sigmoid(CPB) bias and, in shifted
// blocks, the window's 0 / -100 mask; softmax over the keys; the
// probabilities times v. The qkv and output projections stay dense
// layers outside the kernel, as in the JAX version.
//
// Bound on the card: f32 operations, ~4 N^2 hd a (window, head) for
// the two products (N = 64 tokens, hd = 32 at every stage of
// SwinV2-B): a 448^2 crop runs 24 launches of 0.5 to 0.8 GFLOP, ~10 us
// each at 67 TFLOP/s. The design is one block of 256 threads per
// (window, head) with the whole tile in shared memory: q, k and v (64
// x 32, rows padded to 33 floats), the 64 x 64 scores, f32 on the CUDA
// cores. Each row's norm is a sequential sum; 4 threads own a query
// row (16 keys each) and reduce its max and sum by shuffles; each
// thread then writes 8 outputs of its row, summing over the keys in
// order. The qkv projection (B, N, 3, heads, hd) is read in place and
// the output written as (B, N, heads hd), the transposes fused.
#include "kb_common.cuh"

namespace {

constexpr int kN = 64;    // tokens a window, at most
constexpr int kHD = 32;   // head width, at most
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    swinattn_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int N, int heads,
                    int hd, int nW, float* __restrict__ out) {
  __shared__ float qs[kN][kHD + 1];
  __shared__ float ks[kN][kHD + 1];
  __shared__ float vs[kN][kHD + 1];
  __shared__ float S[kN][kN + 1];
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x;
  const long long tok = 3LL * heads * hd;  // floats between tokens
  const float* base = qkv + (long long)b * N * tok + (long long)h * hd;
  const long long koff = (long long)heads * hd;
  for (int idx = t; idx < N * hd; idx += kThreads) {
    const int n = idx / hd, d = idx % hd;
    const float* row = base + n * tok + d;
    qs[n][d] = row[0];
    ks[n][d] = row[koff];
    vs[n][d] = row[2 * koff];
  }
  __syncthreads();
  // L2-normalise the q rows (threads 0..N-1) and k rows (64..64+N-1)
  if (t < 2 * kN && (t & (kN - 1)) < N) {
    float(*m)[kHD + 1] = t < kN ? qs : ks;
    const int n = t & (kN - 1);
    float ss = 0.0f;
    for (int d = 0; d < hd; ++d) ss = ss + m[n][d] * m[n][d];
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int d = 0; d < hd; ++d) m[n][d] = m[n][d] / nrm;
  }
  __syncthreads();
  const int i = t >> 2, part = t & 3;
  const float sc = scale[h];
  const float* brow = bias + ((long long)h * N + i) * N;
  const float* mrow =
      mask ? mask + ((long long)(b % nW) * N + i) * N : nullptr;
  float mx = -INFINITY;
  if (i < N) {
    for (int j = part; j < N; j += 4) {
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = dot + qs[i][d] * ks[j][d];
      float s = dot * sc + __ldg(brow + j);
      if (mrow) s = s + __ldg(mrow + j);
      S[i][j] = s;
      mx = fmaxf(mx, s);
    }
  }
  // the 4 threads of a row are consecutive lanes of one warp
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.0f;
  if (i < N) {
    for (int j = part; j < N; j += 4) {
      const float e = expf(S[i][j] - mx);
      S[i][j] = e;
      sum = sum + e;
    }
  }
  sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
  sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
  __syncthreads();
  if (i < N) {
    constexpr int kPer = kHD / 4;  // outputs a thread, at most
    const int per = (hd + 3) / 4;
    const int d0 = part * per;
    float acc[kPer];
#pragma unroll
    for (int dd = 0; dd < kPer; ++dd) acc[dd] = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float p = S[i][j] / sum;
#pragma unroll
      for (int dd = 0; dd < kPer; ++dd)
        if (dd < per && d0 + dd < hd)
          acc[dd] = acc[dd] + p * vs[j][d0 + dd];
    }
    float* o = out + ((long long)b * N + i) * heads * hd + (long long)h * hd;
#pragma unroll
    for (int dd = 0; dd < kPer; ++dd)
      if (dd < per && d0 + dd < hd) o[d0 + dd] = acc[dd];
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
  dim3 grid(heads, B);
  swinattn_kernel<<<grid, kThreads, 0, s>>>(qkv, scale, bias, mask, N, heads,
                                            hd, nW > 0 ? nW : 1, out);
  return (int)cudaGetLastError();
}
