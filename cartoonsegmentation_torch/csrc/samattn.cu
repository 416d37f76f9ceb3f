// K15a: SAM's encoder attention with decomposed relative positions,
// softmax((q * hd^-0.5) . k^T + bh[.., key_row] + bw[.., key_col]) . v.
//
// Replaces the core of cartoonsegmentation_tpu/models/sam.py:
// SamAttention (:91-107), which materialises the (N, N) score matrix
// of every head: 14x14 windows (N = 196, 25 of them at 1024^2) in 8
// blocks and the whole 64x64 grid (N = 4096) in the 4 global ones.
//
// Bound on the card: f32 operations, 4 n N^2 hd a call (the two
// products; 0.77 ms at N = 4096 with 12 heads at 67 TFLOP/s). The
// design is the simple flash-attention loop, without tensor cores:
// one block of 64 threads per (window, head, tile of 64 queries), one
// thread per query holding its scaled q row and its f32 output
// accumulator in registers. K and V are staged through shared memory
// 32 keys at a time, read in place from the qkv projection (B, N, 3,
// heads, hd) with float4 loads; every thread reads the same key row,
// so shared memory broadcasts it. Each tile's scores get the
// rel-pos terms bh[query, key / W] + bw[query, key % W] (computed
// beforehand from the unscaled q, as the JAX version does) and feed
// an online softmax in f32. The N x N matrix never exists: at N = 4096
// it would be 805 MB per block.
#include "kb_common.cuh"

namespace {

constexpr int kQueries = 64;  // queries (threads) a block
constexpr int kKeys = 32;     // keys a shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kQueries)
    samattn_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ bh,
                   const float* __restrict__ bw, int N, int heads, int Hs,
                   int Ws, float scale, float* __restrict__ out) {
  constexpr int V4 = HD / 4;  // float4s a head row
  __shared__ float4 ks[kKeys * V4];
  __shared__ float4 vs[kKeys * V4];
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kQueries + threadIdx.x;
  const bool active = i < N;
  const long long tok = 3LL * heads * HD;  // floats between tokens
  const float* base = qkv + (long long)b * N * tok + (long long)h * HD;
  const long long koff = (long long)heads * HD, voff = 2 * koff;

  float q[HD], acc[HD];
  const float* bh_row = bh + (((long long)b * heads + h) * N + i) * Hs;
  const float* bw_row = bw + (((long long)b * heads + h) * N + i) * Ws;
  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = base[i * tok + d] * scale;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < N; k0 += kKeys) {
    for (int idx = threadIdx.x; idx < kKeys * V4; idx += kQueries) {
      const int j = k0 + idx / V4, part = idx % V4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < N) {
        const float* row = base + j * tok + 4 * part;
        kv = *reinterpret_cast<const float4*>(row + koff);
        vv = *reinterpret_cast<const float4*>(row + voff);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();
    if (active) {
      float s[kKeys];
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int j = k0 + jj;
        float dot = 0.0f;
#pragma unroll
        for (int p = 0; p < V4; ++p) {
          const float4 k4 = ks[jj * V4 + p];
          dot = __fmaf_rn(q[4 * p], k4.x, dot);
          dot = __fmaf_rn(q[4 * p + 1], k4.y, dot);
          dot = __fmaf_rn(q[4 * p + 2], k4.z, dot);
          dot = __fmaf_rn(q[4 * p + 3], k4.w, dot);
        }
        s[jj] = j < N ? (dot + __ldg(bh_row + j / Ws)) + __ldg(bw_row + j % Ws)
                      : -INFINITY;
        tmax = fmaxf(tmax, s[jj]);
      }
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m, tmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int p4 = 0; p4 < V4; ++p4) {
          const float4 v4 = vs[jj * V4 + p4];
          acc[4 * p4] = __fmaf_rn(p, v4.x, acc[4 * p4]);
          acc[4 * p4 + 1] = __fmaf_rn(p, v4.y, acc[4 * p4 + 1]);
          acc[4 * p4 + 2] = __fmaf_rn(p, v4.z, acc[4 * p4 + 2]);
          acc[4 * p4 + 3] = __fmaf_rn(p, v4.w, acc[4 * p4 + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (active) {
    float* o = out + ((long long)b * N + i) * heads * HD + (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d] / l;
  }
}

template <int HD>
int launch(const float* qkv, const float* bh, const float* bw, int B, int N,
           int heads, int Hs, int Ws, float scale, float* out,
           cudaStream_t s) {
  dim3 grid((N + kQueries - 1) / kQueries, heads, B);
  samattn_kernel<HD><<<grid, kQueries, 0, s>>>(qkv, bh, bw, N, heads, Hs, Ws,
                                               scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, N, 3, heads, hd) f32, 16-byte aligned; bh: (B, heads, N, Hs)
// and bw: (B, heads, N, Ws) f32 with N = Hs * Ws; out: (B, N, heads *
// hd) f32. hd is 64 (ViT-B) or 80 (ViT-L/H). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another hd.
extern "C" int kb_sam_attention(const float* qkv, const float* bh,
                                const float* bw, int B, int N, int heads,
                                int hd, int Hs, int Ws, float scale,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (hd == 64)
    return launch<64>(qkv, bh, bw, B, N, heads, Hs, Ws, scale, out, s);
  if (hd == 80)
    return launch<80>(qkv, bh, bw, B, N, heads, Hs, Ws, scale, out, s);
  return (int)cudaErrorInvalidValue;
}
