// K6: per-instance lower median of round(values) over each mask.
//
// Replaces cartoonsegmentation_tpu/pipeline/depth.py:masked_median_u8,
// the focal-plane median of the colorized (uint8-quantised) depth over
// each detected instance (kenburns_effect.py:1045-1059 in the
// reference).
//
// values (H*W) f32, masks (N, H*W) bool, valid (N,) bool. out[n] = the
// lower median of the bins clamp(rint(values), 0, 255) over mask n, or
// -inf for an invalid or empty instance. A NaN value counts in bin 0
// (fmaxf(NaN, 0) is 0), as JAX's float-to-int conversion on the CPU
// puts it and as the plain version does.
//
// Bound on the card: the bytes of the valid masks (one byte a pixel)
// and the values. One launch, no memset: a grid of (pixel tile,
// instance). A block of an invalid slot reads no mask byte (its tile
// 0 writes -inf). The others read their tile of 16,384 mask bytes in
// 16-byte words, 4 a thread loaded at once; a zero word reads no
// value, a set byte reads its value (a 16-byte load for each group of
// 4 pixels with one set) and counts its bin. A thread counts a run of
// one bin in a register, and the warp adds its threads' last runs by
// bin (__match_any_sync, __reduce_add_sync): an instance's depth is
// smooth, so a warp makes a few shared atomics, not one a pixel. The
// block adds its 256 bins into the instance's histogram;
// the last block to finish the instance (an atomic ticket) takes the
// lower median with a warp scan and leaves the histogram and the
// ticket zero for the next call. The scratch (N x 256 bins, then N
// tickets) is zero on entry: the wrapper keeps one zeroed buffer a
// card (pipeline/depth.py:_median_scratch). Integer counts, so the
// result equals the plain version bit for bit.
#include "kb_common.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;   // one bin a thread when a block adds up
constexpr int kLoads = 4;       // 16-byte mask words a thread
constexpr int kTile = kThreads * kLoads * 16;   // pixels a block

__device__ __forceinline__ int bin_of(float v) {
  return (int)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// adds one pixel of bin b to the thread's run (bin, cnt), handing a
// finished run to the block's histogram
__device__ __forceinline__ void add_pixel(int* sh, int b, int& bin,
                                          int& cnt) {
  if (b == bin) {
    ++cnt;
    return;
  }
  if (cnt) atomicAdd(&sh[bin], cnt);
  bin = b;
  cnt = 1;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    insmedian_kernel(const float* __restrict__ values,
                     const uint8_t* __restrict__ masks,
                     const uint8_t* __restrict__ valid, int HW,
                     int* __restrict__ hist, int* __restrict__ ticket,
                     float* __restrict__ out) {
  const int n = blockIdx.y;
  if (!valid[n]) {  // the whole block: no mask byte is read
    if (blockIdx.x == 0 && threadIdx.x == 0) out[n] = -INFINITY;
    return;
  }
  __shared__ int sh[kBins];
  __shared__ bool last;
  sh[threadIdx.x] = 0;
  __syncthreads();
  const uint8_t* m = masks + (long long)n * HW;
  const long long base = (long long)blockIdx.x * kTile;
  int bin = 0, cnt = 0;
  if (kVec) {  // HW % 16 == 0: a word lies wholly inside or outside
    uint4 w[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long p =
          base + (long long)(k * kThreads + threadIdx.x) * 16;
      w[k] = p < HW ? __ldcs(reinterpret_cast<const uint4*>(m + p))
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if ((w[k].x | w[k].y | w[k].z | w[k].w) == 0) continue;
      const long long p =
          base + (long long)(k * kThreads + threadIdx.x) * 16;
      const unsigned q[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q[j] == 0) continue;
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(values + p + 4 * j));
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((q[j] >> (8 * e)) & 0xffu)
            add_pixel(sh, bin_of(f[e]), bin, cnt);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long p0 =
          base + (long long)(k * kThreads + threadIdx.x) * 16;
      for (int e = 0; e < 16; ++e) {
        const long long p = p0 + e;
        if (p < HW && m[p]) add_pixel(sh, bin_of(values[p]), bin, cnt);
      }
    }
  }
  // the warp's last runs, added by bin (a thread with none keyed -1)
  const unsigned peers = __match_any_sync(0xffffffffu, cnt ? bin : -1);
  const int sum = __reduce_add_sync(peers, cnt);
  if (cnt && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&sh[bin], sum);
  __syncthreads();
  const int c = sh[threadIdx.x];
  if (c) atomicAdd(&hist[n * kBins + threadIdx.x], c);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ticket[n], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  // warp 0 of the last block: the lower median of the 256 bins, each
  // bin read from L2 and left zero
  const int lane = threadIdx.x;
  int* h = hist + n * kBins;
  int local[8];
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    local[k] = __ldcg(h + lane * 8 + k);
    h[lane * 8 + k] = 0;
    s += local[k];
  }
  int incl = s;  // inclusive warp scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int rank = (total - 1) / 2 + 1;  // lower median, 1-based
  // the median bin = the number of bins whose running count < rank
  int cum = incl - s, below = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cum += local[k];
    below += cum < rank;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, o);
  if (lane == 0) {
    out[n] = total > 0 ? (float)below : -INFINITY;
    ticket[n] = 0;
  }
}

}  // namespace

// values (HW,) f32, masks (N, HW) u8, valid (N,) u8; hist (N * 256 + N)
// int scratch, zero on entry and left zero (the bins, then the
// tickets); out (N,) f32. Returns cudaGetLastError().
extern "C" int kb_masked_median(const float* values, const uint8_t* masks,
                                const uint8_t* valid, int N, int HW,
                                int* hist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
  dim3 grid(HW > 0 ? (HW + kTile - 1) / kTile : 1, N);
  int* ticket = hist + (long long)N * kBins;
  if (HW % 16 == 0 && (reinterpret_cast<uintptr_t>(masks) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(values) & 15) == 0)
    insmedian_kernel<true><<<grid, kThreads, 0, s>>>(values, masks, valid,
                                                     HW, hist, ticket, out);
  else
    insmedian_kernel<false><<<grid, kThreads, 0, s>>>(values, masks, valid,
                                                      HW, hist, ticket, out);
  return (int)cudaGetLastError();
}
