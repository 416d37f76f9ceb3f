// K6: per-instance lower median of round(values) over each mask.
//
// Replaces cartoonsegmentation_tpu/pipeline/depth.py:masked_median_u8,
// the focal-plane median of the colorized (uint8-quantised) depth over
// each detected instance (kenburns_effect.py:1045-1059 in the
// reference).
//
// values (H*W) f32 in [0, 255], masks (N, H*W) bool, valid (N,) bool.
// out[n] = the lower median of clamp(rint(values), 0, 255) over mask n,
// or -inf for an invalid or empty instance.
//
// Bound on the card: the bytes of the valid masks (one byte a pixel)
// and the values they re-read from L2. Launch 1 is a grid over (pixel
// tile, instance): a block of an invalid slot returns before it reads
// its mask; the others count their tile into a 256-bin shared-memory
// histogram with shared atomics and add it into a global (N, 256) int
// histogram. Launch 2 is one warp per instance: a warp prefix sum over
// the 256 bins finds the rank floor((cnt-1)/2)+1. Integer counts, so
// the result equals the plain version bit for bit.
#include "kb_common.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;   // one histogram bin a thread
constexpr int kPerThread = 16;  // pixels a thread counts
constexpr int kTile = kThreads * kPerThread;

__global__ void hist_kernel(const float* __restrict__ values,
                            const uint8_t* __restrict__ masks,
                            const uint8_t* __restrict__ valid, int HW,
                            int* __restrict__ hist) {
  const int n = blockIdx.y;
  if (!valid[n]) return;  // the whole block: no mask byte is read
  __shared__ int sh[kBins];
  sh[threadIdx.x] = 0;
  __syncthreads();
  const uint8_t* m = masks + (long long)n * HW;
  const int base = blockIdx.x * kTile;
#pragma unroll 4
  for (int k = 0; k < kPerThread; ++k) {
    const int p = base + k * kThreads + threadIdx.x;
    if (p < HW && m[p]) {
      const float q = fminf(fmaxf(rintf(values[p]), 0.0f), 255.0f);
      atomicAdd(&sh[(int)q], 1);
    }
  }
  __syncthreads();
  const int c = sh[threadIdx.x];
  if (c) atomicAdd(&hist[n * kBins + threadIdx.x], c);
}

__global__ void median_kernel(const int* __restrict__ hist,
                              const uint8_t* __restrict__ valid, int N,
                              float* __restrict__ out) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  if (!valid[n]) {
    if (lane == 0) out[n] = -INFINITY;
    return;
  }
  const int* h = hist + n * kBins;
  int local[8];
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    local[k] = h[lane * 8 + k];
    s += local[k];
  }
  int incl = s;  // inclusive warp scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int cnt = __shfl_sync(0xffffffffu, incl, 31);
  const int rank = (cnt - 1) / 2 + 1;  // lower median, 1-based
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
  if (lane == 0) out[n] = cnt > 0 ? (float)below : -INFINITY;
}

}  // namespace

// values (HW,) f32, masks (N, HW) u8, valid (N,) u8; hist (N, 256) int
// scratch; out (N,) f32. Returns cudaGetLastError().
extern "C" int kb_masked_median(const float* values, const uint8_t* masks,
                                const uint8_t* valid, int N, int HW,
                                int* hist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(hist, 0, sizeof(int) * kBins * (size_t)N, s);
  if (HW > 0) {
    dim3 grid((HW + kTile - 1) / kTile, N);
    hist_kernel<<<grid, kThreads, 0, s>>>(values, masks, valid, HW, hist);
  }
  median_kernel<<<(N + 7) / 8, 256, 0, s>>>(hist, valid, N, out);
  return (int)cudaGetLastError();
}
