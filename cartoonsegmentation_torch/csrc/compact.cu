// K10: stable masked stream compaction into the fixed-capacity cloud.
//
// Replaces cartoonsegmentation_tpu/pipeline/state.py:
// PointCloud.append_masked, which scatters every entry whose mask is
// set to slot count + (its rank among the set entries), drops the
// slots past the capacity P and clamps count to P.
//
// Bound on the card: bytes. Each of the M entries reads one mask byte
// and, where set, its 8 payload floats, and writes them once (M =
// 589,824 at 576x1024: ~20 MB each way). The plain version's boolean
// index syncs the host for the number of set entries; this one never
// leaves the card. Three launches on the caller's stream:
//   1. count: the set entries of each 1024-entry tile;
//   2. scan: one block turns the tile counts into tile offsets that
//      start at the device-side count (clamped to P), and writes the
//      new count min(count + total, P);
//   3. scatter: each tile re-reads its mask, ranks its set entries
//      with warp ballots in index order, and writes each entry whose
//      slot is below P.
// Integer ranks, so the slots, their order and the count equal the
// plain version's exactly, overflow included.
#include "kb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[w] = v;
  __syncthreads();
  int total = 0;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) total += warp_sums[k];
  return total;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask, int M,
                             int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const int base = blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    if (i < M && mask[i]) ++c;
  }
  const int total = block_sum(c, warp_sums);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block of kScanThreads: an exclusive scan of the tile counts in
// chunks of kScanThreads, carried from chunk to chunk.
__global__ void scan_kernel(const int* __restrict__ tile_counts, int n_tiles,
                            int P, int* count, int* __restrict__ offsets) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ long long carry_s;
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const long long start = count[0];
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n_tiles; c0 += kScanThreads) {
    const int t = c0 + threadIdx.x;
    const int v = t < n_tiles ? tile_counts[t] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < kScanThreads / 32; ++k) {
      if (k < w) before += warp_sums[k];
      total += warp_sums[k];
    }
    const long long off = start + carry_s + before + incl - v;
    if (t < n_tiles) offsets[t] = (int)(off < P ? off : P);
    __syncthreads();
    if (threadIdx.x == 0) carry_s += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long n = start + carry_s;
    count[0] = (int)(n < P ? n : P);
  }
}

__global__ void scatter_kernel(const float* __restrict__ points,
                               const float* __restrict__ colors,
                               const float* __restrict__ disparity,
                               const float* __restrict__ depth,
                               const uint8_t* __restrict__ mask, int M,
                               const int* __restrict__ offsets, int P,
                               float* __restrict__ dst_points,
                               float* __restrict__ dst_colors,
                               float* __restrict__ dst_disparity,
                               float* __restrict__ dst_depth) {
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int base = blockIdx.x * kTile;
  long long running = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const bool set = i < M && mask[i];
    const unsigned bal = __ballot_sync(0xffffffffu, set);
    if (lane == 0) warp_cnt[w] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < w) before += warp_cnt[k];
      total += warp_cnt[k];
    }
    if (set) {
      const long long pos =
          running + before + __popc(bal & ((1u << lane) - 1u));
      if (pos < P) {
        const long long s = 3LL * i, d = 3LL * pos;
        dst_points[d] = points[s];
        dst_points[d + 1] = points[s + 1];
        dst_points[d + 2] = points[s + 2];
        dst_colors[d] = colors[s];
        dst_colors[d + 1] = colors[s + 1];
        dst_colors[d + 2] = colors[s + 2];
        dst_disparity[pos] = disparity[i];
        dst_depth[pos] = depth[i];
      }
    }
    running += total;
    __syncthreads();  // warp_cnt is rewritten by the next round
  }
}

}  // namespace

// Source: points, colors (M, 3), disparity, depth (M,) f32, mask (M,)
// u8. Destination, updated in place: the cloud's points, colors (P, 3),
// disparity, depth (P,) and its int32 count. scratch: 2 * ceil(M /
// 1024) ints. Returns cudaGetLastError().
extern "C" int kb_append_masked(const float* points, const float* colors,
                                const float* disparity, const float* depth,
                                const uint8_t* mask, int M,
                                float* dst_points, float* dst_colors,
                                float* dst_disparity, float* dst_depth,
                                int P, int* count, int* scratch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return (int)cudaGetLastError();
  const int n_tiles = (M + kTile - 1) / kTile;
  int* tile_counts = scratch;
  int* offsets = scratch + n_tiles;
  count_kernel<<<n_tiles, kThreads, 0, s>>>(mask, M, tile_counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_counts, n_tiles, P, count,
                                         offsets);
  scatter_kernel<<<n_tiles, kThreads, 0, s>>>(
      points, colors, disparity, depth, mask, M, offsets, P, dst_points,
      dst_colors, dst_disparity, dst_depth);
  return (int)cudaGetLastError();
}
