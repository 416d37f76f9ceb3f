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
// leaves the card.
//
// One launch, a single-pass compaction with a decoupled look-back:
// - a block takes the next tile of 2,048 entries from a counter (so a
//   tile's predecessors belong to blocks already running) and reads
//   the tile's mask into shared memory in 16-byte words (bytes for a
//   ragged last tile or an unaligned mask);
// - a dense tile (every entry set: the all-set append; colors in rows
//   of 3) copies its payload, one run, into shared memory with 16-byte
//   cp.async; any other tile ranks its set entries with warp ballots
//   in index order and stages their 8 payload floats at their ranks
//   (strided loads of the set entries only: the inpainting appends set
//   ~3%);
// - a block publishes its count at once (tile 0 its inclusive prefix,
//   which starts from the device-side count clamped to P), and warp 0
//   looks back over the tiles before it, 128 a step, for the nearest
//   inclusive prefix, adding the counts between;
// - the tile's set entries land in consecutive slots, so the block
//   writes points, colors (P, 3), disparity and depth as four
//   coalesced runs, cut at P; the last tile writes min(count + set, P).
// Integer ranks, so the slots, their order and the count equal the
// plain version's exactly, overflow included.
//
// No memset: the scratch (state.py:_compact_scratch, one per card,
// zero when made) holds two slots of tile counter and status words,
// and a word saying which slot the next call takes. A call uses one
// slot; its last tile (by index, which the counter hands out last, so
// every block has read the slot word by then) zeroes the other slot's
// words, which the call before used and no block of this call reads,
// and hands the next call that slot. So a call always starts on a slot
// that is zero, with no ticket or fence at its end; a graph that
// captures the call replays it the same way.
#include "kb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;
// staged payload: points and colors 3 floats an entry, disparity and
// depth one
constexpr int kSmemBytes = 8 * kTile * (int)sizeof(float);

// a tile's status word: the flag in the top two bits, the value below
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// warp 0: the sum of the set entries of tiles 0..tile-1, plus the
// device-side start count (tile 0's inclusive prefix holds it). A step
// reads the status of the kLook tiles before `end` (lane l the tiles
// end - l - 32 j), waits until each has published, and adds the
// counts down to the nearest inclusive prefix.
constexpr int kLook = 4;

__device__ long long look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (int end = tile - 1;; end -= 32 * kLook) {
    // a tile before tile 0 reads as a zero count (tile 0, always
    // inclusive, lies in the same step); status words 2 apart
    unsigned long long s[kLook];
    bool wait;
    do {
      wait = false;
#pragma unroll
      for (int j = 0; j < kLook; ++j) {
        const int t = end - lane - 32 * j;
        s[j] = t >= 0 ? load_status(status + 2 * t) : kAggregate;
        wait |= (s[j] >> 62) == 0;
      }
    } while (__any_sync(0xffffffffu, wait));
    // the nearest inclusive prefix: distance 32 j + lane
    int stop = 32 * kLook;
#pragma unroll
    for (int j = kLook - 1; j >= 0; --j) {
      const unsigned incl = __ballot_sync(0xffffffffu, (s[j] >> 62) == 2);
      if (incl) stop = 32 * j + __ffs(incl) - 1;
    }
    long long v = 0;
#pragma unroll
    for (int j = 0; j < kLook; ++j)
      if (32 * j + lane <= stop) v += (long long)(s[j] & kValue);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (stop < 32 * kLook) return before;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}

// scratch words (64-bit): the slot in use, each slot's tile counter,
// the tiles each slot's last call used, then the status of tile t in
// slot s at kStatus + 2 t + s
constexpr int kParity = 0, kCounter = 1, kUsed = 3, kStatus = 5;

__global__ void __launch_bounds__(kThreads, 3)
    compact_kernel(const float* __restrict__ points,
                   const float* __restrict__ colors,
                   const float* __restrict__ disparity,
                   const float* __restrict__ depth,
                   const uint8_t* __restrict__ mask, int M, int col_se,
                   int col_sc, bool vec, int n_tiles, int P,
                   float* __restrict__ dst_points,
                   float* __restrict__ dst_colors,
                   float* __restrict__ dst_disparity,
                   float* __restrict__ dst_depth, int* count,
                   unsigned long long* scratch) {
  extern __shared__ __align__(16) float stage[];
  float* s_pts = stage;
  float* s_col = stage + 3 * kTile;
  float* s_disp = stage + 6 * kTile;
  float* s_depth = stage + 7 * kTile;
  __shared__ __align__(16) uint8_t s_mask[kTile];
  __shared__ int s_before[kRounds * kWarps];
  __shared__ int s_tile, s_total, s_slot;
  __shared__ long long s_off;
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;

  // the slot, then a tile from its counter (the counter's address
  // depends on the slot read, so the read comes first)
  if (threadIdx.x == 0) {
    const int slot =
        (int)*reinterpret_cast<volatile unsigned long long*>(scratch);
    s_slot = slot;
    s_tile = (int)atomicAdd(scratch + kCounter + slot, 1ull);
  }
  __syncthreads();
  const int tile = s_tile, slot = s_slot;
  unsigned long long* status = scratch + kStatus + slot;   // stride 2
  const long long base = (long long)tile * kTile;
  const int n = (int)min((long long)kTile, (long long)M - base);
  // the mask into shared memory; a tile whose entries are all set is
  // dense
  bool ones = true;
  if (vec && n == kTile) {
    if (threadIdx.x < kTile / 16) {
      const uint4 m =
          __ldcs(reinterpret_cast<const uint4*>(mask + base) + threadIdx.x);
      reinterpret_cast<uint4*>(s_mask)[threadIdx.x] = m;
      ones = m.x == 0x01010101u && m.y == 0x01010101u &&
             m.z == 0x01010101u && m.w == 0x01010101u;
    }
  } else {
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const uint8_t b = e < n ? mask[base + e] : 0;
      s_mask[e] = b;
      ones &= b != 0;
    }
  }
  const bool dense = __syncthreads_and(ones) && vec;

  int total = kTile;
  bool set[kRounds];
  int below[kRounds];
  if (dense) {
    // the tile's payload is one run: copied whole into shared memory
    // (16-byte chunks: points, colors, then disparity, depth)
    const float* src[4] = {points + 3 * base, colors + 3 * base,
                           disparity + base, depth + base};
    float* dst[4] = {s_pts, s_col, s_disp, s_depth};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int a = j < 6 ? 0 : j < 12 ? 1 : j < 14 ? 2 : 3;
      const int first = a == 0 ? 0 : a == 1 ? 6 : a == 2 ? 12 : 14;
      const int c = (j - first) * kThreads + threadIdx.x;
      cp_async16(dst[a] + 4 * c, src[a] + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    // entry e = r * kThreads + threadIdx.x: a warp's 32 entries of a
    // round are consecutive, ranked by ballot; the (round, warp)
    // counts in index order scanned by warp 0
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      set[r] = s_mask[r * kThreads + threadIdx.x] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, set[r]);
      below[r] = __popc(bal & ((1u << lane) - 1u));
      if (lane == 0) s_before[r * kWarps + w] = __popc(bal);
    }
    __syncthreads();
    if (w == 0) {
      const int a = s_before[2 * lane], b = s_before[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      s_before[2 * lane] = incl - a - b;
      s_before[2 * lane + 1] = incl - b;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    total = s_total;
  }
  if (threadIdx.x == 0) {
    if (tile == 0) {
      const long long start = min((long long)count[0], (long long)P);
      atomicExch(status, kInclusive | (unsigned long long)(start + total));
      s_off = start;
    } else {
      atomicExch(status + 2 * tile,
                 kAggregate | (unsigned long long)total);
    }
  }
  if (!dense) {
    // the set entries' payload into shared memory at their ranks
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (!set[r]) continue;
      const int k = s_before[r * kWarps + w] + below[r];
      const long long i = base + r * kThreads + threadIdx.x;
      s_pts[3 * k] = points[3 * i];
      s_pts[3 * k + 1] = points[3 * i + 1];
      s_pts[3 * k + 2] = points[3 * i + 2];
      const float* c = colors + i * col_se;
      s_col[3 * k] = c[0];
      s_col[3 * k + 1] = c[col_sc];
      s_col[3 * k + 2] = c[2 * col_sc];
      s_disp[k] = disparity[i];
      s_depth[k] = depth[i];
    }
  }
  if (w == 0 && tile > 0) {
    const long long off = look_back(status, tile);
    if (lane == 0) {
      atomicExch(status + 2 * tile,
                 kInclusive | (unsigned long long)(off + total));
      s_off = off;
    }
  }
  if (dense) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the tile's run of slots off .. off + total, cut at P
  const long long off = s_off;
  const int n_out = (int)max(0LL, min((long long)total, (long long)P - off));
  float* dp = dst_points + 3 * off;
  float* dc = dst_colors + 3 * off;
  for (int j = threadIdx.x; j < 3 * n_out; j += kThreads) {
    dp[j] = s_pts[j];
    dc[j] = s_col[j];
  }
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    dst_disparity[off + j] = s_disp[j];
    dst_depth[off + j] = s_depth[j];
  }
  if (tile != n_tiles - 1) return;
  // the last tile: the count; the other slot, which the call before
  // used and no block of this call reads, zeroed; the slots swapped
  const int other = 1 - slot;
  const int used = (int)scratch[kUsed + other];
  for (int t = threadIdx.x; t < used; t += kThreads)
    scratch[kStatus + 2 * t + other] = 0;
  if (threadIdx.x == 0) {
    count[0] = (int)min(off + total, (long long)P);
    scratch[kCounter + other] = 0;
    scratch[kUsed + slot] = (unsigned long long)n_tiles;
    scratch[kParity] = (unsigned long long)other;
  }
}

}  // namespace

// Source: points (M, 3), disparity, depth (M,) f32, mask (M,) u8,
// contiguous; colors (M, 3) f32 at any strides (col_se an entry,
// col_sc a channel: the inpaint net's image is channel-planar).
// Destination, updated in place: the cloud's points, colors (P, 3),
// disparity, depth (P,) and its int32 count. scratch: 5 + 2 ceil(M /
// 2048) 64-bit words, zero before a card's first call
// (state.py:_compact_scratch). Returns the launch's error.
extern "C" int kb_append_masked(const float* points, const float* colors,
                                const float* disparity, const float* depth,
                                const uint8_t* mask, int M, int col_se,
                                int col_sc, float* dst_points,
                                float* dst_colors,
                                float* dst_disparity, float* dst_depth,
                                int P, int* count, void* scratch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return (int)cudaGetLastError();
  // the staged payload takes more than the default 48 KB a block:
  // raised once a device
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(compact_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const int n_tiles = (M + kTile - 1) / kTile;
  // 16-byte words of the mask, 16-byte chunks of a dense tile's run
  // (colors in rows of 3 too)
  const uintptr_t any = reinterpret_cast<uintptr_t>(mask) |
                        reinterpret_cast<uintptr_t>(points) |
                        reinterpret_cast<uintptr_t>(colors) |
                        reinterpret_cast<uintptr_t>(disparity) |
                        reinterpret_cast<uintptr_t>(depth);
  const bool vec = (any & 15) == 0 && col_se == 3 && col_sc == 1;
  compact_kernel<<<n_tiles, kThreads, kSmemBytes, s>>>(
      points, colors, disparity, depth, mask, M, col_se, col_sc, vec,
      n_tiles, P, dst_points, dst_colors, dst_disparity, dst_depth, count,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
