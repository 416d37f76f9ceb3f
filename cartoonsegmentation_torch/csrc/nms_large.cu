// K14b: class-agnostic greedy NMS over a large fixed candidate set.
//
// Replaces cartoonsegmentation_tpu/models/maskrcnn.py:batched_nms_fixed
// (its call of models/rtmdet.py:nms_fixed, the lax.scan over the
// score-ordered list) at Mask R-CNN's sizes: the RPN's K = 4,756
// per-level tops (IoU 0.7, 1000 out) and the detection's K = 2,048
// candidates (IoU 0.5, 100 out). The category offsets are added in
// torch before the call. The semantics, the score key (jnp.argsort's
// canonicalised float order), the IoU test, a tile's keep as a fixed
// point and the output are csrc/nms_common.cuh's, shared with K8
// (csrc/nms.cu, which stops at K = 512).
//
// Bound on the card: latency. The IoUs (11.3 M pairs at K = 4,756,
// ~0.002 ms of f32 work) spread over many blocks; the greedy walk is a
// chain of dependent steps. Three kernels on the stream, no dynamic
// shared memory (so no per-call attribute):
//   1. rank_kernel: the sort as a rank. key(i) = kb_sort_key(-score) <<
//      32 | i is unique, and i's place in `order` is the number of keys
//      below its own. A block counts it for 32 candidates (a lane each)
//      against all K score keys, staged in shared memory 8,192 at a
//      time (all loads issued first), each of its 32 warps taking a
//      share of the tile, ties going by index; then it
//      scatters `order`, the sorted boxes and the sorted scores. The
//      grid (K / 32 blocks) spreads the K^2 comparisons over the card.
//   2. mask_kernel: a grid of 64 x 64 tiles of the upper triangle
//      writes the suppression bitmask, one 64-bit word per (row, column
//      tile), one thread per row; IoU > thr is decided exactly without
//      the division (15 us less at the RPN's K than with it). A diagonal
//      tile holds the whole block, rows before the row's own included:
//      the IoU is symmetric bit for bit (the same f32 operations on the
//      two boxes, the area sum commutative), so row i's word there is
//      both the rows it suppresses (bits above i) and the rows that
//      suppress it (bits below i), and the walk needs no transpose.
//   3. walk_kernel: one block, one __syncthreads a 64-row tile. Warp 0
//      decides tile r's rows all at once, in rounds of four ballots: a
//      row not yet decided is removed once a kept row suppresses it,
//      kept once every candidate that could suppress it is decided and
//      none is kept (the greedy order as a fixed point; the rounds
//      number the tile's longest chain of rows waiting on one another:
//      kb_nms_tile_keep). It holds a lane's two rows' diagonal and
//      next-column words in registers, loaded a tile ahead, and forms
//      the next tile's `removed` word itself (a warp reduce of the kept
//      rows' words in that column). In the same step the other 15
//      warps OR tile r - 1's kept rows into the words from r + 1 on (a
//      thread a word and a share of the rows, its loads issued first,
//      one atomic a half word). The walk stops once it has found n_out
//      kept rows scored above -1; then the block writes the output rows
//      without a second sort (kb_nms_write; why both are exact:
//      nms_common.cuh).
#include "nms_common.cuh"

namespace {

constexpr int kMaxK = 16384;
constexpr int kTile = kNmsTile;
constexpr int kMaxWords = kMaxK / kTile;
constexpr int kRankThreads = 1024;
constexpr int kRankTile = 8192;
constexpr int kWalkThreads = 512;
constexpr unsigned kFull = kNmsFull;

// 1. order = stable argsort(-scores) as ranks; the sorted boxes, scores.
// key(j) < key(i) when kb_sort_key(-score) is lower, or equal with j < i
__global__ void __launch_bounds__(kRankThreads)
    rank_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores, int K,
                int* __restrict__ order, float4* __restrict__ sboxes,
                float* __restrict__ sscores) {
  constexpr int kWarps = kRankThreads / 32;
  constexpr int kLoads = kRankTile / kRankThreads;
  __shared__ unsigned int keys[kRankTile];
  __shared__ int part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const unsigned int mine = i < K ? kb_sort_key(-scores[i]) : ~0u;
  int below = 0;
  for (int t0 = 0; t0 < K; t0 += kRankTile) {
    const int n = min(kRankTile, K - t0);
    unsigned int v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = q * kRankThreads + threadIdx.x;
      v[q] = j < n ? kb_sort_key(-scores[t0 + j]) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = q * kRankThreads + threadIdx.x;
      if (j < n) keys[j] = v[q];
    }
    __syncthreads();
    const int per = (n + kWarps - 1) / kWarps;
    const int j0 = min(n, warp * per), j1 = min(n, j0 + per);
    // the keys before i: <=; from i on: <
    const int split = min(j1, max(j0, i - t0));
#pragma unroll 4
    for (int j = j0; j < split; ++j) below += keys[j] <= mine;
#pragma unroll 4
    for (int j = split; j < j1; ++j) below += keys[j] < mine;
  }
  part[warp][lane] = below;
  __syncthreads();
  if (warp == 0 && i < K) {
    int r = 0;
    for (int w = 0; w < kWarps; ++w) r += part[w][lane];
    order[r] = i;
    sboxes[r] = boxes[i];
    sscores[r] = scores[i];
  }
}

// 2. word (i, c): bit b set when j = 64c + b != i and IoU(i, j) > thr;
// only the tiles with c >= i / 64 are written (and read)
__global__ void __launch_bounds__(kTile)
    mask_kernel(const float4* __restrict__ sboxes, int K, int words,
                float iou_thr, unsigned long long* __restrict__ mask) {
  const int r = blockIdx.y, c = blockIdx.x;
  if (c < r) return;
  __shared__ float4 cb[kTile];
  __shared__ float ca[kTile];
  const int t = threadIdx.x;
  const int jc = c * kTile + t;
  if (jc < K) {
    const float4 o = sboxes[jc];
    cb[t] = o;
    ca[t] = kb_box_area(o);
  }
  __syncthreads();
  const int i = r * kTile + t;
  if (i >= K) return;
  const float4 a = sboxes[i];
  const float area_a = kb_box_area(a);
  const int b1 = min(kTile, K - c * kTile);
  const KbIouThr thr = kb_iou_thr(iou_thr);
  unsigned long long bits = 0;
  for (int b = 0; b < b1; ++b)
    if (kb_iou_above(a, area_a, cb[b], ca[b], thr)) bits |= 1ull << b;
  if (c == r) bits &= ~(1ull << t);  // a row does not suppress itself
  mask[(long long)i * words + c] = bits;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  return ((unsigned long long)__reduce_or_sync(kFull, (unsigned)(v >> 32))
          << 32) |
         __reduce_or_sync(kFull, (unsigned)v);
}

// a lane's two rows of tile r (lane and 32 + lane): their words in the
// diagonal tile and the next column, and their scores
struct Rows {
  unsigned long long da, db, na, nb;
  float sa, sb;
};

__device__ __forceinline__ Rows load_rows(
    const unsigned long long* __restrict__ mask,
    const float* __restrict__ sscores, int K, int words, int r, int lane) {
  Rows o = {0ull, 0ull, 0ull, 0ull, 0.0f, 0.0f};
  const int ra = r * kTile + lane, rb = ra + 32;
  if (ra < K) {
    o.da = mask[(long long)ra * words + r];
    if (r + 1 < words) o.na = mask[(long long)ra * words + r + 1];
    o.sa = sscores[ra];
  }
  if (rb < K) {
    o.db = mask[(long long)rb * words + r];
    if (r + 1 < words) o.nb = mask[(long long)rb * words + r + 1];
    o.sb = sscores[rb];
  }
  return o;
}

// 3. the greedy walk and the output
__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const unsigned long long* __restrict__ mask,
                const int* __restrict__ order,
                const float* __restrict__ sscores, int K, int words,
                int n_out, long long* __restrict__ keep_idx,
                uint8_t* __restrict__ keep_mask) {
  // removed[w]: the rows of tile w removed by kept rows two or more
  // tiles before it (the pushers' ORs); keptw[r]: tile r's kept rows,
  // g1m[r] those of them in G1, g1w[r] the G1 rows before tile r;
  // kept_rows[r & 1]: tile r's kept rows' offsets, for the pushers
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long keptw[kMaxWords];
  __shared__ unsigned long long g1m[kMaxWords];
  __shared__ int g1w[kMaxWords + 1];
  __shared__ unsigned char kept_rows[2][kTile];
  __shared__ int stop;
  __shared__ unsigned int warp_sum[kWalkThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0ull;
  if (t == 0) {
    g1w[0] = 0;
    stop = 0;
  }
  __syncthreads();
  const unsigned long long below_a = (1ull << lane) - 1;
  const unsigned long long below_b = (1ull << (32 + lane)) - 1;

  // warp 0: tile r's rows, and the kept rows' words in column r + 1
  Rows cur = {0ull, 0ull, 0ull, 0ull, 0.0f, 0.0f};
  if (warp == 0) cur = load_rows(mask, sscores, K, words, 0, lane);
  unsigned long long carry = 0ull;
  int g1 = 0, walked = words;
  for (int r = 0; r < words; ++r) {
    if (warp == 0) {
      // the next tile's loads, first used a step later
      const Rows nxt = r + 1 < words
                           ? load_rows(mask, sscores, K, words, r + 1, lane)
                           : cur;
      const int n = min(kTile, K - r * kTile);
      const unsigned long long cand = ~(removed[r] | carry) &
                                      (n == kTile ? ~0ull : (1ull << n) - 1);
      // the greedy order as a fixed point, all 64 rows at once
      const unsigned long long kept = kb_nms_tile_keep(
          cand, cur.da & below_a & cand, cur.db & below_b & cand, lane);
      const bool kpa = (kept >> lane) & 1ull;
      const bool kpb = (kept >> (32 + lane)) & 1ull;
      carry = warp_or((kpa ? cur.na : 0ull) | (kpb ? cur.nb : 0ull));
      const unsigned long long lt = kb_nms_g1_rows(cur.sa, cur.sb);
      // the kept rows' list for the pushers
      unsigned char* list = kept_rows[r & 1];
      if (kpa) list[__popcll(kept & below_a)] = (unsigned char)lane;
      if (kpb)
        list[__popcll(kept & below_b)] = (unsigned char)(32 + lane);
      g1 += __popcll(kept & lt);
      if (lane == 0) {
        keptw[r] = kept;
        g1m[r] = kept & lt;
        g1w[r + 1] = g1;
        if (g1 >= n_out) stop = 1;
      }
      cur = nxt;
    } else if (r > 0) {
      // the pushers: tile r - 1's kept rows into removed[r + 1 ..]. A
      // thread takes one word (consecutive threads on consecutive words
      // of a row: coalesced) and every groups-th kept row, its loads
      // issued before the ORs, then one 32-bit atomic a half word
      const int h = t - 32, nh = kWalkThreads - 32;
      const int w0 = r + 1, later = words - w0;
      const int nk = __popcll(keptw[r - 1]);
      const int groups = later > 0 ? max(1, nh / later) : 0;
      const int g = later > 0 ? h / later : 0;
      if (g < groups && g < nk) {
        const int w = w0 + (h - g * later);
        const unsigned char* list = kept_rows[(r - 1) & 1];
        const unsigned long long* m =
            mask + (long long)(r - 1) * kTile * words + w;
        unsigned long long acc = 0ull;
        int k = g;
        for (; k + 3 * groups < nk; k += 4 * groups) {
          const unsigned long long x0 = m[(long long)list[k] * words];
          const unsigned long long x1 =
              m[(long long)list[k + groups] * words];
          const unsigned long long x2 =
              m[(long long)list[k + 2 * groups] * words];
          const unsigned long long x3 =
              m[(long long)list[k + 3 * groups] * words];
          acc |= x0 | x1 | x2 | x3;
        }
        for (; k < nk; k += groups) acc |= m[(long long)list[k] * words];
        unsigned int* half = reinterpret_cast<unsigned int*>(&removed[w]);
        if ((unsigned int)acc) atomicOr(half, (unsigned int)acc);
        if ((unsigned int)(acc >> 32))
          atomicOr(half + 1, (unsigned int)(acc >> 32));
      }
    }
    __syncthreads();
    if (stop) {
      walked = r + 1;
      break;
    }
  }
  kb_nms_write<kWalkThreads>(keptw, g1m, g1w, walked, order, sscores, K,
                             n_out, keep_idx, keep_mask, warp_sum);
}

}  // namespace

// boxes (K, 4) f32 (16-byte aligned), scores (K,) f32 with 1 <= K <=
// 16384; keep_idx (n_out,) int64, keep_mask (n_out,) u8, 1 <= n_out <=
// K; work: nms_large_workspace(K) bytes, 16-byte aligned, laid out as
// the sorted boxes (K float4), the mask (K * ceil(K/64) 64-bit words),
// order (K int32) and the sorted scores (K f32). Returns
// cudaGetLastError().
extern "C" int kb_nms_large(const float* boxes, const float* scores, int K,
                            float iou_thr, int n_out, long long* keep_idx,
                            uint8_t* keep_mask, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || n_out < 1 || n_out > K)
    return (int)cudaErrorInvalidValue;
  const int words = (K + kTile - 1) / kTile;
  float4* sboxes = static_cast<float4*>(work);
  unsigned long long* mask = reinterpret_cast<unsigned long long*>(
      sboxes + K);
  int* order = reinterpret_cast<int*>(mask + (long long)K * words);
  float* sscores = reinterpret_cast<float*>(order + K);
  rank_kernel<<<(K + 31) / 32, kRankThreads, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), scores, K, order, sboxes,
      sscores);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mask_kernel<<<dim3(words, words), kTile, 0, s>>>(sboxes, K, words,
                                                    iou_thr, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<1, kWalkThreads, 0, s>>>(mask, order, sscores, K, words,
                                         n_out, keep_idx, keep_mask);
  return (int)cudaGetLastError();
}
