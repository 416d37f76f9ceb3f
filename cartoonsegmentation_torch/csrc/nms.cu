// K8: class-agnostic greedy NMS over a fixed candidate set, K <= 512.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:nms_fixed (the
// lax.scan over the score-ordered list that stands in for mmcv's
// batched_nms in the RTMDet-Ins postprocess: the top 512 candidates,
// IoU 0.6, up to 100 kept). boxes (K, 4) xyxy f32, scores (K,) f32.
// The semantics, the score key, the IoU test, a tile's keep and the
// output are csrc/nms_common.cuh's, shared with K14b
// (csrc/nms_large.cu).
//
// Bound on the card: latency. One launch of one block of 1,024 threads,
// everything in shared memory:
//   1. the sort as a rank: two threads a candidate count the score keys
//      below its own (ties by index) in the two halves of the keys,
//      four keys a 16-byte load, and the first scatters its box, area,
//      score and index to that row;
//   2. the walk, a 64-row tile a step, two barriers a step. All 32
//      warps first decide, for each row j of the tile, the suppression
//      bits the walk reads and no others: whether a kept row of an
//      earlier tile suppresses j (16 threads a row, each a share of the
//      kept list, stopping at the first hit), and, for a row still a
//      candidate, which rows of the tile before j suppress it (16
//      threads a row, 4 columns each); then warp 0 decides the tile's
//      rows as a fixed point (kb_nms_tile_keep) and appends the kept
//      rows' boxes to the kept list. The walk stops once it has found
//      n_out kept rows scored above -1;
//   3. the block writes the output without a second sort
//      (kb_nms_write).
#include "nms_common.cuh"

namespace {

constexpr int kMaxK = 512;
constexpr int kThreads = 1024;
constexpr int kTiles = kMaxK / kNmsTile;
constexpr int kRowThreads = kThreads / kNmsTile;  // 16 threads a row

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ boxes,
               const float* __restrict__ scores, int K, float iou_thr,
               int n_out, long long* __restrict__ keep_idx,
               uint8_t* __restrict__ keep_mask) {
  __shared__ __align__(16) unsigned int key[kMaxK];
  __shared__ int upper[kMaxK];  // the keys below i in the upper half
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ float sscore[kMaxK];
  __shared__ int order[kMaxK];
  // the kept rows so far, in row order: their boxes and areas
  __shared__ float4 kbox[kMaxK];
  __shared__ float karea[kMaxK];
  // the tile's rows: removed by an earlier kept row, their suppressors
  __shared__ unsigned long long removed;
  __shared__ unsigned long long sup[kNmsTile];
  __shared__ unsigned long long keptw[kTiles];
  __shared__ unsigned long long g1m[kTiles];
  __shared__ int g1w[kTiles + 1];
  __shared__ int n_kept, stop;
  __shared__ unsigned int warp_sum[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. order = stable argsort(-scores) as ranks
  float4 mybox = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float myscore = 0.0f;
  if (t < K) {
    mybox = make_float4(boxes[4 * t], boxes[4 * t + 1], boxes[4 * t + 2],
                        boxes[4 * t + 3]);
    myscore = scores[t];
    key[t] = kb_sort_key(-myscore);
  } else if (t < ((K + 3) & ~3)) {
    key[t] = ~0u;  // pads the last 16-byte chunk; never below a key
  }
  if (t == 0) {
    removed = 0ull;
    n_kept = 0;
    stop = 0;
    g1w[0] = 0;
  }
  __syncthreads();
  const int i = t & (kMaxK - 1), part = t / kMaxK;
  int below = 0;
  if (i < K) {
    // the keys before i: <=; after i: <. Part 0 counts the chunks
    // [0, nq / 2), part 1 the rest
    const unsigned int mine = key[i];
    const uint4* k4 = reinterpret_cast<const uint4*>(key);
    const int nq = (K + 3) >> 2, iq = i >> 2;
    const int q0 = part ? nq / 2 : 0, q1 = part ? nq : nq / 2;
#pragma unroll 4
    for (int q = q0; q < min(q1, iq); ++q) {
      const uint4 v = k4[q];
      below += (v.x <= mine) + (v.y <= mine) + (v.z <= mine) + (v.w <= mine);
    }
    if (iq >= q0 && iq < q1)
      for (int j = 4 * iq; j < 4 * iq + 4; ++j)
        below += j < i ? key[j] <= mine : j > i && key[j] < mine;
#pragma unroll 4
    for (int q = max(q0, iq + 1); q < q1; ++q) {
      const uint4 v = k4[q];
      below += (v.x < mine) + (v.y < mine) + (v.z < mine) + (v.w < mine);
    }
    if (part) upper[i] = below;
  }
  __syncthreads();
  if (t < K) {
    below += upper[t];
    sbox[below] = mybox;
    sarea[below] = kb_box_area(mybox);
    sscore[below] = myscore;
    order[below] = t;
  }
  __syncthreads();

  // 2. the walk
  const KbIouThr thr = kb_iou_thr(iou_thr);
  const int tiles = (K + kNmsTile - 1) / kNmsTile;
  const int row = t / kRowThreads, sub = t % kRowThreads;
  int walked = tiles, g1 = 0;
  for (int r = 0; r < tiles; ++r) {
    const int j = r * kNmsTile + row;
    const float4 bj = j < K ? sbox[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float aj = j < K ? sarea[j] : 0.0f;
    // removed by a kept row of an earlier tile?
    bool hit = false;
    if (j < K) {
      const int nk = n_kept;
      for (int k = sub; k < nk && !hit; k += kRowThreads)
        hit = kb_iou_above(kbox[k], karea[k], bj, aj, thr);
    }
    // the 16 threads of a row are 16 consecutive lanes of one warp
    const unsigned int group = 0xffffu << (lane & 16);
    const bool gone = (__ballot_sync(kNmsFull, hit) & group) != 0u;
    // the rows of the tile before j that suppress it (this thread's 4
    // columns), for a row still a candidate
    unsigned long long bits = 0ull;
    if (j < K && !gone) {
      const int c0 = sub * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = r * kNmsTile + c0 + c;
        if (c0 + c < row && kb_iou_above(sbox[ii], sarea[ii], bj, aj, thr))
          bits |= 1ull << (c0 + c);
      }
    }
#pragma unroll
    for (int d = 1; d < kRowThreads; d <<= 1)
      bits |= __shfl_xor_sync(kNmsFull, bits, d);
    if (sub == 0) {
      sup[row] = bits;
      if (gone) atomicOr(&removed, 1ull << row);
    }
    __syncthreads();
    if (warp == 0) {
      const int n = min(kNmsTile, K - r * kNmsTile);
      const unsigned long long cand =
          ~removed & (n == kNmsTile ? ~0ull : (1ull << n) - 1);
      const unsigned long long kept =
          kb_nms_tile_keep(cand, sup[lane] & cand, sup[32 + lane] & cand,
                           lane);
      const int ra = r * kNmsTile + lane, rb = ra + 32;
      const unsigned long long lt = kb_nms_g1_rows(
          ra < K ? sscore[ra] : 0.0f, rb < K ? sscore[rb] : 0.0f);
      // the kept rows onto the kept list, in row order
      const int base = n_kept;
      if ((kept >> lane) & 1ull) {
        const int q = base + __popcll(kept & ((1ull << lane) - 1));
        kbox[q] = sbox[ra];
        karea[q] = sarea[ra];
      }
      if ((kept >> (32 + lane)) & 1ull) {
        const int q = base + __popcll(kept & ((1ull << (32 + lane)) - 1));
        kbox[q] = sbox[rb];
        karea[q] = sarea[rb];
      }
      g1 += __popcll(kept & lt);
      __syncwarp();
      if (lane == 0) {
        keptw[r] = kept;
        g1m[r] = kept & lt;
        g1w[r + 1] = g1;
        n_kept = base + __popcll(kept);
        removed = 0ull;
        if (g1 >= n_out) stop = 1;
      }
    }
    __syncthreads();
    if (stop) {
      walked = r + 1;
      break;
    }
  }

  // 3. the output
  kb_nms_write<kThreads>(keptw, g1m, g1w, walked, order, sscore, K, n_out,
                         keep_idx, keep_mask, warp_sum);
}

}  // namespace

// boxes (K, 4), scores (K,) f32 with 1 <= K <= 512; keep_idx (n_out,)
// int64, keep_mask (n_out,) u8, 1 <= n_out <= K. Returns
// cudaGetLastError().
extern "C" int kb_nms(const float* boxes, const float* scores, int K,
                      float iou_thr, int n_out, long long* keep_idx,
                      uint8_t* keep_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || n_out < 1 || n_out > K)
    return (int)cudaErrorInvalidValue;
  nms_kernel<<<1, kThreads, 0, s>>>(boxes, scores, K, iou_thr, n_out,
                                    keep_idx, keep_mask);
  return (int)cudaGetLastError();
}
