// The parts of the greedy NMS that K8 (csrc/nms.cu) and K14b
// (csrc/nms_large.cu) share, so that the two kernels cannot drift
// apart: the score key, the IoU test, a 64-row tile's greedy keep as a
// fixed point of ballots, and the output written without a second
// sort.
//
// Semantics of rtmdet.nms_fixed (the JAX lax.scan), exactly:
//   order = stable argsort(-scores)
//   box i of that order is kept when no kept box before it has
//   IoU > iou_thr with it; boxes j <= i are never suppressed by i
//   top  = stable argsort(-where(kept, score, -1))[:max_out]
//   keep_idx = order[top], keep_mask = kept[top] & (kept score > -1)
// IoU = inter / max(area_a + area_b - inter, 1e-9), in that order.
// Both argsorts compare jnp.argsort's way: floats canonicalised (-0 →
// +0, every NaN → +NaN), then in their total order, ties by index.
//
// Why a walk may stop early, and the output needs no second sort.
// Let e = kb_sort_key(-(-1.0f)), the key of a row that is not kept.
// The output is top = stable argsort(key2)[:n_out], key2(p) =
// kb_sort_key(-(kept(p) ? score(p) : -1.0f)). A kept row's key2 is its
// key from the first sort, and the first sort put the rows in that key
// order with ties by index, so the kept rows already stand in key2
// order. Every row not kept has key2 = e. So top is three groups, each
// in row order:
//   G1 the kept rows with key2 < e: scores above -1 (NaN never: its
//      canonical key is the largest),
//   G2 the rows with key2 = e: not kept, or kept with score exactly -1,
//   G3 the kept rows with key2 > e: scores below -1, -inf, and every
//      NaN,
// truncated to n_out. G1 grows only as the walk advances and comes
// first, so once a walk has found n_out rows of G1 the output is those
// rows and no later row can enter it: the walk stops there. Otherwise
// it runs to the end and one block scan over the K rows places G2 and
// G3 after G1 (kb_nms_write).
#pragma once

#include "kb_common.cuh"

constexpr int kNmsTile = 64;
constexpr unsigned kNmsFull = 0xffffffffu;

// jnp.argsort's key of a float as an unsigned int: -0 → +0 and every
// NaN → +NaN (lax's canonicalisation), then increasing in the float
// total order
__device__ __forceinline__ unsigned int kb_sort_key(float f) {
  unsigned int u = __float_as_uint(f);
  if (f == 0.0f) u = 0u;
  if (isnan(f)) u = 0x7fc00000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the key of a row not kept: kb_sort_key(-(-1.0f))
__device__ __forceinline__ unsigned int kb_nms_e() {
  return kb_sort_key(1.0f);
}

__device__ __forceinline__ float kb_box_area(float4 a) {
  return fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
}

// IoU(a, o) > thr, decided as RN(inter / den) > thr without the
// division: inter > m * den in float64, m the midpoint of thr and the
// next float up (both exact: m has 25 significant bits, den 24); at m
// itself round-to-nearest-even decides. Non-finite values take the
// division. The same f32 operations on the two boxes in either order
// (fmin, fmax and the area sum commute), so the test is symmetric bit
// for bit.
struct KbIouThr {
  float thr;
  double mid;
  bool tie_up;
};

__device__ __forceinline__ KbIouThr kb_iou_thr(float thr) {
  const float up = nextafterf(thr, INFINITY);
  KbIouThr t;
  t.thr = thr;
  t.mid = 0.5 * ((double)thr + (double)up);
  t.tie_up = (__float_as_uint(up) & 1u) == 0;
  return t;
}

__device__ __forceinline__ bool kb_iou_above(float4 a, float area_a,
                                             float4 o, float area_o,
                                             const KbIouThr& t) {
  const float iw = fmaxf(fminf(a.z, o.z) - fmaxf(a.x, o.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, o.w) - fmaxf(a.y, o.y), 0.0f);
  const float inter = iw * ih;
  const float den = fmaxf(area_a + area_o - inter, 1e-9f);
  const double p = t.mid * (double)den;
  return isfinite(inter) && isfinite(den)
             ? (double)inter > p || ((double)inter == p && t.tie_up)
             : inter / den > t.thr;
}

// The greedy keep of one 64-row tile as a fixed point, in one warp:
// lane l holds rows l (a) and 32 + l (b); cand has a bit for each row
// not removed by a kept row of an earlier tile, pa and pb the rows of
// the tile before a and b that suppress them (IoU > thr), already
// masked by cand. An undecided row is removed once a kept row
// suppresses it, kept once every candidate that could suppress it is
// decided and none is kept. The lowest undecided row is decided in
// every round, so the rounds number the longest chain of rows that
// wait on one another, not the kept rows; each round is four ballots.
// Returns the tile's kept rows.
__device__ __forceinline__ unsigned long long kb_nms_tile_keep(
    unsigned long long cand, unsigned long long pa, unsigned long long pb,
    int lane) {
  unsigned long long kept = 0ull, undecided = cand;
  while (undecided) {
    const bool oa = (undecided >> lane) & 1ull;
    const bool ob = (undecided >> (32 + lane)) & 1ull;
    const bool ka = oa && !(pa & (kept | undecided));
    const bool kb = ob && !(pb & (kept | undecided));
    const bool ra = oa && (pa & kept), rb = ob && (pb & kept);
    const unsigned long long nk =
        (unsigned long long)__ballot_sync(kNmsFull, ka) |
        ((unsigned long long)__ballot_sync(kNmsFull, kb) << 32);
    const unsigned long long nr =
        (unsigned long long)__ballot_sync(kNmsFull, ra) |
        ((unsigned long long)__ballot_sync(kNmsFull, rb) << 32);
    kept |= nk;
    undecided &= ~(nk | nr);
  }
  return kept;
}

// The rows of the 64 in a tile (lane's a and b rows) scored in G1 if
// kept: key below e
__device__ __forceinline__ unsigned long long kb_nms_g1_rows(float sa,
                                                             float sb) {
  const unsigned int e = kb_nms_e();
  return (unsigned long long)__ballot_sync(kNmsFull, kb_sort_key(-sa) < e) |
         ((unsigned long long)__ballot_sync(kNmsFull, kb_sort_key(-sb) < e)
          << 32);
}

// The output, by the whole block of kThreads threads, after a walk over
// `walked` tiles: keptw[r] the kept rows of tile r, g1m[r] those in G1,
// g1w[r] the G1 rows before tile r (g1w[walked] all of them); order and
// sscores in sorted row order (global or shared memory). warp_sum:
// kThreads / 32 words of shared memory. K <= 65535.
template <int kThreads>
__device__ void kb_nms_write(const unsigned long long* keptw,
                             const unsigned long long* g1m, const int* g1w,
                             int walked, const int* order,
                             const float* sscores, int K, int n_out,
                             long long* __restrict__ keep_idx,
                             uint8_t* __restrict__ keep_mask,
                             unsigned int* warp_sum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // G1: the kept rows keyed below -1's key, in row order
  for (int p = t; p < walked * kNmsTile; p += kThreads) {
    const unsigned long long g = g1m[p >> 6];
    const int j = p & 63;
    if (!((g >> j) & 1ull)) continue;
    const int q = g1w[p >> 6] + __popcll(g & ((1ull << j) - 1));
    if (q < n_out) {
      keep_idx[q] = (long long)order[p];
      keep_mask[q] = sscores[p] > -1.0f;
    }
  }
  const int g1n = g1w[walked];
  if (g1n >= n_out) return;

  // the walk ran to the end: G2 and G3 after G1, each in row order. A
  // thread takes `per` consecutive rows; one block scan of its counts
  // (G2 in the low 16 bits, G3 in the high 16)
  const unsigned int e = kb_nms_e();
  const int per = (K + kThreads - 1) / kThreads;
  const int p0 = min(K, t * per), p1 = min(K, p0 + per);
  unsigned int cnt = 0;
  for (int p = p0; p < p1; ++p) {
    const bool kp = (keptw[p >> 6] >> (p & 63)) & 1ull;
    const unsigned int k1 = kb_sort_key(-sscores[p]);
    cnt += (!kp || k1 == e) ? 1u : (k1 > e ? 65536u : 0u);
  }
  unsigned int inc = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int o = __shfl_up_sync(kNmsFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned int s = lane < kThreads / 32 ? warp_sum[lane] : 0u;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int o = __shfl_up_sync(kNmsFull, s, d);
      if (lane >= d) s += o;
    }
    if (lane < kThreads / 32) warp_sum[lane] = s;  // inclusive
  }
  __syncthreads();
  const unsigned int before = inc - cnt + (warp ? warp_sum[warp - 1] : 0u);
  const int n2 = (int)(warp_sum[kThreads / 32 - 1] & 0xffffu);
  int q2 = g1n + (int)(before & 0xffffu);
  int q3 = g1n + n2 + (int)(before >> 16);
  for (int p = p0; p < p1; ++p) {
    const bool kp = (keptw[p >> 6] >> (p & 63)) & 1ull;
    const float s = sscores[p];
    const unsigned int k1 = kb_sort_key(-s);
    int q;
    if (!kp || k1 == e)
      q = q2++;
    else if (k1 > e)
      q = q3++;
    else
      continue;  // G1, written above
    if (q < n_out) {
      keep_idx[q] = (long long)order[p];
      keep_mask[q] = kp && s > -1.0f;
    }
  }
}
