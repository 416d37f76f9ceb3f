// K11: exact disocclusion fill, a 16-direction ray march of at most K
// steps each way.
//
// Replaces cartoonsegmentation_tpu/ops/discfill.py:fill_disocclusion
// (with _first_hit and _offset_table), the TPU form of the reference's
// discfill_updateOutput RawKernel (`discfill_mode: exact`).
//
// For each hole pixel p (depth <= 0) and each direction d of the 16,
// the "from" way visits p - o_d(s), s = 1..K, to its first event: a
// valid pixel (depth > 0: found) or leaving the frame (not found);
// the "to" way visits p + o_d(s) the same way. o_d(s) = C-round(s·d̂)
// is the host's table (ops/discfill.py:offset_table, float64). Where
// both ways find a pixel, the gap between the two endpoints competes:
// a direction wins when the best gap so far is strictly larger (the
// first direction keeps a tie), and the hole copies the endpoint with
// the larger depth (the "from" end keeps a tie). Non-holes, and holes
// no direction fills, copy themselves. The output equals the plain
// version's (and the JAX version's) bit for bit.
//
// Bound on the card: bytes, the image read and written once and the
// depth read once (21.2 MB at 576x1024x4, 0.0063 ms at 3.35 TB/s), if
// the walks cost nothing; they are chains of dependent steps, so a
// hole's time is latency. The design is csrc/discfill.cu's (K3):
// - a warp takes a chunk of 32 pixels and copies its non-holes,
//   coalesced: a float4 a lane at C = 4 with 16-byte aligned buffers,
//   else the chunk's 32·C floats in order; a block's 8 chunks lie far
//   apart (chunk (g·stride) mod chunks), so that a band of holes
//   along the border is shared by many blocks;
// - a block with holes stages the step table in shared memory, then
//   deals its holes to its warps, a warp a hole: lane l walks
//   direction l >> 1 on side l & 1 (0 "from", 1 "to"), all 32
//   half-lines at once, each loading 4 steps before it tests them.
//   The lanes of one step read 16 directions' entries: constant memory
//   would serialise them, shared memory serves them in one access. The
//   table is (K, 17) packed words, (dy << 16) + dx, a row a step (the
//   17th word pads the row, so the 32 steps of a long walk read 32
//   banks); the wrapper builds it once per (K, card);
// - a half-line stops as soon as its direction cannot win. Both
//   offsets of a direction keep each component's sign, and the larger
//   component is at least 1 at every step (|d̂|'s larger component is
//   >= 1/sqrt(2)), so for the endpoints' offsets o1 and o2 the gap
//   |o1 + o2|^2 = |o1|^2 + |o2|^2 + 2 o1·o2 > |o1|^2 + |o2|^2; and
//   |o(s)|^2 never shrinks as s grows. So once the squared offsets the
//   two sides have reached (the last step tested, or the endpoint) add
//   up to the best complete gap^2 so far, the direction's gap is
//   strictly larger than the best: it cannot win, nor tie. The
//   direction also stops when either side left the frame or ran out
//   of its K steps;
// - after 4 rounds (16 steps), once fewer than 8 half-lines walk, the
//   warp takes them one at a time, its 32 lanes testing 32 steps in a
//   row (of a pair, the side nearer the frame's edge first: if it
//   leaves, the other need not walk);
// - one warp reduce of gap^2·16 + direction picks the winner. The JAX
//   version compares dist = sqrt(f32(gx)^2 + f32(gy)^2). Each
//   component of an endpoint difference is at most 2K = 512, so gap^2
//   <= 2^19: the squares and their sum are exact in f32, and between
//   two integers n < m <= 2^19 sqrt grows by more than 1/(2·sqrt(m)) >=
//   2^-10.5, over ten f32 ulps at 724 (2^-14), so the correctly rounded
//   f32 sqrt is strictly increasing on them. The integer comparison
//   therefore decides what the f32 comparison decides, ties included.
// One launch a call, no atomics. The walks read the f32 depth
// (2.4 MB at 576x1024, resident in L2), which also gives the
// endpoint's depth.
#include "kb_common.cuh"

#include <climits>

namespace {

constexpr int kBlock = 256;         // threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kAhead = 4;           // steps a half-line loads before it tests
constexpr int kRounds = 4;          // rounds before the warp may switch
constexpr int kSwitch = 8;          // to walking the last few half-lines
                                    // one at a time, a lane a step
constexpr int kMaxSteps = 256;      // MAX_KERNEL_STEPS
constexpr int kRow = 17;            // words a step in the table
constexpr int kNoGap = 1 << 24;     // above any gap^2 (<= 2^19)
constexpr unsigned kAll = 0xffffffffu;

// (dy, dx) of a packed table word (dy << 16) + dx, |dy|, |dx| <= 256
__device__ __forceinline__ void unpack(int v, int& dy, int& dx) {
  dy = (v + 32768) >> 16;
  dx = v - dy * 65536;
}

// The pair exchange: a half-line whose partner failed fails; both lanes
// of a complete direction take its gap^2 (else kNoGap). Returns the
// smallest gap^2 in the warp.
__device__ __forceinline__ int settle(int& state, int ey, int ex,
                                      int& gap) {
  const int pstate = __shfl_xor_sync(kAll, state, 1);
  const int py = __shfl_xor_sync(kAll, ey, 1);
  const int px = __shfl_xor_sync(kAll, ex, 1);
  if (state == 0 && pstate == 2) state = 2;
  gap = kNoGap;
  if (state == 1 && pstate == 1) {
    const int gy = ey - py, gx = ex - px;
    gap = gy * gy + gx * gx;
  }
  return __reduce_min_sync(kAll, gap);
}

// One hole, one warp: pixel i's source, which the warp copies to out.
// tab: the (K, kRow) table in shared memory.
template <bool kVec4>
__device__ void fill_hole(const float* __restrict__ img,
                          const float* __restrict__ depth,
                          const int* __restrict__ tab, int K, int H, int W,
                          int C, int i, int lane, float* __restrict__ out) {
  const int y0 = i / W, x0 = i - y0 * W;
  const int d = lane >> 1;
  const int sg = (lane & 1) ? 1 : -1;
  int s = 0;                      // steps tested
  int r2 = 0;                     // |o|^2 of the last step tested, or of
                                  // the endpoint
  int state = 0;                  // 0 walking, 1 found, 2 failed
  int ey = 0, ex = 0;             // the endpoint
  float ed = 0.0f;                // its depth
  int gap = kNoGap;               // this direction's gap^2, once complete
  int best;
  // 1. each lane its own half-line, kAhead steps a round: kRounds
  // rounds, then while at least kSwitch half-lines walk
  for (int round = 1;; ++round) {
    if (state == 0) {
      int ky[kAhead], kx[kAhead], kr[kAhead];
      bool kin[kAhead];
      float kd[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        // K is a multiple of 16, so a round never passes step K
        int dy, dx;
        unpack(tab[(s + k) * kRow + d], dy, dx);
        ky[k] = y0 + sg * dy;
        kx[k] = x0 + sg * dx;
        kr[k] = dy * dy + dx * dx;
        kin[k] = ky[k] >= 0 && ky[k] < H && kx[k] >= 0 && kx[k] < W;
        kd[k] = kin[k] ? __ldg(depth + ky[k] * W + kx[k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (state == 0) {
          r2 = kr[k];
          if (!kin[k]) {
            state = 2;
          } else if (kd[k] > 0.0f) {
            state = 1;
            ey = ky[k];
            ex = kx[k];
            ed = kd[k];
          }
        }
      }
      s += kAhead;
      if (state == 0 && s >= K) state = 2;   // ran out of steps
    }
    best = settle(state, ey, ex, gap);
    // the direction cannot win once its two sides' squared offsets add
    // up to the best gap^2
    const int pr2 = __shfl_xor_sync(kAll, r2, 1);
    if (state == 0 && r2 + pr2 >= best) state = 2;
    const int pstate = __shfl_xor_sync(kAll, state, 1);
    if (state == 0 && pstate == 2) state = 2;
    const int walking = __popc(__ballot_sync(kAll, state == 0));
    if (walking == 0 || (round >= kRounds && walking < kSwitch)) break;
  }
  // 2. the few half-lines still walking, one at a time (of a pair, the
  // one nearer the frame's edge first, by the table's last step as the
  // direction), each lane testing one of 32 steps in a row
  float to_edge;
  {
    int dy, dx;
    unpack(tab[(K - 1) * kRow + d], dy, dx);
    dy *= sg;
    dx *= sg;
    const float ty = dy > 0 ? (float)(H - y0) / dy
                            : dy < 0 ? (float)(y0 + 1) / -dy : 3e38f;
    const float tx = dx > 0 ? (float)(W - x0) / dx
                            : dx < 0 ? (float)(x0 + 1) / -dx : 3e38f;
    to_edge = fminf(ty, tx);
  }
  for (unsigned live; (live = __ballot_sync(kAll, state == 0)) != 0;) {
    int l = __ffs(live) - 1;
    const float e_l = __shfl_sync(kAll, to_edge, l);
    const float e_p = __shfl_sync(kAll, to_edge, l ^ 1);
    if ((live >> (l ^ 1)) & 1u && e_p < e_l) l ^= 1;
    const int dl = l >> 1, sl = (l & 1) ? 1 : -1;
    const int pr2 = __shfl_sync(kAll, r2, l ^ 1);
    for (int base = __shfl_sync(kAll, s, l);; base += 32) {
      const int ss = base + lane;           // this lane's step, 0-based
      int cy = y0, cx = x0, cr = 0;
      bool stop = ss >= K;
      if (!stop) {
        int dy, dx;
        unpack(tab[ss * kRow + dl], dy, dx);
        cy = y0 + sl * dy;
        cx = x0 + sl * dx;
        cr = dy * dy + dx * dx;
        // a valid pixel this far makes a gap larger than best
        stop = !(cy >= 0 && cy < H && cx >= 0 && cx < W) ||
               cr + pr2 >= best;
      }
      const float cd = stop ? 0.0f : __ldg(depth + cy * W + cx);
      const unsigned hit = __ballot_sync(kAll, cd > 0.0f);
      const unsigned ev = hit | __ballot_sync(kAll, stop);
      if (ev) {
        const int first = __ffs(ev) - 1;
        const int fy = __shfl_sync(kAll, cy, first);
        const int fx = __shfl_sync(kAll, cx, first);
        const int fr = __shfl_sync(kAll, cr, first);
        const float fd = __shfl_sync(kAll, cd, first);
        if (lane == l) {
          state = (hit >> first) & 1u ? 1 : 2;
          ey = fy;
          ex = fx;
          ed = fd;
          r2 = fr;
        }
        break;
      }
    }
    best = settle(state, ey, ex, gap);
  }
  // both lanes of a complete direction hold its gap^2
  const int win = __reduce_min_sync(kAll, gap < kNoGap ? gap * 16 + d
                                                       : INT_MAX);
  const int wl = (win & 15) * 2;
  const int eidx = ey * W + ex;
  const int f_idx = __shfl_sync(kAll, eidx, wl);
  const int t_idx = __shfl_sync(kAll, eidx, wl + 1);
  const float f_d = __shfl_sync(kAll, ed, wl);
  const float t_d = __shfl_sync(kAll, ed, wl + 1);
  const int src = win == INT_MAX ? i : (f_d < t_d ? t_idx : f_idx);
  if (kVec4) {
    if (lane == 0)
      reinterpret_cast<float4*>(out)[i] =
          reinterpret_cast<const float4*>(img)[src];
  } else {
    for (int c = lane; c < C; c += 32)
      out[(long long)i * C + c] = img[(long long)src * C + c];
  }
}

// A block's 8 warps each take a chunk of 32 pixels, chunk
// (g·stride) mod chunks for warp g of the grid. Each warp copies its
// chunk's non-holes; a block with holes stages the table and deals
// its holes to its warps in turn, a warp a hole.
template <bool kVec4>
__global__ void __launch_bounds__(kBlock)
    discfill_exact_kernel(const float* __restrict__ img,
                          const float* __restrict__ depth,
                          const int* __restrict__ table, int K, int H, int W,
                          int C, long long chunks, long long stride,
                          float* __restrict__ out) {
  extern __shared__ int4 tab4[];
  __shared__ unsigned masks[kWarps];
  __shared__ int firsts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = H * W;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  const int first = g < chunks ? (int)(g * stride % chunks) * 32 : n;
  const int i = first + lane;
  const bool hole = i < n && depth[i] <= 0.0f;
  const unsigned mask = __ballot_sync(kAll, hole);
  if (kVec4) {
    if (i < n && !hole)
      reinterpret_cast<float4*>(out)[i] =
          reinterpret_cast<const float4*>(img)[i];
  } else {
    const int end = max(min(32, n - first), 0) * C;
    const long long off = (long long)first * C;
    for (int j = lane; j < end; j += 32)
      if (!((mask >> (j / C)) & 1u)) out[off + j] = img[off + j];
  }
  if (lane == 0) {
    masks[warp] = mask;
    firsts[warp] = first;
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += __popc(masks[w]);
  if (total == 0) return;
  // K·kRow words, a multiple of 16 (K is a multiple of 16)
  const int4* t4 = reinterpret_cast<const int4*>(table);
  for (int j = threadIdx.x; j < K * kRow / 4; j += kBlock)
    tab4[j] = __ldg(t4 + j);
  __syncthreads();
  const int* tab = reinterpret_cast<const int*>(tab4);
  for (int r = warp; r < total; r += kWarps) {
    int w = 0, k = r;
    while (k >= __popc(masks[w])) k -= __popc(masks[w++]);
    unsigned m = masks[w];
    for (; k > 0; --k) m &= m - 1u;  // drop the k lowest holes
    fill_hole<kVec4>(img, depth, tab, K, H, W, C, firsts[w] + __ffs(m) - 1,
                     lane, out);
  }
}

}  // namespace

// img (H,W,C), depth (H,W) f32; table (K, 17) int32, step s's word for
// direction d at [s * 17 + d], (dy << 16) + dx, 16-byte aligned
// (ops/discfill.py:kernel_table); K a multiple of 16, 16 <= K <= 256;
// H·W < 2^31; out (H,W,C). Returns cudaGetLastError().
extern "C" int kb_discfill_exact(const float* img, const float* depth,
                                 const int* table, int K, int H, int W,
                                 int C, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 16 || K > kMaxSteps || K % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)H * W + 31) / 32;
  if (chunks > 0) {
    // a stride near chunks / golden ratio, coprime with chunks, so that
    // (g·stride) mod chunks visits every chunk once
    long long stride = chunks * 618 / 1000 + 1;
    for (;; ++stride) {
      long long x = chunks, y = stride;
      while (y) { const long long t = x % y; x = y; y = t; }
      if (x == 1) break;
    }
    const unsigned blocks = (unsigned)((chunks + kWarps - 1) / kWarps);
    const size_t smem = sizeof(int) * K * kRow;
    const bool vec4 = C == 4 && ((reinterpret_cast<uintptr_t>(img) |
                                  reinterpret_cast<uintptr_t>(out)) &
                                 15) == 0;
    if (vec4)
      discfill_exact_kernel<true><<<blocks, kBlock, smem, s>>>(
          img, depth, table, K, H, W, C, chunks, stride, out);
    else
      discfill_exact_kernel<false><<<blocks, kBlock, smem, s>>>(
          img, depth, table, K, H, W, C, chunks, stride, out);
  }
  return (int)cudaGetLastError();
}
