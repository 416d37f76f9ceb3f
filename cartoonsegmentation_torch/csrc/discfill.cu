// K3: disocclusion fill along 16 digital lines.
//
// Replaces cartoonsegmentation_tpu/ops/discfill3.py:
// fill_disocclusion_fast3 (helpers discfill2.py:_offsets_np/_row_shift,
// discfill.py:_DIR_X/_DIR_Y), the TPU re-design of the reference's
// discfill_updateOutput RawKernel.
//
// For each hole pixel (depth <= 0) and each of the 16 directions, walk
// the digital line x = x0 + off(y) - off(y0) (transposed, y = y0 +
// off(x) - off(x0), when |dx| > |dy|) both ways to the first valid
// pixel (depth > 0); leaving the frame fails the direction. off(y) =
// round(y·p/q) with C rounding, as _off_arith computes it in integers.
// The direction with the smallest squared gap between its two
// endpoints wins (strict <, the first in direction order on a tie;
// gaps >= 1e6 never win), and the hole copies the endpoint with the
// larger depth (a tie keeps the "from" end). A hole with no direction
// copies itself. The output equals the plain version's bit for bit.
//
// Bound on the card: the bytes, H·W·(4C + 4 + 4C) read and written
// once (0.0063 ms at 576x1024, C = 4, at 3.35 TB/s), if the walks cost
// nothing; they are chains of dependent steps (each step's test decides
// whether the next is taken), so a hole's time is latency. A thread a
// pixel would walk its hole's 32 half-lines one after another while
// the warp's other lanes wait on it. This design:
// - a warp takes a chunk of 32 pixels and copies its non-hole pixels,
//   coalesced: a float4 a lane at C = 4 with 16-byte aligned buffers
//   (the frame loop's case), else the chunk's 32·C floats in order;
//   a block's 8 chunks lie far apart (chunk (g·stride) mod chunks), so
//   that a dense run of holes is shared by many blocks (with 256
//   consecutive pixels a block, a band of holes along the border would
//   put 32 holes on each warp of a few blocks, one after another);
// - the block's holes (a ballot a chunk) are dealt to its warps, a warp
//   a hole: lane l walks direction l >> 1 on side l & 1, all 32
//   half-lines at once, each loading 4 steps ahead before it tests
//   them (the loads of a batch do not depend on each other);
// - a half-line stops as soon as its direction cannot win: its partner
//   left the frame, or the squared distance it has walked is at least
//   the best gap found so far (one warp reduce a batch) or 1e6. A gap
//   exceeds the squared distance from the hole to either endpoint (the
//   endpoints lie on opposite sides along a line that is monotone in
//   both coordinates), so this never drops a winner;
// - after 4 rounds (16 steps), once fewer than 8 half-lines walk, the
//   warp takes them one at a time, its 32 lanes testing 32 steps in a
//   row (of a pair, the side nearer the frame's edge first: if it
//   leaves, the other need not walk): holes along the frame's border
//   leave a long vertical walk to one lane otherwise. Short walks stay
//   in the rounds, where the warp's half-lines step together;
// - one warp reduce of gap·16 + direction picks the winner, as the
//   plain version's strict `best_d > d2` taken in direction order does.
// One launch, no global atomics. The walks read the f32 depth (2.4 MB
// at 576x1024, resident in L2), which also gives the endpoint's depth.
#include "kb_common.cuh"

#include <climits>

namespace {

constexpr int kBlock = 256;         // threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kAhead = 4;           // steps a half-line loads before it tests
constexpr int kRounds = 4;          // rounds before the warp may switch
constexpr int kSwitch = 8;          // to walking the last few half-lines
                                    // one at a time, a lane a step
constexpr int kNoGap = 1000000;     // BIG: a gap this large never wins
constexpr unsigned kAll = 0xffffffffu;

__constant__ int kDirX[16] = {-1, 0, 1, 1, -1, 1, 2, 2,
                              -2, -1, 1, 2, 3, 3, 3, 3};
__constant__ int kDirY[16] = {1, 1, 1, 0, 2, 2, 1, -1,
                              3, 3, 3, 3, 2, 1, -1, -2};

// A half-line of direction d from (y0, x0) on side `to`: the walk steps
// coordinate a (y when |dy| >= |dx|, else x) by `step`; the line's
// other coordinate is b = b0 + off(a) - off(a0), off(t) =
// sgn·((2|p|t + q) div 2q) with q > 0; pixel a·sa + b·sb.
struct Walk {
  int a0, b0, na, nb, sa, sb, ap, q, sgn, qt0, step;
  __device__ Walk(int d, bool to, int y0, int x0, int H, int W) {
    const int dx = kDirX[d], dy = kDirY[d];
    const bool rows = abs(dy) >= abs(dx);
    const int p = rows ? dx : dy;
    q = rows ? dy : dx;
    a0 = rows ? y0 : x0;
    b0 = rows ? x0 : y0;
    na = rows ? H : W;
    nb = rows ? W : H;
    sa = rows ? W : 1;
    sb = rows ? 1 : W;
    ap = abs(p);
    sgn = p >= 0 ? 1 : -1;
    qt0 = (2 * ap * a0 + q) / (2 * q);
    step = to ? 1 : -1;
  }
  // b at a, for 0 <= a < na
  __device__ int b_at(int a) const {
    return b0 + sgn * ((2 * ap * a + q) / (2 * q) - qt0);
  }
};

// The pair exchange: a half-line whose partner failed fails; both lanes
// of a complete direction take its gap (else kNoGap). Returns the
// smallest gap in the warp.
__device__ __forceinline__ int settle(int& state, int ea, int eb,
                                      int& gap) {
  const int pstate = __shfl_xor_sync(kAll, state, 1);
  const int pa = __shfl_xor_sync(kAll, ea, 1);
  const int pb = __shfl_xor_sync(kAll, eb, 1);
  if (state == 0 && pstate == 2) state = 2;
  gap = kNoGap;
  if (state == 1 && pstate == 1) {
    const int ga = ea - pa, gb = eb - pb;
    gap = min(ga * ga + gb * gb, kNoGap);
  }
  return __reduce_min_sync(kAll, gap);
}

// One hole, one warp: pixel i's source, which the warp copies to out.
template <bool kVec4>
__device__ void fill_hole(const float* __restrict__ img,
                          const float* __restrict__ depth, int H, int W,
                          int C, int i, int lane, float* __restrict__ out) {
  const int y0 = i / W, x0 = i - y0 * W;
  const int d = lane >> 1;
  const Walk w(d, lane & 1, y0, x0, H, W);
  // off(a) carried as a quotient and a remainder, so that no step
  // divides
  const int two_q = 2 * w.q, drem = 2 * w.ap * w.step;
  int qt = w.qt0, rem = 2 * w.ap * w.a0 + w.q - w.qt0 * two_q;
  int a = w.a0, b = w.b0;
  int state = 0;                  // 0 walking, 1 found, 2 failed
  int ea = 0, eb = 0;             // the endpoint
  float ed = 0.0f;                // its depth
  int gap = kNoGap;               // this direction's gap, once complete
  int best;
  // 1. each lane its own half-line, kAhead steps a round: kRounds
  // rounds, then while at least kSwitch half-lines walk
  for (int round = 1;; ++round) {
    if (state == 0) {
      int ka[kAhead], kb[kAhead];
      bool kin[kAhead];
      float kd[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        a += w.step;
        rem += drem;  // |drem| <= 2q: one carry at most
        if (rem >= two_q) { rem -= two_q; ++qt; }
        if (rem < 0) { rem += two_q; --qt; }
        b = w.b0 + w.sgn * (qt - w.qt0);
        ka[k] = a;
        kb[k] = b;
        kin[k] = a >= 0 && a < w.na && b >= 0 && b < w.nb;
        kd[k] = kin[k] ? __ldg(depth + a * w.sa + b * w.sb) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (state == 0) {
          if (!kin[k]) {
            state = 2;
          } else if (kd[k] > 0.0f) {
            state = 1;
            ea = ka[k];
            eb = kb[k];
            ed = kd[k];
          }
        }
      }
    }
    best = settle(state, ea, eb, gap);
    if (state == 0) {
      const int ra = a - w.a0, rb = b - w.b0;
      if (ra * ra + rb * rb >= best) state = 2;
    }
    const int pstate = __shfl_xor_sync(kAll, state, 1);
    if (state == 0 && pstate == 2) state = 2;
    const int walking = __popc(__ballot_sync(kAll, state == 0));
    if (walking == 0 || (round >= kRounds && walking < kSwitch)) break;
  }
  // 2. the few half-lines still walking, one at a time (of a pair, the
  // one nearer the frame's edge first), each lane testing one of 32
  // steps in a row
  const int to_edge = w.step > 0 ? w.na - a : a + 1;
  for (unsigned live; (live = __ballot_sync(kAll, state == 0)) != 0;) {
    int l = __ffs(live) - 1;
    const int e_l = __shfl_sync(kAll, to_edge, l);
    const int e_p = __shfl_sync(kAll, to_edge, l ^ 1);
    if ((live >> (l ^ 1)) & 1u && e_p < e_l) l ^= 1;
    const Walk v(l >> 1, l & 1, y0, x0, H, W);
    int s = abs(__shfl_sync(kAll, a, l) - v.a0) + 1 + lane;
    for (;; s += 32) {
      const int ca = v.a0 + v.step * s;
      const bool in_a = ca >= 0 && ca < v.na;
      const int cb = in_a ? v.b_at(ca) : v.b0;
      const int rb = cb - v.b0;
      // a valid pixel this far makes a gap larger than best
      const bool stop = !(in_a && cb >= 0 && cb < v.nb) ||
                        s * s + rb * rb >= best;
      const float cd = stop ? 0.0f : __ldg(depth + ca * v.sa + cb * v.sb);
      const unsigned hit = __ballot_sync(kAll, cd > 0.0f);
      const unsigned ev = hit | __ballot_sync(kAll, stop);
      if (ev) {
        const int first = __ffs(ev) - 1;
        const int fa = __shfl_sync(kAll, ca, first);
        const int fb = __shfl_sync(kAll, cb, first);
        const float fd = __shfl_sync(kAll, cd, first);
        if (lane == l) {
          state = (hit >> first) & 1u ? 1 : 2;
          ea = fa;
          eb = fb;
          ed = fd;
        }
        break;
      }
    }
    best = settle(state, ea, eb, gap);
  }
  // both lanes of a complete direction hold its gap
  const int win = __reduce_min_sync(kAll, gap < kNoGap ? gap * 16 + d
                                                       : INT_MAX);
  const int wl = (win & 15) * 2;
  const int eidx = ea * w.sa + eb * w.sb;
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
// (g·stride) mod chunks for warp g of the grid: a dense run of holes
// (a band along the border) spreads over many blocks instead of
// filling a few. Each warp copies its chunk's non-holes; then the
// block deals its holes to its warps, one warp a hole.
template <bool kVec4>
__global__ void __launch_bounds__(kBlock)
    discfill_kernel(const float* __restrict__ img,
                    const float* __restrict__ depth, int H, int W, int C,
                    long long chunks, long long stride,
                    float* __restrict__ out) {
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
  for (int r = warp; r < total; r += kWarps) {
    int w = 0, k = r;
    while (k >= __popc(masks[w])) k -= __popc(masks[w++]);
    unsigned m = masks[w];
    for (; k > 0; --k) m &= m - 1u;  // drop the k lowest holes
    fill_hole<kVec4>(img, depth, H, W, C, firsts[w] + __ffs(m) - 1, lane,
                     out);
  }
}

}  // namespace

// img (H,W,C), depth (H,W) f32; out (H,W,C); H, W < 32768. Returns
// cudaGetLastError().
extern "C" int kb_discfill(const float* img, const float* depth, int H,
                           int W, int C, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
    const bool vec4 = C == 4 && ((reinterpret_cast<uintptr_t>(img) |
                                  reinterpret_cast<uintptr_t>(out)) &
                                 15) == 0;
    if (vec4)
      discfill_kernel<true><<<blocks, kBlock, 0, s>>>(
          img, depth, H, W, C, chunks, stride, out);
    else
      discfill_kernel<false><<<blocks, kBlock, 0, s>>>(
          img, depth, H, W, C, chunks, stride, out);
  }
  return (int)cudaGetLastError();
}
