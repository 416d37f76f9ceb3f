// K1: point-cloud forward splat with z-buffer.
//
// Replaces cartoonsegmentation_tpu/ops/pointcloud.py:_render_impl
// (public render_pointcloud), itself the re-design of the reference's
// updateZee / updateDegrid / updateOutput RawKernels.
//
// Bound on the card: bytes. Per point it reads 12 B of position and
// 4·C B of payload once, and it writes H·W·(C + 2) floats of render,
// weight and z-buffer once: 160 MB in and 163 MB out with the Inpaint
// net's C = 68. Summing into a global H·W·(C+1) accumulator with f32
// atomics would cost 4·(C+1) atomics a point (163 M at C = 68, into
// 163 MB that the 50 MB L2 does not hold) and two more passes over it.
// Design: each 16x16 output tile is summed by one block in shared
// memory, from a list of the points that reach it. Five launches on
// the caller's stream, no host sync:
//   1. init: z-keys to key(1e6), tile counts to 0;
//   2. bin: one thread per point: the atomicMin of the sign-ordered int
//      view of its key on the nearest corner (the key goes negative
//      once f·b/z > 1e6, so a plain float-as-int min would misorder),
//      and a count in each tile that one of its in-frame corners of
//      non-zero weight falls in (1, 2 or 4 tiles; a warp adds its
//      lanes' counts of one tile in one atomic). Invalid points and
//      points out of frame end here;
//   3. scan: one block, the tiles' exclusive prefix sum;
//   4. degrid + scatter: the opposing-neighbour stencil, out of place
//      from the int keys into the f32 z-buffer, and beside it the
//      point ids into the tiles' lists through per-tile cursors;
//   5. accumulate: one block per tile stages the tile's z-buffer in
//      shared memory, walks its list, takes payload·w and w of each
//      corner inside the tile that passes key <= zref + 1, and writes
//      sum / (w + 1e-7) and w once per pixel. Narrow payloads (C < 16)
//      sort the corners by pixel in shared memory and sum each pixel
//      in its own thread's registers; wide ones (the Inpaint net's
//      C = 68) sum in a 256·(C+1) shared accumulator with atomics whose
//      lanes run over the channels.
// The wrapper (ops/pointcloud.py:splat_plan) splits payloads wider than
// 225 channels into chunks, a block each, so that a block's shared
// memory fits 227 KB; C = 68 takes 71,680 B. The z-buffer and the w > 0
// mask equal the plain version's exactly; only the sums depend on the
// order in which the corners are added.
#include "kb_common.cuh"

namespace {

constexpr int T = 256;
constexpr int LG = 4, SIDE = 1 << LG;  // 16x16 output tiles
constexpr int NPX = SIDE * SIDE;
static_assert(NPX == T, "the narrow kernel has a thread per tile pixel");

__device__ __forceinline__ int f2key(float f) {
  int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Corner c of the point: the tile it falls in, or -1 when it is out of
// frame or has weight 0; its pixel (cx, cy) and weight.
__device__ __forceinline__ int corner_tile(const KbProj& p, int c, int H,
                                           int W, int tiles_x, int* cx,
                                           int* cy, float* w) {
  if (kb_corner(p.u, p.v, c, H, W, w) < 0 || *w == 0.0f) return -1;
  *cx = (int)floorf(p.u) + (c & 1);
  *cy = (int)floorf(p.v) + (c >> 1);
  return (*cy >> LG) * tiles_x + (*cx >> LG);
}

// The distinct tiles of a point's corners: t[c] is corner c's tile, or
// -1 when it is out, of weight 0 or in the tile of an earlier corner.
__device__ __forceinline__ void point_tiles(const KbProj& p, int H, int W,
                                            int tiles_x, int t[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int cx, cy;
    float w;
    t[c] = p.valid ? corner_tile(p, c, H, W, tiles_x, &cx, &cy, &w)
                   : -1;
#pragma unroll
    for (int j = 0; j < c; ++j)
      if (t[j] == t[c]) t[c] = -1;
  }
}

__global__ void init_kernel(int* keys, int n_pix, int* counts,
                            int n_tiles) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int stride = gridDim.x * blockDim.x;
  int big = f2key(KB_BIG);
  for (int j = i; j < n_pix; j += stride) keys[j] = big;
  for (int j = i; j < n_tiles; j += stride) counts[j] = 0;
}

__global__ void bin_kernel(const float* __restrict__ pts, int P, int H,
                           int W, float focal, float baseline,
                           int tiles_x, int* keys, int* counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  KbProj p;
  p.valid = false;
  if (i < P)
    p = kb_project(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], H, W,
                   focal, baseline);
  if (p.valid) {
    // nearest corner: ties at 0.5 go to the lower index
    // (pointcloud.py:150-152)
    float x0 = floorf(p.u), y0 = floorf(p.v);
    float bx = x0 + ((p.u - x0) > 0.5f ? 1.0f : 0.0f);
    float by = y0 + ((p.v - y0) > 0.5f ? 1.0f : 0.0f);
    if (bx >= 0.0f && bx < (float)W && by >= 0.0f && by < (float)H)
      atomicMin(&keys[(int)by * W + (int)bx], f2key(p.err));
  }
  int t[4];
  point_tiles(p, H, W, tiles_x, t);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // every lane of the warp takes part (the grid is whole warps)
    unsigned same = __match_any_sync(0xffffffffu, t[c]);
    if (t[c] >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&counts[t[c]], __popc(same));
  }
}

// One block: offs = the exclusive prefix sum of counts.
__global__ void scan_kernel(const int* __restrict__ counts, int n,
                            int* offs) {
  __shared__ int part[1024];
  const int tid = threadIdx.x;
  const int per = (n + 1023) / 1024;
  const int b = min(tid * per, n), e = min(b + per, n);
  int s = 0;
  for (int i = b; i < e; ++i) s += counts[i];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int i = b; i < e; ++i) {
    offs[i] = run;
    run += counts[i];
  }
}

// Blocks below n_degrid: the degrid stencil, one thread a pixel. The
// others: one thread a point, its id into the list of each of its
// tiles; afterwards offs[t] is the end of tile t's list.
__global__ void degrid_scatter_kernel(const int* __restrict__ keys, int H,
                                      int W, float* zee, int n_degrid,
                                      const float* __restrict__ pts, int P,
                                      float focal, float baseline,
                                      int tiles_x, int* offs, int* ids) {
  if ((int)blockIdx.x < n_degrid) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= H * W) return;
    int y = i / W, x = i - y * W;
    float c = key2f(keys[i]);
    const int dys[4] = {0, 1, 1, -1};
    const int dxs[4] = {1, 0, 1, 1};
    float total = 0.0f, count = 0.0f;
    for (int k = 0; k < 4; ++k) {
      int y1 = y + dys[k], x1 = x + dxs[k];
      int y2 = y - dys[k], x2 = x - dxs[k];
      float one = (y1 >= 0 && y1 < H && x1 >= 0 && x1 < W)
                      ? key2f(keys[y1 * W + x1]) : INFINITY;
      float two = (y2 >= 0 && y2 < H && x2 >= 0 && x2 < W)
                      ? key2f(keys[y2 * W + x2]) : INFINITY;
      if (c >= one + 1.0f && c >= two + 1.0f) {
        total = total + (one + two);
        count = count + 2.0f;
      }
    }
    float avg = total / fmaxf(count, 1.0f);
    zee[i] = count > 0.0f ? fminf(c, avg) : c;
    return;
  }
  int i = (blockIdx.x - n_degrid) * blockDim.x + threadIdx.x;
  KbProj p;
  p.valid = false;
  if (i < P)
    p = kb_project(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], H, W,
                   focal, baseline);
  int t[4];
  point_tiles(p, H, W, tiles_x, t);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    unsigned same = __match_any_sync(0xffffffffu, t[c]);
    int lead = __ffs(same) - 1;
    int base = 0;
    if (t[c] >= 0 && lane == lead) base = atomicAdd(&offs[t[c]], __popc(same));
    base = __shfl_sync(0xffffffffu, base, lead);
    if (t[c] >= 0) ids[base + __popc(same & ((1u << lane) - 1u))] = i;
  }
}

// Corner c of a listed point if it lies in this tile (top-left (tx0,
// ty0)) with weight != 0 and passes the z-test: its accumulator offset
// (pixel·stride), else -1; its weight in *w.
__device__ __forceinline__ int corner_slot(const KbProj& p, int c, int H,
                                           int W, int tiles_x, int tile,
                                           int tx0, int ty0,
                                           const float* zs, int stride,
                                           float* w) {
  int cx, cy;
  if (corner_tile(p, c, H, W, tiles_x, &cx, &cy, w) != tile) return -1;
  int l = ((cy - ty0) << LG) + (cx - tx0);
  return p.err <= zs[l] + 1.0f ? l * stride : -1;
}

// The payload values a lane adds for point i: channels k0 + kb + lane
// + 32·t of its row for t < VPL; 1 in the weight's column (k == cw), 0
// past it.
template <int VPL>
__device__ __forceinline__ void load_row(const float* __restrict__ data,
                                         int i, int C, int k0, int kb,
                                         int cw, int lane, float* v) {
  const float* row = data + (long long)i * C + k0;
#pragma unroll
  for (int t = 0; t < VPL; ++t) {
    int k = kb + lane + 32 * t;
    v[t] = k < cw ? row[k] : (k == cw ? 1.0f : 0.0f);
  }
}

// Exclusive prefix sum of v over the block's T threads (T / 32 warp
// totals in warp_tot).
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  int base = 0;
  for (int k = 0; k < wid; ++k) base += warp_tot[k];
  __syncthreads();
  return base + x - v;
}

// Narrow payloads (C < 16): one block per tile, a thread per tile
// pixel (T = 256), no float atomics. The block takes its list BATCH
// points at a time: each thread loads one point and its payload row
// and forms payload·w for each of its corners that lies in the tile
// and passes the z-test; the block counts each pixel's corners (int
// shared atomics, whose results rank them), scans the counts and sorts
// the products by pixel in shared memory; each thread then adds its
// own pixel's products in registers. A warp whose 32 points put a
// corner on one pixel adds those 32 products first (a butterfly of
// shuffles) and files one: the main path's cloud holds ~4,000 copies
// of one point, which an inpainting pass appends for the hole pixels
// of invalid disparity, all at -shift. So many points on one pixel
// cost neither a contended compare-and-swap (sm_90 has no native
// shared f32 add) nor a long serial loop in its owner.
// KMAX >= C + 1 sums a thread (3, 5, 8 or 16); a pair's products take
// an odd stride of PS floats, and BATCH keeps them near 20 KB.
template <int KMAX>
__global__ void __launch_bounds__(T)
    accumulate_narrow_kernel(const float* __restrict__ pts,
                             const float* __restrict__ data, int C, int H,
                             int W, float focal, float baseline,
                             const float* __restrict__ zee,
                             const int* __restrict__ counts,
                             const int* __restrict__ offs,
                             const int* __restrict__ ids, int tiles_x,
                             float* render, float* weight) {
  constexpr int PS = KMAX | 1;
  constexpr int BATCH = KMAX <= 5 ? T : KMAX <= 8 ? T / 2 : T / 4;
  __shared__ float zs[NPX];
  __shared__ int cnt[NPX], start[NPX], warp_tot[T / 32];
  __shared__ float prod[4 * BATCH * PS];
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) << LG;
  const int tx0 = (tile - (tile / tiles_x) * tiles_x) << LG;
  const int q = threadIdx.x;  // the pixel this thread owns
  const int lane = q & 31;
  const int y = ty0 + (q >> LG), x = tx0 + (q & (SIDE - 1));
  const bool in = y < H && x < W;
  zs[q] = in ? zee[y * W + x] : 0.0f;
  float sum[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) sum[k] = 0.0f;

  const int end = offs[tile], begin = end - counts[tile];
  // the id of this thread's point in the batch at b0, or -1
  auto id_at = [&](int b0) {
    return q < BATCH && b0 + q < end ? ids[b0 + q] : -1;
  };
  int i = id_at(begin);
  __syncthreads();  // zs
  for (int b0 = begin; b0 < end; b0 += BATCH) {
    int l[4] = {-1, -1, -1, -1}, rank[4];
    float w[4], v[KMAX];
    if (i >= 0) {
      KbProj p = kb_project(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], H,
                            W, focal, baseline);
      const float* row = data + (long long)i * C;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)  // the weight's column adds w
        v[k] = k < C ? row[k] : 1.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        l[c] = corner_slot(p, c, H, W, tiles_x, tile, tx0, ty0, zs, 1,
                           &w[c]);
    }
    // the next batch's id loads while this batch is sorted and summed
    const int i_next = id_at(b0 + BATCH);
    // corners that all 32 lanes put on one pixel: lane 0 files the sum
    bool folded[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int l0 = __shfl_sync(0xffffffffu, l[c], 0);
      folded[c] = __all_sync(0xffffffffu, l[c] == l0) && l0 >= 0;
      if (folded[c] && lane != 0) l[c] = -1;
    }
    cnt[q] = 0;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (l[c] >= 0) rank[c] = atomicAdd(&cnt[l[c]], 1);
    __syncthreads();
    const int n = cnt[q];
    const int s0 = block_exclusive_scan(n, warp_tot);
    start[q] = s0;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* dst = l[c] >= 0 ? prod + (start[l[c]] + rank[c]) * PS : nullptr;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k > C) continue;
        float r = v[k] * w[c];
        if (folded[c]) {  // warp-uniform
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            r = r + __shfl_xor_sync(0xffffffffu, r, o);
        }
        if (dst) dst[k] = r;
      }
    }
    __syncthreads();
    for (int j = s0; j < s0 + n; ++j) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k <= C) sum[k] = sum[k] + prod[j * PS + k];
    }
    i = i_next;
  }
  if (!in) return;
  const long long pix = (long long)y * W + x;
  float wsum = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k == C) wsum = sum[k];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < C) render[pix * C + k] = sum[k] / (wsum + 1e-7f);
  weight[pix] = wsum;
}

// Wide payloads (C >= 16): one block per (tile, channel chunk). Each
// lane finds the corners of one of 32 listed points; the warp then
// takes the 32 points in turn, its lanes over 128 channels at a time
// (4 each), loading the next point's values before it adds the current
// one's, so the payload rows it reads and the shared atomics it issues
// are contiguous, and no two lanes of an atomic hit the same word.
__global__ void __launch_bounds__(T)
    accumulate_wide_kernel(const float* __restrict__ pts,
                           const float* __restrict__ data, int C, int H,
                           int W, float focal, float baseline,
                           const float* __restrict__ zee,
                           const int* __restrict__ counts,
                           const int* __restrict__ offs,
                           const int* __restrict__ ids, int tiles_x,
                           int chunk, float* render, float* weight) {
  constexpr int VPL = 4, SPAN = 32 * VPL;  // channels a pass takes
  extern __shared__ float sm[];
  const int k0 = blockIdx.y * chunk;
  const int cw = min(chunk, C - k0);  // channels of this block
  const int stride = cw + 1;          // ... and the weight
  float* acc = sm;
  float* zs = sm + NPX * stride;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) << LG;
  const int tx0 = (tile - (tile / tiles_x) * tiles_x) << LG;
  for (int q = threadIdx.x; q < NPX * stride; q += T) acc[q] = 0.0f;
  for (int q = threadIdx.x; q < NPX; q += T) {
    int y = ty0 + (q >> LG), x = tx0 + (q & (SIDE - 1));
    zs[q] = (y < H && x < W) ? zee[y * W + x] : 0.0f;
  }
  __syncthreads();

  const int end = offs[tile], begin = end - counts[tile];
  const int lane = threadIdx.x % 32;
  for (int e0 = begin + threadIdx.x - lane; e0 < end; e0 += T) {
    const int e = e0 + lane;
    int i = 0, slot[4] = {-1, -1, -1, -1};
    float wc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (e < end) {
      i = ids[e];
      KbProj p = kb_project(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], H,
                            W, focal, baseline);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        slot[c] = corner_slot(p, c, H, W, tiles_x, tile, tx0, ty0, zs,
                              stride, &wc[c]);
    }
    const int n = min(32, end - e0);
    for (int kb = 0; kb < stride; kb += SPAN) {
      float v[VPL];
      load_row<VPL>(data, __shfl_sync(0xffffffffu, i, 0), C, k0, kb, cw,
                    lane, v);
      for (int j = 0; j < n; ++j) {
        float vn[VPL];
        const int jn = j + 1 < n ? j + 1 : j;
        load_row<VPL>(data, __shfl_sync(0xffffffffu, i, jn), C, k0, kb, cw,
                      lane, vn);
        int sj[4];
        float wj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sj[c] = __shfl_sync(0xffffffffu, slot[c], j);
          wj[c] = __shfl_sync(0xffffffffu, wc[c], j);
        }
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
          const int k = kb + lane + 32 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k < stride && sj[c] >= 0)
              atomicAdd(&acc[sj[c] + k], v[t] * wj[c]);
        }
#pragma unroll
        for (int t = 0; t < VPL; ++t) v[t] = vn[t];
      }
    }
  }
  __syncthreads();

  // a pixel per warp, its lanes over the channels
  for (int q = threadIdx.x / 32; q < NPX; q += T / 32) {
    const int y = ty0 + (q >> LG), x = tx0 + (q & (SIDE - 1));
    if (y >= H || x >= W) continue;
    const long long pix = (long long)y * W + x;
    const float w = acc[q * stride + cw];
    for (int k = lane; k < cw; k += 32)
      render[pix * C + k0 + k] = acc[q * stride + k] / (w + 1e-7f);
    if (blockIdx.y == 0 && lane == 0) weight[pix] = w;
  }
}

inline unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// shared memory above 48 KB must be asked for once
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      accumulate_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// points (P,3), data (P,C) f32 (C >= 0; data is not read at C = 0);
// chunk: the channels a block sums
// (ops/pointcloud.py:splat_plan); scratch: int32 of H*W + 2*n_tiles +
// 4*P, n_tiles the 16x16 tiles that cover the frame (keys, tile
// counts, tile offsets, the tiles' point lists); zee (H*W), render
// (H*W*C) and weight (H*W) are outputs. Returns cudaGetLastError().
extern "C" int kb_splat(const float* points, const float* data, int P,
                        int C, int H, int W, float focal, float baseline,
                        int chunk, int* scratch, float* zee,
                        float* render, float* weight, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = H * W;
  // C = 0 splats the weight alone (render_coverage's covered-pixel
  // count): the narrow kernel reads no payload then and writes no render
  if (n_pix <= 0 || C < 0 || (C > 0 && chunk <= 0))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + SIDE - 1) / SIDE;
  const int n_tiles = tiles_x * ((H + SIDE - 1) / SIDE);
  int* keys = scratch;
  int* counts = keys + n_pix;
  int* offs = counts + n_tiles;
  int* ids = offs + n_tiles;
  const bool wide = C >= 16;
  if (wide) {
    cudaError_t e = allow_smem();
    if (e != cudaSuccess) return (int)e;
  }

  init_kernel<<<blocks(n_pix < 1 << 20 ? n_pix : 1 << 20, T), T, 0, s>>>(
      keys, n_pix, counts, n_tiles);
  if (P > 0)
    bin_kernel<<<blocks(P, T), T, 0, s>>>(points, P, H, W, focal, baseline,
                                          tiles_x, keys, counts);
  scan_kernel<<<1, 1024, 0, s>>>(counts, n_tiles, offs);
  const unsigned n_degrid = blocks(n_pix, T);
  degrid_scatter_kernel<<<n_degrid + blocks(P, T), T, 0, s>>>(
      keys, H, W, zee, (int)n_degrid, points, P, focal, baseline, tiles_x,
      offs, ids);
  if (wide)
    accumulate_wide_kernel<<<dim3(n_tiles, (C + chunk - 1) / chunk), T,
                             sizeof(float) * NPX * (chunk + 2), s>>>(
        points, data, C, H, W, focal, baseline, zee, counts, offs, ids,
        tiles_x, chunk, render, weight);
  else if (C < 3)
    accumulate_narrow_kernel<3><<<n_tiles, T, 0, s>>>(
        points, data, C, H, W, focal, baseline, zee, counts, offs, ids,
        tiles_x, render, weight);
  else if (C < 5)
    accumulate_narrow_kernel<5><<<n_tiles, T, 0, s>>>(
        points, data, C, H, W, focal, baseline, zee, counts, offs, ids,
        tiles_x, render, weight);
  else if (C < 8)
    accumulate_narrow_kernel<8><<<n_tiles, T, 0, s>>>(
        points, data, C, H, W, focal, baseline, zee, counts, offs, ids,
        tiles_x, render, weight);
  else
    accumulate_narrow_kernel<16><<<n_tiles, T, 0, s>>>(
        points, data, C, H, W, focal, baseline, zee, counts, offs, ids,
        tiles_x, render, weight);
  return (int)cudaGetLastError();
}
