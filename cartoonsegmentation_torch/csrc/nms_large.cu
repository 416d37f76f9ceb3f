// K14b: class-agnostic greedy NMS over a large fixed candidate set.
//
// Replaces cartoonsegmentation_tpu/models/maskrcnn.py:batched_nms_fixed
// (its call of models/rtmdet.py:nms_fixed, the lax.scan over the
// score-ordered list) at Mask R-CNN's sizes: the RPN's K = 4,756
// per-level tops (IoU 0.7, 1000 out) and the detection's K = 2,048
// candidates (IoU 0.5, 100 out). The category offsets are added in
// torch before the call. Semantics of the scan, exactly (as csrc/nms.cu,
// K8, which stops at K = 512):
//   order = stable argsort(-scores), floats in their total order
//   box i of that order is kept when no kept box before it has
//   IoU > iou_thr with it; boxes j <= i are never suppressed by i
//   top  = stable argsort(-where(kept, score, -1))[:max_out]
//   keep_idx = order[top], keep_mask = kept[top] & (kept score > -1)
// IoU = inter / max(area_a + area_b - inter, 1e-9), in that order.
//
// Bound on the card: latency. The IoUs (11.3 M pairs at K = 4,756,
// ~0.003 ms of f32 work) spread over many blocks; the greedy walk is
// serial. Three kernels on the stream:
//   1. one block sorts the (score key, index) pairs in dynamic shared
//      memory (a bitonic sort of the next power of two, up to 16,384 x
//      8 bytes) and writes the order, the sorted boxes and scores;
//   2. a grid of 64 x 64 tiles of the upper triangle writes the
//      suppression bitmask, one 64-bit word per (row, column tile),
//      one thread per row;
//   3. one block walks the rows a 64-row tile at a time: one warp
//      resolves the tile's rows in order from their diagonal words in
//      registers, then all threads OR the kept rows' words into the
//      later tiles' "removed" words in shared memory; then all threads
//      sort the kept boxes again for the output.
#include "kb_common.cuh"

namespace {

constexpr int kMaxK = 16384;
constexpr int kThreads = 1024;
constexpr int kTile = 64;
constexpr int kMaxWords = kMaxK / kTile;

// float → unsigned int, increasing in the float total order
__device__ __forceinline__ unsigned int total_order(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ void bitonic_sort(unsigned long long* key, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = key[i], b = key[ixj];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// 1. order = stable argsort(-scores); the sorted boxes and scores
__global__ void __launch_bounds__(kThreads)
    sort_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores, int K, int n2,
                int* __restrict__ order, float4* __restrict__ sboxes,
                float* __restrict__ sscores) {
  extern __shared__ unsigned long long key[];
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    key[i] = i < K ? ((unsigned long long)total_order(-scores[i]) << 32) |
                         (unsigned int)i
                   : ~0ull;
  __syncthreads();
  bitonic_sort(key, n2);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int o = (int)(key[i] & 0xffffffffu);
    order[i] = o;
    sboxes[i] = make_float4(boxes[4 * o], boxes[4 * o + 1], boxes[4 * o + 2],
                            boxes[4 * o + 3]);
    sscores[i] = scores[o];
  }
}

// 2. word (i, c): bit b set when j = 64c + b > i and IoU(i, j) > thr;
// only the tiles with c >= i / 64 are written (and read)
__global__ void __launch_bounds__(kTile)
    mask_kernel(const float4* __restrict__ sboxes, int K, int words,
                float iou_thr, unsigned long long* __restrict__ mask) {
  const int r = blockIdx.y, c = blockIdx.x;
  if (c < r) return;
  __shared__ float4 cb[kTile];
  const int t = threadIdx.x;
  const int jc = c * kTile + t;
  if (jc < K) cb[t] = sboxes[jc];
  __syncthreads();
  const int i = r * kTile + t;
  if (i >= K) return;
  const float4 a = sboxes[i];
  const float area_a = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  unsigned long long bits = 0;
  for (int b = 0; b < kTile; ++b) {
    const int j = c * kTile + b;
    if (j <= i || j >= K) continue;
    const float4 o = cb[b];
    const float area_b = fmaxf(o.z - o.x, 0.0f) * fmaxf(o.w - o.y, 0.0f);
    const float iw = fmaxf(fminf(a.z, o.z) - fmaxf(a.x, o.x), 0.0f);
    const float ih = fmaxf(fminf(a.w, o.w) - fmaxf(a.y, o.y), 0.0f);
    const float inter = iw * ih;
    const float iou = inter / fmaxf(area_a + area_b - inter, 1e-9f);
    if (iou > iou_thr) bits |= 1ull << b;
  }
  mask[(long long)i * words + c] = bits;
}

// 3. the greedy walk, a 64-row tile at a time, then
// top = stable argsort(-where(kept, score, -1)). Tile r's rows can only
// be suppressed by kept rows before them: those of earlier tiles are
// already OR-ed into removed[r], and the tile's own come from its
// diagonal words, so one warp resolves the tile's 64 rows from
// registers; then every thread ORs the kept rows' words into the later
// words of `removed` (independent loads, shared-memory atomics).
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const unsigned long long* __restrict__ mask,
                const int* __restrict__ order,
                const float* __restrict__ sscores, int K, int n2, int words,
                int n_out, long long* __restrict__ keep_idx,
                uint8_t* __restrict__ keep_mask) {
  extern __shared__ unsigned long long key[];
  uint8_t* kept = reinterpret_cast<uint8_t*>(key + n2);
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long tile_kept;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0;
  __syncthreads();
  for (int r = 0; r < words; ++r) {
    const int row0 = r * kTile;
    if (t < 32) {
      // the diagonal words of rows row0 + t and row0 + 32 + t
      const int ra = row0 + t, rb = row0 + 32 + t;
      const unsigned long long da =
          ra < K ? mask[(long long)ra * words + r] : 0ull;
      const unsigned long long db =
          rb < K ? mask[(long long)rb * words + r] : 0ull;
      unsigned long long word = removed[r], bits = 0;
      const int n = min(kTile, K - row0);
      for (int j = 0; j < n; ++j) {
        const unsigned long long dj =
            __shfl_sync(0xffffffffu, j < 32 ? da : db, j & 31);
        if (!((word >> j) & 1ull)) {
          bits |= 1ull << j;
          word |= dj;
        }
      }
      if (ra < K) kept[ra] = (bits >> t) & 1ull;
      if (rb < K) kept[rb] = (bits >> (32 + t)) & 1ull;
      if (t == 0) tile_kept = bits;
    }
    __syncthreads();
    const unsigned long long bits = tile_kept;
    const int later = words - r - 1;
    for (int q = t; q < kTile * later; q += blockDim.x) {
      const int j = q / later, w = r + 1 + (q - j * later);
      if ((bits >> j) & 1ull) {
        const unsigned long long v = mask[(long long)(row0 + j) * words + w];
        if (v) atomicOr(&removed[w], v);
      }
    }
    __syncthreads();
  }
  for (int p = t; p < n2; p += blockDim.x)
    key[p] = p < K ? ((unsigned long long)total_order(
                          -(kept[p] ? sscores[p] : -1.0f)) << 32) |
                         (unsigned int)p
                   : ~0ull;
  __syncthreads();
  bitonic_sort(key, n2);
  for (int q = t; q < n_out; q += blockDim.x) {
    const int p = (int)(key[q] & 0xffffffffu);
    keep_idx[q] = (long long)order[p];
    keep_mask[q] = kept[p] && sscores[p] > -1.0f;
  }
}

}  // namespace

// boxes (K, 4), scores (K,) f32 with 1 <= K <= 16384; keep_idx (n_out,)
// int64, keep_mask (n_out,) u8, 1 <= n_out <= K; scratch: order (K,)
// int32, sboxes (K, 4) and sscores (K,) f32, mask (K * ceil(K/64),)
// 64-bit words. Returns cudaGetLastError().
extern "C" int kb_nms_large(const float* boxes, const float* scores, int K,
                            float iou_thr, int n_out, long long* keep_idx,
                            uint8_t* keep_mask, int* order, float* sboxes,
                            float* sscores, unsigned long long* mask,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || n_out < 1 || n_out > K)
    return (int)cudaErrorInvalidValue;
  int n2 = 2;
  while (n2 < K) n2 <<= 1;
  const int words = (K + kTile - 1) / kTile;
  const size_t shm_sort = sizeof(unsigned long long) * n2;
  const size_t shm_walk = shm_sort + n2;
  cudaError_t err = cudaFuncSetAttribute(
      sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm_sort);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm_walk);
  if (err != cudaSuccess) return (int)err;
  float4* sb = reinterpret_cast<float4*>(sboxes);
  sort_kernel<<<1, kThreads, shm_sort, s>>>(boxes, scores, K, n2, order, sb,
                                            sscores);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mask_kernel<<<dim3(words, words), kTile, 0, s>>>(sb, K, words, iou_thr,
                                                    mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<1, kThreads, shm_walk, s>>>(mask, order, sscores, K, n2,
                                            words, n_out, keep_idx,
                                            keep_mask);
  return (int)cudaGetLastError();
}
