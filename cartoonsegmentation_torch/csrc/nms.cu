// K8: class-agnostic greedy NMS over a fixed candidate set.
//
// Replaces cartoonsegmentation_tpu/models/rtmdet.py:nms_fixed (the
// lax.scan over the score-ordered list that stands in for mmcv's
// batched_nms in the RTMDet-Ins postprocess).
//
// boxes (K, 4) xyxy f32, scores (K,) f32, K <= 512. Semantics of the
// scan, exactly:
//   order = stable argsort(-scores)
//   box i of that order is kept when no kept box before it has
//   IoU > iou_thr with it; boxes j <= i are never suppressed by i
//   top  = stable argsort(-where(kept, score, -1))[:max_out]
//   keep_idx = order[top], keep_mask = kept[top] & (kept score > -1)
// Sorts compare floats in their total order (-0 < +0, NaNs at the
// ends), as lax.sort does, with ties broken by the lower index.
// IoU = inter / max(area_a + area_b - inter, 1e-9), in that order.
//
// Bound on the card: one block does all of it, so it is latency, not
// bytes or operations. One block of 512 threads:
//   1. a bitonic sort of (score key, index) pairs in shared memory;
//   2. the 512 x 16-word suppression bitmask (32 KB of shared memory),
//      one thread per row;
//   3. one warp walks the rows in order with the "removed" words in
//      its lanes' registers;
//   4. a second bitonic sort orders the kept boxes for the output.
#include "kb_common.cuh"

namespace {

constexpr int kMaxK = 512;
constexpr int kWords = kMaxK / 32;

// float → unsigned int, increasing in the float total order
__device__ __forceinline__ unsigned int total_order(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ void bitonic_sort(unsigned long long* key) {
  const int i = threadIdx.x;
  for (int k = 2; k <= kMaxK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int ixj = i ^ j;
      if (ixj > i) {
        const unsigned long long a = key[i], b = key[ixj];
        const bool ascending = (i & k) == 0;
        if ((a > b) == ascending) {
          key[i] = b;
          key[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxK)
    nms_kernel(const float* __restrict__ boxes,
               const float* __restrict__ scores, int K, float iou_thr,
               int n_out, long long* __restrict__ keep_idx,
               uint8_t* __restrict__ keep_mask) {
  __shared__ unsigned long long key[kMaxK];
  __shared__ float4 box[kMaxK];
  __shared__ float score[kMaxK];
  __shared__ uint8_t kept[kMaxK];
  // the bitmask; after the walk its first kMaxK words hold the order
  __shared__ unsigned int mask[kMaxK * kWords];
  const int t = threadIdx.x;

  // 1. order = stable argsort(-scores)
  key[t] = t < K ? ((unsigned long long)total_order(-scores[t]) << 32) |
                       (unsigned int)t
                 : ~0ull;
  __syncthreads();
  bitonic_sort(key);
  if (t < K) {
    const int o = (int)(key[t] & 0xffffffffu);
    box[t] = make_float4(boxes[4 * o], boxes[4 * o + 1], boxes[4 * o + 2],
                         boxes[4 * o + 3]);
    score[t] = scores[o];
  }
  __syncthreads();

  // 2. row t: bit j set when j > t and IoU(t, j) > iou_thr
  const int nw = (K + 31) / 32;
  if (t < K) {
    const float4 a = box[t];
    const float area_a =
        fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
    for (int w = 0; w < nw; ++w) {
      unsigned int bits = 0;
      for (int b = 0; b < 32; ++b) {
        const int j = w * 32 + b;
        if (j <= t || j >= K) continue;
        const float4 c = box[j];
        const float area_b =
            fmaxf(c.z - c.x, 0.0f) * fmaxf(c.w - c.y, 0.0f);
        const float iw = fmaxf(fminf(a.z, c.z) - fmaxf(a.x, c.x), 0.0f);
        const float ih = fmaxf(fminf(a.w, c.w) - fmaxf(a.y, c.y), 0.0f);
        const float inter = iw * ih;
        const float iou = inter / fmaxf(area_a + area_b - inter, 1e-9f);
        if (iou > iou_thr) bits |= 1u << b;
      }
      mask[t * kWords + w] = bits;
    }
  }
  __syncthreads();

  // 3. the greedy walk, one warp; lane w keeps "removed" word w
  if (t < 32) {
    unsigned int removed = 0;
    for (int i = 0; i < K; ++i) {
      const unsigned int wi = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool alive = !((wi >> (i & 31)) & 1u);
      if (alive && t < nw) removed |= mask[i * kWords + t];
      if (t == 0) kept[i] = alive;
    }
  }
  __syncthreads();

  // 4. top = stable argsort(-where(kept, score, -1))
  unsigned int* order = mask;
  order[t] = (unsigned int)(key[t] & 0xffffffffu);
  __syncthreads();
  key[t] = t < K ? ((unsigned long long)total_order(
                        -(kept[t] ? score[t] : -1.0f)) << 32) |
                       (unsigned int)t
                 : ~0ull;
  __syncthreads();
  bitonic_sort(key);
  if (t < n_out) {
    const int p = (int)(key[t] & 0xffffffffu);
    keep_idx[t] = (long long)order[p];
    keep_mask[t] = kept[p] && score[p] > -1.0f;
  }
}

}  // namespace

// boxes (K, 4), scores (K,) f32 with 1 <= K <= 512; keep_idx (n_out,)
// int64, keep_mask (n_out,) u8, n_out <= K. Returns cudaGetLastError().
extern "C" int kb_nms(const float* boxes, const float* scores, int K,
                      float iou_thr, int n_out, long long* keep_idx,
                      uint8_t* keep_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || n_out > K) return (int)cudaErrorInvalidValue;
  nms_kernel<<<1, kMaxK, 0, s>>>(boxes, scores, K, iou_thr, n_out, keep_idx,
                                 keep_mask);
  return (int)cudaGetLastError();
}
