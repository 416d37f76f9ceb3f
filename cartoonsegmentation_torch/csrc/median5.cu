// K7, first half: the 5x5 median with reflect padding.
//
// Replaces cartoonsegmentation_tpu/ops/filters.py:median_filter (the
// median-5 gate of `existing` in the Inpaint net): jnp.sort of the 25
// reflected taps, element 12, in JAX's order -inf < finite < +inf <
// NaN with -0 equal to +0. So the output is NaN exactly where 13 or
// more of the taps are NaN, and the 13th tap in that order elsewhere.
//
// The order: each tap becomes an int key (every NaN as +NaN, then
// b ^ ((b >> 31) & 0x7fffffff)), whose signed order is that order but
// for -0 just below +0, which only picks the sign of a zero output.
// The comparators are integer min and max.
//
// The selection: x is (B, H, W, C) channel-last; a block of 32x4
// threads covers a 32x32 output tile of one (b, c) plane, staged in
// shared memory as keys with its reflected halo (16-byte loads where
// the row allows). A thread computes RUN = 8 outputs down one column,
// in pairs. Each window row of 5 taps is sorted once (Knuth's 9
// comparators). Outputs 2p and 2p+1 share the rows 2p+1..2p+4 of the
// thread's window rows: sorted pairs of rows are merged (Batcher's
// odd-even merge of 5 + 5; the merge of rows 2p+3, 2p+4 serves pairs p
// and p+1), then the two pairs into one sorted 20 (Batcher's 10 + 10),
// of which only ranks 8..13 can be either output's median. Each output
// then takes the 13th of those and its own sorted row: the min over i
// of max(a_i, b_(13-i)). The compiler drops the comparators that feed
// no rank 8..13: 570 integer min/max a run of 8 outputs, 71.25 a pixel
// or 35.6 compare-exchanges, where a median-of-25 selection network
// needs 99.
// tests/test_torch_median.py reads these networks from this file,
// proves each output exact over all 2^25 inputs of 0s and 1s, counts
// the operations and emulates the kernel against JAX.
//
// Bound on the card: the bytes, each value read and written once
// (0.0014 ms at 576x1024x1); the 71.25 operations a pixel take 0.0006
// ms at the f32 rate.
#include "kb_common.cuh"

namespace {

constexpr int TX = 32;          // columns a tile, a thread a column
constexpr int TYT = 4;          // threads down a tile
constexpr int RUN = 8;          // outputs a thread, down its column
constexpr int TY = TYT * RUN;   // rows a tile
constexpr int SX = TX + 4;      // staged columns, the halo included

// min to the first wire, max to the second
#define KB_CE(i, j)                          \
  {                                          \
    const int lo_ = min(v[i], v[j]);         \
    v[j] = max(v[i], v[j]);                  \
    v[i] = lo_;                              \
  }
// Knuth's sorting network of 5 (9 comparators)
#define KB_SORT5(X) \
  X(0, 1) X(3, 4) X(2, 4) X(2, 3) X(0, 3) X(0, 2) X(1, 4) X(1, 3) X(1, 2)
// Batcher's odd-even merge of sorted v[0..4] and v[5..9] into v[0..9]
// (13 comparators)
#define KB_MERGE_5_5(X)                                                  \
  X(0, 5) X(4, 9) X(4, 5) X(2, 7) X(2, 4) X(5, 7) X(1, 6) X(3, 8) X(3, 6) \
  X(1, 2) X(3, 4) X(5, 6) X(7, 8)
// Batcher's odd-even merge of sorted v[0..9] and v[10..19] into
// v[0..19] (35 comparators)
#define KB_MERGE_10_10(X)                                                \
  X(0, 10) X(8, 18) X(8, 10) X(4, 14) X(4, 8) X(10, 14) X(2, 12)         \
  X(6, 16) X(6, 12) X(2, 4) X(6, 8) X(10, 12) X(14, 16) X(1, 11)         \
  X(9, 19) X(9, 11) X(5, 15) X(5, 9) X(11, 15) X(3, 13) X(7, 17)         \
  X(7, 13) X(3, 5) X(7, 9) X(11, 13) X(15, 17) X(1, 2) X(3, 4) X(5, 6)   \
  X(7, 8) X(9, 10) X(11, 12) X(13, 14) X(15, 16) X(17, 18)

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

__device__ __forceinline__ int order_key(float f) {
  int b = __float_as_int(f);
  b = (b & 0x7fffffff) > 0x7f800000 ? 0x7fc00000 : b;
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// one window row: the 5 keys from shared memory, sorted
__device__ __forceinline__ void sorted_row(const int* s, int (&v)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = s[i];
  KB_SORT5(KB_CE)
}

__device__ __forceinline__ void merge_5_5(const int (&a)[5],
                                          const int (&b)[5], int (&v)[10]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    v[i] = a[i];
    v[5 + i] = b[i];
  }
  KB_MERGE_5_5(KB_CE)
}

__device__ __forceinline__ void merge_10_10(const int (&a)[10],
                                            const int (&b)[10],
                                            int (&v)[20]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    v[i] = a[i];
    v[10 + i] = b[i];
  }
  KB_MERGE_10_10(KB_CE)
}

// the 13th of the union of a sorted 20 and a sorted 5 (1-based ranks:
// min over i = 8..13 of max(a_i, b_(13-i)), b_0 = -inf); reads a[7..12]
__device__ __forceinline__ int median_of(const int (&a)[20],
                                         const int (&b)[5]) {
  int m = a[12];
#pragma unroll
  for (int i = 0; i < 5; ++i) m = min(m, max(a[11 - i], b[i]));
  return m;
}

__global__ void __launch_bounds__(TX * TYT)
    median5_kernel(const float* __restrict__ x, int H, int W, int C,
                   float* __restrict__ out) {
  __shared__ int key[TY + 4][SX];
  const int b = blockIdx.z / C, c = blockIdx.z - b * C;
  const long long plane = (long long)b * H * W * C + c;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (C == 1 && (W & 3) == 0 && x0 + TX <= W &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    // the tile's own columns 16 bytes a load, the 2 + 2 halo columns
    // one by one
    for (int i = tid; i < (TY + 4) * (TX / 4); i += TX * TYT) {
      const int ty = i / (TX / 4), q = i - ty * (TX / 4);
      const int sy = reflect_index(min(y0 + ty - 2, H + 1), H);
      const float4 f = *reinterpret_cast<const float4*>(
          x + plane + (long long)sy * W + x0 + 4 * q);
      int* k = &key[ty][2 + 4 * q];
      k[0] = order_key(f.x);
      k[1] = order_key(f.y);
      k[2] = order_key(f.z);
      k[3] = order_key(f.w);
    }
    for (int i = tid; i < (TY + 4) * 4; i += TX * TYT) {
      const int ty = i >> 2, h = i & 3;
      const int tx = h < 2 ? h : TX + h;
      const int sy = reflect_index(min(y0 + ty - 2, H + 1), H);
      const int sx = reflect_index(x0 + tx - 2, W);
      key[ty][tx] = order_key(x[plane + (long long)sy * W + sx]);
    }
  } else {
    for (int i = tid; i < (TY + 4) * SX; i += TX * TYT) {
      const int ty = i / SX, tx = i - ty * SX;
      const int sy = reflect_index(min(y0 + ty - 2, H + 1), H);
      const int sx = reflect_index(min(x0 + tx - 2, W + 1), W);
      key[ty][tx] = order_key(x[plane + ((long long)sy * W + sx) * C]);
    }
  }
  __syncthreads();
  const int tx = threadIdx.x, r0 = threadIdx.y * RUN;
  const int xx = x0 + tx;
  if (xx >= W || y0 + r0 >= H) return;
  // the sorted window rows S0, S1, S2, S3 and M0 = merge(S1, S2); pair
  // p holds lo = S(2p), mid = S(2p+2), s3 = S(2p+3), m0 = M(p)
  int lo[5], s1[5], mid[5], s3[5], s4[5], s5[5], m0[10], m1[10], a[20];
  sorted_row(&key[r0][tx], lo);
  sorted_row(&key[r0 + 1][tx], s1);
  sorted_row(&key[r0 + 2][tx], mid);
  merge_5_5(s1, mid, m0);
  sorted_row(&key[r0 + 3][tx], s3);
  float* o = out + plane + ((long long)(y0 + r0) * W + xx) * C;
  const long long row = (long long)W * C;
#pragma unroll
  for (int p = 0; p < RUN / 2; ++p) {
    sorted_row(&key[r0 + 2 * p + 4][tx], s4);
    sorted_row(&key[r0 + 2 * p + 5][tx], s5);
    merge_5_5(s3, s4, m1);
    merge_10_10(m0, m1, a);
    const int y = y0 + r0 + 2 * p;
    if (y < H) o[2 * p * row] = key_value(median_of(a, lo));
    if (y + 1 < H) o[(2 * p + 1) * row] = key_value(median_of(a, s5));
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      lo[i] = mid[i];
      mid[i] = s4[i];
      s3[i] = s5[i];
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) m0[i] = m1[i];
  }
}

}  // namespace

// x, out (B, H, W, C) f32; H, W >= 3. Returns cudaGetLastError().
extern "C" int kb_median5(const float* x, int B, int H, int W, int C,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * H * W * C > 0)
    median5_kernel<<<dim3((W + TX - 1) / TX, (H + TY - 1) / TY, B * C),
                     dim3(TX, TYT), 0, s>>>(x, H, W, C, out);
  return (int)cudaGetLastError();
}
