// K12b: one mean-field step of the binary dense CRF (or its norm pass).
//
// Replaces the loop body of cartoonsegmentation_tpu/ops/crf.py:
// densecrf_binary (:128-136) with clustered_bilateral (:77-91),
// _wide_blur (:41-52) and _blur2d (:25-38):
//   m_gauss = (blur5(q) - q) / gauss_norm
//   m_bilat = (bilat(q) - q) / bilat_norm
//   q' = softmax(-unary - swap(3 m_gauss + 40 m_bilat))
// where bilat(q) at a pixel of colour cluster c is the wide blur of
// q * 1[label = c]: a sum pool onto a lattice of s x s cells, an
// unnormalised Gaussian of radius R there (zero padding), and JAX's
// linear upsample (half-pixel centres, border weights renormalised)
// back to the pixel. The norm pass computes gauss_norm and bilat_norm
// the same way from q = 1 (one channel): blur - 1, as the JAX version
// runs under jit (XLA folds its "- 1 + 1e-8" into "+ (1e-8 - 1)",
// which is -1 in f32), and raises a flag where a norm is 0: there the
// JAX version divides by zero and its NaN empties the whole mask from
// the second step on, so a step writes an empty mask where it is set.
//
// Bound on the card (chip_smoke.py's bound()): bytes, 37 B a pixel
// for a step (q 8, the labels 4, the unary 8 and the norms 8 read once,
// q' 8 and the mask 1 written once; 21.8 MB at 576 x 1024, 6.5 us at
// 3.35 TB/s), against ~0.12 G f32 operations (the 5 x 5 Gaussian, the
// two-tap upsample and the messages per pixel and channel, the
// softmax per pixel, the pool and the 9 x 9 blur on the lattice; 1.8
// us at 67 TFLOP/s). Three kernels a step, each the plain version's
// arithmetic in its order (built with -fmad=false):
//  1. pool: one thread per (cluster, channel, lattice cell) sums its
//     cell down each column, then across (the plain _pool_sum order);
//     all K clusters are pooled at once, where the JAX version loops;
//  2. lattice blur: one thread per (cluster, channel, cell), rows then
//     columns of the separable taps (the plain _blur2d order);
//  3. pixel: one thread per pixel samples its own cluster's blurred
//     lattice with the row and column upsample taps (rows first), adds
//     the 5 x 5 Gaussian of q from global memory (L1-cached), and
//     writes q' and the mask q1 > q0 (empty where the flag is set).
#include "kb_common.cuh"

namespace {

constexpr int kGaussR = 2;      // GAUSS_RADIUS
constexpr int kMaxRadius = 15;  // CRF_MAX_RADIUS

__global__ void pool_kernel(const float* __restrict__ q,
                            const int* __restrict__ labels, int H, int W,
                            int K, int C, int s, int gh, int gw,
                            float* __restrict__ pooled) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const int planes = K * C;
  if (cell >= planes * gh * gw) return;
  const int plane = cell / (gh * gw), rem = cell % (gh * gw);
  const int c = plane / C, ch = plane % C;
  const int gy = rem / gw, gx = rem % gw;
  const int y0 = gy * s, x0 = gx * s;
  float out = 0.0f;
  for (int dx = 0; dx < s; ++dx) {
    const int x = x0 + dx;
    float col = 0.0f;
    if (x < W) {
      for (int dy = 0; dy < s; ++dy) {
        const int y = y0 + dy;
        if (y >= H) break;
        const long long p = (long long)y * W + x;
        const float v = labels[p] == c ? (q ? q[p * C + ch] : 1.0f) : 0.0f;
        col = dy == 0 ? v : col + v;
      }
    }
    out = dx == 0 ? col : out + col;
  }
  pooled[cell] = out;
}

// Separable blur of one lattice plane at (gy, gx): for each column tap
// j the row sum over taps i, then the column sum, each from 0 in tap
// order; taps over the border add 0 (the zero padding).
__global__ void blur_kernel(const float* __restrict__ pooled, int planes,
                            int gh, int gw, int R,
                            const float* __restrict__ taps,
                            float* __restrict__ blurred) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= planes * gh * gw) return;
  const int plane = cell / (gh * gw), rem = cell % (gh * gw);
  const int gy = rem / gw, gx = rem % gw;
  const float* src = pooled + (long long)plane * gh * gw;
  float k[2 * kMaxRadius + 1];
  for (int i = 0; i <= 2 * R; ++i) k[i] = __ldg(taps + i);
  float out2 = 0.0f;
  for (int j = 0; j <= 2 * R; ++j) {
    const int x = gx + j - R;
    float out1 = 0.0f;
    if (x >= 0 && x < gw) {
      for (int i = 0; i <= 2 * R; ++i) {
        const int y = gy + i - R;
        const float v = (y >= 0 && y < gh) ? src[y * gw + x] : 0.0f;
        out1 = out1 + k[i] * v;
      }
    }
    out2 = out2 + k[j] * out1;
  }
  blurred[cell] = out2;
}

struct PixelArgs {
  const float* q;  // (H, W, 2), or null for the norm pass (q = 1)
  const int* labels;
  const float* unary;  // (H, W, 2)
  float* norms;        // (H, W, 2): written by the norm pass, else read
  int* dead;           // set by the norm pass where a norm is 0
  int H, W, C, gh, gw;
  const float* g5;                        // 2 kGaussR + 1 taps
  const int* ri;                          // (H,) row upsample tap
  const float* rw;                        // (H, 2)
  const int* ci;                          // (W,)
  const float* cw;                        // (W, 2)
  const float* blurred;                   // (K C, gh, gw)
  float gauss_compat, bilat_compat;
  float* q_out;                           // (H, W, 2)
  unsigned char* mask;                    // (H, W) or null
};

__device__ __forceinline__ float qval(const PixelArgs& a, int y, int x,
                                      int ch) {
  if (y < 0 || y >= a.H || x < 0 || x >= a.W) return 0.0f;
  return a.q ? a.q[((long long)y * a.W + x) * 2 + ch] : 1.0f;
}

__global__ void pixel_kernel(PixelArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const long long p = (long long)y * a.W + x;
  float g5[2 * kGaussR + 1];
  for (int i = 0; i <= 2 * kGaussR; ++i) g5[i] = __ldg(a.g5 + i);
  const int lbl = a.labels[p];
  const int iy0 = a.ri[y], iy1 = min(iy0 + 1, a.gh - 1);
  const int jx0 = a.ci[x], jx1 = min(jx0 + 1, a.gw - 1);
  const float wy0 = a.rw[2 * y], wy1 = a.rw[2 * y + 1];
  const float wx0 = a.cw[2 * x], wx1 = a.cw[2 * x + 1];
  float gauss[2], bilat[2];
  for (int ch = 0; ch < a.C; ++ch) {
    const float* B = a.blurred + (long long)(lbl * a.C + ch) * a.gh * a.gw;
    const float t0 = wy0 * B[iy0 * a.gw + jx0] + wy1 * B[iy1 * a.gw + jx0];
    const float t1 = wy0 * B[iy0 * a.gw + jx1] + wy1 * B[iy1 * a.gw + jx1];
    bilat[ch] = wx0 * t0 + wx1 * t1;
    float out2 = 0.0f;
    for (int j = 0; j <= 2 * kGaussR; ++j) {
      const int xx = x + j - kGaussR;
      float out1 = 0.0f;
      if (xx >= 0 && xx < a.W) {
        for (int i = 0; i <= 2 * kGaussR; ++i)
          out1 = out1 + g5[i] * qval(a, y + i - kGaussR, xx, ch);
      }
      out2 = out2 + g5[j] * out1;
    }
    gauss[ch] = out2;
  }
  if (!a.q) {
    const float gn = gauss[0] - 1.0f, bn = bilat[0] - 1.0f;
    a.norms[2 * p] = gn;
    a.norms[2 * p + 1] = bn;
    if (gn == 0.0f || bn == 0.0f) atomicOr(a.dead, 1);
    return;
  }
  const float gn = a.norms[2 * p], bn = a.norms[2 * p + 1];
  float msg[2];
  for (int ch = 0; ch < 2; ++ch) {
    const float qc = a.q[2 * p + ch];
    const float mg = (gauss[ch] - qc) / gn;
    const float mb = (bilat[ch] - qc) / bn;
    msg[ch] = a.gauss_compat * mg + a.bilat_compat * mb;
  }
  // Potts: each label is penalised by the other label's message
  const float a0 = -a.unary[2 * p] - msg[1];
  const float a1 = -a.unary[2 * p + 1] - msg[0];
  const float m = fmaxf(a0, a1);
  const float e0 = expf(a0 - m), e1 = expf(a1 - m);
  const float sum = e0 + e1;
  const float q0 = e0 / sum, q1 = e1 / sum;
  a.q_out[2 * p] = q0;
  a.q_out[2 * p + 1] = q1;
  if (a.mask) a.mask[p] = (q1 > q0 && *a.dead == 0) ? 1 : 0;
}

}  // namespace

// q: (H, W, 2) f32, or null for the norm pass; labels: (H, W) int32 in
// [0, K); unary: (H, W, 2) f32 (-log(1 - p), -log p), unused by the
// norm pass; norms: (H, W, 2) f32, written by the norm pass, read by a
// step; dead: one int32, zeroed before the norm pass, which sets it
// where a norm is 0, read by a step that writes a mask; s, gh, gw, R:
// the lattice (cells of s pixels, gh x gw cells, blur radius R <= 15);
// g5: 5 Gaussian taps; glat: 2R + 1 lattice taps; ri/rw, ci/cw: the
// upsample's row and column taps (index, 2 weights); pooled, blurred:
// (2K, gh, gw) f32 scratch; q_out: (H, W, 2) f32; mask: (H, W) uint8
// or null. Returns cudaGetLastError().
extern "C" int kb_crf_step(const float* q, const int* labels,
                           const float* unary, float* norms, int* dead,
                           int H, int W,
                           int K, int s, int gh, int gw, int R,
                           const float* g5, const float* glat, const int* ri,
                           const float* rw, const int* ci, const float* cw,
                           float gauss_compat, float bilat_compat,
                           float* pooled, float* blurred, float* q_out,
                           unsigned char* mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (R > kMaxRadius || R < 0 || K < 1) return (int)cudaErrorInvalidValue;
  const int C = q ? 2 : 1;
  const int cells = K * C * gh * gw;
  const int threads = 256;
  pool_kernel<<<(cells + threads - 1) / threads, threads, 0, st>>>(
      q, labels, H, W, K, C, s, gh, gw, pooled);
  blur_kernel<<<(cells + threads - 1) / threads, threads, 0, st>>>(
      pooled, K * C, gh, gw, R, glat, blurred);
  PixelArgs a{q,       labels,       unary,        norms, dead, H,
              W,       C,            gh,           gw,    g5,   ri,
              rw,      ci,           cw,           blurred,
              gauss_compat, bilat_compat, q_out, mask};
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  pixel_kernel<<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}
