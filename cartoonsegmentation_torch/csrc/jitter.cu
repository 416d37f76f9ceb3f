// K13b: the jitter refine of the style flow's background fill.
//
// Replaces cartoonsegmentation_tpu/ops/inpaint_fill.py:jitter_refine.
//
// image (H, W, 3) f32, hole (H, W) bool, offsets (iters, 4, 2, H, W)
// int32 (the radii 4, 8, 16, 32; a dy plane and a dx plane each,
// drawn on the host). One launch an iteration and one thread a pixel;
// an iteration reads the whole image of the one before, so two buffers
// take turns and the last iteration writes the output.
//
// A hole pixel builds its 8-neighbour ring (edges replicated) from the
// current image, then walks the radii in order: the offset's source,
// clamped to the frame, is skipped when it is a hole pixel; otherwise
// its ring scores the SSD against the pixel's own, summed tap by tap,
// channel by channel as the plain version does, and a strictly lower
// cost wins, so an earlier radius keeps a tie. A hole pixel with a
// finite best cost takes the winner's colour; every other pixel keeps
// its own. Bound by bytes: the image, hole and result, the offsets of
// the hole pixels (32 B a hole pixel an iteration) and the buffer
// between iterations; the rings are re-read through L1/L2.
#include "kb_common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int NRAD = 4;

__global__ void jitter_kernel(const float* __restrict__ cur,
                              const unsigned char* __restrict__ hole,
                              const int* __restrict__ off, int H, int W,
                              float* __restrict__ nxt) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= H * W) return;
  float b0 = cur[3 * i], b1 = cur[3 * i + 1], b2 = cur[3 * i + 2];
  if (hole[i]) {
    const int y = i / W, x = i - y * W;
    float ring[8][3];
    int t = 0;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int sy = min(max(y + dy, 0), H - 1);
        const int sx = min(max(x + dx, 0), W - 1);
        const float* p = cur + 3 * ((long long)sy * W + sx);
        ring[t][0] = p[0];
        ring[t][1] = p[1];
        ring[t][2] = p[2];
        ++t;
      }
    const long long plane = (long long)H * W;
    float best = INFINITY;
    for (int r = 0; r < NRAD; ++r) {
      const int qy = min(max(y + off[(2 * r) * plane + i], 0), H - 1);
      const int qx = min(max(x + off[(2 * r + 1) * plane + i], 0), W - 1);
      const long long q = (long long)qy * W + qx;
      if (hole[q]) continue;
      float cost = 0.0f;
      int k = 0;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const int sy = min(max(qy + dy, 0), H - 1);
          const int sx = min(max(qx + dx, 0), W - 1);
          const float* p = cur + 3 * ((long long)sy * W + sx);
          for (int c = 0; c < 3; ++c) {
            const float d = p[c] - ring[k][c];
            cost = cost + d * d;
          }
          ++k;
        }
      if (cost < best) {
        best = cost;
        b0 = cur[3 * q];
        b1 = cur[3 * q + 1];
        b2 = cur[3 * q + 2];
      }
    }
    if (!isfinite(best)) {
      b0 = cur[3 * i];
      b1 = cur[3 * i + 1];
      b2 = cur[3 * i + 2];
    }
  }
  nxt[3 * i] = b0;
  nxt[3 * i + 1] = b1;
  nxt[3 * i + 2] = b2;
}

}  // namespace

// image, scratch, out (H, W, 3) f32; hole (H, W) bool; offsets
// (iters, 4, 2, H, W) int32. scratch may be out when iters <= 1.
// Returns cudaGetLastError().
extern "C" int kb_jitter(const float* image, const unsigned char* hole,
                         const int* offsets, int H, int W, int iters,
                         float* scratch, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)H * W;
  if (n == 0) return (int)cudaGetLastError();
  if (iters <= 0) {
    cudaMemcpyAsync(out, image, 3 * n * sizeof(float),
                    cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
  }
  const float* src = image;
  for (int it = 0; it < iters; ++it) {
    float* dst = ((iters - 1 - it) % 2 == 0) ? out : scratch;
    jitter_kernel<<<(int)((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        src, hole, offsets + (long long)it * NRAD * 2 * n, H, W, dst);
    src = dst;
  }
  return (int)cudaGetLastError();
}
