// K4: three-pass hexagonal bokeh (depth of field).
//
// Replaces cartoonsegmentation_tpu/ops/bokeh.py:_bokeh_core (spec:
// _bokeh_pass_gather, :31-54), the TPU re-design of the reference's
// kernel_bokeh RawKernel.
//
//   hi   = pow(max(img, 0), lightness)
//   vert = pass(hi,   vertical)
//   diag = pass(vert, -30 deg)
//   rhom = pass(diag, -150 deg)
//   out  = pow((diag + rhom) / 2, 1 / lightness)
// pass(src): per pixel, S samples at offsets cround(w·coef_s) where w
// is the (clipped) weight at the pixel; each in-frame sample adds
// w(sample)·src(sample); out = sum / max(wsum, 1e-30), or src where
// wsum == 0. coef_s = f32(double(dir)·m·min(H, W)) with m = s - S/2,
// computed on the host exactly as _bokeh_core's tables are.
//
// Bound on the card: operations. 3 passes x S = 32 samples per pixel,
// each sample two offset roundings, a bounds test and 7 adds and
// multiplies; every sample lies within the pass's halo of the pixel
// (|offset| <= cround(5e-4·max|coef|): 5 px at 576x1024).
// Design: one launch per pass on the caller's stream, a block of 512
// threads per 32x16 output tile, a thread per pixel. The block first
// copies its tile plus the pass's halo (ops/bokeh.py:_halo, from the
// coefficient table) into shared memory as (r, g, b, clipped weight)
// float4s, so each sample is one 16-byte shared load; pass 1 applies
// the highlight pow as it loads (once per loaded pixel, not per
// sample), pass 3 fuses the mean and the inverse pow. The offset
// rounding uses float adds and integer ops only (no conversion
// instructions, which issue at a quarter of the add rate). At S = 32 a
// pixel whose halo lies in frame rounds the 16 offsets of one side and
// negates them for the other. Where a tile and its halo outgrow a
// block's shared memory (a short side from ~9,400 px at S = 32, ~4,700
// at S = 64), the wrapper takes the global path: a pre-pass stores hi
// in `out`, and the same passes read their samples from global memory.
// Each pixel sums its samples in order s = 0..S-1 in f32 on either
// path, so the two paths give the same bits.
#include "kb_common.cuh"

#define KB_MAX_SAMPLES 64
#define KB_SCALE 0.0005f
#define TILE_W 32
#define TILE_H 16

namespace {

struct PassCoefs {
  float x[KB_MAX_SAMPLES];
  float y[KB_MAX_SAMPLES];
};

// C round() (half away from zero) of v to int, for |v| < 2^22:
// floor(|v| + 0.5) with v's sign. 2^23 + x rounds x to the nearest
// integer (the spacing there is 1); one down where that rounded up.
__device__ __forceinline__ int cround(float v) {
  float x = fabsf(v) + 0.5f;
  float y = x + 8388608.0f;
  int n = __float_as_int(y) - 0x4B000000;
  n -= (y - 8388608.0f) > x ? 1 : 0;
  return v < 0.0f ? -n : n;
}

__device__ __forceinline__ float clipw(float w) {
  return fminf(fmaxf(w, 0.0f), KB_SCALE);
}

__global__ void hi_kernel(const float* __restrict__ img, long long n,
                          float lf, float* __restrict__ hi) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) hi[i] = powf(fmaxf(img[i], 0.0f), lf);
}

// MODE 0: src is the raw image, read through pow(max(., 0), lf) as the
// tile loads (TILED only); 1: plain pass; 2: last pass, out =
// pow((src + pass) / 2, 1 / lf). TILED: samples from the block's
// shared tile with a halo of (hx, hy); else from global memory.
// 3 blocks an SM: 42 registers a thread at most (ptxas takes 43
// unbounded, which leaves room for 2)
template <int MODE, bool TILED>
__global__ void __launch_bounds__(TILE_W * TILE_H, 3)
    pass_kernel(const float* __restrict__ src,
                const float* __restrict__ weight, int H, int W, int S,
                PassCoefs coefs, int hx, int hy, float lf, float inv_lf,
                float* __restrict__ out) {
  // an x halo of 0 (the vertical pass) means every x offset is 0
  const bool zx = hx == 0;
  extern __shared__ float4 tile[];
  const int tw = TILE_W + 2 * hx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  if (TILED) {
    const int n = tw * (TILE_H + 2 * hy);
    for (int q = threadIdx.y * TILE_W + threadIdx.x; q < n;
         q += TILE_W * TILE_H) {
      int ly = q / tw;
      int gx = x0 - hx + (q - ly * tw), gy = y0 - hy + ly;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
        long long g = (long long)gy * W + gx;
        v.x = src[3 * g];
        v.y = src[3 * g + 1];
        v.z = src[3 * g + 2];
        if (MODE == 0) {
          v.x = powf(fmaxf(v.x, 0.0f), lf);
          v.y = powf(fmaxf(v.y, 0.0f), lf);
          v.z = powf(fmaxf(v.z, 0.0f), lf);
        }
        v.w = clipw(weight[g]);
      }
      tile[q] = v;
    }
    __syncthreads();
  }
  // the sample at pixel (qx, qy), as (r, g, b, clipped weight)
  auto fetch = [&](int qx, int qy) -> float4 {
    if (TILED) return tile[(qy - y0 + hy) * tw + (qx - x0 + hx)];
    long long g = (long long)qy * W + qx;
    return make_float4(src[3 * g], src[3 * g + 1], src[3 * g + 2],
                       clipw(weight[g]));
  };
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float4 p = fetch(x, y);
  const float d = p.w;
  float wsum = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  auto add = [&](const float4& q) {
    wsum = wsum + q.w;
    c0 = c0 + q.w * q.x;
    c1 = c1 + q.w * q.y;
    c2 = c2 + q.w * q.z;
  };
  if (TILED && S == 32 && x >= hx && x + hx < W && y >= hy &&
      y + hy < H) {
    // S = 32 with the whole halo in frame: no bounds tests, and the
    // offsets of m = 1..15 are those of m = -1..-15 negated (the
    // table's coefficients are, exactly, and so is d·coef), so 16
    // offsets are rounded, not 32; the samples still add in order
    // s = 0..31 (m = -16..15, m = 0 at offset 0)
    const float4* c = tile + (threadIdx.y + hy) * tw + threadIdx.x + hx;
    int off[17];
    if (zx) {
#pragma unroll
      for (int j = 1; j <= 16; ++j)
        off[j] = cround(d * coefs.y[16 - j]) * tw;
    } else {
#pragma unroll
      for (int j = 1; j <= 16; ++j)
        off[j] = cround(d * coefs.y[16 - j]) * tw +
                 cround(d * coefs.x[16 - j]);
    }
#pragma unroll
    for (int s = 0; s < 32; ++s)
      add(c[s < 16 ? off[16 - s] : s == 16 ? 0 : -off[s - 16]]);
  } else {
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      int qx = x + cround(d * coefs.x[s]);
      int qy = y + cround(d * coefs.y[s]);
      if (qx < 0 || qx >= W || qy < 0 || qy >= H) continue;
      add(fetch(qx, qy));
    }
  }
  float r0 = p.x, r1 = p.y, r2 = p.z;
  if (wsum != 0.0f) {
    float den = fmaxf(wsum, 1e-30f);
    r0 = c0 / den;
    r1 = c1 / den;
    r2 = c2 / den;
  }
  if (MODE == 2) {
    r0 = powf((p.x + r0) / 2.0f, inv_lf);
    r1 = powf((p.y + r1) / 2.0f, inv_lf);
    r2 = powf((p.z + r2) / 2.0f, inv_lf);
  }
  long long i = (long long)y * W + x;
  out[3 * i] = r0;
  out[3 * i + 1] = r1;
  out[3 * i + 2] = r2;
}

// shared memory above 48 KB must be asked for once per kernel
template <int MODE>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      pass_kernel<MODE, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// img (H,W,3) and weight (H,W) f32; coef_host: host array of 6·S
// floats, [pass][x|y][sample] for the passes vertical, -30, -150 deg;
// halo_host: 6 ints, [pass][x|y], the largest |offset| a pass can
// take (ops/bokeh.py:_halo); tiled: 1 for the shared-memory tiles
// (the wrapper checked that each pass's tile and halo fit), 0 for
// the global path. vert and diag (H,W,3) are scratch, out (H,W,3) the
// result. Returns cudaGetLastError(), or cudaErrorInvalidValue for S
// outside 1..64.
extern "C" int kb_bokeh(const float* img, const float* weight, int H,
                        int W, int S, const float* coef_host,
                        const int* halo_host, int tiled, float lf,
                        float inv_lf, float* vert, float* diag, float* out,
                        void* stream) {
  if (S < 1 || S > KB_MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  PassCoefs coefs[3];
  for (int p = 0; p < 3; ++p) {
    for (int s = 0; s < S; ++s) {
      coefs[p].x[s] = coef_host[(2 * p) * S + s];
      coefs[p].y[s] = coef_host[(2 * p + 1) * S + s];
    }
  }
  if ((long long)H * W == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  dim3 block(TILE_W, TILE_H);
  if (tiled) {
    cudaError_t e = allow_smem<0>();
    if (e == cudaSuccess) e = allow_smem<1>();
    if (e == cudaSuccess) e = allow_smem<2>();
    if (e != cudaSuccess) return (int)e;
    size_t sm[3];
    for (int p = 0; p < 3; ++p)
      sm[p] = sizeof(float4) * (TILE_W + 2 * halo_host[2 * p]) *
              (TILE_H + 2 * halo_host[2 * p + 1]);
    pass_kernel<0, true><<<grid, block, sm[0], st>>>(
        img, weight, H, W, S, coefs[0], halo_host[0], halo_host[1], lf,
        inv_lf, vert);
    pass_kernel<1, true><<<grid, block, sm[1], st>>>(
        vert, weight, H, W, S, coefs[1], halo_host[2], halo_host[3], lf,
        inv_lf, diag);
    pass_kernel<2, true><<<grid, block, sm[2], st>>>(
        diag, weight, H, W, S, coefs[2], halo_host[4], halo_host[5], lf,
        inv_lf, out);
  } else {
    // hi goes to `out`, which the last pass alone writes
    long long n = 3LL * H * W;
    hi_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(img, n, lf, out);
    pass_kernel<1, false><<<grid, block, 0, st>>>(
        out, weight, H, W, S, coefs[0], 0, 0, lf, inv_lf, vert);
    pass_kernel<1, false><<<grid, block, 0, st>>>(
        vert, weight, H, W, S, coefs[1], 0, 0, lf, inv_lf, diag);
    pass_kernel<2, false><<<grid, block, 0, st>>>(
        diag, weight, H, W, S, coefs[2], 0, 0, lf, inv_lf, out);
  }
  return (int)cudaGetLastError();
}
