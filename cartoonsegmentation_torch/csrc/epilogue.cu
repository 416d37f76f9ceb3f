// K5a: the frame epilogue, from one filled (or blurred) f32 frame to
// its uint8 BGR and, where asked, its I420 planes.
//
// Replaces the tail of the JAX frame loop: cartoonsegmentation_tpu/
// utils/image.py:crop_center_resize (the reference's getRectSubPix +
// resize pair), the clip / x255 / +0.5 / uint8 step of
// pipeline/kenburns.py:975-978, and utils/image.py:bgr_to_i420
// (OpenCV's 20-bit fixed-point BT.601, chroma from the top-left pixel
// of each 2x2 block).
//
// Bound on the card: bytes (the crop's colours, with the extra row or
// column of a half-pixel mean, read once, 3 bytes a pixel of BGR and
// 1.5 of I420 written once; 9.3 MB, 2.8 us at 3.35 TB/s for the
// 558 x 993 crop at 576 x 1024).
// One launch; a block of 32 x 8 threads owns a tile of tile_h x tile_w
// output pixels (8 x 128 unless the crop's scale asks for a smaller
// one: utils/image.py:epilogue_plan, whose shared-memory sum mirrors
// smem_layout below):
//  1. it forms each crop pixel that the tile's bilinear taps reach once,
//     in shared memory: the clipped half-pixel means of getRectSubPix,
//     rows first and then columns as the plain version's two slices
//     do, from the source pixels read straight from global memory
//     (neighbouring threads on neighbouring pixels; a float4 a pixel
//     where the row is 16-byte aligned, the filled buffer's layout);
//  2. each output pixel takes its four taps from those crop pixels
//     with torch's CUDA bilinear (align_corners=False) index and
//     weights, tabulated once a tile row and column; clip, x255, +0.5
//     and truncate; it stores its BGR, Y and (top-left of a 2x2 block)
//     U and V bytes to global memory, neighbouring threads on
//     neighbouring pixels (the L2 merges the bytes of a line).
// Two alternatives measured slower on the H100 (PERF.md): the source
// rows staged in shared memory by 16-byte cp.async before the crop
// pixels are formed, and the tile's bytes staged in shared memory and
// stored as 16-byte rows by a warp a row; so did taller tiles (32 x 64).
// The crop, the mean and the uint8 step follow the plain version one
// rounding at a time (built with -fmad=false); the bilinear sum may
// sit an ulp from torch's own kernel, whose build contracts it into
// FMAs, so a rare byte differs by one.
#include "kb_common.cuh"

namespace {

// a block's threads: kTx columns by kTy rows
constexpr int kTx = 32, kTy = 8;
constexpr int kThreads = kTx * kTy;
constexpr int kSmemMax = 232448;  // ops/_cuda.py:SMEM_BYTES
constexpr int kSh = 20, kHalf = 1 << 19;
constexpr int kCRY = 269484, kCGY = 528482, kCBY = 102760;
constexpr int kCRU = -155188, kCGU = -305135, kCBU = 460324;
constexpr int kCGV = -385875, kCBV = -74701;

// one tabulated row (or column) of a tile: the crop index of the first
// tap relative to the tile's first crop row, the step to the second (0
// at the last crop row), and the two weights
struct Tap {
  int i, p;
  float l0, l1;
};

struct Geo {
  const float* frame;
  long long row_stride;  // floats between rows
  int pix_stride;        // floats between pixels (channels contiguous)
  int iy, ix;            // integer corner of the crop
  int fy, fx;            // the corner sits half a pixel further
  int crop_h, crop_w, out_h, out_w;
  float rh, rw;          // source pixels per output pixel
  int same;              // crop size == output size: no resize
  int tile_h, tile_w;    // output pixels a tile
  int span_w;            // crop columns a tile forms at most
  int off_taps;          // byte offset of the taps in shared memory
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Shared memory of a tile, in bytes: its crop pixels, then its row and
// column taps (utils/image.py:epilogue_smem is the same sum).
inline int smem_layout(Geo& g, int span_h) {
  g.off_taps = round16(12 * span_h * g.span_w);
  return g.off_taps + 16 * (g.tile_h + g.tile_w);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// torch's area_pixel_compute_source_index (align_corners=False)
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float s = scale * ((float)dst + 0.5f) - 0.5f;
  return s < 0.0f ? 0.0f : s;
}

__device__ __forceinline__ Tap make_tap(float scale, int dst, int n_crop,
                                        int first) {
  const float r = source_index(scale, dst);
  const int i = (int)r;
  Tap t;
  t.i = i - first;
  t.p = i < n_crop - 1 ? 1 : 0;
  t.l1 = r - (float)i;
  t.l0 = 1.0f - t.l1;
  return t;
}

// the crop row (or column) of an output row's first tap
__device__ __forceinline__ int first_tap(const Geo& g, float scale,
                                         int dst) {
  return g.same ? dst : (int)source_index(scale, dst);
}

// a row's floats start this far past its 16-byte boundary
__device__ __forceinline__ int row_align(const float* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

__device__ __forceinline__ float3 clipped(const float* p, bool vec) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return make_float3(clip01(v.x), clip01(v.y), clip01(v.z));
  }
  return make_float3(clip01(p[0]), clip01(p[1]), clip01(p[2]));
}

__device__ __forceinline__ float3 mean3(float3 a, float3 b) {
  return make_float3(0.5f * a.x + 0.5f * b.x, 0.5f * a.y + 0.5f * b.y,
                     0.5f * a.z + 0.5f * b.z);
}

// clip, x255, +0.5 (two roundings), truncate
__device__ __forceinline__ int to_u8(float v) {
  const float s = clip01(v) * 255.0f;
  return (int)(uint8_t)(s + 0.5f);
}

__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(Geo g, uint8_t* __restrict__ bgr,
                    uint8_t* __restrict__ i420) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* crop = reinterpret_cast<float*>(smem);
  Tap* rtap = reinterpret_cast<Tap*>(smem + g.off_taps);
  Tap* ctap = rtap + g.tile_h;
  const int tx0 = threadIdx.x, ty0 = threadIdx.y;
  const int oy0 = blockIdx.y * g.tile_h, ox0 = blockIdx.x * g.tile_w;
  const int th = min(g.tile_h, g.out_h - oy0);
  const int tw = min(g.tile_w, g.out_w - ox0);
  // the crop rows r0..r1 and columns c0..c1 that the tile's taps reach
  const int r0 = first_tap(g, g.rh, oy0), c0 = first_tap(g, g.rw, ox0);
  const int r1 = g.same ? oy0 + th - 1
                        : min(first_tap(g, g.rh, oy0 + th - 1) + 1,
                              g.crop_h - 1);
  const int c1 = g.same ? ox0 + tw - 1
                        : min(first_tap(g, g.rw, ox0 + tw - 1) + 1,
                              g.crop_w - 1);
  const int CR = r1 - r0 + 1, CC = c1 - c0 + 1;
  const int ps = g.pix_stride;
  const float* base = g.frame + (long long)(g.iy + r0) * g.row_stride +
                      (long long)(g.ix + c0) * ps;

  // 1. the taps, and the crop pixels, each once
  if (!g.same) {
    for (int t = ty0 * kTx + tx0; t < th + tw; t += kThreads) {
      if (t < th)
        rtap[t] = make_tap(g.rh, oy0 + t, g.crop_h, r0);
      else
        ctap[t - th] = make_tap(g.rw, ox0 + t - th, g.crop_w, c0);
    }
  }
#pragma unroll 4
  for (int py = ty0; py < CR; py += kTy) {
    const float* s0 = base + (long long)py * g.row_stride;
    const float* s1 = s0 + g.row_stride;
    const bool v0 = ps == 4 && row_align(s0) == 0;
    const bool v1 = ps == 4 && row_align(s1) == 0;
    float* c = crop + 3 * py * g.span_w;
    for (int px = tx0; px < CC; px += kTx) {
      const int o = px * ps;
      float3 a = clipped(s0 + o, v0);
      float3 b = make_float3(0.0f, 0.0f, 0.0f);
      if (g.fx) b = clipped(s0 + o + ps, v0);
      if (g.fy) {
        a = mean3(a, clipped(s1 + o, v1));
        if (g.fx) b = mean3(b, clipped(s1 + o + ps, v1));
      }
      if (g.fx) a = mean3(a, b);
      c[3 * px] = a.x;
      c[3 * px + 1] = a.y;
      c[3 * px + 2] = a.z;
    }
  }
  __syncthreads();

  // 2. the output pixels' bytes
  const int HW = g.out_h * g.out_w;
  for (int ty = ty0; ty < th; ty += kTy) {
    const int oy = oy0 + ty, o = oy * g.out_w + ox0;
    Tap rt;
    if (g.same) {
      rt.i = ty;
      rt.p = 0;
    } else {
      rt = rtap[ty];
    }
    const float* A0 = crop + 3 * rt.i * g.span_w;
    const float* A1 = A0 + 3 * rt.p * g.span_w;
    uint8_t* pb = bgr + 3 * o;
    uint8_t* pY = nullptr;
    uint8_t *pU = nullptr, *pV = nullptr;
    if (i420 != nullptr) {
      pY = i420 + o;
      if (!(ty & 1)) {
        // oy0 and ox0 are even: row ty holds the blocks' top-left pixels
        pU = i420 + HW + (oy / 2) * (g.out_w / 2) + ox0 / 2;
        pV = pU + HW / 4;
      }
    }
    for (int tx = tx0; tx < tw; tx += kTx) {
      float3 v;
      if (g.same) {
        const float* a = A0 + 3 * tx;
        v = make_float3(a[0], a[1], a[2]);
      } else {
        const Tap ct = ctap[tx];
        const float* a = A0 + 3 * ct.i;
        const float* b = a + 3 * ct.p;
        const float* d = A1 + 3 * ct.i;
        const float* e = d + 3 * ct.p;
        v = make_float3(
            rt.l0 * (ct.l0 * a[0] + ct.l1 * b[0]) +
                rt.l1 * (ct.l0 * d[0] + ct.l1 * e[0]),
            rt.l0 * (ct.l0 * a[1] + ct.l1 * b[1]) +
                rt.l1 * (ct.l0 * d[1] + ct.l1 * e[1]),
            rt.l0 * (ct.l0 * a[2] + ct.l1 * b[2]) +
                rt.l1 * (ct.l0 * d[2] + ct.l1 * e[2]));
      }
      const int b = to_u8(v.x), gg = to_u8(v.y), r = to_u8(v.z);
      pb[3 * tx] = (uint8_t)b;
      pb[3 * tx + 1] = (uint8_t)gg;
      pb[3 * tx + 2] = (uint8_t)r;
      if (pY == nullptr) continue;
      pY[tx] = (uint8_t)((kCRY * r + kCGY * gg + kCBY * b + (16 << kSh) +
                          kHalf) >> kSh);
      if (pU == nullptr || (tx & 1)) continue;
      pU[tx / 2] = (uint8_t)((kCRU * r + kCGU * gg + kCBU * b +
                              (128 << kSh) + kHalf) >> kSh);
      pV[tx / 2] = (uint8_t)((kCBU * r + kCGV * gg + kCBV * b +
                              (128 << kSh) + kHalf) >> kSh);
    }
  }
}

// shared memory above 48 KB must be asked for once
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// frame: (H, W, 3) f32 with the given row and pixel strides (in
// floats; channels contiguous). bgr: (out_h, out_w, 3) u8; i420:
// (out_h * 3/2, out_w) u8 or null (needs out_h % 4 == 0 and out_w % 2
// == 0). The centre crop (crop_h, crop_w) starts at ((H - crop_h + 1)
// / 2, (W - crop_w + 1) / 2). tile_h x tile_w (even) output pixels a
// block, span_h x span_w the most crop rows and columns a tile's taps
// reach (utils/image.py:epilogue_plan). Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a tile's shared memory exceeds the card's.
extern "C" int kb_frame_epilogue(const float* frame, int H, int W,
                                 long long row_stride, int pix_stride,
                                 int crop_h, int crop_w, int out_h,
                                 int out_w, int tile_h, int tile_w,
                                 int span_h, int span_w, uint8_t* bgr,
                                 uint8_t* i420, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_h <= 0 || out_w <= 0) return (int)cudaGetLastError();
  Geo g;
  g.frame = frame;
  g.row_stride = row_stride;
  g.pix_stride = pix_stride;
  g.iy = (H - crop_h + 1) / 2;
  g.ix = (W - crop_w + 1) / 2;
  g.fy = (H - crop_h + 1) % 2;
  g.fx = (W - crop_w + 1) % 2;
  g.crop_h = crop_h;
  g.crop_w = crop_w;
  g.out_h = out_h;
  g.out_w = out_w;
  // torch: static_cast<float>(input_size) / output_size
  g.rh = (float)crop_h / (float)out_h;
  g.rw = (float)crop_w / (float)out_w;
  g.same = crop_h == out_h && crop_w == out_w;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.span_w = span_w;
  const int smem = smem_layout(g, span_h);
  if (smem > kSmemMax || tile_h < 2 || tile_w < 2 || (tile_h | tile_w) & 1)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((out_w + tile_w - 1) / tile_w,
                  (out_h + tile_h - 1) / tile_h);
  epilogue_kernel<<<grid, dim3(kTx, kTy), smem, s>>>(g, bgr, i420);
  return (int)cudaGetLastError();
}
