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
// Bound on the card: bytes (the frame read once, 3 bytes a pixel of
// BGR and 1.5 of I420 written once). One launch, one thread per 2x2
// block of output pixels: for each of its pixels it computes the four
// bilinear taps of the crop on the fly (each tap the clipped source
// pixel, or the half-pixel mean 0.5*a + 0.5*b of getRectSubPix where
// the crop's corner falls between pixels), repeats torch's CUDA
// bilinear (align_corners=False) for the source index and weights,
// clips, scales and truncates to uint8, and writes BGR; with an I420
// pointer it writes the four Y values and the block's U and V from its
// top-left pixel. The crop, the mean and the uint8 step follow the
// plain version one rounding at a time (built with -fmad=false); the
// bilinear sum may sit an ulp from torch's own kernel, whose build
// contracts it into FMAs, so a rare byte differs by one.
#include "kb_common.cuh"

namespace {

constexpr int kSh = 20, kHalf = 1 << 19;
constexpr int kCRY = 269484, kCGY = 528482, kCBY = 102760;
constexpr int kCRU = -155188, kCGU = -305135, kCBU = 460324;
constexpr int kCGV = -385875, kCBV = -74701;

struct Crop {
  const float* frame;
  long long row_stride;  // floats between rows
  int pix_stride;        // floats between pixels (channels contiguous)
  int iy, ix;            // integer corner of the crop
  bool fy, fx;           // the corner sits half a pixel further
  int crop_h, crop_w, out_h, out_w;
  float rh, rw;          // source pixels per output pixel
};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float3 src3(const Crop& c, int y, int x) {
  const float* p = c.frame + y * c.row_stride + (long long)x * c.pix_stride;
  return make_float3(clip01(p[0]), clip01(p[1]), clip01(p[2]));
}

__device__ __forceinline__ float3 mean3(float3 a, float3 b) {
  return make_float3(0.5f * a.x + 0.5f * b.x, 0.5f * a.y + 0.5f * b.y,
                     0.5f * a.z + 0.5f * b.z);
}

// crop pixel (py, px): rows averaged first, then columns, as the plain
// version's two slices do
__device__ float3 crop3(const Crop& c, int py, int px) {
  const int y = c.iy + py, x = c.ix + px;
  float3 a = src3(c, y, x);
  if (c.fy) a = mean3(a, src3(c, y + 1, x));
  if (c.fx) {
    float3 b = src3(c, y, x + 1);
    if (c.fy) b = mean3(b, src3(c, y + 1, x + 1));
    a = mean3(a, b);
  }
  return a;
}

// torch's area_pixel_compute_source_index (align_corners=False)
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float s = scale * ((float)dst + 0.5f) - 0.5f;
  return s < 0.0f ? 0.0f : s;
}

__device__ float3 out3(const Crop& c, int oy, int ox) {
  if (c.crop_h == c.out_h && c.crop_w == c.out_w) return crop3(c, oy, ox);
  const float h1r = source_index(c.rh, oy);
  const int h1 = (int)h1r;
  const int h1p = h1 < c.crop_h - 1 ? 1 : 0;
  const float h1l = h1r - (float)h1;
  const float h0l = 1.0f - h1l;
  const float w1r = source_index(c.rw, ox);
  const int w1 = (int)w1r;
  const int w1p = w1 < c.crop_w - 1 ? 1 : 0;
  const float w1l = w1r - (float)w1;
  const float w0l = 1.0f - w1l;
  const float3 a = crop3(c, h1, w1), b = crop3(c, h1, w1 + w1p);
  const float3 d = crop3(c, h1 + h1p, w1), e = crop3(c, h1 + h1p, w1 + w1p);
  return make_float3(
      h0l * (w0l * a.x + w1l * b.x) + h1l * (w0l * d.x + w1l * e.x),
      h0l * (w0l * a.y + w1l * b.y) + h1l * (w0l * d.y + w1l * e.y),
      h0l * (w0l * a.z + w1l * b.z) + h1l * (w0l * d.z + w1l * e.z));
}

// clip, x255, +0.5 (two roundings), truncate
__device__ __forceinline__ int to_u8(float v) {
  const float s = clip01(v) * 255.0f;
  return (int)(uint8_t)(s + 0.5f);
}

__global__ void epilogue_kernel(Crop c, uint8_t* __restrict__ bgr,
                                uint8_t* __restrict__ i420) {
  const int bw = (c.out_w + 1) / 2;
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= bw * ((c.out_h + 1) / 2)) return;
  const int y0 = 2 * (blk / bw), x0 = 2 * (blk % bw);
  const int HW = c.out_h * c.out_w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int oy = y0 + (k >> 1), ox = x0 + (k & 1);
    if (oy >= c.out_h || ox >= c.out_w) continue;
    const float3 v = out3(c, oy, ox);
    const int b = to_u8(v.x), g = to_u8(v.y), r = to_u8(v.z);
    const int o = oy * c.out_w + ox;
    bgr[3 * o] = (uint8_t)b;
    bgr[3 * o + 1] = (uint8_t)g;
    bgr[3 * o + 2] = (uint8_t)r;
    if (i420 == nullptr) continue;
    i420[o] = (uint8_t)((kCRY * r + kCGY * g + kCBY * b + (16 << kSh) +
                         kHalf) >> kSh);
    if (k == 0) {
      const int ci = (oy / 2) * (c.out_w / 2) + ox / 2;
      i420[HW + ci] = (uint8_t)((kCRU * r + kCGU * g + kCBU * b +
                                 (128 << kSh) + kHalf) >> kSh);
      i420[HW + HW / 4 + ci] = (uint8_t)((kCBU * r + kCGV * g + kCBV * b +
                                          (128 << kSh) + kHalf) >> kSh);
    }
  }
}

}  // namespace

// frame: (H, W, 3) f32 with the given row and pixel strides (in
// floats; channels contiguous). bgr: (out_h, out_w, 3) u8; i420:
// (out_h * 3/2, out_w) u8 or null (needs out_h % 4 == 0 and out_w % 2
// == 0). The centre crop (crop_h, crop_w) starts at ((H - crop_h + 1)
// / 2, (W - crop_w + 1) / 2). Returns cudaGetLastError().
extern "C" int kb_frame_epilogue(const float* frame, int H, int W,
                                 long long row_stride, int pix_stride,
                                 int crop_h, int crop_w, int out_h,
                                 int out_w, uint8_t* bgr, uint8_t* i420,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Crop c;
  c.frame = frame;
  c.row_stride = row_stride;
  c.pix_stride = pix_stride;
  c.iy = (H - crop_h + 1) / 2;
  c.ix = (W - crop_w + 1) / 2;
  c.fy = (H - crop_h + 1) % 2 != 0;
  c.fx = (W - crop_w + 1) % 2 != 0;
  c.crop_h = crop_h;
  c.crop_w = crop_w;
  c.out_h = out_h;
  c.out_w = out_w;
  // torch: static_cast<float>(input_size) / output_size
  c.rh = (float)crop_h / (float)out_h;
  c.rw = (float)crop_w / (float)out_w;
  const int n = ((out_h + 1) / 2) * ((out_w + 1) / 2);
  if (n > 0)
    epilogue_kernel<<<(n + 255) / 256, 256, 0, s>>>(c, bgr, i420);
  return (int)cudaGetLastError();
}
