"""Image resize / crop / colour-pack utilities (PyTorch port of
``cartoonsegmentation_tpu/utils/image.py``).

Host-side planning (numpy) decides shapes; tensor functions keep the
JAX package's channel-last layout (..., H, W, C) at their interface
and run on whatever device their input lives on. cv2 is optional: it
is imported lazily and only where a host-side call needs it.

K5a ``frame_epilogue`` (the frame loop's crop, resize, uint8 and I420
tail) runs ``frame_epilogue_plain`` for CPU tensors and
``csrc/epilogue.cu`` for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _cuda


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


# ---------------------------------------------------------------------------
# host-side (numpy)
# ---------------------------------------------------------------------------

def scaledown_size(h: int, w: int, max_size: int,
                   divisor: Optional[int] = None) -> Tuple[int, int]:
    """Target (h, w) after scaling the long side down to ``max_size``.
    Never upscales."""
    ratio = max_size / max(h, w)
    if ratio < 1:
        if h > w:
            h, w = max_size, max(1, int(round(w * ratio)))
        else:
            h, w = max(1, int(round(h * ratio))), max_size
    if divisor is not None:
        h = int(np.ceil(h / divisor) * divisor)
        w = int(np.ceil(w / divisor) * divisor)
    return h, w


def scaledown_maxsize(img: np.ndarray, max_size: int,
                      divisor: Optional[int] = None) -> np.ndarray:
    """Scale an HWC image so its long side is <= max_size (linear).
    uint8 images go through ``resize_linear_u8`` (cv2.INTER_LINEAR's
    bytes, with or without cv2); other dtypes through cv2 where present,
    else a plain bilinear resize in torch."""
    h0, w0 = img.shape[:2]
    h, w = scaledown_size(h0, w0, max_size, divisor)
    if (h, w) == (h0, w0):
        return img
    if img.dtype == np.uint8:
        return resize_linear_u8(img, h, w)
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    out = resize_bilinear(x if x.ndim == 3 else x[..., None], h, w)
    out = out if img.ndim == 3 else out[..., 0]
    return out.numpy().astype(img.dtype)


def resize_pad(img: np.ndarray, tgt_size: int, pad_value=0):
    """Scale the long side down to tgt_size, pad bottom/right to a
    square. Returns (img, (pad_top, pad_bottom, pad_left, pad_right))."""
    img = scaledown_maxsize(img, tgt_size)
    h, w = img.shape[:2]
    padb, padr = tgt_size - h, tgt_size - w
    if padb > 0 or padr > 0:
        pad_width = [(0, padb), (0, padr)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad_width, constant_values=pad_value)
    return img, (0, padb, 0, padr)


def square_pad_resize(img: np.ndarray, tgt_size: int, pad_value: int = 114):
    """Pad bottom/right to a square (at least tgt_size), then shrink to
    (tgt_size, tgt_size) with cv2's INTER_AREA (a bilinear resize with
    antialias without cv2). Returns (img, scale, pad_h, pad_w)."""
    h, w = img.shape[:2]
    pad_h, pad_w = 0, 0
    if w < h:
        pad_w = h - w
        w += pad_w
    elif h < w:
        pad_h = w - h
        h += pad_h
    pad_size = tgt_size - h
    if pad_size > 0:
        pad_h += pad_size
        pad_w += pad_size
    if pad_h > 0 or pad_w > 0:
        pad_width = [(0, pad_h), (0, pad_w)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad_width, constant_values=pad_value)
    scale = tgt_size / img.shape[0]
    if scale < 1:
        cv2 = _cv2()
        if cv2 is not None:
            img = cv2.resize(img, (tgt_size, tgt_size),
                             interpolation=cv2.INTER_AREA)
        else:
            x = torch.from_numpy(np.ascontiguousarray(img)).float()
            x = x if x.ndim == 3 else x[..., None]
            out = resize_bilinear_aa(x, tgt_size, tgt_size)
            out = out if img.ndim == 3 else out[..., 0]
            img = out.numpy().astype(img.dtype)
    return img, scale, pad_h, pad_w


def pad2divisor(img: np.ndarray, divisor: int, value=0):
    """Pad bottom/right up to multiples of ``divisor``. Returns (img,
    (pad_h, pad_w))."""
    h, w = img.shape[:2]
    pad_h = int(np.ceil(h / divisor)) * divisor - h
    pad_w = int(np.ceil(w / divisor)) * divisor - w
    if pad_h or pad_w:
        pad_width = [(0, pad_h), (0, pad_w)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad_width, constant_values=value)
    return img, (pad_h, pad_w)


def to_float_chw(img: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 HWC in [0, 1] (the layout stays channel-last,
    as in the JAX package, despite the name)."""
    return img.astype(np.float32) / 255.0


# OpenCV's fixed-point linear resize of 8-bit images (imgproc/resize.cpp)
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _cv2_linear_taps(n_in: int, n_out: int, columns: bool):
    """Source indices and 11-bit weights of one axis, as cv::resize
    computes them: the scale 1/(out/in) and the source coordinate
    (i + 0.5)·scale − 0.5 in double, cast to float; each weight rounded
    to nearest even on its own. Columns past an edge take the edge
    pixel with weight 1; rows keep their weights and clip the two
    source rows into the image."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if columns:
        lo, hi = s < 0, s >= n_in - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = n_in - 1
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    a1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            a0.astype(np.int32), a1.astype(np.int32))


def resize_linear_u8(img, h: int, w: int):
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for uint8
    HW or HWC images, byte for byte, in integer torch arithmetic (a
    numpy input gives a numpy result). The horizontal pass sums
    src·alpha in int32; the vertical pass is OpenCV's
    ((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16) + 2) >> 2. Exactly
    2x down on both axes OpenCV takes its area path, the rounded mean
    of each 2x2 block, and so does this."""
    as_numpy = isinstance(img, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    if x.dtype != torch.uint8:
        raise TypeError(f'resize_linear_u8 takes uint8, got {x.dtype}')
    H, W = x.shape[:2]
    x = x.to(torch.int32)
    if (H, W) == (2 * h, 2 * w):
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
               + x[1::2, 1::2] + 2) >> 2
    else:
        dev = x.device
        xs0, xs1, a0, a1 = (torch.from_numpy(t).to(dev)
                            for t in _cv2_linear_taps(W, w, True))
        ys0, ys1, b0, b1 = (torch.from_numpy(t).to(dev)
                            for t in _cv2_linear_taps(H, h, False))
        extra = (None,) * (x.ndim - 2)
        ax0, ax1 = a0[(slice(None),) + extra], a1[(slice(None),) + extra]
        rows = x.index_select(1, xs0) * ax0 + x.index_select(1, xs1) * ax1
        by0 = b0[(slice(None), None) + extra]
        by1 = b1[(slice(None), None) + extra]
        r0 = rows.index_select(0, ys0) >> 4
        r1 = rows.index_select(0, ys1) >> 4
        out = (((by0 * r0) >> 16) + ((by1 * r1) >> 16) + 2) >> 2
    out = out.to(torch.uint8)
    return out.numpy() if as_numpy else out


# ---------------------------------------------------------------------------
# tensor side, channel-last
# ---------------------------------------------------------------------------

def _as_nchw(x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    """(..., H, W, C) → (N, C, H, W) and the leading shape."""
    lead = tuple(x.shape[:-3])
    H, W, C = x.shape[-3:]
    return x.reshape((-1, H, W, C)).permute(0, 3, 1, 2), lead


def _from_nchw(y: torch.Tensor, lead: tuple) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(lead + tuple(y.shape[2:]) +
                                         (y.shape[1],))


def _interp(x: torch.Tensor, h: int, w: int, **kw) -> torch.Tensor:
    y, lead = _as_nchw(x)
    y = F.interpolate(y, size=(h, w), mode='bilinear', **kw)
    return _from_nchw(y, lead).contiguous()


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain bilinear resize (half-pixel centres, no antialias) of
    (..., H, W, C) to (..., h, w, C) — ``jax.image.resize(...,
    antialias=False)``."""
    return _interp(x, h, w, align_corners=False)


def resize_bilinear_aa(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize whose triangle widens on minification — the
    counterpart of ``jax.image.resize(..., 'linear')`` with its default
    antialias. Both place a triangle of width 2·in/out at the same
    centres and normalise its weights; the tests bound how far the
    two implementations' taps differ."""
    return _interp(x, h, w, align_corners=False, antialias=True)


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True semantics."""
    return _interp(x, h, w, align_corners=True)


def resize_cubic_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., 'cubic')`` of an (N, C, H, W) tensor: Keys'
    cubic with a = -0.5 at half-pixel centres, widened on minification
    with its weights normalised (antialias). F.interpolate's antialiased
    bicubic is that kernel (its plain bicubic is a = -0.75); the tests
    hold it against JAX."""
    return F.interpolate(x, size=(h, w), mode='bicubic', align_corners=False,
                         antialias=True)


def resize_cubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``resize_cubic_nchw`` of a channel-last (..., H, W, C) tensor."""
    y, lead = _as_nchw(x)
    return _from_nchw(resize_cubic_nchw(y, h, w), lead).contiguous()


def crop_center_resize(frame: torch.Tensor, crop_h: int, crop_w: int,
                       out_h: int, out_w: int) -> torch.Tensor:
    """Centre crop (crop_h, crop_w) then bilinear resize to (out_h,
    out_w), as the reference's cv2.getRectSubPix + cv2.resize pair —
    kept as two interpolations.

    getRectSubPix treats W/2 as a pixel-index centre, so the crop
    starts at x0 = (W - cw + 1)/2, half a pixel right of the
    geometric centre. Where x0 is not integral every output pixel is
    the mean of two source pixels (a unit-scale linear sample at a
    half-pixel offset)."""
    H, W = frame.shape[-3], frame.shape[-2]
    y0 = (H - crop_h + 1) / 2.0
    x0 = (W - crop_w + 1) / 2.0
    iy, ix = int(y0), int(x0)
    patch = frame[..., iy:iy + crop_h + (y0 != iy),
                  ix:ix + crop_w + (x0 != ix), :]
    if y0 != iy:
        patch = 0.5 * patch[..., :-1, :, :] + 0.5 * patch[..., 1:, :, :]
    if x0 != ix:
        patch = 0.5 * patch[..., :, :-1, :] + 0.5 * patch[..., :, 1:, :]
    if (crop_h, crop_w) == (out_h, out_w):
        return patch
    return resize_bilinear(patch, out_h, out_w)


# OpenCV's 20-bit fixed-point BT.601 constants (color_yuv.simd.hpp)
_SH, _HALF = 20, 1 << 19
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74701


def bgr_to_i420(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) BGR uint8 → (T, H*3/2, W) uint8 in I420 layout with
    OpenCV's fixed-point BT.601 formula (chroma from the top-left pixel
    of each 2x2 block): the JAX package's bytes exactly, and
    cv2.COLOR_BGR2YUV_I420's within one LSB. Requires H % 4 == 0 and
    W % 2 == 0."""
    T, H, W = frames.shape[:3]
    if H % 4 or W % 2:
        raise ValueError(f'I420 needs H % 4 == 0 and W % 2 == 0, got '
                         f'{H}x{W}')
    b = frames[..., 0].to(torch.int32)
    g = frames[..., 1].to(torch.int32)
    r = frames[..., 2].to(torch.int32)
    y = (_CRY * r + _CGY * g + _CBY * b + (16 << _SH) + _HALF) >> _SH
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    u = (_CRU * rs + _CGU * gs + _CBU * bs + (128 << _SH) + _HALF) >> _SH
    v = (_CBU * rs + _CGV * gs + _CBV * bs + (128 << _SH) + _HALF) >> _SH
    return torch.cat([
        y.to(torch.uint8),
        u.to(torch.uint8).reshape(T, H // 4, W),
        v.to(torch.uint8).reshape(T, H // 4, W)], 1)


def frame_epilogue_plain(frame: torch.Tensor, crop_h: int, crop_w: int,
                         out_h: int, out_w: int) -> torch.Tensor:
    """K5a's plain version: (H, W, 3) f32 frame → clip → centre crop
    and resize → clip → ×255 + 0.5 → truncate to (out_h, out_w, 3)
    uint8 BGR (the JAX frame loop's tail, pipeline/kenburns.py)."""
    frame = crop_center_resize(frame.clamp(0.0, 1.0), crop_h, crop_w,
                               out_h, out_w)
    return (frame.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


# csrc/epilogue.cu: output pixels a tile at most (rows, columns)
EPILOGUE_TILE = (8, 128)


def _first_taps(scale: np.float32, n_out: int) -> np.ndarray:
    """The crop index of each output row's (or column's) first bilinear
    tap, as csrc/epilogue.cu computes it: torch's source index
    scale·(o + 0.5) − 0.5 in f32, one rounding an operation, clamped at
    0 and truncated."""
    o = np.arange(n_out, dtype=np.float32)
    s = scale * (o + np.float32(0.5)) - np.float32(0.5)
    return np.maximum(s, np.float32(0.0)).astype(np.int64)


def epilogue_spans(n_crop: int, n_out: int, tile: int) -> np.ndarray:
    """Crop rows (or columns) that each tile of ``tile`` output rows
    forms in csrc/epilogue.cu: from its first row's first tap to its
    last row's second, or the tile itself when the crop keeps its
    size."""
    starts = np.arange(0, n_out, tile)
    ends = np.minimum(starts + tile, n_out) - 1
    if n_crop == n_out:
        return ends - starts + 1
    first = _first_taps(np.float32(n_crop) / np.float32(n_out), n_out)
    return np.minimum(first[ends] + 1, n_crop - 1) - first[starts] + 1


def epilogue_smem(tile_h: int, tile_w: int, span_h: int, span_w: int
                  ) -> int:
    """Shared memory of one csrc/epilogue.cu block in bytes (its
    ``smem_layout``): the tile's crop pixels and its row and column
    taps."""
    return (12 * span_h * span_w + 15) // 16 * 16 + 16 * (tile_h + tile_w)


@functools.lru_cache(maxsize=64)
def epilogue_plan(crop_h: int, crop_w: int, out_h: int, out_w: int,
                  smem_bytes: int = _cuda.SMEM_BYTES
                  ) -> Tuple[int, int, int, int]:
    """(tile_h, tile_w, span_h, span_w) of csrc/epilogue.cu: the
    largest tile from ``EPILOGUE_TILE`` down, halving the side whose
    crop span is the wider per output pixel, whose shared memory fits
    ``smem_bytes``; the spans are the most crop rows and columns any of
    its tiles forms. Raises where even a 2x2 tile does not fit (a crop
    many times the output)."""
    th, tw = EPILOGUE_TILE
    while True:
        sh = int(epilogue_spans(crop_h, out_h, th).max())
        sw = int(epilogue_spans(crop_w, out_w, tw).max())
        if epilogue_smem(th, tw, sh, sw) <= smem_bytes:
            return th, tw, sh, sw
        if th == tw == 2:
            raise ValueError(f'crop {crop_h}x{crop_w} to {out_h}x{out_w}: '
                             f'a tile\'s source does not fit shared memory')
        if tw == 2 or (th > 2 and sh * tw >= sw * th):
            th //= 2
        else:
            tw //= 2


def _check_frame(frame: torch.Tensor, crop_h: int, crop_w: int) -> None:
    H, W = frame.shape[0], frame.shape[1]
    if frame.dtype != torch.float32 or frame.ndim != 3 or \
            frame.shape[2] != 3 or frame.stride(2) != 1:
        raise ValueError(f'frame must be (H, W, 3) float32 with contiguous '
                         f'channels, got {tuple(frame.shape)} {frame.dtype} '
                         f'strides {frame.stride()}')
    # the crop and its half-pixel neighbour must lie inside the frame
    if not (0 < crop_h and (H - crop_h + 1) // 2 + crop_h
            + (H - crop_h + 1) % 2 <= H and 0 < crop_w
            and (W - crop_w + 1) // 2 + crop_w + (W - crop_w + 1) % 2 <= W):
        raise ValueError(f'crop {crop_h}x{crop_w} does not fit the frame '
                         f'{H}x{W}')


def _check_out(t: Optional[torch.Tensor], name: str, shape: tuple,
               dev: torch.device) -> None:
    if t is None:
        return
    _cuda.check(t, name, torch.uint8, len(shape), dev)
    if tuple(t.shape) != shape:
        raise ValueError(f'{name} is {tuple(t.shape)}, expected {shape}')


def _i420_fits(out_h: int, out_w: int) -> None:
    if out_h % 4 or out_w % 2:
        raise ValueError(f'I420 needs out_h % 4 == 0 and out_w % 2 == 0, '
                         f'got {out_h}x{out_w}')


def _epilogue_args(frame: torch.Tensor, crop_h: int, crop_w: int,
                   out_h: int, out_w: int) -> tuple:
    """The arguments of csrc/epilogue.cu's kb_frame_epilogue between the
    frame's address and the outputs': the frame's size and strides, the
    crop, the output and its tile plan."""
    tiles = epilogue_plan(crop_h, crop_w, out_h, out_w, _cuda.SMEM_BYTES)
    return (frame.shape[0], frame.shape[1], frame.stride(0),
            frame.stride(1), crop_h, crop_w, out_h, out_w, *tiles)


def _launch_epilogue(frame: torch.Tensor, args: tuple, bgr_ptr: int,
                     i420_ptr: int) -> None:
    _cuda.launch('epilogue', frame.data_ptr(), *args, bgr_ptr, i420_ptr,
                 _cuda.stream_ptr(frame))


def frame_epilogue(frame: torch.Tensor, crop_h: int, crop_w: int,
                   out_h: int, out_w: int,
                   bgr: Optional[torch.Tensor] = None,
                   i420: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5a wrapper: one (H, W, 3) f32 frame (channels contiguous; a
    view of the filled (H, W, 4) buffer is read in place) → its uint8
    BGR, written into ``bgr`` (out_h, out_w, 3) when given, and with
    ``i420`` (out_h·3/2, out_w) its I420 bytes as ``bgr_to_i420``
    makes them from that BGR. The plain chain on the CPU,
    csrc/epilogue.cu on CUDA (one launch). Returns the BGR tensor.
    Every call checks its arguments; a frame loop checks them once a
    clip with ``EpiloguePlan``."""
    if i420 is not None:
        _i420_fits(out_h, out_w)
    if frame.device.type == 'cpu':
        out = frame_epilogue_plain(frame, crop_h, crop_w, out_h, out_w)
        if bgr is not None:
            out = bgr.copy_(out)
        if i420 is not None:
            i420.copy_(bgr_to_i420(out[None])[0])
        return out
    dev = frame.device
    _check_frame(frame, crop_h, crop_w)
    if bgr is None:
        bgr = torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=dev)
    _check_out(bgr, 'bgr', (out_h, out_w, 3), dev)
    _check_out(i420, 'i420', (out_h * 3 // 2, out_w), dev)
    args = _epilogue_args(frame, crop_h, crop_w, out_h, out_w)
    _launch_epilogue(frame, args, bgr.data_ptr(),
                     0 if i420 is None else i420.data_ptr())
    return bgr


class EpiloguePlan:
    """K5a for the frames of one clip, checked and packed once.

    ``outputs(bgr, i420)`` takes the buffers of a run of frames, (T,
    out_h, out_w, 3) uint8 BGR and (T, out_h·3/2, out_w) uint8 I420 or
    None, and checks them once; ``plan(frame, t)`` then writes frame
    t's bytes, as ``frame_epilogue(frame, crop_h, crop_w, out_h, out_w,
    bgr[t], i420[t])`` would. The frame's dtype, layout and device and
    the crop are checked, and the launch's arguments packed, on the
    first frame and again only when a frame's shape, strides or dtype
    change; the slots' addresses are the buffers' plus t whole frames. No
    allocation and no host sync: a frame captures in a CUDA graph. On
    the CPU a call is ``frame_epilogue`` into the slots."""

    def __init__(self, crop_h: int, crop_w: int, out_h: int, out_w: int):
        self.crop = (crop_h, crop_w)
        self.out = (out_h, out_w)
        self._key = None
        self._args = ()
        self._frames = 0
        self.bgr = self.i420 = None

    def outputs(self, bgr: torch.Tensor,
                i420: Optional[torch.Tensor] = None) -> None:
        out_h, out_w = self.out
        T = bgr.shape[0] if bgr.ndim == 4 else -1
        if i420 is not None:
            _i420_fits(out_h, out_w)
        if bgr.device.type != 'cpu':
            _check_out(bgr, 'bgr', (T, out_h, out_w, 3), bgr.device)
            _check_out(i420, 'i420', (T, out_h * 3 // 2, out_w), bgr.device)
        elif tuple(bgr.shape) != (T, out_h, out_w, 3):
            raise ValueError(f'bgr is {tuple(bgr.shape)}, expected '
                             f'{(T, out_h, out_w, 3)}')
        if self.bgr is not None and bgr.device != self.bgr.device:
            self._key = None            # the frame's device is checked anew
        self.bgr, self.i420 = bgr, i420
        self._frames = T
        self._bgr_ptr = bgr.data_ptr()
        self._i420_ptr = None if i420 is None else i420.data_ptr()
        self._bgr_step = 3 * out_h * out_w
        self._i420_step = out_h * 3 // 2 * out_w

    def __call__(self, frame: torch.Tensor, t: int) -> None:
        if not 0 <= t < self._frames:
            raise IndexError(f'frame slot {t} of {self._frames}')
        if frame.device.type == 'cpu':
            frame_epilogue(frame, *self.crop, *self.out, self.bgr[t],
                           None if self.i420 is None else self.i420[t])
            return
        key = (frame.shape, frame.stride(), frame.dtype, frame.get_device())
        if key != self._key:
            self._bind(frame, key)
        i420 = 0 if self.i420 is None else \
            self._i420_ptr + t * self._i420_step
        _launch_epilogue(frame, self._args,
                         self._bgr_ptr + t * self._bgr_step, i420)

    def _bind(self, frame: torch.Tensor, key) -> None:
        if frame.device != self.bgr.device:
            raise ValueError(f'frame is on {frame.device}, the outputs on '
                             f'{self.bgr.device}')
        _check_frame(frame, *self.crop)
        self._args = _epilogue_args(frame, *self.crop, *self.out)
        self._key = key


# OpenCV's YUV→RGB fixed-point constants (color_yuv.simd.hpp)
_CY, _CUB, _CUG, _CVG, _CVR = 1220542, 2116026, -409993, -852492, 1673527


def i420_to_bgr_host(yuv: np.ndarray) -> np.ndarray:
    """(T, H*3/2, W) uint8 I420 → (T, H, W, 3) BGR uint8 on the host:
    cv2.COLOR_YUV2BGR_I420 where cv2 is present, else its fixed-point
    formula in numpy (the tests hold the two byte-equal)."""
    yuv = np.asarray(yuv)
    cv2 = _cv2()
    if cv2 is not None:
        return np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420)
                         for f in yuv])
    T, H3, W = yuv.shape
    H = H3 * 2 // 3
    y = yuv[:, :H].astype(np.int64)
    u = yuv[:, H:H + H // 4].reshape(T, H // 2, W // 2).astype(np.int64)
    v = yuv[:, H + H // 4:].reshape(T, H // 2, W // 2).astype(np.int64)
    u = np.repeat(np.repeat(u - 128, 2, 1), 2, 2)
    v = np.repeat(np.repeat(v - 128, 2, 1), 2, 2)
    yy = np.maximum(y - 16, 0) * _CY
    r = (yy + _CVR * v + _HALF) >> _SH
    g = (yy + _CVG * v + _CUG * u + _HALF) >> _SH
    b = (yy + _CUB * u + _HALF) >> _SH
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)
