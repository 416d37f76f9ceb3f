"""Depth post-processing (port of
``cartoonsegmentation_tpu/pipeline/depth.py``): instance-aware
disparity adjustment, per-instance median (K6) and the gray_r colorize
(K5b).

K6 ``masked_median_u8`` runs ``masked_median_u8_plain`` (a 256-bin
histogram with ``index_put_``) for CPU tensors and
``csrc/insmedian.cu`` for CUDA tensors (one launch, its scratch a
buffer a card that each call leaves zero: ``_median_scratch``); K5b
``colorize_gray_r`` runs ``colorize_gray_r_plain`` or
``csrc/colorize.cu``. All are exact.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..instances import Instances
from ..ops import _cuda


def adjust_disparity_by_instances(disparity: torch.Tensor,
                                  instances: Instances,
                                  use_median: bool = False
                                  ) -> torch.Tensor:
    """disparity (H, W) at image resolution. Each valid instance's
    disparity becomes the max over the bottom 3% of its mask's rows
    (zeros outside the mask take part, as in the reference), or the
    masked lower median; instances run in order, each seeing the
    earlier ones' adjustments (kenburns_effect.py:39-91)."""
    H, W = disparity.shape
    rows = torch.arange(H, device=disparity.device, dtype=torch.float32)
    adjusted = disparity
    for i in torch.nonzero(instances.valid).flatten().tolist():
        m = instances.masks[i].to(adjusted.dtype)
        plane = adjusted * m
        if float(plane.sum()) == 0.0:
            continue
        if not use_median:
            row_any = plane.sum(1) > 0.0
            nz = torch.nonzero(row_any).flatten()
            top, bottom = int(nz[0]), int(nz[-1])
            # f32 arithmetic, round half to even, as jnp does
            r0 = float(np.round(np.float32(top) + np.float32(0.97)
                                * np.float32(bottom - top)))
            value = plane[rows >= r0].max()
            adjusted = (1.0 - m) * adjusted + m * value
        else:
            sel = plane > 0
            vals = adjusted[sel].sort().values
            value = vals[(vals.numel() - 1) // 2]
            adjusted = torch.where(sel, value, adjusted)
    return adjusted


def masked_median_u8_plain(values: torch.Tensor, masks: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Per-instance lower median of round(values) over each mask, via a
    256-bin histogram. values (H, W) in [0, 255], masks (N, H, W) bool,
    valid (N,). Invalid or empty instances give -inf; a NaN value
    counts in bin 0, as the JAX version's float-to-int conversion on
    the CPU and the kernel put it."""
    N = masks.shape[0]
    q = values.round().clamp(0, 255).nan_to_num(0.0).to(torch.int64)
    q = q.reshape(-1)
    m = masks.reshape(N, -1)
    hist = torch.zeros((N, 256), device=values.device)
    rows = torch.arange(N, device=values.device)[:, None].expand_as(m)
    hist.index_put_((rows[m], q[None].expand_as(m)[m]),
                    torch.ones((), device=values.device), accumulate=True)
    cnt = hist.sum(-1)
    cum = hist.cumsum(-1)
    rank = torch.floor((cnt - 1.0) / 2.0) + 1.0   # lower median, 1-based
    med = (cum < rank[:, None]).sum(-1).float()
    return torch.where(valid & (cnt > 0), med,
                       torch.full_like(med, float('-inf')))


def masked_median_u8(values: torch.Tensor, masks: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: the plain version on the CPU, csrc/insmedian.cu on
    CUDA. values (H, W) f32, masks (N, H, W) bool, valid (N,) bool →
    (N,) f32 medians, -inf for invalid or empty instances."""
    if values.device.type == 'cpu':
        return masked_median_u8_plain(values, masks, valid)
    dev = values.device
    values = values.contiguous()
    masks = masks.contiguous()
    valid = valid.contiguous()
    _cuda.check(values, 'values', torch.float32, 2, dev)
    _cuda.check(masks, 'masks', torch.bool, 3, dev)
    _cuda.check(valid, 'valid', torch.bool, 1, dev)
    N = masks.shape[0]
    if tuple(masks.shape[1:]) != tuple(values.shape) or valid.shape[0] != N:
        raise ValueError(f'masks {tuple(masks.shape)}, values '
                         f'{tuple(values.shape)} and valid '
                         f'{tuple(valid.shape)} do not match')
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    _cuda.launch('insmedian',
                 values.data_ptr(), masks.data_ptr(), valid.data_ptr(), N,
                 values.numel(), _median_scratch(dev, N).data_ptr(),
                 out.data_ptr(), _cuda.stream_ptr(values))
    return out


# K6's scratch a card, by device index
_scratch: Dict[int, torch.Tensor] = {}


def _median_scratch(dev: torch.device, N: int) -> torch.Tensor:
    """csrc/insmedian.cu's scratch on ``dev`` for N instances: N x 256
    bins and N tickets (int32), zero on entry. Each call leaves what it
    used zero, so one buffer serves every call on the card, made (or
    grown) by the first call that needs it; calls that overlap on two
    streams would share it, and the port makes them on one."""
    buf = _scratch.get(dev.index)
    if buf is None or buf.numel() < N * 257:
        buf = _scratch[dev.index] = torch.zeros(
            N * 257, dtype=torch.int32, device=dev)
    return buf


def colorize_gray_r_plain(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalise and invert to [0, 255] (the reference's
    colorize(..., cmap='gray_r')[..., 0]); a true division by the
    0-d span, as the JAX version's."""
    lo, hi = x.min(), x.max()
    norm = (x - lo) / (hi - lo).clamp(min=1e-12)
    return (1.0 - norm) * 255.0


def colorize_plan(n: int, sms: int) -> Tuple[int, int]:
    """(blocks, scratch floats) of csrc/colorize.cu for a map of n
    values on a card of ``sms`` streaming multiprocessors
    (``_cuda.sm_count``): at most ``_cuda.COLORIZE_BLOCKS_PER_SM`` blocks
    an SM of ``_cuda.COLORIZE_THREADS`` threads (the kernel takes fewer
    if the card holds fewer at once), and 2 floats a block (its min and
    max) after the map in the output buffer."""
    blocks = max(1, min(_cuda.COLORIZE_BLOCKS_PER_SM * sms,
                        -(-n // _cuda.COLORIZE_THREADS)))
    return blocks, 2 * blocks


def colorize_gray_r(x: torch.Tensor) -> torch.Tensor:
    """K5b wrapper: the plain version on the CPU, csrc/colorize.cu on
    CUDA (one launch; reads the map once), equal bit for bit. x (H, W)
    f32, read in place when it is one channel of an interleaved buffer
    (the filled frame's depth) → (H, W) f32, contiguous."""
    if x.device.type == 'cpu':
        return colorize_gray_r_plain(x)
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError(f'colorize_gray_r takes (H, W) float32, got '
                        f'{tuple(x.shape)} {x.dtype}')
    # one element stride over the whole map, or a contiguous copy
    step = x.stride(1)
    if x.stride(0) != step * x.shape[1] or step < 1:
        x, step = x.contiguous(), 1
    n = x.numel()
    blocks, scratch = colorize_plan(n, _cuda.sm_count(x))
    # the map, then the blocks' partial min and max
    out = torch.empty((n + scratch,), dtype=torch.float32, device=x.device)
    _cuda.launch('colorize', x.data_ptr(), n, step, blocks, out.data_ptr(),
                 _cuda.stream_ptr(x))
    return out[:n].view(x.shape)
