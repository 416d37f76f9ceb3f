"""ISNet (DIS), the second-stage mask refinement net (port of
``cartoonsegmentation_tpu/models/isnet.py``), NCHW.

Modules keep the reference checkpoint's key names (``conv_in``,
``stage1.rebnconvin.conv_s1``, ``stage5d.rebnconv1d.bn_s1``,
``side1`` …). One parametric ``RSU`` covers RSU7..RSU4 and, with
``dilated=True``, RSU4F.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class REBNConv(nn.Module):
    """3x3 conv (dilation = padding = dirate, bias) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(cin, cout, 3, padding=dirate,
                                 dilation=dirate, bias=True)
        self.bn_s1 = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, ceil mode: an odd edge is padded with
    -inf (the JAX version pads, then pools)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to ``tar``'s size: jax.image.resize 'linear',
    which only upsamples here, is plain bilinear."""
    return F.interpolate(src, size=tar.shape[-2:], mode='bilinear',
                         align_corners=False)


class RSU(nn.Module):
    """Residual U-block of height L: an input conv, L-1 encoder convs
    with ceil-mode pools, a bottom conv at dilation 2, L-1 decoder convs
    with bilinear upsampling. ``dilated``: no pools, encoder level i at
    dilation 2^(i-1), the bottom at 2^(L-1) (RSU4F when L = 4)."""

    def __init__(self, height: int, cin: int, mid: int, cout: int,
                 dilated: bool = False):
        super().__init__()
        self.height, self.dilated = height, dilated
        L = height

        def rate(i):
            return 2 ** (i - 1) if dilated else 1
        self.rebnconvin = REBNConv(cin, cout)
        self.rebnconv1 = REBNConv(cout, mid, rate(1))
        for i in range(2, L):
            self.add_module(f'rebnconv{i}', REBNConv(mid, mid, rate(i)))
        self.add_module(f'rebnconv{L}',
                        REBNConv(mid, mid, 2 ** (L - 1) if dilated else 2))
        for i in range(L - 1, 0, -1):
            self.add_module(f'rebnconv{i}d',
                            REBNConv(2 * mid, cout if i == 1 else mid,
                                     rate(i)))

    def forward(self, x):
        L = self.height
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        h = enc[0]
        for i in range(2, L):
            if not self.dilated:
                h = _pool_ceil(h)
            h = getattr(self, f'rebnconv{i}')(h)
            enc.append(h)
        d = getattr(self, f'rebnconv{L}')(h)
        for i in range(L - 1, 0, -1):
            skip = enc[i - 1]
            if d.shape[-2:] != skip.shape[-2:]:
                d = _up_like(d, skip)
            d = getattr(self, f'rebnconv{i}d')(torch.cat([d, skip], 1))
        return d + hxin


def RSU4F(cin: int, mid: int, cout: int) -> RSU:
    """The fully dilated RSU of height 4."""
    return RSU(4, cin, mid, cout, dilated=True)


class ISNetDIS(nn.Module):
    """Full ISNet. Returns the six side-output logits at the input size
    (side 1 is the prediction) and the decoder features."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1):
        super().__init__()
        self.conv_in = nn.Conv2d(in_ch, 64, 3, 2, 1, bias=True)
        self.stage1 = RSU(7, 64, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, c in enumerate((64, 64, 128, 256, 512, 512)):
            self.add_module(f'side{i + 1}', nn.Conv2d(c, out_ch, 3, padding=1))

    def forward(self, x) -> Tuple[List[torch.Tensor], Tuple]:
        hxin = self.conv_in(x)
        hx1 = self.stage1(hxin)
        hx2 = self.stage2(_pool_ceil(hx1))
        hx3 = self.stage3(_pool_ceil(hx2))
        hx4 = self.stage4(_pool_ceil(hx3))
        hx5 = self.stage5(_pool_ceil(hx4))
        hx6 = self.stage6(_pool_ceil(hx5))
        hx5d = self.stage5d(torch.cat([_up_like(hx6, hx5), hx5], 1))
        hx4d = self.stage4d(torch.cat([_up_like(hx5d, hx4), hx4], 1))
        hx3d = self.stage3d(torch.cat([_up_like(hx4d, hx3), hx3], 1))
        hx2d = self.stage2d(torch.cat([_up_like(hx3d, hx2), hx2], 1))
        hx1d = self.stage1d(torch.cat([_up_like(hx2d, hx1), hx1], 1))
        feats = (hx1d, hx2d, hx3d, hx4d, hx5d, hx6)
        sides = [_up_like(getattr(self, f'side{i + 1}')(f), x)
                 for i, f in enumerate(feats)]
        return sides, feats
