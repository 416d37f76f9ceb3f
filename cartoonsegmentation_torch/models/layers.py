"""Residual conv blocks of the 3D-Ken-Burns nets (port of
``cartoonsegmentation_tpu/models/layers.py``).

Modules keep the published checkpoints' parameter names (``netMain``,
``netShortcut``) and torch's NCHW layout, as do ``upsample2x`` and
``resize_to``; ``normalize_mean_std`` works on the JAX package's
channel-last tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def PReLU(features: int, init: float = 0.25) -> nn.PReLU:
    """Per-channel PReLU, init 0.25 (torch nn.PReLU(num_parameters=C))."""
    return nn.PReLU(features, init)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         pad: int | None = None, bias: bool = True) -> nn.Conv2d:
    if pad is None:
        pad = kernel // 2
    return nn.Conv2d(cin, cout, kernel, stride, pad, bias=bias)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of an NCHW tensor, half-pixel centres (jax.image.resize
    'linear', whose antialias does nothing when it enlarges)."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode='bilinear', align_corners=False)


def resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (h, w) without antialias, on
    minification too (jax.image.resize 'linear', antialias=False)."""
    return F.interpolate(x, size=(h, w), mode='bilinear',
                         align_corners=False, antialias=False)


class Basic(nn.Module):
    """Residual block: [PReLU] conv3 PReLU conv3 (+ shortcut), kind
    'relu-conv-relu-conv' or 'conv-relu-conv'; channels (in, mid, out).
    The shortcut is the identity when in == out, else a 1x1 conv."""

    def __init__(self, kind: str, channels: Sequence[int]):
        super().__init__()
        cin, cmid, cout = channels
        if kind == 'relu-conv-relu-conv':
            self.netMain = nn.Sequential(PReLU(cin), conv(cin, cmid),
                                         PReLU(cmid), conv(cmid, cout))
        elif kind == 'conv-relu-conv':
            self.netMain = nn.Sequential(conv(cin, cmid), PReLU(cmid),
                                         conv(cmid, cout))
        else:
            raise ValueError(kind)
        self.netShortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        sc = x if self.netShortcut is None else self.netShortcut(x)
        return self.netMain(x) + sc


class Downsample(nn.Module):
    """PReLU conv3/s2 PReLU conv3."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        cin, cmid, cout = channels
        self.netMain = nn.Sequential(PReLU(cin), conv(cin, cmid, stride=2),
                                     PReLU(cmid), conv(cmid, cout))

    def forward(self, x):
        return self.netMain(x)


class Upsample(nn.Module):
    """bilinear x2 (align_corners=False), PReLU conv3 PReLU conv3."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        cin, cmid, cout = channels
        self.netMain = nn.Sequential(
            nn.Upsample(scale_factor=2, mode='bilinear',
                        align_corners=False),
            PReLU(cin), conv(cin, cmid), PReLU(cmid), conv(cmid, cout))

    def forward(self, x):
        return self.netMain(x)


def crop_like(up: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop trailing rows/cols of an NCHW upsample to ``ref``'s size."""
    return up[..., :ref.shape[-2], :ref.shape[-1]]


def normalize_mean_std(x: torch.Tensor, eps: float = 1e-7):
    """Whiten a channel-last (..., H, W, C) tensor over its last three
    axes (population std); returns (x_norm, mean, std)."""
    dims = (-3, -2, -1)
    mean = x.mean(dims, keepdim=True)
    std = x.std(dims, correction=0, keepdim=True)
    return (x - mean) / (std + eps), mean, std
