"""CSPNeXt backbone and CSPNeXt-PAFPN neck of RTMDet-Ins (port of
``cartoonsegmentation_tpu/models/cspnext.py``), NCHW.

Modules keep mmdet's checkpoint key names (``backbone.stem.0.conv``,
``stage1.1.blocks.0.conv2.depthwise_conv``, ``neck.reduce_layers.0``
…), so ``rtmdetl_e60.ckpt`` loads with ``load_state_dict``. Every conv
is bias-free + BatchNorm + SiLU; ``deepen`` and ``widen`` scale depth
and width (L = 1.0 / 1.0) so that tests can run narrow. In train mode
the BatchNorms follow flax's rule (``BatchNorm2d``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its keys and its eval mode) whose train mode is
    the JAX package's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` under
    flax's defaults: batch statistics in f32 with the fast variance
    E[x²] − E[x]² clipped at 0, which normalises the batch and, biased as
    it is, also updates ``running_var`` (torch's own train mode stores
    the unbiased variance); running = 0.9 · running + 0.1 · batch."""

    MOMENTUM = 0.9

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBNAct(nn.Module):
    """conv → BN → SiLU (mmcv ConvModule)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class DWSepConv(nn.Module):
    """Depthwise k x k + pointwise 1x1, each with BN + SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 5):
        super().__init__()
        self.depthwise_conv = ConvBNAct(cin, cin, kernel, groups=cin)
        self.pointwise_conv = ConvBNAct(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, cin: int, cout: int, add_identity: bool = True):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout, 3)
        self.conv2 = DWSepConv(cout, cout, 5)
        self.add_identity = add_identity and cin == cout

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        return h + x if self.add_identity else h


class ChannelAttention(nn.Module):
    """Global average pool → 1x1 conv (bias) → hard-sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, num_blocks: int,
                 add_identity: bool = True, expand_ratio: float = 0.5,
                 channel_attention: bool = False):
        super().__init__()
        mid = int(cout * expand_ratio)
        self.main_conv = ConvBNAct(cin, mid, 1)
        self.short_conv = ConvBNAct(cin, mid, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, mid, add_identity)
                                      for _ in range(num_blocks)])
        self.attention = ChannelAttention(2 * mid) if channel_attention \
            else None
        self.final_conv = ConvBNAct(2 * mid, cout, 1)

    def forward(self, x):
        h = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], 1)
        if self.attention is not None:
            h = self.attention(h)
        return self.final_conv(h)


class SPPBottleneck(nn.Module):
    """1x1 conv, stride-1 max pools of 5/9/13 (padded with -inf, as
    nn.MaxPool2d does), concat, 1x1 conv."""

    def __init__(self, cin: int, cout: int,
                 pool_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvBNAct(cin, mid, 1)
        self.poolings = nn.ModuleList([nn.MaxPool2d(k, 1, k // 2)
                                       for k in pool_sizes])
        self.conv2 = ConvBNAct(mid * (len(pool_sizes) + 1), cout, 1)

    def forward(self, x):
        h = self.conv1(x)
        return self.conv2(torch.cat([h] + [p(h) for p in self.poolings], 1))


# stage table: (in, out, num_blocks, add_identity, use_spp)
_ARCH_P5 = ((64, 128, 3, True, False), (128, 256, 6, True, False),
            (256, 512, 6, True, False), (512, 1024, 3, False, True))


class CSPNeXt(nn.Module):
    """Backbone; returns the stride 8/16/32 features (stages 2-4)."""

    def __init__(self, deepen: float = 1.0, widen: float = 1.0):
        super().__init__()
        stem0 = int(64 * widen // 2)
        self.stem = nn.Sequential(ConvBNAct(3, stem0, 3, 2),
                                  ConvBNAct(stem0, stem0, 3),
                                  ConvBNAct(stem0, int(64 * widen), 3))
        for si, (cin, cout, n, add_id, spp) in enumerate(_ARCH_P5):
            cin, cout = int(cin * widen), int(cout * widen)
            layers: List[nn.Module] = [ConvBNAct(cin, cout, 3, 2)]
            if spp:
                layers.append(SPPBottleneck(cout, cout))
            layers.append(CSPLayer(cout, cout, max(round(n * deepen), 1),
                                   add_id, channel_attention=True))
            setattr(self, f'stage{si + 1}', nn.Sequential(*layers))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for si in range(4):
            x = getattr(self, f'stage{si + 1}')(x)
            if si >= 1:
                outs.append(x)
        return outs


class CSPNeXtPAFPN(nn.Module):
    """Neck: top-down then bottom-up CSP fusion, 3x3 output convs."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 out_channels: int = 256, num_csp_blocks: int = 3):
        super().__init__()
        ch = tuple(in_channels)
        n = len(ch)
        self.reduce_layers = nn.ModuleList(
            [ConvBNAct(ch[i], ch[i - 1], 1) for i in range(n - 1, 0, -1)])
        self.top_down_blocks = nn.ModuleList(
            [CSPLayer(ch[i - 1] * 2, ch[i - 1], num_csp_blocks, False)
             for i in range(n - 1, 0, -1)])
        self.downsamples = nn.ModuleList(
            [ConvBNAct(ch[i], ch[i], 3, 2) for i in range(n - 1)])
        self.bottom_up_blocks = nn.ModuleList(
            [CSPLayer(ch[i] * 2, ch[i + 1], num_csp_blocks, False)
             for i in range(n - 1)])
        self.out_convs = nn.ModuleList(
            [ConvBNAct(c, out_channels, 3) for c in ch])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        inner = [feats[-1]]
        for k, idx in enumerate(range(n - 1, 0, -1)):
            high = self.reduce_layers[k](inner[0])
            inner[0] = high
            h, w = feats[idx - 1].shape[-2:]
            # nearest x2 (a repeat), cropped to the finer level
            up = high.repeat_interleave(2, -2).repeat_interleave(2, -1)
            up = up[..., :h, :w]
            inner.insert(0, self.top_down_blocks[k](
                torch.cat([up, feats[idx - 1]], 1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        return [conv(o) for conv, o in zip(self.out_convs, outs)]
