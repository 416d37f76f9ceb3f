"""MODNet, the trimap-free matting net (port of
``cartoonsegmentation_tpu/models/modnet.py``), NCHW.

A MobileNetV2 backbone (alpha 1, expansion 6), a low-resolution
semantic branch with SE attention, a high-resolution detail branch and
a fusion branch, built from conv → IBNorm → ReLU blocks. Modules keep
the reference checkpoint's key names (``backbone.model.features.N``,
``lr_branch.se_block.fc.0``, ``hr_branch.conv_hr4x.0.layers.1.bnorm``
…); as in the reference, ``lr_branch.backbone`` is the same module as
``backbone``, so the state_dict lists its tensors under both names.

The norms follow the JAX package's Flax modules: BatchNorm at inference
with eps 1e-5, and the InstanceNorm half (no affine) as (x - mean) ·
rsqrt(var + 1e-5) with the population variance.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import resize_to


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_to(x, x.shape[-2] * 2, x.shape[-1] * 2)


def _down(x: torch.Tensor, factor: int) -> torch.Tensor:
    return resize_to(x, x.shape[-2] // factor, x.shape[-1] // factor)


class IBNorm(nn.Module):
    """The first half of the channels batch-normed, the rest
    instance-normed without affine parameters."""

    def __init__(self, channels: int):
        super().__init__()
        self.half = channels // 2
        self.bnorm = nn.BatchNorm2d(self.half, eps=1e-5)

    def forward(self, x):
        bn = self.bnorm(x[:, :self.half])
        rest = x[:, self.half:]
        mean = rest.mean((-2, -1), keepdim=True)
        var = rest.var((-2, -1), correction=0, keepdim=True)
        return torch.cat([bn, (rest - mean) * torch.rsqrt(var + 1e-5)], 1)


class Conv2dIBNormRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 with_ibn: bool = True, with_relu: bool = True):
        super().__init__()
        layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                            bias=True)]
        if with_ibn:
            layers.append(IBNorm(cout))
        if with_relu:
            layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1,
             groups: int = 1, relu: bool = True) -> list:
    out = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
                     bias=False), nn.BatchNorm2d(cout, eps=1e-5)]
    return out + [nn.ReLU6()] if relu else out


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expansion: int):
        super().__init__()
        hidden = round(cin * expansion)
        self.use_res = stride == 1 and cin == cout
        layers = [] if expansion == 1 else _conv_bn(cin, hidden, 1)
        layers += _conv_bn(hidden, hidden, 3, stride, groups=hidden)
        layers += _conv_bn(hidden, cout, 1, relu=False)
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        h = self.conv(x)
        return x + h if self.use_res else h


# (expansion, out, blocks, stride)
_MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.Module):
    def __init__(self, in_ch: int = 3):
        super().__init__()
        feats = [nn.Sequential(*_conv_bn(in_ch, 32, 3, 2))]
        cin = 32
        for t, c, n, s in _MBV2:
            for i in range(n):
                feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        feats.append(nn.Sequential(*_conv_bn(cin, 1280, 1)))
        self.features = nn.Sequential(*feats)


class MobileNetV2Backbone(nn.Module):
    """Returns (enc2x 16, enc4x 24, enc8x 32, enc16x 96, enc32x 1280)."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.model = MobileNetV2(in_ch)

    def forward(self, x):
        f = self.model.features
        outs = []
        for lo, hi in ((0, 2), (2, 4), (4, 7), (7, 14), (14, 19)):
            for i in range(lo, hi):
                x = f[i](x)
            outs.append(x)
        return outs


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False), nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean((-2, -1)))[:, :, None, None]


class LRBranch(nn.Module):
    def __init__(self, backbone: MobileNetV2Backbone):
        super().__init__()
        self.backbone = backbone
        self.se_block = SEBlock(1280)
        self.conv_lr16x = Conv2dIBNormRelu(1280, 96, 5)
        self.conv_lr8x = Conv2dIBNormRelu(96, 32, 5)
        self.conv_lr = Conv2dIBNormRelu(32, 1, 3, 2, with_ibn=False,
                                        with_relu=False)


class HRBranch(nn.Module):
    def __init__(self, hr: int):
        super().__init__()
        self.tohr_enc2x = Conv2dIBNormRelu(16, hr, 1)
        self.conv_enc2x = Conv2dIBNormRelu(hr + 3, hr, 3, 2)
        self.tohr_enc4x = Conv2dIBNormRelu(24, hr, 1)
        self.conv_enc4x = Conv2dIBNormRelu(2 * hr, 2 * hr, 3)
        self.conv_hr4x = nn.Sequential(
            Conv2dIBNormRelu(3 * hr + 3, 2 * hr, 3),
            Conv2dIBNormRelu(2 * hr, 2 * hr, 3),
            Conv2dIBNormRelu(2 * hr, hr, 3))
        self.conv_hr2x = nn.Sequential(
            Conv2dIBNormRelu(2 * hr, 2 * hr, 3),
            Conv2dIBNormRelu(2 * hr, hr, 3),
            Conv2dIBNormRelu(hr, hr, 3),
            Conv2dIBNormRelu(hr, hr, 3))
        self.conv_hr = nn.Sequential(
            Conv2dIBNormRelu(hr + 3, hr, 3),
            Conv2dIBNormRelu(hr, 1, 1, with_ibn=False, with_relu=False))


class FusionBranch(nn.Module):
    def __init__(self, hr: int):
        super().__init__()
        self.conv_lr4x = Conv2dIBNormRelu(32, hr, 5)
        self.conv_f2x = Conv2dIBNormRelu(2 * hr, hr, 3)
        self.conv_f = nn.Sequential(
            Conv2dIBNormRelu(hr + 3, hr // 2, 3),
            Conv2dIBNormRelu(hr // 2, 1, 1, with_ibn=False, with_relu=False))


class MODNet(nn.Module):
    """Returns (pred_semantic, pred_detail, pred_matte); the first two
    are None at inference, as in the reference."""

    def __init__(self, in_ch: int = 3, hr_channels: int = 32):
        super().__init__()
        self.backbone = MobileNetV2Backbone(in_ch)
        self.lr_branch = LRBranch(self.backbone)
        self.hr_branch = HRBranch(hr_channels)
        self.f_branch = FusionBranch(hr_channels)

    def forward(self, img, inference: bool = True
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                           torch.Tensor]:
        lr, hrb, fb = self.lr_branch, self.hr_branch, self.f_branch
        enc2x, enc4x, _, _, enc32x = self.backbone(img)
        lr16x = lr.conv_lr16x(_up2(lr.se_block(enc32x)))
        lr8x = lr.conv_lr8x(_up2(lr16x))
        pred_semantic = None if inference else \
            torch.sigmoid(lr.conv_lr(lr8x))

        e2 = hrb.tohr_enc2x(enc2x)
        hr4x = hrb.conv_enc2x(torch.cat([_down(img, 2), e2], 1))
        hr4x = hrb.conv_enc4x(torch.cat([hr4x, hrb.tohr_enc4x(enc4x)], 1))
        hr4x = hrb.conv_hr4x(torch.cat([hr4x, _up2(lr8x), _down(img, 4)], 1))
        hr2x = hrb.conv_hr2x(torch.cat([_up2(hr4x), e2], 1))
        pred_detail = None if inference else torch.sigmoid(
            hrb.conv_hr(torch.cat([_up2(hr2x), img], 1)))

        lr2x = _up2(fb.conv_lr4x(_up2(lr8x)))
        f2x = fb.conv_f2x(torch.cat([lr2x, hr2x], 1))
        f = fb.conv_f(torch.cat([_up2(f2x), img], 1))
        return pred_semantic, pred_detail, torch.sigmoid(f)
