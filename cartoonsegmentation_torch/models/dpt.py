"""The DPT decoder of MiDaS DPT_BEiT_L_384 on the BEiT backbone (port of
``cartoonsegmentation_tpu/models/dpt.py``): relative depth and the
hooked features ZoeDepth reads ('out_conv', 'l4_rn', 'r4', 'r3', 'r2',
'r1').

Parameter names follow the ZoeDepth checkpoint under ``core.core``:
``pretrained.model`` (the backbone), ``pretrained.act_postprocessN``
(readout ``0.project.0``, projection ``3``, resample ``4``) and
``scratch`` (``layerN_rn``, ``refinenetN.resConfUnit1/2`` and
``out_conv``, ``output_conv.0/2/4``). ``nn.ConvTranspose2d`` takes the
checkpoint's kernel as it is (the JAX package flips it for Flax).
refinenet4 has no skip input; its resConfUnit1 is kept, unused, so
that the checkpoint loads whole.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .beit import BeitBackbone


def up2_ac(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear, align_corners=True (NCHW)."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode='bilinear', align_corners=True)


class Readout(nn.Module):
    """'project' readout: the cls token joined to every patch token,
    Linear(2C → C) + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls, patches = tokens[:, :1], tokens[:, 1:]
        return self.project(torch.cat([patches, cls.expand_as(patches)], -1))


def act_postprocess(i: int, dim: int, oc: int) -> nn.Sequential:
    """Readout (0), two shape steps without parameters (1, 2), the 1x1
    projection (3) and level i's resample (4): x4 and x2 transposed
    convs, none, a stride-2 conv."""
    mods = [Readout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, oc, 1)]
    if i == 0:
        mods.append(nn.ConvTranspose2d(oc, oc, 4, 4))
    elif i == 1:
        mods.append(nn.ConvTranspose2d(oc, oc, 2, 2))
    elif i == 3:
        mods.append(nn.Conv2d(oc, oc, 3, 2, 1))
    return nn.Sequential(*mods)


class ResidualConvUnit(nn.Module):

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """MiDaS FeatureFusionBlock_custom (align_corners=True)."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(up2_ac(self.resConfUnit2(x)))


class DPTBeit(nn.Module):
    """MiDaS DPT-BEiT graph: (B, 3, H, W), MiDaS-normalised → (relative
    depth (B, H, W), the hook features, NCHW). The geometry defaults to
    the shipped DPT_BEiT_L_384; the tests shrink it."""

    def __init__(self, img_size: Tuple[int, int] = (384, 384),
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 hooks: Sequence[int] = (5, 11, 17, 23)):
        super().__init__()
        pre = self.pretrained = nn.Module()
        pre.model = BeitBackbone(img_size, dim=dim, depth=depth,
                                 num_heads=num_heads, hooks=hooks)
        sc = self.scratch = nn.Module()
        for i, oc in enumerate(out_channels):
            pre.add_module(f'act_postprocess{i + 1}',
                           act_postprocess(i, dim, oc))
            sc.add_module(f'layer{i + 1}_rn',
                          nn.Conv2d(oc, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            sc.add_module(f'refinenet{i}', FeatureFusion(features))
        sc.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU(), nn.Identity())

    def forward(self, x):
        pre, sc = self.pretrained, self.scratch
        B = x.shape[0]
        gh, gw = pre.model.grid
        levels = []
        for i, t in enumerate(pre.model(x)):
            ap = getattr(pre, f'act_postprocess{i + 1}')
            h = ap[0](t)
            h = h.transpose(1, 2).reshape(B, h.shape[-1], gh, gw)
            for m in ap[3:]:
                h = m(h)
            levels.append(h)
        rn = [getattr(sc, f'layer{i + 1}_rn')(lv)
              for i, lv in enumerate(levels)]
        r4 = sc.refinenet4(rn[3])
        # MiDaS's r4 hook fires after the crop to layer 3's grid
        r4 = r4[:, :, :rn[2].shape[2], :rn[2].shape[3]]
        r3 = sc.refinenet3(r4, rn[2])
        r2 = sc.refinenet2(r3, rn[1])
        r1 = sc.refinenet1(r2, rn[0])
        oc = sc.output_conv
        out_conv = F.relu(oc[2](up2_ac(oc[0](r1))))
        rel = F.relu(oc[4](out_conv))[:, 0]
        hooks: Dict[str, torch.Tensor] = {
            'out_conv': out_conv, 'l4_rn': rn[3], 'r4': r4, 'r3': r3,
            'r2': r2, 'r1': r1}
        return rel, hooks
