"""U²-Net (the refactored full2 and lite2 variants) and the ISNet
ground-truth encoder (port of ``cartoonsegmentation_tpu/models/
u2net.py``), NCHW.

The animeseg refiner's 'u2net' and 'u2netl' are U2NET_full2 and
U2NET_lite2: six encoder stages of heights (8, 7, 6, 5, 5, 5), where
stages 5, 6 and 5d are dilated height-5 RSUs, side heads and a 1x1 fuse
conv. Modules keep the u2net_refactor checkpoint's key names
(``stage1.rebnconvin.conv_s1``, ``stage5d.rebnconv1d.bn_s1``,
``side1``, ``outconv``); ``ISNetGTEncoder``'s stem keeps
``conv_in.conv`` / ``conv_in.bn``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .isnet import RSU, RSU4F, _pool_ceil, _up_like

# (height, mid, out, dilated) a stage (u2net.py full2, lite2)
_FULL2_ENC = ((8, 32, 64, False), (7, 32, 128, False),
              (6, 64, 256, False), (5, 128, 512, False),
              (5, 256, 512, True), (5, 256, 512, True))
_FULL2_DEC = ((5, 256, 512, True), (5, 128, 256, False),
              (6, 64, 128, False), (7, 32, 64, False),
              (8, 16, 64, False))
_LITE2_ENC = ((8, 16, 64, False), (7, 16, 64, False),
              (6, 16, 64, False), (5, 16, 64, False),
              (5, 16, 64, True), (5, 16, 64, True))
_LITE2_DEC = ((5, 16, 64, True), (5, 16, 64, False),
              (6, 16, 64, False), (7, 16, 64, False),
              (8, 16, 64, False))


class U2Net(nn.Module):
    """Returns ([fused d0, side logits d1..d6] at the input size, the
    decoder features)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, lite: bool = False):
        super().__init__()
        enc = _LITE2_ENC if lite else _FULL2_ENC
        dec = _LITE2_DEC if lite else _FULL2_DEC
        self.n_enc, self.n_dec = len(enc), len(dec)
        cin = in_ch
        outs = []
        for i, (hh, mid, out, dil) in enumerate(enc):
            self.add_module(f'stage{i + 1}', RSU(hh, cin, mid, out, dil))
            outs.append(out)
            cin = out
        side_ch = [outs[-1]]
        for i, (hh, mid, out, dil) in enumerate(dec):
            skip = outs[len(enc) - 2 - i]
            self.add_module(f'stage{len(dec) - i}d',
                            RSU(hh, cin + skip, mid, out, dil))
            side_ch.insert(0, out)
            cin = out
        for i, c in enumerate(side_ch):
            self.add_module(f'side{i + 1}', nn.Conv2d(c, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(len(side_ch) * out_ch, out_ch, 1)

    def forward(self, x) -> Tuple[List[torch.Tensor], Tuple]:
        feats = []
        h = x
        for i in range(self.n_enc):
            h = getattr(self, f'stage{i + 1}')(h)
            feats.append(h)
            if i < self.n_enc - 1:
                h = _pool_ceil(h)
        d = feats[-1]
        dec = [d]
        for i in range(self.n_dec):
            skip = feats[self.n_enc - 2 - i]
            d = getattr(self, f'stage{self.n_dec - i}d')(
                torch.cat([_up_like(d, skip), skip], 1))
            dec.insert(0, d)
        sides = [_up_like(getattr(self, f'side{i + 1}')(f), x)
                 for i, f in enumerate(dec)]
        fused = self.outconv(torch.cat(sides, 1))
        return [fused] + sides, tuple(dec)


class REBNConvIn(nn.Module):
    """The GT encoder's stem (``myrebnconv``): 3x3 conv at stride 2 →
    BN → ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, 1, bias=True)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ISNetGTEncoder(nn.Module):
    """Ground-truth mask encoder: a stride-2 stem and six RSU stages with
    side outputs. Returns (side logits d1..d6 at the input size, the
    stage features)."""

    _CFG = ((7, 16, 64), (6, 16, 64), (5, 32, 128), (4, 32, 256),
            ('f', 64, 512), ('f', 64, 512))

    def __init__(self, in_ch: int = 1, out_ch: int = 1):
        super().__init__()
        self.conv_in = REBNConvIn(in_ch, 16)
        cin = 16
        for i, (hh, mid, out) in enumerate(self._CFG):
            stage = RSU4F(cin, mid, out) if hh == 'f' \
                else RSU(hh, cin, mid, out)
            self.add_module(f'stage{i + 1}', stage)
            self.add_module(f'side{i + 1}', nn.Conv2d(out, out_ch, 3,
                                                      padding=1))
            cin = out

    def forward(self, x) -> Tuple[List[torch.Tensor], Tuple]:
        h = self.conv_in(x)
        feats = []
        for i in range(len(self._CFG)):
            h = getattr(self, f'stage{i + 1}')(h)
            feats.append(h)
            if i < len(self._CFG) - 1:
                h = _pool_ceil(h)
        sides = [_up_like(getattr(self, f'side{i + 1}')(f), x)
                 for i, f in enumerate(feats)]
        return sides, tuple(feats)
