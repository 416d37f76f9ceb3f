"""SwinV2 image classifier, the WD (waifu-diffusion) Danbooru tagger's
backbone — the PyTorch port of ``cartoonsegmentation_tpu/models/
swinv2.py``.

Module and parameter names are timm's ``swinv2`` state-dict keys
(``patch_embed.proj``, ``layers.{i}.downsample``,
``layers.{i}.blocks.{j}.attn.qkv`` / ``q_bias`` / ``v_bias`` /
``logit_scale`` / ``cpb_mlp`` / ``proj``, ``norm1``, ``mlp.fc1``,
``norm2``, ``norm``, ``head.fc``), so ``load_swinv2_state_dict`` takes
a timm checkpoint (``model.`` prefixes stripped, a bare ``head`` taken
as ``head.fc``, timm's derived buffers dropped).

The maths follows the JAX version where a timm release may differ:
post-norm blocks; qkv with q_bias, a zero k bias and v_bias; the
logit scale clamped at log 100; the continuous position bias MLP (512
hidden) through 16·sigmoid; the per-axis window/shift rule (an axis the
map fits in one window gets that window and no shift); the map padded
before the roll, and padded tokens not masked; the patch-merge concat
x0, x1, x2, x3 = (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2,
1::2); exact GELU and LayerNorm eps 1e-5. Channels last (B, H, W, C)
between blocks, as the JAX version; the input is NHWC.

The attention core is kernel K15b: ``window_attention`` runs
``window_attention_plain`` for CPU tensors and ``csrc/swinattn.cu`` for
CUDA tensors. The model runs in f32 (TF32 off on CUDA,
``device.py:resolve_device``).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _cuda

LOGIT_SCALE_MAX = float(np.log(100.0))


# ---------------------------------------------------------------------------
# static (numpy) geometry tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def relative_coords_table(wh: int, ww: int, pwh: int = 0,
                          pww: int = 0) -> np.ndarray:
    """Log-spaced relative coordinate table, ((2wh-1)(2ww-1), 2) f32,
    normalised by the pretrained window size when given, else by the
    current one."""
    h = np.arange(-(wh - 1), wh, dtype=np.float64)
    w = np.arange(-(ww - 1), ww, dtype=np.float64)
    table = np.stack(np.meshgrid(h, w, indexing='ij'), axis=-1)
    table[..., 0] /= max((pwh if pwh > 0 else wh) - 1, 1)
    table[..., 1] /= max((pww if pww > 0 else ww) - 1, 1)
    table *= 8.0
    table = (np.sign(table) * np.log2(np.abs(table) + 1.0)
             / np.log2(8.0))
    return table.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) int32 index into the flattened coords table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))          # (2, wh, ww)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(hp: int, wp: int, window, shift) -> np.ndarray:
    """(num_windows, wh*ww, wh*ww) additive mask (0 / -100) for shifted
    windows on a (hp, wp) padded map. ``window`` and ``shift`` are ints
    (square) or per axis; an axis without shift is one region."""
    wh, ww = (window, window) if isinstance(window, int) else window
    sh, sw = (shift, shift) if isinstance(shift, int) else shift
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    hslices = ((slice(0, -wh), slice(-wh, -sh), slice(-sh, None))
               if sh else (slice(None),))
    wslices = ((slice(0, -ww), slice(-ww, -sw), slice(-sw, None))
               if sw else (slice(None),))
    for hs in hslices:
        for ws in wslices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // wh, wh, wp // ww, ww)
    win = win.transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, w) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, wh*ww, C); H, W multiples of wh, ww."""
    wh, ww = (w, w) if isinstance(w, int) else w
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(x: torch.Tensor, w, H: int, W: int) -> torch.Tensor:
    """(B*nW, wh*ww, C) -> (B, H, W, C)."""
    wh, ww = (w, w) if isinstance(w, int) else w
    C = x.shape[-1]
    x = x.reshape(-1, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


@functools.lru_cache(maxsize=64)
def _on_device(fn, device: torch.device, *args) -> torch.Tensor:
    """A device copy of one of the numpy tables above, made once."""
    return torch.from_numpy(fn(*args)).to(device)


# ---------------------------------------------------------------------------
# the attention kernel (K15b)
# ---------------------------------------------------------------------------

def window_attention_plain(qkv: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K15b's plain version, the JAX maths: softmax(cos(q, k)·scale +
    bias (+ mask))·v. qkv (B, N, 3, n, hd), scale (n,), bias (n, N, N),
    mask (nW, N, N) with window b % nW for batch row b → (B, N, n·hd)."""
    B, N, _, n, hd = qkv.shape
    q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(
        min=1e-12)
    kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp(
        min=1e-12)
    attn = qn @ kn.transpose(-2, -1)
    attn = attn * scale[None, :, None, None]
    attn = attn + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.view(B // nW, nW, n, N, N)
                + mask[None, :, None]).view(B, n, N, N)
    attn = attn.softmax(-1)
    return (attn @ v).permute(0, 2, 1, 3).reshape(B, N, n * hd)


# csrc/swinattn.cu: tokens a window and head width, at most
SWINATTN_MAX_N = 64
SWINATTN_MAX_HD = 32


def window_attention(qkv: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """K15b wrapper: the plain version on the CPU, csrc/swinattn.cu on
    CUDA (N ≤ 64 tokens a window, head width ≤ 32: SwinV2-B's 8 × 8
    windows of 32-wide heads). qkv (B, N, 3, n, hd) f32 read in place;
    scale (n,) f32 = exp(min(logit_scale, log 100)); bias (n, N, N) f32;
    mask (nW, N, N) f32 or None, B a multiple of nW → (B, N, n·hd)."""
    if qkv.device.type == 'cpu':
        return window_attention_plain(qkv, scale, bias, mask)
    dev = qkv.device
    qkv, scale, bias = qkv.contiguous(), scale.contiguous(), bias.contiguous()
    _cuda.check(qkv, 'qkv', torch.float32, 5, dev)
    _cuda.check(scale, 'scale', torch.float32, 1, dev)
    _cuda.check(bias, 'bias', torch.float32, 3, dev)
    B, N, three, n, hd = qkv.shape
    if three != 3 or tuple(scale.shape) != (n,) or \
            tuple(bias.shape) != (n, N, N):
        raise ValueError(f'qkv {tuple(qkv.shape)}, scale '
                         f'{tuple(scale.shape)}, bias {tuple(bias.shape)} '
                         f'do not fit')
    if N > SWINATTN_MAX_N or hd > SWINATTN_MAX_HD:
        raise ValueError(f'swinattn takes N <= {SWINATTN_MAX_N} and head '
                         f'width <= {SWINATTN_MAX_HD}, got {N}, {hd}')
    nW = 0
    if mask is not None:
        mask = mask.contiguous()
        _cuda.check(mask, 'mask', torch.float32, 3, dev)
        nW = mask.shape[0]
        if tuple(mask.shape[1:]) != (N, N) or B % nW:
            raise ValueError(f'mask {tuple(mask.shape)} does not fit '
                             f'{B} windows of {N}')
    out = torch.empty((B, N, n * hd), dtype=torch.float32, device=dev)
    _cuda.launch('swinattn',
                 qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 None if mask is None else mask.data_ptr(), B, N, n, hd, nW,
                 out.data_ptr(), _cuda.stream_ptr(qkv))
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class WindowAttentionV2(nn.Module):
    """Scaled-cosine window attention with the continuous position
    bias; the window size is the block's, decided per input."""

    def __init__(self, dim: int, num_heads: int,
                 pretrained_window_size: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_window_size = tuple(pretrained_window_size)
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), float(np.log(10.0))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def position_bias(self, wh: int, ww: int, device) -> torch.Tensor:
        """(n, N, N) bias 16·sigmoid(CPB(table))[index]."""
        table = _on_device(relative_coords_table, device, wh, ww,
                           *self.pretrained_window_size)
        idx = _on_device(relative_position_index, device, wh, ww)
        bias_table = self.cpb_mlp(table)                    # (T, n)
        N = wh * ww
        bias = bias_table[idx.reshape(-1).long()].reshape(N, N, -1)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1).contiguous())

    def forward(self, x: torch.Tensor, window: Tuple[int, int],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        n = self.num_heads
        qkv_b = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                           self.v_bias])
        qkv = F.linear(x, self.qkv.weight, qkv_b).reshape(B, N, 3, n, C // n)
        scale = torch.exp(torch.clamp(self.logit_scale.reshape(n),
                                      max=LOGIT_SCALE_MAX))
        out = window_attention(qkv, scale,
                               self.position_bias(*window, x.device), mask)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinV2Block(nn.Module):
    """Post-norm Swin block; ``shift`` > 0 means shifted windows."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, pretrained_window_size: int = 0):
        super().__init__()
        self.window, self.shift = window, shift
        self.attn = WindowAttentionV2(dim, num_heads,
                                      (pretrained_window_size,) * 2)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        # timm's _calc_window_shift per axis: an axis that one window
        # covers shrinks the window to the map and drops its shift
        wh = H if H <= self.window else self.window
        ww = W if W <= self.window else self.window
        sh = self.shift if (self.shift > 0 and H > wh) else 0
        sw = self.shift if (self.shift > 0 and W > ww) else 0
        pad_h, pad_w = (-H) % wh, (-W) % ww
        xa = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if pad_h or pad_w else x
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if sh or sw:
            xa = torch.roll(xa, (-sh, -sw), dims=(1, 2))
            mask = _on_device(shift_attn_mask, x.device, Hp, Wp, (wh, ww),
                              (sh, sw))
        attn = self.attn(window_partition(xa, (wh, ww)), (wh, ww), mask)
        xa = window_reverse(attn, (wh, ww), Hp, Wp)
        if sh or sw:
            xa = torch.roll(xa, (sh, sw), dims=(1, 2))
        if pad_h or pad_w:
            xa = xa[:, :H, :W]
        x = x + self.norm1(xa)
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    """2×2 concat → Linear(4C → 2C, no bias) → LayerNorm (V2 order)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)
        self.norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.norm(self.reduction(x))


class _PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class _Stage(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module],
                 downsample: Optional[nn.Module]):
        super().__init__()
        self.downsample = downsample
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class _Head(nn.Module):
    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(dim, num_classes)


class SwinV2(nn.Module):
    """SwinV2 classifier. Input (B, H, W, 3) float NHWC; output (B,
    num_classes) logits (the WD tagger takes their sigmoid)."""

    def __init__(self, num_classes: int = 9083, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 8,
                 mlp_ratio: float = 4.0,
                 pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0)):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = _PatchEmbed(embed_dim)
        stages = []
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            blocks = [SwinV2Block(dim, num_heads[i], window,
                                  0 if j % 2 == 0 else window // 2,
                                  mlp_ratio, pretrained_window_sizes[i])
                      for j in range(depth)]
            stages.append(_Stage(blocks, PatchMerging(dim // 2, dim)
                                 if i > 0 else None))
        self.layers = nn.ModuleList(stages)
        dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = _Head(dim, num_classes)

    def forward(self, x: torch.Tensor,
                return_features: bool = False) -> torch.Tensor:
        """Logits, or with ``return_features`` the pooled (B, dim)
        features before the head."""
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        for stage in self.layers:
            x = stage(x)
        feats = self.norm(x).mean((1, 2))
        return feats if return_features else self.head.fc(feats)


def wd_tagger_swinv2(num_classes: int = 9083) -> SwinV2:
    """SwinV2-Base geometry of the WD taggers (448 px input, patch 4,
    window 8: stage grids 112/56/28/14, the last two padded to 32/16
    for windowing)."""
    return SwinV2(num_classes=num_classes, embed_dim=128,
                  depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=8)


# timm buffers derived from the geometry, rebuilt here per input
_DERIVED = ('relative_coords_table', 'relative_position_index', 'attn_mask',
            'k_bias')


def convert_swinv2(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A timm swinv2 checkpoint (a state dict, or one under
    'state_dict') → the state dict ``SwinV2`` loads: ``model.``
    prefixes stripped, a bare ``head`` taken as ``head.fc``, timm's
    derived buffers dropped (the JAX package's name for its converter
    to Flax variables)."""
    sd = sd.get('state_dict', sd)
    sd = {k[6:] if k.startswith('model.') else k: torch.as_tensor(v)
          for k, v in sd.items() if hasattr(v, 'shape')}
    if 'head.weight' in sd:
        sd['head.fc.weight'] = sd.pop('head.weight')
        sd['head.fc.bias'] = sd.pop('head.bias')
    return {k: v for k, v in sd.items() if k.split('.')[-1] not in _DERIVED}


def load_swinv2_state_dict(module: SwinV2, sd: Mapping) -> None:
    """Load a timm swinv2 checkpoint into ``module``, strictly, through
    ``convert_swinv2``."""
    module.load_state_dict(convert_swinv2(sd))


def init_swinv2_(module: SwinV2, generator: torch.Generator) -> SwinV2:
    """Random weights from ``generator`` (timm's init): Linear and conv
    weights N(0, 0.02²), biases 0, LayerNorms 1 and 0, q/v biases 0,
    the logit scale log 10."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttentionV2):
                m.logit_scale.fill_(float(np.log(10.0)))
                m.q_bias.zero_()
                m.v_bias.zero_()
    return module
