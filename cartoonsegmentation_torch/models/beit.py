"""BEiT-Large backbone of MiDaS DPT_BEiT_L_384 (port of
``cartoonsegmentation_tpu/models/beit.py``): timm's BEiT (patch 16, 1024
dim, 24 blocks, 16 heads), a relative position bias table per block,
layer-scale gammas, q/v-only biases, LayerNorm eps 1e-6, exact GELU;
the token sequences (cls included) at the hook blocks.

Parameter names follow the ZoeDepth checkpoint under
``core.core.pretrained.model`` (``patch_embed.proj``, ``cls_token``,
``blocks.N.*``). A block's bias table has the (2gh-1)(2gw-1)+3 rows of
the model's patch grid; ``models/zoedepth.py:load_zoe_state_dict``
resizes a checkpoint's table trained at another grid.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(N+1, N+1) index into the (2wh-1)(2ww-1)+3 bias table, timm's
    layout: the three trailing rows are cls-as-query, cls-as-key and
    cls-to-cls, written in that order (the later writes win at row and
    column 0)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


def table_rows(grid: Tuple[int, int]) -> int:
    """Rows of a block's relative position bias table at ``grid``."""
    return (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3


class BeitAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_rows(grid), num_heads))
        self.register_buffer('rel_index',
                             torch.from_numpy(rel_pos_index(*grid)),
                             persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        rel = self.relative_position_bias_table[self.rel_index]
        rel = rel.permute(2, 0, 1)[None]                    # (1, H, N, N)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=rel)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BeitBlock(nn.Module):

    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int],
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, grid)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BeitBackbone(nn.Module):
    """(B, 3, H, W) → the token sequences (B, 1 + gh·gw, dim) after the
    hook blocks; the grid is fixed at construction (H/16, W/16)."""

    def __init__(self, img_size: Tuple[int, int] = (384, 384),
                 patch: int = 16, dim: int = 1024, depth: int = 24,
                 num_heads: int = 16,
                 hooks: Sequence[int] = (5, 11, 17, 23)):
        super().__init__()
        self.grid = (img_size[0] // patch, img_size[1] // patch)
        self.hooks = tuple(hooks)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList(
            [BeitBlock(dim, num_heads, self.grid) for _ in range(depth)])

    def forward(self, x):
        B = x.shape[0]
        h = self.patch_embed.proj(x)
        if tuple(h.shape[-2:]) != self.grid:
            raise ValueError(f'patch grid {tuple(h.shape[-2:])} is not the '
                             f'model grid {self.grid}')
        h = h.flatten(2).transpose(1, 2)
        h = torch.cat([self.cls_token.expand(B, -1, -1), h], 1)
        feats = []
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if i in self.hooks:
                feats.append(h)
        return feats
