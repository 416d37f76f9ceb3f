"""SAM (Segment Anything), box prompts only — the PyTorch port of
``cartoonsegmentation_tpu/models/sam.py``.

- ``SamImageEncoder``: the ViT-det encoder (14x14 windowed attention
  with decomposed relative positions, a few global blocks, a conv
  neck), channels last (B, H, W, C) between blocks as the JAX version.
  Its attention core is kernel K15a: ``rel_pos_attention`` runs
  ``rel_pos_attention_plain`` for CPU tensors and ``csrc/samattn.cu``
  for CUDA tensors.
- ``SamPromptEncoder``: random-Fourier encoding of the box corners plus
  learned corner embeddings.
- ``SamMaskDecoder``: the two-way transformer (plain attention: a few
  tokens against the image tokens), hypernetwork mask heads and the
  IoU head.

Module and parameter names are the official ``segment_anything``
state-dict keys (``sam_vit_b_01ec64.pth``), so ``load_state_dict``
takes the published file; ``load_sam_state_dict`` also resamples the
position tables of a checkpoint made at another image size. The maths
follows the JAX package where it departs from the official model: the
decoder's LayerNorms use eps 1e-6 and its MLP GELU.

The model runs in f32, as the JAX package's NativeSAM does; on CUDA
TF32 is off (``device.py:resolve_device`` turns it off).
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _cuda

# pixel stats of the official predictor (RGB, 0-255)
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d: per-pixel normalisation over the channels,
    eps 1e-6, here over the last axis of a channels-last tensor."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight + self.bias


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# image encoder and its attention kernel (K15a)
# ---------------------------------------------------------------------------

def _rel_pos_table(q_size: int, k_size: int) -> np.ndarray:
    """(q, k) index table into a (2·max(q, k) − 1, d) rel-pos table."""
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return (q - k + (k_size - 1) * max(q_size / k_size, 1.0)
            ).astype(np.int64)


def rel_pos_attention_plain(qkv: torch.Tensor, bh: torch.Tensor,
                            bw: torch.Tensor, Hs: int, Ws: int
                            ) -> torch.Tensor:
    """K15a's plain version, the JAX maths with the (N, N) scores
    materialised: softmax((q·hd^-0.5)·kᵀ + bh + bw)·v. qkv (B, N, 3,
    n, hd), bh (B, n, N, Hs), bw (B, n, N, Ws) → (B, N, n·hd)."""
    B, N, _, n, hd = qkv.shape
    q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))
    attn = (q * (hd ** -0.5)) @ k.transpose(-2, -1)
    attn = (attn.view(B, n, N, Hs, Ws) + bh[..., :, None]
            + bw[..., None, :]).view(B, n, N, N)
    attn = attn.softmax(-1)
    return (attn @ v).permute(0, 2, 1, 3).reshape(B, N, n * hd)


def rel_pos_attention(qkv: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor,
                      Hs: int, Ws: int) -> torch.Tensor:
    """K15a wrapper: the plain version on the CPU, csrc/samattn.cu on
    CUDA (head widths 64 and 80: SAM ViT-B, -L, -H). qkv (B, N, 3, n,
    hd) f32 read in place; bh (B, n, N, Hs), bw (B, n, N, Ws) f32 the
    rel-pos terms of the unscaled q; N = Hs·Ws → (B, N, n·hd) f32."""
    if qkv.device.type == 'cpu':
        return rel_pos_attention_plain(qkv, bh, bw, Hs, Ws)
    dev = qkv.device
    qkv, bh, bw = qkv.contiguous(), bh.contiguous(), bw.contiguous()
    _cuda.check(qkv, 'qkv', torch.float32, 5, dev)
    _cuda.check(bh, 'bh', torch.float32, 4, dev)
    _cuda.check(bw, 'bw', torch.float32, 4, dev)
    B, N, three, n, hd = qkv.shape
    if three != 3 or N != Hs * Ws or tuple(bh.shape) != (B, n, N, Hs) \
            or tuple(bw.shape) != (B, n, N, Ws):
        raise ValueError(f'qkv {tuple(qkv.shape)}, bh {tuple(bh.shape)}, bw '
                         f'{tuple(bw.shape)} do not fit a {Hs}x{Ws} grid')
    if hd not in (64, 80):
        raise ValueError(f'samattn is built for head widths 64 and 80, got '
                         f'{hd}')
    if qkv.data_ptr() % 16:
        raise ValueError('qkv must be 16-byte aligned')
    out = torch.empty((B, N, n * hd), dtype=torch.float32, device=dev)
    _cuda.launch('samattn',
                 qkv.data_ptr(), bh.data_ptr(), bw.data_ptr(), B, N, n, hd,
                 Hs, Ws, hd ** -0.5, out.data_ptr(), _cuda.stream_ptr(qkv))
    return out


class SamAttention(nn.Module):
    """Encoder attention with decomposed relative positions. Input
    (B, H, W, C); windows are a larger B."""

    def __init__(self, dim: int, num_heads: int, rel_pos_dim: int):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_pos_dim, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_pos_dim, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads,
                                  C // self.num_heads)
        bh, bw = rel_pos_terms(qkv, self.rel_pos_h, self.rel_pos_w, H, W)
        out = rel_pos_attention(qkv, bh, bw, H, W)
        return self.proj(out.view(B, H, W, C))


def rel_pos_terms(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                  rel_pos_w: torch.Tensor, H: int, W: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposed rel-pos terms of the unscaled q (JAX :97-101):
    bh (B, n, N, H) = q·Rh[row], bw (B, n, N, W) = q·Rw[col], from the
    qkv projection (B, N, 3, n, hd) and the (2·size − 1, hd) tables."""
    B, N, _, n, _ = qkv.shape
    dev = qkv.device
    Rh = rel_pos_h[torch.from_numpy(_rel_pos_table(H, H)).to(dev)]
    Rw = rel_pos_w[torch.from_numpy(_rel_pos_table(W, W)).to(dev)]
    q = qkv[:, :, 0].unflatten(1, (H, W))              # (B, H, W, n, hd)
    bh = torch.einsum('bhwnc,hkc->bnhwk', q, Rh).reshape(B, n, N, H)
    bw = torch.einsum('bhwnc,wkc->bnhwk', q, Rw).reshape(B, n, N, W)
    return bh, bw


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class SamBlock(nn.Module):
    """norm1 → (zero-pad, window partition) → attention → (unpartition,
    crop) → residual; norm2 → MLP → residual. The padded tokens take
    part in the attention as keys, unmasked, as in the JAX version."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SamAttention(dim, num_heads,
                                 2 * (window if window > 0 else grid) - 1)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        sc = x
        x = self.norm1(x)
        w = self.window
        if w > 0:
            Hp, Wp = -(-H // w) * w, -(-W // w) * w
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
            x = x.reshape(B, Hp // w, w, Wp // w, w, C) \
                 .permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
        x = self.attn(x)
        if w > 0:
            x = x.reshape(B, Hp // w, Wp // w, w, w, C) \
                 .permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
            x = x[:, :H, :W]
        x = sc + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class SamImageEncoder(nn.Module):
    """ViT-det encoder + neck: (B, S, S, 3) → (B, S/16, S/16, 256)."""

    def __init__(self, img_size: int = 1024, patch: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 window: int = 14, global_idx: Sequence[int] = (2, 5, 8, 11),
                 out_ch: int = 256):
        super().__init__()
        g = img_size // patch
        self.patch_embed = _PatchEmbed(patch, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        self.blocks = nn.ModuleList([
            SamBlock(dim, num_heads, mlp_ratio,
                     0 if i in global_idx else window, g)
            for i in range(depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out_ch, 1, bias=False), LayerNorm2d(out_ch),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            LayerNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_nhwc(self.patch_embed.proj, x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[1](_conv_nhwc(self.neck[0], x))
        return self.neck[3](_conv_nhwc(self.neck[2], x))


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer('positional_encoding_gaussian_matrix',
                             torch.randn(2, dim // 2))


class SamPromptEncoder(nn.Module):
    """Random-Fourier point encoding + learned corner embeddings. Box
    prompts only: ``not_a_point_embed`` and ``mask_downscaling`` exist
    for the official keys and are never run."""

    def __init__(self, embed_dim: int = 256, grid: int = 64,
                 input_size: int = 1024):
        super().__init__()
        self.grid, self.input_size = grid, input_size
        self.pe_layer = _PositionEmbeddingRandom(embed_dim)
        # 0/1: fg/bg point, 2: box top-left, 3: box bottom-right
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, embed_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), LayerNorm2d(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), LayerNorm2d(16), nn.GELU(),
            nn.Conv2d(16, embed_dim, 1))

    def _pe(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords01 (..., 2) in [0, 1] → (..., embed_dim)."""
        c = (2.0 * coords01 - 1.0) @ \
            self.pe_layer.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def dense_pe(self) -> torch.Tensor:
        """Positional encoding of the embedding grid (grid, grid, D)."""
        g = self.grid
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        xs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        return self._pe(torch.stack([gx, gy], -1))

    def encode_boxes(self, boxes_xyxy: torch.Tensor) -> torch.Tensor:
        """(K, 4) pixel boxes → sparse embeddings (K, 2, D)."""
        pts = boxes_xyxy.reshape(-1, 2, 2) + 0.5
        emb = self._pe(pts / self.input_size)
        corners = torch.stack([self.point_embeddings[2].weight[0],
                               self.point_embeddings[3].weight[0]])
        return emb + corners[None]

    def forward(self, boxes_xyxy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sparse = self.encode_boxes(boxes_xyxy)
        dense = self.no_mask_embed.weight[0].expand(self.grid, self.grid, -1)
        return sparse, dense


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

class TwoWayAttn(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        B = q.shape[0]

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(B, t.shape[1], self.num_heads, -1).transpose(1, 2)
        qh, kh, vh = heads(self.q_proj(q)), heads(self.k_proj(k)), \
            heads(self.v_proj(v))
        hd = qh.shape[-1]
        attn = torch.softmax(qh @ kh.transpose(-2, -1) / math.sqrt(hd), -1)
        out = (attn @ vh).transpose(1, 2).reshape(B, -1, qh.shape[1] * hd)
        return self.out_proj(out)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = TwoWayAttn(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn_token_to_image = TwoWayAttn(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _MLPBlock(dim, mlp_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn_image_to_token = TwoWayAttn(dim, num_heads, 2)
        self.norm4 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayBlock(dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
            for i in range(depth)])
        self.final_attn_token_to_image = TwoWayAttn(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, HW, D), points (B, T, D)."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class _MLP3(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim, hidden),
                                     nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, out)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


class SamMaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, num_multimask: int = 3):
        super().__init__()
        nm = num_multimask + 1
        self.transformer = TwoWayTransformer(2, dim, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(nm, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4),
            nn.GELU(), nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [_MLP3(dim, dim, dim // 8) for _ in range(nm)])
        self.iou_prediction_head = _MLP3(dim, dim, nm)

    def forward(self, image_embedding, image_pe, sparse, dense):
        """image_embedding, image_pe, dense (G, G, D); sparse (K, T, D).
        Returns (masks (K, nm, 4G, 4G), iou (K, nm))."""
        G, D = image_embedding.shape[0], image_embedding.shape[-1]
        K = sparse.shape[0]
        nm = self.mask_tokens.weight.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens.expand(K, -1, -1), sparse], 1)
        src = (image_embedding + dense).reshape(1, G * G, D).expand(K, -1, -1)
        pos = image_pe.reshape(1, G * G, D).expand(K, -1, -1)
        hs, src = self.transformer(src, pos, tokens)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + nm]
        up = self.output_upscaling
        x = _conv_nhwc(up[0], src.reshape(K, G, G, D))
        x = F.gelu(up[1](x))
        x = F.gelu(_conv_nhwc(up[3], x))                 # (K, 4G, 4G, D/8)
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum('knc,khwc->knhw', hyper, x)
        return masks, self.iou_prediction_head(iou_out)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class SAM(nn.Module):
    """encode(image) once per image; decode(embedding, boxes) per
    prompt batch; ``forward`` chains both."""

    def __init__(self, img_size: int = 1024, patch: int = 16,
                 enc_dim: int = 768, enc_depth: int = 12,
                 enc_heads: int = 12, window: int = 14,
                 global_idx: Sequence[int] = (2, 5, 8, 11),
                 dec_dim: int = 256, dec_heads: int = 8,
                 dec_mlp: int = 2048):
        super().__init__()
        self.img_size, self.patch = img_size, patch
        self.window, self.global_idx = window, tuple(global_idx)
        self.image_encoder = SamImageEncoder(
            img_size, patch, enc_dim, enc_depth, enc_heads, 4.0, window,
            global_idx, dec_dim)
        self.prompt_encoder = SamPromptEncoder(dec_dim, img_size // patch,
                                               img_size)
        self.mask_decoder = SamMaskDecoder(dec_dim, dec_heads, dec_mlp)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) normalised RGB → (B, S/16, S/16, D)."""
        return self.image_encoder(x)

    def decode(self, embedding: torch.Tensor, boxes_xyxy: torch.Tensor,
               multimask: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """embedding (G, G, D), boxes (K, 4) → the best mask per box:
        (K, 4G, 4G) logits and (K,) predicted IoU. The pick takes the
        first of equal IoUs, as the JAX version's one-hot of argmax."""
        sparse, dense = self.prompt_encoder(boxes_xyxy)
        pe = self.prompt_encoder.dense_pe()
        masks, iou = self.mask_decoder(embedding, pe, sparse, dense)
        if multimask:
            masks, iou = masks[:, 1:], iou[:, 1:]
        else:
            masks, iou = masks[:, :1], iou[:, :1]
        best = iou.argmax(-1)
        pick = masks[torch.arange(masks.shape[0], device=masks.device), best]
        return pick, iou.max(-1).values

    def forward(self, x: torch.Tensor, boxes_xyxy: torch.Tensor):
        return self.decode(self.encode(x)[0], boxes_xyxy)


def init_sam_(model: SAM) -> SAM:
    """Random weights for a run without a checkpoint (the caller seeds
    torch): torch's default layer init, and N(0, 0.02) for the position
    tables, which the official model starts at zero, so that the
    rel-pos terms of the attention are not all zero."""
    with torch.no_grad():
        model.image_encoder.pos_embed.normal_(0.0, 0.02)
        for blk in model.image_encoder.blocks:
            blk.attn.rel_pos_h.normal_(0.0, 0.02)
            blk.attn.rel_pos_w.normal_(0.0, 0.02)
    return model


def sam_vit_b(img_size: int = 1024) -> SAM:
    return SAM(img_size=img_size)


def sam_vit_l(img_size: int = 1024) -> SAM:
    return SAM(img_size=img_size, enc_dim=1024, enc_depth=24, enc_heads=16,
               global_idx=(5, 11, 17, 23))


def sam_vit_h(img_size: int = 1024) -> SAM:
    return SAM(img_size=img_size, enc_dim=1280, enc_depth=32, enc_heads=16,
               global_idx=(7, 15, 23, 31))


# ---------------------------------------------------------------------------
# official checkpoint
# ---------------------------------------------------------------------------

def _resample_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Linear resample of a rel-pos table to ``rows`` rows (half-pixel
    centres, as cv2 INTER_LINEAR and the official get_rel_pos)."""
    if t.shape[0] == rows:
        return t
    y = F.interpolate(t.float().t()[None], size=rows, mode='linear',
                      align_corners=False)
    return y[0].t().contiguous()


def _resample_grid(pos: torch.Tensor, g: int) -> torch.Tensor:
    """Bicubic resample of the (1, g0, g0, D) position grid to g x g
    (the JAX converter's cv2 INTER_CUBIC; both use a = -0.75)."""
    if pos.shape[1] == g:
        return pos
    y = F.interpolate(pos.float().permute(0, 3, 1, 2), size=(g, g),
                      mode='bicubic', align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def load_sam_state_dict(model: SAM, sd: Mapping[str, torch.Tensor]) -> None:
    """Load an official ``segment_anything`` state dict (the keys of
    ``sam_vit_*.pth``), resampling the position grid and the rel-pos
    tables where ``model``'s image size or window differs from the
    checkpoint's (JAX ``convert_sam`` :483-521)."""
    sd = dict(sd)
    sd.pop('pixel_mean', None)
    sd.pop('pixel_std', None)
    g = model.img_size // model.patch
    key = 'image_encoder.pos_embed'
    sd[key] = _resample_grid(sd[key], g)
    for i, blk in enumerate(model.image_encoder.blocks):
        rows = blk.attn.rel_pos_h.shape[0]
        for ax in ('h', 'w'):
            k = f'image_encoder.blocks.{i}.attn.rel_pos_{ax}'
            sd[k] = _resample_rows(sd[k], rows)
    model.load_state_dict(sd)

