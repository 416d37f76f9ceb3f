"""RTMDet-Ins head, the anime instance detector and its fixed-shape
postprocess (port of ``cartoonsegmentation_tpu/models/rtmdet.py``).

Nets are NCHW ``nn.Module``s with mmdet's checkpoint key names
(``bbox_head.cls_convs.{level}.{i}``, ``bbox_head.rtm_cls.{level}``,
``bbox_head.mask_head.*``). ``AnimeDetector`` returns its maps
channel-last and in f32 whatever the conv dtype, as the JAX detector
does, so ``postprocess`` takes the JAX package's layout.

Two kernels run in ``postprocess``:
- K8 ``nms_fixed``: ``nms_fixed_plain`` (the lax.scan as a Python loop
  over an IoU matrix) for CPU tensors, ``csrc/nms.cu`` for CUDA ones;
  the keep sets are exact.
- K9 ``dynamic_masks``: ``dynamic_masks_plain`` (the 10→8→8→1 dynamic
  1x1 convs summed in input order, sigmoid, bilinear x8 upsample,
  threshold) for CPU tensors, ``csrc/maskhead.cu`` (one launch) for
  CUDA ones.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _cuda
from ..utils.image import resize_bilinear
from .cspnext import CSPNeXt, CSPNeXtPAFPN, ConvBNAct

STRIDES = (8, 16, 32)
NUM_PROTOTYPES = 8
DYCONV_CHANNELS = 8
# dynamic conv parameters: weights (8+2)*8, 8*8, 8*1, then biases 8, 8, 1
WEIGHT_NUMS = ((NUM_PROTOTYPES + 2) * DYCONV_CHANNELS,
               DYCONV_CHANNELS * DYCONV_CHANNELS, DYCONV_CHANNELS * 1)
BIAS_NUMS = (DYCONV_CHANNELS, DYCONV_CHANNELS, 1)
NUM_GEN_PARAMS = sum(WEIGHT_NUMS) + sum(BIAS_NUMS)  # 169


class MaskFeatModule(nn.Module):
    """Fuse the neck's levels into 8 mask prototypes at stride 8."""

    def __init__(self, cin: int, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 3,
                 num_prototypes: int = NUM_PROTOTYPES):
        super().__init__()
        self.fusion_conv = nn.Conv2d(num_levels * cin, cin, 1, bias=True)
        self.stacked_convs = nn.Sequential(*[
            ConvBNAct(cin if i == 0 else feat_channels, feat_channels, 3)
            for i in range(stacked_convs)])
        self.projection = nn.Conv2d(feat_channels, num_prototypes, 1,
                                    bias=True)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        h, w = feats[0].shape[-2:]
        # jax.image.resize 'linear' upsampling = plain bilinear
        fused = [feats[0]] + [
            F.interpolate(f, size=(h, w), mode='bilinear',
                          align_corners=False) for f in feats[1:]]
        x = self.fusion_conv(torch.cat(fused, 1))
        return self.projection(self.stacked_convs(x))


class RTMDetInsSepBNHead(nn.Module):
    """Per-level (cls, reg, kernel) maps; the 3x3 conv stacks are shared
    across levels (one module, reachable under every level's key) while
    their BatchNorms are per level. Holds the mask feature module as
    ``mask_head``, where mmdet keeps it."""

    def __init__(self, cin: int, feat_channels: int = 256,
                 stacked_convs: int = 2, num_levels: int = 3,
                 num_classes: int = 1):
        super().__init__()

        def branch() -> nn.ModuleList:
            levels = nn.ModuleList([
                nn.ModuleList([
                    ConvBNAct(cin if i == 0 else feat_channels,
                              feat_channels, 3)
                    for i in range(stacked_convs)])
                for _ in range(num_levels)])
            for lv in range(1, num_levels):
                for i in range(stacked_convs):
                    levels[lv][i].conv = levels[0][i].conv
            return levels
        self.cls_convs = branch()
        self.reg_convs = branch()
        self.kernel_convs = branch()
        self.rtm_cls = nn.ModuleList([nn.Conv2d(feat_channels, num_classes, 1)
                                      for _ in range(num_levels)])
        self.rtm_reg = nn.ModuleList([nn.Conv2d(feat_channels, 4, 1)
                                      for _ in range(num_levels)])
        self.rtm_kernel = nn.ModuleList([
            nn.Conv2d(feat_channels, NUM_GEN_PARAMS, 1)
            for _ in range(num_levels)])
        self.mask_head = MaskFeatModule(cin)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, krn_out = [], [], []
        for lv, x in enumerate(feats):
            c = r = k = x
            for m in self.cls_convs[lv]:
                c = m(c)
            for m in self.reg_convs[lv]:
                r = m(r)
            for m in self.kernel_convs[lv]:
                k = m(k)
            cls_out.append(self.rtm_cls[lv](c))
            reg_out.append(F.relu(self.rtm_reg[lv](r)) * STRIDES[lv])
            krn_out.append(self.rtm_kernel[lv](k))
        return cls_out, reg_out, krn_out, self.mask_head(feats)


class AnimeDetector(nn.Module):
    """CSPNeXt + PAFPN + RTMDet-Ins head, one class. L = deepen 1.0,
    widen 1.0. Input (B, 3, H, W) normalised BGR; returns per-level
    (cls, reg, kernel) maps and the mask features, each (B, h, w, C)
    f32."""

    def __init__(self, deepen: float = 1.0, widen: float = 1.0):
        super().__init__()
        self.backbone = CSPNeXt(deepen, widen)
        ch = tuple(int(c * widen) for c in (256, 512, 1024))
        self.neck = CSPNeXtPAFPN(ch, int(256 * widen),
                                 max(round(3 * deepen), 1))
        self.bbox_head = RTMDetInsSepBNHead(int(256 * widen))

    def forward(self, x: torch.Tensor):
        cls_out, reg_out, krn_out, mask_feat = self.bbox_head(
            self.neck(self.backbone(x)))

        def hwc(t):
            return t.permute(0, 2, 3, 1).float().contiguous()
        return (tuple(hwc(c) for c in cls_out), tuple(hwc(r) for r in reg_out),
                tuple(hwc(k) for k in krn_out), hwc(mask_feat))


# ---------------------------------------------------------------------------
# fixed-shape postprocess
# ---------------------------------------------------------------------------

def level_priors(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """(h*w, 2) prior centres (x, y) = grid · stride, offset 0."""
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing='ij')
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)


def distance2bbox(priors: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances → (x1, y1, x2, y2)."""
    return torch.stack([priors[:, 0] - dist[:, 0], priors[:, 1] - dist[:, 1],
                        priors[:, 0] + dist[:, 2], priors[:, 1] + dist[:, 3]],
                       -1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (N, 4) x (M, 4) → (N, M)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def _top_k_key(x: torch.Tensor) -> torch.Tensor:
    """The top-k key: f32 → int64, increasing in the raw float total
    order (-0 < +0, a NaN by its sign bit at either end), the order
    lax.top_k compares floats in."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    return torch.where(u >= 0x80000000, 0xffffffff - u, u | 0x80000000)


def _argsort_key(x: torch.Tensor) -> torch.Tensor:
    """The argsort key: as ``_top_k_key`` after jnp.argsort's
    canonicalisation (-0 → +0, every NaN → +NaN, so NaNs come last)."""
    x = x.float()
    u = x.contiguous().view(torch.int32)
    u = torch.where(x == 0, torch.zeros_like(u), u)
    u = torch.where(torch.isnan(x), torch.full_like(u, 0x7fc00000), u)
    return _top_k_key(u.view(torch.float32))


def _top_k_order(x: torch.Tensor) -> torch.Tensor:
    """Indices of x from the largest down, the lower index first among
    equals: lax.top_k's order (torch.topk promises none for ties)."""
    return torch.sort(_top_k_key(-x), stable=True).indices


def _stable_argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """Stable argsort of -x, as jnp.argsort(-x)."""
    return torch.sort(_argsort_key(-x), stable=True).indices


def nms_fixed_plain(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thr: float, max_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: the JAX scan over the score order, one step
    per candidate. Returns (keep_idx (D,) int64, keep_mask (D,) bool),
    D = min(max_out, K)."""
    K = boxes.shape[0]
    order = _stable_argsort_desc(scores)
    iou = box_iou(boxes[order], boxes[order])
    after = torch.arange(K, device=boxes.device)
    alive = torch.ones((K,), dtype=torch.bool, device=boxes.device)
    kept = torch.zeros_like(alive)
    for i in range(K):
        keep_i = alive[i]
        kept[i] = keep_i
        suppress = (iou[i] > iou_thr) & keep_i
        alive = alive & (~suppress | (after <= i))
    kept_scores = torch.where(kept, scores[order],
                              torch.full_like(scores, -1.0))
    top = _stable_argsort_desc(kept_scores)[:max_out]
    return order[top], kept[top] & (kept_scores[top] > -1.0)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
              max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 wrapper: class-agnostic greedy NMS over K <= 512 candidates;
    the plain version on the CPU, csrc/nms.cu on CUDA. boxes (K, 4)
    xyxy f32, scores (K,) f32 → (keep_idx (D,) int64, keep_mask (D,)
    bool), D = min(max_out, K)."""
    if boxes.device.type == 'cpu':
        return nms_fixed_plain(boxes, scores, iou_thr, max_out)
    dev = boxes.device
    boxes, scores = boxes.contiguous(), scores.contiguous()
    _cuda.check(boxes, 'boxes', torch.float32, 2, dev)
    _cuda.check(scores, 'scores', torch.float32, 1, dev)
    K = boxes.shape[0]
    if boxes.shape[1] != 4 or scores.shape[0] != K or not 1 <= K <= 512:
        raise ValueError(f'boxes {tuple(boxes.shape)} and scores '
                         f'{tuple(scores.shape)}: need (K, 4), (K,), '
                         f'1 <= K <= 512')
    n_out = min(max_out, K)
    keep_idx = torch.empty((n_out,), dtype=torch.int64, device=dev)
    keep_mask = torch.empty((n_out,), dtype=torch.bool, device=dev)
    _cuda.launch('nms',
                 boxes.data_ptr(), scores.data_ptr(), K, iou_thr, n_out,
                 keep_idx.data_ptr(), keep_mask.data_ptr(),
                 _cuda.stream_ptr(boxes))
    return keep_idx, keep_mask


def _dyn_params(kernels: torch.Tensor):
    """(N, 169) → [(w (N, cout, cin), b (N, cout))] of the 3 layers."""
    shapes_in = (NUM_PROTOTYPES + 2, DYCONV_CHANNELS, DYCONV_CHANNELS)
    shapes_out = (DYCONV_CHANNELS, DYCONV_CHANNELS, 1)
    ws, o = [], 0
    for wn, cin, cout in zip(WEIGHT_NUMS, shapes_in, shapes_out):
        ws.append(kernels[:, o:o + wn].reshape(-1, cout, cin))
        o += wn
    layers = []
    for w, bn in zip(ws, BIAS_NUMS):
        layers.append((w, kernels[:, o:o + bn]))
        o += bn
    return layers


def dynamic_mask_heads(mask_feat: torch.Tensor, kernels: torch.Tensor,
                       priors_xy: torch.Tensor, strides: torch.Tensor
                       ) -> torch.Tensor:
    """Per-instance dynamic 1x1 conv stack (plain). mask_feat (H, W, 8);
    kernels (N, 169); priors_xy (N, 2); strides (N,) → logits (N, H, W).
    Relative coords = (prior − coord) / (stride · 8), first in the
    input; each output is the sum over the inputs in order, then the
    bias — the order csrc/maskhead.cu sums in."""
    H, W = mask_feat.shape[:2]
    coord = level_priors(H, W, STRIDES[0], mask_feat.device).reshape(H, W, 2)
    rel = (priors_xy[:, None, None, :] - coord[None]) \
        / (strides[:, None, None, None] * 8.0)
    x = torch.cat([rel, mask_feat[None].expand(rel.shape[0], H, W,
                                               NUM_PROTOTYPES)], -1)
    layers = _dyn_params(kernels)
    for li, (w, b) in enumerate(layers):
        acc = x[..., 0:1] * w[:, None, None, :, 0]
        for c in range(1, w.shape[2]):
            acc = acc + x[..., c:c + 1] * w[:, None, None, :, c]
        x = acc + b[:, None, None, :]
        if li < len(layers) - 1:
            x = torch.relu(x)
    return x[..., 0]


def dynamic_masks_plain(mask_feat, kernels, priors_xy, strides, valid,
                        out_h: int, out_w: int, mask_thr: float):
    """Plain version of K9: dynamic heads → sigmoid → bilinear resize to
    (out_h, out_w) → > mask_thr & valid. Returns (masks (N, out_h,
    out_w) bool, probs (N, h·w) f32)."""
    probs = torch.sigmoid(dynamic_mask_heads(mask_feat, kernels, priors_xy,
                                             strides))
    up = resize_bilinear(probs.permute(1, 2, 0), out_h, out_w)
    masks = (up.permute(2, 0, 1) > mask_thr) & valid[:, None, None]
    return masks, probs.reshape(probs.shape[0], -1)


def dynamic_masks(mask_feat: torch.Tensor, kernels: torch.Tensor,
                  priors_xy: torch.Tensor, strides: torch.Tensor,
                  valid: torch.Tensor, out_h: int, out_w: int,
                  mask_thr: float):
    """K9 wrapper: the plain version on the CPU, csrc/maskhead.cu on
    CUDA (one launch: a block a band of 128 output rows of an
    instance). mask_feat (h, w, 8), kernels (N, 169), priors_xy (N,
    2), strides (N,) f32, valid (N,) bool → (masks (N, out_h, out_w)
    bool, probs (N, h·w) f32)."""
    if mask_feat.device.type == 'cpu':
        return dynamic_masks_plain(mask_feat, kernels, priors_xy, strides,
                                   valid, out_h, out_w, mask_thr)
    dev = mask_feat.device
    args = [t.contiguous() for t in (mask_feat, kernels, priors_xy, strides,
                                     valid)]
    mask_feat, kernels, priors_xy, strides, valid = args
    _cuda.check(mask_feat, 'mask_feat', torch.float32, 3, dev)
    _cuda.check(kernels, 'kernels', torch.float32, 2, dev)
    _cuda.check(priors_xy, 'priors_xy', torch.float32, 2, dev)
    _cuda.check(strides, 'strides', torch.float32, 1, dev)
    _cuda.check(valid, 'valid', torch.bool, 1, dev)
    h, w, C = mask_feat.shape
    N = kernels.shape[0]
    if C != NUM_PROTOTYPES or kernels.shape[1] != NUM_GEN_PARAMS or \
            tuple(priors_xy.shape) != (N, 2) or strides.shape[0] != N or \
            valid.shape[0] != N:
        raise ValueError('dynamic_masks: shapes do not match (h, w, 8), '
                         '(N, 169), (N, 2), (N,), (N,)')
    probs = torch.empty((N, h * w), dtype=torch.float32, device=dev)
    masks = torch.empty((N, out_h, out_w), dtype=torch.bool, device=dev)
    _cuda.launch('maskhead',
                 mask_feat.data_ptr(), kernels.data_ptr(),
                 priors_xy.data_ptr(), strides.data_ptr(), valid.data_ptr(),
                 N, h, w, out_h, out_w, mask_thr,
                 probs.data_ptr(), masks.data_ptr(),
                 _cuda.stream_ptr(mask_feat))
    return masks, probs


def candidates(cls_out, reg_out, krn_out):
    """Every level's prior as a candidate (batch 1): (scores (K,) the
    sigmoid of its best class, dists (K, 4), kernels (K, 169), priors
    (K, 2), strides (K,)), level by level."""
    dev = cls_out[0].device
    scores, dists, kernels, priors, strides = [], [], [], [], []
    for lv, (c, r, k) in enumerate(zip(cls_out, reg_out, krn_out)):
        h, w = c.shape[-3], c.shape[-2]
        scores.append(torch.sigmoid(c.reshape(-1, c.shape[-1]).amax(-1)))
        dists.append(r.reshape(-1, 4))
        kernels.append(k.reshape(-1, NUM_GEN_PARAMS))
        pr = level_priors(h, w, STRIDES[lv], dev)
        priors.append(pr)
        strides.append(torch.full((pr.shape[0],), float(STRIDES[lv]),
                                  device=dev))
    return (torch.cat(scores), torch.cat(dists), torch.cat(kernels),
            torch.cat(priors), torch.cat(strides))


def postprocess(cls_out, reg_out, krn_out, mask_feat,
                score_thr: float = 0.3, iou_thr: float = 0.6,
                mask_thr: float = 0.3, pre_topk: int = 512,
                max_det: int = 16, input_h: int = 640,
                input_w: int = 640) -> dict:
    """Head maps (channel-last, batch 1) → padded instances with masks
    at the input size: dict(bboxes (D, 4) xyxy, scores (D,), valid (D,),
    masks (D, input_h, input_w) bool), D = min(max_det, candidates)."""
    scores, dists, kernels, priors, strides = candidates(cls_out, reg_out,
                                                         krn_out)
    k = min(pre_topk, scores.shape[0])
    top_idx = _top_k_order(scores)[:k]
    top_scores = scores[top_idx]
    boxes = distance2bbox(priors[top_idx], dists[top_idx])

    keep_idx, keep_mask = nms_fixed(boxes, top_scores, iou_thr, max_det)
    det_scores = top_scores[keep_idx] * keep_mask
    det_valid = keep_mask & (det_scores > score_thr)
    det_boxes = boxes[keep_idx] * det_valid[:, None]
    sel = top_idx[keep_idx]
    feat = mask_feat[0] if mask_feat.ndim == 4 else mask_feat
    masks, _ = dynamic_masks(feat, kernels[sel], priors[sel], strides[sel],
                             det_valid, input_h, input_w, mask_thr)
    return {'bboxes': det_boxes, 'scores': det_scores, 'valid': det_valid,
            'masks': masks}
