"""Mask R-CNN, torchvision ``maskrcnn_resnet50_fpn`` (port of
``cartoonsegmentation_tpu/models/maskrcnn.py``, ``detector: maskrcnn``).

NCHW ``nn.Module``s with torchvision's legacy key names
(``backbone.body.*``, ``backbone.fpn.inner_blocks.{i}``,
``rpn.head.conv``, ``roi_heads.box_head.fc6``,
``roi_heads.mask_head.mask_fcn{i}``, ...), so ``load_state_dict`` takes
the published file; ``load_maskrcnn_state_dict`` also takes the newer
``Conv2dNormActivation`` nesting (``.0.``). The machinery keeps the JAX
version's fixed capacities: per-level top ``pre_nms_top`` anchors,
category-offset NMS to ``post_nms_top`` proposals, ``box_candidates``
detection candidates and ``max_det`` detections, invalid slots carried
with score -inf. It runs in f32; the score sigmoid and softmax and the
box decode's exp run in float64 and round to f32 once, so that the
card and the CPU give the same bits from the same head outputs.

Two kernels run here:
- K14a ``roi_align_pyramid``: ``roi_align_pyramid_plain`` (the JAX
  version's gather over the flattened pyramid) on the level map of
  ``roi_levels`` for CPU tensors, ``csrc/roialign.cu`` for CUDA ones,
  which computes the same map with the same roundings.
- K14b ``nms_large``: ``rtmdet.nms_fixed_plain`` for CPU tensors,
  ``csrc/nms_large.cu`` (any K up to 16384) for CUDA ones; the keep
  sets are exact.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _cuda
from ..ops.pointcloud import true_div
from .rtmdet import _top_k_order, nms_fixed_plain

# torchvision GeneralizedRCNNTransform stats (0-1 RGB input)
MRCNN_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
MRCNN_STD = np.array([0.229, 0.224, 0.225], np.float32)

ANCHOR_SIZES = (32., 64., 128., 256., 512.)
ASPECTS = (0.5, 1.0, 2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
NUM_CLASSES = 91
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
NMS_MAX_K = 16384


class FrozenBN(nn.Module):
    """torchvision FrozenBatchNorm2d (eps 1e-5): the stored statistics
    folded into an affine map at call time."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(ch))
        self.register_buffer('bias', torch.zeros(ch))
        self.register_buffer('running_mean', torch.zeros(ch))
        self.register_buffer('running_var', torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBN(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBN(width * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, width * 4, 1, stride, bias=False),
            FrozenBN(width * 4)) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet50(nn.Module):
    """C2..C5 feature extractor (strides 4/8/16/32)."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for li, (n, w) in enumerate(zip(blocks, (64, 128, 256, 512))):
            layer = []
            for bi in range(n):
                layer.append(Bottleneck(cin, w, 2 if (bi == 0 and li > 0)
                                        else 1, project=bi == 0))
                cin = w * 4
            setattr(self, f'layer{li + 1}', nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)             # pads with -inf
        feats = []
        for li in range(1, 5):
            x = getattr(self, f'layer{li}')(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    def __init__(self, chans=(256, 512, 1024, 2048), out_ch: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, out_ch, 1) for c in chans])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_ch, out_ch, 3, padding=1) for _ in chans])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        inners = [m(f) for m, f in zip(self.inner_blocks, feats)]
        outs = [None] * len(inners)
        last = outs[-1] = inners[-1]
        for i in range(len(inners) - 2, -1, -1):
            last = inners[i] + F.interpolate(last, size=inners[i].shape[-2:],
                                             mode='nearest')
            outs[i] = last
        outs = [m(o) for m, o in zip(self.layer_blocks, outs)]
        return outs + [F.max_pool2d(outs[-1], 1, 2, 0)]


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = ResNet50()
        self.fpn = FPN()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.fpn(self.body(x))


class RPNHead(nn.Module):
    def __init__(self, ch: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)
        self.cls_logits = nn.Conv2d(ch, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(ch, num_anchors * 4, 1)

    def forward(self, feats):
        out = []
        for f in feats:
            h = F.relu(self.conv(f))
            out.append((self.cls_logits(h), self.bbox_pred(h)))
        return out


class BoxHead(nn.Module):
    """TwoMLPHead: the (N, 256, 7, 7) RoI features flattened NCHW, as
    torchvision does."""

    def __init__(self, ch: int = 256, rep: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(ch * 49, rep)
        self.fc7 = nn.Linear(rep, rep)

    def forward(self, roi: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc7(F.relu(self.fc6(roi.flatten(1)))))


class BoxPredictor(nn.Module):
    def __init__(self, rep: int = 1024):
        super().__init__()
        self.cls_score = nn.Linear(rep, NUM_CLASSES)
        self.bbox_pred = nn.Linear(rep, NUM_CLASSES * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self, ch: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f'mask_fcn{i}', nn.Conv2d(ch, ch, 3, padding=1))

    def forward(self, roi: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            roi = F.relu(getattr(self, f'mask_fcn{i}')(roi))
        return roi


class MaskPredictor(nn.Module):
    def __init__(self, ch: int = 256):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(ch, ch, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(ch, NUM_CLASSES, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class _RPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = RPNHead()


class _RoIHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor()
        self.mask_head = MaskHead()
        self.mask_predictor = MaskPredictor()


# ---------------------------------------------------------------------------
# anchors / box transforms
# ---------------------------------------------------------------------------

def cell_anchors() -> List[np.ndarray]:
    """torchvision AnchorGenerator.generate_anchors per level (rounded
    half extents)."""
    out = []
    for s in ANCHOR_SIZES:
        hr = np.sqrt(np.asarray(ASPECTS))
        wr = 1.0 / hr
        ws, hs = wr * s, hr * s
        base = np.stack([-ws, -hs, ws, hs], 1) / 2
        out.append(np.round(base).astype(np.float32))
    return out


def level_anchors(h: int, w: int, stride: int,
                  cell: np.ndarray) -> np.ndarray:
    """(h*w*A, 4) xyxy anchors, torchvision grid order (row major,
    anchor fastest)."""
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    gy, gx = np.meshgrid(sy, sx, indexing='ij')
    shifts = np.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1., 1., 1., 1.)) -> torch.Tensor:
    """torchvision BoxCoder.decode_single."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    dx, dy, dw, dh = [true_div(deltas[..., i], weights[i]) for i in range(4)]
    dw = dw.clamp(max=BBOX_XFORM_CLIP)
    dh = dh.clamp(max=BBOX_XFORM_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    bw = _exp(dw) * aw
    bh = _exp(dh) * ah
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       -1)


def clip_boxes(boxes: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """Clip to the real image extent inside the padded canvas
    (torchvision clips to image_sizes, not the padded batch shape)."""
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


# ---------------------------------------------------------------------------
# K14b: greedy NMS over a large fixed candidate set
# ---------------------------------------------------------------------------

def nms_large(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
              max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14b wrapper: ``rtmdet.nms_fixed``'s semantics (stable score
    order in the float total order, the greedy keep, the kept boxes
    stably by score first) for 1 <= K <= 16384 candidates;
    ``nms_fixed_plain`` on the CPU, csrc/nms_large.cu on CUDA. boxes
    (K, 4) xyxy f32, scores (K,) f32 → (keep_idx (D,) int64, keep_mask
    (D,) bool), D = min(max_out, K)."""
    if boxes.device.type == 'cpu':
        return nms_fixed_plain(boxes, scores, iou_thr, max_out)
    dev = boxes.device
    boxes, scores = boxes.contiguous(), scores.contiguous()
    _cuda.check(boxes, 'boxes', torch.float32, 2, dev)
    _cuda.check(scores, 'scores', torch.float32, 1, dev)
    K = boxes.shape[0]
    if boxes.shape[1] != 4 or scores.shape[0] != K or \
            not 1 <= K <= NMS_MAX_K:
        raise ValueError(f'boxes {tuple(boxes.shape)} and scores '
                         f'{tuple(scores.shape)}: need (K, 4), (K,), '
                         f'1 <= K <= {NMS_MAX_K}')
    if boxes.data_ptr() % 16:                 # the kernel reads float4 rows
        boxes = boxes.clone()
    n_out = min(max_out, K)
    keep_idx = torch.empty((n_out,), dtype=torch.int64, device=dev)
    keep_mask = torch.empty((n_out,), dtype=torch.bool, device=dev)
    work = torch.empty((nms_large_workspace(K) // 8,), dtype=torch.int64,
                       device=dev)
    _cuda.launch('nms_large',
                 boxes.data_ptr(), scores.data_ptr(), K, iou_thr, n_out,
                 keep_idx.data_ptr(), keep_mask.data_ptr(), work.data_ptr(),
                 _cuda.stream_ptr(boxes))
    return keep_idx, keep_mask


def nms_large_workspace(K: int) -> int:
    """Bytes of csrc/nms_large.cu's scratch for K candidates: the sorted
    boxes (16 B each), the suppression mask (ceil(K/64) 8-byte words a
    row), the order and the sorted scores (4 B each)."""
    return K * (16 + 8 * -(-K // 64) + 8)


def batched_nms_fixed(boxes, scores, cats, iou_thr, max_out):
    """Category-offset NMS on a fixed candidate set: each category's
    boxes shift to a disjoint region so that cross-category pairs never
    overlap (torchvision batched_nms trick)."""
    extent = boxes.max() + 1.0
    off = cats.to(boxes.dtype) * extent
    return nms_large(boxes + off[:, None], scores, iou_thr, max_out)


# ---------------------------------------------------------------------------
# K14a: RoIAlign over a flattened pyramid
# ---------------------------------------------------------------------------

class Pyramid(NamedTuple):
    """P2..P5 as one channel-last table: ``flat`` (sum H_l*W_l, C) and
    the levels' (H_l, W_l)."""
    flat: torch.Tensor
    sizes: Tuple[Tuple[int, int], ...]


def flatten_pyramid(feats: Sequence[torch.Tensor]) -> Pyramid:
    """P2..P5 (1, C, H_l, W_l) → ``Pyramid``; made once per image and
    read by both heads' RoIAligns."""
    C = feats[0].shape[1]
    flat = torch.cat([f[0].permute(1, 2, 0).reshape(-1, C) for f in feats])
    return Pyramid(flat.contiguous(),
                   tuple((int(f.shape[-2]), int(f.shape[-1])) for f in feats))


def roi_levels(boxes: torch.Tensor, canonical: Tuple[int, int] = (224, 4)
               ) -> torch.Tensor:
    """torchvision LevelMapper: floor(4 + log2(sqrt(area)/224 + 1e-6))
    clamped to [2, 5], minus 2 → (N,) int32 (the log2 in float64,
    rounded to f32, so that every device maps a box alike)."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) \
        * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    r = true_div(torch.sqrt(area), float(canonical[0])) + 1e-6
    k = torch.floor(canonical[1] + torch.log2(r.double()).float())
    return (k.clamp(2, 5) - 2).to(torch.int32)


def roi_align_pyramid_plain(pyr: Pyramid, boxes: torch.Tensor,
                            lvl: torch.Tensor, out: int, sampling: int = 2,
                            chunk: int = 128) -> torch.Tensor:
    """Plain version of K14a: legacy (aligned=False) RoIAlign, one
    gather of the flat table per sample tap, ``chunk`` boxes at a time.
    boxes (N, 4) xyxy image pixels, lvl (N,) from ``roi_levels`` →
    (N, C, out, out)."""
    flat = pyr.flat
    dev = flat.device
    C = flat.shape[1]
    sizes = np.asarray(pyr.sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes[:, 0] * sizes[:, 1])])[:4]
    strides = torch.tensor(FPN_STRIDES[:4], dtype=torch.float32, device=dev)
    Hs = torch.from_numpy(sizes[:, 0]).to(dev)
    Ws = torch.from_numpy(sizes[:, 1]).to(dev)
    bases = torch.from_numpy(offsets).to(dev)
    g = out * sampling
    idx = true_div(torch.arange(g, dtype=torch.float32, device=dev) + 0.5,
                   float(sampling))
    res = []
    for s in range(0, boxes.shape[0], chunk):
        b, lv = boxes[s:s + chunk], lvl[s:s + chunk].long()
        N = b.shape[0]
        scale = true_div(1.0, strides[lv])
        Hn, Wn, base = Hs[lv], Ws[lv], bases[lv]
        x1 = b[:, 0] * scale
        y1 = b[:, 1] * scale
        rw = (b[:, 2] * scale - x1).clamp(min=1.0)
        rh = (b[:, 3] * scale - y1).clamp(min=1.0)
        ys = y1[:, None] + idx[None] * true_div(rh, float(out))[:, None]
        xs = x1[:, None] + idx[None] * true_div(rw, float(out))[:, None]
        # torchvision roi_align: outside [-1, size] → 0; else clamp at 0
        oob = (ys[:, :, None] < -1.0) | (ys[:, :, None] > Hn[:, None, None]) \
            | (xs[:, None, :] < -1.0) | (xs[:, None, :] > Wn[:, None, None])
        y = ys.clamp(min=0.0)
        x = xs.clamp(min=0.0)
        y0 = torch.minimum(y.long(), (Hn - 1)[:, None])
        x0 = torch.minimum(x.long(), (Wn - 1)[:, None])
        y1i = torch.minimum(y0 + 1, (Hn - 1)[:, None])
        x1i = torch.minimum(x0 + 1, (Wn - 1)[:, None])
        # y_low >= H-1 collapses both taps to H-1 with weight 0
        zero = torch.zeros((), device=dev)
        ly = torch.where(y1i > y0, (y - y0).clamp(0.0, 1.0), zero)
        lx = torch.where(x1i > x0, (x - x0).clamp(0.0, 1.0), zero)

        def tap(yi, xi):                        # (N, g, g, C)
            rows = base[:, None, None] + yi[:, :, None] * Wn[:, None, None] \
                + xi[:, None, :]
            return flat[rows]
        v = tap(y0, x0) * ((1 - ly)[:, :, None] * (1 - lx)[:, None, :]
                           )[..., None] \
            + tap(y0, x1i) * ((1 - ly)[:, :, None] * lx[:, None, :]
                              )[..., None] \
            + tap(y1i, x0) * (ly[:, :, None] * (1 - lx)[:, None, :]
                              )[..., None] \
            + tap(y1i, x1i) * (ly[:, :, None] * lx[:, None, :])[..., None]
        v = torch.where(oob[..., None], zero, v)
        v = v.reshape(N, out, sampling, out, sampling, C).mean((2, 4))
        res.append(v.permute(0, 3, 1, 2))
    if not res:
        return torch.zeros((0, C, out, out), device=dev)
    return torch.cat(res).contiguous()


def roi_align_pyramid(pyr: Pyramid, boxes: torch.Tensor, out: int,
                      sampling: int = 2) -> torch.Tensor:
    """K14a wrapper: the plain version on the level map of
    ``roi_levels`` on the CPU; csrc/roialign.cu on CUDA, which computes
    that map itself. pyr from ``flatten_pyramid`` (4 levels), boxes (N,
    4) xyxy f32 → (N, C, out, out) f32."""
    if boxes.device.type == 'cpu':
        return roi_align_pyramid_plain(pyr, boxes, roi_levels(boxes), out,
                                       sampling)
    return _roi_align_launch(pyr, boxes, out, sampling)


def _roi_align_launch(pyr: Pyramid, boxes: torch.Tensor, out: int,
                      sampling: int = 2, levels: torch.Tensor = None
                      ) -> torch.Tensor:
    """csrc/roialign.cu on CUDA tensors; ``levels``, an (N,) int32
    tensor, receives the level map the kernel used."""
    dev = boxes.device
    flat, boxes = pyr.flat.contiguous(), boxes.contiguous()
    _cuda.check(flat, 'pyramid', torch.float32, 2, dev)
    _cuda.check(boxes, 'boxes', torch.float32, 2, dev)
    if len(pyr.sizes) != 4 or boxes.shape[1] != 4 or \
            sum(h * w for h, w in pyr.sizes) != flat.shape[0]:
        raise ValueError('roi_align_pyramid: need 4 levels whose rows fill '
                         'the flat table and (N, 4) boxes')
    N, C = boxes.shape[0], flat.shape[1]
    if levels is not None:
        _cuda.check(levels, 'levels', torch.int32, 1, dev)
        if levels.shape[0] != N:
            raise ValueError(f'levels {tuple(levels.shape)}: need ({N},)')
    res = torch.empty((N, C, out, out), dtype=torch.float32, device=dev)
    hw = [v for hw in pyr.sizes for v in hw]
    _cuda.launch('roialign',
                 flat.data_ptr(), boxes.data_ptr(),
                 None if levels is None else levels.data_ptr(), N, C,
                 *hw, out, sampling, res.data_ptr(), _cuda.stream_ptr(boxes))
    return res


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x.double()).float()


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest, the lower index first among equals (as
    lax.top_k; torch.topk promises no order for ties)."""
    return _top_k_order(x)[:k]


class MaskRCNN(nn.Module):
    """image → fixed-capacity detections (boxes, labels, scores, 28x28
    mask logits), in f32."""

    def __init__(self, pre_nms_top: int = 1000, post_nms_top: int = 1000,
                 rpn_nms_thr: float = 0.7, box_score_thr: float = 0.05,
                 box_nms_thr: float = 0.5, max_det: int = 100,
                 box_candidates: int = 2048):
        super().__init__()
        self.pre_nms_top = pre_nms_top
        self.post_nms_top = post_nms_top
        self.rpn_nms_thr = rpn_nms_thr
        self.box_score_thr = box_score_thr
        self.box_nms_thr = box_nms_thr
        self.max_det = max_det
        self.box_candidates = box_candidates
        self.backbone = Backbone()
        self.rpn = _RPN()
        self.roi_heads = _RoIHeads()
        self._anchors: Dict = {}

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(1, 3, H, W) normalised → P2..P6, each (1, 256, h, w)."""
        return self.backbone(x)

    def _level_anchors(self, lv: int, h: int, w: int, dev) -> torch.Tensor:
        key = (lv, h, w, dev)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(level_anchors(
                h, w, FPN_STRIDES[lv], cell_anchors()[lv])).to(dev)
        return self._anchors[key]

    def propose(self, feats, img_h: float, img_w: float):
        """RPN inference (torchvision RegionProposalNetwork.
        filter_proposals): the head, then ``proposals_from_rpn``."""
        return self.proposals_from_rpn(self.rpn.head(feats), img_h, img_w)

    def proposals_from_rpn(self, rpn_outs, img_h: float, img_w: float):
        """Per-level top-k → decode → clip → per-level NMS (K14b) →
        the top ``post_nms_top``: (proposals (D, 4), scores (D,), -inf
        where invalid)."""
        all_boxes, all_scores, all_lvl = [], [], []
        for lv, (cls, reg) in enumerate(rpn_outs):
            h, w = cls.shape[-2:]
            anch = self._level_anchors(lv, h, w, cls.device)
            obj = cls[0].permute(1, 2, 0).reshape(-1)
            delt = reg[0].permute(1, 2, 0).reshape(-1, 4)
            k = min(self.pre_nms_top, obj.shape[0])
            top = _top_k(obj, k)
            boxes = clip_boxes(decode_boxes(anch[top], delt[top]), img_h,
                               img_w)
            ws = boxes[:, 2] - boxes[:, 0]
            hs = boxes[:, 3] - boxes[:, 1]
            score = torch.where((ws >= 1e-3) & (hs >= 1e-3),
                                _sigmoid(obj[top]),
                                torch.full_like(ws, -math.inf))
            all_boxes.append(boxes)
            all_scores.append(score)
            all_lvl.append(torch.full((k,), lv, dtype=torch.int32,
                                      device=cls.device))
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores)
        keep, mask = batched_nms_fixed(boxes, scores, torch.cat(all_lvl),
                                       self.rpn_nms_thr, self.post_nms_top)
        return boxes[keep], torch.where(mask, scores[keep],
                                        torch.full_like(scores[keep],
                                                        -math.inf))

    def box_outputs(self, roi: torch.Tensor):
        rh = self.roi_heads
        return rh.box_predictor(rh.box_head(roi))

    def mask_outputs(self, roi: torch.Tensor) -> torch.Tensor:
        rh = self.roi_heads
        return rh.mask_predictor(rh.mask_head(roi))

    def detect_boxes(self, pyr: Pyramid, proposals, prop_scores,
                     img_h: float, img_w: float):
        """Fast R-CNN branch on the fixed proposal set: RoIAlign 7x7
        (K14a), the box head, then ``boxes_from_heads``."""
        cls, reg = self.box_outputs(roi_align_pyramid(pyr, proposals, 7))
        return self.boxes_from_heads(cls, reg, proposals, prop_scores,
                                     img_h, img_w)

    def boxes_from_heads(self, cls, reg, proposals, prop_scores,
                         img_h: float, img_w: float):
        """Softmax, per-class decode and clip, score filter, the top
        ``box_candidates``, per-class NMS (K14b) to ``max_det``:
        (boxes, labels, scores (0 where invalid), mask)."""
        dev = cls.device
        probs = torch.softmax(cls.double(), -1).float()
        P = proposals.shape[0]
        boxes = decode_boxes(proposals.repeat_interleave(NUM_CLASSES, 0),
                             reg.reshape(-1, 4), weights=(10., 10., 5., 5.))
        boxes = clip_boxes(boxes, img_h, img_w).reshape(P, NUM_CLASSES, 4)
        # drop the background column; P * (C - 1) candidates
        boxes = boxes[:, 1:].reshape(-1, 4)
        scores = probs[:, 1:].reshape(-1)
        labels = torch.arange(1, NUM_CLASSES, device=dev).repeat(P)
        valid = (prop_scores > -math.inf).repeat_interleave(NUM_CLASSES - 1)
        ws = boxes[:, 2] - boxes[:, 0]
        hs = boxes[:, 3] - boxes[:, 1]
        scores = torch.where(valid & (scores > self.box_score_thr)
                             & (ws >= 1e-2) & (hs >= 1e-2), scores,
                             torch.full_like(scores, -math.inf))
        top = _top_k(scores, min(self.box_candidates, scores.shape[0]))
        top_s = scores[top]
        keep, mask = batched_nms_fixed(boxes[top], top_s, labels[top],
                                       self.box_nms_thr, self.max_det)
        sel = top[keep]
        return (boxes[sel], labels[sel],
                torch.where(mask, top_s[keep], torch.zeros_like(top_s[keep])),
                mask)

    def detect_masks(self, pyr: Pyramid, boxes, labels) -> torch.Tensor:
        """RoIAlign 14x14 (K14a), the mask head, each box's class
        channel: (D, 28, 28) logits."""
        logits = self.mask_outputs(roi_align_pyramid(pyr, boxes, 14))
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      labels]

    def forward(self, x: torch.Tensor, image_hw=None) -> Dict:
        """x (1, 3, H, W) normalised; image_hw the un-padded (h, w)
        inside the /32 canvas (the canvas when None). Returns boxes
        (D, 4) xyxy, labels (D,), scores (D,), mask logits (D, 28, 28)
        and valid (D,)."""
        H, W = x.shape[-2:]
        ih, iw = (float(H), float(W)) if image_hw is None else \
            (float(image_hw[0]), float(image_hw[1]))
        feats = self.features(x)
        proposals, pscores = self.propose(feats, ih, iw)
        pyr = flatten_pyramid(feats[:4])
        boxes, labels, scores, mask = self.detect_boxes(
            pyr, proposals, pscores, ih, iw)
        mlog = self.detect_masks(pyr, boxes, labels)
        return {'boxes': boxes, 'labels': labels, 'scores': scores,
                'masks': mlog, 'valid': mask & (scores > 0)}


def load_maskrcnn_state_dict(net: MaskRCNN, sd: Mapping) -> None:
    """Load a torchvision ``maskrcnn_resnet50_fpn`` state dict in either
    key nesting: the legacy flat convs (``inner_blocks.{i}``,
    ``rpn.head.conv``, ``mask_head.mask_fcn{i}``) or the newer
    Conv2dNormActivation ones (``inner_blocks.{i}.0``,
    ``rpn.head.conv.0.0``, ``mask_head.{i-1}.0``)."""
    rules = ((r'^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.0\.', r'\1.'),
             (r'^rpn\.head\.conv\.0\.0\.', 'rpn.head.conv.'),
             (r'^roi_heads\.mask_head\.(\d)\.0\.',
              lambda m: f'roi_heads.mask_head.mask_fcn{int(m.group(1)) + 1}.'))
    out = {}
    for k, v in sd.items():
        for pat, rep in rules:
            k = re.sub(pat, rep, k)
        out[k] = v
    net.load_state_dict(out)


# ---------------------------------------------------------------------------
# mask pasting (torchvision paste_masks_in_image)
# ---------------------------------------------------------------------------

def expand_boxes(boxes: np.ndarray, M: int) -> np.ndarray:
    """torchvision roi_heads.expand_boxes + the .to(torch.int64) that
    follows it in paste_masks_in_image: scale each box by (M+2)/M about
    its centre, then TRUNCATE toward zero (not round)."""
    scale = (M + 2.0) / M
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    hw = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    hh = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    return np.stack([cx - hw, cy - hh, cx + hw, cy + hh], 1).astype(np.int64)


def _cv2_f32_taps(n_in: int, n_out: int, columns: bool):
    """cv::resize INTER_LINEAR taps of one axis for f32 images: source
    coordinate (i + 0.5)·scale − 0.5 in double, cast to float, its
    fraction in float. Columns past an edge take the edge pixel with
    weight 1; rows keep their weights and clip the two source rows."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if columns:
        lo, hi = s < 0, s >= n_in - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = n_in - 1
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            (np.float32(1.0) - f).astype(np.float32), f)


def _resize_f32(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cv2.resize(p, (w, h), INTER_LINEAR) of a 2-D f32 map, as OpenCV
    computes it (a horizontal then a vertical pass, each two products
    and a sum in f32); exactly 2x down on both axes OpenCV takes its
    area path, the mean of each 2x2 block."""
    H, W = p.shape
    if (H, W) == (2 * h, 2 * w):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                + p[1::2, 1::2]) * 0.25
    dev = p.device
    xs0, xs1, a0, a1 = (torch.from_numpy(t).to(dev)
                        for t in _cv2_f32_taps(W, w, True))
    ys0, ys1, b0, b1 = (torch.from_numpy(t).to(dev)
                        for t in _cv2_f32_taps(H, h, False))
    rows = p[:, xs0] * a0 + p[:, xs1] * a1
    return rows[ys0] * b0[:, None] + rows[ys1] * b1[:, None]


def paste_masks(mask_logits: torch.Tensor, boxes: np.ndarray, h: int,
                w: int, thr: float = 0.5) -> torch.Tensor:
    """torchvision paste_masks_in_image on the logits' device: the
    28x28 probability padded by one cell, the box expanded by (M+2)/M,
    the f32 bilinear resize to the box's size, > thr, pasted clipped
    into (N, h, w) bool."""
    N, M = mask_logits.shape[:2]
    dev = mask_logits.device
    out = torch.zeros((N, h, w), dtype=torch.bool, device=dev)
    eb = expand_boxes(np.asarray(boxes, np.float32).reshape(-1, 4), M)
    prob = F.pad(torch.sigmoid(mask_logits.double()).float(), (1, 1, 1, 1))
    for i in range(N):
        x1, y1, x2, y2 = (int(v) for v in eb[i])
        bw, bh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        xs, xe = max(x1, 0), min(x2 + 1, w)
        ys, ye = max(y1, 0), min(y2 + 1, h)
        if xs < xe and ys < ye:
            m = _resize_f32(prob[i], bh, bw) > thr
            out[i, ys:ye, xs:xe] = m[ys - y1:ye - y1, xs - x1:xe - x1]
    return out
