"""Detector training step on one device (port of
``cartoonsegmentation_tpu/parallel/train.py``; the JAX package's data
mesh across devices is not ported yet).

The loss is the functional RTMDet-Ins loss: quality-focal BCE over all
priors, GIoU on positives, dice on the top-8 positives' masks through
the dynamic heads (K9t, ``models/rtmdet.py:dynamic_mask_heads_train``:
its CUDA kernels on the card, the plain version under autograd on the
CPU). Positives come from the DynamicSoftLabelAssigner
(``parallel/dsla.py``); the JAX package's centre-distance alternative
(``assigner='center'``), which no caller selects, is not ported.

BatchNorm runs in train mode: batch statistics over the step's batch by
flax's rule (``models/cspnext.py:BatchNorm2d``), running statistics
updated in place during the forward, as the JAX step returns them.

The optimizer is the chain the JAX training CLI builds with optax
(``scripts/train_detector.py:105-108``): ``clip_by_global_norm``, then
``adamw`` on ``warmup_cosine_decay_schedule`` — here ``torch.optim.AdamW``
(decoupled decay of every parameter, BatchNorm scales and biases
included), the port's own clip (scaled by max_norm / norm only when the
norm reaches max_norm, with no epsilon) and schedule (evaluated at the
update count before it is incremented: the first update has lr 0).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..models.rtmdet import (NUM_GEN_PARAMS, STRIDES, AnimeDetector,
                             _top_k_order, distance2bbox,
                             dynamic_mask_heads_train, level_priors)
from .dsla import dynamic_soft_label_assign


# ---------------------------------------------------------------------------
# the optimizer chain
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule``: linear from init_value
    to peak_value over warmup_steps, then a cosine to end_value at
    decay_steps (counted from 0, warmup included). Returns count →
    value."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError('warmup_cosine_decay_schedule: decay_steps must '
                         'exceed warmup_steps')

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


@torch.no_grad()
def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the parameters' gradients in
    place: g ← (g / norm) · max_norm where norm ≥ max_norm, else g as it
    is. Returns the norm (a device scalar; no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclass
class AdamWChain:
    """The JAX CLI's optax chain as a description: clip the global
    gradient norm at ``clip_norm``, then AdamW (optax's defaults: betas
    0.9, 0.999, eps 1e-8) with ``weight_decay`` at the learning rate
    ``schedule(count)``."""
    schedule: object
    weight_decay: float
    clip_norm: float

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)


def make_optimizer(lr: float, weight_decay: float, warmup: int, steps: int,
                   clip_norm: float) -> AdamWChain:
    """The chain of scripts/train_detector.py: warmup from 0 to ``lr``
    over ``warmup`` updates, cosine to 0 at max(steps, warmup + 1)."""
    return AdamWChain(
        warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1)),
        weight_decay, clip_norm)


def apply_updates(tx: AdamWChain, opt: torch.optim.Optimizer,
                  params: List[torch.Tensor], count: int) -> torch.Tensor:
    """One update of the chain on the gradients in ``.grad``: clip, then
    AdamW at ``schedule(count)`` (``count`` the updates made before).
    Returns the gradients' global norm before the clip."""
    norm = clip_by_global_norm_(params, tx.clip_norm)
    for group in opt.param_groups:
        group['lr'] = float(tx.schedule(count))
    opt.step()
    return norm


# ---------------------------------------------------------------------------
# state, loss, step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The detector (parameters and BatchNorm buffers), its optimizer and
    the count of updates made."""
    model: AnimeDetector
    opt: torch.optim.Optimizer
    step: int
    params: List[torch.Tensor]


def create_train_state(model: AnimeDetector, tx: AdamWChain) -> TrainState:
    """The model in train mode and a fresh optimizer over its (unique)
    parameters."""
    params = list(model.parameters())
    return TrainState(model.train(), tx.init(params), 0, params)


def _flatten_levels(cls_out, reg_out, krn_out):
    dev = cls_out[0].device
    scores, dists, kernels, priors, strides = [], [], [], [], []
    for lv, (c, r, k) in enumerate(zip(cls_out, reg_out, krn_out)):
        B, h, w = c.shape[0], c.shape[1], c.shape[2]
        scores.append(c.reshape(B, -1, c.shape[-1]))
        dists.append(r.reshape(B, -1, 4))
        kernels.append(k.reshape(B, -1, NUM_GEN_PARAMS))
        pr = level_priors(h, w, STRIDES[lv], dev)
        priors.append(pr)
        strides.append(torch.full((pr.shape[0],), float(STRIDES[lv]),
                                  device=dev))
    return (torch.cat(scores, 1), torch.cat(dists, 1), torch.cat(kernels, 1),
            torch.cat(priors, 0), torch.cat(strides, 0))


def _rowwise_iou(a, b):
    """IoU of each box of a with the box of b in its row (JAX's vmap of
    box_iou over single boxes)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    return inter / (area_a + area_b - inter).clamp(min=1e-9)


def _giou(a, b):
    iou = _rowwise_iou(a, b)
    lt = torch.minimum(a[:, :2], b[:, :2])
    rb = torch.maximum(a[:, 2:], b[:, 2:])
    area_c = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    lt_i = torch.maximum(a[:, :2], b[:, :2])
    rb_i = torch.minimum(a[:, 2:], b[:, 2:])
    inter = (rb_i - lt_i).clamp(min=0).prod(-1)
    union = area_a + area_b - inter
    return iou - (area_c - union) / area_c.clamp(min=1e-9)


def sigmoid_binary_cross_entropy(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy`` as the JAX package's
    optax computes it: −z·log σ(x) − (1 − z)·log σ(−x)."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


MASK_TOPK = 8


def detector_loss(model: AnimeDetector, batch: Dict[str, torch.Tensor],
                  mask_loss_stride: int = 4):
    """batch: images (B, H, W, 3) in [0, 1], gt_boxes (B, G, 4) xyxy,
    gt_valid (B, G), gt_masks (B, G, H, W), optional gt_ignore (B, G),
    tensors on the model's device. Returns (loss, metrics dict, extras)
    with ``extras`` the assigner's 'pos' and 'gt_idx' of each image, for
    the tests and the chip run.

    Ignore-mask semantics (reference rtmdet_inshead_custom.py:186-248):
    instances flagged ``gt_ignore`` take part in assignment, cls and
    bbox supervision and are left out of the mask loss."""
    images = batch['images']
    gt_boxes, gt_valid, gt_masks = (batch['gt_boxes'], batch['gt_valid'],
                                    batch['gt_masks'])
    gt_ignore = batch.get('gt_ignore')
    if gt_ignore is None:
        gt_ignore = torch.zeros_like(gt_valid, dtype=torch.bool)
    B, H, W = images.shape[:3]
    cls_out, reg_out, krn_out, mask_feat = model(
        images.permute(0, 3, 1, 2).contiguous())
    scores, dists, kernels, priors, strides = _flatten_levels(
        cls_out, reg_out, krn_out)

    K = MASK_TOPK
    boxes_all, tgt_all, quality_all, pos_all, idx_all = [], [], [], [], []
    top_all, ok_all = [], []
    for b in range(B):
        boxes = distance2bbox(priors, dists[b])
        pos, gt_idx, _ = dynamic_soft_label_assign(
            priors, strides, scores[b].detach(), boxes.detach(), gt_boxes[b],
            gt_valid[b])
        tgt_boxes = gt_boxes[b][gt_idx]
        # quality focal target: the IoU at positives (with its gradient,
        # as in JAX), 0 elsewhere
        iou = _rowwise_iou(boxes, tgt_boxes)
        quality = torch.where(pos, iou, torch.zeros_like(iou))
        mask_ok = pos & ~gt_ignore[b][gt_idx]
        pos_score = torch.where(mask_ok, quality.detach(),
                                torch.full_like(quality, -1.0))
        top = _top_k_order(pos_score)[:K]
        boxes_all.append(boxes)
        tgt_all.append(tgt_boxes)
        quality_all.append(quality)
        pos_all.append(pos)
        idx_all.append(gt_idx)
        top_all.append(top)
        ok_all.append(mask_ok[top])

    # the mask heads of every image's top-K positives at once (K9t)
    tops = torch.stack(top_all)                                # (B, K)
    logits = dynamic_mask_heads_train(
        mask_feat, torch.stack([kernels[b][tops[b]] for b in range(B)]),
        priors[tops], strides[tops])                           # (B, K, h, w)
    s = mask_loss_stride
    logits_up = F.interpolate(logits, size=(H // s, W // s), mode='bilinear',
                              align_corners=False)

    lc, lb, lm = [], [], []
    for b in range(B):
        pos, quality = pos_all[b], quality_all[b]
        logit = scores[b][..., 0]
        p = torch.sigmoid(logit)
        qfl = (quality - p).abs() ** 2 * \
            sigmoid_binary_cross_entropy(logit, quality)
        n_pos = pos.sum().float().clamp(min=1.0)
        lc.append(qfl.sum() / n_pos)

        giou = _giou(boxes_all[b], tgt_all[b])
        lb.append(torch.where(pos, 1.0 - giou, torch.zeros_like(giou)).sum()
                  / n_pos)

        sel_valid = ok_all[b].float()
        tgt = gt_masks[b][idx_all[b][top_all[b]]]
        tgt_ds = tgt[:, s // 2::s, s // 2::s][:, :H // s, :W // s].float()
        probs = torch.sigmoid(logits_up[b])
        eps = 5e-6
        inter = (probs * tgt_ds).sum((1, 2))
        denom = (probs * probs).sum((1, 2)) + eps \
            + (tgt_ds * tgt_ds).sum((1, 2)) + eps
        dice = 1.0 - 2.0 * inter / denom
        lm.append((dice * sel_valid).sum() / sel_valid.sum().clamp(min=1.0))

    lc, lb, lm = torch.stack(lc).mean(), torch.stack(lb).mean(), \
        torch.stack(lm).mean()
    # reference loss weights (mmdet rtmdet-ins defaults): cls 1.0 QFL,
    # bbox 2.0 GIoU, mask 2.0 dice
    loss = lc + 2.0 * lb + 2.0 * lm
    metrics = {'loss': loss.detach(), 'loss_cls': lc.detach(),
               'loss_bbox': lb.detach(), 'loss_mask': lm.detach()}
    return loss, metrics, {'pos': pos_all, 'gt_idx': idx_all}


def make_train_step(tx: AdamWChain):
    """train_step(state, batch) → metrics: the loss's gradients, the
    chain's update, one more count. Metrics stay on the device."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        state.model.train()
        state.opt.zero_grad(set_to_none=True)
        loss, metrics, _ = detector_loss(state.model, batch)
        loss.backward()
        apply_updates(tx, state.opt, state.params, state.step)
        state.step += 1
        return metrics

    return train_step


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: List[torch.Tensor],
               decay) -> None:
    """In place: ema ← ema · decay + p · (1 − decay), parameter by
    parameter (the reference RTMDet recipe ships EMA weights: mmdet
    ExpMomentumEMA, decay 0.9998)."""
    d = torch.as_tensor(decay, dtype=torch.float32).to(ema_params[0].device)
    for e, p in zip(ema_params, params):
        e.copy_(e * d + p * (1.0 - d))


def ema_decay_schedule(base_decay: float, step) -> torch.Tensor:
    """Warm-up decay min(base, (1 + step) / (10 + step)) in f32 (timm /
    mmdet convention), at the update count after the step."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.minimum(torch.tensor(base_decay, dtype=torch.float32),
                         (1.0 + step) / (10.0 + step))
