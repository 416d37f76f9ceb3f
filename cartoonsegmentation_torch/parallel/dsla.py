"""Dynamic Soft Label Assigner (port of
``cartoonsegmentation_tpu/parallel/dsla.py``), plain torch on the
detector's device.

mmdet's ``DynamicSoftLabelAssigner(topk=13)`` at fixed shapes: gts
padded to G with a validity mask, candidates are priors strictly inside
a gt box, cost = soft classification cost + 3·(−log IoU) +
10^(centre distance / stride − 3), each gt takes its dyn_k = clamp(int(sum
of its top-13 candidate IoUs), 1, A) lowest-cost candidates by a rank
test, and a prior claimed by several gts keeps its lowest-cost one.

Orders as JAX's: the rank sorts are stable (``jnp.argsort``), ties of
the conflict argmin go to the lower gt index. No gradient flows through
the assignment (the loss uses only its indices).
"""
from __future__ import annotations

import torch

from ..models.rtmdet import box_iou

BIG = 1e8
EPS = 1e-7


@torch.no_grad()
def dynamic_soft_label_assign(priors: torch.Tensor, strides: torch.Tensor,
                              cls_logits: torch.Tensor,
                              decoded_boxes: torch.Tensor,
                              gt_boxes: torch.Tensor,
                              gt_valid: torch.Tensor,
                              gt_labels: torch.Tensor = None,
                              topk: int = 13,
                              iou_weight: float = 3.0,
                              soft_center_radius: float = 3.0):
    """priors (A, 2) centres; strides (A,); cls_logits (A, C);
    decoded_boxes (A, 4) xyxy; gt_boxes (G, 4) xyxy (padded); gt_valid
    (G,) bool; gt_labels (G,) int (default all class 0).

    Returns (pos (A,) bool, gt_idx (A,) int64, assigned_iou (A,))."""
    A = priors.shape[0]
    G = gt_boxes.shape[0]
    C = cls_logits.shape[-1]
    dev = priors.device
    if gt_labels is None:
        gt_labels = torch.zeros((G,), dtype=torch.int64, device=dev)

    # candidates: prior centre strictly inside the gt box
    lt = priors[None, :, :] - gt_boxes[:, None, :2]           # (G, A, 2)
    rb = gt_boxes[:, None, 2:] - priors[None, :, :]
    inside = torch.cat([lt, rb], -1).amin(-1) > 0             # (G, A)
    cand = inside & gt_valid[:, None]

    iou = box_iou(gt_boxes, decoded_boxes)
    iou = torch.where(cand, iou, torch.zeros_like(iou))

    # soft centre prior
    gt_cx = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
    gt_cy = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
    dist = torch.sqrt((priors[None, :, 0] - gt_cx[:, None]) ** 2 +
                      (priors[None, :, 1] - gt_cy[:, None]) ** 2)
    dist = dist / strides[None, :]
    center_cost = torch.pow(10.0, dist - soft_center_radius)

    # soft classification cost
    onehot = torch.nn.functional.one_hot(gt_labels.long(), C).float()
    soft_label = onehot[:, None, :] * iou[..., None]          # (G, A, C)
    p = torch.sigmoid(cls_logits)[None]
    scale = (soft_label - p).abs() ** 2.0
    bce = cls_logits.clamp(min=0)[None] \
        - cls_logits[None] * soft_label \
        + torch.log1p(torch.exp(-cls_logits.abs()))[None]
    cls_cost = (bce * scale).sum(-1)                          # (G, A)

    iou_cost = -torch.log(iou + EPS) * iou_weight
    cost = cls_cost + iou_cost + center_cost
    cost = torch.where(cand, cost, torch.full_like(cost, BIG))

    # dynamic k from the top-`topk` candidate IoUs of each gt
    k_iou = torch.topk(iou, min(topk, A), dim=1).values
    dyn_k = k_iou.sum(-1).to(torch.int32).clamp(1, A)

    # each gt's k lowest-cost candidates by a rank test
    order = torch.argsort(cost, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    match = (rank < dyn_k[:, None]) & cand & (cost < BIG)

    # conflicts: a prior keeps only its lowest-cost gt
    masked = torch.where(match, cost, torch.full_like(cost, BIG))
    best, best_gt = masked.min(0)
    pos = best < BIG
    assigned_iou = torch.where(pos, iou[best_gt, torch.arange(A, device=dev)],
                               torch.zeros_like(best))
    return pos, best_gt, assigned_iou
