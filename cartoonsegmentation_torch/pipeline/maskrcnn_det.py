"""``detector: maskrcnn``, the reference's COCO Mask R-CNN option
(PyTorch port of ``cartoonsegmentation_tpu/pipeline/maskrcnn_det.py``).

Parity: anime_3dkenburns/kenburns_effect.py:843-886 (``maskrcnn_forward``:
torchvision ``maskrcnn_resnet50_fpn``, every class kept above score
0.3, mask probability > 0.5). torchvision's GeneralizedRCNNTransform is
reproduced on the host: the min-side 800 / max-side 1333 resize with
cv2's uint8 INTER_LINEAR bytes (``resize_linear_u8``, no cv2 needed)
and a /32 canvas; the canvas is normalised on the device with a zero
pad band. The net (models/maskrcnn.py, kernels K14a and K14b) runs in
f32 on the device, and so does the paste of the kept masks.

Reference quirk, transcribed deliberately: ``maskrcnn_forward`` feeds
``img_tensor[0, [2, 0, 1]]``, channel order (R, B, G) of the BGR frame,
not RGB (kenburns_effect.py:877).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..instances import Instances
from ..models.maskrcnn import (MRCNN_MEAN, MRCNN_STD, MaskRCNN,
                               load_maskrcnn_state_dict, paste_masks)
from ..ops.pointcloud import true_div
from ..utils.image import resize_linear_u8
from ..utils.profiling import StageTimer

from ..utils.logger import LOGGER


def normalize_pad(canvas_u8: torch.Tensor, image_hw: Sequence[int]
                  ) -> torch.Tensor:
    """uint8 /32 canvas (H, W, 3) → normalised f32 with a zero pad band.
    torchvision normalises first and pads with zeros after, so the band
    beyond ``image_hw`` is 0.0, not (0 - mean) / std. The channels go
    in the reference's (R, B, G) order of the BGR canvas."""
    dev = canvas_u8.device
    x = true_div(canvas_u8.to(torch.float32), 255.0)[..., [2, 0, 1]]
    x = (x - torch.from_numpy(MRCNN_MEAN).to(dev)) \
        / torch.from_numpy(MRCNN_STD).to(dev)
    yy = torch.arange(canvas_u8.shape[0], device=dev)[:, None] < image_hw[0]
    xx = torch.arange(canvas_u8.shape[1], device=dev)[None, :] < image_hw[1]
    return torch.where((yy & xx)[..., None], x, torch.zeros((), device=dev))


class MaskRCNNDetector:
    """img → Instances, pluggable into KenBurnsPipeline. Without a
    checkpoint the net has random weights made from ``seed``."""

    def __init__(self, capacity: int = 16, min_size: int = 800,
                 max_size: int = 1333, score_thr: float = 0.3,
                 model: Optional[MaskRCNN] = None, seed: int = 0,
                 device=None):
        self.model = model
        self.capacity = capacity
        self.min_size = min_size
        self.max_size = max_size
        self.score_thr = score_thr
        self.device = resolve_device(device)
        self._seed = seed
        # 'detector_forward' (resize, net) and 'detector_paste';
        # KenBurnsPipeline puts its own timer here
        self.timer = StageTimer()

    def _net(self) -> MaskRCNN:
        if self.model is None:
            LOGGER.warning('MaskRCNNDetector: RANDOM weights (no checkpoint '
                           'loaded)')
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.model = MaskRCNN()
        return self.model.to(self.device, torch.float32).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        """A torchvision ``maskrcnn_resnet50_fpn`` state dict (either key
        nesting; under 'model' in training checkpoints)."""
        sd = torch.load(path, map_location='cpu', weights_only=True)
        if isinstance(sd, dict) and 'model' in sd:
            sd = sd['model']
        old = self.model
        net = MaskRCNN() if old is None else MaskRCNN(
            old.pre_nms_top, old.post_nms_top, old.rpn_nms_thr,
            old.box_score_thr, old.box_nms_thr, old.max_det,
            old.box_candidates)
        load_maskrcnn_state_dict(net, sd)
        self.model = net

    def canvas(self, img: np.ndarray):
        """The /32 canvas (uint8, image top-left), the scale and the
        resized (nh, nw)."""
        h, w = img.shape[:2]
        scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        ch, cw = -(-nh // 32) * 32, -(-nw // 32) * 32
        resized = resize_linear_u8(img, nh, nw) if (nh, nw) != (h, w) \
            else img
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = resized
        return canvas, scale, (nh, nw)

    @torch.no_grad()
    def infer(self, img, pred_score_thr: Optional[float] = None,
              **kw) -> Instances:
        if isinstance(img, str):
            import cv2
            img = cv2.imread(img)
        thr = self.score_thr if pred_score_thr is None else pred_score_thr
        h, w = img.shape[:2]
        dev = self.device
        with self.timer.time('detector_forward', dev):
            canvas, scale, (nh, nw) = self.canvas(img)
            net = self._net()
            x = normalize_pad(torch.from_numpy(canvas).to(dev), (nh, nw))
            out = net(x.permute(2, 0, 1)[None].contiguous(), (nh, nw))
            boxes = true_div(out['boxes'], scale).cpu().numpy()
            scores = out['scores'].cpu().numpy()
            valid = out['valid'].cpu().numpy() & (scores > thr)
        with self.timer.time('detector_paste', dev):
            order = np.argsort(-np.where(valid, scores, -1.0),
                               kind='stable')[:self.capacity]
            order = order[valid[order]]
            boxes = np.clip(boxes[order], 0, [w, h, w, h]).astype(np.float32)
            mlog = out['masks'][torch.from_numpy(order).to(dev)]
            masks = paste_masks(mlog, boxes, h, w)
            n = len(order)
            ins = Instances.empty(self.capacity, h, w, dev)
            xywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]],
                                  1)
            ins.masks[:n] = masks
            ins.bboxes[:n] = torch.from_numpy(np.round(xywh)).to(dev)
            ins.scores[:n] = torch.from_numpy(scores[order]).to(dev)
            ins.valid[:n] = True
        return ins

    __call__ = infer
