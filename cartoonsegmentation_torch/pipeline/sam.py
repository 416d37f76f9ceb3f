"""Box-prompted SAM for ``detector: sam`` (PyTorch port of
``cartoonsegmentation_tpu/pipeline/sam.py``).

AnimeInsSeg proposes boxes and SAM replaces their masks (the
reference's ``forward_sam``, kenburns_effect.py:848-860). The image is
letterboxed to ``img_size`` on the host with cv2's uint8 INTER_LINEAR
bytes (``resize_linear_u8``, no cv2 needed), normalised on the device
with a zero pad band, encoded once per canvas (the embedding is cached
on the canvas bytes) and decoded for a fixed box capacity. The
quarter-resolution logits are cropped to the letterbox and resized to
the image on the device in one bilinear call (half-pixel centres, no
antialias: cv2's float INTER_LINEAR), then thresholded at 0.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.sam import (SAM, SAM_MEAN, SAM_STD, init_sam_,
                          load_sam_state_dict, sam_vit_b, sam_vit_h,
                          sam_vit_l)
from ..utils.image import resize_linear_u8
from ..utils.profiling import StageTimer

from ..utils.logger import LOGGER

_BUILDERS = {'vit_b': sam_vit_b, 'vit_l': sam_vit_l, 'vit_h': sam_vit_h}


def normalize_pad(canvas_u8: torch.Tensor, image_hw: Sequence[int]
                  ) -> torch.Tensor:
    """uint8 letterbox canvas (S, S, 3) → normalised f32 with a zero
    pad band: normalise first, then zero the rows and columns beyond
    ``image_hw``, as the official predictor pads after normalising."""
    dev = canvas_u8.device
    mean = torch.from_numpy(SAM_MEAN).to(dev)
    std = torch.from_numpy(SAM_STD).to(dev)
    x = (canvas_u8.to(torch.float32) - mean) / std
    yy = torch.arange(canvas_u8.shape[0], device=dev)[:, None] < image_hw[0]
    xx = torch.arange(canvas_u8.shape[1], device=dev)[None, :] < image_hw[1]
    return torch.where((yy & xx)[..., None], x, torch.zeros((), device=dev))


class NativeSAM:
    """segment_anything-predictor equivalent, boxes only. Without a
    checkpoint the model has random weights made from ``seed``."""

    def __init__(self, model_type: str = 'vit_b', img_size: int = 1024,
                 capacity: int = 16, seed: int = 0,
                 model: Optional[SAM] = None, device=None):
        if model is None and model_type not in _BUILDERS:
            raise ValueError(f'unknown SAM variant {model_type!r}')
        self.model_type = model_type
        self.model = model
        self.img_size = model.img_size if model is not None else img_size
        self.capacity = capacity
        self.device = resolve_device(device)
        self._seed = seed
        self._emb: Optional[torch.Tensor] = None
        self._emb_key = None
        # 'sam_encode' and 'sam_decode'; KenBurnsPipeline puts its own
        # timer here
        self.timer = StageTimer()

    def _net(self) -> SAM:
        if self.model is None:
            LOGGER.warning('NativeSAM: RANDOM weights (no checkpoint '
                           'loaded)')
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.model = init_sam_(_BUILDERS[self.model_type](
                    self.img_size))
        return self.model.to(self.device, torch.float32).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        """An official sam_vit_*.pth state dict."""
        sd = torch.load(path, map_location='cpu', weights_only=True)
        net = _BUILDERS[self.model_type](self.img_size)
        load_sam_state_dict(net, sd)
        self.model = net
        self._emb_key = None

    def _prepare(self, img_bgr: np.ndarray
                 ) -> Tuple[np.ndarray, float, int, int]:
        h, w = img_bgr.shape[:2]
        scale = self.img_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = resize_linear_u8(img_bgr, nh, nw) if (nh, nw) != (h, w) \
            else img_bgr
        canvas = np.zeros((self.img_size, self.img_size, 3), np.uint8)
        canvas[:nh, :nw] = resized[..., ::-1]      # the model wants RGB
        return canvas, scale, nh, nw

    @torch.inference_mode()
    def segment_boxes(self, img_bgr: np.ndarray, boxes_xyxy: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """BGR uint8 image + (N, 4) xyxy pixel boxes → ((N, H, W) bool
        masks, (N,) predicted IoU) on the device. Boxes beyond the
        capacity get empty masks and IoU 0; fewer are padded."""
        dev = self.device
        h, w = img_bgr.shape[:2]
        boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
        n = min(len(boxes), self.capacity)
        net = self._net()
        canvas, scale, nh, nw = self._prepare(img_bgr)
        # keyed on the canvas bytes, never id(): a freed image's id can
        # come back for the next one
        key = (img_bgr.shape, hashlib.sha1(canvas.tobytes()).hexdigest())
        if self._emb_key != key:
            with self.timer.time('sam_encode', dev):
                x = normalize_pad(torch.from_numpy(canvas).to(dev), (nh, nw))
                self._emb = net.encode(x[None])[0]
            self._emb_key = key
        with self.timer.time('sam_decode', dev):
            kb = np.zeros((self.capacity, 4), np.float32)
            kb[:, 2:] = 1.0
            kb[:n] = boxes[:n] * scale
            logits, iou = net.decode(self._emb, torch.from_numpy(kb).to(dev),
                                     multimask=False)
            q = net.patch // 4                       # the logits' stride
            ch, cw = -(-nh // q), -(-nw // q)
            masks = torch.zeros((len(boxes), h, w), dtype=torch.bool,
                                device=dev)
            ious = torch.zeros((len(boxes),), dtype=torch.float32, device=dev)
            if n:
                up = F.interpolate(logits[:n, None, :ch, :cw], size=(h, w),
                                   mode='bilinear', align_corners=False)
                masks[:n] = up[:, 0] > 0.0
                ious[:n] = iou[:n]
        return masks, ious


class SamDetector:
    """``detector: sam``: the box detector's boxes re-masked by SAM
    (kenburns_effect.py:848-860 forward_sam)."""

    def __init__(self, box_detector, sam: Optional[NativeSAM] = None):
        self.box_detector = box_detector
        self.sam = sam if sam is not None else NativeSAM(
            capacity=box_detector.max_instances,
            seed=getattr(box_detector, '_seed', 0),
            device=getattr(box_detector, 'device', None))

    @property
    def max_instances(self) -> int:
        return self.box_detector.max_instances

    @property
    def timer(self) -> StageTimer:
        return self.sam.timer

    @timer.setter
    def timer(self, timer: StageTimer) -> None:
        self.box_detector.timer = self.sam.timer = timer

    def load_torch_checkpoints(self, det_ckpt: Optional[str] = None,
                               sam_ckpt: Optional[str] = None) -> None:
        if det_ckpt:
            self.box_detector.load_torch_checkpoint(det_ckpt)
        if sam_ckpt:
            self.sam.load_torch_checkpoint(sam_ckpt)

    def infer(self, img, pred_score_thr: float = 0.3, **kw):
        if isinstance(img, str):
            import cv2
            img = cv2.imread(img)
        ins = self.box_detector.infer(img, pred_score_thr, **kw)
        xywh = ins.bboxes.cpu().numpy()
        # int32 xyxy by truncation before prompting (:853-856)
        xyxy = np.stack([xywh[:, 0], xywh[:, 1], xywh[:, 0] + xywh[:, 2],
                         xywh[:, 1] + xywh[:, 3]], 1).astype(np.int32)
        masks, _ = self.sam.segment_boxes(img, xyxy.astype(np.float32))
        masks = masks.to(ins.masks.device)
        return ins.replace(masks=masks & ins.valid[:, None, None])

    __call__ = infer
