"""AnimeInsSeg — anime instance segmentation (port of
``cartoonsegmentation_tpu/pipeline/segment.py``: ``infer`` with its
refine step, the batch ``infer_batch``, the candidate embeddings
``infer_embeddings`` and ``segment_with_bboxes``, which decodes masks
for given boxes, and the per-instance Danbooru tags, ``init_tagger`` /
``infer_tags``).

detect → score filter → (optional) mask refinement → Instances. The
mmdet test pipeline is reproduced on the host: keep-ratio resize to
``det_size`` with cv2's uint8 INTER_LINEAR bytes (``resize_linear_u8``,
which needs no cv2) and a bottom/right pad to a square of 114s; the
canvas goes to the device as uint8 and is normalised there. The
forward runs in the conv dtype, the postprocess (kernels K8 and K9) in
f32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..instances import Instances
from ..models.rtmdet import (AnimeDetector, _top_k_order, box_iou,
                             candidates, distance2bbox, dynamic_masks,
                             postprocess)
from ..ops.pointcloud import true_div
from ..utils.image import resize_bilinear, resize_linear_u8
from ..utils.profiling import StageTimer

from ..utils.logger import LOGGER

# RTMDet data_preprocessor constants (BGR order, bgr_to_rgb=False)
_MEAN = (103.53, 116.28, 123.675)
_STD = (57.375, 57.12, 58.395)
_PAD_VAL = 114


def normalize_canvas(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std in f32, a true division as the JAX version's."""
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_STD, dtype=torch.float32, device=x.device)
    return (x.float() - mean) / std


class AnimeInsSeg:
    """Detector wrapper. Without a checkpoint the detector runs with
    random weights made from ``seed``; ``load_torch_checkpoint``
    installs published ones. ``deepen``/``widen`` shrink the net for
    tests (L = 1.0 / 1.0)."""

    def __init__(self, det_size: int = 640, mask_thr: float = 0.3,
                 max_instances: int = 100, dtype: str = 'auto',
                 seed: int = 0, device=None, deepen: float = 1.0,
                 widen: float = 1.0):
        self.det_size = det_size
        self.mask_thr = mask_thr
        self.max_instances = max_instances
        self.device = resolve_device(device)
        # 'auto': bf16 convs on CUDA (the reference runs fp16, the JAX
        # package bf16 on the TPU), f32 on the CPU; heads emit f32
        self.dtype_name = dtype
        self.dtype = resolve_dtype(dtype, self.device)
        self._seed = seed
        self._shape = (deepen, widen)
        self.model: Optional[AnimeDetector] = None
        self.refine = None  # installed by set_refine_method
        self.tagger = None  # installed by init_tagger
        # 'detector_forward' (letterbox, nets, postprocess, un-letterbox)
        # and 'detector_refine'; KenBurnsPipeline puts its own timer here
        self.timer = StageTimer()

    def _net(self) -> AnimeDetector:
        if self.model is None:
            LOGGER.warning('AnimeInsSeg: RANDOM detector weights (no '
                           'checkpoint loaded)')
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.model = AnimeDetector(*self._shape)
        return self.model.to(self.device, self.dtype).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        """rtmdetl_e60.ckpt: an mmdet state dict (under 'state_dict'
        with 'model.'-prefixed keys in lightning checkpoints)."""
        ckpt = torch.load(path, map_location='cpu', weights_only=False)
        sd = ckpt.get('state_dict', ckpt)
        if any(k.startswith('model.') for k in sd):
            sd = {k[len('model.'):]: v for k, v in sd.items()
                  if k.startswith('model.')}
        self.load_variables({k: v for k, v in sd.items() if k.split('.')[0]
                             in ('backbone', 'neck', 'bbox_head')})

    def load_variables(self, variables) -> None:
        """Install weights: a state dict of ``AnimeDetector`` (its
        backbone.*, neck.* and bbox_head.* keys, the mmdet names), loaded
        strictly into a net of this detector's shape."""
        net = AnimeDetector(*self._shape)
        net.load_state_dict(variables)
        self.model = net

    def _preprocess(self, img_bgr: np.ndarray):
        """Keep-ratio resize to det_size + bottom/right pad. Returns the
        unnormalised (1, S, S, 3) canvas (uint8 for uint8 input, else
        f32), the scale and (nh, nw)."""
        h, w = img_bgr.shape[:2]
        scale = self.det_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if img_bgr.dtype == np.uint8:
            resized = resize_linear_u8(img_bgr, nh, nw) \
                if (nh, nw) != (h, w) else img_bgr
            dt = np.uint8
        else:
            x = torch.from_numpy(np.ascontiguousarray(img_bgr, np.float32))
            resized = resize_bilinear(x, nh, nw).numpy()   # cv2's float path
            dt = np.float32
        canvas = np.full((self.det_size, self.det_size, 3), dt(_PAD_VAL), dt)
        canvas[:nh, :nw] = resized.astype(dt)
        return canvas[None], scale, (nh, nw)

    def _forward(self, x: np.ndarray):
        """The net's head maps of the (B, S, S, 3) canvases."""
        canvas = torch.from_numpy(x).to(self.device)
        inp = normalize_canvas(canvas).permute(0, 3, 1, 2).to(self.dtype)
        return self._net()(inp.contiguous())

    def _postprocess(self, maps) -> dict:
        """Fixed-shape postprocess (K8, K9) of one image's head maps at
        det_size (score_thr 0; _rescale applies the score filter)."""
        return postprocess(*maps, score_thr=0.0, mask_thr=self.mask_thr,
                           pre_topk=512, max_det=self.max_instances,
                           input_h=self.det_size, input_w=self.det_size)

    @torch.inference_mode()
    def _run_device(self, x: np.ndarray) -> dict:
        """Forward + fixed-shape postprocess of one canvas."""
        return self._postprocess(self._forward(x))

    @staticmethod
    def _rescale(out: dict, h: int, w: int, nh: int, nw: int,
                 scale: float, score_thr: float):
        """Score filter, un-letterbox the masks to (h, w) (the linear
        resize, antialiased where it shrinks, > 0.5) and the boxes to
        image xywh (clipped, rounded)."""
        scores = out['scores']
        valid = out['valid'] & (scores > score_thr)
        masks = out['masks'][:, :nh, :nw] & valid[:, None, None]
        # the N masks as the channels of one image, resized as
        # resize_bilinear_aa resizes: (N, h, w) contiguous, each mask's
        # pixels in a row as K6 and the depth adjustment read them (the
        # channel-last helper would leave each pixel's N masks in a row)
        masks = torch.nn.functional.interpolate(
            masks.float()[None], size=(h, w), mode='bilinear',
            align_corners=False, antialias=True)[0] > 0.5
        bboxes = out['bboxes'] / torch.tensor(scale, dtype=torch.float32,
                                              device=scores.device)
        hi = torch.tensor([w, h, w, h], dtype=torch.float32,
                          device=scores.device)
        bboxes = torch.minimum(bboxes.clamp(min=0.0), hi)
        xywh = torch.cat([bboxes[:, :2], bboxes[:, 2:] - bboxes[:, :2]], 1)
        return masks, torch.round(xywh), scores, valid

    def infer(self, img: Union[str, np.ndarray], pred_score_thr: float = 0.3,
              remove_duplicated: bool = False) -> Instances:
        """Detect on one BGR image (or path) → Instances at the image's
        size, refined when a refine method is set. Parity:
        animeinsseg/__init__.py:401-504."""
        if isinstance(img, str):
            import cv2
            img = cv2.imread(img)
        h, w = img.shape[:2]
        with self.timer.time('detector_forward', self.device):
            x, scale, (nh, nw) = self._preprocess(img)
            out = self._run_device(x)
            masks, xywh, scores, valid = self._rescale(
                out, h, w, nh, nw, scale, pred_score_thr)
            ins = Instances(masks=masks, bboxes=xywh, scores=scores,
                            valid=valid)
            if remove_duplicated:
                ins = ins.remove_duplicated()
        if self.refine is not None:
            with self.timer.time('detector_refine', self.device):
                ins = self.refine(ins, img)
        return ins

    @torch.inference_mode()
    def infer_batch(self, imgs: Sequence[Union[str, np.ndarray]],
                    pred_score_thr: float = 0.3, mesh=None
                    ) -> List[Instances]:
        """Detect on several BGR images (or paths) at once: one batched
        forward, then each image's postprocess (K8, K9) and its rescale
        as ``infer``'s, refined when a refine method is set. The JAX
        package's ``mesh`` (images sharded over devices) is not ported:
        only ``mesh=None`` is taken."""
        if mesh is not None:
            raise NotImplementedError(
                'infer_batch: a device mesh is not ported to '
                'cartoonsegmentation_torch yet (mesh=None only)')
        if not len(imgs):
            return []
        import cv2
        imgs = [cv2.imread(p) if isinstance(p, str) else p for p in imgs]
        out = []
        with self.timer.time('detector_forward', self.device):
            pre = [self._preprocess(im) for im in imgs]
            maps = self._forward(np.concatenate([p[0] for p in pre], 0))
            for i, (im, (_, scale, (nh, nw))) in enumerate(zip(imgs, pre)):
                cls_out, reg_out, krn_out, feat = maps
                one = self._postprocess(
                    (tuple(t[i:i + 1] for t in cls_out),
                     tuple(t[i:i + 1] for t in reg_out),
                     tuple(t[i:i + 1] for t in krn_out), feat[i:i + 1]))
                h, w = im.shape[:2]
                masks, xywh, scores, valid = self._rescale(
                    one, h, w, nh, nw, scale, pred_score_thr)
                out.append(Instances(masks=masks, bboxes=xywh,
                                     scores=scores, valid=valid))
        if self.refine is not None:
            with self.timer.time('detector_refine', self.device):
                out = [self.refine(ins, im) for ins, im in zip(out, imgs)]
        return out

    @torch.inference_mode()
    def infer_embeddings(self, img: Union[str, np.ndarray],
                         pre_topk: int = 512):
        """The top ``pre_topk`` candidates before NMS, by score (ties
        to the lower index, as lax.top_k): dict(scores, bboxes (xyxy at
        det_size), kernels (K, 169), priors (K, 2), strides (K,),
        mask_feat (h, w, 8)), and the image, scale and (nh, nw). Parity:
        animeinsseg/__init__.py:262-337."""
        if isinstance(img, str):
            import cv2
            img = cv2.imread(img)
        x, scale, (nh, nw) = self._preprocess(img)
        cls_out, reg_out, krn_out, mask_feat = self._forward(x)
        scores, dists, kernels, priors, strides = candidates(
            cls_out, reg_out, krn_out)
        top = _top_k_order(scores)[:min(pre_topk, scores.shape[0])]
        emb = {'scores': scores[top],
               'bboxes': distance2bbox(priors[top], dists[top]),
               'kernels': kernels[top], 'priors': priors[top],
               'strides': strides[top], 'mask_feat': mask_feat[0]}
        return emb, img, scale, (nh, nw)

    @torch.inference_mode()
    def segment_with_bboxes(self, img: Union[str, np.ndarray],
                            bboxes_xyxy: np.ndarray,
                            min_iou: float = 0.05) -> Instances:
        """Masks for given xyxy boxes: each box takes the candidate of
        ``infer_embeddings`` it overlaps most (the first on ties), whose
        dynamic mask head (K9) gives its probabilities; those are
        resized to det_size, cropped to the letterboxed image and
        resized to it (antialiased where it shrinks), > 0.5. A box whose
        best IoU is under ``min_iou`` comes back invalid. Parity:
        animeinsseg/__init__.py:339-393."""
        emb, img, scale, (nh, nw) = self.infer_embeddings(img)
        h, w = img.shape[:2]
        dev = emb['scores'].device
        boxes = torch.from_numpy(np.asarray(bboxes_xyxy, np.float32).reshape(
            -1, 4)).to(dev) * scale
        iou = box_iou(boxes, emb['bboxes'])                   # (Q, K)
        match = iou.argmax(1)
        ok = iou.amax(1) >= min_iou
        feat = emb['mask_feat']
        fh, fw = feat.shape[:2]
        # K9's probabilities alone: no instance valid, so it writes zero
        # masks and does not resize
        _, probs = dynamic_masks(
            feat, emb['kernels'][match], emb['priors'][match],
            emb['strides'][match], torch.zeros_like(ok), self.det_size,
            self.det_size, self.mask_thr)
        probs = probs.reshape(1, -1, fh, fw)
        probs = torch.nn.functional.interpolate(
            probs, size=(self.det_size, self.det_size), mode='bilinear',
            align_corners=False)[..., :nh, :nw]
        masks = torch.nn.functional.interpolate(
            probs, size=(h, w), mode='bilinear', align_corners=False,
            antialias=True)[0] > 0.5
        matched = true_div(emb['bboxes'][match], float(scale))
        xywh = torch.cat([matched[:, :2], matched[:, 2:] - matched[:, :2]], 1)
        ins = Instances(masks=masks & ok[:, None, None],
                        bboxes=torch.round(xywh) * ok[:, None],
                        scores=emb['scores'][match] * ok, valid=ok)
        if self.refine is not None:
            ins = self.refine(ins, img)
        return ins

    def set_refine_method(self, refine_method: str = 'none',
                          refine_size: int = 720) -> None:
        """Parity: animeinsseg/__init__.py:623-636."""
        from .refine import make_refiner
        self.refine = make_refiner(refine_method, refine_size, self.mask_thr,
                                   seed=self._seed, dtype=self.dtype_name,
                                   device=self.device)

    # ------------------------------------------------------------------
    # per-instance tagging (animeinsseg/__init__.py:229-260)
    # ------------------------------------------------------------------
    def init_tagger(self, model_path: str = '', **tagger_kwargs) -> None:
        """Install the Danbooru tagger (the SwinV2 'torch' backend by
        default for a non-onnx checkpoint; see models/tagger.py) on the
        detector's device unless ``device`` is given."""
        from ..models.tagger import Tagger
        tagger_kwargs.setdefault('device', self.device)
        self.tagger = Tagger(model_path, **tagger_kwargs)

    def infer_tags(self, instances: Instances, img_bgr: np.ndarray,
                   infer_grey: bool = False):
        """Tag each valid instance from its white-backed masked crop.
        Returns (tags, character_tags): per valid instance, a
        space-joined tag string and the character-tag list;
        `simple_background` / `white_background` are dropped like the
        reference (animeinsseg/__init__.py:233-260)."""
        import cv2
        if self.tagger is None:
            self.init_tagger()
        img = img_bgr
        if infer_grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
            img = img[..., [0, 0, 0]]
        bboxes = instances.bboxes.cpu().numpy()
        masks = instances.masks.cpu().numpy()
        valid = instances.valid.cpu().numpy()
        exclude = ('simple_background', 'white_background')
        tags_out, ctags_out = [], []
        for i in np.flatnonzero(valid):
            x, y, w, h = bboxes[i].astype(np.int32)
            crop = img[y:y + h, x:x + w].copy()
            m = masks[i][y:y + h, x:x + w]
            if crop.size == 0:
                tags_out.append('')
                ctags_out.append([])
                continue
            crop[~m.astype(bool)] = 255
            tags, ctags = self.tagger.label_cv2_bgr(crop)
            tags_out.append(' '.join(t for t in tags
                                     if t not in exclude))
            ctags_out.append(ctags)
        return tags_out, ctags_out
