"""KenBurnsPipeline — image → depth → point cloud → inpaint → video
(PyTorch port of ``cartoonsegmentation_tpu/pipeline/kenburns.py``).

The port runs the shipped default configuration: the AnimeInsSeg
detector (RTMDet-Ins with kernels K8 NMS and K9 mask heads) with the
ISNet refine, LeReS depth and the instance depth adjustment, autozoom's
coverage search (kernel K2), two passes of the Inpaint net (whose
forward splats with K1 and gates with the K7 median), each appending
to the cloud with the K10 compaction, the focal plane from the K6
per-instance median, and the frame loop (shift → K1 splat → K3 fill →
K5b colorize → K4 bokeh → K5a crop/resize/uint8/I420 → video); the K7
laplacian builds every validity mask. ``detector: sam`` re-masks the
AnimeInsSeg boxes with SAM (its encoder attention is K15a);
``detector: maskrcnn`` runs torchvision's COCO Mask R-CNN (RoIAlign
K14a, NMS K14b); ``detector: none`` skips the detector.
``discfill_mode: exact`` fills with the K11 ray march in place of K3.
``refine_crf`` snaps the disparity to the image's colour edges
(``pipeline/crf_refine.py``: host cv2 segments, each through the dense
CRF of kernels K12a k-means and K12b mean-field step). What the port
does not run yet raises NotImplementedError: the animeseg refine,
depth estimators other than LeReS, the depth refine net and inpaint
types other than 'default' (the sd-webui ``ldm`` of
3dkenburns_sam.yaml among them).

Everything runs on the pipeline's device, CUDA unless the caller
passes ``device='cpu'`` (where every kernel wrapper runs its plain
version). The frame loop is a Python loop: kernels are enqueued on the
current stream and the host waits only where a result must reach it
(the autozoom choice, the cloud count, each chunk's bytes).
"""
from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time as _time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import KenBurnsConfig, build_kenburns_cfg
from ..device import resolve_device, resolve_dtype
from ..instances import Instances
from ..models.kenburns import Inpaint
from ..models.leres import LeReS, _normalize_leres_keys, leres_postprocess
from ..ops.bokeh import bokeh_blur
from ..ops.camera import autozoom, compute_shift, depth_range
from ..ops import discfill, discfill3
from ..ops.filters import valid_depth_mask
from ..ops.pointcloud import (depth_to_points, render_pointcloud,
                              shift_points, true_div)
from ..utils.image import (bgr_to_i420, frame_epilogue, i420_to_bgr_host,
                           resize_bilinear, resize_bilinear_aa,
                           scaledown_maxsize, scaledown_size)
from ..utils.profiling import StageTimer
from .depth import (adjust_disparity_by_instances, colorize_gray_r,
                    masked_median_u8)
from .state import KenBurnsState, PointCloud

LOGGER = logging.getLogger('cartoonsegmentation_torch')


def _check_supported(cfg: KenBurnsConfig) -> None:
    """Raise for the options this slice of the port does not run."""
    todo = []
    if cfg.detector not in ('none', '', 'animeinsseg', 'sam', 'maskrcnn'):
        todo.append(f"detector={cfg.detector!r} (only 'animeinsseg', "
                    "'sam', 'maskrcnn', 'none')")
    if cfg.detector == 'animeinsseg' and \
            cfg.refine_method not in ('none', '', 'refinenet_isnet'):
        todo.append(f"refine_method={cfg.refine_method!r} (only "
                    "'refinenet_isnet', 'none')")
    if cfg.depth_est != 'leres':
        todo.append(f"depth_est={cfg.depth_est!r} (only 'leres')")
    if cfg.default_depth_refine:
        todo.append('default_depth_refine')
    if cfg.inpaint_type != 'default':
        todo.append(f"inpaint_type={cfg.inpaint_type!r} (only 'default')")
    if todo:
        raise NotImplementedError(
            'not ported to cartoonsegmentation_torch yet: '
            + ', '.join(todo))


class _VideoSink:
    """mp4 through cv2 where cv2 is present; otherwise the raw I420
    stream next to ``path`` as ``<stem>.yuv`` (the path is logged)."""

    def __init__(self, path: str, W: int, H: int, fps: int):
        try:
            import cv2
        except ImportError:
            cv2 = None
        self._vw = self._raw = None
        if cv2 is not None:
            self.path = path
            self._vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'),
                                       fps, (W, H))
        else:
            self.path = os.path.splitext(path)[0] + '.yuv'
            self._raw = open(self.path, 'wb')
            LOGGER.warning('cv2 is missing: writing the raw I420 stream '
                           '(%dx%d, %d fps) to %s', W, H, fps, self.path)

    def write(self, bgr: np.ndarray, i420: Optional[np.ndarray]) -> None:
        if self._vw is not None:
            self._vw.write(bgr)
        else:
            if i420 is None:
                i420 = bgr_to_i420(torch.from_numpy(bgr[None]))[0].numpy()
            self._raw.write(np.ascontiguousarray(i420).tobytes())

    def close(self) -> None:
        if self._vw is not None:
            self._vw.release()
        if self._raw is not None:
            self._raw.close()


class KenBurnsPipeline:

    def __init__(self, cfg: Union[KenBurnsConfig, str, dict, None] = None,
                 seed: int = 0, device=None):
        self.cfg = build_kenburns_cfg(cfg)
        _check_supported(self.cfg)
        self.device = resolve_device(device)
        self._seed = seed
        # nets are made from the seed at first use unless weights are
        # loaded first; tests may install smaller ones here
        self.inpaint_net: Optional[Inpaint] = None
        self.leres_net: Optional[LeReS] = None
        # an AnimeInsSeg, any img → Instances callable, or None; run()
        # installs the configured one first (ensure_detector)
        self._detector = None
        self.timer = StageTimer()
        # what the last run() rendered: the inpainted, compacted state
        # and its camera boxes (for re-rendering), and the video file
        self.last_state: Optional[KenBurnsState] = None
        self.last_boxes: Optional[Tuple[Dict, Dict]] = None
        self.last_video_path: Optional[str] = None

    @property
    def conv_dtype(self) -> torch.dtype:
        """cfg.dtype: 'auto' → bf16 on CUDA, f32 on the CPU."""
        return resolve_dtype(self.cfg.dtype, self.device)

    def _net(self, which: str) -> torch.nn.Module:
        attr = f'{which}_net'
        net = getattr(self, attr)
        if net is None:
            LOGGER.warning('kenburns %s net: RANDOM init (no checkpoint '
                           'loaded)', which)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                net = Inpaint() if which == 'inpaint' else LeReS()
            setattr(self, attr, net)
        return net.to(self.device, self.conv_dtype).eval()

    # -- weights -------------------------------------------------------
    def load_torch_checkpoints(self, inpaint: Optional[str] = None) -> None:
        """Load the Inpaint net's published state dict."""
        if inpaint:
            sd = torch.load(inpaint, map_location='cpu', weights_only=True)
            sd = sd.get('state_dict', sd)
            net = Inpaint()
            net.load_state_dict(sd)
            self.inpaint_net = net

    def load_leres_checkpoint(self, path: str) -> None:
        """res101.pth (ckpt['depth_model'], 'module.'-prefixed keys)."""
        ckpt = torch.load(path, map_location='cpu', weights_only=False)
        sd = {k: v for k, v in
              _normalize_leres_keys(ckpt.get('depth_model', ckpt)).items()
              if hasattr(v, 'shape')}
        net = LeReS()
        net.load_state_dict(sd)
        self.leres_net = net

    def load_detector_checkpoints(self, det: Optional[str] = None,
                                  sam: Optional[str] = None) -> None:
        """Route detector weights to the configured family: animeinsseg
        (an mmdet rtmdetl checkpoint), sam (rtmdetl + an official
        sam_vit_*.pth) or maskrcnn (a torchvision COCO .pth)."""
        self.ensure_detector()
        d = self._detector
        if d is None:
            raise ValueError("no detector configured (cfg.detector is "
                             "'none')")
        from .sam import SamDetector
        if isinstance(d, SamDetector):
            d.load_torch_checkpoints(det_ckpt=det, sam_ckpt=sam)
        elif det:
            d.load_torch_checkpoint(det)

    def set_detector(self, detector) -> None:
        """Install a detector name from the config ('animeinsseg', 'sam',
        'maskrcnn' or 'none'), an AnimeInsSeg, or any img → Instances
        callable with an ``infer(img, pred_score_thr)`` method. Parity:
        kenburns_effect.py:831-860."""
        if isinstance(detector, str):
            if detector in ('none', ''):
                self._detector = None
                return
            if detector == 'maskrcnn':
                # the reference's COCO torchvision model
                # (kenburns_effect.py:843-845, 874-886)
                from .maskrcnn_det import MaskRCNNDetector
                seg = MaskRCNNDetector(capacity=self.cfg.max_instances,
                                       seed=self._seed, device=self.device)
                seg.timer = self.timer
                self._detector = seg
                return
            if detector in ('animeinsseg', 'sam'):
                from .segment import AnimeInsSeg
                cfg = self.cfg
                seg = AnimeInsSeg(det_size=cfg.det_size,
                                  mask_thr=cfg.mask_thr,
                                  max_instances=cfg.max_instances,
                                  dtype=cfg.dtype, seed=self._seed,
                                  device=self.device)
                if detector == 'sam':
                    # AnimeInsSeg's boxes, without its refine, re-masked
                    # by SAM (configs/3dkenburns_sam.yaml)
                    from .sam import SamDetector
                    seg = SamDetector(seg)
                elif cfg.refine_method not in ('none', ''):
                    seg.set_refine_method(cfg.refine_method,
                                          cfg.refine_size)
                seg.timer = self.timer
                self._detector = seg
                return
            raise NotImplementedError(
                f'detector {detector!r} is not ported to '
                "cartoonsegmentation_torch yet (only 'animeinsseg', "
                "'sam', 'maskrcnn', 'none')")
        self._detector = detector

    def ensure_detector(self) -> None:
        """Instantiate the configured detector if none is installed."""
        if self._detector is None and self.cfg.detector not in ('none', ''):
            self.set_detector(self.cfg.detector)

    # -- stage 1: state generation --------------------------------------
    def generate_state(self, img: Union[str, np.ndarray],
                       instances: Optional[Instances] = None
                       ) -> KenBurnsState:
        """Image (BGR uint8 HWC, or a path) → state on the device.
        Parity: kenburns_effect.py:898-951."""
        if isinstance(img, str):
            import cv2
            img = cv2.imread(img)
        cfg, dev = self.cfg, self.device
        if instances is None and self._detector is not None:
            with self.timer.time('detector', dev):
                instances = self._detector.infer(img, cfg.pred_score_thr)
        img = scaledown_maxsize(img, cfg.max_size)
        H, W = img.shape[:2]
        if instances is None:
            instances = Instances.empty(cfg.max_instances, H, W, dev)
        else:
            instances = instances.to(dev).resize(H, W)
        image = torch.from_numpy(img.astype(np.float32) / 255.0).to(dev)

        with self.timer.time('depth_estimate', dev):
            disparity = self._est_leres(image)
        with self.timer.time('depth_adjust', dev):
            disparity = self._adjust_disparity(disparity, instances)
        with self.timer.time('depth_refine', dev):
            if disparity.shape[:2] != (H, W):
                disparity = resize_bilinear(disparity, H, W)
            if cfg.refine_crf:
                disparity = self._refine_crf(img, disparity, instances)
        with self.timer.time('prepare_state', dev):
            state = self._prepare_state(image, disparity, instances)
        return state

    @torch.inference_mode()
    def _est_leres(self, image: torch.Tensor) -> torch.Tensor:
        """LeReS at depth_est_size (/32-padded), apply_leres post, back
        to image resolution. Parity: kenburns_effect.py:563-581."""
        H, W = image.shape[:2]
        dh, dw = scaledown_size(H, W, self.cfg.depth_est_size, divisor=32)
        net = self._net('leres')
        rgb = resize_bilinear_aa(image, dh, dw).flip(-1)   # BGR → RGB
        d = net(rgb.permute(2, 0, 1)[None].to(self.conv_dtype))
        disp = leres_postprocess(d[0, 0].float())
        disp = resize_bilinear_aa(disp[..., None], H, W)[..., 0]
        # zeros → min positive (kenburns_effect.py:577)
        pos_min = torch.where(disp > 0, disp, float('inf')).min()
        return torch.where(disp == 0, pos_min, disp)[..., None]

    def _refine_crf(self, img: np.ndarray, disparity: torch.Tensor,
                    instances: Instances) -> torch.Tensor:
        """The CRF depth refine at image resolution on the host arrays
        (its dense CRF on the pipeline's device), the composed instance
        masks excluded. Parity: JAX ``_refine_stage``'s refine_crf
        branch, kenburns_effect.py:618-622."""
        from .crf_refine import refine_depth_crf
        ins_mask = instances.compose_masks().cpu().numpy()
        refined = refine_depth_crf(img, disparity[..., 0].cpu().numpy(),
                                   ins_mask if ins_mask.any() else None,
                                   device=self.device)
        return torch.from_numpy(refined).to(self.device)[..., None]

    def _adjust_disparity(self, disparity: torch.Tensor,
                          instances: Instances) -> torch.Tensor:
        """Instance depth adjustment at image resolution."""
        return adjust_disparity_by_instances(
            disparity[..., 0], instances,
            self.cfg.depthest_use_medium)[..., None]

    def _prepare_state(self, image, disparity, instances) -> KenBurnsState:
        cfg = self.cfg
        H, W = image.shape[:2]
        focal, baseline = cfg.focal, cfg.baseline
        disparity = disparity / (disparity.max() + 1e-12) * baseline
        depth = true_div(focal * baseline, disparity + 1e-5)
        valid = valid_depth_mask(disparity)
        pts = depth_to_points((depth * valid)[..., 0], focal).reshape(-1, 3)
        dr = depth_range(depth[..., 0])
        cloud = PointCloud.with_capacity(
            int(cfg.point_capacity_factor * H * W), self.device)
        cloud = cloud.append_masked(
            pts, image.reshape(-1, 3), disparity.reshape(-1),
            depth.reshape(-1),
            torch.ones((H * W,), dtype=torch.bool, device=self.device))
        return KenBurnsState(
            image=image, disparity=disparity, depth=depth, raw_points=pts,
            depth_min=dr.min_val, depth_min_u=dr.min_u,
            depth_min_v=dr.min_v, cloud=cloud, instances=instances)

    # -- stage 2: autozoom ----------------------------------------------
    def autozoom(self, state: KenBurnsState) -> Tuple[Dict, Dict]:
        """objFrom/objTo camera boxes. Parity: kenburns_effect.py:953-967."""
        cfg = self.cfg
        H, W = state.hw
        obj_from = {'center_u': W / 2.0, 'center_v': H / 2.0,
                    'crop_w': int(math.floor(cfg.crop_ratio * W)),
                    'crop_h': int(math.floor(cfg.crop_ratio * H))}
        if not cfg.auto_zoom:
            return obj_from, {
                'center_u': obj_from['center_u'],
                'center_v': obj_from['center_v'],
                'crop_w': int(round(obj_from['crop_w'] / cfg.autozoom_zoom)),
                'crop_h': int(round(obj_from['crop_h'] / cfg.autozoom_zoom))}
        with self.timer.time('autozoom', self.device):
            best_u, best_v, crop_w_to, crop_h_to = autozoom(
                state.raw_points, state.depth_range, W, H, cfg.focal,
                cfg.baseline, cfg.autozoom_shift, cfg.autozoom_zoom,
                cfg.crop_ratio, stride=cfg.autozoom_stride)
        return obj_from, {'center_u': obj_from['center_u'] + best_u,
                          'center_v': obj_from['center_v'] + best_v,
                          'crop_w': crop_w_to, 'crop_h': crop_h_to}

    # -- stage 3: inpaint passes ----------------------------------------
    def _camera_params(self, t: float, obj_from, obj_to, state):
        """Camera interpolation (kenburns_effect.py:1017-1026):
        (shift_u, shift_v, depth_scale, crop_w, crop_h)."""
        H, W = state.hw
        fr, to = 1.0 - t, t
        shift_u = fr * obj_from['center_u'] + to * obj_to['center_u'] \
            - W / 2.0
        shift_v = fr * obj_from['center_v'] + to * obj_to['center_v'] \
            - H / 2.0
        crop_w = fr * obj_from['crop_w'] + to * obj_to['crop_w']
        crop_h = fr * obj_from['crop_h'] + to * obj_to['crop_h']
        max_cw = max(obj_from['crop_w'], obj_to['crop_w'])
        return shift_u, shift_v, crop_w / max_cw, crop_w, crop_h

    def _f32(self, x) -> torch.Tensor:
        return torch.tensor(np.float32(x), device=self.device)

    @torch.inference_mode()
    def _inpaint_forward(self, state: KenBurnsState, shift_u, shift_v,
                         depth_scale):
        """Inpaint-net forward at a camera extreme → (out dict, shift)."""
        cfg = self.cfg
        H, W = state.hw
        dr = state.depth_range
        shift = compute_shift(dr, self._f32(shift_u), self._f32(shift_v),
                              dr.min_val,
                              dr.min_val * self._f32(depth_scale), W, H,
                              cfg.focal)
        shift = 1.1 * shift                     # kenburns_effect.py:1012
        segmask = state.instances.compose_masks()[..., None].float()
        out = self._net('inpaint')(state.image, state.disparity, shift,
                                   cfg.focal, cfg.baseline,
                                   segmasks=segmask)
        return out, shift

    def _inpaint_append(self, state: KenBurnsState, image, disparity,
                        existing, shift) -> KenBurnsState:
        """Unproject the hallucinated pixels and append the hole ones
        (kenburns_effect.py:453-512)."""
        focal, baseline = self.cfg.focal, self.cfg.baseline
        new_depth = true_div(focal * baseline, disparity + 1e-7)
        valid = valid_depth_mask(disparity)
        pts = depth_to_points((new_depth * valid)[..., 0], focal)
        pts = pts.reshape(-1, 3) - shift[None, :]
        hole = (existing[..., 0] == 0.0).reshape(-1)
        cloud = state.cloud.append_masked(
            pts, image.reshape(-1, 3), disparity.reshape(-1),
            new_depth.reshape(-1), hole)
        return state.replace(cloud=cloud)

    def inpaint_pass(self, state: KenBurnsState, shift_u: float,
                     shift_v: float, depth_scale: float) -> KenBurnsState:
        """One inpainting pass at a camera extreme (inpaint_type
        'default'). Parity: kenburns_effect.py:441-514."""
        out, shift = self._inpaint_forward(state, shift_u, shift_v,
                                           depth_scale)
        return self._inpaint_append(state, out['image'], out['disparity'],
                                    out['existing'], shift)

    def inpaint_extremes(self, state: KenBurnsState, obj_from: Dict,
                         obj_to: Dict) -> KenBurnsState:
        """One inpaint pass at each camera extreme (t = 0, 1), then
        compact the grown cloud."""
        with self.timer.time('inpaint_passes', self.device):
            for t in (0.0, 1.0):
                su, sv, ds, _, _ = self._camera_params(t, obj_from, obj_to,
                                                       state)
                state = self.inpaint_pass(state, su, sv, ds)
        return self.compact_state(state)

    def compact_state(self, state: KenBurnsState) -> KenBurnsState:
        """Shrink the cloud to a snug capacity (bucketed to 64 K): the
        splat's cost follows the buffer, not the live points."""
        count = int(state.cloud.count)
        bucket = 1 << 16
        snug = -(-int(count * 1.02) // bucket) * bucket
        if snug < state.cloud.capacity:
            state = state.replace(cloud=state.cloud.shrink_to(snug))
        return state

    # -- stage 4: frame rendering ----------------------------------------
    def _cams(self, state, obj_from, obj_to, steps) -> torch.Tensor:
        """(T, 4) f32 per-frame (shift_u, shift_v, depth_scale, t)."""
        cams = np.stack([
            np.asarray(self._camera_params(float(t), obj_from, obj_to,
                                           state)[:3], np.float32)
            for t in steps])
        cams = np.concatenate([cams, np.asarray(steps, np.float32)[:, None]],
                              1)
        return torch.from_numpy(cams).to(self.device)

    def _fill(self, img: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """The disocclusion fill of cfg.discfill_mode: K3 for 'fast',
        else (as the JAX package's ``_render_builders``) the K11 ray
        march of cfg.discfill_max_steps."""
        if self.cfg.discfill_mode == 'fast':
            return discfill3.fill_disocclusion(img, depth)
        return discfill.fill_disocclusion(img, depth,
                                          self.cfg.discfill_max_steps)

    def _splat_fill(self, state: KenBurnsState, cam: torch.Tensor):
        """Shift → K1 splat → K3 or K11 fill; (H, W, 4) BGR + depth."""
        cfg = self.cfg
        H, W = state.hw
        dr = state.depth_range
        shift = compute_shift(dr, cam[0], cam[1], dr.min_val,
                              dr.min_val * cam[2], W, H, cfg.focal)
        pts = shift_points(state.cloud.points, shift)
        data = torch.cat([state.cloud.colors, state.cloud.depth[:, None]], 1)
        render, existing = render_pointcloud(pts, data, H, W, cfg.focal,
                                             cfg.baseline)
        return self._fill(render, render[..., 3] * (existing[..., 0] > 0))

    def focal_planes(self, state: KenBurnsState, cams: torch.Tensor,
                     depth_field: bool):
        """Focal planes from the t=0 frame (kenburns_effect.py:
        1045-1059): the max of the instances' median depths, else the
        far plane."""
        zero = torch.zeros((), device=self.device)
        if not depth_field:
            return zero, zero + 255.0
        depth_r = colorize_gray_r(self._splat_fill(state, cams[0])[..., 3])
        ins = state.instances
        has_ins = ins.count() > 0
        meds = masked_median_u8(depth_r, ins.masks, ins.valid)
        fp_end = torch.where(has_ins, meds.max(), zero + 255.0)
        fp_start = torch.where(
            has_ins & ((255.0 - fp_end).abs() > fp_end.abs()),
            zero + 255.0, zero)
        return fp_start, fp_end

    def render_one(self, state: KenBurnsState, cam: torch.Tensor,
                   focal_planes, max_cw: int, max_ch: int,
                   depth_field: bool, bgr: Optional[torch.Tensor] = None,
                   i420: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One frame → (H, W, 3) uint8 BGR, written into ``bgr`` and,
        with ``i420``, its I420 bytes (the K5a epilogue). Parity:
        kenburns_effect.py:1015-1072."""
        cfg = self.cfg
        H, W = state.hw
        filled = self._splat_fill(state, cam)
        frame = filled[..., :3]
        if depth_field:
            depth_r = colorize_gray_r(filled[..., 3])
            fp_start, fp_end = focal_planes
            focal_int = true_div(1.0, 1.0 + torch.exp((0.5 - cam[3])
                                                      * cfg.dof_speed))
            fp = focal_int * fp_end + (1 - focal_int) * fp_start
            frame = bokeh_blur(frame.clamp(0.0, 1.0), depth_r,
                               cfg.dof_num_samples, cfg.lightness_factor,
                               cfg.depth_factor, focal_plane=fp)
        return frame_epilogue(frame, max_ch, max_cw, H, W, bgr, i420)

    @torch.inference_mode()
    def render_frames(self, state: KenBurnsState, obj_from: Dict,
                      obj_to: Dict, steps, depth_field: Optional[bool] = None,
                      return_device: bool = False):
        """All frames (T, H, W, 3) uint8 BGR, on the host unless
        ``return_device``. Parity: kenburns_effect.py:1015-1072."""
        if depth_field is None:
            depth_field = self.cfg.depth_field
        H, W = state.hw
        max_cw = max(obj_from['crop_w'], obj_to['crop_w'])
        max_ch = max(obj_from['crop_h'], obj_to['crop_h'])
        cams = self._cams(state, obj_from, obj_to, steps)
        fps = self.focal_planes(state, cams, depth_field)
        frames = torch.empty((len(cams), H, W, 3), dtype=torch.uint8,
                             device=self.device)
        for i in range(len(cams)):
            self.render_one(state, cams[i], fps, max_cw, max_ch, depth_field,
                            bgr=frames[i])
        return frames if return_device else frames.cpu().numpy()

    @torch.inference_mode()
    def render_frames_stream(self, state: KenBurnsState, obj_from: Dict,
                             obj_to: Dict, steps, video_path: str,
                             depth_field: Optional[bool] = None,
                             chunk: int = 16, fps: int = 25) -> np.ndarray:
        """Render in chunks; each chunk is packed to I420 on the device
        and copied to pinned host memory asynchronously while the next
        chunk renders, and a worker thread decodes and encodes it. With
        cfg.playback the palindrome tail follows. Returns the forward
        frames (BGR, decoded from the I420 stream)."""
        cfg, dev = self.cfg, self.device
        if depth_field is None:
            depth_field = cfg.depth_field
        H, W = state.hw
        T = len(steps)
        max_cw = max(obj_from['crop_w'], obj_to['crop_w'])
        max_ch = max(obj_from['crop_h'], obj_to['crop_h'])
        if H % 4 or W % 2:
            raise NotImplementedError(f'the streamed video needs H % 4 == 0 '
                                      f'and W % 2 == 0, got {H}x{W}')
        cams = self._cams(state, obj_from, obj_to, steps)
        planes = self.focal_planes(state, cams, depth_field)
        pin = dev.type == 'cuda'
        n_chunks = -(-T // chunk)

        sink = _VideoSink(video_path, W, H, fps)
        self.last_video_path = sink.path
        host_bgr: list = [None] * n_chunks
        host_i420: list = [None] * n_chunks
        q: 'queue.Queue' = queue.Queue(maxsize=4)
        enc_s = [0.0]
        enc_err: list = []

        def encoder():
            sentinel_seen = False
            try:
                while True:
                    item = q.get()
                    if item is None:
                        sentinel_seen = True
                        break
                    ci, arr = item
                    t0 = _time.perf_counter()
                    bgr = i420_to_bgr_host(arr)
                    host_bgr[ci], host_i420[ci] = bgr, arr
                    for f, y in zip(bgr, arr):
                        sink.write(f, y)
                    enc_s[0] += _time.perf_counter() - t0
                if cfg.playback:
                    t0 = _time.perf_counter()
                    flat = [(f, y) for b, a in zip(host_bgr, host_i420)
                            for f, y in zip(b, a)]
                    for f, y in flat[::-1][1:-1]:
                        sink.write(f, y)
                    enc_s[0] += _time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — re-raised below
                enc_err.append(e)
                # keep draining until the sentinel: the queue is bounded,
                # so a dead consumer would block the producer's put
                while not sentinel_seen:
                    if q.get() is None:
                        sentinel_seen = True

        def hand_over(ci, ev, host):
            """Wait for chunk ci's copy, then queue it for the encoder."""
            t0 = _time.perf_counter()
            if ev is not None:
                ev.synchronize()
            xfer[0] += _time.perf_counter() - t0
            q.put((ci, host.numpy()))

        th = threading.Thread(target=encoder, daemon=True)
        th.start()
        xfer = [0.0]
        t_render = _time.perf_counter()
        try:
            prev = None                     # (chunk, event, host i420)
            for ci in range(n_chunks):
                c0 = ci * chunk
                n = min(chunk, T - c0)
                # each frame's epilogue writes its BGR and I420 straight
                # into the chunk's buffers
                bgr = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
                i420 = torch.empty((n, H * 3 // 2, W), dtype=torch.uint8,
                                   device=dev)
                for j in range(n):
                    self.render_one(state, cams[c0 + j], planes, max_cw,
                                    max_ch, depth_field, bgr=bgr[j],
                                    i420=i420[j])
                host = torch.empty(i420.shape, dtype=torch.uint8,
                                   pin_memory=pin)
                host.copy_(i420, non_blocking=pin)
                ev = None
                if pin:
                    ev = torch.cuda.Event()
                    ev.record()
                # chunk ci is queued on the card: hand the previous one
                # to the encoder while this one renders
                if prev is not None:
                    hand_over(*prev)
                prev = (ci, ev, host)
            if prev is not None:
                hand_over(*prev)
        finally:
            # stream_render: the render loop until the last chunk is on
            # the host; stream_encode_tail: the encoder's work left then
            t_tail = _time.perf_counter()
            q.put(None)
            th.join()
            self.timer.add('stream_render', t_tail - t_render)
            self.timer.add('stream_encode_tail', _time.perf_counter() - t_tail)
            self.timer.add('stream_transfer_wait', xfer[0])
            self.timer.add('stream_encode', enc_s[0])
            sink.close()
        if enc_err:
            raise enc_err[0]
        return np.concatenate(host_bgr)[:T] if host_bgr else \
            np.zeros((0, H, W, 3), np.uint8)

    # -- orchestration -----------------------------------------------------
    def process_kenburns(self, state: KenBurnsState, obj_from: Dict,
                         obj_to: Dict, steps=None, inpaint: bool = True,
                         return_device: bool = False):
        if steps is None:
            steps = np.linspace(0.0, 1.0, self.cfg.num_frame)
        state = self.inpaint_extremes(state, obj_from, obj_to) if inpaint \
            else self.compact_state(state)
        with self.timer.time('render_frames', self.device):
            frames = self.render_frames(state, obj_from, obj_to, steps,
                                        return_device=True)
        if return_device:
            return frames
        with self.timer.time('host_transfer', self.device):
            return frames.cpu().numpy()

    def run(self, img: Union[str, np.ndarray],
            video_path: Optional[str] = None) -> np.ndarray:
        """Image → frames (T, H, W, 3) uint8 BGR, and with a video path
        the clip: the streamed render overlaps each chunk's transfer
        and encode with the next chunk's render."""
        self.ensure_detector()
        state = self.generate_state(img)
        obj_from, obj_to = self.autozoom(state)
        state = self.inpaint_extremes(state, obj_from, obj_to)
        self.last_state, self.last_boxes = state, (obj_from, obj_to)
        if not video_path:
            return self.process_kenburns(state, obj_from, obj_to,
                                         inpaint=False)
        steps = np.linspace(0.0, 1.0, self.cfg.num_frame)
        with self.timer.time('render_stream+encode', self.device):
            return self.render_frames_stream(state, obj_from, obj_to,
                                             steps, video_path)


def write_video(frames: np.ndarray, path: str, fps: int = 25,
                playback: bool = True) -> str:
    """frames (T, H, W, 3) BGR uint8 → mp4 (raw .yuv without cv2);
    returns the path written. Parity: kenburns_effect.py:1086-1090."""
    seq = list(frames)
    if playback:
        seq = seq + seq[::-1][1:-1]
    h, w = seq[0].shape[:2]
    sink = _VideoSink(path, w, h, fps)
    try:
        for f in seq:
            sink.write(f, None)
    finally:
        sink.close()
    return sink.path
