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
CRF of kernels K12a k-means and K12b mean-field step). ``refine_method``
takes every refiner of ``pipeline/refine.py`` (the animeseg nets too).
``depth_est: default`` runs the 3D-Ken-Burns disparity net at its coarse
grid (the instance adjustment at image resolution and back), and
``default_depth_refine`` its Refine net up to image resolution.
``inpaint_type`` 'patchmatch' (the host C++ PatchMatch), 'ldm' (a
stable-diffusion-webui server) and 'ldm_native' (SD1.5-inpainting
latent diffusion in the process, ``models/ldm_inpaint.py``) fill each
pass's image before its holes join the cloud. ``depth_est`` 'zoe' and
'zoe_nk' run ZoeDepth (BEiT-L DPT, N or the NK router) with its flip
average at the image fitted into 672, 'leres_boost' LeReS boosted by
the pix2pix merge over gradient-dense patches (``pipeline/boost.py``),
'marigold' Marigold's latent diffusion (``models/marigold.py``). The
two diffusion models run in f32 on the pipeline's device.

Everything runs on the pipeline's device, CUDA unless the caller
passes ``device='cpu'`` (where every kernel wrapper runs its plain
version). The frame loop is a Python loop: kernels are enqueued on the
current stream and the host waits only where a result must reach it
(the autozoom choice, the cloud count, each chunk's bytes). With
``stage_previews`` on (off by default: each preview is a full-frame
copy to the host), ``stages`` collects the verbose stage images that
``save_stages`` writes.
"""
from __future__ import annotations

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
from ..models.kenburns import DisparityEstimator, Inpaint, Refine
from ..models.leres import LeReS, _normalize_leres_keys, leres_postprocess
from ..models.pix2pix4depth import Pix2Pix4Depth
from ..ops.bokeh import bokeh_blur
from ..ops.camera import autozoom, compute_shift, depth_range
from ..ops import discfill, discfill3
from ..ops.filters import valid_depth_mask
from ..ops.pointcloud import (depth_to_points, render_pointcloud,
                              shift_points, true_div)
from ..utils.image import (EpiloguePlan, bgr_to_i420, i420_to_bgr_host,
                           resize_bilinear, resize_bilinear_aa,
                           scaledown_maxsize, scaledown_size)
from ..utils.profiling import StageTimer
from .depth import (adjust_disparity_by_instances, colorize_gray_r,
                    masked_median_u8)
from .state import KenBurnsState, PointCloud

from ..utils.logger import LOGGER


# the depth estimators and inpaint types of the JAX package that the port
# does not run yet: none
UNPORTED_DEPTH = ()
UNPORTED_INPAINT = ()
_NETS = {'inpaint': Inpaint, 'leres': LeReS,
         'disparity': DisparityEstimator, 'refine': Refine,
         'p2p': Pix2Pix4Depth}


def _load_torch_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's tensors by name (its 'state_dict' entry
    where it has one), as the JAX package's ``load_torch_ckpt`` reads
    it."""
    sd = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return {k: v for k, v in sd.items() if hasattr(v, 'shape')}


def _check_supported(cfg: KenBurnsConfig) -> None:
    """Raise for the options this slice of the port does not run."""
    todo = []
    if cfg.detector not in ('none', '', 'animeinsseg', 'sam', 'maskrcnn'):
        todo.append(f"detector={cfg.detector!r} (only 'animeinsseg', "
                    "'sam', 'maskrcnn', 'none')")
    if cfg.depth_est in UNPORTED_DEPTH:
        todo.append(f'depth_est={cfg.depth_est!r}')
    if cfg.inpaint_type in UNPORTED_INPAINT:
        todo.append(f'inpaint_type={cfg.inpaint_type!r}')
    if todo:
        raise NotImplementedError(
            'not ported to cartoonsegmentation_torch yet: '
            + ', '.join(todo))


class _VideoSink:
    """mp4 through cv2 where cv2 is present; otherwise the raw I420
    stream next to ``path`` as ``<stem>.yuv`` (the path is logged),
    which takes only frames with H % 4 == 0 and W % 2 == 0."""

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
            if H % 4 or W % 2:
                raise RuntimeError(
                    f'cv2 is missing and the raw I420 stream needs H % 4 '
                    f'== 0 and W % 2 == 0, got {H}x{W}: install cv2 to '
                    f'write this clip')
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
        self.disparity_net: Optional[DisparityEstimator] = None
        self.refine_net: Optional[Refine] = None
        # leres_boost's merge net; ZoeDepth or ZoeDepthNK at the grid of
        # the last image (made again for another grid, and loaded again
        # from the checkpoint's path where one was loaded)
        self.p2p_net: Optional[Pix2Pix4Depth] = None
        self.zoe_net = None
        self._zoe_ckpt_path: Optional[str] = None
        self._zoe_ckpt_is_nk = False
        # the diffusion models (depth_est 'marigold', inpaint_type
        # 'ldm_native'): made from the cfg at first use, their weights
        # drawn on the device from the seed unless a checkpoint is loaded
        self.marigold = None
        self.ldm_inpainter = None
        # the last leres_boost run's LeReSBoost (its patches, R_x)
        self.last_boost = None
        # an AnimeInsSeg, any img → Instances callable, or None; run()
        # installs the configured one first (ensure_detector)
        self._detector = None
        self.timer = StageTimer()
        # what the last run() rendered: the inpainted, compacted state
        # and its camera boxes (for re-rendering), and the video file
        self.last_state: Optional[KenBurnsState] = None
        self.last_boxes: Optional[Tuple[Dict, Dict]] = None
        self.last_video_path: Optional[str] = None
        # the verbose stage images (BGR uint8 on the host), keyed as the
        # JAX package's: input, depth_coarse, depth_adjusted, depth_final,
        # instances, inpainted_<cloud count>; all but 'input' are taken
        # only with stage_previews on
        self.stages: Dict[str, np.ndarray] = {}
        self.stage_previews: bool = False

    @property
    def conv_dtype(self) -> torch.dtype:
        """cfg.dtype: 'auto' → bf16 on CUDA, f32 on the CPU."""
        return resolve_dtype(self.cfg.dtype, self.device)

    def _net(self, which: str,
             dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
        """The named net on the device: made from the seed at first use,
        in ``dtype`` if given, else cfg.dtype's conv dtype (Inpaint,
        LeReS) or f32 (the disparity estimator, Refine and the pix2pix
        merge net, as in the JAX package)."""
        attr = f'{which}_net'
        net = getattr(self, attr)
        if net is None:
            LOGGER.warning('kenburns %s net: RANDOM init (no checkpoint '
                           'loaded)', which)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                net = _NETS[which]()
            setattr(self, attr, net)
        if dtype is None:
            dtype = self.conv_dtype if which in ('inpaint', 'leres') \
                else torch.float32
        return net.to(self.device, dtype).eval()

    # -- weights -------------------------------------------------------
    def load_torch_checkpoints(self, disparity: Optional[str] = None,
                               refine: Optional[str] = None,
                               inpaint: Optional[str] = None,
                               vgg: Optional[str] = None) -> None:
        """Load the published 3D-Ken-Burns state dicts: the disparity net
        (its 'module*' keys renamed 'net*', as the reference loads them),
        torchvision's vgg19_bn (its ``features`` through the 4th pool
        become Semantics), the Refine and Inpaint nets."""
        def load(path):
            sd = torch.load(path, map_location='cpu', weights_only=True)
            return sd.get('state_dict', sd)
        if disparity or vgg:
            est = self.disparity_net or DisparityEstimator()
            if disparity:
                est.disparity.load_state_dict(
                    {k.replace('module', 'net'): v
                     for k, v in load(disparity).items()})
            if vgg:
                n = len(est.semantics.netVgg)
                est.semantics.netVgg.load_state_dict(
                    {k[len('features.'):]: v for k, v in load(vgg).items()
                     if k.startswith('features.')
                     and int(k.split('.')[1]) < n})
            self.disparity_net = est
        for which, path in (('refine', refine), ('inpaint', inpaint)):
            if path:
                net = _NETS[which]()
                net.load_state_dict(load(path))
                setattr(self, f'{which}_net', net)

    def load_leres_checkpoint(self, path: str) -> None:
        """res101.pth (ckpt['depth_model'], 'module.'-prefixed keys)."""
        ckpt = torch.load(path, map_location='cpu', weights_only=False)
        sd = {k: v for k, v in
              _normalize_leres_keys(ckpt.get('depth_model', ckpt)).items()
              if hasattr(v, 'shape')}
        net = LeReS()
        net.load_state_dict(sd)
        self.leres_net = net

    def load_pix2pix_checkpoint(self, path: str) -> None:
        """leres_boost's merge net: latest_net_G.pth."""
        sd = _load_torch_ckpt(path)
        net = Pix2Pix4Depth()
        net.load_state_dict({k[len('module.'):] if k.startswith('module.')
                             else k: v for k, v in sd.items()})
        self.p2p_net = net

    def load_zoe_checkpoint(self, path: str) -> None:
        """ZoeD_M12_N.pt or ZoeD_M12_NK.pt; the variant is the state
        dict's (NK carries the router's ``patch_transformer.*`` keys).
        The path is kept: an image of another grid size makes the net
        again and loads the checkpoint into it."""
        self._zoe_ckpt_path = path
        self._load_zoe(path)

    def _load_zoe(self, path: str) -> None:
        from ..models.zoedepth import (ZoeDepth, ZoeDepthNK,
                                       load_zoe_state_dict)
        sd = _load_torch_ckpt(path)
        is_nk = any(k.startswith('patch_transformer.') for k in sd)
        self._zoe_ckpt_is_nk = is_nk
        cls = ZoeDepthNK if is_nk else ZoeDepth
        if not isinstance(self.zoe_net, cls):
            size = self.zoe_net.img_size if self.zoe_net is not None \
                else (672, 672)
            self.zoe_net = cls(img_size=size)
        load_zoe_state_dict(self.zoe_net, sd)

    def load_marigold_checkpoint(self, unet_path: str, vae_path: str,
                                 text_path: Optional[str] = None) -> None:
        """A Marigold checkpoint directory's unet/, vae/ and (optionally)
        text_encoder/ torch weight files, by diffusers' key names."""
        self._ensure_marigold().load_weights(
            _load_torch_ckpt(unet_path), _load_torch_ckpt(vae_path),
            _load_torch_ckpt(text_path) if text_path else None)

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
        # a new image: the last one's stage images go
        self.stages.clear()
        self.stages['input'] = np.ascontiguousarray(img)
        H, W = img.shape[:2]
        if instances is None:
            instances = Instances.empty(cfg.max_instances, H, W, dev)
        else:
            instances = instances.to(dev).resize(H, W)
        image = torch.from_numpy(img.astype(np.float32) / 255.0).to(dev)

        with self.timer.time('depth_estimate', dev):
            disparity = self._estimate_disparity(image)
            self._stage_depth('depth_coarse', disparity)
        with self.timer.time('depth_adjust', dev):
            disparity = self._adjust_disparity(image, disparity, instances)
            self._stage_depth('depth_adjusted', disparity)
        with self.timer.time('depth_refine', dev):
            disparity = self._refine_stage(img, image, disparity, instances)
            self._stage_depth('depth_final', disparity)
        if self._detector is not None and self.stage_previews:
            self.stages['instances'] = instances.draw(img)
        with self.timer.time('prepare_state', dev):
            state = self._prepare_state(image, disparity, instances)
        return state

    def _estimate_disparity(self, image: torch.Tensor) -> torch.Tensor:
        """The configured estimator's disparity: 'default' at its coarse
        grid, the others ('leres', 'leres_boost', 'zoe', 'zoe_nk',
        'marigold') at image resolution. Parity: the JAX package's
        ``_estimate_disparity`` (an unknown name runs LeReS with a
        warning)."""
        est = self.cfg.depth_est
        if est == 'default':
            return self._est_default(image)
        if est in ('zoe', 'zoe_nk'):
            return self._est_zoe(image, nk=est == 'zoe_nk')
        if est == 'leres_boost':
            return self._est_leres_boost(image)
        if est == 'marigold':
            return self._est_marigold(image)
        if est != 'leres':
            LOGGER.warning('unknown depth_est=%s; using leres', est)
        return self._est_leres(image)

    @torch.inference_mode()
    def _est_default(self, image: torch.Tensor) -> torch.Tensor:
        """The 3D-Ken-Burns disparity net at its native grid (half of the
        image fitted into 512): no resize back, the coarse grid goes
        through the adjustment and into Refine as it is."""
        d = self._net('disparity')(image.permute(2, 0, 1)[None])
        return d[0].permute(1, 2, 0)

    @torch.inference_mode()
    def _refine_disparity(self, image: torch.Tensor,
                          disparity: torch.Tensor) -> torch.Tensor:
        """The Refine net: the image at its resolution guides the
        disparity at its own grid up to the image's (H, W, 1)."""
        d = self._net('refine')(image.permute(2, 0, 1)[None],
                                disparity.permute(2, 0, 1)[None])
        return d[0].permute(1, 2, 0)

    def _refine_stage(self, img: np.ndarray, image: torch.Tensor,
                      disparity: torch.Tensor,
                      instances: Instances) -> torch.Tensor:
        """The final depth refinement, at image resolution: the Refine
        net (``default_depth_refine``) or the CRF refine, both optional;
        a coarse grid left over is resized up (no antialias). Parity:
        the JAX package's ``_refine_stage``."""
        H, W = img.shape[:2]
        if self.cfg.default_depth_refine:
            disparity = self._refine_disparity(image, disparity)
        elif self.cfg.refine_crf:
            if disparity.shape[:2] != (H, W):
                disparity = resize_bilinear(disparity, H, W)
            disparity = self._refine_crf(img, disparity, instances)
        if disparity.shape[:2] != (H, W):
            disparity = resize_bilinear(disparity, H, W)
        return disparity

    def _stage_depth(self, name: str, disparity: torch.Tensor) -> None:
        if self.stage_previews:
            self.stages[name] = colorize_gray_r(
                disparity[..., 0]).cpu().numpy().astype(np.uint8)

    def save_stages(self, save_dir: str, name: str) -> None:
        """Write the stage images as <save_dir>/tmp_stage_<stage>_<name>.png
        (the reference run_kenburns --verbose dumps)."""
        import cv2
        os.makedirs(save_dir, exist_ok=True)
        for stage, img in self.stages.items():
            cv2.imwrite(os.path.join(save_dir,
                                     f'tmp_stage_{stage}_{name}.png'), img)

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

    def _est_leres_boost(self, image: torch.Tensor) -> torch.Tensor:
        """BoostingMonoDepth (``pipeline/boost.py``) with LeReS and the
        pix2pix merge net in f32 on the pipeline's device, on the image's
        uint8 bytes; then apply_leres's post-processing at image
        resolution. Parity: the JAX package's ``_est_leres_boost``,
        depth_modules/leres/__init__.py:112-141."""
        from .boost import LeReSBoost
        f32 = torch.float32
        boost = LeReSBoost(self._net('leres', f32), self._net('p2p', f32))
        img_u8 = (image.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        depth = torch.from_numpy(boost(img_u8)).to(self.device)
        self.last_boost = boost
        disp = leres_postprocess(depth)
        # zeros → min positive, where one is positive
        pos_min = torch.where(disp > 0, disp, float('inf')).min()
        return torch.where((disp == 0) & torch.isfinite(pos_min), pos_min,
                           disp)[..., None]

    def _ensure_marigold(self):
        """The Marigold model, made at first use from the cfg's knobs
        (one construction point for checkpoint loading and inference)."""
        if self.marigold is None:
            from ..models.marigold import MarigoldDepth
            cfg = self.cfg
            self.marigold = MarigoldDepth(
                processing_res=cfg.marigold_res,
                denoise_steps=cfg.marigold_steps,
                ensemble_size=cfg.marigold_ensemble,
                scheduler=cfg.marigold_scheduler, seed=self._seed)
        return self.marigold

    @torch.inference_mode()
    def _est_marigold(self, image: torch.Tensor) -> torch.Tensor:
        """Marigold's depth in [0, 1] on the image's RGB bytes (the cast
        truncates, as numpy's astype), zeros to the smallest positive
        value, as disparity (1 - depth) · 255. Parity: the JAX package's
        ``_est_marigold``, kenburns_effect.py:554-561."""
        net = self._ensure_marigold().ready(self.device)
        img_u8 = (image.flip(-1).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        depth = net(img_u8)
        pos_min = torch.where(depth > 0, depth, float('inf')).min()
        depth = torch.where((depth == 0) & torch.isfinite(pos_min), pos_min,
                            depth)
        return ((1.0 - depth) * 255.0)[..., None]

    def _zoe(self, hw: Tuple[int, int], nk: bool) -> torch.nn.Module:
        """ZoeDepth (or NK) at the grid ``hw`` on the device, in the conv
        dtype: the installed net if it fits, else one made from the seed
        and loaded from the checkpoint's path where one was loaded
        (whose variant then wins over ``nk``)."""
        from ..models.zoedepth import ZoeDepth, ZoeDepthNK
        ckpt = self._zoe_ckpt_path
        want_nk = self._zoe_ckpt_is_nk if ckpt is not None else nk
        if ckpt is not None and want_nk != nk:
            LOGGER.warning('depth_est asks for ZoeDepth %s but the loaded '
                           'checkpoint is %s: using the checkpoint\'s',
                           'NK' if nk else 'N', 'NK' if want_nk else 'N')
        cls = ZoeDepthNK if want_nk else ZoeDepth
        net = self.zoe_net
        if not isinstance(net, cls) or net.img_size != tuple(hw):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.zoe_net = cls(img_size=tuple(hw))
            if ckpt is not None:
                LOGGER.info('loading the zoe checkpoint again for %s', hw)
                self._load_zoe(ckpt)
            else:
                LOGGER.warning('zoedepth: RANDOM init (no checkpoint '
                               'loaded)')
        return self.zoe_net.to(self.device, self.conv_dtype).eval()

    @torch.inference_mode()
    def _est_zoe(self, image: torch.Tensor, nk: bool = False
                 ) -> torch.Tensor:
        """ZoeDepth's metric depth at the image fitted into 672 (/32),
        flip-averaged, as disparity focal · baseline / (depth + 1e-5)
        (NaN and inf to 0), resized to the image. The net runs in the
        conv dtype (bf16 on the card under 'auto'); the resizes and the
        conversion in f32. Parity: the JAX package's ``_est_zoe``,
        kenburns_effect.py:812-818."""
        from ..models.zoedepth import infer_zoe
        cfg = self.cfg
        H, W = image.shape[:2]
        zh, zw = scaledown_size(H, W, 672, divisor=32)
        net = self._zoe((zh, zw), nk)
        rgb = resize_bilinear(image.flip(-1), zh, zw)      # BGR → RGB
        depth = infer_zoe(net, rgb.permute(2, 0, 1)[None],
                          dtype=self.conv_dtype)[0, 0]
        depth = depth.clamp_min(1e-5)
        disp = true_div(cfg.focal * cfg.baseline, depth + 1e-5)
        disp = torch.nan_to_num(disp, nan=0.0, posinf=0.0, neginf=0.0)
        return resize_bilinear_aa(disp[..., None], H, W)

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

    def _adjust_disparity(self, image: torch.Tensor, disparity: torch.Tensor,
                          instances: Instances) -> torch.Tensor:
        """Instance depth adjustment at image resolution, returned at the
        disparity's own grid: a coarser grid is resized up to the image,
        adjusted there and resized back, both without antialias
        (kenburns_effect.py:49-92)."""
        H, W = image.shape[:2]
        dh, dw = disparity.shape[:2]
        d = disparity if (dh, dw) == (H, W) else \
            resize_bilinear(disparity, H, W)
        adj = adjust_disparity_by_instances(
            d[..., 0], instances, self.cfg.depthest_use_medium)[..., None]
        return adj if (dh, dw) == (H, W) else resize_bilinear(adj, dh, dw)

    def _prepare_state(self, image, disparity, instances) -> KenBurnsState:
        cfg = self.cfg
        H, W = image.shape[:2]
        focal, baseline = cfg.focal, cfg.baseline
        disparity = disparity / (disparity.max() + 1e-12) * baseline
        depth = true_div(focal * baseline, disparity + 1e-5)
        valid = valid_depth_mask(disparity)
        pts = depth_to_points((depth * valid)[..., 0], focal).reshape(-1, 3)
        dr = depth_range(depth[..., 0])
        # appended in place: the cloud is new, so no copy
        cloud = PointCloud.with_capacity(
            int(cfg.point_capacity_factor * H * W), self.device)
        cloud.append_masked_(
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

    def _hole_entries(self, image, disparity, existing, shift) -> tuple:
        """The hallucinated pixels unprojected, and the hole ones to
        append: append_masked's arguments (kenburns_effect.py:453-512)."""
        focal, baseline = self.cfg.focal, self.cfg.baseline
        new_depth = true_div(focal * baseline, disparity + 1e-7)
        valid = valid_depth_mask(disparity)
        pts = depth_to_points((new_depth * valid)[..., 0], focal)
        pts = pts.reshape(-1, 3) - shift[None, :]
        hole = (existing[..., 0] == 0.0).reshape(-1)
        return (pts, image.reshape(-1, 3), disparity.reshape(-1),
                new_depth.reshape(-1), hole)

    def _pass_entries(self, state: KenBurnsState, shift_u: float,
                      shift_v: float, depth_scale: float) -> tuple:
        """One inpainting pass at a camera extreme up to the entries it
        appends: the Inpaint net's forward, the stage preview, and for
        inpaint_type 'patchmatch', 'ldm' or 'ldm_native' the net's image
        filled again (``_host_fill``). Parity: kenburns_effect.py:441-514."""
        out, shift = self._inpaint_forward(state, shift_u, shift_v,
                                           depth_scale)
        if self.stage_previews:
            self.stages[f'inpainted_{int(state.cloud.count)}'] = \
                (out['image'].clamp(0.0, 1.0) * 255.0).to(
                    torch.uint8).cpu().numpy()
        image = out['image']
        if self.cfg.inpaint_type != 'default':
            image = self._host_fill(out)
        return self._hole_entries(image, out['disparity'], out['existing'],
                                  shift)

    def _host_fill(self, out: dict) -> torch.Tensor:
        """The hallucinated image filled under the hole mask (``existing``
        == 0, OR-ed with the rendered instance masks), the mask on the
        host: 'patchmatch' through the C++ PatchMatch on the BGR bytes,
        'ldm' through the sd-webui server on the RGB bytes, 'ldm_native'
        through ``LDMInpainter`` on the pipeline's device on the BGR
        bytes (it flips them itself), both with the mask dilated by a
        5-px ellipse, at ldm_inpaint_size (else max_size); back on the
        device as f32."""
        cfg = self.cfg
        mask = (out['existing'][..., 0] == 0.0).cpu().numpy().astype(
            np.uint8) * 255
        seg = out.get('segmasks')
        if seg is not None:
            mask |= (seg[..., 0] > 0).cpu().numpy().astype(np.uint8) * 255
        img_u8 = (out['image'].clamp(0.0, 1.0) * 255.0).to(
            torch.uint8).cpu().numpy()
        t0 = _time.perf_counter()
        if cfg.inpaint_type == 'patchmatch':
            from ..ops import patchmatch_native
            filled = patchmatch_native.inpaint(img_u8, mask, patch_size=3)
        else:
            import cv2
            e = 5
            el = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                           (2 * e + 1, 2 * e + 1))
            mask = cv2.dilate(mask, el)
            res = cfg.ldm_inpaint_size or cfg.max_size
            if cfg.inpaint_type == 'ldm_native':
                filled = self._ldm_inpainter()(img_u8, mask, res=res)
            else:
                from ..serving.sd_webui import ldm_inpaint_webui
                opts = {k: getattr(cfg.ldm_inpaint_options, k)
                        for k in ('steps', 'cfg_scale', 'sample_name',
                                  'denoising_strength', 'inpainting_fill',
                                  'seed', 'subseed')}
                filled = ldm_inpaint_webui(
                    img_u8[..., ::-1], mask, res, cfg.sd_img2img_url,
                    'high quality, masterpiece, no_humans',
                    'cat, human, single, person, girl, 1girl, creature, '
                    'animal, alien, robot, body', **opts)[..., ::-1]
        self.timer.add(f'inpaint_{cfg.inpaint_type}_host',
                       _time.perf_counter() - t0)
        return torch.from_numpy(np.ascontiguousarray(filled).astype(
            np.float32) / 255.0).to(self.device)

    def _ldm_inpainter(self):
        """``inpaint_type: ldm_native``'s LDMInpainter on the device, made
        at first use from ldm_inpaint_options (steps, cfg_scale, seed);
        load a checkpoint with ``pipe.ldm_inpainter.load_checkpoint``."""
        if self.ldm_inpainter is None:
            from ..models.ldm_inpaint import LDMInpainter
            o = self.cfg.ldm_inpaint_options
            self.ldm_inpainter = LDMInpainter(steps=o.steps,
                                              guidance=o.cfg_scale,
                                              seed=o.seed)
        return self.ldm_inpainter.ready(self.device)

    def inpaint_pass(self, state: KenBurnsState, shift_u: float,
                     shift_v: float, depth_scale: float) -> KenBurnsState:
        """One inpainting pass at a camera extreme, into a new cloud."""
        cloud = state.cloud.append_masked(*self._pass_entries(
            state, shift_u, shift_v, depth_scale))
        return state.replace(cloud=cloud)

    def inpaint_extremes(self, state: KenBurnsState, obj_from: Dict,
                         obj_to: Dict) -> KenBurnsState:
        """One inpaint pass at each camera extreme (t = 0, 1), then
        compact the grown cloud. The passes append in place to one copy
        of the state's cloud, so the caller's state is left as it was."""
        with self.timer.time('inpaint_passes', self.device):
            state = state.replace(cloud=state.cloud.clone())
            for t in (0.0, 1.0):
                su, sv, ds, _, _ = self._camera_params(t, obj_from, obj_to,
                                                       state)
                state.cloud.append_masked_(*self._pass_entries(state, su, sv,
                                                               ds))
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

    def _frame(self, state: KenBurnsState, cam: torch.Tensor, focal_planes,
               depth_field: bool) -> torch.Tensor:
        """One frame before its epilogue (``EpiloguePlan``, K5a): (H, W,
        3) f32, the filled frame's colours or, with ``depth_field``, its
        bokeh. Parity: kenburns_effect.py:1015-1072."""
        cfg = self.cfg
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
        return frame

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
        epilogue = EpiloguePlan(max_ch, max_cw, H, W)
        epilogue.outputs(frames)
        for i in range(len(cams)):
            epilogue(self._frame(state, cams[i], fps, depth_field), i)
        return frames if return_device else frames.cpu().numpy()

    @torch.inference_mode()
    def render_frames_stream(self, state: KenBurnsState, obj_from: Dict,
                             obj_to: Dict, steps, video_path: str,
                             depth_field: Optional[bool] = None,
                             chunk: int = 16, fps: int = 25) -> np.ndarray:
        """Render in chunks; each chunk is packed to I420 on the device
        (BGR where the frame size does not fit I420: H % 4 or W % 2)
        and copied to pinned host memory asynchronously while the next
        chunk renders, and a worker thread decodes and encodes it. With
        cfg.playback the palindrome tail follows. Returns the forward
        frames (BGR; decoded from the I420 stream where it was used)."""
        cfg, dev = self.cfg, self.device
        if depth_field is None:
            depth_field = cfg.depth_field
        H, W = state.hw
        T = len(steps)
        max_cw = max(obj_from['crop_w'], obj_to['crop_w'])
        max_ch = max(obj_from['crop_h'], obj_to['crop_h'])
        use_i420 = H % 4 == 0 and W % 2 == 0
        cams = self._cams(state, obj_from, obj_to, steps)
        planes = self.focal_planes(state, cams, depth_field)
        epilogue = EpiloguePlan(max_ch, max_cw, H, W)
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
                    if use_i420:
                        bgr, yuv = i420_to_bgr_host(arr), arr
                    else:
                        bgr, yuv = arr, [None] * len(arr)
                    host_bgr[ci], host_i420[ci] = bgr, yuv
                    for f, y in zip(bgr, yuv):
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
                # each frame's epilogue writes its BGR (and I420)
                # straight into the chunk's buffers
                bgr = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
                i420 = torch.empty((n, H * 3 // 2, W), dtype=torch.uint8,
                                   device=dev) if use_i420 else None
                epilogue.outputs(bgr, i420)
                for j in range(n):
                    epilogue(self._frame(state, cams[c0 + j], planes,
                                         depth_field), j)
                sent = bgr if i420 is None else i420
                host = torch.empty(sent.shape, dtype=torch.uint8,
                                   pin_memory=pin)
                host.copy_(sent, non_blocking=pin)
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


def stream_video(frames: torch.Tensor, path: str, fps: int = 25,
                 playback: bool = True, chunk: int = 8,
                 yuv420: bool = True) -> np.ndarray:
    """(T, H, W, 3) BGR uint8 frames on the device → video, in chunks:
    every chunk's copy to pinned host memory is enqueued before the
    first is encoded, so the copies run while the host encodes. With ``yuv420`` and H % 4 == 0, W % 2 ==
    0 the chunks are packed to I420 on the device first (half the bytes
    to move; ``bgr_to_i420``, the bytes K5a's I420 output is held to)
    and decoded on the host; otherwise they move as BGR. The palindrome
    tail (``playback``) reuses the host frames. Returns the forward
    frames as written (decoded from I420 where it was used). Parity:
    the JAX package's ``stream_video``."""
    T, h, w = frames.shape[:3]
    use_i420 = yuv420 and h % 4 == 0 and w % 2 == 0 and T > 0
    pin = frames.device.type == 'cuda'
    copies = []
    for c0 in range(0, T, chunk):
        sent = frames[c0:c0 + chunk]
        if use_i420:
            sent = bgr_to_i420(sent)
        host = torch.empty(sent.shape, dtype=torch.uint8, pin_memory=pin)
        host.copy_(sent, non_blocking=pin)
        ev = None
        if pin:
            ev = torch.cuda.Event()
            ev.record()
        copies.append((ev, host))
    sink = _VideoSink(path, w, h, fps)
    out = []
    try:
        for ev, host in copies:
            if ev is not None:
                ev.synchronize()
            arr = host.numpy()
            bgr = i420_to_bgr_host(arr) if use_i420 else arr
            out.append(bgr)
            for f, y in zip(bgr, arr if use_i420 else [None] * len(arr)):
                sink.write(f, y)
        frames_h = np.concatenate(out) if out else \
            np.zeros((0, h, w, 3), np.uint8)
        if playback:
            for f in list(frames_h)[::-1][1:-1]:
                sink.write(f, None)
    finally:
        sink.close()
    return frames_h
