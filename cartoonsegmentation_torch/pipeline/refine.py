"""Second-stage mask refinement, ``refinenet_isnet`` (port of
``cartoonsegmentation_tpu/pipeline/refine.py:ISNetRefiner`` and
``make_refiner``). The other refiners (animeseg and its whole-image
nets) are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..instances import Instances
from ..models.isnet import ISNetDIS
from ..utils.image import resize_bilinear_aa, resize_bilinear_ac, \
    scaledown_size

LOGGER = logging.getLogger('cartoonsegmentation_torch')


class ISNetRefiner:
    """refinenet_isnet: ISNetDIS(in_ch=4: BGR + coarse mask) at
    ``refine_size``. Only the valid instances run, ``chunk`` at a time
    in slot order; each instance's result depends on its own inputs
    alone, so the chunk size does not change it."""

    def __init__(self, refine_size: int = 720, mask_thr: float = 0.3,
                 chunk: int = 4, seed: int = 0, dtype: str = 'auto',
                 device=None):
        self.refine_size = refine_size
        self.mask_thr = mask_thr
        self.chunk = chunk
        self.device = resolve_device(device)
        # 'auto': bf16 convs on CUDA; sigmoid and threshold stay f32
        self.dtype = resolve_dtype(dtype, self.device)
        self._seed = seed
        self.net: Optional[ISNetDIS] = None

    def _net(self) -> ISNetDIS:
        if self.net is None:
            LOGGER.warning('ISNetRefiner: RANDOM init (no checkpoint)')
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.net = ISNetDIS(in_ch=4)
        return self.net.to(self.device, self.dtype).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        """The reference refine checkpoint (keys may carry lightning's
        'net.' prefix)."""
        sd = torch.load(path, map_location='cpu', weights_only=False)
        sd = sd.get('state_dict', sd)
        sd = {k[4:] if k.startswith('net.') else k: v for k, v in sd.items()}
        net = ISNetDIS(in_ch=4)
        net.load_state_dict(sd)
        self.net = net

    @torch.inference_mode()
    def __call__(self, instances: Instances, img_bgr: np.ndarray
                 ) -> Instances:
        """Refine every valid instance. Parity:
        animeinsseg/__init__.py:638-665."""
        valid_h = instances.valid.cpu().numpy()
        sel_all = np.flatnonzero(valid_h)
        if sel_all.size == 0:
            return instances
        dev = self.device
        H, W = img_bgr.shape[:2]
        S = self.refine_size
        nh, nw = scaledown_size(H, W, S)
        net = self._net()
        image = torch.from_numpy(img_bgr.astype(np.float32) / 255.0).to(dev)
        small = resize_bilinear_aa(image, nh, nw)
        img = torch.zeros((3, S, S), device=dev)
        img[:, :nh, :nw] = small.permute(2, 0, 1)
        masks = instances.masks.to(dev)
        out = torch.zeros_like(masks)
        for c0 in range(0, sel_all.size, self.chunk):
            sel = torch.from_numpy(sel_all[c0:c0 + self.chunk]).to(dev)
            c = sel.shape[0]
            m = resize_bilinear_aa(masks[sel].float().permute(1, 2, 0),
                                   nh, nw).permute(2, 0, 1)
            batch = torch.zeros((c, 4, S, S), device=dev)
            batch[:, :3] = img
            batch[:, 3, :nh, :nw] = m
            sides, _ = net(batch.to(self.dtype))
            probs = torch.sigmoid(sides[0][:, 0].float())[:, :nh, :nw]
            up = resize_bilinear_ac(probs[..., None], H, W)[..., 0]
            out[sel] = up > self.mask_thr
        return instances.replace(
            masks=out & instances.valid.to(dev)[:, None, None])


def make_refiner(method: str = 'refinenet_isnet', refine_size: int = 720,
                 mask_thr: float = 0.3, seed: int = 0, dtype: str = 'auto',
                 device=None) -> Optional[ISNetRefiner]:
    """Refine-method factory ('none' or 'refinenet_isnet')."""
    if method in (None, 'none', ''):
        return None
    if method == 'refinenet_isnet':
        return ISNetRefiner(refine_size, mask_thr, seed=seed, dtype=dtype,
                            device=device)
    raise NotImplementedError(f'refine method {method!r} is not ported to '
                              "cartoonsegmentation_torch yet (only "
                              "'refinenet_isnet' and 'none')")
