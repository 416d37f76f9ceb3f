"""Second-stage mask refinement (port of
``cartoonsegmentation_tpu/pipeline/refine.py``): ``refinenet_isnet``,
the per-instance ISNet (``ISNetRefiner``), and ``animeseg``, one
whole-image segmentation net (ISNet, the ISNet GT encoder, U²-Net full
or lite, or MODNet: ``get_refine_net``) whose mask is intersected with
each instance's (``AnimeSegRefiner``). ``make_refiner`` takes every
name the JAX package's does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..instances import Instances
from ..models.isnet import ISNetDIS
from ..models.modnet import MODNet
from ..models.u2net import ISNetGTEncoder, U2Net
from ..utils.image import resize_bilinear_aa, resize_bilinear_ac, \
    scaledown_size

from ..utils.logger import LOGGER


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


def get_refine_net(net_name: str):
    """The animeseg net of a name (isnet, isnet_is, isnet_gt, u2net (full2),
    u2netl (lite2), modnet; the reference's get_net): (a function that
    makes the module, a function (module, RGB [0, 1] NCHW batch) → the
    foreground probability (B, H, W))."""
    if net_name in ('isnet', 'isnet_is'):
        def run(net, x):
            return torch.sigmoid(net(x)[0][0][:, 0])
        return (lambda: ISNetDIS(in_ch=3)), run
    if net_name == 'isnet_gt':
        def run(net, x):
            # the GT encoder reads one channel: the image's luma
            luma = 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]
            return torch.sigmoid(net(luma)[0][0][:, 0])
        return ISNetGTEncoder, run
    if net_name in ('u2net', 'u2netl'):
        def run(net, x):
            return torch.sigmoid(net(x)[0][0][:, 0])
        return (lambda: U2Net(lite=net_name == 'u2netl')), run
    if net_name == 'modnet':
        def run(net, x):
            # MODNet reads [-1, 1] and predicts the matte itself
            return net(x * 2.0 - 1.0)[2][:, 0]
        return MODNet, run
    raise ValueError(f'unknown animeseg net: {net_name!r} (expected '
                     'isnet/isnet_is/isnet_gt/u2net/u2netl/modnet)')


class AnimeSegRefiner:
    """'animeseg': one whole-image net's mask (RGB at ``input_size``,
    thresholded at ``seg_thr``) intersected with each instance mask when
    the intersection keeps more than 30% of its area. Parity:
    animeinsseg/__init__.py:78-117. The net runs in f32, as in the JAX
    package."""

    def __init__(self, input_size: int = 1024, seg_thr: float = 0.5,
                 seed: int = 0, net_name: str = 'isnet_is', device=None):
        self.input_size = input_size
        self.seg_thr = seg_thr
        self.net_name = net_name
        self._make, self._run = get_refine_net(net_name)
        self.device = resolve_device(device)
        self._seed = seed
        self.net: Optional[torch.nn.Module] = None

    def _net(self) -> torch.nn.Module:
        if self.net is None:
            LOGGER.warning('AnimeSegRefiner(%s): RANDOM init (no '
                           'checkpoint)', self.net_name)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self._seed)
                self.net = self._make()
        return self.net.to(self.device, torch.float32).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        """The reference's animeseg checkpoint of this net (keys may
        carry lightning's 'net.' prefix)."""
        sd = torch.load(path, map_location='cpu', weights_only=False)
        sd = sd.get('state_dict', sd)
        sd = {k[4:] if k.startswith('net.') else k: v for k, v in sd.items()}
        net = self._make()
        net.load_state_dict(sd)
        self.net = net

    @torch.inference_mode()
    def __call__(self, instances: Instances, img_bgr: np.ndarray
                 ) -> Instances:
        if instances.is_empty_host():
            return instances
        dev = self.device
        H, W = img_bgr.shape[:2]
        S = self.input_size
        nh, nw = scaledown_size(H, W, S)
        rgb = torch.from_numpy(
            img_bgr[..., ::-1].astype(np.float32) / 255.0).to(dev)
        img = torch.zeros((1, 3, S, S), device=dev)
        img[0, :, :nh, :nw] = resize_bilinear_aa(rgb, nh, nw).permute(2, 0, 1)
        pred = self._run(self._net(), img)[0, :nh, :nw]
        whole = resize_bilinear_ac(pred[..., None], H, W)[..., 0] \
            > self.seg_thr
        masks = instances.masks.to(dev)
        refined = masks & whole[None]
        area0 = masks.sum((1, 2))
        area1 = refined.sum((1, 2))
        take = (area1 / area0.clamp(min=1)) > 0.3
        out = torch.where(take[:, None, None], refined, masks)
        return instances.replace(
            masks=out & instances.valid.to(dev)[:, None, None])


ANIMESEG_NETS = ('isnet', 'isnet_is', 'isnet_gt', 'u2net', 'u2netl',
                 'modnet')


def make_refiner(method: str = 'refinenet_isnet', refine_size: int = 720,
                 mask_thr: float = 0.3, seed: int = 0, dtype: str = 'auto',
                 device=None):
    """Refine-method factory: 'none', 'refinenet_isnet', 'animeseg'
    (ISNet-IS), 'animeseg:<net>' or a bare animeseg net name (the
    reference's set_refine_method and get_net names). The animeseg
    nets run at max(refine_size, 1024)."""
    if method in (None, 'none', ''):
        return None
    if method == 'refinenet_isnet':
        return ISNetRefiner(refine_size, mask_thr, seed=seed, dtype=dtype,
                            device=device)
    size = max(refine_size, 1024)
    if method == 'animeseg':
        return AnimeSegRefiner(size, seed=seed, device=device)
    if method.startswith('animeseg:'):
        return AnimeSegRefiner(size, seed=seed, device=device,
                               net_name=method.split(':', 1)[1])
    if method in ANIMESEG_NETS:
        return AnimeSegRefiner(size, seed=seed, device=device,
                               net_name=method)
    raise ValueError(f'unknown refine method: {method}')
