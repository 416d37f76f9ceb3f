"""The 3D-Ken-Burns nets (port of
``cartoonsegmentation_tpu/models/kenburns.py``): the disparity
estimator (``Semantics``, VGG19-bn features with their BatchNorm
statistics, and ``Disparity``, a 6-row grid U-net, in
``DisparityEstimator``), the image-guided disparity upsampler
``Refine`` and the point-cloud inpainting net ``Inpaint`` (reference
disparity_estimation.py:80-193, disparity_refinement.py:81-127,
pointcloud_inpainting.py:81-204).

``Inpaint``'s forward renders the shifted point cloud of (imageN,
disparityN, 64-channel context) with the K1 splat, gates ``existing``
with a 5x5 median, and a 4-row grid U-net hallucinates colour and
disparity where ``existing`` is 0. Parameter names follow the published
checkpoints (``netContext``, ``netInput``, ``'{r}x{c} - {r}x{c+1}'``
grid cells, ``netImage``, ``netDisparity``, ``netSemantics``,
``netImageOne`` … ``netRefine``; ``Semantics.netVgg`` keeps
torchvision's ``vgg19_bn().features`` indices).

``Inpaint``'s conv stacks (context and U-net) run in the dtype of the
module's parameters (the pipeline casts the module to bf16 on CUDA when
cfg.dtype is 'auto'); geometry, splat and the normalisation statistics
stay f32 and the heads return to f32, as in the JAX package.
``DisparityEstimator`` and ``Refine`` take and return NCHW tensors and
run in f32, as the JAX package's do.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.filters import median_filter, valid_depth_mask
from ..ops.pointcloud import depth_to_points, render_pointcloud, true_div
from .layers import (Basic, Downsample, PReLU, Upsample, conv, crop_like,
                     normalize_mean_std, resize_to)

# ---------------------------------------------------------------------------
# the disparity estimator and the refine net
# ---------------------------------------------------------------------------

_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
# vgg19_bn's features through the 4th pool: convs of these widths, 'M' a
# 2x2 max pool (ceil mode, as the JAX package pools)
_VGG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
        512, 512, 512, 512, 'M')


class Semantics(nn.Module):
    """VGG19-bn features through the 4th pool (512 channels at /16) of a
    BGR [0, 1] NCHW image, flipped to RGB and ImageNet-normalised
    first."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for w in _VGG:
            if w == 'M':
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
            else:
                layers += [nn.Conv2d(cin, w, 3, 1, 1),
                           nn.BatchNorm2d(w, eps=1e-5), nn.ReLU()]
                cin = w
        self.netVgg = nn.Sequential(*layers)
        self.register_buffer('mean', torch.tensor(_VGG_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor(_VGG_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, bgr):
        return self.netVgg((bgr.flip(1) - self.mean) / self.std)


def _grid_cells(module: nn.Module, f: Sequence[int]) -> None:
    """The grid U-net's cells: basics r x 3, downs in columns 0-1, ups in
    columns 2-3, under the checkpoints' '{r}x{c} - …' names."""
    for r in range(len(f)):
        for c in range(3):
            module.add_module(f'{r}x{c} - {r}x{c + 1}',
                              Basic('relu-conv-relu-conv', (f[r], f[r], f[r])))
    for c in (0, 1):
        for r in range(len(f) - 1):
            module.add_module(f'{r}x{c} - {r + 1}x{c}',
                              Downsample((f[r], f[r + 1], f[r + 1])))
    for c in (2, 3):
        for r in range(len(f) - 1):
            module.add_module(f'{r + 1}x{c} - {r}x{c}',
                              Upsample((f[r + 1], f[r], f[r])))


def _grid_passes(m, cols: List, n: int) -> List:
    """Columns 1-3 of the grid over column 0's rows."""
    cols = _col_down(cols, [m[f'{r}x0 - {r}x1'] for r in range(n)],
                     [m[f'{r}x1 - {r + 1}x1'] for r in range(n - 1)])
    cols = _col_up(cols, [m[f'{r}x1 - {r}x2'] for r in range(n)],
                   [m[f'{r + 1}x2 - {r}x2'] for r in range(n - 1)])
    return _col_up(cols, [m[f'{r}x2 - {r}x3'] for r in range(n)],
                   [m[f'{r + 1}x3 - {r}x3'] for r in range(n - 1)])


class Disparity(nn.Module):
    """6-row grid U-net of rows (32, 48, 64, 512, 512, 512) over the
    image, the semantics joining row 3 of column 0."""
    feats: Tuple[int, ...] = (32, 48, 64, 512, 512, 512)

    def __init__(self):
        super().__init__()
        self.netImage = conv(3, 32, kernel=7, stride=2, pad=3)
        self.netSemantics = conv(512, 512)
        _grid_cells(self, self.feats)
        self.netDisparity = Basic('conv-relu-conv', (32, 32, 1))

    def forward(self, image_bgr, semantics):
        m = self._modules
        cols = [self.netImage(image_bgr)]
        for r in range(len(self.feats) - 1):
            h = m[f'{r}x0 - {r + 1}x0'](cols[r])
            if r == 2:
                h = h + self.netSemantics(semantics)
            cols.append(h)
        cols = _grid_passes(m, cols, len(self.feats))
        return self.netDisparity(cols[0]).clamp(min=0.0)


class DisparityEstimator(nn.Module):
    """Semantics + Disparity on the image resized (no antialias) to fit
    512 with its aspect kept; the disparity at half that size."""

    def __init__(self):
        super().__init__()
        self.semantics = Semantics()
        self.disparity = Disparity()

    @staticmethod
    def input_size(h: int, w: int) -> Tuple[int, int]:
        ratio = w / h
        return min(int(512 / ratio), 512), min(int(512 * ratio), 512)

    def forward(self, image_bgr):
        x = resize_to(image_bgr, *self.input_size(*image_bgr.shape[-2:]))
        return self.disparity(x, self.semantics(x))


class Refine(nn.Module):
    """Image-guided disparity upsampler: (image (B, 3, H, W), disparity
    (B, 1, h, w) at a coarser grid) → disparity (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.netImageOne = Basic('conv-relu-conv', (3, 24, 24))
        self.netImageTwo = Downsample((24, 48, 48))
        self.netImageThr = Downsample((48, 96, 96))
        self.netDisparityOne = Basic('conv-relu-conv', (1, 96, 96))
        self.netDisparityTwo = Upsample((192, 96, 96))
        self.netDisparityThr = Upsample((144, 48, 48))
        self.netDisparityFou = Basic('conv-relu-conv', (72, 24, 24))
        self.netRefine = Basic('conv-relu-conv', (24, 24, 1))

    def forward(self, image_bgr, disparity):
        imgN, _, _ = normalize_mean_std(image_bgr)
        dispN, dmean, dstd = normalize_mean_std(disparity)
        img1 = self.netImageOne(imgN)
        img2 = self.netImageTwo(img1)
        img3 = self.netImageThr(img2)
        up = self.netDisparityOne(dispN)
        for img, net in ((img3, self.netDisparityTwo),
                         (img2, self.netDisparityThr),
                         (img1, self.netDisparityFou)):
            if up.shape[-2:] != img.shape[-2:]:
                up = resize_to(up, *img.shape[-2:])
            up = net(torch.cat([img, up], 1))
        refined = self.netRefine(up) * (dstd + 1e-7) + dmean
        return refined.clamp(min=0.0)


def _col_down(cols: List, basics: Sequence, downs: Sequence) -> List:
    """Column pass with downsample lateral adds (top-down)."""
    out: List = []
    for r in range(len(cols)):
        h = basics[r](cols[r])
        if r != 0:
            h = h + downs[r - 1](out[r - 1])
        out.append(h)
    return out


def _col_up(cols: List, basics: Sequence, ups: Sequence) -> List:
    """Column pass with upsample lateral adds (bottom-up, crop to fit)."""
    n = len(cols)
    out: List = [None] * n
    for r in range(n - 1, -1, -1):
        h = basics[r](cols[r])
        if r != n - 1:
            h = h + crop_like(ups[r](out[r + 1]), h)
        out[r] = h
    return out


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(2, 0, 1)[None].to(dtype)


def _hwc(x: torch.Tensor) -> torch.Tensor:
    return x[0].permute(1, 2, 0).float()


class Inpaint(nn.Module):
    feats: Tuple[int, ...] = (32, 64, 128, 256)

    def __init__(self):
        super().__init__()
        f = self.feats
        self.netContext = nn.Sequential(conv(4, 64), PReLU(64),
                                        conv(64, 64), PReLU(64))
        self.netInput = Basic('conv-relu-conv', (69, 32, 32))
        _grid_cells(self, f)
        self.netImage = Basic('conv-relu-conv', (32, 32, 3))
        self.netDisparity = Basic('conv-relu-conv', (32, 32, 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.netInput.netMain[0].weight.dtype

    def _m(self, name: str) -> nn.Module:
        return self._modules[name]

    def context(self, imgN: torch.Tensor, dispN: torch.Tensor
                ) -> torch.Tensor:
        """Context feature convs on channel-last inputs → (H, W, 64)."""
        x = _nchw(torch.cat([imgN, dispN], -1), self.dtype)
        return _hwc(self.netContext(x))

    def unet(self, render: torch.Tensor, existing: torch.Tensor):
        """Grid U-net over the gated (H, W, 68) render and (H, W, 1)
        existing mask; raw (image, disparity) heads before
        de-normalisation, channel-last f32."""
        n = len(self.feats)
        cols = [self.netInput(_nchw(torch.cat([render, existing], -1),
                                    self.dtype))]
        for r in range(n - 1):
            cols.append(self._m(f'{r}x0 - {r + 1}x0')(cols[r]))
        cols = _grid_passes(self._modules, cols, n)
        return _hwc(self.netImage(cols[0])), _hwc(self.netDisparity(cols[0]))

    def forward(self, image_bgr: torch.Tensor, disparity: torch.Tensor,
                shift: torch.Tensor, focal: float, baseline: float,
                segmasks: Optional[torch.Tensor] = None) -> dict:
        """image_bgr (H, W, 3) in [0, 1], disparity (H, W, 1), shift
        (3,), segmasks (H, W, k) or None → dict of channel-last
        'existing', 'image', 'disparity', 'segmasks'."""
        H, W = image_bgr.shape[:2]
        depth = true_div(focal * baseline, disparity + 1e-7)
        valid = valid_depth_mask(disparity)
        points = depth_to_points((depth * valid)[..., 0], focal)
        points = points.reshape(-1, 3) + shift[None, :]

        imgN, imean, istd = normalize_mean_std(image_bgr)
        dispN, dmean, dstd = normalize_mean_std(disparity)
        ctx = self.context(imgN, dispN)

        payload = torch.cat([imgN, dispN, ctx], -1)          # 68 ch
        render, existing = render_pointcloud(
            points, payload.reshape(H * W, -1), H, W, focal, baseline)

        seg_render = None
        if segmasks is not None:
            segp = torch.cat([segmasks, dispN], -1)
            seg_render, _ = render_pointcloud(
                points, segp.reshape(H * W, -1), H, W, focal, baseline)
            seg_render = seg_render[..., :segmasks.shape[-1]]

        existing = (existing > 0.0).to(render.dtype)
        existing = existing * median_filter(existing, 5)
        render = render * existing

        image_raw, disp_raw = self.unet(render, existing)
        image = (image_raw * (istd + 1e-7) + imean).clamp(0.0, 1.0)
        disp_out = disp_raw * (dstd + 1e-7) + dmean
        return {'existing': existing, 'image': image,
                'disparity': disp_out.clamp(min=0.0),
                'segmasks': seg_render}
