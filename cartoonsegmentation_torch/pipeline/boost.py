"""BoostingMonoDepth for LeReS (port of
``cartoonsegmentation_tpu/pipeline/boost.py``, the reference's
``estimateboost``, depth_modules/leres/leres/depthmap.py): R_x, the
largest whole-image size that keeps 20% of the pixels near a contextual
edge; a 448 and an R_x LeReS estimate merged by the pix2pix net at
1024; then gradient-dense patches, each estimated the same way, merged
onto the base estimate and blended in with a Gaussian mask after a
degree-1 polyfit.

The patch selection and the blend are the JAX package's host code,
copied (numpy and cv2); the selection reads only the image, so every
device chooses the same patches. The nets run on their device: the
whole-image double estimate, then the patches in batches (the JAX
package maps them one at a time). Device resizes are
``jax.image.resize``'s cubic (``utils/image.py:resize_cubic_nchw``).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.pix2pix4depth import merge_depths
from ..utils.image import resize_cubic_nchw

WHOLE_SIZE_THRESHOLD = 1600   # R_max (depthmap.py:13)
PIX2PIX_SIZE = 1024
RECEPTIVE_FIELD = 448         # LeReS receptive field (:507)
PATCH_NETSIZE = 2 * RECEPTIVE_FIELD
R_THRESHOLD = 0.2             # x of R_x (:425)
SCALE_THRESHOLD = 3           # max upscaling (:437)
PATCH_BATCH = 4               # patches through the nets at once


def generatemask(size: Tuple[int, int]) -> np.ndarray:
    """Gaussian blend mask (depthmap.py:48-57)."""
    import cv2
    mask = np.zeros(size, dtype=np.float32)
    sigma = int(size[0] / 16)
    k_size = int(2 * np.ceil(2 * int(size[0] / 16)) + 1)
    mask[int(0.15 * size[0]):size[0] - int(0.15 * size[0]),
         int(0.15 * size[1]):size[1] - int(0.15 * size[1])] = 1
    mask = cv2.GaussianBlur(mask, (k_size, k_size), sigma)
    mask = (mask - mask.min()) / (mask.max() - mask.min())
    return mask.astype(np.float32)


def _rgb2gray(img: np.ndarray) -> np.ndarray:
    # reference applies RGB luma weights to whatever order it is
    # given (the pipeline hands it BGR) — kept verbatim for parity
    return np.dot(img[..., :3], [0.2989, 0.5870, 0.1140])


def _resizewithpool(img: np.ndarray, size: int) -> np.ndarray:
    """block_reduce(img, (n, n), max) without the skimage dependency
    (depthmap.py:59-64)."""
    n = int(np.floor(img.shape[0] / size))
    h, w = img.shape
    ph, pw = (-h) % n, (-w) % n
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)),
                     constant_values=-np.inf)
    H, W = img.shape
    return img.reshape(H // n, n, W // n, n).max(axis=(1, 3))


def calculateprocessingres(img: np.ndarray, basesize: int,
                           confidence: float = 0.1,
                           scale_threshold: int = 3,
                           whole_size_threshold: int = 3000
                           ) -> Tuple[int, float]:
    """R_x search (depthmap.py:70-126). Returns (R_x, patch_scale K)."""
    import cv2
    speed_scale = 32
    image_dim = int(min(img.shape[0:2]))

    gray = _rgb2gray(img)
    grad = np.abs(cv2.Sobel(gray, cv2.CV_64F, 0, 1, ksize=3)) + \
        np.abs(cv2.Sobel(gray, cv2.CV_64F, 1, 0, ksize=3))
    grad = cv2.resize(grad, (image_dim, image_dim), cv2.INTER_AREA)

    m, M = grad.min(), grad.max()
    middle = m + (0.4 * (M - m))
    grad[grad < middle] = 0
    grad[grad >= middle] = 1

    kernel = np.ones((int(basesize / speed_scale),) * 2, float)
    kernel2 = np.ones((int(basesize / (4 * speed_scale)),) * 2, float)

    threshold = min(whole_size_threshold,
                    scale_threshold * max(img.shape[:2]))
    outputsize_scale = basesize / speed_scale
    for p_size in range(int(basesize / speed_scale),
                        int(threshold / speed_scale),
                        int(basesize / (2 * speed_scale))):
        grad_resized = _resizewithpool(grad, p_size)
        grad_resized = cv2.resize(grad_resized, (p_size, p_size),
                                  cv2.INTER_NEAREST)
        grad_resized = (grad_resized >= 0.5).astype(np.float64)
        dilated = cv2.dilate(grad_resized, kernel, iterations=1)
        if (1 - dilated).mean() > confidence:
            break
        outputsize_scale = p_size

    grad_region = cv2.dilate(grad_resized, kernel2, iterations=1)
    return int(outputsize_scale * speed_scale), float(grad_region.mean())


def _apply_grid_patch(blsize, stride, img, box):
    """Initial grid (depthmap.py:159-172)."""
    bounds = []
    for k in range(blsize, img.shape[1] - blsize, stride):
        for j in range(blsize, img.shape[0] - blsize, stride):
            rect = [box[0] + k - blsize, box[1] + j - blsize,
                    2 * blsize, 2 * blsize]
            bounds.append({'rect': rect, 'size': rect[2]})
    return bounds


def _get_gf(integral, rect):
    x1, y1, w, h = rect
    return (integral[y1 + h, x1 + w] - integral[y1, x1 + w]
            - integral[y1 + h, x1] + integral[y1, x1])


def _adaptiveselection(integral_grad, patch_bounds, gf, factor):
    """Keep gradient-dense patches, grow each until density matches
    the whole image (depthmap.py:221-264)."""
    patchlist = []
    height, width = integral_grad.shape
    search_step = int(32 / factor)
    for p in patch_bounds:
        bbox = list(p['rect'])
        cgf = _get_gf(integral_grad, bbox) / (bbox[2] * bbox[3])
        if cgf >= gf:
            bbox_test = bbox.copy()
            while True:
                bbox_test[0] -= int(search_step / 2)
                bbox_test[1] -= int(search_step / 2)
                bbox_test[2] += search_step
                bbox_test[3] += search_step
                if bbox_test[0] < 0 or bbox_test[1] < 0 or \
                        bbox_test[1] + bbox_test[3] >= height or \
                        bbox_test[0] + bbox_test[2] >= width:
                    break
                cgf = _get_gf(integral_grad, bbox_test) / \
                    (bbox_test[2] * bbox_test[3])
                if cgf < gf:
                    break
                bbox = bbox_test.copy()
            patchlist.append({'rect': bbox, 'size': bbox[2]})
    return patchlist


def generatepatchs(img: np.ndarray, base_size: int, factor: float):
    """Gradient-guided patch set, biggest first (depthmap.py:176-207)."""
    import cv2
    gray = _rgb2gray(img)
    whole_grad = np.abs(cv2.Sobel(gray, cv2.CV_64F, 0, 1, ksize=3)) + \
        np.abs(cv2.Sobel(gray, cv2.CV_64F, 1, 0, ksize=3))
    threshold = whole_grad[whole_grad > 0].mean()
    whole_grad[whole_grad < threshold] = 0
    gf = whole_grad.sum() / len(whole_grad.reshape(-1))
    grad_integral = cv2.integral(whole_grad)

    blsize = int(round(base_size / 2))
    stride = int(round(blsize * 0.75))
    bounds = _apply_grid_patch(blsize, stride, img, [0, 0, 0, 0])
    patchlist = _adaptiveselection(grad_integral, bounds, gf, factor)
    return sorted(patchlist, key=lambda x: x['size'], reverse=True)


@functools.lru_cache(maxsize=1)
def _blend_mask() -> np.ndarray:
    """The 3000x3000 blend mask every patch's mask is resized from (one
    GaussianBlur of ~750 taps, made once)."""
    return generatemask((3000, 3000))


class LeReSBoost:
    """estimateboost over the port's LeReS and pix2pix nets, both on one
    device in f32. ``max_res=None`` is the reference's call (the input's
    max(H, W)): the patches are skipped where R_x exceeds it. After a
    call, ``last_rects`` holds the patches (x1, y1, x2, y2) in blend
    order and ``last_whole_size`` R_x."""

    def __init__(self, leres_net, p2p_net, max_res: Optional[int] = None):
        self.leres_net = leres_net
        self.p2p_net = p2p_net
        self.max_res = max_res
        self.last_rects: List[Tuple[int, int, int, int]] = []
        self.last_whole_size = 0

    @property
    def device(self) -> torch.device:
        return next(self.leres_net.parameters()).device

    def _leres(self, bgr01: np.ndarray) -> torch.Tensor:
        """(N, S, S, 3) BGR in [0, 1] on the host → LeReS (N, S, S)."""
        x = torch.from_numpy(np.ascontiguousarray(bgr01)).to(self.device)
        return self.leres_net(x.flip(-1).permute(0, 3, 1, 2))[:, 0]

    @staticmethod
    def _to_merge(e: torch.Tensor) -> torch.Tensor:
        S = PIX2PIX_SIZE
        return resize_cubic_nchw(e[:, None], S, S)[:, 0]

    @torch.inference_mode()
    def _double(self, img_bgr01: np.ndarray, size2: int) -> np.ndarray:
        """doubleestimate: LeReS at 448 and at size2, merged at 1024,
        min-max normalised."""
        import cv2
        a = cv2.resize(img_bgr01, (RECEPTIVE_FIELD, RECEPTIVE_FIELD),
                       interpolation=cv2.INTER_CUBIC)
        b = cv2.resize(img_bgr01, (size2, size2),
                       interpolation=cv2.INTER_CUBIC)
        e1 = self._to_merge(self._leres(a[None]))
        e2 = self._to_merge(self._leres(b[None]))
        m = merge_depths(self.p2p_net, e1, e2)[0]
        m = (m - m.min()) / torch.clamp(m.max() - m.min(), min=1e-12)
        return m.cpu().numpy()

    @torch.inference_mode()
    def _patches(self, p448, p896, base1024) -> np.ndarray:
        """Each patch: LeReS at 448 and 896 merged at 1024, then merged
        with its base patch (not min-max normalised again,
        depthmap.py:512-517). Host arrays in, (N, 1024, 1024) out."""
        out = []
        for i in range(0, len(p448), PATCH_BATCH):
            s = slice(i, i + PATCH_BATCH)
            e1 = self._to_merge(self._leres(np.stack(p448[s])))
            e2 = self._to_merge(self._leres(np.stack(p896[s])))
            inner = merge_depths(self.p2p_net, e1, e2)
            base = torch.from_numpy(np.stack(base1024[s])).to(self.device)
            out.append(merge_depths(self.p2p_net, base, inner).cpu())
        return torch.cat(out).numpy()

    def __call__(self, img_bgr: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) BGR → the boosted raw depth (H, W) float32 in
        [0, 1] (estimateboost's return; the disparity post-processing
        comes after)."""
        import cv2
        img01 = img_bgr.astype(np.float32) / 255.0
        input_res = img_bgr.shape

        whole_size, patch_scale = calculateprocessingres(
            img_bgr, RECEPTIVE_FIELD, R_THRESHOLD, SCALE_THRESHOLD,
            WHOLE_SIZE_THRESHOLD)
        # the whole-image pass a /32 multiple for the conv trunk
        whole_size = max(32, (whole_size // 32) * 32)
        self.last_whole_size = whole_size
        self.last_rects = []

        whole_estimate = self._double(img01, whole_size)

        factor = max(min(1.0, 4 * patch_scale * whole_size
                         / WHOLE_SIZE_THRESHOLD), 0.2)

        max_res = self.max_res if self.max_res is not None \
            else max(input_res[0], input_res[1])
        if max_res < whole_size:
            return cv2.resize(whole_estimate,
                              (input_res[1], input_res[0]),
                              interpolation=cv2.INTER_CUBIC)

        # target resolution for patching (depthmap.py:431-439)
        if img_bgr.shape[0] > img_bgr.shape[1]:
            a = 2 * whole_size
            b = round(2 * whole_size * img_bgr.shape[1]
                      / img_bgr.shape[0])
        else:
            a = round(2 * whole_size * img_bgr.shape[0]
                      / img_bgr.shape[1])
            b = 2 * whole_size
        a, b = int(round(a / factor)), int(round(b / factor))

        img_big = cv2.resize(img_bgr, (b, a),
                             interpolation=cv2.INTER_CUBIC)
        patchset = generatepatchs(img_big, RECEPTIVE_FIELD * 2, factor)

        mergein_scale = input_res[0] / img_big.shape[0]
        rgb_scaled = cv2.resize(
            img_big, (round(img_big.shape[1] * mergein_scale),
                      round(img_big.shape[0] * mergein_scale)),
            interpolation=cv2.INTER_CUBIC).astype(np.float32) / 255.0
        updated = cv2.resize(
            whole_estimate, (rgb_scaled.shape[1], rgb_scaled.shape[0]),
            interpolation=cv2.INTER_CUBIC)
        base = updated.copy()

        # ---- the patches' fixed-size inputs (host) --------------------
        rects = []
        p448, p896, base1024 = [], [], []
        for p in patchset:
            rect = np.round(np.array(p['rect']) * mergein_scale
                            ).astype(int)
            x1, y1, w, h = rect
            x2, y2 = x1 + w, y1 + h
            if w <= 0 or h <= 0 or x1 < 0 or y1 < 0 or \
                    x2 > rgb_scaled.shape[1] or y2 > rgb_scaled.shape[0]:
                continue
            patch_rgb = rgb_scaled[y1:y2, x1:x2]
            p448.append(cv2.resize(patch_rgb,
                                   (RECEPTIVE_FIELD, RECEPTIVE_FIELD),
                                   interpolation=cv2.INTER_CUBIC))
            p896.append(cv2.resize(patch_rgb,
                                   (PATCH_NETSIZE, PATCH_NETSIZE),
                                   interpolation=cv2.INTER_CUBIC))
            base1024.append(cv2.resize(base[y1:y2, x1:x2],
                                       (PIX2PIX_SIZE, PIX2PIX_SIZE),
                                       interpolation=cv2.INTER_CUBIC))
            rects.append((int(x1), int(y1), int(x2), int(y2)))
        self.last_rects = rects

        if not rects:
            return cv2.resize(updated, (input_res[1], input_res[0]),
                              interpolation=cv2.INTER_CUBIC)

        merged_all = self._patches(p448, p896, base1024)

        mask_org = _blend_mask()
        mask = mask_org
        # ---- sequential Gaussian blend, biggest patch first -----------
        for (x1, y1, x2, y2), mapped, b1024 in zip(rects, merged_all,
                                                   base1024):
            org_size = (y2 - y1, x2 - x1)
            # deg-1 polyfit match to the base patch (depthmap.py:522-524)
            p_coef = np.polyfit(mapped.reshape(-1), b1024.reshape(-1),
                                deg=1)
            merged = np.polyval(p_coef, mapped.reshape(-1)
                                ).reshape(mapped.shape)
            merged = cv2.resize(merged, (org_size[1], org_size[0]),
                                interpolation=cv2.INTER_CUBIC)
            if mask.shape != org_size:
                mask = cv2.resize(mask_org, (org_size[1], org_size[0]),
                                  interpolation=cv2.INTER_LINEAR)
            updated[y1:y2, x1:x2] = \
                updated[y1:y2, x1:x2] * (1 - mask) + merged * mask

        return cv2.resize(updated, (input_res[1], input_res[0]),
                          interpolation=cv2.INTER_CUBIC)
