#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

1. prints the card, torch and CUDA versions, and builds the 19 CUDA
   kernel libraries (csrc/*.cu, one entry point each) with nvcc, all at
   once;
2. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (576x1024; K1 with C = 4 and C = 68; K6 over
   100 instance slots; K8 over the top 512 boxes; K9 at 100 x 640x640;
   K5a at the path's crop and at a crop kept at its size; K10 with an
   overflow, under the sync debug mode; K15a at SAM ViT-B's windowed
   and global blocks, beside SDPA with the bias prebuilt; K11 on the
   rendered frames at 128 steps; K14a at (1000, 7x7) and (100, 14x14)
   over the 768x1344 canvas's pyramid; K14b at K = 4,756 and 2,048 with
   -inf scores and category offsets; K12a on the image's 576x1024 guide
   and a crop, K12b's norm pass, one step and a whole densecrf_binary at
   576x1024; K15b at SwinV2-B 448's four stage shapes with and without
   the shift mask, beside SDPA) and times both with CUDA events around
   one call on an idle card (median of runs on varied inputs);
3. runs the detector-free clip (``KenBurnsConfig(detector='none')``,
   the path of the first slice), checks the launch counters of the
   kernels it runs and re-renders 3 of its frames on the CPU, where
   every wrapper runs its plain version, against the kernel frames;
4. runs the main path, the shipped default config with the AnimeInsSeg
   detector and its ISNet refine —
   ``KenBurnsPipeline(KenBurnsConfig()).run(img, video)`` on a 576x1024
   image made from the seed, with random nets from the seed set so that
   the instances have edges (``edged_nets``) — and checks that its 12
   kernels launched in that run, that it found instances with
   non-empty masks smaller than the frame, that the adjusted disparity
   is not flat, and that the 75 frames are sane;
5. re-renders 3 frames of that state on the CPU the same way;
6. runs the detector in f32 on the card and on the CPU with the same
   weights on the same image: the head maps within the stated
   tolerance, the CPU postprocess of the card's head maps and the whole
   detector on the CPU against the card's (NMS keep set exact, mask
   pixels >= 99.9%);
7. runs the main path again warm, and profiles 16 frames of the render
   loop (host enqueue time, device busy share, device time by kernel);
8. runs the SAM path, ``configs/3dkenburns_sam.yaml`` with
   ``inpaint_type: default`` (AnimeInsSeg's boxes re-masked by SAM
   ViT-B at 1024, DoF off), with the same edged detector and a seeded
   SAM set so that its masks have edges (``edged_sam``): the launches
   (12 of K15a for the one encode), the instances, the disparity, the
   frames and 3 of them against the CPU;
9. runs SAM in f32 on the card and on the CPU on the same weights,
   image and (at most 8) boxes: the embedding, masks and IoUs within
   the stated tolerances; then ``SamDetector.infer`` →
   ``instances_to_coco`` on the card, whose RLEs must decode to the
   masks exactly;
10. runs the Mask R-CNN path with the exact fill,
   ``KenBurnsConfig(detector='maskrcnn', discfill_mode='exact')``, with
   the seeded Mask R-CNN set so that detections survive
   (``edged_maskrcnn``): K11, K14a and K14b launched and K3 did not,
   the instances, the disparity, the frames and 3 of them against the
   CPU;
11. runs Mask R-CNN in f32 on the card and on the CPU
   (``compare_maskrcnn``: the CPU machinery on the card's outputs exact,
   the whole detector's detections the same set within the stated
   tolerances), then
   ``run_segmentation --detector maskrcnn`` on the card with those
   weights, whose RLEs must decode to the masks exactly;
12. runs the shipped default with the CRF depth refine,
   ``KenBurnsConfig(refine_crf=True)``, with the edged detector: K12a
   and K12b launched (one k-means a segment), the instances, the frames
   and 3 of them against the CPU, then refine_depth_crf on the clip's
   own image, disparity and instances on the card and on the CPU;
13. runs refine_depth_crf on a layered disparity over the image's shapes
   (at least 5 segments reach the CRF), card against CPU;
14. builds the full-width danbooru tagger (SwinV2-B at 448, 9083
   classes, random from the seed), saves it as a timm checkpoint with a
   synthetic tag CSV, loads it through ``AnimeInsSeg.init_tagger`` and
   tags the detector's instances with ``infer_tags`` (24 K15b launches
   an instance), then one crop card against CPU;
15. prints one {"kernels": [...]} line, then the card line and the
   {"ok": true, ...} line last.

Any failed check exits non-zero before the last line. Without CUDA it
exits non-zero at once.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 576, 1024
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth
# and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
RUNS = 10


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f'nvidia-smi failed: {out.stderr.strip()}'


def make_image(seed: int) -> np.ndarray:
    """576x1024 BGR uint8: smooth gradients plus a few shapes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([
        128 + 90 * np.sin(xx / 97 + ph[0]) * np.cos(yy / 61),
        128 + 90 * np.cos(xx / 53 + ph[1]) * np.sin(yy / 43 + ph[2]),
        128 + 90 * np.sin((xx + yy) / 71)], -1)
    for _ in range(6):
        cx, cy = rng.uniform(100, W - 100), rng.uniform(80, H - 80)
        r = rng.uniform(30, 90)
        col = rng.uniform(0, 255, 3)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = col
    x0, y0 = int(rng.uniform(50, W - 300)), int(rng.uniform(50, H - 200))
    img[y0:y0 + 150, x0:x0 + 250] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def time_ms(fn, inputs) -> float:
    """Median CUDA-event time of fn over the varied inputs, after a
    warm-up pass over them. The card idles until the host has enqueued
    fn, so this is the time of one call on an idle card, the host's
    dispatch included (~0.05 ms for a ctypes launch)."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for x in inputs:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(x)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    tb, tf = n_bytes / PEAK_BYTES_S * 1e3, n_flops / PEAK_F32_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def synthetic_cloud(gen: torch.Generator, dev, n_total: int):
    """Grid cloud of a smooth depth map with steps, padded with z = 0
    slots to n_total, as the compacted cloud of the frame loop is."""
    from cartoonsegmentation_torch.ops.pointcloud import depth_to_points
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing='ij')
    depth = 300 + 200 * torch.sin(xx / 150) * torch.cos(yy / 90)
    depth = torch.where((xx - 500) ** 2 + (yy - 300) ** 2 < 150 ** 2,
                        depth * 0.3, depth)
    pts = depth_to_points(depth, 512.0).reshape(-1, 3)
    pts = torch.cat([pts, torch.zeros((n_total - H * W, 3))])
    col = torch.rand((n_total, 3), generator=gen)
    return pts.to(dev), col.to(dev), depth.to(dev)


def check_kernels(dev, gen: torch.Generator) -> dict:
    """Step 2: every kernel against its plain version at the main
    path's shapes. Returns per-kernel results."""
    from cartoonsegmentation_torch.ops import (bokeh, camera, discfill3,
                                               pointcloud)
    from cartoonsegmentation_torch.ops.pointcloud import shift_points
    from cartoonsegmentation_torch.pipeline.depth import colorize_gray_r
    res = {}
    P4 = 11 * (1 << 16)                       # ~ the compacted cloud
    pts, col, depth = synthetic_cloud(gen, dev, P4)
    shifts = [torch.tensor([0.4 * i - 2.0, 0.25 * i - 1.0, 3.0 * i - 15.0],
                           device=dev) for i in range(RUNS)]
    frames_pts = [shift_points(pts, s).contiguous() for s in shifts]
    n_valid = int((frames_pts[0][:, 2] >= 0.001).sum())

    # --- K1 splat, C = 4 (frame loop) and C = 68 (Inpaint) -----------
    for C, pts_in in ((4, frames_pts), (68, [p[:H * W].contiguous()
                                             for p in frames_pts])):
        P = pts_in[0].shape[0]
        data = torch.rand((P, C), generator=gen).to(dev) if C == 68 \
            else torch.cat([col, pts[:, 2:3] / 500.0], 1).contiguous()
        rk, wk, zk = pointcloud.splat(pts_in[0], data, H, W, 512.0, 40.0)
        rp, wp, zp = pointcloud.splat_plain(pts_in[0], data, H, W, 512.0,
                                            40.0)
        torch.cuda.synchronize()
        if not torch.equal(zk, zp):
            fail(f'splat C={C}: z-buffer differs from the plain version '
                 f'at {int((zk != zp).sum())} pixels')
        if not torch.equal(wk > 0, wp > 0):
            fail(f'splat C={C}: w > 0 mask differs at '
                 f'{int(((wk > 0) != (wp > 0)).sum())} pixels')
        # f32 atomics sum in another order than index_add_
        err = max(float((rk - rp).abs().max()), float((wk - wp).abs().max()))
        if not (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5)
                and torch.allclose(wk, wp, rtol=1e-4, atol=1e-5)):
            fail(f'splat C={C}: sums differ by {err}')
        nv = int((pts_in[0][:, 2] >= 0.001).sum())
        nbytes = nv * (12 + 4 * C) + (P - nv) * 4 + H * W * 4 * (C + 2)
        # projection 10, corners 12, per corner (C + 1) mul + add
        flops = nv * (22 + 4 * 2 * (C + 1))
        ms = time_ms(
            lambda x: pointcloud.splat(x, data, H, W, 512.0, 40.0), pts_in)
        plain_ms = time_ms(lambda x: pointcloud.splat_plain(
            x, data, H, W, 512.0, 40.0), pts_in)
        b, by = bound(nbytes, flops)
        res[f'splat_c{C}'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by)
        print(f'[kernel] splat C={C} P={P}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), max err '
              f'{err:.3g}', flush=True)

    # --- K2 coverage: 256 candidates on the stride-2 miniature --------
    mini = pts[:H * W].reshape(H, W, 3)[::2, ::2].reshape(-1, 3).contiguous()
    dr = camera.depth_range(depth)
    lin = [torch.linspace(-100.0 + i, 100.0 - i, 16) for i in range(RUNS)]
    cand = [camera.compute_shift(dr, v.repeat(16).to(dev),
                                 v.repeat_interleave(16).to(dev),
                                 dr.min_val, dr.min_val * 0.8, W, H,
                                 512.0).contiguous() for v in lin]
    ck = pointcloud.coverage(mini, cand[0], H // 2, W // 2, 256.0, 40.0)
    cp = pointcloud.coverage_plain(mini, cand[0], H // 2, W // 2, 256.0,
                                   40.0)
    if not torch.equal(ck, cp):
        fail(f'coverage counts differ at {int((ck != cp).sum())} of 256 '
             f'candidates')
    N, K = mini.shape[0], 256
    nbytes = N * 12 + K * 12 + K * 4
    flops = K * N * 25   # shift 7, projection 8, corners 10
    ms = time_ms(lambda s: pointcloud.coverage(
        mini, s, H // 2, W // 2, 256.0, 40.0), cand)
    plain_ms = time_ms(lambda s: pointcloud.coverage_plain(
        mini, s, H // 2, W // 2, 256.0, 40.0), cand)
    b, by = bound(nbytes, flops)
    res['coverage'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by)
    print(f'[kernel] coverage N={N} K={K}: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), counts exact',
          flush=True)

    # --- K3 fill: real splat renders with disocclusions ---------------
    data4 = torch.cat([col, pts[:, 2:3]], 1).contiguous()
    fills = []
    for p in frames_pts:
        r, w = pointcloud.render_pointcloud(p, data4, H, W, 512.0, 40.0)
        fills.append((r.contiguous(),
                      (r[..., 3] * (w[..., 0] > 0)).contiguous()))
    fk = discfill3.fill_disocclusion(*fills[0])
    fp = discfill3.fill_disocclusion_plain(*fills[0])
    if not torch.equal(fk, fp):
        fail(f'fill differs at {int((fk != fp).any(-1).sum())} pixels')
    nbytes = H * W * (4 * 4 + 4 + 4 * 4)
    ms = time_ms(lambda x: discfill3.fill_disocclusion(*x), fills)
    plain_ms = time_ms(lambda x: discfill3.fill_disocclusion_plain(*x),
                       fills)
    b, by = bound(nbytes, 0)
    holes = float((fills[0][1] <= 0).float().mean())
    res['discfill'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by)
    print(f'[kernel] discfill {H}x{W} ({holes:.3%} holes): kernel '
          f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), '
          f'bit-exact', flush=True)

    # --- K11 exact fill: the same renders, the ray march of 128 steps --
    from cartoonsegmentation_torch.ops import discfill
    fk = discfill.fill_disocclusion(*fills[0], 128)
    fp = discfill.fill_disocclusion_plain(*fills[0], 128)
    if not torch.equal(fk, fp):
        fail(f'exact fill differs at {int((fk != fp).any(-1).sum())} pixels')
    ms = time_ms(lambda x: discfill.fill_disocclusion(*x, 128), fills)
    plain_ms = time_ms(lambda x: discfill.fill_disocclusion_plain(*x, 128),
                       fills[:3])
    b, by = bound(nbytes, 0)
    res['discfill_exact'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b, bound_by=by)
    print(f'[kernel] discfill_exact {H}x{W} ({holes:.3%} holes, 128 steps): '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms '
          f'({by}), bit-exact', flush=True)

    # --- K4 bokeh: filled frames, weights from their depth ------------
    bok = []
    for i, (r, _) in enumerate(fills):
        f = discfill3.fill_disocclusion(r, fills[i][1])
        wgt = bokeh.bokeh_weight_field(colorize_gray_r(f[..., 3]), 1,
                                       focal_plane=25.0 * i)
        bok.append((f[..., :3].clamp(0, 1).contiguous(), wgt.contiguous()))
    bk = bokeh.bokeh_core(*bok[0], 13.0, 32)
    bp = bokeh.bokeh_core_plain(*bok[0], 13.0, 32)
    err = float((bk - bp).abs().max())
    # same sample sets; sums in another order (sequential vs tree)
    if not torch.allclose(bk, bp, rtol=0, atol=1e-4):
        fail(f'bokeh differs by {err}')
    nbytes = H * W * (12 + 4 + 12)
    # per pixel and pass: 32 samples x (2 mul, 2 rounds of 3, 7
    # accumulate) = 480, plus 6 pows (~20 each) and the divides
    flops = H * W * (3 * 480 + 6 * 20 + 12)
    ms = time_ms(lambda x: bokeh.bokeh_core(*x, 13.0, 32), bok)
    plain_ms = time_ms(lambda x: bokeh.bokeh_core_plain(*x, 13.0, 32), bok)
    b, by = bound(nbytes, flops)
    res['bokeh'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b, bound_by=by)
    print(f'[kernel] bokeh {H}x{W}: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), max err {err:.3g}',
          flush=True)

    filled = [discfill3.fill_disocclusion(*f) for f in fills]
    depth_maps = [colorize_gray_r(f[..., 3]) for f in filled]
    existing = [(w > 0).float()[..., None].contiguous()
                for _, w in fills]
    res.update(check_detector_kernels(dev, gen, depth_maps, existing))
    res.update(check_frame_kernels(dev, filled))
    res.update(check_samattn(dev, gen))
    res.update(check_maskrcnn_kernels(dev, gen))
    return res


# the 768x1344 canvas of a 576x1024 image (min side 800, max side 1333):
# P2..P5
CANVAS_LEVELS = ((192, 336), (96, 168), (48, 84), (24, 42))


def rpn_like_boxes(gen: torch.Generator, n: int) -> torch.Tensor:
    """n boxes over the 750x1333 image inside the canvas, of sides 8 to
    700 px (every pyramid level), some across the border."""
    c = torch.rand((n, 2), generator=gen) * torch.tensor([1333.0, 750.0])
    side = 8.0 * torch.exp(torch.rand((n, 2), generator=gen) * 4.5)
    return torch.cat([c - side / 2, c + side / 2], 1)


def check_maskrcnn_kernels(dev, gen) -> dict:
    """K14a RoIAlign at the box head's (1000, 7x7) and the mask head's
    (100, 14x14) over the 768x1344 pyramid; K14b NMS at the RPN's
    K = 4,756 (IoU 0.7, 1000 out, level offsets) and the detection's
    K = 2,048 (IoU 0.5, 100 out, class offsets), -inf scores present."""
    from cartoonsegmentation_torch.models import maskrcnn, rtmdet
    res = {}
    C = 256
    rows = sum(h * w for h, w in CANVAS_LEVELS)
    pyrs = [maskrcnn.flatten_pyramid([
        torch.randn((1, C, h, w), generator=gen).to(dev)
        for h, w in CANVAS_LEVELS]) for _ in range(3)]
    for n, out in ((1000, 7), (100, 14)):
        cases = [(p, rpn_like_boxes(gen, n).to(dev)) for p in pyrs]
        got = maskrcnn.roi_align_pyramid(*cases[0], out)
        want = maskrcnn.roi_align_pyramid_plain(
            *cases[0], maskrcnn.roi_levels(cases[0][1]), out)
        err = float((got - want).abs().max())
        span = float(want.max() - want.min())
        if err > 1e-5 * span:
            fail(f'roialign ({n}, {out}): max err {err:.3g} above 1e-5 of '
                 f'{span:.3g}')
        ms = time_ms(lambda c: maskrcnn.roi_align_pyramid(*c, out), cases)
        plain_ms = time_ms(lambda c: maskrcnn.roi_align_pyramid_plain(
            *c, maskrcnn.roi_levels(c[1]), out), cases)
        # the pyramid read once, the (n, C, out, out) output written once;
        # per output value 4 samples of 4 taps (a multiply-add each) and
        # their 4 weights
        nbytes = rows * C * 4 + n * 16 + n * C * out * out * 4
        b, by = bound(nbytes, n * C * out * out * 4 * 12)
        res[f'roialign_{out}'] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=b,
                                      bound_by=by)
        print(f'[kernel] roialign ({n}, {C}, {out}, {out}) over {rows} '
              f'pyramid rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'bound {b:.4f} ms ({by}), max err {err:.3g} of {span:.3g}',
              flush=True)

    sizes = (1000, 1000, 1000, 1000, 756)
    for K, thr, n_out, tag in ((4756, 0.7, 1000, 'rpn'),
                               (2048, 0.5, 100, 'det')):
        cases = []
        for _ in range(RUNS):
            boxes, scores = nms_case(gen, K)
            boxes = boxes * 2.0
            scores[torch.rand((K,), generator=gen) < 0.1] = -float('inf')
            cats = torch.cat([torch.full((k,), i, dtype=torch.int32)
                              for i, k in enumerate(sizes)]) \
                if tag == 'rpn' else torch.randint(1, 91, (K,),
                                                   generator=gen,
                                                   dtype=torch.int32)
            cases.append(tuple(t.to(dev) for t in (boxes, scores, cats)))

        def plain(c):
            extent = c[0].max() + 1.0
            return rtmdet.nms_fixed_plain(
                c[0] + (c[2].float() * extent)[:, None], c[1], thr, n_out)
        kept = []
        for c in cases[:3]:
            ki, km = maskrcnn.batched_nms_fixed(*c, thr, n_out)
            pi, pm = plain(c)
            if not (torch.equal(ki, pi) and torch.equal(km, pm)):
                fail(f'nms_large K={K}: keep set differs from the plain '
                     f'version')
            kept.append(int(km.sum()))
        ms = time_ms(lambda c: maskrcnn.batched_nms_fixed(*c, thr, n_out),
                     cases)
        plain_ms = time_ms(plain, cases[:3])
        # the IoUs of the upper triangle, ~12 operations each
        b, by = bound(K * 20 + n_out * 9, K * (K - 1) / 2 * 12)
        res[f'nms_large_{tag}'] = dict(max_abs_err=0.0, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b,
                                       bound_by=by)
        print(f'[kernel] nms_large K={K} IoU {thr} {n_out} out (kept: '
              f'{kept}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{b:.6f} ms ({by}), keep sets exact', flush=True)
    return res


def check_frame_kernels(dev, filled) -> dict:
    """K5a epilogue, K5b colorize and K10 compaction against their
    plain versions on the filled frames of the render loop."""
    from cartoonsegmentation_torch.pipeline import depth, state
    from cartoonsegmentation_torch.utils import image
    res = {}
    u8 = torch.uint8

    # --- K5a: the path's crop (crop_ratio 0.97: 558x993 at 576x1024,
    # half-pixel rows) resized to the frame, and a crop at a half-pixel
    # corner kept at its size (556x992) ---------------------------------
    ch, cw = int(0.97 * H), int(0.97 * W)
    worst, maxd = 1.0, 0
    kept = (H - 20, W - 32)
    for crop, out in (((ch, cw), (H, W)), (kept, kept)):
        for f in filled[:3]:
            bgr = torch.empty((*out, 3), dtype=u8, device=dev)
            i420 = torch.empty((out[0] * 3 // 2, out[1]), dtype=u8,
                               device=dev)
            got = image.frame_epilogue(f[..., :3], *crop, *out, bgr, i420)
            want = image.frame_epilogue_plain(f[..., :3], *crop, *out)
            d = (got.int() - want.int()).abs()
            maxd = max(maxd, int(d.max()))
            worst = min(worst, float((d == 0).float().mean()))
            if not torch.equal(i420, image.bgr_to_i420(got[None])[0]):
                fail('epilogue: I420 bytes differ from bgr_to_i420 of the '
                     'kernel BGR')
    # the bilinear sum may sit an ulp from torch's FMA-contracted kernel
    if maxd > 1 or worst < 0.9999:
        fail(f'epilogue: BGR max diff {maxd}, equal share {worst:.6f}')
    bgr = torch.empty((H, W, 3), dtype=u8, device=dev)
    i420 = torch.empty((H * 3 // 2, W), dtype=u8, device=dev)
    ms = time_ms(lambda f: image.frame_epilogue(f[..., :3], ch, cw, H, W,
                                                bgr, i420), filled)
    plain_ms = time_ms(lambda f: image.bgr_to_i420(image.frame_epilogue_plain(
        f[..., :3], ch, cw, H, W)[None]), filled)
    # read the frame's colours once, write BGR and I420 once; per output
    # value ~42 operations (4 taps of 2 clipped reads and a mean, the
    # bilinear sum, the uint8 step), ~16 a pixel for weights and Y
    b, by = bound(H * W * (12 + 3 + 1.5), H * W * (3 * 42 + 16))
    res['epilogue'] = dict(max_abs_err=float(maxd), ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, bgr_equal=worst)
    print(f'[kernel] epilogue {H}x{W} crop {ch}x{cw}: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}); BGR max diff '
          f'{maxd}, equal {worst:.6f}; I420 exact', flush=True)

    # --- K5b: the depth channel of the filled frames, read in place ----
    maps = [f[..., 3] for f in filled]
    for x in maps[:3]:
        if not torch.equal(depth.colorize_gray_r(x),
                           depth.colorize_gray_r_plain(x)):
            fail('colorize differs from the plain version')
    ms = time_ms(depth.colorize_gray_r, maps)
    plain_ms = time_ms(depth.colorize_gray_r_plain, maps)
    b, by = bound(H * W * 8, H * W * 6)   # min, max; sub, div, sub, mul
    res['colorize'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by)
    print(f'[kernel] colorize {H}x{W}: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), exact', flush=True)

    # --- K10: the state's appends at M = H*W: all set, then hole-like
    # masks; a second cloud overflows on its second append -------------
    M = H * W
    g = torch.Generator(device=dev).manual_seed(1)
    src = [torch.rand((M, 3), device=dev, generator=g),
           torch.rand((M, 3), device=dev, generator=g),
           torch.rand((M,), device=dev, generator=g),
           torch.rand((M,), device=dev, generator=g)]
    masks = [torch.ones((M,), dtype=torch.bool, device=dev),
             torch.rand((M,), device=dev, generator=g) < 0.3,
             torch.rand((M,), device=dev, generator=g) < 0.6]
    for P in (2 * M, M + 100000):
        kern = state.PointCloud.with_capacity(P, dev)
        plain = state.PointCloud.with_capacity(P, dev)
        for m in masks:
            torch.cuda.set_sync_debug_mode('error')
            try:
                kern = kern.append_masked(*src, m)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            state.append_masked_plain(plain, *src, m)
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            if not torch.equal(getattr(kern, k), getattr(plain, k)):
                fail(f'compact: {k} differs from the plain version '
                     f'(capacity {P})')
    clouds = [state.PointCloud.with_capacity(2 * M, dev) for _ in range(RUNS)]
    ms = time_ms(lambda c: state.append_masked_into(c, *src, masks[0]),
                 clouds)
    clouds = [state.PointCloud.with_capacity(2 * M, dev) for _ in range(RUNS)]
    plain_ms = time_ms(lambda c: state.append_masked_plain(c, *src, masks[0]),
                       clouds)
    del clouds
    # the mask byte of every entry; 8 payload floats of each set entry
    # read and written once
    b, by = bound(M + M * 64, 0)
    res['compact'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by)
    print(f'[kernel] compact M={M} (all set) into 2M slots: kernel '
          f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}); '
          f'exact with an overflow, no host sync', flush=True)
    return res


def check_samattn(dev, gen) -> dict:
    """K15a at SAM ViT-B 1024's shapes: the windowed blocks (25 windows
    of 14x14, padded from 64) and the global ones (64x64), 12 heads of
    64, random q, k, v and rel-pos tables; against the plain version
    and beside SDPA with the (B, n, N, N) bias prebuilt."""
    import torch.nn.functional as F
    from cartoonsegmentation_torch.models import sam
    res = {}
    g = torch.Generator(device=dev).manual_seed(int(torch.randint(
        0, 1 << 30, (1,), generator=gen)))
    n, hd = 12, 64
    # (tag, windows, side): 25 windows of 14x14 (the 64x64 grid padded
    # to 70) and the whole grid
    for tag, B, side in (('windowed', 25, 14), ('global', 1, 64)):
        N = side * side
        cases = []
        for _ in range(RUNS):
            qkv = torch.randn((B, N, 3, n, hd), device=dev, generator=g)
            rel = torch.randn((2, 2 * side - 1, hd), device=dev,
                              generator=g) * 0.1
            bh, bw = sam.rel_pos_terms(qkv, rel[0], rel[1], side, side)
            cases.append((qkv, bh.contiguous(), bw.contiguous()))
        got = sam.rel_pos_attention(*cases[0], side, side)
        want = sam.rel_pos_attention_plain(*cases[0], side, side)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if err > 1e-5 * scale:
            fail(f'samattn {tag}: max err {err:.3g} above 1e-5 of '
                 f'{scale:.3g}')
        ms = time_ms(lambda c: sam.rel_pos_attention(*c, side, side), cases)
        plain_ms = time_ms(lambda c: sam.rel_pos_attention_plain(
            *c, side, side), cases)

        # one PyTorch call for the same function: SDPA with the bias
        # prebuilt; the bias build is timed on its own
        def bias(c):
            return (c[1][..., :, None] + c[2][..., None, :]).reshape(
                B, n, N, N)

        def heads(c):
            return [c[0][:, :, j].transpose(1, 2) for j in range(3)]
        mask_ms = time_ms(bias, cases[:3])
        lib_cases = [(heads(c), bias(c)) for c in cases[:3]]
        lib = F.scaled_dot_product_attention(*lib_cases[0][0],
                                             attn_mask=lib_cases[0][1])
        lib_err = float((lib.transpose(1, 2).reshape(B, N, n * hd)
                         - want).abs().max())
        lib_ms = time_ms(lambda c: F.scaled_dot_product_attention(
            *c[0], attn_mask=c[1]), lib_cases)
        del lib_cases, lib
        # q·k and p·v (2 operations a multiply-add), the two bias adds
        # and ~4 of the online softmax a score
        flops = B * n * N * N * (4 * hd + 6)
        nbytes = 4 * (B * N * 3 * n * hd + B * n * N * 2 * side
                      + B * N * n * hd)
        b, by = bound(nbytes, flops)
        res[f'samattn_{tag}'] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b,
                                     bound_by=by, library_ms=lib_ms)
        print(f'[kernel] samattn {tag} B={B} N={N} 12x64: kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), SDPA '
              f'{lib_ms:.4f} ms (+ {mask_ms:.4f} ms to build the bias, max '
              f'err {lib_err:.3g}); max err {err:.3g} of {scale:.3g}',
              flush=True)
        del cases
    return res


def instance_masks(gen: torch.Generator, dev, n: int, n_valid: int):
    """n ellipse masks at 576x1024 (n_valid valid; the invalid slots get
    masks too, which must not count)."""
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    p = torch.rand((n, 4), generator=gen).to(dev)
    cx, cy = p[:, 0, None, None] * W, p[:, 1, None, None] * H
    rx, ry = 20 + p[:, 2, None, None] * 400, 20 + p[:, 3, None, None] * 250
    masks = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
    valid = torch.arange(n, device=dev) < n_valid
    return masks.contiguous(), valid


def nms_case(gen: torch.Generator, K: int = 512):
    """Top-512-like candidates: clusters of heavily overlapping boxes,
    exact duplicates, bf16-valued (tied) scores."""
    centres = torch.rand((K // 8, 2), generator=gen) * 600
    pick = torch.randint(0, K // 8, (K,), generator=gen)
    c = centres[pick] + torch.randn((K, 2), generator=gen) * 4
    wh = 10 + torch.rand((K, 2), generator=gen) * 60
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1)
    boxes[K // 2:K // 2 + 5] = boxes[K // 2]
    scores = torch.rand((K,), generator=gen).bfloat16().float()
    return boxes, scores


def check_detector_kernels(dev, gen, depth_maps, existing) -> dict:
    """K6-K9 against their plain versions at the main path's shapes."""
    from cartoonsegmentation_torch.models import rtmdet
    from cartoonsegmentation_torch.ops import filters
    from cartoonsegmentation_torch.pipeline import depth
    res = {}

    # --- K6: 100 instance slots, 60 valid (one of them empty) ---------
    masks, valid = instance_masks(gen, dev, 100, 60)
    masks[3] = False
    got = depth.masked_median_u8(depth_maps[0], masks, valid)
    want = depth.masked_median_u8_plain(depth_maps[0], masks, valid)
    if not torch.equal(got, want):
        fail(f'masked median differs at {int((got != want).sum())} of 100 '
             f'instances')
    n_valid = int(valid.sum())
    nbytes = H * W * 4 + n_valid * H * W + 100 + 100 * 4
    ms = time_ms(
        lambda v: depth.masked_median_u8(v, masks, valid), depth_maps)
    plain_ms = time_ms(
        lambda v: depth.masked_median_u8_plain(v, masks, valid), depth_maps)
    b, by = bound(nbytes, n_valid * H * W * 3)   # round, clamp, count
    res['insmedian'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            bound_ms=b, bound_by=by)
    print(f'[kernel] insmedian 100 slots ({n_valid} valid) at {H}x{W}: '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms '
          f'({by}), exact', flush=True)

    # --- K7: the median-5 of `existing`, the laplacian of a disparity --
    disp = [(d / 255.0)[..., None].contiguous() for d in depth_maps]
    for x in existing[:2] + disp[:2]:
        if not torch.equal(filters.median_filter(x, 5),
                           filters.median_filter_plain(x, 5)):
            fail('median-5 differs from the plain version')
        if not torch.equal(filters.laplacian_filter(x),
                           filters.laplacian_filter_plain(x)):
            fail('laplacian differs from the plain version')
    # the median of 25 needs 99 compare-exchanges (a selection network:
    # Paeth's, as in Devillard's opt_med25), a min and a max each; the
    # kernel's full sort does 300. The laplacian: 1 multiply, 4 subtracts
    for name, fn, plain, xs, ops in (
            ('median5', lambda x: filters.median_filter(x, 5),
             lambda x: filters.median_filter_plain(x, 5), existing, 99 * 2),
            ('laplacian', filters.laplacian_filter,
             filters.laplacian_filter_plain, disp, 5)):
        b, by = bound(H * W * 8, H * W * ops)
        ms, plain_ms = time_ms(fn, xs), time_ms(plain, xs)
        res[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by)
        print(f'[kernel] {name} {H}x{W}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), exact',
              flush=True)
    # the laplacian as one library call: a cuDNN convolution with
    # replicate padding, f32 without TF32
    conv = torch.nn.Conv2d(1, 1, 3, padding=1, padding_mode='replicate',
                           bias=False).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        conv.weight.copy_(torch.tensor([[0.0, -1.0, -1.0], [-1.0, 4.0, 0.0],
                                        [-1.0, 0.0, 0.0]]))
        lib_err = float((conv(disp[0].view(1, 1, H, W)).view(H, W, 1)
                         - filters.laplacian_filter_plain(disp[0]))
                        .abs().max())
        res['laplacian']['library_ms'] = time_ms(
            lambda x: conv(x.view(1, 1, H, W)), disp)
    print(f'[kernel] laplacian as a cuDNN convolution: '
          f'{res["laplacian"]["library_ms"]:.4f} ms, max err {lib_err:.3g}',
          flush=True)

    # --- K8: the top 512 candidates, ties and overlaps -----------------
    cases = [tuple(t.to(dev) for t in nms_case(gen)) for _ in range(RUNS)]
    kept = []
    for bx, sc in cases[:3]:
        for max_out in (100, 512):
            ki, km = rtmdet.nms_fixed(bx, sc, 0.6, max_out)
            pi, pm = rtmdet.nms_fixed_plain(bx, sc, 0.6, max_out)
            if not (torch.equal(ki, pi) and torch.equal(km, pm)):
                fail('NMS keep set differs from the plain version')
        kept.append(int(km.sum()))
    ms = time_ms(lambda c: rtmdet.nms_fixed(*c, 0.6, 100), cases)
    plain_ms = time_ms(lambda c: rtmdet.nms_fixed_plain(*c, 0.6, 100), cases)
    # the IoUs of the upper triangle, ~12 operations each
    b, by = bound(512 * 20 + 100 * 9, 512 * 511 / 2 * 12)
    res['nms'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=b, bound_by=by)
    print(f'[kernel] nms K=512 (kept of 512: {kept}): kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by}), keep sets '
          f'exact', flush=True)

    # --- K9: 100 instances, 80x80 prototypes → 640x640 masks -----------
    N, h = 100, 80

    def heads_case():
        feat = torch.randn((h, h, 8), generator=gen)
        kern = torch.randn((N, 169), generator=gen)
        pri = torch.randint(0, h, (N, 2), generator=gen).float() * 8
        st = torch.tensor([8.0, 16.0, 32.0])[
            torch.randint(0, 3, (N,), generator=gen)]
        val = torch.rand((N,), generator=gen) < 0.8
        return tuple(t.to(dev) for t in (feat, kern, pri, st, val))
    heads = [heads_case() for _ in range(RUNS)]
    mk, pk = rtmdet.dynamic_masks(*heads[0], 640, 640, 0.3)
    mp, pp = rtmdet.dynamic_masks_plain(*heads[0], 640, 640, 0.3)
    err = float((pk - pp).abs().max())
    same = float((mk == mp).float().mean())
    if err > 1e-6 or same < 0.9999:
        fail(f'mask heads: probs differ by {err}, masks agree on {same}')
    ms = time_ms(lambda x: rtmdet.dynamic_masks(*x, 640, 640, 0.3), heads)
    plain_ms = time_ms(lambda x: rtmdet.dynamic_masks_plain(*x, 640, 640,
                                                            0.3), heads)
    nbytes = h * h * 8 * 4 + N * (169 + 2 + 1) * 4 + N + N * 640 * 640
    flops = N * h * h * 2 * (10 * 8 + 8 * 8 + 8 + 20) + N * 640 * 640 * 12
    b, by = bound(nbytes, flops)
    res['maskhead'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, masks_equal=same)
    print(f'[kernel] maskhead N={N} {h}x{h} → 640x640: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), probs max err '
          f'{err:.3g}, masks equal {same:.6f}', flush=True)
    return res


def profile_frame_loop(pipe, state, obj_from, obj_to, n: int = 16) -> None:
    """n frames of the render loop: host enqueue time against the time
    to the device's last result, then a torch.profiler pass for the
    device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    steps = list(np.linspace(0.0, 1.0, n))
    pipe.render_frames(state, obj_from, obj_to, steps[:2],
                       return_device=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.render_frames(state, obj_from, obj_to, steps, return_device=True)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f'[loop] {n} frames: {1e3 * total / n:.3f} ms/frame, host '
          f'enqueue {1e3 * enqueue / n:.3f} ms/frame', flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.render_frames(state, obj_from, obj_to, steps,
                           return_device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_time_report(prof, wall, n, 'frame', '[loop]')


def device_time_report(prof, wall: float, n: int, unit: str, tag: str,
                       top: int = 15) -> None:
    """From a torch.profiler pass over n units of work that took wall
    seconds: the device's busy time and share, and the device time by
    kernel per unit. Only the device's own events (kernels, copies,
    fills) count: an aten op's self device time is its kernels' time,
    which the kernels' rows hold already."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if not rows:
        print(f'{tag} the profiler recorded no device time: busy share '
              'not measured', flush=True)
        return
    busy = sum(r[0] for r in rows) / 1e6
    print(f'{tag} profiled {n} {unit}s: wall {1e3 * wall / n:.3f} ms/{unit}, '
          f'device busy {1e3 * busy / n:.3f} ms/{unit} ({busy / wall:.1%}), '
          f'device idle {1e3 * (wall - busy) / n:.3f} ms/{unit}; by '
          'kernel:', flush=True)
    for us, count, key in sorted(rows, reverse=True)[:top]:
        print(f'  {us / 1e3 / n:9.4f} ms/{unit}  {count // n:4d}/{unit}  '
              f'{key[:90]}', flush=True)


def profile_tagger_crop(tagger, crop: np.ndarray, n: int = 4) -> None:
    """n calls of ``label_cv2_bgr`` on one instance's crop, as
    ``infer_tags`` makes them: the host's preprocessing alone, then a
    torch.profiler pass for the device's busy time by kernel against
    the wall time an instance."""
    from torch.profiler import ProfilerActivity, profile
    tagger.label_cv2_bgr(crop)
    t0 = time.perf_counter()
    for _ in range(n):
        tagger._prep(crop)
    prep = (time.perf_counter() - t0) / n
    print(f'[tagger] host preprocessing (make_square + smart_resize of a '
          f'{crop.shape[0]}x{crop.shape[1]} crop): {1e3 * prep:.3f} ms an '
          'instance', flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tagger.label_cv2_bgr(crop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_time_report(prof, wall, n, 'instance', '[tagger]', top=10)


def run_clip(pipe, img, tag: str):
    """pipe.run(img, video) with the launch counters set to 0 just
    before and read just after; checks the frames. Returns the launches."""
    from cartoonsegmentation_torch.ops import _cuda
    tmp = tempfile.mkdtemp(prefix='smoke_', dir=str(_cuda.BUILD_DIR))
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        frames = pipe.run(img, os.path.join(tmp, 'smoke.mp4'))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        size = os.path.getsize(pipe.last_video_path)
        kind = 'raw I420 (cv2 is missing)' \
            if pipe.last_video_path.endswith('.yuv') else 'mp4'
        print(f'[{tag}] video: {size} bytes, {kind}', flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if frames.shape != (pipe.cfg.num_frame, H, W, 3) or \
            frames.dtype != np.uint8:
        fail(f'{tag}: frames are {frames.shape} {frames.dtype}')
    if frames.std() < 5 or not 5 < frames.mean() < 250:
        fail(f'{tag}: frames look blank (mean {frames.mean():.1f}, std '
             f'{frames.std():.1f})')
    render_s = pipe.timer.seconds['render_stream+encode']
    print(f'{pipe.timer.report()}\n[{tag}] {len(frames)} frames in '
          f'{wall:.3f} s (render+stream+encode {render_s:.3f} s, '
          f'{len(frames) / render_s:.2f} fps); launches {launches}',
          flush=True)
    return launches


def compare_frames(pipe, tag: str) -> None:
    """Re-render 3 frames of the pipeline's last state on the CPU, where
    every wrapper runs its plain version; fail below 99.5% of values
    within 1 LSB of the kernel frames."""
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    state = pipe.last_state
    obj_from, obj_to = pipe.last_boxes
    steps = [0.0, 0.5, 1.0]
    fk = pipe.render_frames(state, obj_from, obj_to, steps)
    cpu = KenBurnsPipeline(pipe.cfg, device='cpu')
    t0 = time.perf_counter()
    fp = cpu.render_frames(state.to('cpu'), obj_from, obj_to, steps)
    diff = np.abs(fk.astype(np.int32) - fp.astype(np.int32))
    close = float((diff <= 1).mean())
    print(f'[{tag}] frames, kernel vs plain (CPU, '
          f'{time.perf_counter() - t0:.1f} s): {close:.5f} of values within '
          f'1 LSB, max diff {int(diff.max())}, mean {diff.mean():.4f}',
          flush=True)
    if close < 0.995:
        fail(f'{tag}: only {close:.4f} of frame values within 1 LSB of the '
             f'plain versions')


def require_launches(tag, launches, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    if missing:
        fail(f'{tag}: kernels not launched: {missing}')


def edged_nets(seed: int):
    """The detector and refine nets that ``AnimeInsSeg(seed=seed)``
    makes (random from the seed), with three small parts set so that the
    instances have edges. Random weights alone put every mask over the
    whole frame: the mask head's and the refine's logits sit near 0, and
    sigmoid(0) = 0.5 > mask_thr 0.3. Here
    - each level's dynamic-kernel conv (``rtm_kernel``) emits, at every
      prior, the parameters of a mask MLP whose logit is
      2 - 8 (|rx| + |ry|) in the relative coords: a diamond around the
      prior, 0.36 * 8 * stride pixels in radius at det_size;
    - one channel of the ISNet carries the coarse mask m from the input
      to side 1 (conv_in and the input convs of stage1 and stage1d copy
      it; their last decoder convs add 0 to it), and side 1 reads
      20 m - 10, so the refine keeps the coarse mask where m > 0.46.
    Every other weight stays random, and every conv runs at full width.
    Returns (AnimeDetector, ISNetDIS), f32 on the CPU."""
    from cartoonsegmentation_torch.models.isnet import ISNetDIS
    from cartoonsegmentation_torch.models.rtmdet import AnimeDetector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        det = AnimeDetector()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        isnet = ISNetDIS(in_ch=4)
    # the 169 dynamic params: weights (8, 10), (8, 8), (1, 8) row-major,
    # then biases 8, 8, 1; inputs rx, ry, then the 8 prototypes
    w1, w2, w3 = torch.zeros(8, 10), torch.zeros(8, 8), torch.zeros(1, 8)
    w1[0, 0], w1[1, 0], w1[2, 1], w1[3, 1] = 1.0, -1.0, 1.0, -1.0
    w2[:4, :4] = torch.eye(4)
    w3[0, :4] = -8.0
    params = torch.cat([w1.flatten(), w2.flatten(), w3.flatten(),
                        torch.zeros(16), torch.tensor([2.0])])
    with torch.no_grad():
        for conv in det.bbox_head.rtm_kernel:
            conv.weight.zero_()
            conv.bias.copy_(params)
        conv = isnet.conv_in
        conv.weight[0] = 0.0
        conv.weight[0, 3, 1, 1] = 1.0
        conv.bias[0] = 0.0
        # stage1d's input is cat(up(hx2d), hx1): hx1's channel 0 is 64
        for stage, ch in ((isnet.stage1, 0), (isnet.stage1d, 64)):
            conv = stage.rebnconvin.conv_s1
            conv.weight[0] = 0.0
            conv.weight[0, ch, 1, 1] = 1.0
            conv.bias[0] = 0.0
            conv = stage.rebnconv1d.conv_s1
            conv.weight[0] = 0.0
            conv.bias[0] = 0.0
        isnet.side1.weight.zero_()
        isnet.side1.weight[0, 0, 1, 1] = 20.0
        isnet.side1.bias.fill_(-10.0)
    return det, isnet


def edged_sam(seed: int, img: np.ndarray, share: float = 0.2):
    """SAM ViT-B at 1024 as ``NativeSAM(seed=seed)`` makes it (random
    from the seed), with two small parts of its mask decoder set so that
    its masks have edges. Random weights alone give each box a mask
    whose logits are one random mix of the upscaled features, so the
    mask covers nearly all or nearly none of the frame. Here
    - the second upscaling deconv (``output_upscaling.3``) emits
      gelu(1) on channel 0 and copies its input channel 0 to channel 1;
    - the last layer of each hypernetwork MLP emits (-tau / gelu(1), 1,
      0, ...) for every box, so the logit is that copied channel less
      tau;
    - tau is the (1 - share) quantile of that channel over the image's
      letterbox, from one probe decode of the same SAM on ``img``, so
      each mask covers ~share of the frame along the edges of one
      feature of the seeded encoder.
    Every other weight stays random; the encoder, the prompt encoder
    and the two-way transformer run unchanged at full width. Returns the
    SAM on the card."""
    import torch.nn.functional as F
    from cartoonsegmentation_torch.models.sam import init_sam_, sam_vit_b
    from cartoonsegmentation_torch.pipeline.sam import (NativeSAM,
                                                        normalize_pad)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = init_sam_(sam_vit_b())
    dec = net.mask_decoder
    with torch.no_grad():
        up = dec.output_upscaling[3]
        up.weight[:, :2] = 0.0
        up.weight[0, 1] = 1.0
        up.bias[:2] = torch.tensor([1.0, 0.0])
        for mlp in dec.output_hypernetworks_mlps:
            mlp.layers[2].weight.zero_()
            mlp.layers[2].bias.zero_()
            mlp.layers[2].bias[1] = 1.0
    probe = NativeSAM(capacity=1, model=net, device='cuda')
    net = probe._net()
    canvas, _, nh, nw = probe._prepare(img)
    with torch.inference_mode():
        x = normalize_pad(torch.from_numpy(canvas).cuda(), (nh, nw))
        emb = net.encode(x[None])[0]
        box = torch.tensor([[0.0, 0.0, nw - 1.0, nh - 1.0]], device='cuda')
        logits, _ = net.decode(emb, box, multimask=False)
    crop = logits[0, :-(-nh // 4), :-(-nw // 4)].flatten()
    tau = float(torch.quantile(crop, 1.0 - share))
    with torch.no_grad():
        g1 = float(F.gelu(torch.tensor(1.0)))
        for mlp in dec.output_hypernetworks_mlps:
            mlp.layers[2].bias[0] = -tau / g1
    print(f'[sam] edged_sam: tau {tau:.4f} (the {1 - share:.0%} quantile of '
          f'the copied channel, range {float(crop.min()):.4f} .. '
          f'{float(crop.max()):.4f})', flush=True)
    return net


EDGED_CLASS = 1


def edged_maskrcnn(seed: int, img: np.ndarray, top: float = 0.03):
    """Mask R-CNN as ``MaskRCNNDetector(seed=seed)`` makes it (random
    from the seed), with one row of its class scores set so that
    detections survive. Random weights give every class a softmax near
    1/91, under the 0.05 box and 0.3 score thresholds, and class logits
    that hardly vary between proposals (std ~0.004), so the scores of
    all proposals sit within ~1e-3 of each other and their order is
    decided by f32 noise. Here class 1's ``cls_score`` row is scaled so
    that its logit's spread over the image's valid proposals (from one
    probe pass of the same net) is 2, and its bias set so that the top
    ``top`` share of them score above 0.5. Every other weight stays
    random and every layer runs at full width. Returns the net on the
    card."""
    from cartoonsegmentation_torch.models import maskrcnn
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import (
        MaskRCNNDetector, normalize_pad)
    probe = MaskRCNNDetector(seed=seed, device='cuda')
    net = probe._net()
    head = net.roi_heads.box_predictor.cls_score
    canvas, _, (nh, nw) = probe.canvas(img)
    with torch.no_grad():
        x = normalize_pad(torch.from_numpy(canvas).cuda(), (nh, nw))
        feats = net.features(x.permute(2, 0, 1)[None].contiguous())
        props, ps = net.propose(feats, float(nh), float(nw))
        pyr = maskrcnn.flatten_pyramid(feats[:4])
        cls, _ = net.box_outputs(maskrcnn.roi_align_pyramid(pyr, props, 7))
        logits = cls[ps > -float('inf')].double().cpu()
    z = logits[:, EDGED_CLASS] - float(head.bias.detach()[EDGED_CLASS])
    others = torch.cat([logits[:, :EDGED_CLASS], logits[:, EDGED_CLASS + 1:]],
                       1)
    k = 2.0 / float(z.std())
    margin = k * z - torch.logsumexp(others, 1)
    bias = -float(torch.quantile(margin, 1.0 - top))
    p = torch.sigmoid(margin + bias)
    with torch.no_grad():
        head.weight[EDGED_CLASS] *= k
        head.bias[EDGED_CLASS] = bias
    print(f'[maskrcnn] edged_maskrcnn: class {EDGED_CLASS} cls_score row x '
          f'{k:.2f}, bias {bias:.4f}: of {len(logits)} valid probe '
          f'proposals {int((p > 0.3).sum())} score above 0.3 and '
          f'{int((p > 0.05).sum())} above 0.05 (two-way estimate)',
          flush=True)
    return net


def match_detections(a_boxes, a_keys, b_boxes, b_keys):
    """One-to-one match of two detection sets: each of a to the b of the
    same key with the nearest box. Returns (b index for each a, max box
    difference), or (None, inf) unless the sets have one size and the
    nearest partners are distinct. Slots of detections whose scores lie
    within f32 noise of each other may swap between devices; the set
    may not change."""
    if len(a_boxes) != len(b_boxes):
        return None, float('inf')
    if len(a_boxes) == 0:
        return torch.zeros((0,), dtype=torch.long), 0.0
    d = (a_boxes[:, None].double() - b_boxes[None].double()).abs().amax(-1)
    d = torch.where(a_keys[:, None] == b_keys[None], d,
                    torch.full_like(d, float('inf')))
    near, idx = d.min(1)
    if len(set(idx.tolist())) != len(idx):
        return None, float('inf')
    return idx, float(near.max())


def compare_maskrcnn(img, net) -> None:
    """Mask R-CNN in f32 on the card and on the CPU, the same weights and
    image. The CPU machinery on the card's outputs, stage by stage (the
    RPN head's maps → proposals, the box head's logits → detections)
    gives the card's keep sets, boxes and scores exactly; the CPU
    RoIAlign and mask head on the card's pyramid give its mask logits
    within 1e-4 of their range; the whole detector on the CPU gives the
    card's detections above the 0.3 score threshold (the detector's
    output) as a set (``match_detections``): the same count, each with
    its label and its box within 1e-3 px, and >= 99.9% of the matched
    pasted mask pixels. (Below the threshold, candidates whose scores
    lie within f32 noise of each other may swap places in the greedy
    NMS; none of them can change a detection scored above it.)"""
    from cartoonsegmentation_torch.models import maskrcnn
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import (
        MaskRCNNDetector, normalize_pad)
    dets = {d: MaskRCNNDetector(capacity=100, model=copy.deepcopy(net).to(d),
                                device=d) for d in ('cuda', 'cpu')}
    canvas, _, (nh, nw) = dets['cuda'].canvas(img)
    ih, iw = float(nh), float(nw)

    def cpu(t):
        return [cpu(v) for v in t] if isinstance(t, (list, tuple)) \
            else t.cpu()
    with torch.no_grad():
        g, c = dets['cuda']._net(), dets['cpu']._net()
        x = normalize_pad(torch.from_numpy(canvas).cuda(), (nh, nw))
        x = x.permute(2, 0, 1)[None].contiguous()
        feats = g.features(x)
        rpn = g.rpn.head(feats)
        props, ps = g.proposals_from_rpn(rpn, ih, iw)
        cprops, cps = c.proposals_from_rpn(cpu(rpn), ih, iw)
        same_rpn = torch.equal(props.cpu(), cprops) and \
            torch.equal(ps.cpu(), cps)
        pyr = maskrcnn.flatten_pyramid(feats[:4])
        cls, reg = g.box_outputs(maskrcnn.roi_align_pyramid(pyr, props, 7))
        det = g.boxes_from_heads(cls, reg, props, ps, ih, iw)
        cdet = c.boxes_from_heads(cls.cpu(), reg.cpu(), props.cpu(),
                                  ps.cpu(), ih, iw)
        same_det = all(torch.equal(a.cpu(), b) for a, b in zip(det, cdet))
        mlog = g.detect_masks(pyr, det[0], det[1])
        cpyr = maskrcnn.flatten_pyramid(cpu(feats[:4]))
        cmlog = c.detect_masks(cpyr, cdet[0], cdet[1])
        mrel = float((mlog.cpu() - cmlog).abs().max()
                     / (cmlog.max() - cmlog.min()).clamp(min=1e-30))
        t0 = time.perf_counter()
        full = {'card': g(x, (nh, nw))}
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        full['cpu'] = c(x.cpu(), (nh, nw))
        t_cpu = time.perf_counter() - t0
    fk, fc = ({k: v.cpu() for k, v in full[d].items()} for d in
              ('card', 'cpu'))
    sel_k = fk['valid'] & (fk['scores'] > 0.3)
    sel_c = fc['valid'] & (fc['scores'] > 0.3)
    n_valid, n_cpu = int(sel_k.sum()), int(sel_c.sum())
    idx, box_diff = match_detections(fk['boxes'][sel_k], fk['labels'][sel_k],
                                     fc['boxes'][sel_c], fc['labels'][sel_c])
    slots_moved = idx is not None and not torch.equal(
        idx, torch.arange(n_valid))
    ins = {d: det_.infer(img) for d, det_ in dets.items()}
    ik, ic = ins['cuda'], ins['cpu']
    vk, vc = ik.valid.cpu(), ic.valid
    zeros = torch.zeros((int(vk.sum()),))
    # the Instances carry rounded xywh boxes and no labels
    mi, _ = match_detections(ik.bboxes.cpu()[vk], zeros, ic.bboxes[vc],
                             zeros[:int(vc.sum())])
    mask_same = float((ik.masks.cpu()[vk] == ic.masks[vc][mi]).float()
                      .mean()) if mi is not None and len(mi) else 0.0
    print(f'[maskrcnn f32] forward card {t_card:.3f} s, cpu {t_cpu:.3f} s; CPU '
          f'machinery on the card\'s outputs: proposals and scores '
          f'{"exact" if same_rpn else "DIFFER"} ({int((ps > -1e30).sum())} '
          f'valid), detections {"exact" if same_det else "DIFFER"} '
          f'({int(det[3].sum())} kept), mask logits max |card - cpu| / range '
          f'{mrel:.3g}; whole detector: {n_valid} above 0.3 on the card, '
          f'{n_cpu} on the CPU (of {int(fk["valid"].sum())} valid), '
          f'{"matched with equal labels" if box_diff < 1e30 else "NOT matched"}'
          f' ({"some slots swapped" if slots_moved else "slot for slot"}), '
          f'boxes max diff {box_diff:.3g} px, pasted masks equal '
          f'{mask_same:.6f} over {len(zeros)} instances (mean area '
          f'{float(ic.masks.float().mean()):.4f})', flush=True)
    if not (same_rpn and same_det) or mrel > 1e-4:
        fail('the CPU Mask R-CNN machinery differs from the card\'s on the '
             'same outputs')
    if idx is None or n_valid == 0 or box_diff > 1e-3 or mask_same < 0.999:
        fail('Mask R-CNN on the card differs from Mask R-CNN on the CPU')


def segment_cli_maskrcnn(net, img) -> None:
    """``run_segmentation --detector maskrcnn`` on the card with the
    edged weights as its --ckpt: every RLE of its COCO JSON must decode
    to the mask that MaskRCNNDetector.infer gives on the same image."""
    import cv2
    from cartoonsegmentation_torch import run_segmentation
    from cartoonsegmentation_torch.data.coco_export import rle2mask
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import \
        MaskRCNNDetector
    tmp = tempfile.mkdtemp(prefix='smoke_', dir=str(_cuda.BUILD_DIR))
    try:
        src, ckpt = os.path.join(tmp, 'smoke.png'), os.path.join(tmp, 'w.pth')
        ann = os.path.join(tmp, 'ann.json')
        cv2.imwrite(src, img)
        torch.save(net.state_dict(), ckpt)
        t0 = time.perf_counter()
        run_segmentation.main(['--input', src, '--save-dir',
                               os.path.join(tmp, 'out'), '--detector',
                               'maskrcnn', '--ckpt', ckpt, '--save-json', ann])
        wall = time.perf_counter() - t0
        with open(ann) as f:
            anns = json.load(f)['annotations']
        det = MaskRCNNDetector(device='cuda')
        det.load_torch_checkpoint(ckpt)
        ins = det.infer(cv2.imread(src), 0.3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    masks, valid = ins.masks.cpu().numpy(), ins.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    same = len(anns) == len(idx) and all(
        np.array_equal(rle2mask(a['segmentation']), masks[i])
        for a, i in zip(anns, idx))
    print(f'[segment] run_segmentation --detector maskrcnn ({wall:.2f} s): '
          f'{len(idx)} instances, {len(anns)} annotations, RLE round trip '
          f'{"exact" if same else "DIFFERS"}', flush=True)
    if not same or not len(idx):
        fail('segmentation CLI: the COCO RLEs do not decode to the masks')


def check_instances(pipe, tag: str) -> None:
    """Fail unless the last state's instances include a non-empty mask,
    their mean area is under half the frame, and the adjusted disparity
    is not flat."""
    ins = pipe.last_state.instances
    n_valid = int(ins.count())
    nonempty = int((ins.masks.any((1, 2)) & ins.valid).sum())
    areas = ins.masks[ins.valid].float().mean((1, 2)) if n_valid \
        else torch.zeros(1)
    disp = pipe.last_state.disparity
    spread = float(disp.std() / disp.abs().max())
    print(f'[{tag}] instances: {n_valid} valid, {nonempty} with a non-empty '
          f'mask, areas (share of the frame) mean {float(areas.mean()):.4f} '
          f'min {float(areas.min()):.4f} max {float(areas.max()):.4f}; '
          f'disparity std / max {spread:.4f}', flush=True)
    if nonempty == 0 or not float(areas.mean()) < 0.5 or \
            not float(areas.max()) < 1.0:
        fail(f'{tag}: the detector gave no instance with a non-empty mask '
             f'with edges: K6 and the instance depth adjustment did no real '
             f'work')
    if spread < 1e-3:
        fail(f'{tag}: the adjusted disparity is flat')


def sam_config(root: str):
    """configs/3dkenburns_sam.yaml with inpaint_type 'default' (its
    'ldm' needs an sd-webui server)."""
    from cartoonsegmentation_torch.config import build_kenburns_cfg
    path = os.path.join(root, 'configs', '3dkenburns_sam.yaml')
    cfg = build_kenburns_cfg(path)
    print(f'[sam] {path}: detector {cfg.detector}, inpaint_type '
          f'{cfg.inpaint_type!r} → \'default\', depth_field '
          f'{cfg.depth_field}, num_frame {cfg.num_frame}', flush=True)
    return cfg.replace(inpaint_type='default')


def compare_sam(img, sam_net, box_det, n_max: int = 8) -> None:
    """SAM in f32 on the card and on the CPU, the same weights, image
    and boxes (the first ``n_max`` valid boxes of the detector, as
    SamDetector prompts them). Fails unless the image embedding is
    within 1e-4 of its range, the masks agree at >= 99.9% and the IoUs
    within 1e-4."""
    from cartoonsegmentation_torch.pipeline.sam import NativeSAM
    ins = box_det.infer(img, 0.3)
    xywh = ins.bboxes[ins.valid].cpu().numpy()[:n_max]
    if len(xywh) == 0:
        fail('sam f32: the detector gave no box')
    boxes = np.stack([xywh[:, 0], xywh[:, 1], xywh[:, 0] + xywh[:, 2],
                      xywh[:, 1] + xywh[:, 3]], 1).astype(np.int32)
    out = {}
    for dev in ('cuda', 'cpu'):
        ns = NativeSAM(capacity=len(boxes), model=copy.deepcopy(sam_net).to(
            dev), device=dev)
        t0 = time.perf_counter()
        masks, ious = ns.segment_boxes(img, boxes.astype(np.float32))
        if dev == 'cuda':
            torch.cuda.synchronize()
        out[dev] = (ns._emb.cpu(), masks.cpu(), ious.cpu(),
                    time.perf_counter() - t0)
    (ek, mk, ik, tk), (ec, mc, ic, tc) = out['cuda'], out['cpu']
    emb_rel = float((ek - ec).abs().max() / (ec.max() - ec.min()))
    same = float((mk == mc).float().mean())
    iou_err = float((ik - ic).abs().max())
    print(f'[sam f32] {len(boxes)} boxes, card {tk:.3f} s, cpu {tc:.3f} s: '
          f'embedding max |card - cpu| / range {emb_rel:.3g}, masks equal '
          f'{same:.6f} (mean area {float(mc.float().mean()):.4f}), IoU max '
          f'err {iou_err:.3g}', flush=True)
    if emb_rel > 1e-4 or same < 0.999 or iou_err > 1e-4:
        fail('SAM on the card differs from SAM on the CPU')


def segment_api(det, img) -> None:
    """The segmentation path through the API on the card:
    SamDetector.infer → instances_to_coco; every RLE must decode to its
    mask exactly."""
    from cartoonsegmentation_torch.data.coco_export import (instances_to_coco,
                                                            rle2mask)
    ins = det.infer(img, 0.3)
    _, anns = instances_to_coco(ins, 0, 'smoke.png', img.shape[:2])
    masks, valid = ins.masks.cpu().numpy(), ins.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    same = len(anns) == len(idx) and all(
        np.array_equal(rle2mask(a['segmentation']), masks[i])
        for a, i in zip(anns, idx))
    print(f'[segment] SamDetector.infer → instances_to_coco: {len(idx)} '
          f'instances, {len(anns)} annotations, RLE round trip '
          f'{"exact" if same else "DIFFERS"}', flush=True)
    if not same or not len(idx):
        fail('segmentation API: the COCO RLEs do not decode to the masks')


def compare_detector(img, det_net, device: str = 'cuda') -> None:
    """The detector in f32 on the card and on the CPU with the same
    weights (``det_net``) on the same image. Fails unless the head maps
    agree within 1e-4 of each map's range (f32 convs, cuDNN against
    oneDNN); the CPU postprocess of the card's head maps gives the
    card's validity and boxes exactly, its scores within 1e-6 and
    >= 99.9% of its mask pixels; and the whole detector on the CPU gives
    the card's validity exactly, its boxes within 1e-3 px (the same
    kept candidates; the box regression differs by ulps) and >= 99.9%
    of its mask pixels."""
    from cartoonsegmentation_torch.models.rtmdet import postprocess
    from cartoonsegmentation_torch.pipeline.segment import (
        AnimeInsSeg, normalize_canvas)
    cpu = AnimeInsSeg(dtype='float32', device='cpu')
    gpu = AnimeInsSeg(dtype='float32', device=device)
    cpu.model, gpu.model = copy.deepcopy(det_net), copy.deepcopy(det_net)
    x, _, _ = gpu._preprocess(img)
    kw = dict(score_thr=0.0, mask_thr=gpu.mask_thr, pre_topk=512,
              max_det=gpu.max_instances, input_h=gpu.det_size,
              input_w=gpu.det_size)
    heads = {}
    with torch.inference_mode():
        for tag, seg in (('card', gpu), ('cpu', cpu)):
            net = seg._net()
            inp = normalize_canvas(torch.from_numpy(x).to(seg.device))
            t0 = time.perf_counter()
            heads[tag] = net(inp.permute(0, 3, 1, 2).contiguous())
            if seg.device.type == 'cuda':
                torch.cuda.synchronize()
            print(f'[detector f32] {tag} forward '
                  f'{time.perf_counter() - t0:.3f} s', flush=True)
        flat_g = [t for group in heads['card'] for t in
                  (group if isinstance(group, tuple) else (group,))]
        flat_c = [t for group in heads['cpu'] for t in
                  (group if isinstance(group, tuple) else (group,))]
        rel = max(float((g.cpu() - c).abs().max()
                        / c.abs().max().clamp(min=1e-30))
                  for g, c in zip(flat_g, flat_c))
        card = postprocess(*heads['card'], **kw)
        on_cpu = postprocess(*[tuple(t.cpu() for t in h)
                               if isinstance(h, tuple) else h.cpu()
                               for h in heads['card']], **kw)
        all_cpu = postprocess(*heads['cpu'], **kw)
    card = {k: v.cpu() for k, v in card.items()}
    keep_same = all(torch.equal(card[k], on_cpu[k])
                    for k in ('valid', 'bboxes'))
    mask_same = float((card['masks'] == on_cpu['masks']).float().mean())
    score_err = float((card['scores'] - on_cpu['scores']).abs().max())
    full_keep = int((card['valid'] == all_cpu['valid']).sum())
    full_box = float((card['bboxes'] - all_cpu['bboxes']).abs().max())
    full_mask = float((card['masks'] == all_cpu['masks']).float().mean())
    area = float(card['masks'][card['valid']].float().mean())
    n = card['valid'].numel()
    print(f'[detector f32] head maps: max |card - cpu| / range {rel:.3g}; '
          f'postprocess of the same maps: keep set and boxes '
          f'{"exact" if keep_same else "DIFFER"}, scores max err '
          f'{score_err:.3g}, masks equal {mask_same:.6f}, '
          f'{int(card["valid"].sum())} valid (mean mask area {area:.4f}); '
          f'whole detector on the CPU: {full_keep}/{n} validity equal, '
          f'boxes max diff {full_box:.3g} px, masks equal {full_mask:.6f}',
          flush=True)
    if rel > 1e-4:
        fail(f'detector head maps differ by {rel:.3g} of their range')
    if not keep_same or mask_same < 0.999 or score_err > 1e-6:
        fail('the card postprocess differs from the CPU plain one on the '
             'same head maps')
    if full_keep < n or full_box > 1e-3 or full_mask < 0.999:
        fail('the detector on the card differs from the detector on the '
             'CPU')


# -- K12 (the CRF depth refine) and K15b (the tagger) ------------------

# shares the CRF checks hold the kernels to (see their docstrings)
KMEANS_SHARE = 0.999
CRF_MASK_SHARE = 0.999
REFINE_SHARE = 0.99


def sloppy_mask(gen: torch.Generator, h: int, w: int) -> torch.Tensor:
    """A foreground probability as the refine's flood fills give the CRF:
    an ellipse at 0.9 with a ragged band of 0.5 +- noise around it."""
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    r = ((xx - 0.45 * w) / (0.3 * w)) ** 2 + ((yy - 0.5 * h) / (0.35 * h)) ** 2
    p = torch.where(r < 0.8, 0.9, 0.05)
    band = (r >= 0.8) & (r < 1.3)
    noise = 0.5 + 0.15 * torch.randn((h, w), generator=gen)
    return torch.where(band, noise, p).clamp(0, 1)


def check_crf_kernels(dev, gen, img: np.ndarray) -> dict:
    """K12a and K12b against their plain versions at the refine's
    shapes: the k-means on the full 576x1024 guide of the image (RGB,
    as the refine's crops) and on one crop, >= 99.9% of labels equal
    (the kernel's block-ordered cluster sums and the plain one-hot
    matmul round the centres differently); the CRF's norm pass exact,
    one mean-field step within 1e-5 (the same labels), and
    densecrf_binary on the 576x1024 image and a sloppy mask >= 99.9%
    equal to the plain version's on the CPU."""
    from cartoonsegmentation_torch.ops import crf
    res = {}
    rgb = torch.from_numpy(np.ascontiguousarray(img[..., ::-1])).to(dev)
    inv = torch.tensor(1.0 / 255.0, device=dev)
    k, iters = 10, 8
    for tag, part in (('full', rgb), ('crop', rgb[120:420, 260:700])):
        g = (part.float() * inv).reshape(-1, 3).contiguous()
        N = g.shape[0]
        got = crf.kmeans_labels(g, k, iters)
        want = crf._kmeans_labels(g, k, iters)
        share = float((got == want).float().mean())
        cases = [(g * (1.0 - 1e-3 * i)).contiguous() for i in range(RUNS)]
        ms = time_ms(lambda x: crf.kmeans_labels(x, k, iters), cases)
        plain_ms = time_ms(lambda x: crf._kmeans_labels(x, k, iters),
                           cases[:3])
        # per point and cluster in each of the 9 passes: 3 subtracts, a
        # multiply, 2 fused multiply-adds (2 each) and a compare; per
        # point in each of the 8 recentrings: 4 adds
        flops = N * k * 9 * (iters + 1) + N * 4 * iters
        b, by = bound(N * 12 + N * 4, flops)
        print(f'[kernel] kmeans {tag} N={N} k={k}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}); labels equal '
              f'{share:.6f} ({len(torch.unique(got))} clusters used)',
              flush=True)
        if share < KMEANS_SHARE:
            fail(f'kmeans {tag}: only {share:.6f} of labels equal to the '
                 f'plain version ({KMEANS_SHARE} required)')
        res[f'kmeans_{tag}'] = dict(label_share=share, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, max_abs_err=1.0 - share)

    # K12b on the whole 576x1024 image
    unary_fg = sloppy_mask(gen, H, W).to(dev)
    guide = rgb.float() * inv
    labels = crf.kmeans_labels(guide.reshape(-1, 3), k).reshape(H, W)
    norms, dead = crf.crf_norms(labels)
    norms_p, dead_p = crf.crf_norms_plain(labels, 1.0, 46.0, k)
    norm_err = float((norms - norms_p).abs().max())
    p = torch.clamp(unary_fg, 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    qs = [crf._softmax2(-unary * (1.0 + 0.05 * i)) for i in range(RUNS)]
    got = crf.crf_step(qs[0], labels, unary, norms, dead)[0]
    want = crf.crf_step_plain(qs[0], labels, unary, norms_p)
    err = float((got - want).abs().max())
    ms = time_ms(lambda q: crf.crf_step(q, labels, unary, norms, dead),
                 qs)
    plain_ms = time_ms(lambda q: crf.crf_step_plain(q, labels, unary,
                                                    norms_p), qs[:3])
    mk = crf.densecrf_binary(unary_fg, rgb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk = crf.densecrf_binary(unary_fg, rgb)
    torch.cuda.synchronize()
    whole_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    mp = crf.densecrf_binary(unary_fg.cpu(), rgb.cpu())
    cpu_s = time.perf_counter() - t0
    mask_share = float((mk.cpu() == mp).float().mean())
    s, gh, gw, R = crf.lattice(H, W, 46.0)
    planes = 2 * k
    # a step reads q, the labels, the unary and the norms, writes q'
    # and the mask
    nbytes = H * W * (8 + 4 + 8 + 8 + 8 + 1)
    # per pixel and channel: the 5x5 Gaussian (2 x 30 operations), the
    # two-tap bilinear (6), the messages (8); per pixel the softmax
    # (~30); the lattice: the pool (s^2 adds) and the 9x9 blur
    flops = H * W * (2 * (60 + 6 + 8) + 30) + planes * gh * gw * (
        s * s + 2 * (2 * R + 1) ** 2)
    b, by = bound(nbytes, flops)
    print(f'[kernel] crf step {H}x{W} ({gh}x{gw} lattice of {s} px, {k} '
          f'clusters): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{b:.4f} ms ({by}); norm pass max err {norm_err:.3g} (dead '
          f'{int(dead)} / {int(dead_p)}), step max err {err:.3g}; '
          f'densecrf_binary {whole_ms:.3f} ms on the card, {cpu_s:.2f} s the '
          f'plain version on the CPU, masks equal {mask_share:.6f} (fg '
          f'{float(mp.float().mean()):.4f})', flush=True)
    if norm_err > 0 or int(dead) != int(dead_p) or err > 1e-5:
        fail('crf: the norm pass or a step differs from the plain version')
    if mask_share < CRF_MASK_SHARE:
        fail(f'crf: only {mask_share:.6f} of densecrf_binary\'s mask equal to '
             f'the plain version\'s ({CRF_MASK_SHARE} required)')
    res['crf'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                      bound_by=by, densecrf_ms=whole_ms,
                      mask_share=mask_share)
    return res


# SwinV2-B at 448: (stage, windows of 8x8, heads, padded grid)
SWIN_STAGES = ((0, 196, 4, 112), (1, 49, 8, 56), (2, 16, 16, 32),
               (3, 4, 32, 16))


def check_swinattn(dev, gen) -> dict:
    """K15b at SwinV2-B 448's four stage shapes (N = 64 tokens, head
    width 32), with and without the shifted blocks' mask; random q, k,
    v, logit scales and CPB bias; within 1e-5 of the plain version's
    range; beside SDPA on the pre-normalised, pre-scaled q with bias +
    mask prebuilt as its attn_mask."""
    import torch.nn.functional as F
    from cartoonsegmentation_torch.models import swinv2
    res = {}
    g = torch.Generator(device=dev).manual_seed(int(torch.randint(
        0, 1 << 30, (1,), generator=gen)))
    N, hd = 64, 32
    for stage, B, n, grid in SWIN_STAGES:
        for masked in (False, True):
            mask = swinv2.shift_attn_mask(grid, grid, (8, 8), (4, 4)) \
                if masked else None
            mask = None if mask is None else torch.from_numpy(mask).to(dev)
            cases = []
            for _ in range(RUNS):
                qkv = torch.randn((B, N, 3, n, hd), device=dev, generator=g)
                scale = torch.exp(torch.clamp(torch.rand(
                    (n,), device=dev, generator=g) * 5.0, max=np.log(100.0)))
                bias = 16.0 * torch.sigmoid(torch.randn(
                    (n, N, N), device=dev, generator=g))
                cases.append((qkv, scale, bias, mask))
            got = swinv2.window_attention(*cases[0])
            want = swinv2.window_attention_plain(*cases[0])
            err = float((got - want).abs().max())
            rng_ = float(want.abs().max())
            if err > 1e-5 * rng_:
                fail(f'swinattn stage {stage} mask {masked}: max err '
                     f'{err:.3g} above 1e-5 of {rng_:.3g}')
            ms = time_ms(lambda c: swinv2.window_attention(*c), cases)
            plain_ms = time_ms(lambda c: swinv2.window_attention_plain(*c),
                               cases)

            def sdpa_args(c):
                qkv, scale, bias, m = c
                q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
                q = F.normalize(q, dim=-1, eps=1e-12) * scale[:, None, None]
                k = F.normalize(k, dim=-1, eps=1e-12)
                am = bias[None].expand(B, n, N, N)
                if m is not None:
                    am = (am.reshape(B // m.shape[0], m.shape[0], n, N, N)
                          + m[None, :, None]).reshape(B, n, N, N)
                return q, k, v, am.contiguous()
            lib_cases = [sdpa_args(c) for c in cases[:3]]
            lib = F.scaled_dot_product_attention(
                *lib_cases[0][:3], attn_mask=lib_cases[0][3], scale=1.0)
            lib_err = float((lib.transpose(1, 2).reshape(B, N, n * hd)
                             - want).abs().max())
            lib_ms = time_ms(lambda c: F.scaled_dot_product_attention(
                *c[:3], attn_mask=c[3], scale=1.0), lib_cases)
            # q.k and p.v (2 operations a multiply-add), the scale, bias,
            # mask and ~4 of the softmax a score; the two norms
            flops = B * n * N * N * (4 * hd + 7) + B * n * N * 2 * 3 * hd
            nbytes = 4 * (B * N * 3 * n * hd + n * N * N + B * N * n * hd
                          + (mask.numel() if masked else 0))
            b, by = bound(nbytes, flops)
            tag = f's{stage}{"m" if masked else ""}'
            res[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b, bound_by=by, library_ms=lib_ms)
            print(f'[kernel] swinattn stage {stage} {B} windows x {n} heads'
                  f'{" masked" if masked else ""}: kernel {ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), SDPA '
                  f'{lib_ms:.4f} ms (max err {lib_err:.3g}); max err '
                  f'{err:.3g} of {rng_:.3g}', flush=True)
            del cases, lib_cases
    return res


def refine_inputs(pipe) -> dict:
    """Record what the pipeline's next CRF refine is given: the image,
    the disparity and the instances."""
    seen = {}
    inner = pipe._refine_crf

    def recording(img, disparity, instances):
        seen.update(img=img, disparity=disparity.clone(),
                    instances=instances)
        return inner(img, disparity, instances)
    pipe._refine_crf = recording
    return seen


def compare_refine(tag: str, img, disparity: np.ndarray, ins_mask) -> int:
    """refine_depth_crf on the card and on the CPU (the plain versions)
    on the same host arrays; fails below REFINE_SHARE of equal refined
    disparity pixels (a k-means label at a near tie can flip a CRF
    pixel, which can move a segment's box or median, and a written
    segment covers at most a tenth of the frame). Returns the segments
    that reached the CRF on the card."""
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.crf_refine import \
        refine_depth_crf
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out_k = refine_depth_crf(img, disparity, ins_mask, device='cuda')
    torch.cuda.synchronize()
    tk = time.perf_counter() - t0
    segments = _cuda.LAUNCHES['kmeans']
    t0 = time.perf_counter()
    out_c = refine_depth_crf(img, disparity, ins_mask, device='cpu')
    tc = time.perf_counter() - t0
    same = float((out_k == out_c).mean())
    moved = float((out_k != disparity).mean())
    print(f'[{tag}] refine_depth_crf card {tk:.3f} s ({segments} segments, '
          f'{_cuda.LAUNCHES["crf"]} crf launches), cpu {tc:.3f} s: refined '
          f'disparity equal {same:.6f}, max diff '
          f'{float(np.abs(out_k - out_c).max()):.4g}; {moved:.4f} of the '
          f'pixels moved', flush=True)
    if same < REFINE_SHARE:
        fail(f'{tag}: only {same:.6f} of the refined disparity equal on the '
             f'card and the CPU ({REFINE_SHARE} required)')
    return segments


def layered_disparity(seed: int) -> np.ndarray:
    """A disparity of flat layers over ``make_image``'s shapes (the same
    draws): a background ramp of 5 to 8, each disc a level of its own
    from 12 to 27, the rectangle 40."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rng.uniform(0, 2 * np.pi, 3)
    disp = 5.0 + 3.0 * xx / W
    for i in range(6):
        cx, cy = rng.uniform(100, W - 100), rng.uniform(80, H - 80)
        r = rng.uniform(30, 90)
        rng.uniform(0, 255, 3)
        disp[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = 12.0 + 3.0 * i
    x0, y0 = int(rng.uniform(50, W - 300)), int(rng.uniform(50, H - 200))
    disp[y0:y0 + 150, x0:x0 + 250] = 40.0
    return disp.astype(np.float32)


def mask_boxes(ins):
    """The instances with each box the extent of its mask: the edged
    detector's masks have edges, but its random box head gives
    degenerate boxes (x, 0, 0, 0), which crop nothing to tag."""
    m = ins.masks & ins.valid[:, None, None]
    rows, cols = m.any(2), m.any(1)

    def extent(hit):
        idx = torch.arange(hit.shape[1], device=hit.device)
        lo = torch.where(hit, idx, hit.shape[1]).min(1).values
        hi = torch.where(hit, idx, -1).max(1).values + 1
        return lo, (hi - lo).clamp(min=0)
    (y0, h), (x0, w) = extent(rows), extent(cols)
    boxes = torch.stack([x0, y0, w, h], 1).float()
    return ins.replace(bboxes=torch.where(m.any((1, 2))[:, None], boxes,
                                          torch.zeros_like(boxes)))


def tagger_phase(det, img: np.ndarray, seed: int) -> dict:
    """The danbooru tagger at full width: SwinV2-B at 448 with 9083
    classes, random from ``seed``, saved in timm's keys as model.pth
    beside a synthetic 9083-row selected_tags.csv (4 rating rows, one
    character tag), loaded by ``AnimeInsSeg.init_tagger``, run by
    ``infer_tags`` on the detector's instances of the image (boxed by
    their masks, ``mask_boxes``): 24 K15b launches an instance. Then one crop's probabilities on the card
    against the CPU within 1e-4, the tags equal apart from those within
    1e-4 of the threshold. Returns the launches of infer_tags."""
    from cartoonsegmentation_torch.models.swinv2 import (init_swinv2_,
                                                          wd_tagger_swinv2)
    from cartoonsegmentation_torch.models.tagger import Tagger
    from cartoonsegmentation_torch.ops import _cuda
    net = init_swinv2_(wd_tagger_swinv2(9083),
                       torch.Generator().manual_seed(seed))
    tmp = tempfile.mkdtemp(prefix='smoke_', dir=str(_cuda.BUILD_DIR))
    try:
        path = os.path.join(tmp, 'model.pth')
        torch.save(net.state_dict(), path)
        with open(os.path.join(tmp, 'selected_tags.csv'), 'w') as f:
            f.write('tag_id,name,category,count\n')
            for i in range(9083):
                cat = 9 if i < 4 else (4 if i == 4 else 0)
                f.write(f'{i},tag_{i},{cat},1\n')
        det.init_tagger(path)
        tagger = det.tagger
        ins = mask_boxes(det.infer(img, 0.3))
        n = int(ins.count())
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        tags, chars = det.infer_tags(ins, img)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        n_tags = [len(t.split()) for t in tags]
        print(f'[tagger] SwinV2-B 448, 9083 classes ({tagger.backend} on '
              f'{tagger.device}): {len(tags)} instances tagged in {wall:.3f} '
              f's ({1e3 * wall / max(len(tags), 1):.1f} ms each), '
              f'{launches["swinattn"]} swinattn launches; tags an instance '
              f'{min(n_tags, default=0)}-{max(n_tags, default=0)}, character '
              f'tags {sum(len(c) for c in chars)}', flush=True)
        if len(tags) != n or n == 0:
            fail(f'tagger: {len(tags)} instances tagged of {n}')
        if launches['swinattn'] != 24 * n:
            fail(f'tagger: {launches["swinattn"]} swinattn launches for {n} '
                 f'instances, expected {24 * n}')
        # one crop, as infer_tags builds it, on the card and the CPU
        i = int(np.flatnonzero(ins.valid.cpu().numpy())[0])
        x, y, w, h = ins.bboxes[i].cpu().numpy().astype(np.int32)
        crop = img[y:y + h, x:x + w].copy()
        crop[~ins.masks[i].cpu().numpy()[y:y + h, x:x + w]] = 255
        profile_tagger_crop(tagger, crop)
        xin = tagger._prep(crop)
        pk = tagger.probs(xin)[0]
        cpu = Tagger(path, device='cpu')
        t0 = time.perf_counter()
        pc = cpu.probs(xin)[0]
        tc = time.perf_counter() - t0
        err = float(np.abs(pk - pc).max())
        near = np.abs(pc - tagger.general_thr) <= 1e-4
        keep = ~near
        same = tagger._split(np.where(keep, pk, 0.0)) == \
            cpu._split(np.where(keep, pc, 0.0))
        print(f'[tagger] one crop card vs cpu ({tc:.2f} s on the CPU): '
              f'probabilities max err {err:.3g}, tags equal '
              f'{"yes" if same else "NO"} ({int(near.sum())} within 1e-4 of '
              f'the threshold set aside; {int((pk > 0.5).sum())} above it)',
              flush=True)
        if err > 1e-4 or not same:
            fail('tagger: the card and the CPU disagree on one crop')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description='GPU smoke run of the port')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs '
             'one CUDA GPU')
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from cartoonsegmentation_torch.config import KenBurnsConfig
        from cartoonsegmentation_torch.ops import _cuda
        from cartoonsegmentation_torch.pipeline.kenburns import \
            KenBurnsPipeline
    except ImportError as e:
        fail(f'the cartoonsegmentation_torch package is missing: {e}')

    dev = torch.device('cuda')
    card = card_line()
    print(f'card: {card}', flush=True)
    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = 'missing'
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'python {sys.version.split()[0]}, cv2 {cv2_version}, '
          f'{torch.cuda.get_device_name(0)}', flush=True)

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    print(f'[build] {len(_cuda.KERNELS)} kernel libraries in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # 2. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    res = check_kernels(dev, gen)
    img = make_image(args.seed)
    res.update(check_crf_kernels(dev, gen, img))
    res.update(check_swinattn(dev, gen))

    # 3. the first slice's path: the detector-free clip -------------------
    free = KenBurnsPipeline(KenBurnsConfig(detector='none'), seed=args.seed,
                            device='cuda')
    launches_free = run_clip(free, img, 'detector-free')
    require_launches('detector-free', launches_free,
                     ('splat', 'coverage', 'discfill', 'bokeh', 'insmedian',
                      'median5', 'laplacian', 'epilogue', 'colorize',
                      'compact'))
    compare_frames(free, 'detector-free')
    del free

    # 4. the main path: the shipped default, detector and refine on --------
    cfg = KenBurnsConfig()
    pipe = KenBurnsPipeline(cfg, seed=args.seed, device='cuda')
    det_net, isnet = edged_nets(args.seed)
    pipe.ensure_detector()
    pipe._detector.model = copy.deepcopy(det_net)
    pipe._detector.refine.net = isnet
    launches = run_clip(pipe, img, 'main')
    require_launches('main', launches,
                     [k for k in _cuda.KERNELS if k not in (
                         'samattn', 'discfill_exact', 'roialign',
                         'nms_large', 'kmeans', 'crf', 'swinattn')])
    check_instances(pipe, 'main')

    # 5. kernel frames against the plain versions on the CPU ---------------
    compare_frames(pipe, 'main')
    state = pipe.last_state
    obj_from, obj_to = pipe.last_boxes

    # 6. the detector in f32, card against CPU ----------------------------
    compare_detector(img, det_net)

    # 7. the main path again, warm, and where the frame loop's time goes
    pipe.timer.reset()
    run_clip(pipe, img, 'warm')
    profile_frame_loop(pipe, state, obj_from, obj_to)
    del pipe, state

    # 8. the SAM path: 3dkenburns_sam.yaml, AnimeInsSeg boxes re-masked
    # by SAM ViT-B ------------------------------------------------------
    sp = KenBurnsPipeline(sam_config(root), seed=args.seed, device='cuda')
    sp.ensure_detector()
    sp._detector.box_detector.model = copy.deepcopy(det_net)
    sam_net = edged_sam(args.seed, img)
    sp._detector.sam.model = sam_net
    launches_sam = run_clip(sp, img, 'sam')
    require_launches('sam', launches_sam,
                     ('splat', 'coverage', 'discfill', 'median5', 'laplacian',
                      'nms', 'maskhead', 'epilogue', 'compact', 'samattn'))
    if launches_sam['samattn'] != 12:
        fail(f'sam: {launches_sam["samattn"]} samattn launches for one '
             f'encode, expected 12 (one a block)')
    check_instances(sp, 'sam')
    compare_frames(sp, 'sam')

    # 9. SAM in f32 card against CPU; the segmentation API ---------------
    compare_sam(img, sam_net, sp._detector.box_detector)
    segment_api(sp._detector, img)
    del sp, sam_net

    # 10. the Mask R-CNN path with the exact fill --------------------------
    mp = KenBurnsPipeline(KenBurnsConfig(detector='maskrcnn',
                                         discfill_mode='exact'),
                          seed=args.seed, device='cuda')
    mr_net = edged_maskrcnn(args.seed, img)
    mp.ensure_detector()
    mp._detector.model = copy.deepcopy(mr_net)
    launches_mr = run_clip(mp, img, 'maskrcnn')
    require_launches('maskrcnn', launches_mr,
                     ('splat', 'coverage', 'discfill_exact', 'bokeh',
                      'insmedian', 'median5', 'laplacian', 'epilogue',
                      'colorize', 'compact', 'roialign', 'nms_large'))
    if launches_mr['discfill']:
        fail(f'maskrcnn: K3 launched {launches_mr["discfill"]} times under '
             f'discfill_mode exact')
    check_instances(mp, 'maskrcnn')
    compare_frames(mp, 'maskrcnn')
    del mp

    # 11. Mask R-CNN in f32 card against CPU; the segmentation CLI --------
    compare_maskrcnn(img, mr_net)
    segment_cli_maskrcnn(mr_net, img)

    # 12. the CRF clip: the shipped default with refine_crf -------------
    cp = KenBurnsPipeline(KenBurnsConfig(refine_crf=True), seed=args.seed,
                          device='cuda')
    cp.ensure_detector()
    cp._detector.model = copy.deepcopy(det_net)
    cp._detector.refine.net = copy.deepcopy(isnet)
    seen = refine_inputs(cp)
    launches_crf = run_clip(cp, img, 'crf')
    require_launches('crf', launches_crf,
                     [k for k in _cuda.KERNELS if k not in (
                         'samattn', 'discfill_exact', 'roialign',
                         'nms_large', 'swinattn')])
    print(f'[crf] depth_refine {cp.timer.seconds["depth_refine"]:.3f} s: '
          f'{launches_crf["kmeans"]} segments reached the CRF, '
          f'{launches_crf["kmeans"]} kmeans and {launches_crf["crf"]} crf '
          f'launches', flush=True)
    check_instances(cp, 'crf')
    compare_frames(cp, 'crf')
    ins_mask = seen['instances'].compose_masks().cpu().numpy()
    compare_refine('crf', seen['img'],
                   seen['disparity'][..., 0].cpu().numpy(),
                   ins_mask if ins_mask.any() else None)

    # 13. refine_depth_crf on layers over the image's shapes --------------
    segments = compare_refine('crf layers', img, layered_disparity(args.seed),
                              None)
    if segments < 5:
        fail(f'crf layers: {segments} segments reached the CRF, expected at '
             f'least 5')

    # 14. the danbooru tagger on the detector's instances -----------------
    launches_tag = tagger_phase(cp._detector, img, args.seed)
    del cp

    # 15. report --------------------------------------------------------
    src = 'cartoonsegmentation_torch/csrc/'
    tpu = 'cartoonsegmentation_tpu/'
    c68, win = res['splat_c68'], res['samattn_windowed']
    rows = [
        # the frame loop's C = 4; the Inpaint net's C = 68 beside it
        ('splat', res['splat_c4'], 'ops/pointcloud.py:121',
         {f'{k}_c68': c68[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                       'bound_ms')}),
        ('coverage', res['coverage'], 'ops/pointcloud.py:226', {}),
        ('discfill', res['discfill'], 'ops/discfill3.py:90', {}),
        ('bokeh', res['bokeh'], 'ops/bokeh.py:253', {}),
        ('insmedian', res['insmedian'], 'pipeline/depth.py:67', {}),
        ('median5', res['median5'], 'ops/filters.py:42', {}),
        ('laplacian', res['laplacian'], 'ops/filters.py:26', {}),
        ('nms', res['nms'], 'models/rtmdet.py:194', {}),
        ('maskhead', res['maskhead'], 'models/rtmdet.py:222', {}),
        # crop_center_resize :146, the uint8 step pipeline/kenburns.py
        # :975, bgr_to_i420 :194
        ('epilogue', res['epilogue'], 'utils/image.py:146', {}),
        ('colorize', res['colorize'], 'pipeline/depth.py:113', {}),
        ('compact', res['compact'], 'pipeline/state.py:58', {}),
        # the global blocks; the windowed ones beside them
        ('samattn', res['samattn_global'], 'models/sam.py:76',
         {f'{k}_windowed': win[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                            'bound_ms', 'library_ms')}),
        ('discfill_exact', res['discfill_exact'], 'ops/discfill.py:225', {}),
        # the box head's (1000, 7x7); the mask head's (100, 14x14) beside
        ('roialign', res['roialign_7'], 'models/maskrcnn.py:248',
         {f'{k}_14': res['roialign_14'][k] for k in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms')}),
        # the RPN's K = 4,756; the detection's K = 2,048 beside
        ('nms_large', res['nms_large_rpn'], 'models/maskrcnn.py:235',
         {f'{k}_det': res['nms_large_det'][k] for k in (
             'ms', 'plain_ms', 'bound_ms')}),
        # the full 576x1024 guide; the crop beside it
        ('kmeans', res['kmeans_full'], 'ops/crf.py:55',
         {f'{k}_crop': res['kmeans_crop'][k] for k in (
             'label_share', 'ms', 'plain_ms', 'bound_ms')}),
        # one mean-field step at 576x1024
        ('crf', res['crf'], 'ops/crf.py:95', {}),
        # stage 0 with the shift mask; every stage, with and without
        ('swinattn', res['s0m'], 'models/swinv2.py:123',
         {f'{k}_{tag}': res[tag][k] for tag in (
             's0', 's1', 's1m', 's2', 's2m', 's3', 's3m') for k in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')}),
    ]
    paths = {'detector-free': launches_free, 'main': launches,
             'sam': launches_sam, 'maskrcnn': launches_mr,
             'crf': launches_crf, 'tagger': launches_tag}
    own_path = {'samattn': launches_sam, 'discfill_exact': launches_mr,
                'roialign': launches_mr, 'nms_large': launches_mr,
                'kmeans': launches_crf, 'crf': launches_crf,
                'swinattn': launches_tag}
    kernels = []
    for name, r, where, extra in rows:
        # one PyTorch call computes the laplacian (a convolution) and
        # the two attentions (SDPA with the bias); none computes the
        # others (torchvision, whose roi_align and nms would, is not
        # installed)
        kernels.append({
            'name': name, 'route': 'cuda', 'source': f'{src}{name}.cu',
            'replaces': f'{tpu}{where}',
            'launches': own_path.get(name, launches)[name],
            'launches_by_path': {k: v[name] for k, v in paths.items()},
            'library_ms': None, **r, **extra})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
