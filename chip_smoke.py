#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

1. prints the card, torch and CUDA versions, and builds the 22 CUDA
   kernel libraries (csrc/*.cu, one entry point each) with nvcc, all at
   once;
2. takes the host's cost of one kernel call apart (``host_phase``:
   the laplacian's wrapper, its launch, the bare ctypes call, the
   stream handle, an entry point that returns at once, ``torch.neg``;
   µs a call over 1,000 calls), then
   holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (576x1024; K1 with C = 4, C = 68 and C = 4
   with 4,096 copies of one point, as the main path's cloud has; K6 over
   100 instance slots, also on a map with NaN and +-inf values, its
   scratch left zero; K7's median-5 and 3x3 median also on taps of NaN,
   +-inf and +-0 (NaN outputs where the plain version has them; the
   3x3 median bit for bit where no tap is zero); K8 over the top
   512 boxes, and K8 and K14b on scores with +-0.0 and NaNs; K9 at 100
   x 640x640; K6, both medians, K8 and K9 each one kernel a call,
   counted as the nodes of a captured CUDA graph;
   K5a at the path's crop and at a crop kept at its size, on the
   filled view and on contiguous frames, through ``frame_epilogue``
   and the frame loop's ``EpiloguePlan``, with the host's cost of a
   call; K10 with an overflow; K1, K4 and K10 once under the sync
   debug mode, where a host sync fails the run; K15a at SAM ViT-B's
   windowed
   and global blocks, beside SDPA with the bias prebuilt, bound by the
   tensor cores' 3xTF32 rate (``bound_tc``); K11 at 128 steps on the
   rendered frames, a frame of holes only and a render with a band of
   holes along the border; K14a at (1000, 7x7) and (100, 14x14)
   over the 768x1344 canvas's pyramid; K14b at K = 4,756 and 2,048 with
   -inf scores and category offsets (``synthetic_k14``); K12a on the
   image's 576x1024 guide and a crop, K12b's norm pass, one step and a
   whole densecrf_binary at 576x1024; K15b at SwinV2-B 448's four stage shapes with and without
   the shift mask, beside SDPA; K13a and K13b at the style path's
   448x768 and 768x768 on a hole of seeded discs over a quarter of the
   frame) and times both with CUDA events around one call on an idle
   card (median of runs on varied inputs); K1, K2, K3, K4, K5a, K5b,
   K6, the median-5, the laplacian and its cuDNN convolution, K8, K9,
   K11, K12a, K12b's step and norm pass, K13a, K13b, K14a, K14b, K15a,
   K15b and SDPA also by
   their device time alone (``graph_ms``: ten calls captured in a CUDA
   graph and replayed), the ratio to SDPA's on each attention line;
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
   is not flat, and that the 75 frames are sane; counts the copies of
   its cloud's most repeated point (K1's crowded case); holds K3 bit for
   bit against its plain version on 8 of the clip's own frames and
   times it there, with their hole share and gaps; holds K2's counts
   against its plain version on the clip's own autozoom input (the
   stride-2 miniature of its cloud and its 256 shifts) and times it
   there;
5. re-renders 3 frames of that state on the CPU the same way;
6. runs the detector in f32 on the card and on the CPU with the same
   weights on the same image: the head maps within the stated
   tolerance, the CPU postprocess of the card's head maps and the whole
   detector on the CPU against the card's (NMS keep set exact, mask
   pixels >= 99.9%); records the K8 and K9 calls of one forward of the
   shipped default's detector on the image (``detector_inputs``) and
   holds both against their plain versions there, with their device
   times, bounds and the calls' facts (the candidates kept, the sorted
   row of the last output, the valid instances);
7. runs the main path again warm, and profiles 16 frames of the render
   loop (host enqueue time, device busy share, device time by kernel);
   then ``[serve]`` (``serve_phase``: that pipeline behind the port's
   server on 127.0.0.1, every request over HTTP: /health, /load_image,
   /get_live at t = 0, 0.5, 1, /update_to, /step_inpaint, /get_result
   decoded with cv2, /segment, three MJPEG parts; any status but 200
   fails; the t = 0.5 frame against the card's and the CPU's renders;
   K1-K10 launched; the routes' seconds) and ``[segment_api]``
   (``segment_api_phase``: infer_batch against infer, segment_with_bboxes
   at Q = 5 with K9's probabilities against its plain version,
   render_coverage as K1 at C = 0 against the plain version and K2 at
   zero shift, timed; spatial_filter('median-3'));
   then the options clip (``options_phase``): the shipped default with
   ``refine_method: animeseg`` (ISNet-IS at 1024, its logits centred on
   the image, ``edged_animeseg``), ``depth_est: default`` with
   ``default_depth_refine`` (the disparity net and Refine with their
   last blocks scaled on a probe, ``edged_depth``) and ``inpaint_type:
   patchmatch`` (the host C++ PatchMatch, built with g++ first), after
   U2Net, U2Net-lite, ISNetGTEncoder and MODNet at 1024 and the
   disparity net and Refine at the clip's sizes in f32 card against
   CPU (within 1e-4 of the output's range): the launches, the
   instances, the frames against the CPU, both PatchMatch passes' host
   seconds, the instances the refine changed; then the depth
   estimators (``zoe_boost_phase``): ZoeDepth and ZoeDepthNK at full
   width on the clip's 384x672 grid in f32 card against CPU (the
   metric depth within ``ZOE_TOL`` of its range, the NK router's vote
   equal; each net's seed bins and log-binomial head set so that the
   depth spans its bins, ``edged_zoe``), the merge net at 1024 and
   LeReSBoost on a 432x768 image (``boost_image``: the same patches,
   the boosted depth within ``BOOST_TOL``), then the shipped default
   with ``depth_est`` 'zoe', 'zoe_nk' and 'leres_boost' at 576x1024,
   75 frames each: K1-K10 launched, the instances, the disparity's
   range and the frames' hole share, the boost's steps in seconds,
   the frames against the CPU; then the diffusion options
   (``diffusion_phase``): Marigold (the SD2 UNet with 8 input channels,
   the SD VAE) and the SD1.5-inpainting model (9 channels, 1x1-conv
   projections) drawn on the card from the seed at full width, the
   backend SDPA picks in f32 at their largest attentions (the VAE's
   one head of width 512 at a 72x128 latent) with its time and memory,
   both UNets at a 16x16 latent, the VAE at 128x128, both CLIP towers
   and the ensemble merge at (5, 448, 768) card against CPU (within
   ``DIFF_TOL`` of the output's range), MarigoldDepth (4 LCM steps,
   ensemble 5) and LDMInpainter (32 DDIM steps, CFG 7) end to end on a
   128x128 crop on the same host-drawn noise, then the shipped default
   with ``depth_est: marigold`` and with ``inpaint_type: ldm_native``
   at 576x1024, 75 frames each (the pipelines draw the same weights):
   K1-K10, the instances, the disparity and hole share, each inpainting
   pass's seconds and changed share, the frames against the CPU;
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
   masks exactly; then ``configs/3dkenburns_sam.yaml`` as shipped
   (``inpaint_type: ldm``) against a stub sd-webui on 127.0.0.1 at the
   shipped URL's port (``ldm_phase``): each pass's request size by the
   /32 rule, its mask the dilated hole mask, the stub's reply in the
   cloud;
10. runs the Mask R-CNN path with the exact fill,
   ``KenBurnsConfig(detector='maskrcnn', discfill_mode='exact')``, with
   the seeded Mask R-CNN set so that detections survive
   (``edged_maskrcnn``): K11, K14a and K14b launched and K3 did not,
   the instances, the disparity, the frames and 3 of them against the
   CPU; holds K11 bit for bit against its plain version on 8 of the
   clip's own frames and times it there; records the K14 calls of one
   detector forward on the image (``maskrcnn_inputs``: the RPN's and
   the detection's NMS, the box and mask heads' RoIAligns) and holds
   K14a and K14b against their plain versions there, with their device
   times, device time by kernel and bounds (K14a's by the pyramid rows
   its samples touch, ``roi_cost``; K14b's walk's tiles,
   ``nms_walk_tiles``);
11. runs Mask R-CNN in f32 on the card and on the CPU
   (``compare_maskrcnn``: the CPU machinery on the card's outputs exact,
   the whole detector's detections the same set within the stated
   tolerances), then
   ``run_segmentation --detector maskrcnn`` on the card with those
   weights, whose RLEs must decode to the masks exactly;
12. runs the shipped default with the CRF depth refine,
   ``KenBurnsConfig(refine_crf=True)``, with the edged detector: K12a
   and K12b launched (one k-means and one K12b call a segment; the
   crops' sizes printed), K12a on each crop's guide against its plain
   version (>= 99.9% of labels) and its device time summed over the
   crops (their inputs kept on a replay of the clip's refine after the
   timed run), the instances, the frames and 3 of them
   against the CPU, then refine_depth_crf on the clip's
   own image, disparity and instances on the card and on the CPU;
13. runs refine_depth_crf on a layered disparity over the image's shapes
   (at least 5 segments reach the CRF), card against CPU;
14. builds the full-width danbooru tagger (SwinV2-B at 448, 9083
   classes, random from the seed), saves it as a timm checkpoint with a
   synthetic tag CSV, loads it through ``AnimeInsSeg.init_tagger`` and
   tags the detector's instances with ``infer_tags`` (24 K15b launches
   an instance), then one crop card against CPU;
15. runs the style flow, ``StyleEditor.repaint`` at long side 768 with
   that detector and tagger against a stub sd-webui server on
   127.0.0.1: K13a and K13b launched, one img2img and one inpaint an
   instance, the card's background fill against the CPU's, and K13a's
   and K13b's device times on that fill's inputs;
16. runs the detector-free clip at 683x1024 (H % 4 != 0), which
   streams BGR chunks: the frames, the clip's frame count, no I420;
   then ``run_kenburns --verbose --trace-dir`` in a subprocess (the
   stage images, CUDA kernel events in the trace) and ``stream_video``
   of frames on the card against ``write_video`` (``cli_phase``);
17. prints one {"kernels": [...]} line, then the card line and the
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
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth,
# f32 rate outside the tensor cores and the dense TF32 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12
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


def make_image(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """h x w (576x1024) BGR uint8: smooth gradients plus a few shapes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([
        128 + 90 * np.sin(xx / 97 + ph[0]) * np.cos(yy / 61),
        128 + 90 * np.cos(xx / 53 + ph[1]) * np.sin(yy / 43 + ph[2]),
        128 + 90 * np.sin((xx + yy) / 71)], -1)
    for _ in range(6):
        cx, cy = rng.uniform(100, w - 100), rng.uniform(80, h - 80)
        r = rng.uniform(30, 90)
        col = rng.uniform(0, 255, 3)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = col
    x0, y0 = int(rng.uniform(50, w - 300)), int(rng.uniform(50, h - 200))
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


def bound_tc(n_bytes: float, product_flops: float, other_flops: float):
    """(bound_ms, bound_by, bound_unit, bound_ms_simt) of a kernel whose
    products run on the tensor cores in 3xTF32: the largest of bytes
    over HBM bandwidth, 3 x the products' operations over the TF32 peak
    (three passes make an f32-accurate product) and the other
    operations over the f32 peak. bound_by is 'bytes' or 'operations'
    (the kernels line's two values), bound_unit names what binds
    ('tensor cores (3xTF32)' for the products); bound_ms_simt is the
    bound with every operation on the f32 peak (``bound``)."""
    t = {'bytes': n_bytes / PEAK_BYTES_S * 1e3,
         'tensor cores (3xTF32)': 3 * product_flops / PEAK_TF32_S * 1e3,
         'CUDA cores (f32)': other_flops / PEAK_F32_S * 1e3}
    unit = max(t, key=t.get)
    by = 'bytes' if unit == 'bytes' else 'operations'
    return t[unit], by, unit, bound(n_bytes, product_flops + other_flops)[0]


def graph_ms(fn, x, reps: int = 10, calls: int = 10) -> float:
    """Device time of one fn(x), host dispatch excluded: ``calls``
    calls of fn captured in one CUDA graph, the graph replayed reps
    times between two events, the time over reps x calls. A graph of
    one call replayed back to back measures the host's replay rate
    (~13 µs a replay on the H100's machine), not a kernel of a few µs
    (the laplacian, the fill, K15b's small stages)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(x)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def no_host_sync(fn, tag: str):
    """fn() under torch's sync debug mode 'error': a host sync inside
    it (an item(), a nonzero, a copy to the host) raises and fails the
    run. Returns what fn returns."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = fn()
    except RuntimeError as e:
        fail(f'{tag}: synchronises with the host: {e}')
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def host_us(fns: dict, n: int = 1000, rounds: int = 5) -> dict:
    """Host clock (perf_counter) over n calls of each fn back to back
    with no sync inside, in µs a call: the median of ``rounds`` runs,
    the fns taken in turns within each round and the card drained
    between runs."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times[k].append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def host_phase(dev) -> dict:
    """[host]: the host's cost of one kernel call, taken apart, at
    576x1024x1 (the laplacian of the validity mask), in µs a call over
    1,000 calls: the whole ``laplacian_filter``; ``_cuda.launch`` alone;
    the bare ctypes call with its argtypes bound once, through the
    port's ``PyDLL`` handle and through a ``CDLL`` one (which drops the
    GIL); ``stream_ptr`` and the ``torch.cuda.Stream`` route to the same
    handle; ``torch.empty_like``; a C entry point that returns at once
    (``kb_noop``, both handles); ``torch.neg`` on the same tensor as
    the yardstick of one PyTorch op; the bare call of the same source
    linked against the shared CUDA runtime (``-cudart shared``, which
    loads the libcudart torch has loaded) in place of nvcc's static
    one. Then the floor of ``time_ms``: a pair of CUDA events around
    nothing."""
    import ctypes
    from cartoonsegmentation_torch.ops import _cuda, filters
    x = torch.rand((H, W, 1), device=dev)
    out = torch.empty_like(x)
    so = _cuda.lib('laplacian')
    args = (x.data_ptr(), 1, H, W, 1, out.data_ptr(), _cuda.stream_ptr(x))
    entry = getattr(so, _cuda.SIGNATURES['laplacian'][0])
    cdll = ctypes.CDLL(so._name)
    bare_c = getattr(cdll, _cuda.SIGNATURES['laplacian'][0])
    shared = _cuda._lib_path('laplacian').with_suffix('.cudart-shared.so')
    if not shared.exists():
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-cudart',
                        'shared', '-o', str(shared),
                        str(_cuda.CSRC / 'laplacian.cu')], check=True,
                       capture_output=True)
    bare_s = getattr(ctypes.PyDLL(str(shared)),
                     _cuda.SIGNATURES['laplacian'][0])
    for f in (bare_c, bare_s):
        f.restype, f.argtypes = entry.restype, entry.argtypes
    with open('/proc/self/maps') as maps:
        cudart = sorted({ln.split()[-1] for ln in maps if 'libcudart' in ln})
    print(f'[host] libcudart loaded: {cudart}', flush=True)
    noop, noop_c = so.kb_noop, cdll.kb_noop
    for f in (noop, noop_c):
        f.restype, f.argtypes = ctypes.c_int, []
    res = host_us({
        'laplacian_filter': lambda: filters.laplacian_filter(x),
        '_cuda.launch': lambda: _cuda.launch('laplacian', *args),
        'ctypes call, PyDLL (argtypes bound once)': lambda: entry(*args),
        'ctypes call, CDLL (argtypes bound once)': lambda: bare_c(*args),
        'ctypes call, PyDLL, -cudart shared': lambda: bare_s(*args),
        'stream_ptr': lambda: _cuda.stream_ptr(x),
        'torch.cuda.current_stream(dev).cuda_stream':
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        'torch.empty_like': lambda: torch.empty_like(x),
        'kb_noop, PyDLL': noop,
        'kb_noop, CDLL': noop_c,
        'torch.neg': lambda: torch.neg(x),
    })
    for k, us in res.items():
        print(f'[host] {k}: {us:.2f} µs a call', flush=True)
    xs = [torch.rand((H, W, 1), device=dev) for _ in range(RUNS)]
    res['event pair'] = 1e3 * time_ms(lambda v: None, xs)
    print(f'[host] time_ms around nothing (its floor): '
          f'{res["event pair"]:.2f} µs', flush=True)
    return res


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


def synthetic_coverage_inputs(pts, depth, span: float = 100.0) -> tuple:
    """K2's arguments on the synthetic cloud as the autozoom passes
    them: the stride-2 miniature of its grid, the 16 x 16 candidate
    shifts over +-span px, a 288x512 raster at focal 256."""
    from cartoonsegmentation_torch.ops import camera
    dev = pts.device
    mini = pts[:H * W].reshape(H, W, 3)[::2, ::2].reshape(-1, 3).contiguous()
    dr = camera.depth_range(depth)
    lin = torch.linspace(-span, span, 16)
    shifts = camera.compute_shift(dr, lin.repeat(16).to(dev),
                                  lin.repeat_interleave(16).to(dev),
                                  dr.min_val, dr.min_val * 0.8, W, H, 512.0)
    return mini, shifts.contiguous(), H // 2, W // 2, 256.0, 40.0


def synthetic_fills(pts, col, frames_pts) -> list:
    """K3's inputs, (render, depth), of the synthetic cloud at each of
    the shifted clouds ``frames_pts``: the far shifts leave a band of
    holes along the frame's border."""
    from cartoonsegmentation_torch.ops import pointcloud
    data4 = torch.cat([col, pts[:, 2:3]], 1).contiguous()
    fills = []
    for p in frames_pts:
        r, w = pointcloud.render_pointcloud(p, data4, H, W, 512.0, 40.0)
        fills.append((r.contiguous(),
                      (r[..., 3] * (w[..., 0] > 0)).contiguous()))
    return fills


def fill_walks(depths) -> dict:
    """K3 inputs' holes and walks, over the depth maps ``depths``: the
    mean hole share, and the gap of each hole's winning direction (the
    distance between its two endpoints, as the plain version picks it)
    over the holes that have one: the mean of each map's mean, the
    largest, and the mean share of holes with none."""
    from cartoonsegmentation_torch.ops import discfill3 as d3
    share, means, top, none = [], [], 0.0, []
    for depth in depths:
        best = d3.fill_winners_plain(depth)[0]
        hole = depth <= 0
        gap = best[hole & (best < d3.BIG)].sqrt()
        share.append(float(hole.float().mean()))
        means.append(float(gap.mean()) if gap.numel() else 0.0)
        top = max(top, float(gap.max()) if gap.numel() else 0.0)
        none.append(1.0 - gap.numel() / max(int(hole.sum()), 1))
    return dict(hole_share=statistics.mean(share),
                gap_mean=statistics.mean(means), gap_max=top,
                no_gap_share=statistics.mean(none))


def real_fill_inputs(pipe, n: int = 8) -> list:
    """K3's inputs, (render, depth), in n frames of the pipeline's last
    clip, evenly over it, as its frame loop renders them."""
    state = pipe.last_state
    obj_from, obj_to = pipe.last_boxes
    seen = []
    fill = pipe._fill

    def capture(img, depth):
        seen.append((img.clone(), depth.clone()))
        return fill(img, depth)
    pipe._fill = capture
    try:
        pipe.render_frames(state, obj_from, obj_to,
                           list(np.linspace(0.0, 1.0, n)),
                           return_device=True)
    finally:
        del pipe._fill
    return seen[1:]     # the first is the focal planes' render of t = 0


def check_fill_real(inputs: list) -> dict:
    """K3 on the shipped default clip's own frames: bit-exact against
    its plain version on each, its ms over them, its device time (the
    median over the frames of ``graph_ms``), their holes and walks."""
    from cartoonsegmentation_torch.ops import discfill3
    for i, x in enumerate(inputs):
        fk = discfill3.fill_disocclusion(*x)
        fp = discfill3.fill_disocclusion_plain(*x)
        if not torch.equal(fk, fp):
            fail(f'fill on real frame {i} differs at '
                 f'{int((fk != fp).any(-1).sum())} pixels')
    ms = time_ms(lambda x: discfill3.fill_disocclusion(*x),
                 inputs + inputs[:2])
    dev_ms = statistics.median(
        graph_ms(lambda x: discfill3.fill_disocclusion(*x), x)
        for x in inputs)
    out = dict(ms=ms, device_ms=dev_ms, frames=len(inputs),
               **fill_walks([x[1] for x in inputs]))
    print(f'[kernel] discfill on {len(inputs)} frames of the shipped '
          f'default clip ({out["hole_share"]:.3%} holes, gap mean '
          f'{out["gap_mean"]:.2f} max {out["gap_max"]:.2f} px, '
          f'{out["no_gap_share"]:.3%} of holes without one): kernel '
          f'{ms:.4f} ms (device {dev_ms:.4f} ms), bit-exact', flush=True)
    return out


def exact_fill_bytes(h: int, w: int, c: int) -> int:
    """K11's bytes: the image read and written once, the depth read
    once (the walks' re-reads of the depth are not counted)."""
    return h * w * (4 * c + 4 + 4 * c)


def band_fill(x: tuple, width: int = 24) -> tuple:
    """A fill input (render, depth) with a band of holes ``width`` px
    wide along the whole border: K3's slow case, where the holes of the
    band walk long lines along it."""
    img, depth = x[0].clone(), x[1].clone()
    for t in (depth[:width], depth[-width:], depth[:, :width],
              depth[:, -width:]):
        t.zero_()
    img[depth <= 0] = 0.0
    return img, depth


def holes_only(x: tuple) -> tuple:
    """A fill input of the render's size with every pixel a hole: every
    half-line walks to the frame's edge or its last step."""
    return x[0].clone(), torch.zeros_like(x[1])


def check_exact_fill(inputs: list, tag: str, steps: int = 128) -> dict:
    """K11 on ``inputs`` ((render, depth) pairs): bit-exact against its
    plain version on each, its ms over them and its device time (the
    median over the inputs of ``graph_ms``; each input's and their sum
    kept), their hole share, and the bound of one call."""
    from cartoonsegmentation_torch.ops import discfill
    for i, x in enumerate(inputs):
        fk = discfill.fill_disocclusion(*x, steps)
        fp = discfill.fill_disocclusion_plain(*x, steps)
        if not torch.equal(fk, fp):
            fail(f'exact fill, {tag} {i}: differs at '
                 f'{int((fk != fp).any(-1).sum())} pixels')
    ms = time_ms(lambda x: discfill.fill_disocclusion(*x, steps),
                 (inputs * RUNS)[:max(RUNS, len(inputs))])
    each = [graph_ms(lambda x: discfill.fill_disocclusion(*x, steps), x)
            for x in inputs]
    h, w, c = inputs[0][0].shape
    b, by = bound(exact_fill_bytes(h, w, c), 0)
    holes = statistics.mean(float((x[1] <= 0).float().mean())
                            for x in inputs)
    dev_ms = statistics.median(each)
    print(f'[kernel] discfill_exact on {tag} ({len(inputs)} inputs, '
          f'{holes:.3%} holes, {steps} steps): kernel {ms:.4f} ms (device '
          f'{dev_ms:.4f} ms, each {" ".join(f"{t:.4f}" for t in each)}), '
          f'bound {b:.4f} ms ({by}), bit-exact', flush=True)
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                device_ms_sum=sum(each), bound_ms=b, bound_by=by,
                hole_share=holes, inputs=len(inputs))


def real_coverage_inputs(pipe) -> tuple:
    """K2's arguments in the pipeline's last clip: the autozoom's
    stride-2 miniature of ``state.raw_points`` and its 256 candidate
    shifts, as ops/camera.py:autozoom passes them, recorded by running
    the clip's autozoom stage again."""
    from cartoonsegmentation_torch.ops import camera
    seen = []
    cover = camera.coverage

    def capture(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args))
        return cover(*args)
    camera.coverage = capture
    try:
        pipe.autozoom(pipe.last_state)
    finally:
        camera.coverage = cover
    return seen[0]


def check_coverage_real(args: tuple) -> dict:
    """K2 on the shipped default clip's own autozoom input: its counts
    equal to the plain version's, its ms and its device time."""
    from cartoonsegmentation_torch.ops import pointcloud
    pts, shifts, h, w = args[:4]
    ck = pointcloud.coverage(*args)
    cp = pointcloud.coverage_plain(*args)
    if not torch.equal(ck, cp):
        fail(f'coverage on the clip\'s miniature differs at '
             f'{int((ck != cp).sum())} of {len(ck)} candidates')
    ms = time_ms(lambda a: pointcloud.coverage(*a), [args] * RUNS)
    dev_ms = graph_ms(lambda a: pointcloud.coverage(*a), args)
    N, K = pts.shape[0], shifts.shape[0]
    valid = int((pts[:, 2] >= 0.001).sum())
    b, by = bound(N * 12 + K * 16, K * N * 25)
    out = dict(ms=ms, device_ms=dev_ms, bound_ms=b, bound_by=by, points=N,
               valid_points=valid, candidates=K, raster=f'{h}x{w}',
               max_abs_err=0.0)
    print(f'[kernel] coverage on the shipped default clip\'s miniature '
          f'(N={N}, {valid} with z >= 0.001, K={K}, {h}x{w}): kernel '
          f'{ms:.4f} ms (device {dev_ms:.4f} ms), bound {b:.4f} ms ({by}), '
          f'counts exact', flush=True)
    return out


def check_kernels(dev, gen: torch.Generator) -> dict:
    """Step 2: every kernel against its plain version at the main
    path's shapes. Returns per-kernel results."""
    from cartoonsegmentation_torch.ops import bokeh, discfill3, pointcloud
    from cartoonsegmentation_torch.ops.pointcloud import shift_points
    from cartoonsegmentation_torch.pipeline.depth import colorize_gray_r
    res = {}
    P4 = 11 * (1 << 16)                       # ~ the compacted cloud
    pts, col, depth = synthetic_cloud(gen, dev, P4)
    shifts = [torch.tensor([0.4 * i - 2.0, 0.25 * i - 1.0, 3.0 * i - 15.0],
                           device=dev) for i in range(RUNS)]
    frames_pts = [shift_points(pts, s).contiguous() for s in shifts]
    n_valid = int((frames_pts[0][:, 2] >= 0.001).sum())

    # --- K1 splat, C = 4 (frame loop) and C = 68 (Inpaint); C = 4 again
    # with 4,096 copies of one point in front, as the main path's cloud
    # holds them (an inpainting pass appends one for each hole pixel of
    # invalid disparity, all at -shift) -------------------------------
    copies = pts.clone()
    copies[H * W:H * W + 4096] = torch.tensor([-3.0, 2.0, 120.0],
                                              device=dev)
    copies = [shift_points(copies, s).contiguous() for s in shifts]
    for tag, C, pts_in in (('c4', 4, frames_pts),
                           ('c68', 68, [p[:H * W].contiguous()
                                        for p in frames_pts]),
                           ('c4_copies', 4, copies)):
        P = pts_in[0].shape[0]
        data = torch.rand((P, C), generator=gen).to(dev) if C == 68 \
            else torch.cat([col, pts[:, 2:3] / 500.0], 1).contiguous()
        rk, wk, zk = pointcloud.splat(pts_in[0], data, H, W, 512.0, 40.0)
        rp, wp, zp = pointcloud.splat_plain(pts_in[0], data, H, W, 512.0,
                                            40.0)
        torch.cuda.synchronize()
        if not torch.equal(zk, zp):
            fail(f'splat {tag}: z-buffer differs from the plain version '
                 f'at {int((zk != zp).sum())} pixels')
        if not torch.equal(wk > 0, wp > 0):
            fail(f'splat {tag}: w > 0 mask differs at '
                 f'{int(((wk > 0) != (wp > 0)).sum())} pixels')
        # f32 atomics sum in another order than index_add_
        err = max(float((rk - rp).abs().max()), float((wk - wp).abs().max()))
        if not (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5)
                and torch.allclose(wk, wp, rtol=1e-4, atol=1e-5)):
            fail(f'splat {tag}: sums differ by {err}')
        no_host_sync(lambda: pointcloud.splat(pts_in[1], data, H, W, 512.0,
                                              40.0), f'splat {tag}')
        nv = int((pts_in[0][:, 2] >= 0.001).sum())
        nbytes = nv * (12 + 4 * C) + (P - nv) * 4 + H * W * 4 * (C + 2)
        # projection 10, corners 12, per corner (C + 1) mul + add
        flops = nv * (22 + 4 * 2 * (C + 1))
        ms = time_ms(
            lambda x: pointcloud.splat(x, data, H, W, 512.0, 40.0), pts_in)
        plain_ms = time_ms(lambda x: pointcloud.splat_plain(
            x, data, H, W, 512.0, 40.0), pts_in)
        dev_ms = graph_ms(
            lambda x: pointcloud.splat(x, data, H, W, 512.0, 40.0), pts_in[0])
        b, by = bound(nbytes, flops)
        res[f'splat_{tag}'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by, device_ms=dev_ms)
        print(f'[kernel] splat {tag} P={P}: kernel {ms:.4f} ms (device '
              f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms '
              f'({by}), max err {err:.3g}', flush=True)

    # --- K2 coverage: 256 candidates on the stride-2 miniature --------
    # RUNS candidate grids, each a little narrower than the last
    cover = [synthetic_coverage_inputs(pts, depth, 100.0 - i)
             for i in range(RUNS)]
    mini, _, h, w, focal, baseline = cover[0]
    cand = [c[1] for c in cover]
    ck = pointcloud.coverage(*cover[0])
    cp = pointcloud.coverage_plain(*cover[0])
    if not torch.equal(ck, cp):
        fail(f'coverage counts differ at {int((ck != cp).sum())} of 256 '
             f'candidates')
    N, K = mini.shape[0], 256
    nbytes = N * 12 + K * 12 + K * 4
    flops = K * N * 25   # shift 7, projection 8, corners 10
    ms = time_ms(lambda s: pointcloud.coverage(
        mini, s, h, w, focal, baseline), cand)
    plain_ms = time_ms(lambda s: pointcloud.coverage_plain(
        mini, s, h, w, focal, baseline), cand)
    dev_ms = graph_ms(lambda x: pointcloud.coverage(*x), cover[0])
    b, by = bound(nbytes, flops)
    res['coverage'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, device_ms=dev_ms)
    print(f'[kernel] coverage N={N} K={K}: kernel {ms:.4f} ms (device '
          f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms '
          f'({by}), counts exact', flush=True)

    # --- K3 fill: real splat renders with disocclusions ---------------
    fills = synthetic_fills(pts, col, frames_pts)
    for x in fills:
        fk = discfill3.fill_disocclusion(*x)
        fp = discfill3.fill_disocclusion_plain(*x)
        if not torch.equal(fk, fp):
            fail(f'fill differs at {int((fk != fp).any(-1).sum())} pixels')
    no_host_sync(lambda: discfill3.fill_disocclusion(*fills[1]), 'discfill')
    nbytes = H * W * (4 * 4 + 4 + 4 * 4)
    ms = time_ms(lambda x: discfill3.fill_disocclusion(*x), fills)
    plain_ms = time_ms(lambda x: discfill3.fill_disocclusion_plain(*x),
                       fills)
    dev_ms = statistics.median(
        graph_ms(lambda x: discfill3.fill_disocclusion(*x), x) for x in fills)
    b, by = bound(nbytes, 0)
    walks = fill_walks([x[1] for x in fills])
    holes = walks['hole_share']
    res['discfill'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, device_ms=dev_ms,
                           **walks)
    print(f'[kernel] discfill {H}x{W}, {len(fills)} renders ({holes:.3%} '
          f'holes, gap mean {walks["gap_mean"]:.2f} max '
          f'{walks["gap_max"]:.2f} px): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), bit-exact',
          flush=True)

    # --- K11 exact fill: the same renders, the ray march of 128 steps;
    # a frame of holes only and a render with a band of holes along the
    # border --------------------------------------------------------------
    from cartoonsegmentation_torch.ops import discfill
    plain_ms = time_ms(lambda x: discfill.fill_disocclusion_plain(*x, 128),
                       fills[:3])
    res['discfill_exact'] = dict(check_exact_fill(fills, 'the renders'),
                                 plain_ms=plain_ms)
    # after the first call of a step count, which copies its table
    no_host_sync(lambda: discfill.fill_disocclusion(*fills[1], 128),
                 'discfill_exact')
    for tag, x in (('holes_only', holes_only(fills[0])),
                   ('band', band_fill(fills[0]))):
        r = check_exact_fill([x], tag.replace('_', ' '))
        res['discfill_exact'].update({f'{k}_{tag}': r[k] for k in (
            'ms', 'device_ms', 'bound_ms')})

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
    no_host_sync(lambda: bokeh.bokeh_core(*bok[1], 13.0, 32), 'bokeh')
    nbytes = H * W * (12 + 4 + 12)
    # per pixel and pass: 32 samples x (2 mul, 2 rounds of 3, 7
    # accumulate) = 480, plus 6 pows (~20 each) and the divides
    flops = H * W * (3 * 480 + 6 * 20 + 12)
    ms = time_ms(lambda x: bokeh.bokeh_core(*x, 13.0, 32), bok)
    plain_ms = time_ms(lambda x: bokeh.bokeh_core_plain(*x, 13.0, 32), bok)
    dev_ms = graph_ms(lambda x: bokeh.bokeh_core(*x, 13.0, 32), bok[0])
    b, by = bound(nbytes, flops)
    res['bokeh'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b, bound_by=by, device_ms=dev_ms)
    print(f'[kernel] bokeh {H}x{W}: kernel {ms:.4f} ms (device {dev_ms:.4f} '
          f'ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), max err '
          f'{err:.3g}', flush=True)

    filled = [discfill3.fill_disocclusion(*f) for f in fills]
    depth_maps = [colorize_gray_r(f[..., 3]) for f in filled]
    existing = [(w > 0).float()[..., None].contiguous()
                for _, w in fills]
    res.update(check_detector_kernels(dev, gen, depth_maps, existing))
    res.update(check_frame_kernels(dev, filled))
    res.update(check_samattn(dev, gen))
    res.update(check_k14(synthetic_k14(gen, dev), 'synthetic'))
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


def synthetic_k14(gen, dev) -> dict:
    """K14's synthetic calls at the Mask R-CNN path's shapes, as
    ``maskrcnn_inputs`` records them: K14a at the box head's (1000,
    7x7) and the mask head's (100, 14x14) over three random 768x1344
    pyramids; K14b at the RPN's K = 4,756 (IoU 0.7, 1000 out, level
    offsets) and the detection's K = 2,048 (IoU 0.5, 100 out, class
    offsets), clustered boxes with tied scores, -inf present."""
    from cartoonsegmentation_torch.models import maskrcnn
    C = 256
    pyrs = [maskrcnn.flatten_pyramid([
        torch.randn((1, C, h, w), generator=gen).to(dev)
        for h, w in CANVAS_LEVELS]) for _ in range(3)]
    seen = {f'roi{out}': [(p, rpn_like_boxes(gen, n).to(dev), out)
                          for p in pyrs] for n, out in ((1000, 7), (100, 14))}
    sizes = (1000, 1000, 1000, 1000, 756)
    for K, thr, n_out, tag in ((4756, 0.7, 1000, 'rpn'),
                               (2048, 0.5, 100, 'det')):
        seen[tag] = []
        for _ in range(RUNS):
            boxes, scores = nms_case(gen, K)
            boxes = boxes * 2.0
            scores[torch.rand((K,), generator=gen) < 0.1] = -float('inf')
            cats = torch.cat([torch.full((k,), i, dtype=torch.int32)
                              for i, k in enumerate(sizes)]) \
                if tag == 'rpn' else torch.randint(1, 91, (K,),
                                                   generator=gen,
                                                   dtype=torch.int32)
            seen[tag].append((boxes.to(dev), scores.to(dev), cats.to(dev),
                              thr, n_out))
    return seen


def maskrcnn_inputs(net, img: np.ndarray) -> dict:
    """The K14 calls of one Mask R-CNN detector forward (``net`` on the
    card, ``MaskRCNNDetector.infer`` of the BGR ``img``), recorded as
    they are made: 'rpn' and 'det', the RPN's and the detection's
    ``batched_nms_fixed`` arguments (boxes, scores, categories, IoU
    threshold, outputs); 'roi7' and 'roi14', the box and mask heads'
    ``roi_align_pyramid`` arguments (pyramid, boxes, out). Each a list
    of one call."""
    from cartoonsegmentation_torch.models import maskrcnn
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import \
        MaskRCNNDetector
    seen = {'rpn': [], 'det': [], 'roi7': [], 'roi14': []}
    nms, roi = maskrcnn.batched_nms_fixed, maskrcnn.roi_align_pyramid

    def rec_nms(boxes, scores, cats, thr, n_out):
        seen['rpn' if n_out > 100 else 'det'].append(
            (boxes.clone(), scores.clone(), cats.clone(), thr, n_out))
        return nms(boxes, scores, cats, thr, n_out)

    def rec_roi(pyr, boxes, out, sampling=2):
        seen[f'roi{out}'].append((pyr, boxes.clone(), out))
        return roi(pyr, boxes, out, sampling)
    maskrcnn.batched_nms_fixed, maskrcnn.roi_align_pyramid = rec_nms, rec_roi
    try:
        MaskRCNNDetector(capacity=100, model=net, device='cuda').infer(img)
    finally:
        maskrcnn.batched_nms_fixed, maskrcnn.roi_align_pyramid = nms, roi
    return seen


def load_maskrcnn_inputs(path: str, dev) -> dict:
    """The K14 calls that ``render_kernel_times.py --save-maskrcnn-inputs``
    saved, on ``dev``, in ``maskrcnn_inputs``' layout (a list of calls
    under each key, one a forward)."""
    from cartoonsegmentation_torch.models import maskrcnn
    seen = {'rpn': [], 'det': [], 'roi7': [], 'roi14': []}
    for rec in torch.load(path):
        pyr = maskrcnn.Pyramid(rec['pyr'][0].to(dev),
                               tuple(map(tuple, rec['pyr'][1])))
        for tag in ('rpn', 'det'):
            b, s, c, thr, n_out = rec[tag]
            seen[tag].append((b.to(dev), s.to(dev), c.to(dev), thr, n_out))
        for out in (7, 14):
            seen[f'roi{out}'].append((pyr, rec[f'roi{out}'].to(dev), out))
    return seen


def roi_cost(pyr, boxes: torch.Tensor, out: int, sampling: int = 2):
    """K14a's (bytes, operations, bytes counting the whole pyramid): the
    distinct pyramid rows that the in-bounds samples' four taps read
    (C floats each), the boxes and the (N, C, out, out) output; per
    output value 4 samples of 4 taps (a multiply-add each) and their 4
    weights."""
    from cartoonsegmentation_torch.models import maskrcnn
    dev = boxes.device
    C = pyr.flat.shape[1]
    N = boxes.shape[0]
    lv = maskrcnn.roi_levels(boxes).long()
    hw = torch.tensor(pyr.sizes, device=dev)
    Hn, Wn = hw[lv, 0], hw[lv, 1]
    base = (torch.cumsum(hw[:, 0] * hw[:, 1], 0) - hw[:, 0] * hw[:, 1])[lv]
    scale = 1.0 / torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)[lv]
    idx = (torch.arange(out * sampling, device=dev) + 0.5) / sampling

    def taps(lo, hi, n):
        v = (lo * scale)[:, None] + idx * (torch.clamp(
            hi * scale - lo * scale, min=1.0) / out)[:, None]
        oob = (v < -1.0) | (v > n[:, None])
        i0 = torch.minimum(v.clamp(min=0.0).long(), (n - 1)[:, None])
        return oob, i0, torch.minimum(i0 + 1, (n - 1)[:, None])
    oy, y0, y1 = taps(boxes[:, 1], boxes[:, 3], Hn)
    ox, x0, x1 = taps(boxes[:, 0], boxes[:, 2], Wn)
    rows = [base[:, None, None] + y[:, :, None] * Wn[:, None, None]
            + x[:, None, :] for y in (y0, y1) for x in (x0, x1)]
    keep = ~(oy[:, :, None] | ox[:, None, :])
    n_rows = int(torch.unique(torch.stack(rows, -1)[keep]).numel()) \
        if N else 0
    tail = N * 16 + N * C * out * out * 4
    return (n_rows * C * 4 + tail, N * C * out * out * 4 * 12,
            pyr.flat.shape[0] * C * 4 + tail)


def nms_cost(K: int, n_out: int):
    """K14b's (bytes, operations): boxes, scores and categories read,
    the outputs written; the IoUs of the upper triangle, ~12 operations
    each."""
    return K * 20 + n_out * 9, K * (K - 1) / 2 * 12


def k14_calls(seen: dict) -> list:
    """K14's four calls on recorded inputs (``synthetic_k14``,
    ``maskrcnn_inputs``): [(tag, kernel, plain, inputs, costs)], costs
    the (bytes, operations) of each input's call."""
    from cartoonsegmentation_torch.models import maskrcnn, rtmdet

    def nms(x):
        return maskrcnn.batched_nms_fixed(*x)

    def nms_plain(x):
        boxes, scores, cats, thr, n_out = x
        extent = boxes.max() + 1.0
        return rtmdet.nms_fixed_plain(
            boxes + (cats.float() * extent)[:, None], scores, thr, n_out)

    def roi(x):
        return maskrcnn.roi_align_pyramid(*x)

    def roi_plain(x):
        return maskrcnn.roi_align_pyramid_plain(
            x[0], x[1], maskrcnn.roi_levels(x[1]), x[2])
    calls = []
    for tag in ('rpn', 'det'):
        if seen.get(tag):
            calls.append((f'nms_large {tag}', nms, nms_plain, seen[tag],
                          [nms_cost(x[0].shape[0], x[4]) for x in seen[tag]]))
    for out in (7, 14):
        xs = seen.get(f'roi{out}')
        if xs:
            calls.append((f'roialign {out}', roi, roi_plain, xs,
                          [roi_cost(*x) for x in xs]))
    return calls


def nms_walk_tiles(x) -> tuple:
    """(tiles K14b's walk resolves, tiles) on one call's inputs: the walk
    stops at the tile of the n_out-th kept row scored above -1 in score
    order, where there are n_out of them; else it resolves every tile."""
    from cartoonsegmentation_torch.models import maskrcnn, rtmdet
    boxes, scores, cats, thr, n_out = x
    tiles = -(-boxes.shape[0] // 64)
    idx, keep = maskrcnn.batched_nms_fixed(*x)
    if keep.numel() < n_out or not bool(keep.all()):
        return tiles, tiles
    order = rtmdet._stable_argsort_desc(scores)
    return int((order == idx[-1]).nonzero()[0, 0]) // 64 + 1, tiles


def by_kernel(fn, x, n: int = 10) -> dict:
    """Device ms a call of fn(x) by kernel (and copy or fill), from a
    torch.profiler pass over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n / 1e3
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0}


def check_k14(seen: dict, where: str) -> dict:
    """K14b's keep sets exact and K14a within 1e-5 of the range of its
    plain version's output, on every input of ``k14_calls(seen)``; each
    call's ``ms``, ``device_ms`` (``graph_ms`` of its first input),
    device time by kernel, bound (K14a: the pyramid rows its samples
    touch; ``bound_ms_pyramid`` counts the whole pyramid) and kept
    counts."""
    res = {}
    for tag, fn, plain, xs, costs in k14_calls(seen):
        err, kept = 0.0, []
        for x in xs[:3]:
            got, want = fn(x), plain(x)
            if tag.startswith('nms'):
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    fail(f'{tag} ({where}): keep set differs from the plain '
                         f'version')
                kept.append(int(got[1].sum()))
                continue
            e = float((got - want).abs().max())
            span = float(want.max() - want.min())
            if e > 1e-5 * span:
                fail(f'{tag} ({where}): max err {e:.3g} above 1e-5 of '
                     f'{span:.3g}')
            err = max(err, e)
        ms = time_ms(fn, xs * max(1, RUNS // len(xs)))
        plain_ms = time_ms(plain, xs[:3])
        dev_ms = statistics.median(graph_ms(fn, xs[0]) for _ in range(3))
        parts = by_kernel(fn, xs[0])
        b, by = bound(*costs[0][:2])
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                 bound_by=by, device_ms=dev_ms, by_kernel=parts)
        line = ''
        if tag.startswith('nms'):
            r['kept'] = kept
            r['walk_tiles'] = [nms_walk_tiles(x) for x in xs[:3]]
            line = (f'kept {kept}, the walk resolves (tiles, of) '
                    f'{r["walk_tiles"]}, keep sets exact')
        else:
            r['bound_ms_pyramid'] = bound(costs[0][2], costs[0][1])[0]
            line = (f'max err {err:.3g}, bound with the whole pyramid '
                    f'{r["bound_ms_pyramid"]:.4f} ms')
        x = xs[0]
        shape = f'K={x[0].shape[0]} {x[4]} out' if tag.startswith('nms') \
            else f'{x[1].shape[0]} boxes'
        print(f'[kernel] {tag} ({where}, {shape}): kernel {ms:.4f} ms '
              f'(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
              f'{b:.6f} ms ({by}); {line}; by kernel: '
              + ', '.join(f'{v:.4f} {k[:40]}' for k, v in sorted(
                  parts.items(), key=lambda kv: -kv[1])), flush=True)
        res[tag.replace(' ', '_')] = r
    return res


def epilogue_bytes(H: int, W: int, crop_h: int, crop_w: int, out_h: int,
                   out_w: int, i420: bool) -> int:
    """Bytes K5a must move: the crop's colours read once (12 B a pixel),
    with the extra row or column that a half-pixel corner's mean reads,
    and 3 B of BGR (and 1.5 of I420) a pixel written once."""
    fy, fx = (H - crop_h + 1) % 2, (W - crop_w + 1) % 2
    return ((crop_h + fy) * (crop_w + fx) * 12
            + out_h * out_w * (3 + 1.5 * i420))


def check_frame_kernels(dev, filled) -> dict:
    """K5a epilogue, K5b colorize and K10 compaction against their
    plain versions on the filled frames of the render loop."""
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline import depth, state
    from cartoonsegmentation_torch.utils import image
    res = {}
    u8 = torch.uint8

    # --- K5a: the path's crop (crop_ratio 0.97: 558x993 at 576x1024,
    # half-pixel rows) resized to the frame, and a crop at a half-pixel
    # corner kept at its size (556x992), each on the filled frames'
    # view of the (H, W, 4) buffer and on contiguous (H, W, 3) frames
    # (the bokeh's output, the main path's layout) ---------------------
    ch, cw = int(0.97 * H), int(0.97 * W)
    worst, maxd = 1.0, 0
    kept = (H - 20, W - 32)
    blurred = [f[..., :3].contiguous() for f in filled]
    for crop, out in (((ch, cw), (H, W)), (kept, kept)):
        for f in [f[..., :3] for f in filled[:3]] + blurred[:3]:
            bgr = torch.empty((*out, 3), dtype=u8, device=dev)
            i420 = torch.empty((out[0] * 3 // 2, out[1]), dtype=u8,
                               device=dev)
            got = image.frame_epilogue(f, *crop, *out, bgr, i420)
            want = image.frame_epilogue_plain(f, *crop, *out)
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
    # the frame loop's path: one plan a clip, checked once
    plan = image.EpiloguePlan(ch, cw, H, W)
    plan.outputs(bgr[None], i420[None])
    plan(blurred[0], 0)
    if not torch.equal(bgr, image.frame_epilogue(blurred[0], ch, cw, H, W)):
        fail('epilogue: EpiloguePlan differs from frame_epilogue')
    ms = time_ms(lambda f: image.frame_epilogue(f[..., :3], ch, cw, H, W,
                                                bgr, i420), filled)
    plan_ms = time_ms(lambda f: plan(f, 0), blurred)
    plain_ms = time_ms(lambda f: image.bgr_to_i420(image.frame_epilogue_plain(
        f[..., :3], ch, cw, H, W)[None]), filled)
    # per output value ~42 operations (4 taps of 2 clipped reads and a
    # mean, the bilinear sum, the uint8 step), ~16 a pixel for weights
    # and Y
    dev_ms = statistics.median(graph_ms(lambda f: plan(f[..., :3], 0), f)
                               for f in filled[:3])
    dev_ms_rgb = statistics.median(graph_ms(lambda f: plan(f, 0), f)
                                   for f in blurred[:3])
    b, by = bound(epilogue_bytes(H, W, ch, cw, H, W, True),
                  H * W * (3 * 42 + 16))
    f3 = blurred[0]
    host = host_us({
        'frame_epilogue': lambda: image.frame_epilogue(f3, ch, cw, H, W,
                                                       bgr, i420),
        'EpiloguePlan call': lambda: plan(f3, 0),
        '_cuda.launch': lambda: _cuda.launch(
            'epilogue', f3.data_ptr(), *plan._args, bgr.data_ptr(),
            i420.data_ptr(), _cuda.stream_ptr(f3))}, n=500)
    res['epilogue'] = dict(max_abs_err=float(maxd), ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, bgr_equal=worst,
                           device_ms=dev_ms, device_ms_rgb=dev_ms_rgb,
                           ms_plan_rgb=plan_ms, host_us=host)
    print(f'[kernel] epilogue {H}x{W} crop {ch}x{cw}: kernel {ms:.4f} ms '
          f'(device {dev_ms:.4f} ms on the filled view, {dev_ms_rgb:.4f} '
          f'on contiguous frames; EpiloguePlan {plan_ms:.4f} ms), plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}); BGR max diff {maxd}, '
          f'equal {worst:.6f}; I420 exact', flush=True)
    for k, us in host.items():
        print(f'[host] epilogue {k}: {us:.2f} µs a call', flush=True)

    # --- K5b: the depth channel of the filled frames, read in place ----
    maps = [f[..., 3] for f in filled]
    for x in maps[:3]:
        if not torch.equal(depth.colorize_gray_r(x),
                           depth.colorize_gray_r_plain(x)):
            fail('colorize differs from the plain version')
    ms = time_ms(depth.colorize_gray_r, maps)
    plain_ms = time_ms(depth.colorize_gray_r_plain, maps)
    dev_ms = statistics.median(graph_ms(depth.colorize_gray_r, x)
                               for x in maps[:3])
    b, by = bound(H * W * 8, H * W * 6)   # min, max; sub, div, sub, mul
    res['colorize'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, device_ms=dev_ms)
    print(f'[kernel] colorize {H}x{W}: kernel {ms:.4f} ms (device '
          f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms '
          f'({by}), exact', flush=True)

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
    # the colours in rows of 3, and channel-planar as the inpaint net's
    planar = src[1].t().contiguous().t()
    for P, col in ((2 * M, src[1]), (M + 100000, src[1]),
                   (M + 100000, planar)):
        args = [src[0], col, src[2], src[3]]
        kern = state.PointCloud.with_capacity(P, dev)
        plain = state.PointCloud.with_capacity(P, dev)
        for m in masks:
            kern = no_host_sync(lambda: kern.append_masked(*args, m),
                                'compact')
            state.append_masked_plain(plain, *args, m)
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            if not torch.equal(getattr(kern, k), getattr(plain, k)):
                fail(f'compact: {k} differs from the plain version '
                     f'(capacity {P}, colour strides {col.stride()})')
    del planar
    cloud = state.PointCloud.with_capacity(2 * M, dev)
    one_launch(lambda: state.append_masked_into(cloud, *src, masks[0]),
               'compact')
    clouds = [state.PointCloud.with_capacity(2 * M, dev) for _ in range(RUNS)]
    ms = time_ms(lambda c: state.append_masked_into(c, *src, masks[0]),
                 clouds)
    clouds = [state.PointCloud.with_capacity(2 * M, dev) for _ in range(RUNS)]
    plain_ms = time_ms(lambda c: state.append_masked_plain(c, *src, masks[0]),
                       clouds)
    del clouds
    dev_ms = compact_device_ms(cloud, src, masks[0])
    # the nearest single PyTorch call: boolean-index compaction of the
    # (M, 8) payload, its host sync included (no count offset, no
    # capacity)
    payload = torch.cat([src[0], src[1], src[2][:, None], src[3][:, None]],
                        1).contiguous()
    lib_ms = time_ms(lambda _: payload[masks[0]], [None] * RUNS)
    del payload
    # the mask byte of every entry; 8 payload floats of each set entry
    # read and written once
    b, by = bound(M + M * 64, 0)
    res['compact'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, device_ms=dev_ms,
                          library_ms=lib_ms)
    print(f'[kernel] compact M={M} (all set) into 2M slots: kernel '
          f'{ms:.4f} ms (device {dev_ms:.4f} ms with a 4-byte count reset), '
          f'plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), payload[mask] '
          f'{lib_ms:.4f} ms; exact with an overflow and with planar '
          f'colours, no host sync, one launch', flush=True)
    return res


def compact_device_ms(cloud, src, mask) -> float:
    """K10's device time on a cloud (``graph_ms``): each call first sets
    the count back to 0 (a 4-byte fill inside the timed call), so that
    every call writes the same slots."""
    from cartoonsegmentation_torch.pipeline import state

    def run(_):
        cloud.count.zero_()
        state.append_masked_into(cloud, *src, mask)
    return graph_ms(run, None)


class CompactCalls:
    """Records each K10 call (``state.append_masked_into``) that a clip
    makes: the cloud before it and the call's entries and mask, as
    copies on the card."""

    def __init__(self):
        from cartoonsegmentation_torch.pipeline import state
        self.calls, self.append = [], state.append_masked_into

        def record(cloud, *args):
            self.calls.append((cloud.clone(), [a.clone() for a in args]))
            return self.append(cloud, *args)
        state.append_masked_into = record

    def close(self):
        from cartoonsegmentation_torch.pipeline import state
        state.append_masked_into = self.append


def check_compact_real(calls: list) -> dict:
    """K10 on the shipped default clip's own appends (the prepared cloud,
    then each inpainting pass's hole pixels): each call on a copy of its
    cloud, under the sync debug mode, against the plain version on
    another copy: the slots, their order and the count exact. Device
    time of each (``compact_device_ms``, its cloud's count reset to 0)
    and its bound (the mask and 64 bytes a set entry)."""
    from cartoonsegmentation_torch.pipeline import state
    out = {'set': [], 'device_ms_each': [], 'bound_ms_each': []}
    for i, (cloud, args) in enumerate(calls):
        kern, plain = cloud.clone(), cloud.clone()
        no_host_sync(lambda: state.append_masked_into(kern, *args),
                     'compact (the clip\'s appends)')
        state.append_masked_plain(plain, *args)
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            if not torch.equal(getattr(kern, k), getattr(plain, k)):
                fail(f'compact: the clip\'s append {i}: {k} differs from '
                     f'the plain version')
        n_set = int(args[4].sum())
        start = int(cloud.count)
        work = cloud.clone()
        # the saved count back before each timed call: the same slots
        dev_ms = graph_ms(lambda _: (work.count.fill_(start),
                                     state.append_masked_into(work, *args)),
                          None)
        out['set'].append(n_set)
        out['device_ms_each'].append(dev_ms)
        out['bound_ms_each'].append(bound(args[4].numel() + n_set * 64, 0)[0])
    out['device_ms'] = sum(out['device_ms_each'])
    out['bound_ms'] = sum(out['bound_ms_each'])
    print(f'[kernel] compact on the shipped default clip\'s {len(calls)} '
          f'appends (set {out["set"]}): exact, no host sync; device '
          f'{" ".join(f"{t:.4f}" for t in out["device_ms_each"])} ms (each '
          f'with a 4-byte count fill), bounds '
          f'{" ".join(f"{t:.4f}" for t in out["bound_ms_each"])} ms',
          flush=True)
    return out


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
        # device time alone, host dispatch excluded (CUDA graphs)
        dev_ms = graph_ms(lambda c: sam.rel_pos_attention(*c, side, side),
                          cases[0])
        lib_dev_ms = graph_ms(lambda c: F.scaled_dot_product_attention(
            *c[0], attn_mask=c[1]), lib_cases[0])
        del lib_cases, lib
        # q·k and p·v (2 operations a multiply-add) on the tensor cores;
        # the two bias adds and ~4 of the online softmax a score
        products = B * n * N * N * 4 * hd
        nbytes = 4 * (B * N * 3 * n * hd + B * n * N * 2 * side
                      + B * N * n * hd)
        b, by, unit, b_simt = bound_tc(nbytes, products,
                                       B * n * N * N * 6)
        res[f'samattn_{tag}'] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, bound_unit=unit, bound_ms_simt=b_simt,
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        print(f'[kernel] samattn {tag} B={B} N={N} 12x64: kernel {ms:.4f} '
              f'ms ({ms / lib_ms:.2f}x SDPA; device {dev_ms:.4f} ms, '
              f'{dev_ms / lib_dev_ms:.2f}x SDPA\'s {lib_dev_ms:.4f}), plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms (bound_by: {unit}; '
              f'{b / ms:.1%} of the kernel\'s ms; f32 CUDA cores '
              f'{b_simt:.4f}), SDPA '
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

    # --- K6: 100 instance slots, 60 valid (one of them empty), on the
    # colorized depth and on a map with NaN (bin 0) and ±inf values ----
    masks, valid = instance_masks(gen, dev, 100, 60)
    masks[3] = False
    odd = depth_maps[0].clone()
    pick = torch.rand(odd.shape, generator=gen).to(dev)
    odd[pick < 0.05] = float('nan')
    odd[(pick >= 0.05) & (pick < 0.07)] = float('inf')
    odd[(pick >= 0.07) & (pick < 0.09)] = float('-inf')
    for tag, v in (('the colorized depth', depth_maps[0]),
                   ('NaN and +-inf values', odd)):
        got = depth.masked_median_u8(v, masks, valid)
        want = depth.masked_median_u8_plain(v, masks, valid)
        if not torch.equal(got, want):
            fail(f'masked median on {tag} differs at '
                 f'{int((got != want).sum())} of 100 instances')
    torch.cuda.synchronize()
    if bool(depth._scratch[odd.device.index].any()):
        fail('masked median: a call left its histogram or tickets nonzero')
    n_valid = int(valid.sum())
    nbytes = H * W * 4 + n_valid * H * W + 100 + 100 * 4
    ms = time_ms(
        lambda v: depth.masked_median_u8(v, masks, valid), depth_maps)
    plain_ms = time_ms(
        lambda v: depth.masked_median_u8_plain(v, masks, valid), depth_maps)
    dev_ms = graph_ms(lambda v: depth.masked_median_u8(v, masks, valid),
                      depth_maps[0])
    b, by = bound(nbytes, n_valid * H * W * 3)   # round, clamp, count
    res['insmedian'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            bound_ms=b, bound_by=by, device_ms=dev_ms)
    print(f'[kernel] insmedian 100 slots ({n_valid} valid) at {H}x{W}: '
          f'kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), exact (NaN and '
          f'+-inf values too; scratch left zero)', flush=True)
    res['insmedian']['one_launch'] = one_launch(
        lambda: depth.masked_median_u8(depth_maps[0], masks, valid),
        'insmedian')

    # --- K7: the median-5 of `existing`, the laplacian of a disparity --
    disp = [(d / 255.0)[..., None].contiguous() for d in depth_maps]
    for x in existing[:2] + disp[:2]:
        if not torch.equal(filters.median_filter(x, 5),
                           filters.median_filter_plain(x, 5)):
            fail('median-5 differs from the plain version')
        if not torch.equal(filters.laplacian_filter(x),
                           filters.laplacian_filter_plain(x)):
            fail('laplacian differs from the plain version')
    # taps of NaN of both signs over half the plane, ±inf, ±0: NaN where
    # 13 or more taps are NaN, the sign of a zero free
    x = torch.tensor([-2.5, -0.0, 0.0, 1.0, float('inf'), float('-inf')])[
        torch.randint(0, 6, (1, H, W, 1), generator=gen)]
    nan = torch.rand(x.shape, generator=gen) < 0.5
    x[nan] = torch.tensor([float('nan')]).view(torch.int32).bitwise_or(
        (torch.rand(x.shape, generator=gen)[nan] < 0.5).int()
        * -(1 << 31)).view(torch.float32)
    x = x.to(dev)
    got, want = filters.median_filter(x, 5), filters.median_filter_plain(x, 5)
    same = torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
        got[~torch.isnan(got)], want[~torch.isnan(want)])
    if not same:
        fail('median-5 differs from the plain version on NaN, +-inf and +-0 '
             'taps')
    print(f'[kernel] median5 on NaN (both signs), +-inf and +-0 taps: '
          f'{int(torch.isnan(got).sum())} NaN outputs where the plain '
          f'version has them, the rest equal', flush=True)
    # the median: csrc/median5.cu's networks make 570 integer min/max a
    # run of 8 outputs (71.25 a pixel, 35.6 compare-exchanges, where a
    # median-of-25 selection network needs 99), whose time at the f32
    # rate is below the bytes': the bytes bind. The laplacian: 1
    # multiply, 4 subtracts
    for name, fn, plain, xs, ops in (
            ('median5', lambda x: filters.median_filter(x, 5),
             lambda x: filters.median_filter_plain(x, 5), existing,
             570 / 8),
            ('laplacian', filters.laplacian_filter,
             filters.laplacian_filter_plain, disp, 5)):
        b, by = bound(H * W * 8, H * W * ops)
        ms, plain_ms = time_ms(fn, xs), time_ms(plain, xs)
        res[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by)
        print(f'[kernel] {name} {H}x{W}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}), exact',
              flush=True)
    res['median5']['device_ms'] = graph_ms(
        lambda x: filters.median_filter(x, 5), existing[0])
    print(f'[kernel] median5 device time {res["median5"]["device_ms"]:.4f} '
          f'ms', flush=True)
    res['median5']['one_launch'] = one_launch(
        lambda: filters.median_filter(existing[0], 5), 'median5')
    res['median3'] = check_median3(gen, x, existing, disp)
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
        # device time alone, host dispatch excluded, both in this run
        res['laplacian']['library_device_ms'] = graph_ms(
            lambda x: conv(x.view(1, 1, H, W)), disp[0])
    res['laplacian']['device_ms'] = graph_ms(filters.laplacian_filter,
                                             disp[0])
    lap = res['laplacian']
    print(f'[kernel] laplacian as a cuDNN convolution: '
          f'{lap["library_ms"]:.4f} ms, max err {lib_err:.3g}; device time '
          f'kernel {lap["device_ms"]:.4f} ms, cuDNN '
          f'{lap["library_device_ms"]:.4f} ms '
          f'({lap["device_ms"] / lap["library_device_ms"]:.2f}x)', flush=True)

    # --- K8: the top 512 candidates, ties and overlaps; the signed
    # zeros and NaNs (K14b too) ---------------------------------------
    cases = [tuple(t.to(dev) for t in nms_case(gen)) for _ in range(RUNS)]
    check_nms_signed(gen, dev)
    res['nms'] = check_nms_calls(cases, 'synthetic')
    res['nms']['one_launch'] = one_launch(
        lambda: rtmdet.nms_fixed(*cases[0], 0.6, 100), 'nms')

    # --- K9: 100 instances, 80x80 prototypes → 640x640 masks -----------
    N, h = 100, 80

    def heads_case():
        feat = torch.randn((h, h, 8), generator=gen)
        kern = torch.randn((N, 169), generator=gen)
        pri = torch.randint(0, h, (N, 2), generator=gen).float() * 8
        st = torch.tensor([8.0, 16.0, 32.0])[
            torch.randint(0, 3, (N,), generator=gen)]
        val = torch.rand((N,), generator=gen) < 0.8
        return tuple(t.to(dev) for t in (feat, kern, pri, st, val)) + (
            640, 640, 0.3)
    heads = [heads_case() for _ in range(RUNS)]
    res['maskhead'] = check_maskhead_calls(heads, 'synthetic')
    res['maskhead']['one_launch'] = one_launch(
        lambda: rtmdet.dynamic_masks(*heads[0]), 'maskhead')
    return res


def check_median3(gen, taps, existing, disp) -> dict:
    """K7's 3x3 median (``spatial_filter('median-3')``) against its plain
    version: exact on the Inpaint net's `existing` maps and on
    disparities; on the median-5 check's taps (NaN of both signs, ±inf,
    ±0) NaN where the plain version has NaN and the rest equal (the sign
    of a zero free, as the median-5's); on the same taps with the zeros
    replaced by 1 every non-NaN output bit for bit. Timed as the
    median-5; the bound counts the bytes (each value read and written
    once) against 19 compare-exchanges (38 integer min/max) a pixel."""
    from cartoonsegmentation_torch.ops import filters
    for x in existing[:2] + disp[:2]:
        if not torch.equal(filters.median_filter(x, 3),
                           filters.median_filter_plain(x, 3)):
            fail('median-3 differs from the plain version')
    for tag, x in (('NaN (both signs), +-inf and +-0 taps', taps),
                   ('the same taps without zeros',
                    torch.where(taps == 0, torch.ones_like(taps), taps))):
        got = filters.median_filter(x, 3)
        want = filters.median_filter_plain(x, 3)
        nan = torch.isnan(want)
        same = torch.equal(torch.isnan(got), nan) and (
            torch.equal(got[~nan].view(torch.int32),
                        want[~nan].view(torch.int32)) if tag.endswith(
                            'zeros') else torch.equal(got[~nan], want[~nan]))
        if not same:
            fail(f'median-3 differs from the plain version on {tag}')
        print(f'[kernel] median3 on {tag}: {int(nan.sum())} NaN outputs '
              f'where the plain version has them, the rest '
              f'{"bit for bit" if tag.endswith("zeros") else "equal"}',
              flush=True)
    b, by = bound(H * W * 8, H * W * 38)
    ms = time_ms(lambda x: filters.median_filter(x, 3), existing)
    plain_ms = time_ms(lambda x: filters.median_filter_plain(x, 3), existing)
    dev_ms = graph_ms(lambda x: filters.median_filter(x, 3), existing[0])
    print(f'[kernel] median3 {H}x{W}: kernel {ms:.4f} ms (device '
          f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms '
          f'({by}), exact', flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, device_ms=dev_ms, one_launch=one_launch(
                    lambda: filters.median_filter(existing[0], 3),
                    'median3'))


def signed_scores(gen: torch.Generator, K: int) -> torch.Tensor:
    """Scores in a few values with +0.0, -0.0, NaNs of either sign and
    two payloads, -inf and -1.0 among them: the values whose order
    jnp.argsort canonicalises (-0 as +0, every NaN as +NaN)."""
    bits = torch.tensor([0x00000000, -0x80000000, 0x7fc00000, -0x00400000,
                         0x7f800001, -0x00800000, -0x40800000, 0x3f000000,
                         0x3e800000], dtype=torch.int32)
    return bits[torch.randint(0, len(bits), (K,), generator=gen)].view(
        torch.float32).clone()


def check_nms_signed(gen: torch.Generator, dev) -> None:
    """K8 at K = 512, 97 and 1 and K14b at K = 512 and 2,048 on the
    signed zeros and NaNs: every output slot equal to the plain
    version's."""
    from cartoonsegmentation_torch.models import maskrcnn, rtmdet
    for K, max_out in ((512, 100), (512, 512), (97, 40), (1, 1)):
        boxes = nms_case(gen, max(K, 8))[0][:K].to(dev)
        scores = signed_scores(gen, K).to(dev)
        for fn in (rtmdet.nms_fixed, maskrcnn.nms_large):
            got, want = fn(boxes, scores, 0.6, max_out), \
                rtmdet.nms_fixed_plain(boxes, scores, 0.6, max_out)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                fail(f'{fn.__name__} on +-0 and NaN scores (K={K}, '
                     f'{max_out} out) differs from the plain version')
    boxes = (nms_case(gen, 2048)[0] * 2.0).to(dev)
    scores = signed_scores(gen, 2048).to(dev)
    got = maskrcnn.nms_large(boxes, scores, 0.5, 100)
    want = rtmdet.nms_fixed_plain(boxes, scores, 0.5, 100)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail('nms_large on +-0 and NaN scores (K=2048) differs from the '
             'plain version')
    print('[kernel] nms, nms_large on +-0.0 and NaN scores: keep sets '
          'exact', flush=True)


def graph_ops(fn) -> list:
    """The device operations (kernels, copies, memsets; libcuda's empty
    nodes left out) of one call of fn, after a warm-up call, as the
    nodes of a CUDA graph that captures it (as tests/test_torch_kernels.py
    :_device_ops counts them)."""
    import ctypes
    kinds = {0: 'kernel', 1: 'memcpy', 2: 'memset', 3: 'host',
             10: 'mem_alloc', 11: 'mem_free'}
    cu = ctypes.CDLL('libcuda.so.1')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail('cuGraphGetNodes failed')
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    ops = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 5:
            ops.append(kinds.get(kind.value, f'type {kind.value}'))
    return ops


def one_launch(fn, lib: str) -> bool:
    """Fails unless one call of fn is one kernel on the card and one
    launch of the library ``lib`` (a captured graph's nodes)."""
    from cartoonsegmentation_torch.ops import _cuda
    before = _cuda.LAUNCHES[lib]
    ops = graph_ops(fn)
    launches = _cuda.LAUNCHES[lib] - before
    if ops != ['kernel'] or launches != 2:        # warm-up and capture
        fail(f'{lib}: a call is {ops} on the card with {launches // 2} '
             f'launches of its library, expected one kernel')
    print(f'[kernel] {lib}: one call is one kernel (a captured graph\'s '
          f'nodes)', flush=True)
    return True


def nms_facts(x) -> dict:
    """One K8 call's facts: the candidates the greedy scan keeps of the
    K (max_out = K), and the sorted row of the last output row when
    max_out rows above -1 are kept (where the walk stops)."""
    from cartoonsegmentation_torch.models import rtmdet
    boxes, scores, thr, n_out = x
    K = boxes.shape[0]
    kept = int(rtmdet.nms_fixed_plain(boxes, scores, thr, K)[1].sum())
    idx, keep = rtmdet.nms_fixed(boxes, scores, thr, n_out)
    row = None
    if keep.numel() == n_out and bool(keep.all()):
        order = rtmdet._stable_argsort_desc(scores)
        row = int((order == idx[-1]).nonzero()[0, 0])
    return {'kept_of_K': kept, 'last_out_row': row}


def check_nms_calls(xs: list, where: str) -> dict:
    """K8 on the calls xs ((boxes, scores) of the synthetic cases, or
    (boxes, scores, thr, max_out) recorded): keep sets exact at max_out
    100 and K; ms, device_ms (``graph_ms`` of the first), plain ms,
    bound (``nms_cost``) and the calls' facts."""
    from cartoonsegmentation_torch.models import rtmdet
    xs = [x if len(x) == 4 else (x[0], x[1], 0.6, 100) for x in xs]
    for boxes, scores, thr, n_out in xs[:3]:
        for max_out in (n_out, boxes.shape[0]):
            ki, km = rtmdet.nms_fixed(boxes, scores, thr, max_out)
            pi, pm = rtmdet.nms_fixed_plain(boxes, scores, thr, max_out)
            if not (torch.equal(ki, pi) and torch.equal(km, pm)):
                fail(f'NMS ({where}) keep set differs from the plain version')
    facts = [nms_facts(x) for x in xs[:3]]

    def run(x):
        return rtmdet.nms_fixed(*x)
    ms = time_ms(run, xs * max(1, RUNS // len(xs)))
    plain_ms = time_ms(lambda x: rtmdet.nms_fixed_plain(*x), xs[:3])
    dev_ms = statistics.median(graph_ms(run, xs[0]) for _ in range(3))
    b, by = bound(*nms_cost(xs[0][0].shape[0], xs[0][3]))
    print(f'[kernel] nms ({where}, K={xs[0][0].shape[0]}, {xs[0][3]} out): '
          f'kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain '
          f'{plain_ms:.4f} ms, bound {b:.6f} ms ({by}); kept of K and the '
          f'last output row {facts}; keep sets exact', flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, device_ms=dev_ms, facts=facts)


def maskhead_cost(x) -> tuple:
    """K9's (bytes, operations) of one call: the prototypes, the
    parameters, priors, strides and flags read, the masks written; the
    dynamic heads (~2 x 172 operations a source pixel an instance) and
    12 a mask byte."""
    feat, kern, _, _, _, Ho, Wo, _ = x
    h, w = feat.shape[:2]
    N = kern.shape[0]
    return (h * w * 8 * 4 + N * (169 + 2 + 1) * 4 + N + N * Ho * Wo,
            N * h * w * 2 * (10 * 8 + 8 * 8 + 8 + 20) + N * Ho * Wo * 12)


def check_maskhead_calls(xs: list, where: str) -> dict:
    """K9 on the calls xs: probs within 1e-6 of the plain version's and
    >= 99.99% of mask pixels equal (the plain resize may contract its
    products into FMAs); ms, device_ms, plain ms, bound
    (``maskhead_cost``) and the valid instances."""
    from cartoonsegmentation_torch.models import rtmdet
    err, same = 0.0, 1.0
    for x in xs[:3]:
        mk, pk = rtmdet.dynamic_masks(*x)
        mp, pp = rtmdet.dynamic_masks_plain(*x)
        err = max(err, float((pk - pp).abs().max()))
        same = min(same, float((mk == mp).float().mean()))
    if err > 1e-6 or same < 0.9999:
        fail(f'mask heads ({where}): probs differ by {err}, masks agree on '
             f'{same}')
    valid = [int(x[4].sum()) for x in xs[:3]]
    ms = time_ms(lambda x: rtmdet.dynamic_masks(*x),
                 xs * max(1, RUNS // len(xs)))
    plain_ms = time_ms(lambda x: rtmdet.dynamic_masks_plain(*x), xs[:3])
    dev_ms = statistics.median(graph_ms(lambda x: rtmdet.dynamic_masks(*x),
                                        xs[0]) for _ in range(3))
    b, by = bound(*maskhead_cost(xs[0]))
    N, (h, w), Ho, Wo = xs[0][1].shape[0], xs[0][0].shape[:2], xs[0][5], \
        xs[0][6]
    print(f'[kernel] maskhead ({where}, N={N} {h}x{w} → {Ho}x{Wo}, valid '
          f'{valid}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms, '
          f'{b / dev_ms:.1%} of the bound), plain {plain_ms:.4f} ms, bound '
          f'{b:.4f} ms ({by}), probs max err {err:.3g}, masks equal '
          f'{same:.6f}', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, device_ms=dev_ms, masks_equal=same,
                valid=valid)


def detector_inputs(det_net, img: np.ndarray, seed: int = 0) -> dict:
    """K8's and K9's calls in one detector forward of the shipped
    default (its AnimeInsSeg as ``KenBurnsPipeline(KenBurnsConfig())``
    makes it, ``det_net`` on the card) on the BGR ``img``, recorded as
    they are made: 'nms' (boxes, scores, IoU threshold, outputs) and
    'maskhead' (``dynamic_masks``' arguments), a list of one call
    each."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.models import rtmdet
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    pipe = KenBurnsPipeline(KenBurnsConfig(), seed=seed, device='cuda')
    pipe.ensure_detector()
    seg = pipe._detector
    seg.model = copy.deepcopy(det_net)
    seen = {'nms': [], 'maskhead': []}
    nms, heads = rtmdet.nms_fixed, rtmdet.dynamic_masks

    def rec_nms(boxes, scores, thr, n_out):
        seen['nms'].append((boxes.clone(), scores.clone(), thr, n_out))
        return nms(boxes, scores, thr, n_out)

    def rec_heads(*a):
        seen['maskhead'].append(tuple(t.clone() if torch.is_tensor(t) else t
                                      for t in a))
        return heads(*a)
    rtmdet.nms_fixed, rtmdet.dynamic_masks = rec_nms, rec_heads
    try:
        x, _, _ = seg._preprocess(img)
        seg._run_device(x)
    finally:
        rtmdet.nms_fixed, rtmdet.dynamic_masks = nms, heads
    return seen


def load_detector_inputs(path: str, dev) -> dict:
    """The K8 and K9 calls that ``render_kernel_times.py
    --save-detector-inputs`` saved, on ``dev``, in ``detector_inputs``'
    layout (a call a forward under each key)."""
    seen = {'nms': [], 'maskhead': []}
    for rec in torch.load(path):
        for tag in seen:
            seen[tag].append(tuple(t.to(dev) if torch.is_tensor(t) else t
                                   for t in rec[tag]))
    return seen


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


def video_frames(path: str, h: int, w: int) -> int:
    """Frames in an (h, w) clip: decoded with cv2 from an mp4, counted
    from the size of a raw I420 stream."""
    if path.endswith('.yuv'):
        return os.path.getsize(path) // (h * w * 3 // 2)
    return len(decode_video(path))


def decode_video(path: str) -> list:
    """The frames of an mp4, decoded with cv2 (BGR uint8)."""
    import cv2
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def run_clip(pipe, img, tag: str):
    """pipe.run(img, video) with the launch counters set to 0 just
    before and read just after; checks the frames and that the clip
    holds them with the palindrome tail. Returns the launches."""
    from cartoonsegmentation_torch.ops import _cuda
    h, w = img.shape[:2]
    T = pipe.cfg.num_frame
    want = T + (T - 2 if pipe.cfg.playback else 0)
    tmp = tempfile.mkdtemp(prefix='smoke_', dir=str(_cuda.BUILD_DIR))
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        frames = pipe.run(img, os.path.join(tmp, 'smoke.mp4'))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        path = pipe.last_video_path
        size = os.path.getsize(path)
        n = video_frames(path, h, w)
        kind = 'raw I420 (cv2 is missing)' if path.endswith('.yuv') \
            else 'mp4'
        print(f'[{tag}] video: {size} bytes, {kind}, {n} frames', flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if n != want:
        fail(f'{tag}: the clip holds {n} frames, expected {want}')
    if frames.shape != (T, h, w, 3) or frames.dtype != np.uint8:
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


def cloud_copies(pipe, tag: str) -> None:
    """How often the last state's cloud repeats its most repeated valid
    point: an inpainting pass appends, for each hole pixel of invalid
    disparity, a point at -shift, all of them on one pixel of every
    frame (K1's crowded case)."""
    cloud = pipe.last_state.cloud
    pts = cloud.points[:int(cloud.count)]
    pts = pts[pts[:, 2] >= 0.001]
    _, reps = torch.unique(pts, dim=0, return_counts=True)
    print(f'[{tag}] cloud: {pts.shape[0]} valid points of {cloud.capacity} '
          f'slots; the most repeated point {int(reps.max())} times',
          flush=True)


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


def crf_cost(H: int, W: int, k: int, lattice: tuple, steps: int,
             norm_pass: bool) -> tuple:
    """(bytes, f32 operations) of one csrc/crf.cu call at (H, W) with k
    clusters on ``lattice`` (crf.lattice's s, gh, gw, R): the norm pass
    if asked (the labels read, the norms written: 12 B a pixel), then
    ``steps`` steps (q, the labels, the unary and the norms read, q'
    written: 36 B a pixel), the last also writing the mask (1 B)."""
    s, gh, gw, R = lattice
    # a plane's lattice: the pool (s^2 adds a cell) and the 9x9 blur
    plane = gh * gw * (s * s + 2 * (2 * R + 1) ** 2)
    nbytes = H * W * (12 * norm_pass + 36 * steps + (steps > 0))
    # per pixel and channel: the 5x5 Gaussian (2 x 30 operations), the
    # two-tap bilinear (6), the messages (8); per pixel the softmax
    # (~30); the norm pass has one channel and no messages
    flops = (norm_pass * (H * W * (60 + 6 + 2) + k * plane)
             + steps * (H * W * (2 * (60 + 6 + 8) + 30) + 2 * k * plane))
    return nbytes, flops


def kmeans_cost(N: int, k: int, iters: int = 8) -> tuple:
    """(bytes, f32 operations) of one k-means: the colours read once
    and the labels written once (16 B a point); per point and cluster
    in each of the iters + 1 assignments 3 subtracts, a multiply, 2
    fused multiply-adds (2 each) and a compare, and per point in each
    of the iters recentrings 4 adds."""
    return N * 16, N * k * 9 * (iters + 1) + N * 4 * iters


def crf_guide(rgb: torch.Tensor) -> torch.Tensor:
    """densecrf_binary's k-means input: the (H, W, 3) guide (uint8
    times f32(1/255), or f32 as it is), as (H·W, 3)."""
    g = rgb if rgb.dtype == torch.float32 else \
        rgb.float() * torch.tensor(1.0 / 255.0, device=rgb.device)
    return g.reshape(-1, 3).contiguous()


def check_kmeans_crops(inputs: list, k: int = 10) -> dict:
    """K12a on the guides of the CRF clip's densecrf_binary calls
    (``CrfCrops(keep=True).inputs`` on a replay of its refine): each
    crop's labels against the plain version (>= KMEANS_SHARE), each crop's device time
    (``graph_ms``), their sum and median, and the bounds' sum."""
    from cartoonsegmentation_torch.ops import crf
    guides = [crf_guide(rgb.cuda()) for _, rgb in inputs]
    shares, each, bounds = [], [], []
    for g in guides:
        got = crf.kmeans_labels(g, k)
        shares.append(float((got == crf._kmeans_labels(g, k)).float()
                            .mean()))
        each.append(graph_ms(lambda x: crf.kmeans_labels(x, k), g))
        bounds.append(bound(*kmeans_cost(g.shape[0], k))[0])
    ms = time_ms(lambda x: crf.kmeans_labels(x, k), guides)
    out = dict(crops=len(guides), points=sum(g.shape[0] for g in guides),
               label_share_min=min(shares), ms=ms,
               device_ms=statistics.median(each), device_ms_sum=sum(each),
               bound_ms=statistics.median(bounds), bound_ms_sum=sum(bounds))
    print(f'[kernel] kmeans on the CRF clip\'s {out["crops"]} crops '
          f'({out["points"]} points): kernel {ms:.4f} ms (median), device '
          f'{out["device_ms"]:.4f} ms median, {out["device_ms_sum"]:.4f} '
          f'summed; bound {out["bound_ms"]:.6f} median, '
          f'{out["bound_ms_sum"]:.6f} summed; labels equal >= '
          f'{out["label_share_min"]:.6f}', flush=True)
    if out['label_share_min'] < KMEANS_SHARE:
        fail(f'kmeans crops: only {out["label_share_min"]:.6f} of a crop\'s '
             f'labels equal to the plain version ({KMEANS_SHARE} required)')
    return out


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
    k, iters = 10, 8
    for tag, part in (('full', rgb), ('crop', rgb[120:420, 260:700])):
        g = crf_guide(part)
        N = g.shape[0]
        got = crf.kmeans_labels(g, k, iters)
        want = crf._kmeans_labels(g, k, iters)
        share = float((got == want).float().mean())
        cases = [(g * (1.0 - 1e-3 * i)).contiguous() for i in range(RUNS)]
        ms = time_ms(lambda x: crf.kmeans_labels(x, k, iters), cases)
        plain_ms = time_ms(lambda x: crf._kmeans_labels(x, k, iters),
                           cases[:3])
        dev_ms = graph_ms(lambda x: crf.kmeans_labels(x, k, iters), g)
        b, by = bound(*kmeans_cost(N, k, iters))
        print(f'[kernel] kmeans {tag} N={N} k={k}: kernel {ms:.4f} ms '
              f'(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
              f'{b:.4f} ms ({by}); labels equal {share:.6f} '
              f'({len(torch.unique(got))} clusters used)', flush=True)
        if share < KMEANS_SHARE:
            fail(f'kmeans {tag}: only {share:.6f} of labels equal to the '
                 f'plain version ({KMEANS_SHARE} required)')
        no_host_sync(lambda: crf.kmeans_labels(g, k, iters), f'kmeans {tag}')
        res[f'kmeans_{tag}'] = dict(label_share=share, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, max_abs_err=1.0 - share,
                                    device_ms=dev_ms)

    # K12b on the whole 576x1024 image
    unary_fg = sloppy_mask(gen, H, W).to(dev)
    labels = crf.kmeans_labels(crf_guide(rgb), k).reshape(H, W)
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
    dev_ms = statistics.median(graph_ms(
        lambda q: crf.crf_step(q, labels, unary, norms, dead), q)
        for q in qs[:3])
    norms_ms = time_ms(crf.crf_norms, [labels] * RUNS)
    norms_dev_ms = graph_ms(crf.crf_norms, labels)
    mk = crf.densecrf_binary(unary_fg, rgb)
    whole_ms = time_ms(lambda u: crf.densecrf_binary(u, rgb),
                       [unary_fg] * RUNS)
    t0 = time.perf_counter()
    mp = crf.densecrf_binary(unary_fg.cpu(), rgb.cpu())
    cpu_s = time.perf_counter() - t0
    mask_share = float((mk.cpu() == mp).float().mean())
    s, gh, gw, R = crf.lattice(H, W, 46.0)
    b, by = bound(*crf_cost(H, W, k, (s, gh, gw, R), 1, False))
    print(f'[kernel] crf step {H}x{W} ({gh}x{gw} lattice of {s} px, {k} '
          f'clusters): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain '
          f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}); norm pass '
          f'{norms_ms:.4f} ms (device {norms_dev_ms:.4f}), max err '
          f'{norm_err:.3g} (dead {int(dead)} / {int(dead_p)}), step max err '
          f'{err:.3g}; densecrf_binary {whole_ms:.3f} ms on the card (k-means '
          f'and 5 steps), {cpu_s:.2f} s the plain version on the CPU, masks '
          f'equal {mask_share:.6f} (fg {float(mp.float().mean()):.4f})',
          flush=True)
    if norm_err > 0 or int(dead) != int(dead_p) or err > 1e-5:
        fail('crf: the norm pass or a step differs from the plain version')
    if mask_share < CRF_MASK_SHARE:
        fail(f'crf: only {mask_share:.6f} of densecrf_binary\'s mask equal to '
             f'the plain version\'s ({CRF_MASK_SHARE} required)')
    res['crf'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                      bound_by=by, device_ms=dev_ms, norms_ms=norms_ms,
                      norms_device_ms=norms_dev_ms, densecrf_ms=whole_ms,
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
            # device time alone, host dispatch excluded (CUDA graphs)
            dev_ms = graph_ms(lambda c: swinv2.window_attention(*c),
                              cases[0])
            lib_dev_ms = graph_ms(lambda c: F.scaled_dot_product_attention(
                *c[:3], attn_mask=c[3], scale=1.0), lib_cases[0])
            # q.k and p.v (2 operations a multiply-add) on the tensor
            # cores; the bias, mask and ~4 of the softmax a score and
            # the two norms on the CUDA cores
            products = B * n * N * N * 4 * hd
            others = B * n * N * N * 7 + B * n * N * 2 * 3 * hd
            nbytes = 4 * (B * N * 3 * n * hd + n * N * N + B * N * n * hd
                          + (mask.numel() if masked else 0))
            b, by, unit, b_simt = bound_tc(nbytes, products, others)
            tag = f's{stage}{"m" if masked else ""}'
            res[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b, bound_by=by, bound_unit=unit,
                            bound_ms_simt=b_simt, library_ms=lib_ms,
                            device_ms=dev_ms, library_device_ms=lib_dev_ms)
            print(f'[kernel] swinattn stage {stage} {B} windows x {n} heads'
                  f'{" masked" if masked else ""}: kernel {ms:.4f} ms '
                  f'({ms / lib_ms:.2f}x SDPA; device {dev_ms:.4f} ms, '
                  f'{dev_ms / lib_dev_ms:.2f}x SDPA\'s {lib_dev_ms:.4f}), '
                  f'plain {plain_ms:.4f} ms, bound {b:.4f} ms (bound_by: '
                  f'{unit}; '
                  f'{b / ms:.1%} of the kernel\'s ms), SDPA {lib_ms:.4f} ms '
                  f'(max err {lib_err:.3g}); max err {err:.3g} of '
                  f'{rng_:.3g}', flush=True)
            del cases, lib_cases
    return res


class CrfCrops:
    """Records the (H, W) of every densecrf_binary call that the CRF
    refine makes until ``close()``; ``keep`` also keeps the inputs (the
    foreground probability and the guide, on the host)."""

    def __init__(self, keep: bool = False):
        from cartoonsegmentation_torch.pipeline import crf_refine
        self.module, self.inner = crf_refine, crf_refine.densecrf_binary
        self.shapes, self.inputs = [], []

        def recording(unary_fg, rgb, *a, **k):
            self.shapes.append(tuple(unary_fg.shape))
            if keep:
                self.inputs.append((unary_fg.cpu(), rgb.cpu()))
            return self.inner(unary_fg, rgb, *a, **k)
        crf_refine.densecrf_binary = recording

    def close(self) -> None:
        self.module.densecrf_binary = self.inner


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

# the style path's working sizes: long_side_to(576, 1024, 768) and
# repaint_person's default -W/-H
FILL_SIZES = ((448, 768), (768, 768))
# K13a alone: an odd size, and one whose coarse levels exceed a block's
# shared memory (block 0 sums them in the scratch behind a second
# barrier)
FILL_ODD = ((37, 53), (1600, 1200))
JITTER_SHARE = 0.9999
STYLE_FILL_SHARE = 0.999


def fill_hole(gen: torch.Generator, h: int, w: int) -> torch.Tensor:
    """(h, w) bool: 7 seeded discs over about a quarter of the frame,
    one of them across the left edge."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing='ij')
    r = (0.3 * h * w / (7 * np.pi)) ** 0.5
    c = torch.rand((6, 2), generator=gen) * torch.tensor([h, w])
    centres = [(float(cy), float(cx)) for cy, cx in c] + [(h / 2, 0.0)]
    hole = torch.zeros((h, w), dtype=torch.bool)
    for cy, cx in centres:
        hole |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return hole


def fill_bytes(h: int, w: int) -> int:
    """K13a's bytes: the image and hole read, the pyramid's levels
    1..L (4 floats a pixel; level 0 is never stored: the first pull
    reads the image, the last pass writes the result) written and
    read, the result written."""
    from cartoonsegmentation_torch.ops.inpaint_fill import fill_levels
    pyr = sum(a * b for a, b in fill_levels(h, w)[1:]) * 16
    return h * w * 12 + h * w + 2 * pyr + h * w * 12


def jitter_bytes(h: int, w: int, n_hole: int, iters: int = 2) -> int:
    """K13b's bytes: the image and hole read, the offsets of the hole
    pixels read (2 planes of int32 a radius and an iteration), the
    ping-pong buffer between iterations written and read, the result
    written."""
    return (h * w * 12 + h * w + n_hole * iters * 4 * 2 * 4
            + (iters - 1) * 2 * h * w * 12 + h * w * 12)


def check_fill_kernels(dev, gen, img: np.ndarray) -> dict:
    """K13a push-pull and K13b jitter refine against their plain
    versions on the card at the style path's sizes, on the image
    resized and a hole of seeded discs (``fill_hole``): K13a within
    1e-6 and one launch; K13b on K13a's result with the offsets drawn
    on the card (equal to the CPU's draw bit for bit; the same for
    both), >= 99.99% of the hole pixels equal. K13a alone at FILL_ODD."""
    from cartoonsegmentation_torch.ops import inpaint_fill as fill
    res = {}
    rgb = torch.from_numpy(img).to(dev).float().permute(2, 0, 1)[None] / 255
    for h, w in FILL_ODD:
        x = torch.nn.functional.interpolate(rgb, size=(h, w), mode='bilinear',
                                            align_corners=False)
        x = x[0].permute(1, 2, 0).contiguous()
        hole = fill_hole(gen, h, w).to(dev)
        got = fill.push_pull_fill(x, hole)
        err = float((got - fill.push_pull_fill_plain(x, hole)).abs().max())
        print(f'[kernel] pushpull {h}x{w}: max err {err:.3g}', flush=True)
        if not err <= 1e-6 or not torch.equal(got[~hole], x[~hole]):
            fail(f'pushpull {h}x{w}: {err:.3g} from the plain version (1e-6 '
                 f'allowed), or a pixel outside the hole changed')
    for h, w in FILL_SIZES:
        tag = f'{h}x{w}'
        x = torch.nn.functional.interpolate(rgb, size=(h, w), mode='bilinear',
                                            align_corners=False)
        x = x[0].permute(1, 2, 0).contiguous()
        hole = fill_hole(gen, h, w).to(dev)
        share = float(hole.float().mean())
        got = fill.push_pull_fill(x, hole)
        want = fill.push_pull_fill_plain(x, hole)
        err = float((got - want).abs().max())
        cases = [(x * (1.0 - 1e-3 * i)).contiguous() for i in range(RUNS)]
        ms = time_ms(lambda c: fill.push_pull_fill(c, hole), cases)
        plain_ms = time_ms(lambda c: fill.push_pull_fill_plain(c, hole),
                           cases[:3])
        dev_ms = graph_ms(lambda c: fill.push_pull_fill(c, hole), cases[0])
        one_launch(lambda: fill.push_pull_fill(x, hole), 'pushpull')
        levels = fill.fill_levels(h, w)
        # per pyramid pixel: the 2x2 sums of 4 channels (12 adds), the
        # upsample (3 channels x 6) and the blend (3 x 6 and a clip)
        b, by = bound(fill_bytes(h, w),
                      50 * sum(a * c for a, c in levels))
        print(f'[kernel] pushpull {tag} ({share:.1%} hole, {len(levels) - 1} '
              f'levels, one launch a call): kernel {ms:.4f} ms (device '
              f'{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms '
              f'({by}); max err {err:.3g}', flush=True)
        if not err <= 1e-6:
            fail(f'pushpull {tag}: {err:.3g} from the plain version (1e-6 '
                 f'allowed)')
        res[f'pushpull_{tag}'] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=b,
                                      bound_by=by, hole_share=share,
                                      device_ms=dev_ms)

        base = want
        off = fill.jitter_offsets(h, w, device=dev)
        if not torch.equal(off.cpu(), fill.jitter_offsets(h, w)):
            fail(f'jitter_offsets {tag}: the card\'s draw differs from the '
                 f'CPU\'s')
        got = fill.jitter_refine(base, hole, off)
        want = fill.jitter_refine_plain(base, hole, off)
        same = float((got == want).all(-1)[hole].float().mean())
        err = float((got - want).abs().max())
        moved = float((got != base).any(-1)[hole].float().mean())
        cases = [(base * (1.0 - 1e-3 * i)).contiguous() for i in range(RUNS)]
        ms = time_ms(lambda c: fill.jitter_refine(c, hole, off), cases)
        plain_ms = time_ms(lambda c: fill.jitter_refine_plain(c, hole, off),
                           cases[:3])
        dev_ms = graph_ms(lambda c: fill.jitter_refine(c, hole, off),
                          cases[0])
        n_hole = int(hole.sum())
        # per hole pixel, iteration and radius: 24 differences, squares
        # and adds of the ring SSD
        b, by = bound(jitter_bytes(h, w, n_hole), n_hole * 2 * 4 * 72)
        print(f'[kernel] jitter {tag} ({n_hole} hole pixels, 2 launches a '
              f'call): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain '
              f'{plain_ms:.4f} ms, bound {b:.4f} ms ({by}); hole pixels '
              f'equal {same:.6f}, max err {err:.3g}; the refine moved '
              f'{moved:.1%} of them; offsets drawn on the card, equal to '
              f'the CPU\'s draw', flush=True)
        if same < JITTER_SHARE or moved == 0.0:
            fail(f'jitter {tag}: {same:.6f} of hole pixels equal to the plain '
                 f'version ({JITTER_SHARE} required), {moved:.1%} moved')
        res[f'jitter_{tag}'] = dict(max_abs_err=err, equal_share=same,
                                    ms=ms, plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, device_ms=dev_ms)
    return res


def stub_sd_server(port: int = 0):
    """A stub stable-diffusion-webui on 127.0.0.1 (stdlib http.server in
    a thread), at ``port`` (a free one for 0): img2img answers n_iter *
    batch_size images of the asked size, PNG-encoded with cv2 (a fixed
    function of the request), records each request body and keeps each
    reply's images in ``server.replies``. Returns (server, url, calls)."""
    import base64
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import cv2
    calls, cache, replies = [], {}, []

    def image(w, h, k):
        if (w, h, k) not in cache:
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack([(xx * 3 + 50 * k) % 256, (yy * 2) % 256,
                            np.full((h, w), 90 + 40 * k)], -1)
            ok, buf = cv2.imencode('.png', img.astype(np.uint8))
            cache[w, h, k] = base64.b64encode(buf.tobytes()).decode()
        return cache[w, h, k]

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers['Content-Length'])
            payload = json.loads(self.rfile.read(n))
            calls.append(payload)
            w, h = payload.get('width', 64), payload.get('height', 64)
            count = int(payload.get('n_iter', 1)) * int(
                payload.get('batch_size', 1))
            imgs = [image(w, h, k + 1) for k in range(count)]
            if count > 1:
                imgs = [image(w, h, 0)] + imgs
            replies.append(imgs)
            body = json.dumps({'images': imgs}).encode()
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(('127.0.0.1', port), Handler)
    srv.replies = replies
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img', calls


class MaskBoxed:
    """The detector with each instance boxed by its mask (the random box
    head's boxes may crop nothing, ``mask_boxes``) and instances whose
    mask is empty dropped: the tagger needs a crop."""

    def __init__(self, det):
        self.det, self.device = det, det.device

    def infer(self, img, *a, **k):
        ins = mask_boxes(self.det.infer(img, *a, **k))
        return ins.replace(valid=ins.valid & ins.masks.any((1, 2)))


def style_phase(det, img: np.ndarray, save: str = None) -> tuple:
    """``StyleEditor.repaint`` on the card: the edged detector with its
    ISNet refine (``MaskBoxed``), the full-width random tagger of the
    tagger phase, a stub sd-webui server; long_side 768 (a 448x768
    working size), niter 1, one inpaint an instance. Checks K13a and
    K13b launched once each, one img2img and one inpaint an instance at
    768x448 with the style prompt, and the card's background fill
    against the plain versions on the CPU on the same host arrays:
    outside the hole exact, inside >= 99.9% equal; then the draw of the
    offsets on the card, and K13a's and K13b's device times on that
    fill's inputs, which ``save`` (a path) keeps as an .npz of the
    image and mask for render_kernel_times.py. Returns the launches of
    the repaint and those times."""
    import cv2
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.ops.inpaint_fill import (
        inpaint, jitter_offsets, jitter_refine, push_pull_fill)
    from cartoonsegmentation_torch.pipeline.style import (
        StyleConfig, StyleEditor, long_side_to)
    srv, url, calls = stub_sd_server()
    tmp = tempfile.mkdtemp(prefix='smoke_', dir=str(_cuda.BUILD_DIR))
    try:
        cfg = StyleConfig(
            url=url, style_prompt='pixar style', long_side=768, niter=1,
            onebyone=True, cache_masks_dir=os.path.join(tmp, 'cache'),
            save_dir=os.path.join(tmp, 'out'),
            sd_params={'steps': 2, 'alwayson_scripts':
                       {'controlnet': {'args': [{}]}}})
        editor = StyleEditor(cfg, detector=MaskBoxed(det),
                             tagger=det.tagger.label_cv2_bgr)
        prep_s = []
        prepare = editor.prepare

        def timed_prepare(*a):
            t0 = time.perf_counter()
            out = prepare(*a)
            prep_s.append(time.perf_counter() - t0)
            return out
        editor.prepare = timed_prepare
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        saved = editor.repaint(img, 'smoke')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        require_launches('style', launches, ('pushpull', 'jitter'))
        if launches['pushpull'] != 1 or launches['jitter'] != 1:
            fail(f'style: {launches["pushpull"]} pushpull and '
                 f'{launches["jitter"]} jitter launches, expected one fill')
        with open(os.path.join(tmp, 'cache', 'smoke_prompts.json')) as f:
            n = len(json.load(f)) - 1
        h, w = long_side_to(*img.shape[:2], 768)
        bad = [i for i, c in enumerate(calls)
               if (c['width'], c['height']) != (w, h)
               or not c['prompt'].startswith('pixar style')
               or ('mask' in c) != (i > 0)]
        print(f'[style] repaint {wall:.3f} s (prepare {prep_s[0]:.3f} s: '
              f'detect, tag {n} instances, fill), {len(calls)} requests '
              f'(1 img2img, {len(calls) - 1} inpaints); saved '
              f'{[os.path.basename(p) for p in saved]}; launches '
              f'{ {k: v for k, v in launches.items() if v} }', flush=True)
        if n < 2 or len(calls) != 1 + n or bad or len(saved) != 1 or \
                not os.path.exists(saved[0]):
            fail(f'style: {n} instances, {len(calls)} requests (bad: {bad}), '
                 f'saved {saved}')
        # the background fill: the card's against the CPU's
        small = cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)
        cache = os.path.join(tmp, 'cache')
        mask = cv2.imread(os.path.join(cache, 'smoke_mask_fg.png'),
                          cv2.IMREAD_GRAYSCALE)
        card = cv2.imread(os.path.join(cache, 'smoke_bg_repaint.png'))
        t0 = time.perf_counter()
        cpu = inpaint(small, mask, device='cpu')
        cpu_s = time.perf_counter() - t0
        hole = mask > 0
        outside = bool((card[~hole] == cpu[~hole]).all()
                       and (card[~hole] == small[~hole]).all())
        inside = float((card[hole] == cpu[hole]).all(-1).mean())
        fill_ms = time_ms(lambda _: inpaint(small, mask, device=det.device),
                          [None] * RUNS)
        # of which the draw of the jitter offsets on the card
        draw_ms = time_ms(lambda _: jitter_offsets(h, w, device=det.device),
                          [None] * RUNS)
        print(f'[style] background fill {h}x{w}, {hole.mean():.1%} hole: '
              f'{fill_ms:.3f} ms on the card (uint8 in and out, host copies '
              f'included; the card\'s draw of the offsets alone '
              f'{draw_ms:.3f} ms), {1e3 * cpu_s:.1f} ms on the CPU; outside '
              f'the hole {"exact" if outside else "DIFFERENT"}, inside '
              f'{inside:.6f} of pixels equal', flush=True)
        if save:
            np.savez(save, image=small, mask=mask)
        if not outside or inside < STYLE_FILL_SHARE:
            fail(f'style: the card\'s background fill disagrees with the CPU '
                 f'(outside exact: {outside}, inside {inside:.6f})')
        # the fill's two kernels alone, on the repaint's image and hole
        img_t = torch.from_numpy(small.astype(np.float32) / 255.0).to(
            det.device)
        hole_t = torch.from_numpy(hole).to(det.device)
        base = push_pull_fill(img_t, hole_t)
        off = jitter_offsets(h, w, device=det.device)
        fill_dev = {
            'pushpull': graph_ms(lambda x: push_pull_fill(*x),
                                 (img_t, hole_t)),
            'jitter': graph_ms(lambda x: jitter_refine(*x),
                               (base, hole_t, off))}
        print(f'[style] device time on the repaint\'s {h}x{w} fill: '
              f'pushpull {fill_dev["pushpull"]:.4f} ms, jitter '
              f'{fill_dev["jitter"]:.4f} ms', flush=True)
        fill_dev.update(fill_ms=fill_ms, draw_ms=draw_ms)
    finally:
        srv.shutdown()
        srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, fill_dev


def odd_clip_phase(seed: int) -> dict:
    """The detector-free clip at 683x1024 (a 3:2 image at 1024 wide:
    H % 4 != 0), which streams BGR chunks: the frames, the clip's frame
    count with the palindrome tail, and that the I420 decode was never
    called. Returns the launches."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.pipeline import kenburns
    i420_calls = []
    decode = kenburns.i420_to_bgr_host

    def counted(arr):
        i420_calls.append(len(arr))
        return decode(arr)
    kenburns.i420_to_bgr_host = counted
    try:
        pipe = kenburns.KenBurnsPipeline(KenBurnsConfig(detector='none'),
                                         seed=seed, device='cuda')
        launches = run_clip(pipe, make_image(seed, 683, 1024),
                            'clip 683x1024')
    finally:
        kenburns.i420_to_bgr_host = decode
    print(f'[clip 683x1024] BGR stream: stream_render '
          f'{pipe.timer.seconds["stream_render"]:.3f} s, stream_encode_tail '
          f'{pipe.timer.seconds["stream_encode_tail"]:.3f} s; I420 decodes '
          f'{len(i420_calls)}', flush=True)
    if i420_calls:
        fail(f'clip 683x1024: the I420 path was taken ({i420_calls})')
    return launches


def _probe(module, fn):
    """The output of ``module`` (a forward hook) while fn() runs."""
    seen = {}
    h = module.register_forward_hook(lambda m, i, o: seen.setdefault('o', o))
    try:
        with torch.no_grad():
            fn()
    finally:
        h.remove()
    return seen['o']


def _scale_block(block, o, mean: float = 0.0) -> None:
    """Scale a residual Basic block whose output on a probe was ``o`` so
    that its output there has std 1 and the given mean: both its last
    conv and its shortcut conv are divided by o's std, and the last
    conv's bias takes the shift."""
    mu, sd = float(o.mean()), float(o.std())
    with torch.no_grad():
        for conv in (block.netMain[-1], block.netShortcut):
            conv.weight /= sd
            conv.bias /= sd
        block.netMain[-1].bias += mean - mu / sd


def edged_depth(seed: int, img: np.ndarray):
    """The 3D-Ken-Burns disparity estimator and Refine net as
    ``KenBurnsPipeline(seed=seed)`` makes them (random from the seed),
    with their last blocks scaled on a probe of ``img`` on the card.
    Random weights alone put the disparity's logits below 0 at all but
    0.3% of the pixels (a disparity of zeros after the ReLU) and the
    Refine net's output within ~1% of the mean of its input. Here
    - the estimator's last block (``netDisparity``) gives std 1 and mean
      2 before the ReLU (a disparity positive nearly everywhere);
    - Refine's last block (``netRefine``) gives std 1 and mean 0 on the
      estimator's output, so that the refined disparity spreads as its
      input does.
    Returns (DisparityEstimator, Refine), f32 on the CPU."""
    from cartoonsegmentation_torch.models.kenburns import (DisparityEstimator,
                                                           Refine)
    nets = []
    for cls in (DisparityEstimator, Refine):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            nets.append(cls().eval().cuda())
    est, ref = nets
    x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(
        2, 0, 1)[None].cuda()
    _scale_block(est.disparity.netDisparity,
                 _probe(est.disparity.netDisparity, lambda: est(x)), 2.0)
    with torch.no_grad():
        d = est(x)
    _scale_block(ref.netRefine, _probe(ref.netRefine, lambda: ref(x, d)))
    with torch.no_grad():
        r = ref(x, d)
    print(f'[options] edged_depth: disparity {tuple(d.shape[-2:])} positive '
          f'at {float((d > 0).float().mean()):.4f}, std / mean '
          f'{float(d.std() / d.mean()):.4f}; refined {tuple(r.shape[-2:])} '
          f'std / mean {float(r.std() / r.mean()):.4f}', flush=True)
    return est.cpu(), ref.cpu()


def refiner_input(img: np.ndarray, size: int) -> torch.Tensor:
    """AnimeSegRefiner's input on the card: the RGB image shrunk (with
    antialias) to fit ``size``, at the top left of a size x size frame
    of zeros."""
    from cartoonsegmentation_torch.utils.image import (resize_bilinear_aa,
                                                       scaledown_size)
    nh, nw = scaledown_size(*img.shape[:2], size)
    rgb = torch.from_numpy(img[..., ::-1].astype(np.float32) / 255.0).cuda()
    x = torch.zeros((1, 3, size, size), device='cuda')
    x[0, :, :nh, :nw] = resize_bilinear_aa(rgb, nh, nw).permute(2, 0, 1)
    return x


def edged_animeseg(seed: int, img: np.ndarray, name: str = 'isnet_is',
                   size: int = 1024):
    """The animeseg refiner's net as ``AnimeSegRefiner(seed=seed)`` makes
    it, with its last conv moved so that on ``img`` its logits are 4
    (logit - median): the 0.5 threshold then cuts the frame about in
    half (a random net's probabilities sit within ~0.1 of 0.5, on one
    side of it over most of the frame). Returns the net, on the CPU."""
    from cartoonsegmentation_torch.pipeline.refine import get_refine_net
    from cartoonsegmentation_torch.utils.image import scaledown_size
    make, run = get_refine_net(name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = make().eval().cuda()
    nh, nw = scaledown_size(*img.shape[:2], size)
    with torch.no_grad():
        p = run(net, refiner_input(img, size))[0, :nh, :nw].double()
        m = float(torch.log(p / (1 - p)).median())
        conv = net.side1
        conv.bias -= m
        conv.weight *= 4.0
        conv.bias *= 4.0
        share = float((run(net, refiner_input(img, size))[0, :nh, :nw]
                       > 0.5).float().mean())
    print(f'[options] edged_animeseg ({name} at {size}): median logit '
          f'{m:.4f} moved to 0; {share:.4f} of the frame above 0.5',
          flush=True)
    return net.cpu()


def calibrate_bn(net, fn) -> None:
    """Set every BatchNorm's running statistics to its batch statistics
    in one forward (``fn()``, train mode), as a trained net's match its
    data; then eval mode. At PyTorch's initial statistics (mean 0,
    variance 1) a random U2Net's probabilities all sit within 0.01 of
    0.48 and the card-vs-CPU check of its mask would be empty; with its
    own statistics they spread over 0.02..0.71 (PR 18)."""
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None                   # a cumulative mean of 1 batch
    net.train()
    with torch.no_grad():
        fn()
    for m in bns:
        m.momentum = 0.1
    net.eval()


# MODNet's probabilities, card against CPU: the difference grows through
# its MobileNetV2 backbone (1.6e-5 of a layer's range after block 3,
# 4e-4 after block 17, the matte 4.5e-4), the same with cuDNN off: f32
# summation order through 17 depthwise blocks, not an algorithm of cuDNN
PROB_TOL = {'u2net': 1e-4, 'u2netl': 1e-4, 'isnet_gt': 1e-4, 'modnet': 1e-3}


def compare_nets_card_cpu(seed: int, img: np.ndarray, est, ref,
                          tol: float = 1e-4) -> None:
    """Each new net in f32 on the card (cuDNN, TF32 off) against the same
    weights on the CPU: U2Net, U2Net-lite, ISNetGTEncoder and MODNet as
    the animeseg refiner runs them at 1024 (random from the seed, their
    BatchNorm statistics from the input, ``calibrate_bn``), their
    foreground probabilities within ``PROB_TOL`` and their masks (> 0.5)
    >= 99.9% equal; the disparity estimator on the clip's image (its
    144x256 output) and Refine from that grid to 576x1024 within ``tol``
    of the output's range. Else the run fails."""
    from cartoonsegmentation_torch.pipeline.refine import get_refine_net
    x = refiner_input(img, 1024)
    for name, ptol in PROB_TOL.items():
        make, run = get_refine_net(name)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = make().cuda()
        calibrate_bn(net, lambda: run(net, x))
        with torch.no_grad():
            got = run(net, x).cpu()
            t0 = time.perf_counter()
            want = run(net.cpu(), x.cpu())
            tc = time.perf_counter() - t0
        err = float((got - want).abs().max())
        same = float(((got > 0.5) == (want > 0.5)).float().mean())
        print(f'[options f32] {name} at 1024 card vs cpu ({tc:.1f} s on the '
              f'CPU): probabilities {float(want.min()):.4f}..'
              f'{float(want.max()):.4f}, max |diff| {err:.3g} (tolerance '
              f'{ptol:g}), masks equal at {same:.6f} (>= 0.999)', flush=True)
        if not (err <= ptol and same >= 0.999):
            fail(f'options: {name} on the card differs from the CPU by {err}'
                 f', its mask at {1 - same:.6f} of the pixels')
    xi = torch.from_numpy(img.astype(np.float32) / 255.0).permute(
        2, 0, 1)[None]
    with torch.no_grad():
        d = est(xi)
        r = ref(xi, d)
        outs = ((f'DisparityEstimator {tuple(d.shape[-2:])}', d,
                 est.cuda()(xi.cuda()).cpu()),
                (f'Refine {tuple(d.shape[-2:])} → {tuple(r.shape[-2:])}', r,
                 ref.cuda()(xi.cuda(), d.cuda()).cpu()))
    est.cpu(), ref.cpu()
    for tag, want, got in outs:
        err = float((got - want).abs().max())
        rng = float(want.max() - want.min())
        print(f'[options f32] {tag} card vs cpu: max |diff| {err:.3g}, '
              f'tolerance {tol:g} x range {rng:.4f} = {tol * rng:.3g}',
              flush=True)
        if not err <= tol * rng:
            fail(f'options: {tag} on the card differs from the CPU by {err}')


def options_phase(det_net, img: np.ndarray, seed: int) -> tuple:
    """The options clip: the shipped default with refine_method
    'animeseg' (ISNet-IS at 1024 over the edged detector's instances,
    ``edged_animeseg``), depth_est 'default' with default_depth_refine
    (``edged_depth``) and inpaint_type 'patchmatch'. First each new net
    card against CPU (``compare_nets_card_cpu``) and the PatchMatch
    library's build; then the clip with its launches, instances and
    frames against the CPU, the two PatchMatch passes' host seconds,
    and how many instances the animeseg refine changed. Returns (the
    launches, the pipeline)."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.ops import patchmatch_native
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    from cartoonsegmentation_torch.device import resolve_device
    from cartoonsegmentation_torch.pipeline.refine import AnimeSegRefiner
    resolve_device('cuda')              # TF32 off: the nets run in f32
    est, ref = edged_depth(seed, img)
    compare_nets_card_cpu(seed, img, est, ref)
    t0 = time.perf_counter()
    lib = patchmatch_native.build_library()
    print(f'[options] PatchMatch library {lib.name} built or found in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    cfg = KenBurnsConfig(refine_method='animeseg', depth_est='default',
                         default_depth_refine=True, inpaint_type='patchmatch')
    pipe = KenBurnsPipeline(cfg, seed=seed, device='cuda')
    pipe.ensure_detector()
    det = pipe._detector
    if not isinstance(det.refine, AnimeSegRefiner) or \
            det.refine.input_size != 1024:
        fail(f'options: the refine is {det.refine!r}')
    det.model = copy.deepcopy(det_net)
    det.refine.net = edged_animeseg(seed, img)
    pipe.disparity_net, pipe.refine_net = est, ref
    passes = []
    pm = patchmatch_native.inpaint

    def timed(image, mask, **k):
        t = time.perf_counter()
        out = pm(image, mask, **k)
        passes.append((time.perf_counter() - t, float((mask > 0).mean())))
        return out
    patchmatch_native.inpaint = timed
    try:
        launches = run_clip(pipe, img, 'options')
    finally:
        patchmatch_native.inpaint = pm
    print('[options] PatchMatch passes (host seconds, hole share of '
          '576x1024): ' + ', '.join(f'{t:.3f} s ({h:.4f})'
                                    for t, h in passes), flush=True)
    if len(passes) != 2:
        fail(f'options: {len(passes)} PatchMatch passes, expected 2')
    require_launches('options', launches,
                     ('splat', 'coverage', 'discfill', 'bokeh', 'insmedian',
                      'median5', 'laplacian', 'nms', 'maskhead', 'epilogue',
                      'colorize', 'compact'))
    check_instances(pipe, 'options')
    compare_frames(pipe, 'options')
    # what the animeseg refine did to the instances: the detector again
    # with the refine and without it
    refine = det.refine
    refined = det.infer(img, cfg.pred_score_thr)
    det.refine = None
    raw = det.infer(img, cfg.pred_score_thr)
    det.refine = refine
    valid = raw.valid
    changed = int(((refined.masks != raw.masks).any((1, 2)) & valid).sum())
    print(f'[options] animeseg refine: {changed} of {int(valid.sum())} '
          f'instances changed', flush=True)
    if changed == 0:
        fail('options: the animeseg refine changed no instance')
    return launches, pipe


# the depth estimators: ZoeDepth N and NK at the grid of a 576x1024 image
# fitted into 672, and LeReS boosting
ZOE_TOL = 1e-4          # metric depth, card vs CPU, share of its range
MERGE_TOL = 1e-4        # the merge net's [0, 1] output, card vs CPU
BOOST_TOL = 1e-3        # the boosted [0, 1] depth, card vs CPU


def zoe_grid(img: np.ndarray) -> tuple:
    from cartoonsegmentation_torch.utils.image import scaledown_size
    return scaledown_size(*img.shape[:2], 672, divisor=32)


def edged_zoe(seed: int, img: np.ndarray, nk: bool):
    """ZoeDepth (or NK) at the image's grid as ``KenBurnsPipeline(seed=
    seed)`` makes it (random from the seed), with two last convs of each
    head set. A random net's seed bins all sit near softplus(0) = 0.69
    (the metric depth spans ~1%), its p near 0.5 and its temperature
    high. Here the seed bin regressor's last conv puts the bins at 0.5
    to 3.0, in order, everywhere (its weights 0, its biases softplus's
    inverse of those); and in the conditional log-binomial's last conv,
    set on a probe of ``img`` on the card, the p logit (channel 0 against
    channel 1, their rows opposite) is the hidden feature that varies
    most over the probe, standardised to std 2, and the temperature is
    pinned near its 0.0212 floor, so each pixel's weight sits near the
    bin p · (K - 1) and the depth spans the bins. (A random row of the
    conv varies little over the image: standardising it amplified the
    features' f32 noise, ~1e-5 of their spread card against CPU, to
    8e-5 of the depth's range.) Prints the disparity's range; returns
    the net, f32 on the CPU."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.models.zoedepth import ZoeDepth, ZoeDepthNK
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = (ZoeDepthNK if nk else ZoeDepth)(img_size=zoe_grid(img))
    net = net.eval().cuda()
    est = 'zoe_nk' if nk else 'zoe'
    pipe = KenBurnsPipeline(KenBurnsConfig(detector='none', depth_est=est,
                                           dtype='float32'), seed=seed,
                            device='cuda')
    pipe.zoe_net = net
    image = torch.from_numpy(img.astype(np.float32) / 255.0).cuda()
    heads = list(net.conditional_log_binomial.values()) if nk \
        else [net.conditional_log_binomial]
    seeds = list(net.seed_bin_regressors.values()) if nk \
        else [net.seed_bin_regressor]
    with torch.no_grad():
        for reg in seeds:
            conv = reg._net[2]
            bins = torch.linspace(0.5, 3.0, conv.out_channels,
                                  dtype=torch.float64)
            conv.weight.zero_()
            conv.bias.copy_(torch.log(torch.expm1(bins)))
    for clb in heads:
        conv = clb.mlp[2]
        g = _probe(clb.mlp[1], lambda: pipe._estimate_disparity(image))
        with torch.inference_mode():
            spread = g[0].flatten(1).std(1)
            c = int(spread.argmax())
            mu, sd = float(g[0, c].mean()), float(spread[c])
        with torch.no_grad():
            conv.weight.zero_()
            conv.weight[0, c] = 2.0 / sd
            conv.weight[1, c] = -2.0 / sd
            conv.bias.copy_(torch.tensor([-2.0 * mu / sd, 2.0 * mu / sd,
                                          -10.0, 5.0]))
    d = pipe._estimate_disparity(image)
    print(f'[zoe] edged_zoe ({est} at {net.img_size}): disparity '
          f'{float(d.min()):.3f}..{float(d.max()):.3f}, std / mean '
          f'{float(d.std() / d.mean()):.4f}', flush=True)
    return net.cpu()


def zoe_input(img: np.ndarray) -> torch.Tensor:
    """The image as ZoeDepth's input at its grid: RGB, resized with the
    cubic of ``infer_zoe`` (1, 3, zh, zw), on the CPU."""
    from cartoonsegmentation_torch.utils.image import resize_cubic_nchw
    rgb = torch.from_numpy(img[..., ::-1].astype(np.float32) / 255.0)
    return resize_cubic_nchw(rgb.permute(2, 0, 1)[None], *zoe_grid(img))


def compare_zoe_card_cpu(net, img: np.ndarray, tag: str) -> None:
    """One forward of ZoeDepth (N or NK) at full width on the image's
    grid, f32 on the card (TF32 off) against the CPU: the metric depth
    within ZOE_TOL of its range; for NK the same vote. Else the run
    fails."""
    x = zoe_input(img)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = net(x)
        tc = time.perf_counter() - t0
        got = {k: v.cpu() for k, v in net.cuda()(x.cuda()).items()}
    net.cpu()
    md = want['metric_depth']
    err = float((got['metric_depth'] - md).abs().max())
    rng = float(md.max() - md.min())
    line = (f'[zoe f32] {tag} at {tuple(x.shape[-2:])} card vs cpu ({tc:.1f} '
            f's on the CPU): metric depth {float(md.min()):.4f}..'
            f'{float(md.max()):.4f}, max |diff| {err:.3g}, tolerance '
            f'{ZOE_TOL:g} x range = {ZOE_TOL * rng:.3g}')
    if 'domain_logits' in want:
        lw, lg = want['domain_logits'].sum(0), got['domain_logits'].sum(0)
        kw, kg = bool(lw[1] > lw[0]), bool(lg[1] > lg[0])
        line += (f'; router: {"kitti" if kw else "nyu"} on the CPU, '
                 f'{"kitti" if kg else "nyu"} on the card (logit margin '
                 f'{float(lw[1] - lw[0]):.4g}, max |diff| '
                 f'{float((lg - lw).abs().max()):.3g})')
        if kw != kg:
            fail(f'zoe: {tag}\'s router voted otherwise on the card')
    print(line, flush=True)
    if not rng > 0 or not err <= ZOE_TOL * rng:
        fail(f'zoe: {tag} on the card differs from the CPU by {err} '
             f'(range {rng})')


def boost_image(seed: int) -> np.ndarray:
    """432x768: make_image with a band of seeded noise along its left
    side, so that R_x (448 at seed 0) fits the image and a few patches
    are dense enough (2 at seed 0), which keeps the CPU side short."""
    img = make_image(seed, 432, 768)
    rng = np.random.RandomState(seed + 1)
    img[:, :160] = rng.randint(0, 256, (432, 160, 3), dtype=np.uint8)
    return img


def seeded(cls, seed: int, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**kw).eval()


def compare_boost_card_cpu(seed: int) -> None:
    """The merge net at 1024 and LeReSBoost on ``boost_image``, f32 on the
    card against the CPU with the pipeline's seeded LeReS and merge net:
    the merge within MERGE_TOL, the same patches, the boosted depth within
    BOOST_TOL of its range. Else the run fails."""
    from cartoonsegmentation_torch.models.leres import LeReS
    from cartoonsegmentation_torch.models.pix2pix4depth import (
        Pix2Pix4Depth, merge_depths)
    from cartoonsegmentation_torch.pipeline.boost import LeReSBoost
    leres, p2p = seeded(LeReS, seed), seeded(Pix2Pix4Depth, seed)
    img = boost_image(seed)
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(64, 64, generator=g)
    a = torch.nn.functional.interpolate(a[None, None], size=(1024, 1024),
                                        mode='bicubic')[0, 0]
    b = torch.from_numpy(np.ascontiguousarray(
        img[:, :, 1].astype(np.float32) / 255.0))
    b = torch.nn.functional.interpolate(b[None, None], size=(1024, 1024),
                                        mode='bilinear')[0, 0]
    with torch.no_grad():
        want = merge_depths(p2p, a[None], b[None])
        got = merge_depths(p2p.cuda(), a[None].cuda(), b[None].cuda()).cpu()
    err = float((got - want).abs().max())
    print(f'[boost f32] merge net at 1024 card vs cpu: output '
          f'{float(want.min()):.4f}..{float(want.max()):.4f}, max |diff| '
          f'{err:.3g} (tolerance {MERGE_TOL:g})', flush=True)
    if not err <= MERGE_TOL:
        fail(f'boost: the merge net on the card differs from the CPU by {err}')
    runs = {}
    for dev in ('cuda', 'cpu'):
        bst = LeReSBoost(leres.to(dev), p2p.to(dev))
        t0 = time.perf_counter()
        out = bst(img)
        if dev == 'cuda':
            torch.cuda.synchronize()
        runs[dev] = (out, list(bst.last_rects), bst.last_whole_size,
                     time.perf_counter() - t0)
    (dk, rk, sk, tk), (dc, rc, sc, tc) = runs['cuda'], runs['cpu']
    err = float(np.abs(dk - dc).max())
    rng = float(dc.max() - dc.min())
    print(f'[boost f32] LeReSBoost on {img.shape[0]}x{img.shape[1]}: R_x '
          f'{sk} / {sc}, {len(rk)} / {len(rc)} patches (card / CPU), '
          f'card {tk:.2f} s, cpu {tc:.2f} s; boosted depth '
          f'{float(dc.min()):.4f}..{float(dc.max()):.4f}, max |diff| '
          f'{err:.3g}, tolerance {BOOST_TOL:g} x range = {BOOST_TOL * rng:.3g}',
          flush=True)
    if rk != rc or sk != sc or not rk:
        fail(f'boost: the card chose patches {rk} at R_x {sk}, the CPU {rc} '
             f'at {sc}')
    if not err <= BOOST_TOL * rng:
        fail(f'boost: the boosted depth on the card differs from the CPU by '
             f'{err}')


class BoostTimes:
    """Seconds in LeReSBoost's steps while the block runs, by name:
    ``__call__`` (the whole boost), ``_double`` and ``_patches`` (the
    nets; each ends in a copy to the host), ``calculateprocessingres``
    and ``generatepatchs`` (the host's selection)."""

    def __enter__(self):
        from cartoonsegmentation_torch.pipeline import boost
        self.spent = dict.fromkeys(('__call__', '_double', '_patches',
                                    'calculateprocessingres',
                                    'generatepatchs'), 0.0)
        self.saved = []
        for owner, name in ((boost.LeReSBoost, '__call__'),
                            (boost.LeReSBoost, '_double'),
                            (boost.LeReSBoost, '_patches'),
                            (boost, 'calculateprocessingres'),
                            (boost, 'generatepatchs')):
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._timed(name, fn))
        return self.spent

    def _timed(self, name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spent[name] += time.perf_counter() - t0
        return run

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def depth_clip(det_net, isnet, img: np.ndarray, seed: int, est: str,
               cfg: dict, nets: dict = None, after=None) -> dict:
    """The shipped default (the edged detector and refine) with the
    options ``cfg`` at 576x1024, 75 frames, its pipeline given the
    ``nets`` (attributes by name): K1-K10 launched, the instances, the
    disparity's range and the frames' hole share, the frames against the
    CPU. ``after(pipe)`` may check and print more before the frames are
    compared.
    Returns the launches."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline import boost
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    pipe = KenBurnsPipeline(KenBurnsConfig(**cfg), seed=seed, device='cuda')
    pipe.ensure_detector()
    pipe._detector.model = copy.deepcopy(det_net)
    pipe._detector.refine.net = copy.deepcopy(isnet)
    for k, v in (nets or {}).items():
        setattr(pipe, k, v)
    with BoostTimes() as spent:
        launches = run_clip(pipe, img, est)
    require_launches(est, launches,
                     [k for k in _cuda.KERNELS if k not in (
                         'samattn', 'discfill_exact', 'roialign',
                         'nms_large', 'kmeans', 'crf', 'swinattn',
                         'pushpull', 'jitter', 'median3')])
    check_instances(pipe, est)
    d = pipe.last_state.disparity
    holes = fill_walks([x[1] for x in real_fill_inputs(pipe)])['hole_share']
    extra = ''
    if est == 'leres_boost':
        bst = pipe.last_boost
        host = spent['__call__'] - sum(v for k, v in spent.items()
                                       if k != '__call__')
        extra = (f'; R_x {bst.last_whole_size}, {len(bst.last_rects)} '
                 f'patches; the boost {spent["__call__"]:.3f} s: R_x search '
                 f'{spent["calculateprocessingres"]:.3f}, double estimate '
                 f'{spent["_double"]:.3f}, patch selection '
                 f'{spent["generatepatchs"]:.3f}, the patches\' nets '
                 f'{spent["_patches"]:.3f} (batches of '
                 f'{boost.PATCH_BATCH}), the '
                 f'host\'s resizes, polyfits and blend {host:.3f}')
    print(f'[{est}] disparity {float(d.min()):.3f}..{float(d.max()):.3f}, '
          f'std / mean {float(d.std() / d.mean()):.4f}; {holes:.3%} of the '
          f'frames\' pixels in holes before the fill{extra}', flush=True)
    if holes <= 0.0:
        fail(f'{est}: the frames have no holes: the fill did no work')
    if after is not None:
        after(pipe)
    compare_frames(pipe, est)
    return launches


def zoe_boost_phase(det_net, isnet, img: np.ndarray, seed: int) -> dict:
    """The depth estimators: ZoeDepth N and NK at full width and the
    merge net and LeReSBoost card against CPU in f32, then the zoe,
    zoe_nk and leres_boost clips. Returns their launches by name."""
    from cartoonsegmentation_torch.device import resolve_device
    resolve_device('cuda')              # TF32 off: the nets run in f32
    zoe = {}
    for nk in (False, True):
        tag = 'ZoeDepthNK' if nk else 'ZoeDepth'
        zoe[nk] = edged_zoe(seed, img, nk)
        compare_zoe_card_cpu(zoe[nk], img, tag)
    compare_boost_card_cpu(seed)
    return {est: depth_clip(det_net, isnet, img, seed, est,
                            {'depth_est': est},
                            {'zoe_net': copy.deepcopy(z)} if z else None)
            for est, z in (('zoe', zoe[False]), ('zoe_nk', zoe[True]),
                           ('leres_boost', None))}


# the diffusion models at full width, random from the seed: Marigold (the
# SD2 UNet with 8 input channels, the SD VAE, LCM 4 steps, ensemble 5)
# and SD1.5 inpainting (9 input channels, 1x1-conv projections, CLIP-L
# context, DDIM 32 steps with CFG 7); card against CPU at small sizes
DIFF_TOL = 1e-4         # one net's output, card vs CPU, share of its range
MARIGOLD_TOL = 1e-3     # Marigold's depth after 4 steps and the merge
DIFF_E2E = 128          # the end-to-end compares' image side (16x16 latent)


def card_cpu(tag: str, got: torch.Tensor, want: torch.Tensor,
             tol: float) -> None:
    """Print the CPU output's range and the card's largest difference
    beside tol x range; fail beyond it."""
    got, want = got.float().cpu(), want.float()
    err = float((got - want).abs().max())
    lo, hi = float(want.min()), float(want.max())
    print(f'[diffusion] {tag} card vs cpu: range {lo:.4g}..{hi:.4g}, max '
          f'|diff| {err:.3g}, tolerance {tol:g} x range = '
          f'{tol * (hi - lo):.3g}', flush=True)
    if not hi > lo or not err <= tol * (hi - lo):
        fail(f'diffusion: {tag} on the card differs from the CPU by {err} '
             f'(range {hi - lo})')


def seeded_clip_sd(cfg: dict, seed: int) -> dict:
    """A CLIP text tower of the setting ``cfg`` drawn on the card from
    ``seed`` (``init_random_``): its state dict, on the card."""
    from cartoonsegmentation_torch.models.clip import ClipTextModel
    from cartoonsegmentation_torch.models.ldm import init_random_
    with torch.device('meta'):
        m = ClipTextModel(**cfg)
    m.to_empty(device='cuda')
    init_random_(m, torch.Generator('cuda').manual_seed(seed))
    return m.state_dict()


def sdpa_backends() -> None:
    """The backend PyTorch's SDPA picks in f32 (TF32 off) for the
    diffusion models' largest attentions, with its time and the memory
    the call holds above its inputs: the VAE mid block's one head of
    width 512 at a 72x128 latent (the inpainter's), the inpainting
    UNet's level 0 and Marigold's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    names = {int(v): k for k, v in SDPBackend.__members__.items()}
    gen = torch.Generator('cuda').manual_seed(0)
    for tag, shape in (
            ('VAE mid attention, 72x128 latent', (1, 1, 9216, 512)),
            ('inpainting UNet level 0, 72x128, CFG pair', (2, 8, 9216, 40)),
            ("Marigold's UNet level 0, 56x96, ensemble 5",
             (5, 5, 5376, 64))):
        q, k, v = (torch.randn(shape, device='cuda', generator=gen)
                   for _ in range(3))
        choice = names.get(int(torch._fused_sdp_choice(q, k, v)), '?')
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda x: F.scaled_dot_product_attention(*x),
                     [(q, k, v)] * 5)
        B, Hh, N, d = shape
        flops = 4.0 * B * Hh * N * N * d
        print(f'[diffusion] SDPA {tag} {shape} f32: backend {choice}, '
              f'{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), '
              f'{held / 2 ** 20:.1f} MiB held above the inputs (the '
              f'{N}x{N} f32 scores of one head: '
              f'{N * N * 4 / 2 ** 20:.0f} MiB)', flush=True)
        del q, k, v


def compare_diffusion_nets(mg, li, seed: int) -> None:
    """Each net at full width in f32, card against CPU (the card's
    weights copied to the host), within DIFF_TOL of its output's range:
    both UNets at a 16x16 latent (Marigold's on its text embedding at
    t 999, the inpainter's on the CFG pair at t 962), Marigold's VAE
    encoder (mean and logvar) at 128x128 and decoder from 16x16, both
    CLIP towers (SD2 on the empty prompt, SD1.5 on 77 ids), and
    ``ensemble_depths`` at (5, 448, 768), timed on the card."""
    from cartoonsegmentation_torch.models.clip import (SD2_TEXT, SD15_TEXT,
                                                       clip_text_embed)
    from cartoonsegmentation_torch.models.marigold import (EMPTY_PROMPT_IDS,
                                                           ensemble_depths)
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randn(1, 8, 16, 16, generator=g)
    x9 = torch.randn(2, 9, 16, 16, generator=g)
    img = torch.rand(1, 3, 128, 128, generator=g) * 2 - 1
    z = torch.randn(1, 4, 16, 16, generator=g)
    ctx9 = torch.cat([li.uncond, li.cond], 0)
    with torch.inference_mode():
        cases = (
            ("Marigold's UNet (SD2, 8 channels) at 16x16",
             mg.unet, lambda n, dv: n(x8.to(dv), torch.tensor([999], device=dv),
                                      mg.text_embed.to(dv))),
            ("the inpainter's UNet (SD1.5, 9 channels) at 16x16",
             li.unet, lambda n, dv: n(x9.to(dv), torch.tensor([962, 962],
                                                              device=dv),
                                      ctx9.to(dv))),
            ("Marigold's VAE encoder (mean) at 128x128",
             mg.vae, lambda n, dv: n.encode(img.to(dv))[0]),
            ("Marigold's VAE encoder (logvar) at 128x128",
             mg.vae, lambda n, dv: n.encode(img.to(dv))[1]),
            ("Marigold's VAE decoder from 16x16",
             mg.vae, lambda n, dv: n.decode(z.to(dv))))
        for tag, net, fn in cases:
            got = fn(net, 'cuda').cpu()
            twin = copy.deepcopy(net).cpu()
            t0 = time.perf_counter()
            want = fn(twin, 'cpu')
            tc = time.perf_counter() - t0
            del twin
            card_cpu(f'{tag} ({tc:.1f} s on the CPU)', got, want, DIFF_TOL)
        ids15 = [49406] + [320 + 7 * i for i in range(20)] + [49407] * 56
        for tag, cfg, ids in (('the SD2 CLIP tower (23 layers, 1024) on '
                               'the empty prompt', SD2_TEXT,
                               EMPTY_PROMPT_IDS),
                              ('the SD1.5 CLIP tower (12 layers, 768) on '
                               '77 ids', SD15_TEXT, ids15)):
            sd = seeded_clip_sd(cfg, seed)
            got = clip_text_embed(sd, ids, device='cuda', **cfg)
            want = clip_text_embed({k: v.cpu() for k, v in sd.items()}, ids,
                                   device='cpu', **cfg)
            card_cpu(tag, got, want, DIFF_TOL)
            del sd
        # five members of one depth, each under its own scale and shift,
        # with noise (a trained model's members agree up to those)
        smooth = torch.nn.functional.interpolate(
            torch.rand(1, 1, 28, 48, generator=g), size=(448, 768),
            mode='bicubic')[0]
        preds = smooth * torch.tensor([1.0, 3.0, 0.5, 2.0, 1.5])[:, None, None] \
            + torch.tensor([0.0, -1.0, 7.0, 2.0, -0.5])[:, None, None] \
            + torch.randn(5, 448, 768, generator=g) * 0.01
        pc = preds.cuda()
        got = ensemble_depths(pc)
        ms = time_ms(ensemble_depths, [pc] * 5)
        card_cpu(f'ensemble_depths at (5, 448, 768) ({ms:.3f} ms on the '
                 f'card)', got, ensemble_depths(preds), DIFF_TOL)


def compare_diffusion_models(mg, li, img: np.ndarray) -> None:
    """MarigoldDepth and LDMInpainter end to end at full width, card
    against CPU on the same host-drawn noise, on a DIFF_E2E-square crop of
    the image (a 16x16 latent): Marigold's 4 LCM steps at ensemble 5 and
    its merge, the depth within MARIGOLD_TOL of its range; the
    inpainter's 32 DDIM steps with CFG on a hole of a third of the crop,
    >= 99.5% of its bytes within 1 level."""
    s = DIFF_E2E
    crop = np.ascontiguousarray(img[200:200 + s, 400:400 + s])
    rgb = np.ascontiguousarray(crop[..., ::-1])
    ph, pw, lh, lw = mg.latent_hw(s, s)
    noise = mg.draw_noise(lh, lw)
    t0 = time.perf_counter()
    got = mg(rgb, noise=noise)
    torch.cuda.synchronize()
    tk = time.perf_counter() - t0
    twin = copy.deepcopy(mg).cpu()
    t0 = time.perf_counter()
    want = twin(rgb, noise=noise)
    tc = time.perf_counter() - t0
    del twin
    card_cpu(f'MarigoldDepth end to end at {s}x{s} ({ph}x{pw}, latent '
             f'{lh}x{lw}; card {tk:.2f} s, CPU {tc:.1f} s)', got, want,
             MARIGOLD_TOL)
    mask = np.zeros((s, s), np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    mask[(xx - s / 2) ** 2 + (yy - s / 2) ** 2 < (s * 0.33) ** 2] = 255
    rh, rw, lh, lw = li.size_for(s, s, s)
    noise = li.draw_noise(lh, lw)
    t0 = time.perf_counter()
    got = li(crop, mask, noise=noise)
    tk = time.perf_counter() - t0
    twin = copy.deepcopy(li).cpu()
    t0 = time.perf_counter()
    want = twin(crop, mask, noise=noise)
    tc = time.perf_counter() - t0
    del twin
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    hole = mask > 0
    close = float((d <= 1).mean())
    changed = float((want != crop).any(-1)[hole].mean())
    print(f'[diffusion] LDMInpainter end to end at {s}x{s} (latent '
          f'{lh}x{lw}, {li.steps} steps, CFG {li.guidance}; card {tk:.2f} s, '
          f'CPU {tc:.1f} s) card vs cpu: {close:.5f} of bytes within 1 '
          f'level, max diff {int(d.max())}; the hole {hole.mean():.3f} of '
          f'the crop, {changed:.3f} of its pixels changed', flush=True)
    if close < 0.995:
        fail(f'diffusion: only {close} of the inpainter\'s bytes within 1 '
             f'level of the CPU\'s')
    if changed < 0.5 or (got[~hole] != crop[~hole]).any():
        fail('diffusion: the inpainter left the hole as it was or changed '
             'pixels outside it')


class NativePasses:
    """LDMInpainter's calls while the block runs: each call's seconds,
    the hole mask's share of the frame and the share of its pixels the
    call changed."""

    def __enter__(self):
        from cartoonsegmentation_torch.models.ldm_inpaint import LDMInpainter
        self.cls, self.real = LDMInpainter, LDMInpainter.forward
        self.calls = []
        real = self.real

        def rec(m, img, mask, **k):
            t0 = time.perf_counter()
            out = real(m, img, mask, **k)
            hole = np.asarray(mask) > 0
            self.calls.append((time.perf_counter() - t0, float(hole.mean()),
                               float((out != img).any(-1)[hole].mean())))
            return out
        LDMInpainter.forward = rec
        return self.calls

    def __exit__(self, *exc):
        self.cls.forward = self.real


def diffusion_phase(det_net, isnet, img: np.ndarray, seed: int) -> dict:
    """The two diffusion options: Marigold and the SD1.5 inpainter drawn
    on the card as the pipeline draws them, SDPA's backends at their attentions, each
    net and both models card against CPU, then the shipped default with
    ``depth_est: marigold`` and with ``inpaint_type: ldm_native`` at
    576x1024, 75 frames each, the pipelines drawing their models
    themselves (the same weights: checked). Returns their launches."""
    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.device import resolve_device
    from cartoonsegmentation_torch.models.ldm_inpaint import LDMInpainter
    from cartoonsegmentation_torch.models.marigold import MarigoldDepth
    resolve_device('cuda')              # TF32 off: the nets run in f32
    t0 = time.perf_counter()
    # as the pipeline makes them: Marigold from its seed, the inpainter
    # from ldm_inpaint_options (steps, cfg_scale, seed)
    mg = MarigoldDepth(seed=seed).init_random('cuda')
    o = KenBurnsConfig().ldm_inpaint_options
    li = LDMInpainter(steps=o.steps, guidance=o.cfg_scale,
                      seed=o.seed).init_random('cuda')
    torch.cuda.synchronize()

    def params(m):
        return sum(p.numel() for p in m.parameters()) / 1e6
    print(f'[diffusion] Marigold (UNet {params(mg.unet):.1f}M, VAE '
          f'{params(mg.vae):.1f}M parameters) and the inpainter (UNet '
          f'{params(li.unet):.1f}M, VAE {params(li.vae):.1f}M) drawn on the '
          f'card in {time.perf_counter() - t0:.2f} s', flush=True)
    sdpa_backends()
    compare_diffusion_nets(mg, li, seed)
    compare_diffusion_models(mg, li, img)
    probe = {'marigold': mg.unet.conv_in.weight[:2].clone(),
             'ldm_native': li.unet.conv_in.weight[:2].clone()}
    del mg, li
    torch.cuda.empty_cache()

    def same_weights(attr, tag):
        def check(pipe):
            w = getattr(pipe, attr).unet.conv_in.weight[:2]
            if not torch.equal(w, probe[tag]):
                fail(f'{tag}: the pipeline drew other weights from the seed')
        return check

    def marigold_after(pipe):
        same_weights('marigold', 'marigold')(pipe)
        print(f'[marigold] depth_estimate {pipe.timer.seconds["depth_estimate"]:.3f} '
              f's (the model drawn on the card at first use included)',
              flush=True)
    launches = {'marigold': depth_clip(
        det_net, isnet, img, seed, 'marigold', {'depth_est': 'marigold'},
        after=marigold_after)}
    with NativePasses() as calls:
        launches['ldm_native'] = depth_clip(
            det_net, isnet, img, seed, 'ldm_native',
            {'inpaint_type': 'ldm_native'},
            after=same_weights('ldm_inpainter', 'ldm_native'))
    for i, (sec, share, changed) in enumerate(calls):
        print(f'[ldm_native] pass {i}: {sec:.3f} s, the dilated hole mask '
              f'{share:.4f} of the frame, {changed:.4f} of its pixels '
              f'changed', flush=True)
    if len(calls) != 2 or min(c[2] for c in calls) <= 0.0:
        fail(f'ldm_native: {len(calls)} inpainter calls, expected 2, each '
             f'changing pixels of its hole')
    torch.cuda.empty_cache()
    return launches


def ldm_phase(root: str, det_net, sam_net, img: np.ndarray, seed: int
              ) -> dict:
    """configs/3dkenburns_sam.yaml as shipped (detector 'sam',
    inpaint_type 'ldm') against the stub sd-webui on 127.0.0.1, at the
    shipped URL's port where it is free: one img2img request a pass at
    the /32 rule's size, the mask sent equal to the pass's hole mask
    (``existing`` == 0 or a rendered instance) dilated by the 5-px
    ellipse, and the stub's reply, resized back with PIL's LANCZOS and
    flipped to BGR, in the cloud as the colours of the points that pass
    appended. Returns the launches."""
    import base64
    import urllib.parse
    import cv2
    from PIL import Image
    from cartoonsegmentation_torch.config import build_kenburns_cfg
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    path = os.path.join(root, 'configs', '3dkenburns_sam.yaml')
    cfg = build_kenburns_cfg(path)
    port = urllib.parse.urlparse(cfg.sd_img2img_url).port
    try:
        srv, url, calls = stub_sd_server(port)
    except OSError as e:
        srv, url, calls = stub_sd_server()
        print(f'[ldm] port {port} is taken ({e}): the stub listens at {url}',
              flush=True)
    if url != cfg.sd_img2img_url:
        cfg = cfg.replace(sd_img2img_url=url)
    print(f'[ldm] {path}: detector {cfg.detector}, inpaint_type '
          f'{cfg.inpaint_type!r}, ldm_inpaint_size {cfg.ldm_inpaint_size}, '
          f'stub at {cfg.sd_img2img_url}', flush=True)
    pipe = KenBurnsPipeline(cfg, seed=seed, device='cuda')
    pipe.ensure_detector()
    pipe._detector.box_detector.model = copy.deepcopy(det_net)
    pipe._detector.sam.model = sam_net
    seen = []
    host_fill = pipe._host_fill

    def recorded(out):
        filled = host_fill(out)
        seen.append((out['existing'][..., 0].cpu().numpy(),
                     out['segmasks'][..., 0].cpu().numpy(),
                     filled.cpu().numpy()))
        return filled
    pipe._host_fill = recorded
    try:
        launches = run_clip(pipe, img, 'ldm')
    finally:
        srv.shutdown()
        srv.server_close()
    require_launches('ldm', launches,
                     ('splat', 'coverage', 'discfill', 'median5', 'laplacian',
                      'nms', 'maskhead', 'epilogue', 'compact', 'samattn'))
    h, w = img.shape[:2]
    res = cfg.ldm_inpaint_size or cfg.max_size
    want = (res, int((w / h * res) // 32 * 32)) if h <= w else \
        (int((h / w * res) // 32 * 32), res)
    if len(calls) != 2 or len(seen) != 2:
        fail(f'ldm: {len(calls)} requests and {len(seen)} fills, expected '
             f'2 (one a pass)')
    el = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (11, 11))
    cloud = pipe.last_state.cloud
    colors = cloud.colors[:int(cloud.count)].cpu().numpy()
    start = h * w
    for i, (call, reply, (existing, seg, filled)) in enumerate(
            zip(calls, srv.replies, seen)):
        size = (call['height'], call['width'])
        if size != want:
            fail(f'ldm: pass {i} asked for {size}, the /32 rule gives {want}')
        hole = existing == 0
        mask = ((hole | (seg > 0)) * 255).astype(np.uint8)
        sent = cv2.imdecode(np.frombuffer(base64.b64decode(call['mask']),
                                          np.uint8), cv2.IMREAD_UNCHANGED)
        if not np.array_equal(sent, cv2.dilate(mask, el)):
            fail(f'ldm: pass {i} sent a mask other than the dilated holes')
        rgb = cv2.imdecode(np.frombuffer(base64.b64decode(reply[0]),
                                         np.uint8), cv2.IMREAD_COLOR)
        rgb = np.ascontiguousarray(rgb[..., ::-1])
        back = np.array(Image.fromarray(rgb).resize(
            (w, h), resample=Image.Resampling.LANCZOS))[..., ::-1]
        if not np.array_equal(filled, back.astype(np.float32) / 255.0):
            fail(f'ldm: pass {i}\'s fill is not the stub\'s reply')
        n = int(hole.sum())
        if not np.array_equal(colors[start:start + n],
                              filled.reshape(-1, 3)[hole.reshape(-1)]):
            fail(f'ldm: pass {i}\'s appended colours are not the reply\'s')
        print(f'[ldm] pass {i}: {size[1]}x{size[0]} request, hole '
              f'{hole.mean():.4f} and instances {(seg > 0).mean():.4f} of '
              f'the frame, the sent mask {(sent > 0).mean():.4f} (dilated), '
              f'{n} points of the reply appended', flush=True)
        start += n
    check_instances(pipe, 'ldm')
    return launches


def cli_phase(root: str, seed: int, pipe) -> None:
    """``python -m cartoonsegmentation_torch.run_kenburns --verbose
    --trace-dir DIR --no-detector`` (the shipped YAML) on a 288x512
    image in a subprocess: the stage images written, the trace holding
    CUDA kernel events. Then ``stream_video`` of 9 frames rendered on
    the card by ``pipe`` (its last clip): through BGR chunks its frames
    are the frames and its clip decodes as ``write_video``'s of them;
    through I420 its frames are their I420 round trip on the CPU."""
    import cv2
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.kenburns import (stream_video,
                                                             write_video)
    from cartoonsegmentation_torch.utils.image import (bgr_to_i420,
                                                       i420_to_bgr_host)
    from cartoonsegmentation_torch.utils.profiling import trace_events
    tmp = tempfile.mkdtemp(prefix='cli_', dir=str(_cuda.BUILD_DIR))
    try:
        src = os.path.join(tmp, 'pic.png')
        cv2.imwrite(src, make_image(seed, 288, 512))
        out, tdir = os.path.join(tmp, 'out'), os.path.join(tmp, 'trace')
        cmd = [sys.executable, '-m', 'cartoonsegmentation_torch.run_kenburns',
               '--input-img', src, '--save-dir', out, '--no-detector',
               '--verbose', '--trace-dir', tdir, '--seed', str(seed)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        tail = '\n'.join(proc.stdout.strip().splitlines()[-3:])
        print(f'[cli] {" ".join(cmd[1:4])} ... exit {proc.returncode} in '
              f'{wall:.1f} s:\n{tail}', flush=True)
        if proc.returncode != 0:
            fail(f'cli: run_kenburns exited {proc.returncode}: '
                 f'{proc.stderr[-2000:]}')
        stages = sorted(f[len('tmp_stage_'):-len('_pic.png')]
                        for f in os.listdir(out) if f.startswith('tmp_stage_'))
        plain = [s for s in stages if not s.startswith('inpainted_')]
        print(f'[cli] stage images: {stages}', flush=True)
        if plain != ['depth_adjusted', 'depth_coarse', 'depth_final',
                     'input'] or len(stages) != len(plain) + 2:
            fail(f'cli: --verbose wrote the stages {stages}')
        kernels, other = trace_events(os.path.join(tdir, 'trace.json'))
        print(f'[cli] trace: {kernels} CUDA kernel events, {other} other '
              f'events ({os.path.getsize(os.path.join(tdir, "trace.json"))} '
              f'bytes)', flush=True)
        if kernels == 0:
            fail('cli: the --trace-dir trace holds no CUDA kernel event')
        state, (obj_from, obj_to) = pipe.last_state, pipe.last_boxes
        frames = pipe.render_frames(state, obj_from, obj_to,
                                    np.linspace(0.0, 1.0, 9),
                                    return_device=True)
        host = frames.cpu().numpy()
        got = stream_video(frames, os.path.join(tmp, 'a.mp4'), yuv420=False)
        ref = write_video(host, os.path.join(tmp, 'b.mp4'))
        same_clip = all(np.array_equal(a, b) for a, b in zip(
            decode_video(os.path.join(tmp, 'a.mp4')), decode_video(ref)))
        n = video_frames(os.path.join(tmp, 'a.mp4'), *host.shape[1:3])
        got_i420 = stream_video(frames, os.path.join(tmp, 'c.mp4'))
        want_i420 = i420_to_bgr_host(bgr_to_i420(torch.from_numpy(host))
                                     .numpy())
        print(f'[cli] stream_video of {len(host)} frames on the card: BGR '
              f'frames equal {np.array_equal(got, host)}, the clip equal to '
              f'write_video\'s {same_clip} ({n} frames); I420 frames equal '
              f'the CPU round trip {np.array_equal(got_i420, want_i420)}',
              flush=True)
        if not (np.array_equal(got, host) and same_clip and n == 16
                and np.array_equal(got_i420, want_i420)):
            fail('cli: stream_video differs from write_video')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _http(base: str, route: str, data: bytes = None, timeout: int = 600):
    """(content type, body, seconds) of a GET (a POST with data) to the
    server; any status but 200 fails the run."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                base + route, data=data), timeout=timeout) as r:
            ctype, body = r.headers['Content-Type'], r.read()
    except urllib.error.HTTPError as e:
        fail(f'serve: {route} answered {e.code}: {e.read()[:300]!r}')
    return ctype, body, time.perf_counter() - t0


def serve_phase(pipe, img: np.ndarray) -> dict:
    """[serve]: the shipped default pipeline of the main path (edged
    nets) behind the port's server (``serve(..., block=False,
    segmentor=...)`` on 127.0.0.1:0), driven over HTTP with urllib:
    /health, POST /load_image, /get_live at t = 0, 0.5 (again, cached)
    and 1, POST /update_to, /step_inpaint, /get_result (its mp4 decoded
    with cv2), /segment without tags, three parts of the MJPEG stream.
    The t = 0.5 frame, decoded, against the card's render of the
    service's state, JPEG-coded the same way, and that render against
    the plain versions on the CPU (each >= 99.5% of values within 1 LSB:
    the splat's sums are summed in an order its atomics pick);
    /segment's instances are ``infer``'s on the same image. Returns the
    launches of the requests."""
    import cv2
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    from cartoonsegmentation_torch.serving.interface import serve
    srv = serve(pipe, '127.0.0.1', 0, block=False, segmentor=pipe._detector)
    svc = srv.service
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    png = cv2.imencode('.png', img)[1].tobytes()
    T = pipe.cfg.num_frame
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        health = json.loads(_http(base, '/health')[1])
        if not health['ok'] or health['loaded']:
            fail(f'serve: /health {health}')
        _, body, load_s = _http(base, '/load_image', png)
        meta = json.loads(body)
        if (meta['height'], meta['width']) != img.shape[:2]:
            fail(f'serve: /load_image meta {meta}')
        live = {}
        for t in (0.0, 0.5, 1.0):
            ctype, body, sec = _http(base, f'/get_live?fltTime={t}')
            if ctype != 'image/jpeg':
                fail(f'serve: /get_live answered {ctype}')
            live[t] = (body, 1e3 * sec)
        _, cached, sec = _http(base, '/get_live?fltTime=0.5')
        cached_ms = 1e3 * sec
        if cached != live[0.5][0]:
            fail('serve: the cached /get_live frame differs')
        # the route's frame against the card's render of the state, and
        # that render against the plain versions on the CPU
        steps = np.asarray([0.5], np.float32)
        with torch.inference_mode():
            fk = pipe.render_frames(svc.state, svc.obj_from, svc.obj_to,
                                    steps, depth_field=False)
        cpu = KenBurnsPipeline(pipe.cfg, device='cpu')
        fp = cpu.render_frames(svc.state.to('cpu'), svc.obj_from, svc.obj_to,
                               steps, depth_field=False)

        def jpeg(f):
            return cv2.imdecode(cv2.imencode(
                '.jpg', f, [cv2.IMWRITE_JPEG_QUALITY, 80])[1],
                cv2.IMREAD_COLOR)
        route = cv2.imdecode(np.frombuffer(live[0.5][0], np.uint8),
                             cv2.IMREAD_COLOR)
        for tag, a, b in (('the card\'s render, JPEG-coded', route,
                           jpeg(fk[0])),
                          ('the plain versions (CPU), raw', fk, fp)):
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            close = float((diff <= 1).mean())
            print(f'[serve] /get_live t=0.5 vs {tag}: {close:.5f} of values '
                  f'within 1 LSB, max diff {int(diff.max())}', flush=True)
            if close < 0.995:
                fail(f'serve: the live frame against {tag}: only '
                     f'{close:.4f} of values within 1 LSB')
        box = dict(meta['objTo'], center_u=meta['objTo']['center_u'] + 8.0)
        if json.loads(_http(base, '/update_to',
                            json.dumps(box).encode())[1]) != {'ok': True}:
            fail('serve: /update_to')
        st = json.loads(_http(base, '/step_inpaint', b'{}')[1])
        if not st['ok'] or not svc.inpainted:
            fail(f'serve: /step_inpaint {st}')
        ctype, clip, result_s = _http(base, '/get_result')
        tmp = tempfile.mkdtemp(prefix='serve_', dir=str(_cuda.BUILD_DIR))
        try:
            path = os.path.join(tmp, 'result.mp4')
            with open(path, 'wb') as f:
                f.write(clip)
            frames = decode_video(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        want = T + (T - 2 if pipe.cfg.playback else 0)
        if ctype != 'video/mp4' or len(frames) != want or \
                frames[0].shape != img.shape:
            fail(f'serve: /get_result {ctype}, {len(frames)} frames, '
                 f'expected {want} ({T} and the palindrome tail)')
        seg = json.loads(_http(base, '/segment', png)[1])
        if 'note' in seg:
            fail(f'serve: /segment noted {seg["note"]}')
        with torch.inference_mode():
            ins = pipe._detector.infer(img)
        valid = ins.valid.cpu().numpy()
        want_boxes = [[float(v) for v in b]
                      for b in ins.bboxes.cpu().numpy()[valid]]
        got_boxes = [r['bbox'] for r in seg['instances']]
        if got_boxes != want_boxes or not got_boxes:
            fail(f'serve: /segment boxes {got_boxes} are not infer\'s '
                 f'{want_boxes}')
        import urllib.request
        with urllib.request.urlopen(base + '/get_live', timeout=600) as r:
            buf = b''
            while buf.count(b'--frame') < 4:
                chunk = r.read1(1 << 16)
                if not chunk:
                    fail('serve: the MJPEG stream ended')
                buf += chunk
        for part in buf.split(b'--frame')[1:4]:
            f = cv2.imdecode(np.frombuffer(
                part.split(b'\r\n\r\n', 1)[1].rstrip(b'\r\n'), np.uint8),
                cv2.IMREAD_COLOR)
            if f is None or f.shape != img.shape:
                fail('serve: an MJPEG part does not decode to a frame')
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
    print(f'[serve] {card_line()}: /load_image {load_s:.3f} s, /get_live '
          f'first {live[0.0][1]:.1f} ms (t=0), t=0.5 first '
          f'{live[0.5][1]:.1f} ms, cached {cached_ms:.1f} ms, /get_result '
          f'{result_s:.3f} s ({len(frames)} frames), /segment '
          f'{len(got_boxes)} instances = infer\'s; 3 MJPEG parts; launches '
          f'{launches}', flush=True)
    return launches


def segment_api_phase(det_net, img: np.ndarray, state, cfg, seed: int
                      ) -> tuple:
    """[segment_api]: the detector's API on the card with the edged
    detector in f32 (no refine; its boxes given an area): ``infer_batch`` on 3 images against 3
    ``infer`` calls (validity exact, boxes within 1e-3 px, masks >=
    99.9%); ``segment_with_bboxes`` with Q = 5 boxes (K9's probabilities
    at the matched candidates within 1e-5 of its plain version, one K9
    launch, valid and masks against the CPU's); ``render_coverage`` (K1
    at C = 0) on the main clip's cloud unshifted, its count equal to
    the plain version's and at most K2's at zero shift, timed; and
    ``spatial_filter('median-3')`` once. Returns (the launches of the
    API calls, K1 at C = 0's timings)."""
    from cartoonsegmentation_torch.models import rtmdet
    from cartoonsegmentation_torch.ops import _cuda, filters, pointcloud
    from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg

    def seg(dev):
        s = AnimeInsSeg(dtype='float32', device=dev, seed=seed)
        s.model = copy.deepcopy(det_net).float()
        # a random trunk's box distances sit near relu(0) = 0, so every
        # candidate's box is empty and no given box matches one: the
        # reg convs' bias puts each prior's box ~8 strides wide
        with torch.no_grad():
            for conv in s.model.bbox_head.rtm_reg:
                conv.bias.fill_(4.0)
        return s
    det, cpu_det = seg('cuda'), seg('cpu')
    imgs = [img, make_image(seed + 1), make_image(seed + 2, 480, 360)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    batch = det.infer_batch(imgs)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    for i, (im, got) in enumerate(zip(imgs, batch)):
        want = det.infer(im)
        if not torch.equal(got.valid, want.valid):
            fail(f'segment_api: infer_batch image {i} validity differs '
                 f'from infer')
        v = want.valid
        err = float((got.bboxes[v] - want.bboxes[v]).abs().max()) \
            if bool(v.any()) else 0.0
        share = float((got.masks == want.masks).float().mean())
        print(f'[segment_api] infer_batch image {i} {im.shape[:2]}: '
              f'{int(v.sum())} valid = infer\'s, boxes within {err:.3g} px, '
              f'masks {share:.5f} equal', flush=True)
        if err > 1e-3 or share < 0.999:
            fail(f'segment_api: infer_batch image {i} against infer: boxes '
                 f'{err}, masks {share}')
    # the image boxes of the 4 best candidates with an area (a random
    # net's boxes are often empty) and one far outside the image
    emb, _, scale, _ = det.infer_embeddings(img)
    cand = emb['bboxes']
    wide = ((cand[:, 2] - cand[:, 0] > 2) & (cand[:, 3] - cand[:, 1] > 2))
    boxes = np.concatenate([
        (cand[wide][:4] / scale).cpu().numpy(),
        [[-900.0, -900.0, -800.0, -800.0]]]).astype(np.float32)
    if len(boxes) != 5:
        fail(f'segment_api: {len(boxes) - 1} candidates with an area')
    match = rtmdet.box_iou(torch.from_numpy(boxes).cuda() * scale,
                           emb['bboxes']).argmax(1)
    args = [emb['mask_feat'], emb['kernels'][match], emb['priors'][match],
            emb['strides'][match], torch.zeros(5, dtype=torch.bool,
                                               device='cuda'),
            det.det_size, det.det_size, det.mask_thr]
    pk = rtmdet.dynamic_masks(*args)[1]
    pp = rtmdet.dynamic_masks_plain(*args)[1]
    perr = float((pk - pp).abs().max())
    before = _cuda.LAUNCHES['maskhead']
    got = det.segment_with_bboxes(img, boxes)
    torch.cuda.synchronize()
    n_k9 = _cuda.LAUNCHES['maskhead'] - before
    launches['maskhead'] += n_k9
    want = cpu_det.segment_with_bboxes(img, boxes)
    share = float((got.masks.cpu() == want.masks).float().mean())
    print(f'[segment_api] segment_with_bboxes Q=5: K9 probabilities within '
          f'{perr:.3g} of the plain version, {n_k9} K9 launch, valid '
          f'{got.valid.cpu().tolist()}, masks {share:.5f} equal to the '
          f'CPU\'s', flush=True)
    if perr > 1e-5 or n_k9 != 1 or share < 0.999 or not torch.equal(
            got.valid.cpu(), want.valid) or got.valid.cpu().tolist() != [
                True] * 4 + [False]:
        fail('segment_api: segment_with_bboxes against its plain version '
             'and the CPU')

    # K1 at C = 0 on the clip's cloud at zero shift
    pts = pointcloud.shift_points(state.raw_points,
                                  torch.zeros(3, device='cuda')).contiguous()
    f, b = cfg.focal, cfg.baseline
    before = _cuda.LAUNCHES['splat']
    count = int(pointcloud.render_coverage(pts, H, W, f, b))
    launches['splat'] += _cuda.LAUNCHES['splat'] - before
    _, wp, _ = pointcloud.splat_plain(pts, pts.new_zeros((len(pts), 0)), H,
                                      W, f, b)
    plain = int((wp > 0).sum())
    k2 = int(pointcloud.coverage(pts, torch.zeros((1, 3), device='cuda'), H,
                                 W, f, b)[0])
    # K2 counts without the z-test, so it covers a superset: the pixels
    # whose every contributor the degrid-lowered z-buffer rejects are
    # its alone (JAX's render_coverage_fast docstring)
    print(f'[segment_api] render_coverage (K1 at C = 0) on the main clip\'s '
          f'{len(pts)} points: {count} pixels, plain {plain}, K2 at zero '
          f'shift {k2} ({k2 - count} pixels without the z-test)',
          flush=True)
    if count != plain or k2 < count:
        fail('segment_api: render_coverage differs from the plain version '
             'or counts more than K2 at zero shift')
    shifted = [pointcloud.shift_points(pts, torch.tensor(
        [0.3 * i, -0.2 * i, 0.5 * i], device='cuda')).contiguous()
        for i in range(RUNS)]
    zero = pts.new_zeros((len(pts), 0))
    nv = int((pts[:, 2] >= 0.001).sum())
    bnd, by = bound(nv * 12 + (len(pts) - nv) * 4 + H * W * 8,
                    nv * (22 + 4 * 2))
    c0 = dict(
        max_abs_err=0.0, bound_ms=bnd, bound_by=by,
        ms=time_ms(lambda x: pointcloud.render_coverage(x, H, W, f, b),
                   shifted),
        plain_ms=time_ms(lambda x: (pointcloud.splat_plain(
            x, zero, H, W, f, b)[1] > 0).sum(), shifted),
        device_ms=graph_ms(lambda x: pointcloud.splat(x, zero, H, W, f, b),
                           shifted[0]))
    print(f'[kernel] splat c0 (render_coverage) P={len(pts)}: kernel '
          f'{c0["ms"]:.4f} ms (device {c0["device_ms"]:.4f} ms), plain '
          f'{c0["plain_ms"]:.4f} ms, bound {bnd:.4f} ms ({by})', flush=True)

    before = _cuda.LAUNCHES['median3']
    filters.spatial_filter((state.disparity / 40.0).contiguous(), 'median-3')
    launches['median3'] += _cuda.LAUNCHES['median3'] - before
    return launches, c0


# K1-K10: the kernels of the shipped default's clip and of the server's
# routes on it
K1_K10 = ('splat', 'coverage', 'discfill', 'bokeh', 'insmedian', 'median5',
          'laplacian', 'nms', 'maskhead', 'epilogue', 'colorize', 'compact')


def main() -> None:
    ap = argparse.ArgumentParser(description='GPU smoke run of the port')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--save-style-fill', metavar='PATH',
                    help='save the [style] phase\'s background fill inputs '
                    '(an .npz of the image and mask) for '
                    'render_kernel_times.py --style-fill-inputs')
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

    # 2. the host's cost of a kernel call; kernels against their plain
    # versions ---------------------------------------------------------
    host = host_phase(dev)
    gen = torch.Generator().manual_seed(args.seed)
    res = check_kernels(dev, gen)
    res['laplacian']['host_us'] = host
    img = make_image(args.seed)
    res.update(check_crf_kernels(dev, gen, img))
    res.update(check_swinattn(dev, gen))
    res.update(check_fill_kernels(dev, gen, img))

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
    appends = CompactCalls()
    try:
        launches = run_clip(pipe, img, 'main')
    finally:
        appends.close()
    require_launches('main', launches,
                     [k for k in _cuda.KERNELS if k not in (
                         'samattn', 'discfill_exact', 'roialign',
                         'nms_large', 'kmeans', 'crf', 'swinattn',
                         'pushpull', 'jitter', 'median3')])
    check_instances(pipe, 'main')
    cloud_copies(pipe, 'main')
    res['discfill_real'] = check_fill_real(real_fill_inputs(pipe))
    res['coverage_real'] = check_coverage_real(real_coverage_inputs(pipe))
    res['compact_real'] = check_compact_real(appends.calls)
    del appends

    # 5. kernel frames against the plain versions on the CPU ---------------
    compare_frames(pipe, 'main')
    state = pipe.last_state
    obj_from, obj_to = pipe.last_boxes

    # 6. the detector in f32, card against CPU; K8 and K9 on the calls
    # of the clip's own detector forward --------------------------------
    compare_detector(img, det_net)
    seen = detector_inputs(det_net, img, args.seed)
    res['nms_real'] = check_nms_calls(seen['nms'],
                                      "the shipped default's forward")
    res['maskhead_real'] = check_maskhead_calls(
        seen['maskhead'], "the shipped default's forward")
    del seen

    # 7. the main path again, warm, and where the frame loop's time goes
    pipe.timer.reset()
    run_clip(pipe, img, 'warm')
    profile_frame_loop(pipe, state, obj_from, obj_to)

    # 7a. [serve]: the port's server on the main path's pipeline, over
    # HTTP; [segment_api]: the rest of the detector's API, K1 at C = 0
    # and the 3x3 median ------------------------------------------------
    launches_serve = serve_phase(pipe, img)
    require_launches('serve', launches_serve, K1_K10)
    launches_seg, res['splat_c0'] = segment_api_phase(det_net, img, state,
                                                      pipe.cfg, args.seed)
    require_launches('segment_api', launches_seg,
                     ('splat', 'nms', 'maskhead', 'median3'))
    del pipe, state

    # 7b. the options clip: the animeseg refine, the 3D-Ken-Burns depth
    # with its Refine net, PatchMatch inpainting; each new net card
    # against CPU first --------------------------------------------------
    launches_opt, opt = options_phase(det_net, img, args.seed)

    # 7c. the depth estimators ZoeDepth (N, NK) and LeReS boosting: the
    # nets card against CPU, then a clip each ------------------------------
    launches_depth = zoe_boost_phase(det_net, isnet, img, args.seed)

    # 7d. the diffusion options: Marigold depth and latent-diffusion
    # inpainting, the nets card against CPU, then a clip each -----------
    launches_diff = diffusion_phase(det_net, isnet, img, args.seed)

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
    del sp

    # 9b. 3dkenburns_sam.yaml as shipped: the sd-webui 'ldm' inpainting
    # against a stub server ------------------------------------------------
    launches_ldm = ldm_phase(root, det_net, sam_net, img, args.seed)
    del sam_net

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
    res['discfill_exact_real'] = check_exact_fill(
        real_fill_inputs(mp), 'the Mask R-CNN clip\'s frames',
        mp.cfg.discfill_max_steps)
    compare_frames(mp, 'maskrcnn')
    del mp
    # K14 on the inputs of the clip's own detector forward
    real_k14 = check_k14(maskrcnn_inputs(mr_net, img),
                         "the Mask R-CNN clip's forward")
    res.update({f'{k}_real': v for k, v in real_k14.items()})

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
    crops = CrfCrops()
    launches_crf = run_clip(cp, img, 'crf')
    crops.close()
    require_launches('crf', launches_crf,
                     [k for k in _cuda.KERNELS if k not in (
                         'samattn', 'discfill_exact', 'roialign',
                         'nms_large', 'swinattn', 'pushpull', 'jitter',
                         'median3')])
    print(f'[crf] depth_refine {cp.timer.seconds["depth_refine"]:.3f} s: '
          f'{launches_crf["kmeans"]} segments reached the CRF, '
          f'{launches_crf["kmeans"]} kmeans and {launches_crf["crf"]} crf '
          f'launches; the crops (H x W): '
          f'{" ".join(f"{h}x{w}" for h, w in crops.shapes)}', flush=True)
    check_instances(cp, 'crf')
    compare_frames(cp, 'crf')
    ins_mask = seen['instances'].compose_masks().cpu().numpy()
    ins_mask = ins_mask if ins_mask.any() else None
    crf_disp = seen['disparity'][..., 0].cpu().numpy()
    # the crops' inputs, kept on a replay of the clip's refine after its
    # timed run (keeping them copies each to the host)
    from cartoonsegmentation_torch.pipeline.crf_refine import \
        refine_depth_crf
    kept = CrfCrops(keep=True)
    refine_depth_crf(seen['img'], crf_disp, ins_mask, device='cuda')
    kept.close()
    if kept.shapes != crops.shapes:
        fail(f'crf: the refine\'s replay made crops {kept.shapes}, the clip '
             f'{crops.shapes}')
    res['kmeans_crops'] = check_kmeans_crops(kept.inputs)
    compare_refine('crf', seen['img'], crf_disp, ins_mask)

    # 13. refine_depth_crf on layers over the image's shapes --------------
    segments = compare_refine('crf layers', img, layered_disparity(args.seed),
                              None)
    if segments < 5:
        fail(f'crf layers: {segments} segments reached the CRF, expected at '
             f'least 5')

    # 14. the danbooru tagger on the detector's instances -----------------
    launches_tag = tagger_phase(cp._detector, img, args.seed)

    # 15. the style flow: StyleEditor.repaint with the same detector and
    # tagger against a stub sd-webui server ------------------------------
    launches_style, style_dev = style_phase(cp._detector, img,
                                            args.save_style_fill)
    del cp

    # 16. the detector-free clip at a frame size I420 does not fit --------
    launches_odd = odd_clip_phase(args.seed)

    # 16b. the CLI with --verbose and --trace-dir; stream_video ----------
    cli_phase(root, args.seed, opt)
    del opt

    # 17. report --------------------------------------------------------
    src = 'cartoonsegmentation_torch/csrc/'
    tpu = 'cartoonsegmentation_tpu/'
    win = res['samattn_windowed']
    rows = [
        # the frame loop's C = 4; the Inpaint net's C = 68 and C = 4 with
        # the copies of one point beside it
        # render_coverage's C = 0 beside them
        ('splat', res['splat_c4'], 'ops/pointcloud.py:121',
         {f'{k}_{tag}': res[f'splat_{tag}'][k]
          for tag in ('c68', 'c4_copies', 'c0')
          for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                    'device_ms')}),
        # the synthetic miniature; the shipped default clip's own beside
        ('coverage', res['coverage'], 'ops/pointcloud.py:226',
         {f'{k}_real': v for k, v in res['coverage_real'].items()}),
        # the synthetic renders; the shipped default clip's frames beside
        ('discfill', res['discfill'], 'ops/discfill3.py:90',
         {f'{k}_real': v for k, v in res['discfill_real'].items()}),
        ('bokeh', res['bokeh'], 'ops/bokeh.py:253', {}),
        ('insmedian', res['insmedian'], 'pipeline/depth.py:67', {}),
        ('median5', res['median5'], 'ops/filters.py:42', {}),
        # the same function at size 3 (spatial_filter('median-3'))
        ('median3', res['median3'], 'ops/filters.py:42', {}),
        ('laplacian', res['laplacian'], 'ops/filters.py:26', {}),
        # the synthetic cases; the shipped default's own calls beside
        ('nms', res['nms'], 'models/rtmdet.py:194',
         {f'{k}_real': v for k, v in res['nms_real'].items()}),
        ('maskhead', res['maskhead'], 'models/rtmdet.py:222',
         {f'{k}_real': v for k, v in res['maskhead_real'].items()}),
        # crop_center_resize :146, the uint8 step pipeline/kenburns.py
        # :975, bgr_to_i420 :194
        ('epilogue', res['epilogue'], 'utils/image.py:146', {}),
        ('colorize', res['colorize'], 'pipeline/depth.py:113', {}),
        # the synthetic all-set append; the shipped default clip's three
        # appends beside it (device ms and bound summed, and each)
        ('compact', res['compact'], 'pipeline/state.py:58',
         {f'{k}_real': v for k, v in res['compact_real'].items()}),
        # the global blocks; the windowed ones beside them
        ('samattn', res['samattn_global'], 'models/sam.py:76',
         {f'{k}_windowed': win[k] for k in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'bound_unit', 'bound_ms_simt', 'library_ms', 'device_ms',
             'library_device_ms')}),
        # the synthetic renders (a frame of holes only and a band beside
        # them); the Mask R-CNN clip's frames beside
        ('discfill_exact', res['discfill_exact'], 'ops/discfill.py:225',
         {f'{k}_real': v for k, v in res['discfill_exact_real'].items()}),
        # the box head's (1000, 7x7); the mask head's (100, 14x14) beside
        ('roialign', res['roialign_7'], 'models/maskrcnn.py:248',
         {f'{k}_{tag}': res[f'roialign_{tag}'][k]
          for tag in ('14', '7_real', '14_real') for k in (
              'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
              'bound_ms_pyramid', 'device_ms')}),
        # the RPN's K = 4,756; the detection's K = 2,048 beside; both on
        # the clip's own inputs
        ('nms_large', res['nms_large_rpn'], 'models/maskrcnn.py:235',
         {f'{k}_{tag}': res[f'nms_large_{tag}'][k]
          for tag in ('det', 'rpn_real', 'det_real') for k in (
              'ms', 'plain_ms', 'bound_ms', 'device_ms', 'kept')}),
        # the full 576x1024 guide; a 300x440 crop and the CRF clip's
        # crops beside it
        ('kmeans', res['kmeans_full'], 'ops/crf.py:55',
         {**{f'{k}_crop': res['kmeans_crop'][k] for k in (
             'label_share', 'ms', 'plain_ms', 'bound_ms', 'device_ms')},
          **{f'{k}_clip': v for k, v in res['kmeans_crops'].items()}}),
        # one mean-field step at 576x1024
        ('crf', res['crf'], 'ops/crf.py:95', {}),
        # stage 0 with the shift mask; every stage, with and without
        ('swinattn', res['s0m'], 'models/swinv2.py:123',
         {f'{k}_{tag}': res[tag][k] for tag in (
             's0', 's1', 's1m', 's2', 's2m', 's3', 's3m') for k in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_ms_simt',
             'library_ms', 'device_ms', 'library_device_ms')}),
        # the style path's 448x768; repaint_person's 768x768 beside it
        # the device time on the style phase's own fill beside
        ('pushpull', res['pushpull_448x768'], 'ops/inpaint_fill.py:43',
         {**{f'{k}_768x768': res['pushpull_768x768'][k] for k in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'device_ms')},
          'device_ms_style': style_dev['pushpull'],
          'inpaint_ms_style': style_dev['fill_ms'],
          'offsets_draw_ms_style': style_dev['draw_ms']}),
        ('jitter', res['jitter_448x768'], 'ops/inpaint_fill.py:70',
         {**{f'{k}_768x768': res['jitter_768x768'][k] for k in (
             'max_abs_err', 'equal_share', 'ms', 'plain_ms', 'bound_ms',
             'device_ms')},
          'device_ms_style': style_dev['jitter']}),
    ]
    paths = {'detector-free': launches_free, 'main': launches,
             'sam': launches_sam, 'maskrcnn': launches_mr,
             'crf': launches_crf, 'tagger': launches_tag,
             'style': launches_style, 'clip 683x1024': launches_odd,
             'options': launches_opt, 'ldm': launches_ldm,
             'serve': launches_serve, 'segment_api': launches_seg,
             **launches_depth, **launches_diff}
    own_path = {'samattn': launches_sam, 'discfill_exact': launches_mr,
                'roialign': launches_mr, 'nms_large': launches_mr,
                'kmeans': launches_crf, 'crf': launches_crf,
                'swinattn': launches_tag, 'pushpull': launches_style,
                'jitter': launches_style, 'median3': launches_seg}
    kernels = []
    for name, r, where, extra in rows:
        # one PyTorch call computes the laplacian (a convolution) and
        # the two attentions (SDPA with the bias); none computes the
        # others (torchvision, whose roi_align and nms would, is not
        # installed; none computes a push-pull or the jitter refine)
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
