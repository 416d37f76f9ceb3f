#!/usr/bin/env python3
"""Device times of the render kernels K1 (splat), K2 (the autozoom
coverage), K3 (the disocclusion fill), K4 (bokeh), K5a (the frame
epilogue), K5b (the depth colorize) and K11 (the exact fill), of the
per-instance median K6, of K7 (the median-5 and the laplacian), of
the detector's K8 and K9, of the cloud compaction K10, of the dense
CRF's k-means K12a and step K12b, of the style fill's push-pull K13a
(and the whole uint8 fill, ``inpaint``) and of Mask R-CNN's RoIAlign
K14a and NMS K14b, of one checkout of the PyTorch/CUDA port, on one
GPU.

    python3 render_kernel_times.py [--save-fill-inputs PATH]
                                   [--save-coverage-inputs PATH]
                                   [--save-crf-inputs PATH]
                                   [--save-exact-fill-inputs PATH]
                                   [--save-maskrcnn-inputs PATH]
                                   [--save-detector-inputs PATH]
                                   [--save-median-inputs PATH]
                                   [--save-compact-inputs PATH]
                                   [--seed N]
    python3 render_kernel_times.py [--root DIR] [--fill-inputs PATH]
                                   [--coverage-inputs PATH]
                                   [--crf-inputs PATH]
                                   [--exact-fill-inputs PATH]
                                   [--maskrcnn-inputs PATH]
                                   [--detector-inputs PATH]
                                   [--median-inputs PATH]
                                   [--compact-inputs PATH]
                                   [--style-fill-inputs PATH]
                                   [--only WORD[,WORD...]] [--seed N]
    python3 render_kernel_times.py --loop [--root DIR] [--seed N]
    python3 render_kernel_times.py --inpaint-passes [--root DIR] [--seed N]
    python3 render_kernel_times.py --clips [--root DIR] [--only WORD,...]
                                   [--seed N]

With ``--inpaint-passes`` it prepares the shipped default clip's state
with DIR's package (``generate_state``, ``autozoom``) and profiles, 5
times each, ``_prepare_state`` on that state's image, disparity and
instances and ``inpaint_extremes`` on the state (torch.profiler: the
device time of each call by kernel, and of its device-to-device
copies, the cloud's clones among them), and exits.

With ``--loop`` it runs the shipped default clip with DIR's package
and times its frame loop on the host instead (16 frames a run, 7 runs:
the enqueue and the wall time a frame), and exits. With ``--clips`` it
runs the shipped default clip, the SAM clip (``chip_smoke.sam_config``),
the Mask R-CNN clip (``detector='maskrcnn', discfill_mode='exact'``)
and the CRF clip with DIR's package (with ``--only``, the clips whose
name holds one of the words), each once cold and then 3 times warm,
and prints each warm run's wall seconds (``pipe.run`` to the mp4, synchronised) and
its ``depth_refine``, ``stream_render``, ``detector_forward`` and
``depth_adjust`` seconds, and exits.

With ``--save-fill-inputs`` or ``--save-coverage-inputs`` it runs the
shipped default clip (``KenBurnsConfig()``, chip_smoke's edged
detector) with DIR's package (default: this file's checkout), saves
K3's inputs in 8 frames of its frame loop and K2's input (the
autozoom's stride-2 miniature of its cloud and its 256 shifts) to the
given paths (``torch.save``);
with ``--save-crf-inputs`` it runs the CRF clip
(``KenBurnsConfig(refine_crf=True)``, the same detector) and saves the
inputs of its densecrf_binary calls (each segment's crop: the
foreground probability and the guide); with
``--save-exact-fill-inputs`` it runs the Mask R-CNN clip (chip_smoke's
edged Mask R-CNN) and saves K11's inputs in 8 frames of its frame
loop; with ``--save-maskrcnn-inputs`` it runs the Mask R-CNN clip's
detector forward (chip_smoke's edged Mask R-CNN, ``MaskRCNNDetector.
infer``) on the images of 3 seeds and saves the arguments of its K14
calls (``chip_smoke.maskrcnn_inputs``: the RPN's and the detection's
NMS candidates with their categories, the flattened pyramid, ~88 MB an
image, the 1,000 proposals and the 100 detections that the RoIAligns
read); with ``--save-detector-inputs`` it runs the shipped default
clip's detector forward (``chip_smoke.detector_inputs``: AnimeInsSeg
with chip_smoke's edged detector) on the images of 3 seeds and saves
the arguments of its K8 and K9 calls (the top 512 candidates' boxes
and scores; the mask heads' prototypes, parameters, priors, strides
and valid flags, ~3 MB a forward); with ``--save-median-inputs`` or
``--save-compact-inputs`` it runs the shipped default clip and saves
the arguments of its K6 call (``focal_planes``' colorized depth with
the instances' masks and valid flags, ~60 MB) and of its two
median-5 calls (the inpainting passes' ``existing``), or of its three
K10 calls (``PointCloud.append_masked``: the cloud before the append
and the entries with their mask, ~130 MB); then it exits.

Otherwise it imports ``cartoonsegmentation_torch`` from DIR (default:
this file's directory), builds its ``splat``, ``coverage``,
``discfill``, ``bokeh``, ``epilogue``, ``colorize``, ``laplacian``,
``discfill_exact``, ``kmeans`` and ``crf`` kernels, and at the main
path's shapes
(576x1024; the frame loop's compacted cloud of 720,896 slots at C = 4,
alone and with 4,096 copies of one point in front, the Inpaint net's
589,824 points at C = 68 and C = 2, C = 68 on the cloud with the
copies; K2 on chip_smoke's synthetic miniature with 256 shifts and,
with ``--coverage-inputs``, on the saved input of the shipped default
clip; K3 on chip_smoke's 10 renders of that cloud and, with
``--fill-inputs``, on the saved frames of the shipped default clip;
K11 at 128 steps on the 10 renders, a frame of holes only, a render
with a band of holes along the border and, with
``--exact-fill-inputs``, the saved frames of the Mask R-CNN clip;
the 3-pass bokeh at S = 32 on a filled render's weights; K5a's crop
558x993 to 576x1024 with I420 on the filled frames' view of their
(H, W, 4) buffer and on their bokeh (contiguous (H, W, 3), the main
path's frames), through ``frame_epilogue`` and, where the checkout has
it, the frame loop's ``EpiloguePlan``; K5b on the depth channels of
the filled frames, read in place; the laplacian of a 576x1024x1 mask;
K12a on chip_smoke's image's guide at 576x1024 and 300x440 and, with
``--crf-inputs``, on each saved crop's guide; K12b's norm pass, one
step and the whole densecrf_binary at 576x1024 on chip_smoke's image
and sloppy mask and, with ``--crf-inputs``, on each saved crop; K14a
at (1000, 7x7) and (100, 14x14) and K14b at the RPN's K = 4,756 and
the detection's K = 2,048 on chip_smoke's synthetic inputs
(``synthetic_k14``) and, with ``--maskrcnn-inputs``, on the saved
calls; K8 over 512 candidates (IoU 0.6, 100 out) and K9 at 100
instances 80x80 → 640x640 on chip_smoke's synthetic cases and, with
``--detector-inputs``, on the saved calls of the shipped default's
forwards; there also K14b's three launches on K8's calls; K6 over
chip_smoke's 100 instance slots (60 valid) and the median-5 of a
random 0/1 mask and, with ``--median-inputs``, their saved calls of
the shipped default clip; K10 appending all of 576x1024 to a cloud
of twice that and, with ``--compact-inputs``, the saved appends of
the shipped default clip, each call on its saved cloud with the
count set back first, a 4-byte copy inside the call; K13a at 448x768
and 768x768 on chip_smoke's image with a hole of its seeded discs
and, with ``--style-fill-inputs`` (saved by ``chip_smoke.py
--save-style-fill``), on the [style] phase's own image and mask, and
there the whole uint8 fill ``inpaint``, host work included, with no
device time) prints,
for each call (with ``--only``, for the calls whose tag holds one of
the words):
- its device time (the call captured in a CUDA graph and replayed:
  ``chip_smoke.graph_ms``), the median of 3 graphs (of a call with
  several inputs: for each input, and their median and sum;
  densecrf_binary of a checkout that copies its 1/255 to the card on
  every call has none);
- its ``ms`` (``chip_smoke.time_ms``: CUDA events around one call on an
  idle card, host dispatch included);
- its device time by kernel (torch.profiler over 10 calls on its first
  input);
- its largest difference from the plain version (densecrf_binary: the
  share of mask pixels unlike the plain version's on the CPU; K12a:
  the share of labels);
- for K5a, K6, the median-5, K8, K9, K10, K11, K12a, K12b and K14,
  chip_smoke's bound of each input's
  call (K6: the valid masks and the values; the median-5: the bytes;
  K10: the mask bytes and each set entry's 64; K5a:
  ``chip_smoke.epilogue_bytes``; K11: ``exact_fill_bytes``;
  K12a: ``kmeans_cost``; K12b: ``crf_cost``, for densecrf_binary its
  norm pass and 5 steps; K14a: ``roi_cost``, the pyramid rows its
  samples touch; K8, K14b: ``nms_cost``; K9: ``maskhead_cost``), their
  median and sum;
- for K8, K9 and K14, the host's µs a call (``chip_smoke.host_us``,
  200 calls back to back); for K14b, the kept count of each input and
  the tiles its walk resolves (``chip_smoke.nms_walk_tiles``); for K8,
  each input's facts (``chip_smoke.nms_facts``: the candidates kept of
  the K, the sorted row of the last output row); for K9, the valid
  instances of each input.
The wrappers' signatures are the same in every checkout since the
port's first slice, so two checkouts compare in one call on one card:
save the inputs once, then run the script with each root in turn (A,
B, B, A). Prints the card and its power limit first and one JSON line
last. Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--fill-inputs', help='K3 inputs saved by '
                    '--save-fill-inputs, timed as a call of their own')
    ap.add_argument('--save-fill-inputs', metavar='PATH',
                    help='save K3 inputs of the shipped default clip')
    ap.add_argument('--coverage-inputs', help='K2 input saved by '
                    '--save-coverage-inputs, timed as a call of its own')
    ap.add_argument('--save-coverage-inputs', metavar='PATH',
                    help='save K2 input of the shipped default clip')
    ap.add_argument('--crf-inputs', help='densecrf_binary inputs saved by '
                    '--save-crf-inputs, K12b timed on each')
    ap.add_argument('--save-crf-inputs', metavar='PATH',
                    help='save the CRF clip\'s densecrf_binary inputs')
    ap.add_argument('--exact-fill-inputs', help='K11 inputs saved by '
                    '--save-exact-fill-inputs, timed as a call of their own')
    ap.add_argument('--save-exact-fill-inputs', metavar='PATH',
                    help='save K11 inputs of the Mask R-CNN clip')
    ap.add_argument('--maskrcnn-inputs', help='K14 inputs saved by '
                    '--save-maskrcnn-inputs, timed as calls of their own')
    ap.add_argument('--save-maskrcnn-inputs', metavar='PATH',
                    help='save the K14 inputs of the Mask R-CNN clip\'s '
                    'detector forward on 3 images')
    ap.add_argument('--detector-inputs', help='K8 and K9 inputs saved by '
                    '--save-detector-inputs, timed as calls of their own')
    ap.add_argument('--save-detector-inputs', metavar='PATH',
                    help='save the K8 and K9 inputs of the shipped default '
                    'clip\'s detector forward on 3 images')
    ap.add_argument('--median-inputs', help='K6 and median-5 inputs saved '
                    'by --save-median-inputs, timed as calls of their own')
    ap.add_argument('--save-median-inputs', metavar='PATH',
                    help='save the K6 and median-5 inputs of the shipped '
                    'default clip')
    ap.add_argument('--compact-inputs', help='K10 inputs saved by '
                    '--save-compact-inputs, timed as calls of their own')
    ap.add_argument('--save-compact-inputs', metavar='PATH',
                    help='save the K10 inputs of the shipped default clip')
    ap.add_argument('--style-fill-inputs', help="the [style] phase's "
                    'fill inputs saved by chip_smoke.py --save-style-fill')
    ap.add_argument('--only', help='comma-separated words: time only the '
                    'calls whose tag holds one of them')
    ap.add_argument('--clips', action='store_true',
                    help='warm seconds of the shipped default, SAM, Mask '
                    'R-CNN and CRF clips')
    ap.add_argument('--inpaint-passes', action='store_true',
                    help="profile the shipped default clip's "
                    '_prepare_state and inpaint_extremes')
    ap.add_argument('--loop', action='store_true',
                    help="time the shipped default clip's frame loop on "
                    'the host instead of the kernels')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA card', flush=True)
        sys.exit(1)
    root = os.path.abspath(args.root)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs                       # timing and inputs
    sys.path.insert(0, root)                      # the package measured
    if args.save_fill_inputs or args.save_coverage_inputs:
        save_inputs(cs, args.save_fill_inputs, args.save_coverage_inputs,
                    args.seed)
    if args.save_crf_inputs:
        save_crf_inputs(cs, args.save_crf_inputs, args.seed)
    if args.save_exact_fill_inputs:
        save_exact_fill_inputs(cs, args.save_exact_fill_inputs, args.seed)
    if args.save_maskrcnn_inputs:
        save_maskrcnn_inputs(cs, args.save_maskrcnn_inputs, args.seed)
    if args.save_detector_inputs:
        save_detector_inputs(cs, args.save_detector_inputs, args.seed)
    if args.save_median_inputs or args.save_compact_inputs:
        save_path_inputs(cs, args.save_median_inputs,
                         args.save_compact_inputs, args.seed)
    if args.save_fill_inputs or args.save_coverage_inputs or \
            args.save_crf_inputs or args.save_exact_fill_inputs or \
            args.save_maskrcnn_inputs or args.save_detector_inputs or \
            args.save_median_inputs or args.save_compact_inputs:
        return
    if args.loop:
        loop_times(cs, root, args.seed)
        return
    if args.inpaint_passes:
        inpaint_pass_times(cs, root, args.seed)
        return
    if args.clips:
        clip_times(cs, root, args.seed, args.only)
        return
    from cartoonsegmentation_torch.ops import (_cuda, bokeh, crf, discfill,
                                               discfill3, filters,
                                               pointcloud)
    from cartoonsegmentation_torch.ops.pointcloud import shift_points
    from cartoonsegmentation_torch.pipeline.depth import (
        colorize_gray_r, colorize_gray_r_plain)
    from cartoonsegmentation_torch.utils import image
    if not os.path.abspath(pointcloud.__file__).startswith(root):
        cs.fail(f'imported {pointcloud.__file__}, not from {root}')
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    _cuda.build(['splat', 'coverage', 'bokeh', 'discfill', 'epilogue',
                 'colorize', 'laplacian', 'discfill_exact', 'kmeans', 'crf',
                 'roialign', 'nms_large', 'nms', 'maskhead', 'insmedian',
                 'median5', 'compact', 'pushpull'])
    H, W, dev = cs.H, cs.W, torch.device('cuda')

    gen = torch.Generator().manual_seed(args.seed)
    pts, col, depth = cs.synthetic_cloud(gen, dev, 11 * (1 << 16))
    # the same cloud with 4,096 copies of one point in front of it in its
    # empty slots, as the main path's cloud holds them
    copies = pts.clone()
    copies[H * W:H * W + 4096] = torch.tensor([-3.0, 2.0, 120.0],
                                              device=dev)
    shifts = [torch.tensor([0.4 * i - 2.0, 0.25 * i - 1.0, 3.0 * i - 15.0],
                           device=dev) for i in range(2)]
    frames = [shift_points(pts, s).contiguous() for s in shifts]
    data4 = torch.cat([col, pts[:, 2:3] / 500.0], 1).contiguous()
    splats = {
        'splat C=4': (frames[0], data4),
        'splat C=4 copies': (shift_points(copies, shifts[0]).contiguous(),
                             data4),
        'splat C=68': (frames[0][:H * W].contiguous(),
                       torch.rand((H * W, 68), generator=gen).to(dev)),
        'splat C=68 copies': (shift_points(copies, shifts[0]).contiguous(),
                              torch.rand((copies.shape[0], 68),
                                         generator=gen).to(dev)),
        'splat C=2': (frames[1][:H * W].contiguous(),
                      torch.rand((H * W, 2), generator=gen).to(dev)),
    }
    # K3 on chip_smoke's 10 renders of the cloud (the far ones leave a
    # band of holes along the border)
    fills = cs.synthetic_fills(pts, col, [
        shift_points(pts, torch.tensor(
            [0.4 * i - 2.0, 0.25 * i - 1.0, 3.0 * i - 15.0],
            device=dev)).contiguous() for i in range(cs.RUNS)])
    r, w = pointcloud.render_pointcloud(frames[0], data4, H, W, 512.0, 40.0)
    f = discfill3.fill_disocclusion(
        r.contiguous(), (r[..., 3] * (w[..., 0] > 0)).contiguous())
    wgt = bokeh.bokeh_weight_field(colorize_gray_r(f[..., 3]), 1,
                                   focal_plane=25.0).contiguous()
    img = f[..., :3].clamp(0, 1).contiguous()

    def run_splat(x):
        return pointcloud.splat(*x, H, W, 512.0, 40.0)

    def plain_splat(x):
        return pointcloud.splat_plain(*x, H, W, 512.0, 40.0)

    def run_bokeh(x):
        return bokeh.bokeh_core(*x, 13.0, 32)

    def plain_bokeh(x):
        return bokeh.bokeh_core_plain(*x, 13.0, 32)
    def run_fill(x):
        return discfill3.fill_disocclusion(*x)

    def plain_fill(x):
        return discfill3.fill_disocclusion_plain(*x)

    def run_cover(x):
        return pointcloud.coverage(*x)

    def plain_cover(x):
        return pointcloud.coverage_plain(*x)
    # each call: (tag, kernel, plain, its inputs)
    calls = [(k, run_splat, plain_splat, [x]) for k, x in splats.items()]
    calls.append(('coverage 256 shifts, synthetic miniature', run_cover,
                  plain_cover, [cs.synthetic_coverage_inputs(pts, depth)]))
    if args.coverage_inputs:
        x = torch.load(args.coverage_inputs)
        calls.append(('coverage 256 shifts, the shipped default clip\'s '
                      'miniature', run_cover, plain_cover,
                      [tuple(t.to(dev) if torch.is_tensor(t) else t
                             for t in x)]))
    calls.append((f'discfill {len(fills)} renders', run_fill, plain_fill,
                  fills))
    filled = [run_fill(x) for x in fills]
    if args.fill_inputs:
        real = [tuple(t.to(dev) for t in x)
                for x in torch.load(args.fill_inputs)]
        calls.append((f'discfill {len(real)} frames of the shipped default',
                      run_fill, plain_fill, real))
        filled = [run_fill(x) for x in real]
    calls.append(('bokeh', run_bokeh, plain_bokeh, [(img, wgt)]))
    calls.append((f'colorize {len(filled)} filled frames\' depth channel',
                  colorize_gray_r, colorize_gray_r_plain,
                  [f[..., 3] for f in filled]))
    mask = (torch.rand((H, W, 1), generator=gen) > 0.5).float().to(dev)
    calls.append(('laplacian', filters.laplacian_filter,
                  filters.laplacian_filter_plain, [mask]))
    calls += exact_fill_calls(cs, discfill, fills, args.exact_fill_inputs)
    calls += epilogue_calls(cs, image, bokeh, colorize_gray_r, filled)
    calls += kmeans_calls(cs, crf, args.crf_inputs)
    calls += crf_calls(cs, crf, gen, args.crf_inputs)
    calls += k14_calls(cs, gen, args.maskrcnn_inputs)
    calls += detector_calls(cs, gen, args.detector_inputs)
    calls += median_calls(cs, gen, args.median_inputs)
    calls += compact_calls(cs, gen, args.compact_inputs)
    calls += fill_calls(cs, args.style_fill_inputs, args.seed)
    if args.only:
        words = args.only.split(',')
        calls = [c for c in calls if any(wd in c[0] for wd in words)]
    out = {}
    for tag, fn, plain, xs, *opt in calls:
        opt = opt[0] if opt else {}
        err = 0.0
        for x in xs if plain else ():
            got, want = fn(x), plain(x)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max([err] + [float((a.to(b.device) != b).float().mean())
                               if a.dtype == torch.bool or opt.get('share')
                               else
                               float((a.double() - b.double()).abs().max())
                               for a, b in zip(got, want)])
        each = [statistics.median(cs.graph_ms(fn, x) for _ in range(3))
                if opt.get('graph', True) else float('nan') for x in xs]
        dev_ms = statistics.median(each)
        ms = cs.time_ms(fn, xs * max(1, 10 // len(xs)))
        by = cs.by_kernel(fn, xs[0])
        out[tag] = dict(device_ms=dev_ms, ms=ms, max_abs_err=err,
                        by_kernel=by, device_ms_each=each)
        print(f'[{tag}] device {dev_ms:.4f} ms, ms {ms:.4f}, max err vs '
              f'plain {err:.3g}', flush=True)
        if opt.get('host'):
            x = xs[0]
            out[tag]['host_us'] = cs.host_us({tag: lambda: fn(x)}, n=200,
                                             rounds=3)[tag]
            print(f'   host {out[tag]["host_us"]:.2f} us a call', flush=True)
        if tag.startswith('nms '):
            out[tag]['facts'] = [cs.nms_facts(x) for x in xs]
            print(f'   facts {out[tag]["facts"]}', flush=True)
        if tag.startswith('maskhead'):
            out[tag]['valid'] = [int(x[4].sum()) for x in xs]
            print(f'   valid instances {out[tag]["valid"]}', flush=True)
        if tag.startswith('nms_large'):
            out[tag]['kept'] = [int(fn(x)[1].sum()) for x in xs]
            out[tag]['walk_tiles'] = [cs.nms_walk_tiles(x) for x in xs]
            print(f'   kept {out[tag]["kept"]}; the walk resolves (tiles, '
                  f'of) {out[tag]["walk_tiles"]}', flush=True)
        if 'bounds' in opt:
            bounds = [cs.bound(*c) for c in opt['bounds']]
            b_each = [b for b, _ in bounds]
            out[tag].update(bound_ms=statistics.median(b_each),
                            bound_ms_sum=sum(b_each),
                            bound_by=sorted({by for _, by in bounds}))
            print(f'   bound {statistics.median(b_each):.6f} ms (median of '
                  f'the inputs; sum {sum(b_each):.6f}; '
                  f'{"/".join(out[tag]["bound_by"])})', flush=True)
        if len(xs) > 1:
            print(f'   device ms of each input: '
                  f'{" ".join(f"{t:.4f}" for t in each)} (sum '
                  f'{sum(each):.4f})', flush=True)
        print('   by kernel (the first input):', flush=True)
        for k, ms in sorted(by.items(), key=lambda kv: -kv[1]):
            print(f'   {ms:.4f} ms  {k[:70]}', flush=True)
    print(json.dumps({'root': root, 'card': cs.card_line(),
                      'calls': out}), flush=True)


def exact_fill_calls(cs, discfill, fills, inputs_path) -> list:
    """K11's calls at 128 steps: chip_smoke's 10 renders, a frame of
    holes only, a render with a band of holes along the border and,
    with ``inputs_path``, the saved frames of the Mask R-CNN clip; the
    bound of each input's call (``chip_smoke.exact_fill_bytes``)."""
    import torch

    def run(x):
        return discfill.fill_disocclusion(*x, 128)

    def plain(x):
        return discfill.fill_disocclusion_plain(*x, 128)

    def cost(xs):
        return [(cs.exact_fill_bytes(*x[0].shape), 0) for x in xs]
    cases = [(f'discfill_exact {len(fills)} renders', fills),
             ('discfill_exact holes only', [cs.holes_only(fills[0])]),
             ('discfill_exact border band', [cs.band_fill(fills[0])])]
    if inputs_path:
        dev = fills[0][0].device
        real = [tuple(t.to(dev) for t in x) for x in torch.load(inputs_path)]
        cases.append((f'discfill_exact {len(real)} frames of the Mask R-CNN '
                      f'clip', real))
    return [(tag, run, plain, xs, {'bounds': cost(xs)}) for tag, xs in cases]


def kmeans_calls(cs, crf, crf_inputs) -> list:
    """K12a's calls (10 clusters, 8 iterations): chip_smoke's image at
    576x1024 and its 300x440 crop and, with ``crf_inputs``, the guides
    of the CRF clip's saved densecrf_binary calls; the bound of each
    (``chip_smoke.kmeans_cost``). The error printed is the share of
    labels unlike the plain version's."""
    import numpy as np
    import torch
    img = torch.from_numpy(np.ascontiguousarray(
        cs.make_image(0)[..., ::-1])).cuda()
    cases = [('kmeans 576x1024', [cs.crf_guide(img)]),
             ('kmeans 300x440', [cs.crf_guide(img[120:420, 260:700])])]
    if crf_inputs:
        guides = [cs.crf_guide(rgb.cuda()) for _, rgb in torch.load(
            crf_inputs)]
        cases.append((f'kmeans the CRF clip\'s {len(guides)} crops', guides))

    def run(x):
        return crf.kmeans_labels(x, 10)

    def plain(x):
        return crf._kmeans_labels(x, 10)
    return [(tag, run, plain, xs,
             {'bounds': [cs.kmeans_cost(x.shape[0], 10) for x in xs],
              'share': True}) for tag, xs in cases]


def epilogue_calls(cs, image, bokeh, colorize_gray_r, filled) -> list:
    """K5a's calls: the shipped default's crop (558x993 to 576x1024,
    I420) on the filled frames' view and on their bokeh (contiguous),
    through frame_epilogue and, where the checkout has it, the frame
    loop's EpiloguePlan."""
    import torch
    H, W, dev = cs.H, cs.W, torch.device('cuda')
    ch, cw = int(0.97 * H), int(0.97 * W)
    views = [f[..., :3] for f in filled]
    blurred = [bokeh.bokeh_core(
        f[..., :3].clamp(0, 1).contiguous(),
        bokeh.bokeh_weight_field(colorize_gray_r(f[..., 3]), 1,
                                 focal_plane=25.0).contiguous(), 13.0, 32)
        for f in filled]
    bgr = torch.empty((1, H, W, 3), dtype=torch.uint8, device=dev)
    i420 = torch.empty((1, H * 3 // 2, W), dtype=torch.uint8, device=dev)

    def run(f):
        return image.frame_epilogue(f, ch, cw, H, W, bgr[0], i420[0])

    def plain(f):
        return image.frame_epilogue_plain(f, ch, cw, H, W)
    # the bytes of chip_smoke's K5a bound, its operations
    cost = [(cs.epilogue_bytes(H, W, ch, cw, H, W, True),
             H * W * (3 * 42 + 16))]
    calls = [(f'epilogue {len(views)} filled frames (view)', run, plain,
              views, {'bounds': cost * len(views)}),
             (f'epilogue {len(blurred)} blurred frames (contiguous)', run,
              plain, blurred, {'bounds': cost * len(blurred)})]
    if hasattr(image, 'EpiloguePlan'):
        plan = image.EpiloguePlan(ch, cw, H, W)
        plan.outputs(bgr, i420)

        def run_plan(f):
            plan(f, 0)
            return bgr[0]
        calls += [(f'epilogue plan {len(views)} filled frames (view)',
                   run_plan, plain, views, {'bounds': cost * len(views)}),
                  (f'epilogue plan {len(blurred)} blurred frames '
                   f'(contiguous)', run_plan, plain, blurred,
                   {'bounds': cost * len(blurred)})]
    return calls


def crf_calls(cs, crf, gen, crf_inputs) -> list:
    """K12b's calls: the norm pass, one step and the whole
    densecrf_binary (the k-means and 5 steps) at 576x1024 on
    chip_smoke's image and sloppy mask and on each saved crop of the
    CRF clip."""
    import numpy as np
    import torch
    dev = torch.device('cuda')
    img = cs.make_image(0)
    cases = [(cs.sloppy_mask(gen, cs.H, cs.W),
              torch.from_numpy(np.ascontiguousarray(img[..., ::-1])))]
    if crf_inputs:
        cases += torch.load(crf_inputs)
    steps, norms_in, whole = [], [], []
    inv = torch.tensor(1.0 / 255.0, device=dev)
    for unary_fg, rgb in cases:
        unary_fg, rgb = unary_fg.to(dev), rgb.to(dev)
        H, W = unary_fg.shape
        labels = crf.kmeans_labels((rgb.float() * inv).reshape(-1, 3),
                                   10).reshape(H, W)
        p = torch.clamp(unary_fg, 1e-5, 1 - 1e-5)
        unary = -torch.log(torch.stack([1 - p, p], -1))
        norms, dead = crf.crf_norms(labels)
        steps.append((crf._softmax2(-unary), labels, unary, norms, dead))
        norms_in.append(labels)
        whole.append((unary_fg, rgb))

    def step(x):
        return crf.crf_step(*x)[0]

    def step_plain(x):
        return crf.crf_step_plain(*x[:4])

    def norms(x):
        return crf.crf_norms(x)[0]

    def norms_plain(x):
        return crf.crf_norms_plain(x, 1.0, 46.0, 10)[0]

    def dense(x):
        return crf.densecrf_binary(*x)

    def dense_plain(x):
        return crf.densecrf_binary(x[0].cpu(), x[1].cpu())

    def cost(sl, n_steps, norm_pass):
        # chip_smoke's K12b bound of each input's csrc/crf.cu call
        return [cs.crf_cost(*x.shape, 10, crf.lattice(*x.shape, 46.0),
                            n_steps, norm_pass) for x in norms_in[sl]]
    # a checkout whose densecrf_binary copies its 1/255 to the card on
    # every call cannot capture it in a graph
    captures = hasattr(crf, '_inv255')
    calls = []
    for tag, sl in (('576x1024', slice(0, 1)),
                    (f'the CRF clip\'s {len(cases) - 1} crops',
                     slice(1, None))):
        if not steps[sl]:
            continue
        calls += [(f'crf norm pass {tag}', norms, norms_plain, norms_in[sl],
                   {'bounds': cost(sl, 0, True)}),
                  (f'crf step {tag}', step, step_plain, steps[sl],
                   {'bounds': cost(sl, 1, False)}),
                  # the bound: K12b's norm pass and 5 steps, not the
                  # k-means
                  (f'densecrf_binary {tag}', dense, dense_plain, whole[sl],
                   {'graph': captures, 'bounds': cost(sl, 5, True)})]
    return calls


def k14_calls(cs, gen, inputs_path) -> list:
    """K14's calls (``chip_smoke.k14_calls``) on chip_smoke's synthetic
    inputs and, with ``inputs_path``, on the saved calls of the Mask
    R-CNN clip's forwards; bound, host µs and (K14b) kept counts."""
    import torch
    dev = torch.device('cuda')
    sets = [('synthetic', cs.synthetic_k14(gen, dev))]
    if inputs_path:
        seen = cs.load_maskrcnn_inputs(inputs_path, dev)
        sets.append((f'the Mask R-CNN clip\'s {len(seen["rpn"])} forwards',
                     seen))
    return [(f'{tag} {where}', fn, plain, xs,
             {'bounds': [c[:2] for c in costs], 'host': True})
            for where, seen in sets
            for tag, fn, plain, xs, costs in cs.k14_calls(seen)]


def detector_calls(cs, gen, inputs_path) -> list:
    """K8's and K9's calls on chip_smoke's synthetic cases and, with
    ``inputs_path``, on the saved calls of the shipped default's detector
    forwards; there also K14b (``maskrcnn.nms_large``, three launches)
    on K8's calls; bound and host µs."""
    import torch
    from cartoonsegmentation_torch.models import maskrcnn, rtmdet
    dev = torch.device('cuda')
    nms = [tuple(t.to(dev) for t in cs.nms_case(gen)) + (0.6, 100)
           for _ in range(3)]
    N, h = 100, 80
    heads = []
    for _ in range(3):
        val = torch.rand((N,), generator=gen) < 0.8
        heads.append((torch.randn((h, h, 8), generator=gen).to(dev),
                      torch.randn((N, 169), generator=gen).to(dev),
                      (torch.randint(0, h, (N, 2), generator=gen).float()
                       * 8).to(dev),
                      torch.tensor([8.0, 16.0, 32.0])[torch.randint(
                          0, 3, (N,), generator=gen)].to(dev), val.to(dev),
                      640, 640, 0.3))
    sets = [('synthetic', nms, heads)]
    if inputs_path:
        seen = cs.load_detector_inputs(inputs_path, dev)
        sets.append((f'the shipped default\'s {len(seen["nms"])} forwards',
                     seen['nms'], seen['maskhead']))

    def run_nms(x):
        return rtmdet.nms_fixed(*x)

    def plain_nms(x):
        return rtmdet.nms_fixed_plain(*x)

    def run_large(x):
        return maskrcnn.nms_large(*x)

    def run_heads(x):
        return rtmdet.dynamic_masks(*x)

    def plain_heads(x):
        return rtmdet.dynamic_masks_plain(*x)
    calls = []
    for where, n, m in sets:
        nb = [cs.nms_cost(x[0].shape[0], x[3]) for x in n]
        calls += [(f'nms {where}', run_nms, plain_nms, n,
                   {'bounds': nb, 'host': True}),
                  (f'K14b on K8\'s calls, {where}', run_large,
                   plain_nms, n, {'bounds': nb, 'host': True}),
                  (f'maskhead {where}', run_heads, plain_heads, m,
                   {'bounds': [cs.maskhead_cost(x) for x in m],
                    'host': True})]
    return calls


def median_calls(cs, gen, inputs_path) -> list:
    """K6's and the median-5's calls: chip_smoke's 100 instance slots (60
    valid) on a map of [0, 255] values and the median-5 of a random 0/1
    mask at 576x1024 and, with ``inputs_path``, the shipped default
    clip's calls; the bound of each (K6: the values and the valid
    masks; the median-5: the bytes, csrc/median5.cu's 570 operations a
    run of 8 outputs beside them). The error printed is the share of
    outputs unlike the plain version's."""
    import torch
    from cartoonsegmentation_torch.ops import filters
    from cartoonsegmentation_torch.pipeline import depth
    H, W, dev = cs.H, cs.W, torch.device('cuda')
    masks, valid = cs.instance_masks(gen, dev, 100, 60)
    cases = [('synthetic',
              [((torch.rand((H, W), generator=gen) * 255).to(dev), masks,
                valid)],
              [(torch.rand((1, H, W, 1), generator=gen) > 0.4).float()
               .to(dev)])]
    if inputs_path:
        saved = torch.load(inputs_path)
        cases.append(("the shipped default clip's",
                      [tuple(t.to(dev) for t in x)
                       for x in saved['insmedian']],
                      [x.to(dev) for x in saved['median5']]))

    def k6(x):
        return depth.masked_median_u8(*x)

    def k6_plain(x):
        return depth.masked_median_u8_plain(*x)

    def med(x):
        return filters.median_filter(x, 5)

    def med_plain(x):
        return filters.median_filter_plain(x, 5)

    def k6_cost(x):
        values, _, ok = x
        n, hw = int(ok.sum()), values.numel()
        return hw * 4 + n * hw + ok.numel() * 5, n * hw * 3
    calls = []
    for where, ins, maps in cases:
        calls += [(f'insmedian {where}', k6, k6_plain, ins,
                   {'bounds': [k6_cost(x) for x in ins], 'share': True}),
                  (f'median5 {where}', med, med_plain, maps,
                   {'bounds': [(x.numel() * 8, x.numel() * 570 / 8)
                               for x in maps], 'share': True})]
    return calls


def compact_calls(cs, gen, inputs_path) -> list:
    """K10's calls (``state.append_masked_into``): all of 576x1024 set,
    appended to an empty cloud of twice that, and, with ``inputs_path``,
    the shipped default clip's three appends on their saved clouds.
    Each call first sets the cloud's count back to the saved one (a
    4-byte device copy inside the timed call), so that every call
    writes the same slots. The bound: the mask bytes and the 64 bytes
    of each set entry, read and written."""
    import torch
    from cartoonsegmentation_torch.pipeline import state
    H, W, dev = cs.H, cs.W, torch.device('cuda')
    M = H * W
    cloud = state.PointCloud.with_capacity(2 * M, dev)
    src = (torch.rand((M, 3), generator=gen).to(dev),
           torch.rand((M, 3), generator=gen).to(dev),
           torch.rand((M,), generator=gen).to(dev),
           torch.rand((M,), generator=gen).to(dev),
           torch.ones((M,), dtype=torch.bool, device=dev))
    cases = [('synthetic', [(cloud, src, cloud.count.clone())])]
    if inputs_path:
        xs = []
        for rec in torch.load(inputs_path):
            c = state.PointCloud(*(t.to(dev) for t in rec['cloud']))
            xs.append((c, tuple(t.to(dev) for t in rec['args']),
                       c.count.clone()))
        cases.append(("the shipped default clip's", xs))

    def run(x):
        cloud, args, count = x
        cloud.count.copy_(count)
        state.append_masked_into(cloud, *args)
        return cloud.points, cloud.count

    def plain(x):
        cloud, args, count = x
        out = cloud.clone()
        out.count.copy_(count)
        state.append_masked_plain(out, *args)
        return out.points, out.count
    return [(f'compact {where}', run, plain, xs,
             {'bounds': [(x[1][4].numel() + int(x[1][4].sum()) * 64, 0)
                         for x in xs], 'share': True})
            for where, xs in cases]


def fill_calls(cs, inputs_path, seed: int) -> list:
    """K13a's calls (``push_pull_fill``, one image and hole each):
    chip_smoke's image resized to 448x768 and 768x768 with a hole of
    its seeded discs (``chip_smoke.fill_hole``) and, with
    ``inputs_path``, the [style] phase's own; there also the whole
    uint8 fill (``inpaint``: host copies, the offsets' draw and both
    kernels), timed by ``ms`` only. The bound: ``chip_smoke.fill_bytes``
    and 50 operations a pyramid pixel."""
    import numpy as np
    import torch
    from cartoonsegmentation_torch.ops import inpaint_fill as fill
    dev = torch.device('cuda')
    rgb = torch.from_numpy(cs.make_image(seed)).to(dev).float().permute(
        2, 0, 1)[None] / 255
    cases = []
    for h, w in cs.FILL_SIZES:
        x = torch.nn.functional.interpolate(rgb, size=(h, w), mode='bilinear',
                                            align_corners=False)
        cases.append((f'{h}x{w}', x[0].permute(1, 2, 0).contiguous(),
                      cs.fill_hole(torch.Generator().manual_seed(seed), h,
                                   w).to(dev)))
    style = None
    if inputs_path:
        style = np.load(inputs_path)
        cases.append(("the [style] phase's",
                      torch.from_numpy(style['image'].astype(np.float32) /
                                       255.0).to(dev),
                      torch.from_numpy(style['mask'] > 0).to(dev)))
    calls = []
    for tag, x, hole in cases:
        h, w = hole.shape
        levels = fill.fill_levels(h, w)
        calls.append((f'pushpull {tag}', lambda a: fill.push_pull_fill(*a),
                      lambda a: fill.push_pull_fill_plain(*a), [(x, hole)],
                      {'bounds': [(cs.fill_bytes(h, w),
                                   50 * sum(a * b for a, b in levels))]}))
    if style is not None:
        calls.append(("inpaint the [style] phase's uint8 fill",
                      lambda a: fill.inpaint(*a, device=dev), None,
                      [(style['image'], style['mask'])], {'graph': False}))
    return calls


def save_path_inputs(cs, median_path, compact_path, seed: int) -> None:
    """Run the shipped default clip (``shipped_default_clip``) and save
    the arguments of its K6 and median-5 calls to ``median_path`` (a
    dict: 'insmedian', the (values, masks, valid) of each call;
    'median5', each call's map) and of its K10 calls to
    ``compact_path`` (a list: each call's cloud before it, as
    (points, colors, disparity, depth, count), and its entries and
    mask); either path may be None."""
    import torch
    from cartoonsegmentation_torch.models import kenburns as net
    from cartoonsegmentation_torch.pipeline import kenburns as pipe
    from cartoonsegmentation_torch.pipeline import state
    print(f'card: {cs.card_line()}', flush=True)
    seen = {'insmedian': [], 'median5': [], 'compact': []}
    k6, median, append = (pipe.masked_median_u8, net.median_filter,
                          state.append_masked_into)

    def rec_k6(*x):
        seen['insmedian'].append(tuple(t.detach().cpu() for t in x))
        return k6(*x)

    def rec_median(x, size):
        seen['median5'].append(x.detach().cpu())
        return median(x, size)

    def rec_append(cloud, *x):
        seen['compact'].append({
            'cloud': tuple(getattr(cloud, k).cpu() for k in (
                'points', 'colors', 'disparity', 'depth', 'count')),
            'args': tuple(t.detach().cpu() for t in x)})
        return append(cloud, *x)
    pipe.masked_median_u8, net.median_filter = rec_k6, rec_median
    state.append_masked_into = rec_append
    try:
        shipped_default_clip(cs, seed)
    finally:
        pipe.masked_median_u8, net.median_filter = k6, median
        state.append_masked_into = append
    if median_path:
        torch.save({k: seen[k] for k in ('insmedian', 'median5')},
                   median_path)
        _, m, ok = seen['insmedian'][0]
        share = float(m[ok].float().mean())
        print(f'saved {len(seen["insmedian"])} K6 calls ({m.shape[0]} '
              f'slots, {int(ok.sum())} valid, {share:.4%} of their masks '
              f'set, strides {m.stride()}) and {len(seen["median5"])} '
              f'median-5 calls '
              f'{[tuple(x.shape) for x in seen["median5"]]} to {median_path}',
              flush=True)
    if compact_path:
        torch.save(seen['compact'], compact_path)
        print(f'saved {len(seen["compact"])} K10 calls (M '
              f'{[int(r["args"][4].numel()) for r in seen["compact"]]}, set '
              f'{[int(r["args"][4].sum()) for r in seen["compact"]]}, '
              f'capacity {int(seen["compact"][0]["cloud"][0].shape[0])}) to '
              f'{compact_path}', flush=True)


def save_detector_inputs(cs, path: str, seed: int, images: int = 3) -> None:
    """Save the K8 and K9 calls of the shipped default clip's detector
    forward (``chip_smoke.detector_inputs`` with ``edged_nets``) on the
    images of seeds seed .. seed + images - 1 to ``path``: a list of one
    dict an image."""
    import torch
    from cartoonsegmentation_torch.ops import _cuda
    print(f'card: {cs.card_line()}', flush=True)
    _cuda.build(['nms', 'maskhead'])
    saved = []
    for s in range(seed, seed + images):
        img = cs.make_image(s)
        seen = cs.detector_inputs(cs.edged_nets(s)[0], img, s)
        rec = {tag: tuple(t.cpu() if torch.is_tensor(t) else t
                          for t in seen[tag][0]) for tag in seen}
        b, sc = rec['nms'][:2]
        print(f'[save] seed {s}: nms K = {b.shape[0]}, scores '
              f'{float(sc.min()):.4g}..{float(sc.max()):.4g}; maskhead N = '
              f'{rec["maskhead"][1].shape[0]}, '
              f'{int(rec["maskhead"][4].sum())} valid', flush=True)
        saved.append(rec)
    torch.save(saved, path)
    print(f'saved the K8 and K9 calls of {len(saved)} forwards to {path}',
          flush=True)


def save_maskrcnn_inputs(cs, path: str, seed: int, images: int = 3) -> None:
    """Save the K14 calls of the Mask R-CNN clip's detector forward
    (``chip_smoke.maskrcnn_inputs`` with ``edged_maskrcnn``) on the
    images of seeds seed .. seed + images - 1 to ``path``: a list of
    one dict an image, the pyramid once."""
    import torch
    from cartoonsegmentation_torch.ops import _cuda
    print(f'card: {cs.card_line()}', flush=True)
    _cuda.build(['roialign', 'nms_large'])
    saved = []
    for s in range(seed, seed + images):
        img = cs.make_image(s)
        seen = cs.maskrcnn_inputs(cs.edged_maskrcnn(s, img), img)
        pyr = seen['roi7'][0][0]
        rec = {'pyr': (pyr.flat.cpu(), pyr.sizes)}
        for tag in ('rpn', 'det'):
            b, sc, c, thr, n_out = seen[tag][0]
            rec[tag] = (b.cpu(), sc.cpu(), c.cpu(), thr, n_out)
            print(f'[save] seed {s} {tag}: K = {b.shape[0]}, '
                  f'{int(torch.isinf(sc).sum())} -inf scores, '
                  f'{len(torch.unique(c))} categories', flush=True)
        for out in (7, 14):
            rec[f'roi{out}'] = seen[f'roi{out}'][0][1].cpu()
        saved.append(rec)
    torch.save(saved, path)
    print(f'saved the K14 calls of {len(saved)} forwards to {path}',
          flush=True)


def shipped_default_clip(cs, seed: int, **cfg):
    """The pipeline ``KenBurnsConfig(**cfg)`` of the package on
    sys.path with chip_smoke's edged detector (``edged_nets``, or
    ``edged_maskrcnn`` for ``detector='maskrcnn'``; with ``sam=True``
    the SAM clip, ``chip_smoke.sam_config`` with the edged box detector
    and ``edged_sam``), after one clip."""
    import copy
    import tempfile

    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    _cuda.build()
    img = cs.make_image(seed)
    if cfg.pop('sam', False):
        pipe = KenBurnsPipeline(cs.sam_config(os.path.dirname(
            os.path.abspath(__file__))), seed=seed, device='cuda')
    else:
        pipe = KenBurnsPipeline(KenBurnsConfig(**cfg), seed=seed,
                                device='cuda')
    pipe.ensure_detector()
    if pipe.cfg.detector == 'maskrcnn':
        pipe._detector.model = cs.edged_maskrcnn(seed, img)
    elif pipe.cfg.detector == 'sam':
        pipe._detector.box_detector.model = copy.deepcopy(
            cs.edged_nets(seed)[0])
        pipe._detector.sam.model = cs.edged_sam(seed, img)
    else:
        det_net, isnet = cs.edged_nets(seed)
        pipe._detector.model = copy.deepcopy(det_net)
        pipe._detector.refine.net = isnet
    with tempfile.TemporaryDirectory(dir=str(_cuda.BUILD_DIR)) as tmp:
        pipe.run(img, os.path.join(tmp, 'clip.mp4'))
    return pipe


def save_inputs(cs, fill_path, coverage_path, seed: int) -> None:
    """Save K3's inputs in 8 frames of the shipped default clip's frame
    loop to ``fill_path`` and K2's input in that clip to
    ``coverage_path`` (either may be None)."""
    import torch
    print(f'card: {cs.card_line()}', flush=True)
    pipe = shipped_default_clip(cs, seed)
    if fill_path:
        inputs = cs.real_fill_inputs(pipe)
        torch.save([tuple(t.cpu() for t in x) for x in inputs], fill_path)
        print(f'saved K3 inputs of {len(inputs)} frames to {fill_path}',
              flush=True)
    if coverage_path:
        x = cs.real_coverage_inputs(pipe)
        torch.save(tuple(t.cpu() if torch.is_tensor(t) else t for t in x),
                   coverage_path)
        print(f'saved K2 input ({x[0].shape[0]} points, {x[1].shape[0]} '
              f'shifts, {x[2]}x{x[3]}) to {coverage_path}', flush=True)


def save_crf_inputs(cs, path: str, seed: int) -> None:
    """Save the inputs of the CRF clip's densecrf_binary calls (each
    segment's foreground probability and guide crop) to ``path``."""
    import torch
    crops = cs.CrfCrops(keep=True)
    shipped_default_clip(cs, seed, refine_crf=True)
    crops.close()
    torch.save(crops.inputs, path)
    print(f'saved {len(crops.inputs)} densecrf_binary inputs to {path}: '
          f'{" ".join(f"{h}x{w}" for h, w in crops.shapes)}', flush=True)


def save_exact_fill_inputs(cs, path: str, seed: int) -> None:
    """Save K11's inputs in 8 frames of the Mask R-CNN clip's frame loop
    (``KenBurnsConfig(detector='maskrcnn', discfill_mode='exact')``,
    chip_smoke's edged Mask R-CNN) to ``path``."""
    import torch
    print(f'card: {cs.card_line()}', flush=True)
    pipe = shipped_default_clip(cs, seed, detector='maskrcnn',
                                discfill_mode='exact')
    inputs = cs.real_fill_inputs(pipe)
    torch.save([tuple(t.cpu() for t in x) for x in inputs], path)
    print(f'saved K11 inputs of {len(inputs)} frames to {path}', flush=True)


def clip_times(cs, root: str, seed: int, only: str | None = None,
               runs: int = 3) -> None:
    """The shipped default, SAM, Mask R-CNN and CRF clips of the package
    at ``root`` (with ``only``, those whose name holds one of its
    comma-separated words): ``runs`` warm runs each after a cold one,
    wall seconds to the mp4 and four stages' seconds."""
    import tempfile

    import torch
    from cartoonsegmentation_torch.ops import _cuda
    if not os.path.abspath(_cuda.__file__).startswith(root):
        cs.fail(f'imported {_cuda.__file__}, not from {root}')
    img = cs.make_image(seed)
    out = {}
    for tag, cfg in (('shipped default', {}),
                     ('SAM clip', {'sam': True}),
                     ('Mask R-CNN clip', {'detector': 'maskrcnn',
                                          'discfill_mode': 'exact'}),
                     ('CRF clip', {'refine_crf': True})):
        if only and not any(w in tag for w in only.split(',')):
            continue
        pipe = shipped_default_clip(cs, seed, **cfg)
        walls, refine, render, forward, adjust = [], [], [], [], []
        for _ in range(runs):
            pipe.timer.reset()
            with tempfile.TemporaryDirectory(dir=str(_cuda.BUILD_DIR)) as d:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.run(img, os.path.join(d, 'clip.mp4'))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            refine.append(pipe.timer.seconds.get('depth_refine', 0.0))
            render.append(pipe.timer.seconds['stream_render'])
            forward.append(pipe.timer.seconds.get('detector_forward', 0.0))
            adjust.append(pipe.timer.seconds['depth_adjust'])
        out[tag] = dict(wall_s=walls, depth_refine_s=refine,
                        stream_render_s=render, detector_forward_s=forward,
                        depth_adjust_s=adjust)
        print(f'[clips] {tag} warm: {" ".join(f"{w:.3f}" for w in walls)} '
              f's (median {statistics.median(walls):.3f}); depth_refine '
              f'{" ".join(f"{v:.3f}" for v in refine)} s; stream_render '
              f'{" ".join(f"{v:.3f}" for v in render)} s; detector_forward '
              f'{" ".join(f"{v:.3f}" for v in forward)} s; depth_adjust '
              f'{" ".join(f"{v:.3f}" for v in adjust)} s', flush=True)
        del pipe
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    print(json.dumps({'root': root, 'clips': out}), flush=True)


def inpaint_pass_times(cs, root: str, seed: int, runs: int = 5) -> None:
    """The shipped default clip's ``_prepare_state`` and
    ``inpaint_extremes`` of the package at ``root``, each profiled
    ``runs`` times after a warm-up: device ms a call in all and in the
    device-to-device copies, and the three kernels that take the
    most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cartoonsegmentation_torch.ops import _cuda
    if not os.path.abspath(_cuda.__file__).startswith(root):
        cs.fail(f'imported {_cuda.__file__}, not from {root}')
    pipe = shipped_default_clip(cs, seed)
    state = pipe.generate_state(cs.make_image(seed))
    boxes = pipe.autozoom(state)
    calls = {'prepare_state': lambda: pipe._prepare_state(
                 state.image, state.disparity, state.instances),
             'inpaint_extremes': lambda: pipe.inpaint_extremes(state,
                                                               *boxes)}
    out = {}
    for tag, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        rows = []
        for _ in range(runs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ev = {e.key: e.self_device_time_total / 1e3
                  for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU}
            rows.append(dict(
                device_ms=sum(ev.values()),
                dtod_ms=sum(v for k, v in ev.items() if 'DtoD' in k),
                top=sorted(ev.items(), key=lambda kv: -kv[1])[:3]))
        out[tag] = rows
        for k in ('device_ms', 'dtod_ms'):
            print(f'[inpaint passes] {tag} {k}: '
                  f'{" ".join(f"{r[k]:.4f}" for r in rows)} (median '
                  f'{statistics.median(r[k] for r in rows):.4f})', flush=True)
        print(f'   top kernels (last run): '
              f'{[(k[:50], round(v, 4)) for k, v in rows[-1]["top"]]}',
              flush=True)
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    print(json.dumps({'root': root, 'inpaint_passes': {
        k: [{kk: vv for kk, vv in r.items() if kk != 'top'} for r in v]
        for k, v in out.items()}}), flush=True)


def loop_times(cs, root: str, seed: int, runs: int = 7) -> None:
    """The shipped default clip's frame loop, 16 frames a run
    (``render_frames``, as chip_smoke's [loop]): the host's enqueue
    time and the wall time to the last result, ms a frame, each run and
    the medians."""
    import numpy as np
    import torch
    from cartoonsegmentation_torch.ops import _cuda
    if not os.path.abspath(_cuda.__file__).startswith(root):
        cs.fail(f'imported {_cuda.__file__}, not from {root}')
    pipe = shipped_default_clip(cs, seed)
    state, (obj_from, obj_to) = pipe.last_state, pipe.last_boxes
    steps = list(np.linspace(0.0, 1.0, 16))
    pipe.render_frames(state, obj_from, obj_to, steps, return_device=True)
    enqueue, wall = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.render_frames(state, obj_from, obj_to, steps,
                           return_device=True)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) / len(steps) * 1e3)
        wall.append((time.perf_counter() - t0) / len(steps) * 1e3)
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    print(f'[loop] host enqueue {statistics.median(enqueue):.3f} ms/frame '
          f'({" ".join(f"{v:.3f}" for v in enqueue)}), wall '
          f'{statistics.median(wall):.3f} ms/frame', flush=True)
    print(json.dumps({'root': root, 'loop_enqueue_ms': enqueue,
                      'loop_wall_ms': wall}), flush=True)


if __name__ == '__main__':
    main()
