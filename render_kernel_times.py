#!/usr/bin/env python3
"""Device times of the render kernels K1 (splat), K2 (the autozoom
coverage), K3 (the disocclusion fill), K4 (bokeh) and K5b (the depth
colorize), and of the laplacian (K7), of one checkout of the
PyTorch/CUDA port, on one GPU.

    python3 render_kernel_times.py [--save-fill-inputs PATH]
                                   [--save-coverage-inputs PATH] [--seed N]
    python3 render_kernel_times.py [--root DIR] [--fill-inputs PATH]
                                   [--coverage-inputs PATH] [--seed N]
    python3 render_kernel_times.py --loop [--root DIR] [--seed N]

With ``--loop`` it runs the shipped default clip with DIR's package
and times its frame loop on the host instead (16 frames a run, 7 runs:
the enqueue and the wall time a frame), and exits.

With ``--save-fill-inputs`` or ``--save-coverage-inputs`` it runs the
shipped default clip (``KenBurnsConfig()``, chip_smoke's edged
detector) with this file's checkout, saves K3's inputs in 8 frames of
its frame loop and K2's input (the autozoom's stride-2 miniature of
its cloud and its 256 shifts) to the given paths (``torch.save``) and
exits.

Otherwise it imports ``cartoonsegmentation_torch`` from DIR (default:
this file's directory), builds its ``splat``, ``coverage``,
``discfill``, ``bokeh``, ``colorize`` and ``laplacian`` kernels, and at
the main path's shapes (576x1024; the frame loop's compacted cloud of
720,896 slots at C = 4, alone and with 4,096 copies of one point in
front, the Inpaint net's 589,824 points at C = 68 and C = 2, C = 68 on
the cloud with the copies; K2 on chip_smoke's synthetic miniature with
256 shifts and, with ``--coverage-inputs``, on the saved input of the
shipped default clip; K3 on chip_smoke's 10 renders of that cloud and,
with ``--fill-inputs``, on the saved frames of the shipped default
clip; the 3-pass bokeh at S = 32 on a filled render's weights; K5b on
the depth channels of the filled frames, read in place; the laplacian
of a 576x1024x1 mask) prints, for each call:
- its device time (the call captured in a CUDA graph and replayed:
  ``chip_smoke.graph_ms``), the median of 3 graphs (of a call with
  several inputs: for each input, and their median);
- its ``ms`` (``chip_smoke.time_ms``: CUDA events around one call on an
  idle card, host dispatch included);
- its device time by kernel (torch.profiler over 10 calls on its first
  input);
- its largest difference from the plain version.
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
    if args.save_fill_inputs or args.save_coverage_inputs:
        save_inputs(cs, args.save_fill_inputs, args.save_coverage_inputs,
                    args.seed)
        return
    sys.path.insert(0, root)                      # the package measured
    if args.loop:
        loop_times(cs, root, args.seed)
        return
    from cartoonsegmentation_torch.ops import (_cuda, bokeh, discfill3,
                                               filters, pointcloud)
    from cartoonsegmentation_torch.ops.pointcloud import shift_points
    from cartoonsegmentation_torch.pipeline.depth import (
        colorize_gray_r, colorize_gray_r_plain)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not os.path.abspath(pointcloud.__file__).startswith(root):
        cs.fail(f'imported {pointcloud.__file__}, not from {root}')
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    _cuda.build(['splat', 'coverage', 'bokeh', 'discfill', 'colorize',
                 'laplacian'])
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
    out = {}
    for tag, fn, plain, xs in calls:
        err = 0.0
        for x in xs:
            got, want = fn(x), plain(x)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max([err] + [float((a - b).abs().max().float())
                               for a, b in zip(got, want)])
        each = [statistics.median(cs.graph_ms(fn, x) for _ in range(3))
                for x in xs]
        dev_ms = statistics.median(each)
        ms = cs.time_ms(fn, xs * max(1, 10 // len(xs)))
        x = xs[0]
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(x)
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 10 / 1e3
              for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0}
        out[tag] = dict(device_ms=dev_ms, ms=ms, max_abs_err=err,
                        by_kernel=by, device_ms_each=each)
        print(f'[{tag}] device {dev_ms:.4f} ms, ms {ms:.4f}, max err vs '
              f'plain {err:.3g}', flush=True)
        if len(xs) > 1:
            print(f'   device ms of each input: '
                  f'{" ".join(f"{t:.4f}" for t in each)}', flush=True)
        print('   by kernel (the first input):', flush=True)
        for k, ms in sorted(by.items(), key=lambda kv: -kv[1]):
            print(f'   {ms:.4f} ms  {k[:70]}', flush=True)
    print(json.dumps({'root': root, 'card': cs.card_line(),
                      'calls': out}), flush=True)


def shipped_default_clip(cs, seed: int):
    """The shipped default pipeline (``KenBurnsConfig()``, chip_smoke's
    edged detector) of the package on sys.path, after one clip."""
    import copy
    import tempfile

    from cartoonsegmentation_torch.config import KenBurnsConfig
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    _cuda.build()
    pipe = KenBurnsPipeline(KenBurnsConfig(), seed=seed, device='cuda')
    det_net, isnet = cs.edged_nets(seed)
    pipe.ensure_detector()
    pipe._detector.model = copy.deepcopy(det_net)
    pipe._detector.refine.net = isnet
    with tempfile.TemporaryDirectory(dir=str(_cuda.BUILD_DIR)) as tmp:
        pipe.run(cs.make_image(seed), os.path.join(tmp, 'clip.mp4'))
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
