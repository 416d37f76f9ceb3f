#!/usr/bin/env python3
"""Device times of the render kernels K1 (splat) and K4 (bokeh) of one
checkout of the PyTorch/CUDA port, on one GPU.

    python3 render_kernel_times.py [--root DIR] [--seed N]

Imports ``cartoonsegmentation_torch`` from DIR (default: this file's
directory), builds its ``splat`` and ``bokeh`` kernels, and at the
main path's shapes (576x1024; the frame loop's compacted cloud of
720,896 slots at C = 4, alone and with 4,096 copies of one point in
front, the Inpaint net's 589,824 points at C = 68 and C = 2, C = 68 on
the cloud with the copies, the 3-pass bokeh at S = 32 on a filled
render's weights)
prints, for each call:
- its device time (the call captured in a CUDA graph and replayed:
  ``chip_smoke.graph_ms``), the median of 3 graphs;
- its device time by kernel (torch.profiler over 10 calls);
- its largest difference from the plain version.
The wrappers' signatures are the same in every checkout since the
port's first slice, so two checkouts compare in one call on one card:
run the script with each root in turn (A, B, B, A). Prints the card
and its power limit first and one JSON line last. Needs a CUDA card;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--seed', type=int, default=0)
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
    from cartoonsegmentation_torch.ops import (_cuda, bokeh, discfill3,
                                               pointcloud)
    from cartoonsegmentation_torch.ops.pointcloud import shift_points
    from cartoonsegmentation_torch.pipeline.depth import colorize_gray_r
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not os.path.abspath(pointcloud.__file__).startswith(root):
        cs.fail(f'imported {pointcloud.__file__}, not from {root}')
    print(f'card: {cs.card_line()}; root {root}', flush=True)
    _cuda.build(['splat', 'bokeh', 'discfill', 'colorize'])
    H, W, dev = cs.H, cs.W, torch.device('cuda')

    gen = torch.Generator().manual_seed(args.seed)
    pts, col, _ = cs.synthetic_cloud(gen, dev, 11 * (1 << 16))
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
    calls = [(k, run_splat, plain_splat, x) for k, x in splats.items()]
    calls.append(('bokeh', run_bokeh, plain_bokeh, (img, wgt)))
    out = {}
    for tag, fn, plain, x in calls:
        got, want = fn(x), plain(x)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        dev_ms = statistics.median(cs.graph_ms(fn, x) for _ in range(3))
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
        out[tag] = dict(device_ms=dev_ms, max_abs_err=err, by_kernel=by)
        print(f'[{tag}] device {dev_ms:.4f} ms, max err vs plain {err:.3g}; '
              f'by kernel:', flush=True)
        for k, ms in sorted(by.items(), key=lambda kv: -kv[1]):
            print(f'   {ms:.4f} ms  {k[:70]}', flush=True)
    print(json.dumps({'root': root, 'card': cs.card_line(),
                      'calls': out}), flush=True)


if __name__ == '__main__':
    main()
