#!/usr/bin/env python3
"""Where the time of K10 (csrc/compact.cu), K13a (csrc/pushpull.cu)
and K9t (csrc/dynhead_fwd.cu, dynhead_bwd.cu) goes, on one GPU.

    python3 kernel_phases.py [--compact-inputs Q] [--seed N]

First the device time (``chip_smoke.graph_ms``) of the shipped kernels
on synthetic inputs: K10 appending all of 576x1024, and a 3% mask, to
a cloud of twice that (each call setting the count back to 0 first, a
4-byte fill inside the call), beside ``payload[mask]`` (boolean-index
compaction of the (M, 8) payload, its host sync included: ``ms``);
K13a at 448x768 on a 20% random hole and on one 100x100 block; the
jitter offsets' draw on the card (``ms``).

Then the same kernels built from a copy of the package under
``workspace/phases`` whose sources record ``clock64()`` (thread 0 of
each block) at points of each phase (the text edits in ``MARKS``; an
edit that no longer applies raises), read back through an entry point
the copy adds: for each phase, the median and the maximum over the
blocks of its SM cycles. K10 on the two synthetic masks and, with
``--compact-inputs`` (saved by ``render_kernel_times.py
--save-compact-inputs``), on the shipped default clip's three appends;
K13a at 448x768 on chip_smoke's image and seeded discs
(``chip_smoke.fill_hole``), the push's phases over the tiles that hold
a hole pixel; K9t at the training shape (B = 8, K = 8, 80x80,
``chip_smoke.dynhead_case``): the forward's set-up and pixels a warp,
the backward's pixels (warp 0 of a block, its two instances), slot
tree and feature sums a block. The marks cost a few cycles each; the
copy's device times are not the shipped kernels'.

Prints the card and its power limit first and one JSON line last.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys

SLOTS = 16          # marks a block
BLOCKS = 8192       # blocks recorded
HEAD = f'''
__device__ long long kb_marks[{BLOCKS} * {SLOTS}];
extern "C" int kb_read_marks(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, kb_marks, sizeof(kb_marks));
}}
#define MARK(i) do {{ if (threadIdx.x == 0) \\
    kb_marks[blockIdx.x * {SLOTS} + (i)] = clock64(); }} while (0)
'''
# (source, [(text of the shipped source, its replacement)]); K10's
# marks go by tile (taken from the counter), not by block
MARKS = {
    'compact': [
        ('  // the slot, then a tile from its counter',
         '  const long long t0 = clock64();\n'
         '  // the slot, then a tile from its counter'),
        ('  const int tile = s_tile, slot = s_slot;\n',
         '  const int tile = s_tile, slot = s_slot;\n'
         '#undef MARK\n'
         f'#define MARK(i) do {{ if (threadIdx.x == 0) '
         f'kb_marks[tile * {SLOTS} + (i)] = clock64(); }} while (0)\n'
         f'  if (threadIdx.x == 0) kb_marks[tile * {SLOTS}] = t0;\n'
         '  MARK(1);\n'),
        ('  int total = kTile;', '  MARK(2);\n  int total = kTile;'),
        ('  if (threadIdx.x == 0) {\n    if (tile == 0) {',
         '  MARK(3);\n  if (threadIdx.x == 0) {\n    if (tile == 0) {'),
        ('  if (w == 0 && tile > 0) {', '  MARK(4);\n  if (w == 0 && tile > 0) {'),
        ("  // the tile's run of slots", "  MARK(5);\n  // the tile's run of slots"),
        ('  if (tile != n_tiles - 1) return;',
         '  __syncthreads();\n  MARK(6);\n  if (tile != n_tiles - 1) return;'),
    ],
    'pushpull': [
        ('  cg::grid_group grid = cg::this_grid();\n',
         '  cg::grid_group grid = cg::this_grid();\n  MARK(0);\n'),
        ('  grid.sync();\n\n  // coarse',
         '  MARK(1);\n  grid.sync();\n  MARK(2);\n\n  // coarse'),
        ("  float4* lv = sm + kWinBytes / 16;      // the block's coarse levels\n",
         "  float4* lv = sm + kWinBytes / 16;      // the block's coarse levels\n"
         "  MARK(3);\n"),
        ("  __syncthreads();\n  {  // the windows' sums",
         "  __syncthreads();\n  MARK(4);\n  {  // the windows' sums"),
        ('  if (coarse_here) {\n    asm volatile("cp.async.wait_group 1;',
         '  MARK(5);\n  if (coarse_here) {\n    asm volatile("cp.async.wait_group 1;'),
        ('    coarse_done = true;\n  }\n', '    coarse_done = true;\n  }\n  MARK(6);\n'),
        ('  const bool own_coarse = p.L > p.T && p.coarse_in_smem;\n',
         '  MARK(7);\n  const bool own_coarse = p.L > p.T && p.coarse_in_smem;\n'),
        ("  // level 0: the tile's hole pixels. With",
         "  MARK(8);\n  // level 0: the tile's hole pixels. With"),
        ('    push_tile(img, hole, p, t, scratch, out, sm, win, coarse_done);\n'
         '    __syncthreads();\n',
         '    push_tile(img, hole, p, t, scratch, out, sm, win, coarse_done);\n'
         '    __syncthreads();\n    MARK(9);\n'),
    ],
    'dynhead_fwd': [
        ('  const int lane = threadIdx.x;\n',
         '  const int lane = threadIdx.x;\n  MARK(0);\n'),
        ('  for (int q = lane; q < len; q += 32) {',
         '  MARK(1);\n  for (int q = lane; q < len; q += 32) {'),
        ('    dyn_advance(x, y, 32, w);\n  }\n',
         '    dyn_advance(x, y, 32, w);\n  }\n  MARK(2);\n'),
    ],
    'dynhead_bwd': [
        ('      reinterpret_cast<const float4*>(feat) + 2 * ((size_t)b * hw + q0);\n',
         '      reinterpret_cast<const float4*>(feat) + 2 * ((size_t)b * hw + q0);\n'
         '  MARK(0);\n'),
        ("      // the 8 pixel slots' sums",
         "      MARK(1);\n      // the 8 pixel slots' sums"),
        ("    __syncthreads();\n    // the tile's feature gradients",
         "    MARK(2);\n    __syncthreads();\n    // the tile's feature gradients"),
        ('    if (!last_grp) __syncthreads();\n',
         '    MARK(3);\n    if (!last_grp) __syncthreads();\n'),
    ],
}
# each report: (its name, the marks it spans)
PHASES = {
    'compact': ('tile counter, mask, ranks or the dense copy issued, '
                'publish, look-back and wait, the run written',
                [0, 1, 2, 3, 4, 5, 6]),
    'pull': ('pull, grid barrier', [0, 1, 2]),
    'push': ('windows, loads issued, coarse levels, the windows\' sums '
             'landed, window levels, hole pixels', [3, 4, 5, 6, 7, 8, 9]),
    'dynhead_fwd': ('weights and first features issued, pixels', [0, 1, 2]),
    'dynhead_bwd': ("warp 0's two instances up to the second's slot "
                    "tree, that tree and partial, the barrier and feature "
                    'sums', [0, 1, 2, 3]),
}


def marked_copy(root: str) -> str:
    """A copy of this checkout's package under ``root`` with the marks
    in its K10 and K13a sources."""
    here = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(root, 'cartoonsegmentation_torch')
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(here, 'cartoonsegmentation_torch'), dst,
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    for name, edits in MARKS.items():
        path = os.path.join(dst, 'csrc', f'{name}.cu')
        with open(path) as f:
            text = f.read().replace('namespace {', HEAD + '\nnamespace {', 1)
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'{name}.cu: the mark edit no longer '
                                   f'applies at {old[:60]!r}')
            text = text.replace(old, new, 1)
        with open(path, 'w') as f:
            f.write(text)
    return root


def read_marks(_cuda, lib: str, n: int):
    import numpy as np
    buf = np.zeros(BLOCKS * SLOTS, np.int64)
    fn = _cuda.lib(lib).kb_read_marks
    fn.argtypes = [ctypes.c_void_p]
    if fn(buf.ctypes.data) != 0:
        raise RuntimeError('kb_read_marks failed')
    return buf.reshape(BLOCKS, SLOTS)[:n]


def phases(marks, points) -> dict:
    import numpy as np
    d = np.diff(marks[:, points], axis=1)
    return {'median': [int(v) for v in np.median(d, 0)],
            'max': [int(v) for v in d.max(0)]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--compact-inputs', help='K10 calls saved by '
                    'render_kernel_times.py --save-compact-inputs')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA card', flush=True)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    print(f'card: {cs.card_line()}', flush=True)
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    M = cs.H * cs.W
    src = [torch.rand((M, 3), device=dev, generator=g),
           torch.rand((M, 3), device=dev, generator=g),
           torch.rand((M,), device=dev, generator=g),
           torch.rand((M,), device=dev, generator=g)]
    masks = {'all set': torch.ones((M,), dtype=torch.bool, device=dev),
             '3% set': torch.rand((M,), device=dev, generator=g) < 0.03}
    gen = torch.Generator().manual_seed(args.seed)
    x = torch.rand((448, 768, 3), generator=gen).to(dev)
    holes = {'20% random': (torch.rand((448, 768), generator=gen) < 0.2
                            ).to(dev),
             'one 100x100 block': torch.zeros((448, 768), dtype=torch.bool,
                                              device=dev)}
    holes['one 100x100 block'][100:200, 300:400] = True
    img = torch.from_numpy(cs.make_image(args.seed)).to(dev).float()
    img = torch.nn.functional.interpolate(
        img.permute(2, 0, 1)[None] / 255, size=(448, 768), mode='bilinear',
        align_corners=False)[0].permute(1, 2, 0).contiguous()
    discs = cs.fill_hole(torch.Generator().manual_seed(args.seed), 448,
                         768).to(dev)
    out = {'device_ms': {}, 'phases': {}}

    # 1. the shipped kernels' device time
    sys.path.insert(0, here)
    from cartoonsegmentation_torch.ops import inpaint_fill as fill
    from cartoonsegmentation_torch.pipeline import state
    cloud = state.PointCloud.with_capacity(2 * M, dev)
    payload = torch.cat([src[0], src[1], src[2][:, None], src[3][:, None]],
                        1).contiguous()
    dm = out['device_ms']
    for tag, m in masks.items():
        dm[f'compact {tag}'] = cs.compact_device_ms(cloud, src, m)
        dm[f'payload[mask] {tag} (ms)'] = cs.time_ms(lambda _: payload[m],
                                                     [None] * cs.RUNS)
    for tag, h in holes.items():
        dm[f'pushpull {tag}'] = cs.graph_ms(
            lambda c: fill.push_pull_fill(c, h), x)
    from cartoonsegmentation_torch.models import rtmdet
    k9t = cs.dynhead_case(torch.Generator().manual_seed(args.seed), 8, 8, 80,
                          80)
    dm['dynhead_fwd 8x8 80x80'] = cs.graph_ms(
        lambda x: rtmdet.dynhead_forward(*x[:4]), k9t)
    dm['dynhead_bwd 8x8 80x80'] = cs.graph_ms(
        lambda x: rtmdet.dynhead_backward(*x), k9t)
    dm['jitter_offsets 448x768 on the card (ms)'] = cs.time_ms(
        lambda _: fill.jitter_offsets(448, 768, device=dev), [None] * cs.RUNS)
    for k, v in dm.items():
        print(f'[device] {k}: {v:.4f} ms', flush=True)

    # 2. the marked copy's phases
    for k in list(sys.modules):
        if k.startswith('cartoonsegmentation_torch'):
            del sys.modules[k]
    sys.path.insert(0, marked_copy(os.path.join(here, 'workspace',
                                                'phases')))
    from cartoonsegmentation_torch.ops import _cuda
    from cartoonsegmentation_torch.ops import inpaint_fill as mfill
    from cartoonsegmentation_torch.pipeline import state as mstate
    calls = [(f'synthetic {t}', mstate.PointCloud.with_capacity(2 * M, dev),
              src + [m]) for t, m in masks.items()]
    if args.compact_inputs:
        for i, rec in enumerate(torch.load(args.compact_inputs)):
            calls.append((f"the shipped default clip's append {i}",
                          mstate.PointCloud(*(t.to(dev)
                                              for t in rec['cloud'])),
                          [t.to(dev) for t in rec['args']]))
    name, points = PHASES['compact']
    for tag, c, a in calls:
        count = c.count.clone()
        for _ in range(3):
            c.count.copy_(count)
            mstate.append_masked_into(c, *a)
        torch.cuda.synchronize()
        res = phases(read_marks(_cuda, 'compact', -(-M // 2048)), points)
        out['phases'][f'compact {tag}'] = res
        print(f'[phases] compact {tag} ({name}): SM cycles median '
              f'{res["median"]}, max {res["max"]}', flush=True)
    for _ in range(3):
        mfill.push_pull_fill(img, discs)
    torch.cuda.synchronize()
    marks = read_marks(_cuda, 'pushpull', 14 * 24)
    pushed = marks[:, 3] != 0
    for key in ('pull', 'push'):
        name, points = PHASES[key]
        res = phases(marks if key == 'pull' else marks[pushed], points)
        out['phases'][f'pushpull {key}'] = res
        print(f'[phases] pushpull 448x768, {float(discs.float().mean()):.1%} '
              f'hole, {key} ({name}; {int(pushed.sum())} tiles pushed): SM '
              f'cycles median {res["median"]}, max {res["max"]}', flush=True)
    from cartoonsegmentation_torch.models import rtmdet as mrtmdet
    for _ in range(3):
        mrtmdet.dynhead_forward(*k9t[:4])
        mrtmdet.dynhead_backward(*k9t)
    torch.cuda.synchronize()
    sms = _cuda.sm_count(k9t[0])
    _, chunks = mrtmdet.dynhead_fwd_plan(8, 8, 6400, sms)
    _, tiles = mrtmdet.dynhead_bwd_plan(8, 8, 6400, sms)
    k9t_marks = {'dynhead_fwd': read_marks(_cuda, 'dynhead_fwd', 64 * chunks),
                 'dynhead_bwd': read_marks(_cuda, 'dynhead_bwd', 8 * tiles)}
    for key, marks in k9t_marks.items():
        name, points = PHASES[key]
        res = phases(marks, points)
        out['phases'][key] = res
        print(f'[phases] {key} 8x8 80x80 ({name}; {len(marks)} blocks): SM '
              f'cycles median {res["median"]}, max {res["max"]}', flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
