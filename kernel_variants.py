#!/usr/bin/env python3
"""Design alternatives of K2 (csrc/coverage.cu) and K5b
(csrc/colorize.cu) against the shipped kernels, and K8 (csrc/nms.cu)
and K9 (csrc/maskhead.cu) against a parent checkout's, on one GPU.

    python3 kernel_variants.py [--fill-inputs F --coverage-inputs C]
                               [--parent DIR] [--turns N] [--seed N]
                               [--detector-inputs D --detector-parent DIR]

F and C are the inputs that ``render_kernel_times.py
--save-fill-inputs F --save-coverage-inputs C`` saves from the shipped
default clip. Each alternative is the shipped source with the edits
listed in ``VARIANTS``, built beside it with the same nvcc flags:
- ``coverage warp combine``: lanes on consecutive points, and a
  warp's bits combined a word at a time (``__match_any_sync`` +
  ``__reduce_or_sync``, one ``atomicOr`` a distinct word) in place of
  lanes 32 points apart;
- ``colorize scalar``: the stride-4 channel read by the strided 4-byte
  load in place of one 16-byte load a pixel.
Each is held exactly against the plain version and timed by device
time (``chip_smoke.graph_ms``) in turns with the shipped kernel (A, B,
B, A, three times): K2 on chip_smoke's synthetic miniature, on the
clip's own and on the synthetic one with a third of its points masked
to (0, 0, 0) under shifts of positive z (they all land on one pixel);
K5b on the depth channels of the clip's filled frames, read in place,
and on contiguous copies.

With ``--parent DIR`` (a checkout whose csrc/colorize.cu is the
two-launch K5b, before its one-launch redesign) it also builds that
source, calls it as that checkout's wrapper did (an output and a
partials tensor allocated each call), and times its ``ms`` (CUDA events
around one call on an idle card, host dispatch included:
``chip_smoke.time_ms`` over 5 rounds of the frames) in turns with this
checkout's ``colorize_gray_r`` in one process, ``--turns`` times each,
with the median of the paired differences and its quartiles.

With ``--detector-inputs D --detector-parent DIR`` (the K8 and K9
calls that ``render_kernel_times.py --save-detector-inputs D`` saves
from the shipped default's detector forwards, and a checkout of the
parent) it builds that checkout's csrc/nms.cu and csrc/maskhead.cu,
calls them as its wrappers did, holds this checkout's K8 keep sets and
K9 masks and probabilities bit for bit against theirs on every saved
call (K9 on 3 synthetic calls too: chip_smoke's 100 instances, 80 %
valid), and times both against the parent's in turns: device time
(``in_turns``) and ``ms`` (``chip_smoke.time_ms``, ``--turns`` times
each).

Prints the card and its power limit first and one JSON line last.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

# (kernel source, [(text of the shipped source, its replacement)])
VARIANTS = {
    'coverage warp combine': ('coverage', [
        ('''__device__ __forceinline__ void set_row(uint32_t* bm, int b, bool left,
                                        bool right) {
  if (left && right && (b & 31) != 31) {
    atomicOr(bm + (b >> 5), 3u << (b & 31));
    return;
  }
  if (left) atomicOr(bm + (b >> 5), 1u << (b & 31));
  if (right) atomicOr(bm + ((b + 1) >> 5), 1u << ((b + 1) & 31));
}''', '''__device__ __forceinline__ void set_row(uint32_t* bm, int b, bool left,
                                        bool right) {
  const int s = b & 31;
  const uint32_t lo = (left ? 1u << s : 0u) | (right && s != 31 ? 2u << s : 0u);
  const unsigned peers = __match_any_sync(0xffffffffu, lo ? (b >> 5) : -1);
  const uint32_t all = __reduce_or_sync(peers, lo);
  if (lo && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicOr(bm + (b >> 5), all);
  if (right && s == 31) atomicOr(bm + ((b + 1) >> 5), 1u);
}'''),
        ('const int p0 = 32 * lane + ((warp + lane) & 31);',
         'const int p0 = tid;'),
        # every lane reaches set_row: the skips become predicates
        ('''        if ((long long)t * kTile + p0 + j * kThreads >= N) continue;
        const float xs = xr[j] + sx, ys = yr[j] + sy, zs = z[j] + sz;
        if (!(zs >= 0.001f)) continue;   // kb_project's valid''',
         '''        const bool live = (long long)t * kTile + p0 + j * kThreads < N;
        const float xs = xr[j] + sx, ys = yr[j] + sy, zs = z[j] + sz;'''),
        ('''        if (!(u >= -1.0f && u < Wf && v >= r0f - 1.0f && v < r1f)) continue;''',
         '''        const bool ok = live && zs >= 0.001f && u >= -1.0f && u < Wf &&
                        v >= r0f - 1.0f && v < r1f;'''),
        ('const bool in_y0 = y0 >= r0f, in_y1 = y1 < r1f;',
         'const bool in_y0 = ok && y0 >= r0f, in_y1 = ok && y1 < r1f;'),
        ('const int b0 = small_int((y0 - r0f) * Wf + x0);',
         'const int b0 = ok ? small_int((y0 - r0f) * Wf + x0) : 0;'),
        ('''        if (in_y0) set_row(bm, b0, in_x0 && nw, in_x1 && ne);
        if (in_y1) set_row(bm, b0 + W, in_x0 && sw, in_x1 && se);''',
         '''        set_row(bm, b0, in_y0 && in_x0 && nw, in_y0 && in_x1 && ne);
        set_row(bm, b0 + W, in_y1 && in_x0 && sw, in_y1 && in_x1 && se);'''),
    ]),
    'colorize scalar': ('colorize', [
        ('if (stride == 4) {', 'if (false) {'),
    ]),
}


def build_variant(_cuda, name: str) -> str:
    """The library of variant ``name``: its kernel's shipped source with
    its edits, bound into ``_cuda`` under ``name`` (as ``_cuda.lib``
    binds its own) with the shipped kernel's entry point. Returns the
    name."""
    kernel, edits = VARIANTS[name]
    text = (_cuda.CSRC / f'{kernel}.cu').read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f'{name}: the edit does not apply:\n{old}')
        text = text.replace(old, new)
    return build_source(_cuda, name, text, *_cuda.SIGNATURES[kernel])


def build_source(_cuda, name: str, text: str, entry: str, params: str
                 ) -> str:
    """Build ``text`` (a kernel source) with the shipped nvcc flags and
    bind its ``entry`` (``params`` as in ``_cuda.SIGNATURES``) into
    ``_cuda`` under ``name``."""
    tag = name.replace(' ', '_')
    cu = _cuda.BUILD_DIR / f'variant_{tag}.cu'
    so = _cuda.BUILD_DIR / f'libvariant_{tag}.so'
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-I', str(_cuda.CSRC),
                    '-o', str(so), str(cu)], check=True)
    lib = ctypes.PyDLL(str(so))
    lib.kb_error_string.restype = ctypes.c_char_p
    lib.kb_error_string.argtypes = [ctypes.c_int]
    f = getattr(lib, entry)
    f.restype = ctypes.c_int
    f.argtypes = [_cuda.CTYPES[c] for c in params]
    _cuda._libs[name], _cuda._entries[name] = lib, f
    _cuda.SIGNATURES[name] = (entry, params)
    _cuda.LAUNCHES[name] = 0
    return name


def in_turns(cs, fns: dict, xs: list, rounds: int = 3) -> dict:
    """Device time of each fn over xs (the median over xs), in turns
    A, B, B, A, ``rounds`` times: {name: [ms of each turn]}."""
    res = {n: [] for n in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for n in order:
            res[n].append(statistics.median(cs.graph_ms(fns[n], x)
                                            for x in xs))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--fill-inputs')
    ap.add_argument('--coverage-inputs')
    ap.add_argument('--parent', help='a checkout with the two-launch K5b')
    ap.add_argument('--detector-inputs', help='K8 and K9 calls saved by '
                    'render_kernel_times.py --save-detector-inputs')
    ap.add_argument('--detector-parent', help='a checkout whose K8 and K9 '
                    'the shipped ones are held against (with '
                    '--detector-inputs)')
    ap.add_argument('--turns', type=int, default=50)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA card', flush=True)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from cartoonsegmentation_torch.ops import _cuda, discfill3, pointcloud
    from cartoonsegmentation_torch.pipeline import depth
    print(f'card: {cs.card_line()}', flush=True)
    out = {}

    def summary(tag, res):
        for n, v in res.items():
            print(f'[{tag}] {n}: device median {statistics.median(v):.5f} '
                  f'ms ({" ".join(f"{t:.5f}" for t in v)})', flush=True)
        out[tag] = res
    if args.detector_inputs and args.detector_parent:
        detector_parent(cs, _cuda, args, summary, out)
    if args.fill_inputs and args.coverage_inputs:
        render_variants(cs, _cuda, discfill3, pointcloud, depth, args,
                        summary, out)
    print(json.dumps({'card': cs.card_line(), 'results': out}), flush=True)


def render_variants(cs, _cuda, discfill3, pointcloud, depth, args, summary,
                    out) -> None:
    """K2's and K5b's alternatives (and K5b's two-launch parent)."""
    import torch
    _cuda.build(['coverage', 'colorize', 'discfill'])
    dev = torch.device('cuda')

    # --- K2 -----------------------------------------------------------
    name = build_variant(_cuda, 'coverage warp combine')

    def cover(lib):
        def run(x):
            points, shifts, H, W, focal = x[:5]
            K = shifts.shape[0]
            counts = torch.empty((K,), dtype=torch.int32, device=dev)
            G, band_rows, _ = pointcloud.coverage_plan(
                K, H, W, _cuda.sm_count(points))
            _cuda.launch(lib, points.data_ptr(), points.shape[0],
                         shifts.data_ptr(), K, H, W, float(focal), G,
                         band_rows, counts.data_ptr(),
                         _cuda.stream_ptr(points))
            return counts
        return run

    gen = torch.Generator().manual_seed(args.seed)
    pts, _, depth_map = cs.synthetic_cloud(gen, dev, 11 * (1 << 16))
    syn = cs.synthetic_coverage_inputs(pts, depth_map)
    clip = tuple(t.to(dev) if torch.is_tensor(t) else t
                 for t in torch.load(args.coverage_inputs))
    masked = syn[0].clone()
    masked[torch.rand(masked.shape[0], generator=gen).to(dev) < 1 / 3] = 0.0
    up = syn[1].clone()
    up[:, 2] = up[:, 2].abs() + 1.0
    fns = {'shipped': cover('coverage'), name: cover(name)}
    for tag, x in (('K2 synthetic miniature', syn),
                   ("K2 the clip's miniature", clip),
                   ('K2 a third masked, z shifts > 0',
                    (masked, up) + tuple(syn[2:]))):
        want = pointcloud.coverage_plain(*x)
        for n, f in fns.items():
            if not torch.equal(f(x), want):
                cs.fail(f'{tag}: {n} differs from the plain version')
        summary(tag, in_turns(cs, fns, [x]))

    # --- K5b ----------------------------------------------------------
    name = build_variant(_cuda, 'colorize scalar')

    def scalar(x):
        """colorize_gray_r's call, launching the variant."""
        step = x.stride(1)
        n = x.numel()
        blocks, scratch = depth.colorize_plan(n, _cuda.sm_count(x))
        o = torch.empty((n + scratch,), dtype=torch.float32, device=dev)
        _cuda.launch(name, x.data_ptr(), n, step, blocks, o.data_ptr(),
                     _cuda.stream_ptr(x))
        return o[:n].view(x.shape)

    fns = {'shipped': depth.colorize_gray_r, name: scalar}
    if args.parent:
        build_source(_cuda, 'colorize parent', open(os.path.join(
            args.parent, 'cartoonsegmentation_torch', 'csrc',
            'colorize.cu')).read(), 'kb_colorize', 'pqippp')

        def parent(x):
            """The parent checkout's colorize_gray_r."""
            if x.device.type == 'cpu':
                return depth.colorize_gray_r_plain(x)
            if x.dtype != torch.float32 or x.ndim != 2:
                raise TypeError('(H, W) float32')
            step = x.stride(1)
            if x.stride(0) != step * x.shape[1] or step < 1:
                x, step = x.contiguous(), 1
            o = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            partials = torch.empty((2 * 264,), dtype=torch.float32,
                                   device=x.device)
            _cuda.launch('colorize parent', x.data_ptr(), x.numel(), step,
                         partials.data_ptr(), o.data_ptr(),
                         _cuda.stream_ptr(x))
            return o
        fns['parent'] = parent
    real = [tuple(t.to(dev) for t in x) for x in torch.load(args.fill_inputs)]
    maps = [discfill3.fill_disocclusion(*x)[..., 3] for x in real]
    for tag, xs in (("K5b the clip's filled frames' depth channel", maps),
                    ('K5b contiguous copies', [m.contiguous()
                                               for m in maps])):
        for x in xs:
            want = depth.colorize_gray_r_plain(x)
            for n, f in fns.items():
                if not torch.equal(f(x), want):
                    cs.fail(f'{tag}: {n} differs from the plain version')
        summary(tag, in_turns(cs, fns, xs))
    if args.parent:
        ms = {'shipped': [], 'parent': []}
        for i in range(args.turns):
            for n in (('shipped', 'parent') if i % 2 else
                      ('parent', 'shipped')):
                ms[n].append(cs.time_ms(fns[n], maps * 5))
        for n, v in ms.items():
            q = statistics.quantiles(v, n=4)
            print(f'[K5b ms, {args.turns} turns of {5 * len(maps)} calls] '
                  f'{n}: median {statistics.median(v):.5f} ms, quartiles '
                  f'{q[0]:.5f} {q[2]:.5f}', flush=True)
        d = [a - b for a, b in zip(ms['shipped'], ms['parent'])]
        q = statistics.quantiles(d, n=4)
        print(f'[K5b ms] shipped - parent, paired by turn: median '
              f'{statistics.median(d):.5f} ms, quartiles {q[0]:.5f} '
              f'{q[2]:.5f}', flush=True)
        out['K5b ms'] = ms


def detector_parent(cs, _cuda, args, summary, out) -> None:
    """K8 and K9 against the parent's kernels: bit for bit, by device
    time in turns and by ``ms`` in turns."""
    import torch
    from cartoonsegmentation_torch.models import rtmdet
    _cuda.build(['nms', 'maskhead'])
    dev = torch.device('cuda')
    seen = cs.load_detector_inputs(args.detector_inputs, dev)
    gen = torch.Generator().manual_seed(args.seed)
    N, h = 100, 80
    synth = []
    for _ in range(3):
        val = torch.rand((N,), generator=gen) < 0.8
        synth.append((torch.randn((h, h, 8), generator=gen).to(dev),
                      torch.randn((N, 169), generator=gen).to(dev),
                      (torch.randint(0, h, (N, 2), generator=gen).float()
                       * 8).to(dev),
                      torch.tensor([8.0, 16.0, 32.0])[torch.randint(
                          0, 3, (N,), generator=gen)].to(dev), val.to(dev),
                      640, 640, 0.3))
    src = os.path.join(args.detector_parent, 'cartoonsegmentation_torch',
                       'csrc')
    for kernel in ('maskhead', 'nms'):
        build_source(_cuda, f'{kernel} parent', open(os.path.join(
            src, f'{kernel}.cu')).read(), *_cuda.SIGNATURES[kernel])

    def heads_parent(x):
        feat, kern, pri, st, val, Ho, Wo, thr = x
        n, (hh, ww) = kern.shape[0], feat.shape[:2]
        probs = torch.empty((n, hh * ww), dtype=torch.float32, device=dev)
        masks = torch.empty((n, Ho, Wo), dtype=torch.bool, device=dev)
        _cuda.launch('maskhead parent', feat.data_ptr(), kern.data_ptr(),
                     pri.data_ptr(), st.data_ptr(), val.data_ptr(), n, hh,
                     ww, Ho, Wo, thr, probs.data_ptr(), masks.data_ptr(),
                     _cuda.stream_ptr(feat))
        return masks, probs

    def nms_parent(x):
        boxes, scores, thr, n_out = x
        idx = torch.empty((n_out,), dtype=torch.int64, device=dev)
        keep = torch.empty((n_out,), dtype=torch.bool, device=dev)
        _cuda.launch('nms parent', boxes.data_ptr(), scores.data_ptr(),
                     boxes.shape[0], thr, n_out, idx.data_ptr(),
                     keep.data_ptr(), _cuda.stream_ptr(boxes))
        return idx, keep

    fns = {'K8': lambda x: rtmdet.nms_fixed(*x), 'K8 parent': nms_parent,
           'K9': lambda x: rtmdet.dynamic_masks(*x),
           'K9 parent': heads_parent}
    cases = (("K8 the shipped default's forwards", 'K8', seen['nms']),
             ("K9 the shipped default's forwards", 'K9', seen['maskhead']),
             ('K9 synthetic', 'K9', synth))
    for tag, k, xs in cases:
        for x in xs:
            got, want = fns[k](x), fns[f'{k} parent'](x)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                cs.fail(f'{tag}: {k} differs from the parent kernel')
        print(f'[{tag}] bit-equal to the parent kernel', flush=True)
        summary(tag, in_turns(cs, {k: fns[k], 'parent': fns[f'{k} parent']},
                              xs))
    ms = {n: [] for n in fns}
    for i in range(args.turns):
        for n in (list(fns) if i % 2 else list(fns)[::-1]):
            xs = seen['nms'] if n.startswith('K8') else seen['maskhead']
            ms[n].append(cs.time_ms(fns[n], xs * 3))
    for n, v in ms.items():
        q = statistics.quantiles(v, n=4)
        print(f'[K8/K9 ms, {args.turns} turns] {n}: median '
              f'{statistics.median(v):.5f} ms, quartiles {q[0]:.5f} '
              f'{q[2]:.5f}', flush=True)
    out['K8/K9 ms'] = ms

if __name__ == '__main__':
    main()
