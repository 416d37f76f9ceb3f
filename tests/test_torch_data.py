"""The port's data modules (cartoonsegmentation_torch/data: samplers,
augment, paste, syndataset, dataset) against the JAX package's, on the
same seeds: equal outputs, array for array and byte for byte.

Both packages draw from Python's ``random`` and numpy's global state,
so each comparison seeds both the same way before each package runs.
"""
import json
import os
import os.path as osp
import random

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from cartoonsegmentation_tpu.data import augment as jaug  # noqa: E402
from cartoonsegmentation_tpu.data import dataset as jds  # noqa: E402
from cartoonsegmentation_tpu.data import paste as jpaste  # noqa: E402
from cartoonsegmentation_tpu.data import samplers as jsamp  # noqa: E402
from cartoonsegmentation_tpu.data import syndataset as jsyn  # noqa: E402
from cartoonsegmentation_torch.data import augment as taug  # noqa: E402
from cartoonsegmentation_torch.data import dataset as tds  # noqa: E402
from cartoonsegmentation_torch.data import paste as tpaste  # noqa: E402
from cartoonsegmentation_torch.data import samplers as tsamp  # noqa: E402
from cartoonsegmentation_torch.data import syndataset as tsyn  # noqa: E402
from cartoonsegmentation_torch.utils import constants as tconst  # noqa: E402
from torch_cpu import torch_threads  # noqa: F401,E402  (autouse)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _same(a, b):
    """Equal nested outputs: arrays by value and dtype, lists, dicts."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _both(fn_j, fn_t, seed=0):
    """Each package's call after the same seeding; asserts them equal."""
    _seed(seed)
    want = fn_j()
    _seed(seed)
    got = fn_t()
    _same(got, want)
    return got


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """4 RGBA foregrounds (ellipse blobs with soft alpha), 3 backgrounds
    (one grey, one with alpha), a person-box layout file."""
    root = tmp_path_factory.mktemp('assets')
    rng = np.random.RandomState(0)
    fgs = []
    for i in range(4):
        c = np.zeros((90 + 10 * i, 60, 4), np.uint8)
        col = tuple(int(v) for v in rng.randint(0, 255, 3))
        cv2.ellipse(c, (30, 45), (22, 40), 0, 0, 360, col + (255,), -1)
        c[..., :3] = np.clip(c[..., :3].astype(int)
                             + rng.randint(-30, 30, c[..., :3].shape), 0,
                             255).astype(np.uint8)
        c[..., 3] = cv2.GaussianBlur(c[..., 3], (5, 5), 2)
        p = str(root / f'fg{i}.png')
        cv2.imwrite(p, c)
        fgs.append(p)
    bgs = []
    for i, ch in enumerate((3, 1, 4)):
        b = (rng.rand(120, 160, ch) * 255).astype(np.uint8)
        p = str(root / f'bg{i}.png')
        cv2.imwrite(p, b if ch != 1 else b[..., 0])
        bgs.append(p)
    layouts = [[[10, 20, 30, 60, 160, 120], [80, 10, 40, 100, 160, 120]],
               [[5, 5, 50, 90, 160, 120]], []]
    pbs = root / 'person_bbox.json'
    pbs.write_text(json.dumps(layouts))
    return {'root': root, 'fgs': fgs, 'bgs': bgs, 'pbs': str(pbs)}


def test_image_id_zfill():
    from cartoonsegmentation_tpu.utils.constants import IMAGE_ID_ZFILL
    assert tconst.IMAGE_ID_ZFILL == IMAGE_ID_ZFILL == 12


@pytest.mark.parametrize('case', ['train', 'val_personbbox'])
def test_syn_dataset_equal(assets, tmp_path, case):
    """One seed writes the same annotation JSON and byte-equal images."""
    kw = dict(tgt_size=96, max_syn_num=8, syn_num_multiplier=3, seed=3)
    if case == 'train':
        kw.update(policy='train', hist_match_prob=0.4, quantize_prob=0.4)
    else:
        kw.update(policy='val', person_bbox_samples=assets['pbs'],
                  person_paste_prob=0.5, regular_paste_prob=0.2)
    fg_info = [{'path': p} for p in assets['fgs']]
    a = jsyn.syn_animecoco_dataset(assets['bgs'], fg_info,
                                   str(tmp_path / 'jax'), **kw)
    b = tsyn.syn_animecoco_dataset(assets['bgs'], fg_info,
                                   str(tmp_path / 'port'), **kw)
    ja, tb = json.load(open(a)), json.load(open(b))
    assert ja == tb
    assert len(tb['images']) >= 3 and len(tb['annotations']) >= 3
    policy = kw['policy']
    for im in tb['images']:
        want = open(osp.join(tmp_path, 'jax', policy, im['file_name']),
                    'rb').read()
        got = open(osp.join(tmp_path, 'port', policy, im['file_name']),
                   'rb').read()
        assert got == want


@pytest.fixture(scope='module')
def coco(assets, tmp_path_factory):
    """A synthetic COCO set written by the port, one annotation made
    bbox-only (no segmentation: an ignore-mask instance)."""
    out = tmp_path_factory.mktemp('coco')
    fg_info = [{'path': p} for p in assets['fgs']]
    ann = tsyn.syn_animecoco_dataset(assets['bgs'], fg_info, str(out),
                                     tgt_size=96, max_syn_num=6,
                                     syn_num_multiplier=3, seed=1)
    d = json.load(open(ann))
    del d['annotations'][0]['segmentation']
    json.dump(d, open(ann, 'w'))
    return ann, osp.join(out, 'train')


@pytest.mark.parametrize('mosaic,mixup', [(0.0, 0.0), (1.0, 0.0),
                                          (0.5, 1.0)])
def test_mixed_dataset_batches_equal(coco, mosaic, mixup):
    """MixedDetDataset.batches over two concatenated sources, array for
    array, with mosaic and mixup on and off."""
    ann, root = coco

    def run(mod):
        srcs = [mod.CocoSource(ann, root, 'a'), mod.CocoSource(ann, root, 'b')]
        ds = mod.MixedDetDataset(srcs, img_size=64, mosaic_prob=mosaic,
                                 mixup_prob=mixup, max_instances=5)
        return list(ds.batches(3, 2))
    got = _both(lambda: run(jds), lambda: run(tds), seed=7)
    assert got[0]['images'].shape == (3, 64, 64, 3)
    assert got[0]['gt_ignore'].dtype == bool


def test_coco_source_load_equal(coco):
    ann, root = coco
    a, b = jds.CocoSource(ann, root), tds.CocoSource(ann, root)
    assert a.ids == b.ids
    for i in range(len(a)):
        _same(b.load(i), a.load(i))
    assert b.load(0)['ignore'].any()


@pytest.mark.parametrize('train', [True, False])
def test_mask_refine_dataset_equal(coco, train):
    ann, root = coco
    a = jds.MaskRefineDataset(jds.CocoSource(ann, root), input_size=48,
                              train=train)
    b = tds.MaskRefineDataset(tds.CocoSource(ann, root), input_size=48,
                              train=train)
    assert a.items == b.items and len(b) > 2
    _both(lambda: [a[i] for i in range(len(a))],
          lambda: [b[i] for i in range(len(b))], seed=5)


def test_samplers_equal(assets):
    def draws(mod):
        out = [mod.NameSampler({'a': 0.3, 'b': 0.5}).sample()
               for _ in range(20)]
        out += [mod.PoissonSampler(2.5, 1, 9).sample() for _ in range(20)]
        out += [mod.NormalSampler(scalar=640, to_int=True,
                                  max_scale=0.75).sample() for _ in range(20)]
        out += [mod.NormalSampler(to_int=False).sample() for _ in range(5)]
        pbs = mod.PersonBBoxSampler(assets['pbs'])
        out += [pbs.sample(96) for _ in range(5)]
        fg, info = mod.random_load_valid_fg([{'path': p}
                                             for p in assets['fgs']])
        out += [fg, info, mod.random_load_valid_bg(assets['bgs'])]
        out.append(mod.load_image_any(assets['bgs'][2]))
        return out
    got = _both(lambda: draws(jsamp), lambda: draws(tsamp), seed=11)
    assert got[-1].shape[2] == 4


def _fg(assets, i=0):
    return cv2.imread(assets['fgs'][i], cv2.IMREAD_UNCHANGED)


def _bg(assets, i=0, size=96):
    return cv2.resize(cv2.imread(assets['bgs'][i]), (size, size))


@pytest.mark.parametrize('mode', ['partition', 'regular', 'bbox', 'alpha'])
def test_paste_equal(assets, mode):
    fgs = [_fg(assets, i) for i in range(4)]
    fgs = [cv2.resize(f, (f.shape[1] // 2, f.shape[0] // 2)) for f in fgs]
    bg = _bg(assets)
    boxes = [np.array([5, 5, 30, 40], np.float32),
             np.array([40, 20, 20, 60], np.float32),
             np.array([60, 60, 2, 2], np.float32),
             np.array([70, 10, 25, 50], np.float32)]

    def run(mod):
        if mode == 'partition':
            return mod.partition_paste(bg, fgs)
        if mode == 'regular':
            return mod.regular_paste(bg, fgs)
        if mode == 'bbox':
            return mod.bbox_paste(bg, fgs, boxes)
        canvas = bg.copy()
        return canvas, [mod.alpha_paste(canvas, fgs[0], -5, 70),
                        mod.alpha_paste(canvas, fgs[1], 200, 0)]
    canvas, masks = _both(lambda: run(jpaste), lambda: run(tpaste), seed=13)
    assert canvas.shape == bg.shape and len(masks) >= 1


AUGMENTS = ['resize2height', 'rotate_image', 'color_jitter',
            'jpeg_artifacts', 'gaussian_blur', 'fg_transform',
            'fg_transform_eval', 'bg_transform', 'quantize_image',
            'hist_match', 'fgbg_hist_matching']


@pytest.mark.parametrize('name', AUGMENTS)
def test_augment_equal(assets, name):
    fg = _fg(assets, 1)
    bg = cv2.imread(assets['bgs'][0])

    def run(mod):
        if name == 'resize2height':
            return [mod.resize2height(fg, 40), mod.resize2height(fg, 150)]
        if name == 'rotate_image':
            return mod.rotate_image(fg, 17.5)
        if name == 'color_jitter':
            return [mod.color_jitter(fg), mod.color_jitter(bg)]
        if name == 'jpeg_artifacts':
            return [mod.jpeg_artifacts(fg, 70), mod.jpeg_artifacts(bg, 90)]
        if name == 'gaussian_blur':
            return mod.gaussian_blur(fg, 1.2)
        if name == 'fg_transform':
            return [mod.fg_transform(fg, 64) for _ in range(6)]
        if name == 'fg_transform_eval':
            return mod.fg_transform(fg, 64, train=False)
        if name == 'bg_transform':
            return [mod.bg_transform(bg, 64) for _ in range(6)]
        if name == 'quantize_image':
            return list(mod.quantize_image(bg, 8))
        if name == 'hist_match':
            return mod.hist_match(fg[..., :3], bg)
        return mod.fgbg_hist_matching(fg, bg, 0.6)
    _both(lambda: run(jaug), lambda: run(taug), seed=17)
