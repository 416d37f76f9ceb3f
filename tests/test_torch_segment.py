"""The port's segmentation path on the CPU against the JAX package's:
the RLE codec and COCO export byte for byte, ``Instances.draw`` pixel
for pixel, and ``python -m cartoonsegmentation_torch.run_segmentation``
end to end on a small image."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.data import coco_export as jcoco
from cartoonsegmentation_tpu.data import rle as jrle
from cartoonsegmentation_tpu.instances import Instances as JIns
from cartoonsegmentation_tpu.utils import constants as jconst
from cartoonsegmentation_torch.data import coco_export as tcoco
from cartoonsegmentation_torch.data import rle as trle
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.utils import constants as tconst
from torch_cpu import torch_threads  # noqa: F401  (autouse)


def _masks(rng, n=5, h=37, w=53):
    """Discs and boxes, an empty mask, a full one, one set at (0, 0)."""
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((n, h, w), bool)
    m[0] = (xx - 20) ** 2 + (yy - 15) ** 2 < 100
    m[1] = rng.rand(h, w) < 0.4
    m[2, 3:30, 40:] = True
    m[2, 0, 0] = True
    m[4] = True
    return m                                     # m[3] stays empty


def _pair(rng):
    masks = _masks(rng)
    boxes = rng.uniform(0, 30, (5, 4)).astype(np.float32)
    scores = rng.rand(5).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    masks &= valid[:, None, None]
    t = TIns(masks=torch.from_numpy(masks), bboxes=torch.from_numpy(boxes),
             scores=torch.from_numpy(scores), valid=torch.from_numpy(valid))
    j = JIns(masks=jnp.asarray(masks), bboxes=jnp.asarray(boxes),
             scores=jnp.asarray(scores), valid=jnp.asarray(valid))
    return t, j, masks


def test_rle_vs_jax(rng):
    for m in _masks(rng):
        got, want = trle.encode(m), jrle.encode(m)
        assert got == want
        np.testing.assert_array_equal(trle.decode(got), m)
        np.testing.assert_array_equal(trle.decode(
            {'size': got['size'], 'counts': got['counts'].encode()}), m)
    assert tcoco.mask2rle(_masks(rng)[0]) == jcoco.mask2rle(_masks(rng)[0])


def test_instances_to_coco_vs_jax(rng):
    t, j, masks = _pair(rng)
    tags = ['a', '', 'c']
    got = tcoco.instances_to_coco(t, 7, 'x.png', (37, 53), obj_id_start=3,
                                  tags=tags)
    want = jcoco.instances_to_coco(j, 7, 'x.png', (37, 53), obj_id_start=3,
                                   tags=tags)
    assert json.dumps(got) == json.dumps(want)
    assert [a['id'] for a in got[1]] == [3, 4, 5, 6]
    for a, i in zip(got[1], (0, 1, 3, 4)):
        np.testing.assert_array_equal(tcoco.rle2mask(a['segmentation']),
                                      masks[i])


def test_constants_vs_jax():
    assert tconst.CATEGORIES == jconst.CATEGORIES
    assert [tconst.get_color(i) for i in range(-1, 30)] == \
        [jconst.get_color(i) for i in range(-1, 30)]
    assert tconst.get_color(3, bgr=False) == jconst.get_color(3, bgr=False)


@pytest.mark.parametrize('kw', [{}, dict(draw_contour=True, tags=['x', 'y']),
                                dict(draw_bbox=False, mask_alpha=0.4),
                                dict(resize=True)])
def test_draw_vs_jax(rng, kw):
    """Boxes, masks, contours and tags, and an image at another size
    than the masks (resized to them), equal to the JAX drawing."""
    pytest.importorskip('cv2')
    kw = dict(kw)
    t, j, _ = _pair(rng)
    shape = (74, 106, 3) if kw.pop('resize', False) else (37, 53, 3)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    got, want = t.draw(img, **kw), j.draw(img, **kw)
    assert got.shape == (37, 53, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _png(tmp_path, rng, name='pic.png'):
    cv2 = pytest.importorskip('cv2')
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 17), 128 + 90 * np.cos(yy / 9),
                    128 + 60 * np.sin((xx + yy) / 13)], -1)
    img[30:70, 40:90] = rng.uniform(0, 255, 3)
    path = tmp_path / name
    cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8))
    return path


def test_run_segmentation_cli(tmp_path, rng, capsys):
    """The CLI on a small image with the full-width detector at det
    size 256: a drawn image and a COCO JSON whose RLEs decode to the
    detector's masks."""
    cv2 = pytest.importorskip('cv2')
    from cartoonsegmentation_torch import run_segmentation
    from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg
    src = _png(tmp_path, rng)
    out = tmp_path / 'out'
    ann = tmp_path / 'ann.json'
    run_segmentation.main(['--input', str(src), '--save-dir', str(out),
                           '--det-size', '256', '--save-json', str(ann),
                           '--device', 'cpu'])
    assert 'instances' in capsys.readouterr().out
    drawn = cv2.imread(str(out / 'pic.png'))
    assert drawn.shape == (96, 128, 3)
    coco = json.loads(ann.read_text())
    assert coco['categories'] == tconst.CATEGORIES
    assert coco['images'][0]['file_name'] == 'pic.png'
    img = cv2.imread(str(src))
    ins = AnimeInsSeg(det_size=256, device='cpu').infer(img, 0.3)
    idx = [i for i in range(ins.capacity) if bool(ins.valid[i])]
    assert idx and len(coco['annotations']) == len(idx)
    for a, i in zip(coco['annotations'], idx):
        np.testing.assert_array_equal(tcoco.rle2mask(a['segmentation']),
                                      ins.masks[i].numpy())
    np.testing.assert_array_equal(drawn, ins.draw(img))     # PNG: lossless


def test_run_segmentation_maskrcnn(tmp_path, rng, monkeypatch, capsys):
    """The CLI with --detector maskrcnn on the CPU, the detector at
    min-side 64 / max-side 96 with the edged small net of
    tests/test_torch_maskrcnn.py: a drawn image and a COCO JSON whose
    RLEs decode to the detector's masks."""
    cv2 = pytest.importorskip('cv2')
    from cartoonsegmentation_torch import run_segmentation
    from cartoonsegmentation_torch.pipeline import maskrcnn_det
    from test_torch_maskrcnn import edged_net

    class Small(maskrcnn_det.MaskRCNNDetector):
        def __init__(self, **kw):
            super().__init__(min_size=64, max_size=96, model=edged_net(),
                             **kw)
    monkeypatch.setattr(maskrcnn_det, 'MaskRCNNDetector', Small)
    src = _png(tmp_path, rng)
    out = tmp_path / 'out'
    ann = tmp_path / 'ann.json'
    run_segmentation.main(['--input', str(src), '--save-dir', str(out),
                           '--detector', 'maskrcnn', '--score-thr', '0.1',
                           '--save-json', str(ann), '--device', 'cpu'])
    assert 'instances' in capsys.readouterr().out
    img = cv2.imread(str(src))
    ins = Small(device='cpu').infer(img, 0.1)
    assert ins.capacity == 16
    idx = [i for i in range(ins.capacity) if bool(ins.valid[i])]
    coco = json.loads(ann.read_text())
    assert idx and len(coco['annotations']) == len(idx)
    for a, i in zip(coco['annotations'], idx):
        np.testing.assert_array_equal(tcoco.rle2mask(a['segmentation']),
                                      ins.masks[i].numpy())
    np.testing.assert_array_equal(cv2.imread(str(out / 'pic.png')),
                                  ins.draw(img))
