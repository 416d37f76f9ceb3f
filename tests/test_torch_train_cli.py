"""The port's training CLI (``python -m
cartoonsegmentation_torch.train_detector --device cpu``) end to end on a
tiny on-disk COCO set (tests/test_train_cli.py's ``_make_coco``, rebuilt
here with the port's RLE codec): a 2-step run at nano / 64 with mosaic,
COCO-mAP validation, metrics.jsonl's train and val rows, the checkpoint
(EMA 'params' that ``AnimeInsSeg.load_variables`` loads, 'raw_params'),
then a resumed step; the assertions mirror tests/test_train_cli.py:47.
The viz hook draws the port's ``Instances`` into a grid; the tracker's
``RunningAverageDict`` and ``metrics.jsonl`` rows against the JAX
package's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from torch_cpu import torch_threads, worker_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_coco(tmp_path, n_images=3, size=64):
    import cv2
    from cartoonsegmentation_torch.data import rle as rle_codec
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    aid = 1
    for i in range(n_images):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        name = f'{i}.png'
        cv2.imwrite(str(img_dir / name), img)
        images.append({'id': i + 1, 'file_name': name,
                       'height': size, 'width': size})
        for _ in range(2):
            x, y = rng.randint(0, size // 2, 2)
            w, h = rng.randint(8, size // 2, 2)
            m = np.zeros((size, size), bool)
            m[y:y + h, x:x + w] = True
            annotations.append({
                'id': aid, 'image_id': i + 1, 'category_id': 1,
                'bbox': [int(x), int(y), int(w), int(h)],
                'area': int(w * h),
                'segmentation': rle_codec.encode(m), 'iscrowd': 0})
            aid += 1
    ann = {'images': images, 'annotations': annotations,
           'categories': [{'id': 1, 'name': 'character'}]}
    ann_path = tmp_path / 'train.json'
    ann_path.write_text(json.dumps(ann))
    return ann_path, img_dir


def _run(args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS=str(worker_threads()))
    return subprocess.run(
        [sys.executable, '-m', 'cartoonsegmentation_torch.train_detector',
         '--device', 'cpu', *args], capture_output=True, text=True,
        timeout=600, cwd=REPO, env=env)


def test_train_detector_cli_cpu(tmp_path):
    ann, img_dir = _make_coco(tmp_path)
    ckpt = tmp_path / 'det.pt'
    res = _run(['--ann', f'{ann}={img_dir}', '--val-ann', f'{ann}={img_dir}',
                '--size', 'nano', '--img-size', '64', '--batch', '4',
                '--steps', '2', '--log-every', '1', '--val-max-images', '2',
                '--mosaic-prob', '0.5', '--viz-dir', str(img_dir),
                '--ckpt-out', str(ckpt)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert ckpt.exists()
    log = res.stderr + res.stdout
    assert 'step 2/2' in log
    assert 'val animeins_bbox' in log and 'val animeins_segm' in log

    rows = [json.loads(ln) for ln in
            (tmp_path / 'run' / 'metrics.jsonl').read_text().splitlines()]
    train = [r for r in rows if 'Train/loss' in r]
    vals = [r for r in rows if any(k.startswith('Metrics/') for k in r)]
    assert len(train) == 2 and train[-1]['step'] == 2
    for r in train:
        for k in ('loss', 'loss_cls', 'loss_bbox', 'loss_mask',
                  'img_per_s'):
            assert np.isfinite(r[f'Train/{k}'])
    assert vals and any(k.endswith('/mAP') for k in vals[0])
    assert (tmp_path / 'run' / 'images' / 'val_step2.jpg').exists()

    # the checkpoint: EMA weights with the BN buffers, and the raw ones;
    # the detector loads the EMA state dict strictly
    from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg
    from cartoonsegmentation_torch.utils.checkpoint import load_params
    saved = load_params(str(ckpt))
    assert set(saved) == {'params', 'raw_params'}
    seg = AnimeInsSeg(det_size=64, device='cpu', deepen=0.33, widen=0.125)
    seg.load_variables(saved['params'])
    k = 'backbone.stem.0.conv.weight'
    assert not torch.equal(saved['params'][k], saved['raw_params'][k])
    b = 'backbone.stem.0.bn.running_var'
    assert torch.equal(saved['params'][b], saved['raw_params'][b])

    # resume loads the saved checkpoint
    ckpt2 = tmp_path / 'det2.pt'
    res2 = _run(['--ann', f'{ann}={img_dir}', '--size', 'nano',
                 '--img-size', '64', '--batch', '4', '--steps', '1',
                 '--log-every', '1', '--resume', str(ckpt),
                 '--ckpt-out', str(ckpt2)], tmp_path)
    assert res2.returncode == 0, res2.stderr[-3000:]
    assert 'resuming params from' in res2.stderr + res2.stdout
    assert ckpt2.exists()
    # the resumed weights went on from the saved ones: the first update
    # has lr 0, but the step's forward moved the running statistics
    again = load_params(str(ckpt2))
    assert torch.equal(again['raw_params'][k], saved['raw_params'][k])
    assert not torch.equal(again['raw_params'][b], saved['raw_params'][b])


def test_tracker_and_viz_hook_against_jax(tmp_path):
    """RunningAverageDict's means (non-finite values skipped, late keys)
    and ExperimentTracker's rows equal JAX's but for the wall clock; the
    viz hook writes a grid of the detector's drawn instances."""
    import cv2
    from cartoonsegmentation_tpu.utils import tracking as jtrack
    from cartoonsegmentation_torch.instances import Instances
    from cartoonsegmentation_torch.parallel.hooks import \
        InstanceSegVisualizationHook
    from cartoonsegmentation_torch.utils import tracking as ttrack
    ups = [{'a': 1.0, 'b': float('nan')}, {'a': 2.5, 'c': np.float32(4)},
           None, {'b': 3.0}]
    ja, ta = jtrack.RunningAverageDict(), ttrack.RunningAverageDict()
    for u in ups:
        ja.update(u)
        ta.update(u)
    assert ta.value() == ja.value() and bool(ta) == bool(ja)
    rows = {}
    for name, mod in (('jax', jtrack), ('port', ttrack)):
        with mod.ExperimentTracker(str(tmp_path / name),
                                   config={'lr': 1e-3, 'x': (1, 2)}) as t:
            t.log({'loss': np.float32(0.5), 'n': 3}, 1, prefix='Train/')
            t.log({'mAP': 0.25}, 2, prefix='Metrics/a/')
            t.log_image('grid', np.zeros((8, 8, 3), np.uint8), 2)
        rows[name] = [{k: v for k, v in json.loads(ln).items()
                       if k != 'wall_s'} for ln in
                      (tmp_path / name / 'metrics.jsonl').read_text()
                      .splitlines()]
        assert (tmp_path / name / 'images' / 'grid_step2.jpg').exists()
    assert rows['port'] == rows['jax']
    assert (tmp_path / 'port' / 'config.json').read_text() == \
        (tmp_path / 'jax' / 'config.json').read_text()

    samples = tmp_path / 'samples'
    samples.mkdir()
    for i in range(3):
        cv2.imwrite(str(samples / f'{i}.png'),
                    np.full((40, 60, 3), 60 * i, np.uint8))

    class Det:
        def infer(self, img):
            m = np.zeros((1,) + img.shape[:2], bool)
            m[0, 5:20, 10:30] = True
            return Instances.from_numpy(m, np.array([[10, 5, 20, 15]]))
    logged = []
    hook = InstanceSegVisualizationHook(
        str(samples), out_dir=str(tmp_path / 'viz'), grid_size=64,
        log_fn=lambda name, grid, step: logged.append((name, step)))
    grid = hook.before_val(Det(), 7)
    assert grid is not None and grid.ndim == 3
    assert (tmp_path / 'viz' / 'val_step7.jpg').exists()
    assert logged == [('val_samples', 7)]
