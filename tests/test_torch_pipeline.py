"""The port's Ken Burns path as a whole against the JAX package's, on
the CPU in f32, detector-free (the detector-on path, the shipped
default's AnimeInsSeg and ISNet refine at a reduced size, is
tests/test_torch_pipeline_detector.py).

One numpy image, one set of Flax weights (a reduced LeReS trunk with
perturbed BatchNorm statistics, the full-width Inpaint net from a
seed) carried into the port with ``leres_from_flax`` /
``inpaint_from_flax``. Both pipelines run ``detector='none'`` with
``dtype='float32'`` and ``render_payload_dtype='float32'`` at a small
size. Compared: disparity and depth, the autozoom boxes, the frames.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.config import KenBurnsConfig as JConfig
from cartoonsegmentation_tpu.models.leres import LeReS as JLeReS
from cartoonsegmentation_tpu.pipeline.kenburns import \
    KenBurnsPipeline as JPipeline
from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.models.convert import (inpaint_from_flax,
                                                      leres_from_flax)
from cartoonsegmentation_torch.models.kenburns import Inpaint as TInpaint
from cartoonsegmentation_torch.models.leres import LeReS as TLeReS
from cartoonsegmentation_torch.ops.camera import _linspace_f32
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from cartoonsegmentation_torch.utils.image import (bgr_to_i420,
                                                   i420_to_bgr_host)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W = 96, 128
LAYERS = (1, 1, 1, 1)
SHIFT = 10.0
CFG = dict(detector='none', dtype='float32', render_payload_dtype='float32',
           max_size=128, depth_est_size=64, autozoom_shift=SHIFT,
           num_frame=4)


def _image(seed=0):
    """Smooth gradients and a few flat shapes, BGR uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 17) * np.cos(yy / 11),
                    128 + 90 * np.cos(xx / 9 + 1) * np.sin(yy / 7),
                    128 + 90 * np.sin((xx + yy) / 13)], -1)
    for _ in range(4):
        cx, cy, r = rng.uniform(20, W - 20), rng.uniform(20, H - 20), \
            rng.uniform(8, 20)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _leres_variables():
    net = JLeReS(encoder_layers=LAYERS)
    v = jax.jit(net.init)(jax.random.PRNGKey(1),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(2)

    def perturb(path, a):
        return (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == 'var'
                else rng.randn(*a.shape) * 0.1).astype(np.float32)
    return net, {'params': jax.tree_util.tree_map(np.asarray, v['params']),
                 'batch_stats': jax.tree_util.tree_map_with_path(
                     perturb, v['batch_stats'])}


@pytest.fixture(scope='module')
def both():
    img = _image()
    jp = JPipeline(JConfig(**CFG), seed=0)
    jp.stage_previews = False
    jp._leres_net, jp._leres_vars = _leres_variables()
    inpaint_params = jax.tree_util.tree_map(np.asarray,
                                            jp._vars('inpaint')['params'])

    tp = TPipeline(TConfig(**CFG), device='cpu')
    tp.leres_net = TLeReS(LAYERS)
    tp.leres_net.load_state_dict(leres_from_flax(jp._leres_vars,
                                                 tp.leres_net))
    tp.inpaint_net = TInpaint()
    tp.inpaint_net.load_state_dict(inpaint_from_flax(inpaint_params))

    state_j = jp.generate_state(img)
    boxes_j = jp.autozoom(state_j)
    frames_j = jp.process_kenburns(state_j, *boxes_j)
    frames_t = tp.run(img)
    return dict(img=img, jp=jp, tp=tp, state_j=state_j, boxes_j=boxes_j,
                frames_j=frames_j, frames_t=frames_t)


def _np(a):
    return np.asarray(jax.device_get(a))


def test_disparity_and_depth(both):
    st_t, st_j = both['tp'].last_state, both['state_j']
    disp_t = st_t.disparity[..., 0].numpy()
    disp_j = _np(st_j.disparity[..., 0])
    # LeReS convs in another order leave f32 noise (measured: 5.7e-6 at
    # most); the 16-bit / 8-bit requantisation of leres_postprocess can
    # turn it into one level (40/255 after scaling to the baseline) at
    # a few pixels, which the resize back to the image spreads
    assert np.abs(disp_t - disp_j).max() <= 40.0 / 255 + 1e-4
    assert (np.abs(disp_t - disp_j) <= 1e-4).mean() >= 0.99
    # depth = f·b/(disp + 1e-5): compare the reciprocal, as the
    # composed-pipeline test does
    np.testing.assert_allclose(1.0 / st_t.depth.numpy(),
                               1.0 / _np(st_j.depth), rtol=5e-3, atol=1e-5)
    # the minMaxLoc anchor that the camera path hangs on
    dr_t, dr_j = st_t.depth_range, st_j.depth_range
    assert (float(dr_t.min_u), float(dr_t.min_v)) == \
        (float(dr_j.min_u), float(dr_j.min_v))


def test_autozoom_boxes(both):
    """The same candidate cell and crop sizes, exactly. The JAX grid
    value may sit an ulp of the shift range off the port's (XLA's CPU
    code reassociates and contracts the jnp.linspace arithmetic), so
    the centres are compared to that ulp."""
    (from_t, to_t), (from_j, to_j) = both['tp'].last_boxes, both['boxes_j']
    assert from_t == from_j
    assert (to_t['crop_w'], to_t['crop_h']) == (to_j['crop_w'],
                                                 to_j['crop_h'])
    lin = _linspace_f32(-SHIFT, SHIFT, 16)
    for k, c in (('center_u', W / 2.0), ('center_v', H / 2.0)):
        cell_t = int(np.abs(lin - (to_t[k] - c)).argmin())
        cell_j = int(np.abs(lin - (to_j[k] - c)).argmin())
        assert cell_t == cell_j
        assert abs(to_t[k] - to_j[k]) <= np.spacing(np.float32(SHIFT))


def _agreement(a, b, lsb=1):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff <= lsb).mean()), float(diff.mean())


def test_frames(both):
    """Tighter than tests/test_composed_pipeline.py's budget for the
    same chain with DoF (≥ 90% within 6 LSB, mean < 3.5). Measured:
    99.0% within 1 LSB, mean 0.09. What differs is f32 noise of the
    convs: a hallucinated point that the t = 0 view projects onto a
    pixel boundary lends a tiny weight to one neighbour or the other,
    which decides whether that neighbour is a hole."""
    ft, fj = both['frames_t'], both['frames_j']
    assert ft.shape == fj.shape == (CFG['num_frame'], H, W, 3)
    assert ft.dtype == np.uint8
    close1, mean = _agreement(ft, fj)
    close6, _ = _agreement(ft, fj, lsb=6)
    assert close1 >= 0.98 and close6 >= 0.99 and mean < 0.5, \
        (close1, close6, mean)


def _port_state(sj):
    """The JAX package's KenBurnsState as the port's, on the CPU."""
    from cartoonsegmentation_torch.instances import Instances
    from cartoonsegmentation_torch.pipeline.state import (KenBurnsState,
                                                          PointCloud)

    def t(a):
        return torch.from_numpy(np.array(a))
    return KenBurnsState(
        image=t(sj.image), disparity=t(sj.disparity), depth=t(sj.depth),
        raw_points=t(sj.raw_points), depth_min=t(sj.depth_min),
        depth_min_u=t(sj.depth_min_u), depth_min_v=t(sj.depth_min_v),
        cloud=PointCloud(*(t(getattr(sj.cloud, k)) for k in (
            'points', 'colors', 'disparity', 'depth', 'count'))),
        instances=Instances.empty(TConfig().max_instances, H, W))


def test_inpaint_and_render_from_the_same_state(both):
    """The JAX package's state handed to the port: the inpaint passes
    append the same number of points at the same places (to f32 conv
    noise), and the frames agree but for the boundary case above.
    Measured: 99.7% within 1 LSB, mean 0.02."""
    tp, jp, sj = both['tp'], both['jp'], both['state_j']
    boxes = both['boxes_j']
    st = tp.inpaint_extremes(_port_state(sj), *boxes)
    sj = jp.inpaint_extremes(sj, *boxes)
    n = int(st.cloud.count)
    assert n == int(sj.cloud.count)
    np.testing.assert_allclose(st.cloud.points.numpy()[:n],
                               _np(sj.cloud.points)[:n], rtol=1e-5,
                               atol=1e-4)
    steps = [0.0, 0.5, 1.0]
    close1, mean = _agreement(tp.render_frames(st, *boxes, steps),
                              jp.render_frames(sj, *boxes,
                                               np.asarray(steps)))
    assert close1 >= 0.99 and mean < 0.1, (close1, mean)


def test_process_kenburns_twice_on_one_state(both):
    """The inpaint passes leave the caller's state as it was, as the
    JAX package's immutable state does: a second process_kenburns on
    the same state renders the same frames, and both agree with the
    JAX package's frames from that state. Measured: 99.8% within
    1 LSB, mean 0.015."""
    tp, sj = both['tp'], both['state_j']
    boxes = both['boxes_j']
    st = _port_state(sj)
    before = st.cloud.clone()
    first = tp.process_kenburns(st, *boxes)
    for k in ('points', 'colors', 'disparity', 'depth', 'count'):
        assert torch.equal(getattr(st.cloud, k), getattr(before, k)), k
    second = tp.process_kenburns(st, *boxes)
    np.testing.assert_array_equal(first, second)
    close1, mean = _agreement(second, both['frames_j'])
    assert close1 >= 0.99 and mean < 0.1, (close1, mean)


def test_streamed_video_matches_the_frames(both, tmp_path):
    """run() with a video path: the same frames through the I420
    stream, and a clip on disk."""
    tp = both['tp']
    state, (obj_from, obj_to) = tp.last_state, tp.last_boxes
    steps = np.linspace(0.0, 1.0, CFG['num_frame'])
    got = tp.render_frames_stream(state, obj_from, obj_to, steps,
                                  str(tmp_path / 'clip.mp4'), chunk=3)
    want = i420_to_bgr_host(bgr_to_i420(
        torch.from_numpy(both['frames_t'])).numpy())
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / 'clip.mp4').exists() or \
        (tmp_path / 'clip.yuv').exists()


def test_streamed_i420_bytes_vs_jax_packer(both, tmp_path, monkeypatch):
    """The stream writes each frame's I420 from the K5a epilogue into
    the chunk's buffer: without cv2 the raw .yuv file holds exactly the
    JAX ``bgr_to_i420`` bytes of the port's frames, the palindrome
    tail included."""
    import sys
    from cartoonsegmentation_tpu.utils.image import bgr_to_i420 as jpack
    monkeypatch.setitem(sys.modules, 'cv2', None)
    tp = both['tp']
    state, (obj_from, obj_to) = tp.last_state, tp.last_boxes
    steps = np.linspace(0.0, 1.0, CFG['num_frame'])
    tp.render_frames_stream(state, obj_from, obj_to, steps,
                            str(tmp_path / 'clip.mp4'), chunk=3)
    raw = np.fromfile(tmp_path / 'clip.yuv', np.uint8)
    want = np.asarray(jpack(jnp.asarray(both['frames_t'])))
    want = np.concatenate([want, want[::-1][1:-1]])
    np.testing.assert_array_equal(raw.reshape(want.shape), want)


def test_cli_writes_the_clip(tmp_path, capsys):
    """python -m cartoonsegmentation_torch.run_kenburns on the CPU: the
    shipped YAML with --no-detector, full-width nets, a small image."""
    cv2 = pytest.importorskip('cv2')
    pytest.importorskip('yaml')
    from cartoonsegmentation_torch import run_kenburns
    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), _image()[:64, :96])
    cfg = Path(__file__).resolve().parent.parent / 'configs' / \
        '3dkenburns.yaml'
    run_kenburns.main(['--cfg', str(cfg), '--input-img', str(src),
                       '--save-dir',
                       str(tmp_path / 'out'), '--no-detector',
                       '--device', 'cpu'])
    assert '75 frames' in capsys.readouterr().out
    assert (tmp_path / 'out' / 'pic.mp4').stat().st_size > 0
