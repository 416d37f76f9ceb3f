"""The streamed clip at a frame size that I420 does not fit (H % 4 != 0,
W odd): the port renders BGR chunks, as the JAX package does, on the
CPU against the JAX package's stream from the same state.

A tiny detector-free pipeline pair (reduced LeReS trunk, full-width
Inpaint net, 66x93, 4 frames) as in tests/test_torch_pipeline.py.
"""
import ast
import sys

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
from cartoonsegmentation_torch.instances import Instances
from cartoonsegmentation_torch.models.convert import inpaint_from_flax
from cartoonsegmentation_torch.models.kenburns import Inpaint as TInpaint
from cartoonsegmentation_torch.pipeline import kenburns as tkb
from cartoonsegmentation_torch.pipeline.state import (KenBurnsState,
                                                      PointCloud)

from test_torch_config import FORBIDDEN, PORT, _imports
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W = 66, 93
CFG = dict(detector='none', dtype='float32', render_payload_dtype='float32',
           max_size=128, depth_est_size=64, autozoom_shift=10.0,
           num_frame=4)


def _image():
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 13) * np.cos(yy / 9),
                    128 + 90 * np.cos(xx / 7 + 1) * np.sin(yy / 5),
                    128 + 90 * np.sin((xx + yy) / 11)], -1)
    for _ in range(3):
        cx, cy, r = rng.uniform(15, W - 15), rng.uniform(15, H - 15), \
            rng.uniform(6, 14)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _port_state(sj):
    def t(a):
        return torch.from_numpy(np.array(a))
    return KenBurnsState(
        image=t(sj.image), disparity=t(sj.disparity), depth=t(sj.depth),
        raw_points=t(sj.raw_points), depth_min=t(sj.depth_min),
        depth_min_u=t(sj.depth_min_u), depth_min_v=t(sj.depth_min_v),
        cloud=PointCloud(*(t(getattr(sj.cloud, k)) for k in (
            'points', 'colors', 'disparity', 'depth', 'count'))),
        instances=Instances.empty(TConfig().max_instances, H, W))


@pytest.fixture(scope='module')
def streams(tmp_path_factory):
    """The JAX package's inpainted state streamed by both packages."""
    d = tmp_path_factory.mktemp('stream')
    jp = JPipeline(JConfig(**CFG), seed=0)
    jp.stage_previews = False
    net = JLeReS(encoder_layers=(1, 1, 1, 1))
    jp._leres_net = net
    jp._leres_vars = jax.jit(net.init)(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 64, 64, 3), jnp.float32))
    state = jp.generate_state(_image())
    boxes = jp.autozoom(state)
    state = jp.inpaint_extremes(state, *boxes)
    assert tuple(state.hw) == (H, W)
    steps = np.linspace(0.0, 1.0, CFG['num_frame'])
    frames_j = jp.render_frames_stream(state, *boxes, steps,
                                       str(d / 'jax.mp4'), chunk=3)

    tp = tkb.KenBurnsPipeline(TConfig(**CFG), device='cpu')
    tp.inpaint_net = TInpaint()
    tp.inpaint_net.load_state_dict(inpaint_from_flax(jax.tree_util.tree_map(
        np.asarray, jp._vars('inpaint')['params'])))
    st = _port_state(state)
    frames_t = tp.render_frames_stream(st, *boxes, steps,
                                       str(d / 'port.mp4'), chunk=3)
    return dict(tp=tp, st=st, boxes=boxes, steps=steps, dir=d,
                frames_j=np.asarray(frames_j), frames_t=frames_t)


def test_stream_matches_the_frames_and_jax(streams):
    """The BGR stream returns exactly the frames render_frames makes
    (no I420 round trip at this size), and agrees with the JAX
    package's BGR stream from the same state as the frames of
    tests/test_torch_pipeline.py's same-state test do (>= 99% within
    1 LSB, mean < 0.1)."""
    tp, st, boxes = streams['tp'], streams['st'], streams['boxes']
    ft, fj = streams['frames_t'], streams['frames_j']
    assert ft.shape == fj.shape == (CFG['num_frame'], H, W, 3)
    np.testing.assert_array_equal(
        ft, tp.render_frames(st, *boxes, streams['steps']))
    diff = np.abs(ft.astype(np.int32) - fj.astype(np.int32))
    assert (diff <= 1).mean() >= 0.99 and diff.mean() < 0.1, \
        ((diff <= 1).mean(), diff.mean())


def test_stream_writes_every_frame(streams):
    """The clip holds the forward frames and the palindrome tail."""
    cv2 = pytest.importorskip('cv2')
    n = CFG['num_frame']
    cap = cv2.VideoCapture(str(streams['dir'] / 'port.mp4'))
    count = 0
    while cap.read()[0]:
        count += 1
    assert count == n + (n - 2)
    assert streams['tp'].last_video_path.endswith('port.mp4')


def test_stream_takes_no_i420_at_this_size(streams, monkeypatch, tmp_path):
    """Neither the I420 decode nor the raw .yuv writer: without cv2 the
    sink refuses the size by name instead of writing a malformed
    stream."""
    def refuse(*a):
        raise AssertionError('the I420 path was taken')
    monkeypatch.setattr(tkb, 'i420_to_bgr_host', refuse)
    tp, st, boxes = streams['tp'], streams['st'], streams['boxes']
    tp.render_frames_stream(st, *boxes, streams['steps'][:2],
                            str(tmp_path / 'a.mp4'), chunk=3)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(RuntimeError, match=f'{H}x{W}'):
        tp.render_frames_stream(st, *boxes, streams['steps'][:2],
                                str(tmp_path / 'b.mp4'), chunk=3)
    assert not (tmp_path / 'b.yuv').exists()


def test_port_imports_no_jax_covers_the_style_flow():
    """tests/test_torch_config.py's AST scan walks every module of the
    port: the new serving/ subpackage and the style flow among them,
    none importing JAX or the JAX package."""
    files = set(PORT.rglob('*.py'))
    new = [PORT / 'serving' / '__init__.py', PORT / 'serving' / 'sd_webui.py',
           PORT / 'utils' / 'io.py', PORT / 'ops' / 'inpaint_fill.py',
           PORT / 'pipeline' / 'style.py', PORT / 'run_style.py',
           PORT / 'repaint_person.py']
    for f in new:
        assert f in files, f
        names = list(_imports(ast.parse(f.read_text(), str(f))))
        assert not [n for n in names if n.split('.')[0] in FORBIDDEN], f
