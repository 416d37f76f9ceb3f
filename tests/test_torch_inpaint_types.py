"""The port's host inpaint types (``inpaint_type`` 'patchmatch' and
'ldm'), the verbose stage images, ``--trace-dir`` and ``stream_video``
against the JAX package's, on the CPU.

One small clip state (48x64, two instances, a synthetic disparity) is
made by the JAX package and handed to the port; the Inpaint net is the
full-width one from a seed, carried over with ``inpaint_from_flax``.
The 'ldm' passes of both packages talk to one stub sd-webui server on
127.0.0.1 (tests/test_torch_style.py's), whose reply is a fixed function
of the requested size.

Exact: the hole masks (the rendered ``existing`` == 0, OR-ed with the
rendered instance masks), the PatchMatch output on the same bytes, the
ldm requests (images compared decoded, PNG being lossless), the stage
names. Where the two packages' own net forwards feed the host fill, the
uint8 image may differ by one level where the net's f32 noise crosses
a level (>= 99.9% of bytes equal; measured: 1 byte of 9,216 differs),
so the passes' own outputs are compared from one forward, handed to
both. JAX is imported only where the JAX side runs (``J``), so the
card-side test runs where JAX is missing.
"""
import base64
import copy
import functools
import io
import json
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models.convert import inpaint_from_flax
from cartoonsegmentation_torch.models.kenburns import Inpaint as TInpaint
from cartoonsegmentation_torch.ops import patchmatch_native as tpm
from cartoonsegmentation_torch.pipeline import kenburns as tkb
from cartoonsegmentation_torch.pipeline.state import (KenBurnsState,
                                                      PointCloud)
from cartoonsegmentation_torch.serving import sd_webui as tsd
from cartoonsegmentation_torch.utils.image import (bgr_to_i420,
                                                   i420_to_bgr_host)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W = 48, 64
CFG = dict(detector='none', dtype='float32', render_payload_dtype='float32',
           max_size=64)
# one camera extreme: (shift_u, shift_v, depth_scale)
CAM = (9.0, -5.0, 0.8)
BOXES = ({'center_u': W / 2, 'center_v': H / 2, 'crop_w': 51, 'crop_h': 38},
         {'center_u': W / 2 + 8, 'center_v': H / 2 - 4, 'crop_w': 40,
          'crop_h': 30})


@functools.lru_cache(maxsize=None)
def J():
    """The JAX package's pieces this file uses."""
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.config import KenBurnsConfig
    from cartoonsegmentation_tpu.instances import Instances
    from cartoonsegmentation_tpu.ops import patchmatch_native
    from cartoonsegmentation_tpu.pipeline import kenburns
    from cartoonsegmentation_tpu.serving import sd_webui
    return types.SimpleNamespace(jax=jax, jnp=jnp, Config=KenBurnsConfig,
                                 Ins=Instances, pm=patchmatch_native,
                                 kb=kenburns, sd=sd_webui)


class _StubSD(BaseHTTPRequestHandler):
    """sd-webui's img2img route: the reply is one image of the requested
    size, a fixed function of that size, cv2-encoded; every request body
    is kept in ``calls``."""
    calls = []

    def do_POST(self):
        import cv2
        n = int(self.headers['Content-Length'])
        payload = json.loads(self.rfile.read(n))
        _StubSD.calls.append(payload)
        w, h = payload.get('width', 64), payload.get('height', 64)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 7 + 40) % 256, (yy * 5) % 256,
                        np.full((h, w), 110)], -1).astype(np.uint8)
        ok, buf = cv2.imencode('.png', img)
        body = json.dumps({'images': [
            base64.b64encode(buf.tobytes()).decode()]}).encode()
        self.send_response(200)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _decoded(payload):
    """The request body with each image replaced by its decoded pixels
    (shape, dtype, bytes)."""
    from PIL import Image

    def px(b64):
        a = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
        return (a.shape, str(a.dtype), a.tobytes())
    p = copy.deepcopy(payload)
    p['init_images'] = [px(b) for b in p['init_images']]
    p['mask'] = px(p['mask'])
    return p


def _image():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([128 + 100 * np.sin(xx / 6 + c) * np.cos(yy / 5 - c)
                     for c in range(3)], -1).astype(np.uint8)


def _disparity():
    """Two planes and a raised disc: depth edges that open holes."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.where(xx < W / 2, 2.0, 6.0) + 0.02 * yy
    d[(xx - 40) ** 2 + (yy - 20) ** 2 < 100] = 14.0
    return d[..., None].astype(np.float32)


def _masks():
    m = np.zeros((2, H, W), bool)
    m[0, 8:30, 30:52] = True
    m[1, 30:46, 4:24] = True
    return m, np.zeros((2, 4), np.float32)


@pytest.fixture(scope='module')
def server():
    srv = HTTPServer(('127.0.0.1', 0), _StubSD)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img'
    srv.shutdown()


@pytest.fixture
def calls():
    _StubSD.calls.clear()
    return _StubSD.calls


def _port_state(sj, masks, boxes) -> KenBurnsState:
    def t(a):
        return torch.from_numpy(np.array(a))
    return KenBurnsState(
        image=t(sj.image), disparity=t(sj.disparity), depth=t(sj.depth),
        raw_points=t(sj.raw_points), depth_min=t(sj.depth_min),
        depth_min_u=t(sj.depth_min_u), depth_min_v=t(sj.depth_min_v),
        cloud=PointCloud(*(t(getattr(sj.cloud, k)) for k in (
            'points', 'colors', 'disparity', 'depth', 'count'))),
        instances=TIns.from_numpy(masks, boxes, capacity=4))


@pytest.fixture(scope='module')
def clip():
    """The JAX state, its Inpaint weights, and one JAX forward at CAM
    (the out dict as numpy, and the shift)."""
    jp = J().kb.KenBurnsPipeline(J().Config(**CFG), seed=0)
    jp.stage_previews = False
    masks, boxes = _masks()
    sj = jp._prepare_state(J().jnp.asarray(_image() / np.float32(255)),
                           J().jnp.asarray(_disparity()),
                           J().Ins.from_numpy(masks, boxes, capacity=4))
    params = J().jax.tree_util.tree_map(np.asarray,
                                        jp._vars('inpaint')['params'])
    out, shift = jp._inpaint_forward(sj, *CAM)
    out = {k: np.asarray(v) for k, v in out.items()}
    return dict(jvars=jp._vars('inpaint'), params=params, sj=sj,
                masks=masks, boxes=boxes, out=out, shift=np.asarray(shift))


def _pipes(clip, **kw):
    jp = J().kb.KenBurnsPipeline(J().Config(**CFG, **kw), seed=0)
    jp.stage_previews = False
    jp._inpaint_vars = clip['jvars']
    tp = tkb.KenBurnsPipeline(TConfig(**CFG, **kw), device='cpu')
    tp.inpaint_net = TInpaint()
    tp.inpaint_net.load_state_dict(inpaint_from_flax(clip['params']))
    return jp, tp


def _fixed_forward(jp, tp, clip):
    """Both pipelines' forwards return the one JAX forward."""
    out, shift = clip['out'], clip['shift']
    jp._inpaint_forward = lambda *a: ({k: J().jnp.asarray(v)
                                       for k, v in out.items()},
                                      J().jnp.asarray(shift))
    tp._inpaint_forward = lambda *a: ({k: torch.tensor(v)
                                       for k, v in out.items()},
                                      torch.tensor(shift))


def _recorder(monkeypatch, module, log):
    real = module.inpaint

    def rec(img, mask, **k):
        res = real(img, mask, **k)
        log.append((np.array(img), np.array(mask), res))
        return res
    monkeypatch.setattr(module, 'inpaint', rec)


def _cloud(c):
    n = int(c.count)
    return {k: np.asarray(getattr(c, k))[:n] for k in (
        'points', 'colors', 'disparity', 'depth')}


def _assert_same_cloud(ct, cj):
    a, b = _cloud(ct), _cloud(cj)
    assert len(a['points']) == len(b['points'])
    np.testing.assert_array_equal(a['colors'], b['colors'])
    for k in ('points', 'disparity', 'depth'):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-5)


def test_patchmatch_hole_masks_from_each_forward(clip, monkeypatch):
    """Each package's own forward: the hole masks handed to PatchMatch
    are equal, holes from ``existing`` and from the rendered instances
    both present; the uint8 images >= 99.9% equal; the port's PatchMatch
    on JAX's bytes equals JAX's output; the clouds grow by the same
    count."""
    jp, tp = _pipes(clip, inpaint_type='patchmatch')
    logs = {'j': [], 't': []}
    _recorder(monkeypatch, J().pm, logs['j'])
    _recorder(monkeypatch, tpm, logs['t'])
    sj = jp.inpaint_pass(clip['sj'], *CAM)
    st = tp.inpaint_pass(_port_state(clip['sj'], clip['masks'],
                                     clip['boxes']), *CAM)
    (ij, mj, oj), (it, mt, ot) = logs['j'][0], logs['t'][0]
    np.testing.assert_array_equal(mt, mj)
    existing = clip['out']['existing'][..., 0] == 0
    assert 0 < existing.mean() < (mj > 0).mean() < 0.9
    assert float((it == ij).mean()) >= 0.999
    np.testing.assert_array_equal(tpm.inpaint(ij, mj, patch_size=3), oj)
    assert int(st.cloud.count) == int(sj.cloud.count) > H * W


def test_patchmatch_pass_vs_jax(clip):
    """One forward handed to both: the filled image, and so the appended
    cloud, equal to JAX's."""
    jp, tp = _pipes(clip, inpaint_type='patchmatch')
    _fixed_forward(jp, tp, clip)
    sj = jp.inpaint_pass(clip['sj'], *CAM)
    st = tp.inpaint_pass(_port_state(clip['sj'], clip['masks'],
                                     clip['boxes']), *CAM)
    _assert_same_cloud(st.cloud, sj.cloud)
    assert tp.timer.counts['inpaint_patchmatch_host'] == 1


def test_ldm_pass_vs_jax(clip, server, calls):
    """inpaint_type 'ldm' against the stub: one img2img request a pass,
    its size by the /32 rule (64x64 for 48x64 at resolution 64), the
    mask the 5-px ellipse dilation of the hole mask, every field equal to
    JAX's; the reply (64x64) resized back with LANCZOS and appended as
    JAX's."""
    jp, tp = _pipes(clip, inpaint_type='ldm', sd_img2img_url=server,
                    ldm_inpaint_size=64)
    _fixed_forward(jp, tp, clip)
    sj = jp.inpaint_pass(clip['sj'], *CAM)
    st = tp.inpaint_pass(_port_state(clip['sj'], clip['masks'],
                                     clip['boxes']), *CAM)
    assert len(calls) == 2
    a, b = _decoded(calls[0]), _decoded(calls[1])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k
    assert (calls[1]['width'], calls[1]['height']) == (64, 64)
    assert calls[1]['prompt'] == 'high quality, masterpiece, no_humans'
    hole = clip['out']['existing'][..., 0] == 0
    mask = np.frombuffer(b['mask'][2], np.uint8).reshape(b['mask'][0])
    assert mask.shape == (H, W) and mask.dtype == np.uint8
    assert (mask[hole] == 255).all() and (mask > 0).sum() > hole.sum()
    _assert_same_cloud(st.cloud, sj.cloud)


def test_ldm_webui_rule_and_unreachable(server, calls):
    """The /32 rule both ways, the auth keys taken out of the request,
    and a server nothing listens on: RuntimeError after the retries."""
    jsd = J().sd
    img = np.zeros((50, 130, 3), np.uint8)
    mask = np.zeros((50, 130), np.uint8)
    for sd in (jsd, tsd):
        out = sd.ldm_inpaint_webui(img, mask, 64, server, 'p', 'n',
                                   steps=3, username='', password='x')
        assert out.shape == img.shape
        out = sd.ldm_inpaint_webui(img.transpose(1, 0, 2),
                                   mask.T, 64, server)
        assert out.shape == (130, 50, 3)
    assert [(c['width'], c['height']) for c in calls] == \
        [(160, 64), (64, 160)] * 2
    assert 'username' not in calls[0] and 'password' not in calls[0]
    srv = HTTPServer(('127.0.0.1', 0), _StubSD)
    dead = f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img'
    srv.server_close()
    with pytest.raises(RuntimeError, match='unreachable'):
        tsd.ldm_inpaint_webui(img, mask, 64, dead, retries=2, wait_time=0.0)


class _Det:
    def __init__(self, ins):
        self.ins = ins

    def infer(self, img, *a, **k):
        return self.ins


def test_verbose_stage_names_vs_jax(clip):
    """stage_previews on, a detector, the two inpaint passes: the port's
    ``stages`` keys equal JAX's (input, depth_coarse, depth_adjusted,
    depth_final, instances, inpainted_<count> a pass), the depth and
    inpainted images within 1 level of JAX's; off, only 'input'."""
    jp, tp = _pipes(clip)
    masks, boxes = clip['masks'], clip['boxes']
    jp._detector = _Det(J().Ins.from_numpy(masks, boxes, capacity=4))
    tp._detector = _Det(TIns.from_numpy(masks, boxes, capacity=4))
    jp._estimate_disparity = lambda image: J().jnp.asarray(_disparity())
    tp._estimate_disparity = lambda image: torch.from_numpy(_disparity())
    img = _image()
    jp.stage_previews = tp.stage_previews = True
    for p in (jp, tp):
        p.inpaint_extremes(p.generate_state(img), *BOXES)
    assert list(tp.stages) == list(jp.stages)
    assert sum(k.startswith('inpainted_') for k in tp.stages) == 2
    for k, v in tp.stages.items():
        w = np.asarray(jp.stages[k])
        assert v.shape == w.shape and v.dtype == w.dtype == np.uint8, k
        if k != 'instances':
            diff = np.abs(v.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, k
    tp.stage_previews = False
    tp.generate_state(img)
    assert list(tp.stages) == ['input']


def test_cli_verbose_and_trace_dir(tmp_path, capsys):
    """run_kenburns --verbose --trace-dir on the CPU (--no-detector, the
    shipped YAML at 4 frames and LeReS at 64, full-width nets, a 48x64
    image): the stage images of JAX's --verbose (no 'instances' without
    a detector), and a trace file with events, reported as CPU only."""
    cv2 = pytest.importorskip('cv2')
    pytest.importorskip('yaml')
    from pathlib import Path
    from cartoonsegmentation_torch import run_kenburns
    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), _image())
    shipped = Path(__file__).resolve().parent.parent / 'configs' / \
        '3dkenburns.yaml'
    cfg = tmp_path / 'kb.yaml'
    cfg.write_text(shipped.read_text().replace('num_frame: 75',
                                               'num_frame: 4')
                   .replace('depth_est_size: 640', 'depth_est_size: 64'))
    out = tmp_path / 'out'
    run_kenburns.main(['--cfg', str(cfg), '--input-img', str(src),
                       '--save-dir', str(out), '--no-detector',
                       '--device', 'cpu', '--verbose', '--trace-dir',
                       str(tmp_path / 'trace')])
    printed = capsys.readouterr().out
    assert 'CPU only' in printed and '4 frames' in printed
    names = sorted(p.name for p in out.glob('tmp_stage_*_pic.png'))
    stages = [n[len('tmp_stage_'):-len('_pic.png')] for n in names]
    assert [s for s in stages if not s.startswith('inpainted_')] == \
        ['depth_adjusted', 'depth_coarse', 'depth_final', 'input']
    assert sum(s.startswith('inpainted_') for s in stages) == 2
    assert cv2.imread(str(out / 'tmp_stage_depth_final_pic.png')).shape \
        == (H, W, 3)
    events = json.loads((tmp_path / 'trace' / 'trace.json').read_text())
    assert len(events['traceEvents']) > 100


def test_trace_empty_device_trace_raises(tmp_path):
    """A trace asked of a CUDA device that comes back with no kernel
    event (here: CPU work only) raises after the file is written."""
    from cartoonsegmentation_torch.utils import profiling
    with pytest.raises(RuntimeError, match='no CUDA kernel event'):
        with profiling.trace(str(tmp_path), device='cuda') as s:
            torch.ones(4) + 1
    assert s.cuda and s.kernel_events == 0 and s.other_events > 0
    assert (tmp_path / 'trace.json').exists()


def _video_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


@pytest.mark.parametrize('yuv420', [False, True], ids=['bgr', 'i420'])
def test_stream_video_vs_write_video(yuv420, tmp_path):
    """stream_video of a (T, H, W, 3) tensor: with BGR chunks its frames
    are write_video's input and the two clips decode to the same frames;
    through I420 its frames are the I420 round trip of the input, as the
    JAX package's stream_video returns them; the palindrome tail in
    both."""
    pytest.importorskip('cv2')
    rng = np.random.RandomState(0)
    frames = (rng.rand(5, H, W, 3) * 255).astype(np.uint8)
    got = tkb.stream_video(torch.from_numpy(frames), str(tmp_path / 'a.mp4'),
                           chunk=2, yuv420=yuv420)
    path = tkb.write_video(got, str(tmp_path / 'b.mp4'))
    a = _video_frames(str(tmp_path / 'a.mp4'))
    assert len(a) == 5 + 3
    np.testing.assert_array_equal(a, _video_frames(path))
    if yuv420:
        want = i420_to_bgr_host(bgr_to_i420(torch.from_numpy(frames)).numpy())
        np.testing.assert_array_equal(got, want)
        jgot = J().kb.stream_video(J().jnp.asarray(frames),
                                   str(tmp_path / 'j.mp4'), chunk=2)
        np.testing.assert_array_equal(got, jgot)
    else:
        np.testing.assert_array_equal(got, frames)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
def test_stream_video_card_and_trace(tmp_path, cuda):
    """stream_video of frames on the card equals the CPU's, both ways;
    a trace of work on the card holds CUDA kernel events."""
    from cartoonsegmentation_torch.utils.profiling import trace
    frames = (torch.rand(9, 576, 1024, 3) * 255).to(torch.uint8)
    for yuv420 in (False, True):
        a = tkb.stream_video(frames.cuda(), str(tmp_path / 'a.mp4'),
                             yuv420=yuv420)
        b = tkb.stream_video(frames, str(tmp_path / 'b.mp4'), yuv420=yuv420)
        np.testing.assert_array_equal(a, b)
    with trace(str(tmp_path / 't'), device='cuda') as s:
        torch.ones(1 << 20, device='cuda').cumsum(0)
    assert s.kernel_events > 0


def test_no_cv2_raw_stream(tmp_path, monkeypatch):
    """Without cv2 stream_video writes the raw I420 stream: the JAX
    bgr_to_i420 bytes of its frames, the palindrome tail included."""
    from cartoonsegmentation_tpu.utils.image import bgr_to_i420 as jpack
    monkeypatch.setitem(sys.modules, 'cv2', None)
    frames = (np.random.RandomState(1).rand(4, H, W, 3) * 255).astype(
        np.uint8)
    got = tkb.stream_video(torch.from_numpy(frames), str(tmp_path / 'c.mp4'),
                           chunk=3, yuv420=False)
    raw = np.fromfile(tmp_path / 'c.yuv', np.uint8)
    want = np.asarray(jpack(J().jnp.asarray(got)))
    want = np.concatenate([want, want[::-1][1:-1]])
    np.testing.assert_array_equal(raw.reshape(want.shape), want)


@pytest.mark.parametrize('kw', [
    {'detector': 'animeinsseg', 'refine_method': 'animeseg'},
    {'detector': 'sam', 'inpaint_type': 'ldm'},
    {'detector': 'none', 'default_depth_refine': True,
     'depth_est': 'default'},
    {'detector': 'none', 'inpaint_type': 'patchmatch'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_formerly_refused_options_install(kw):
    """The options the port refused before (tests/test_torch_config.py
    keeps the ones it still refuses) build a pipeline, and its detector
    with the configured refine; configs/3dkenburns_sam.yaml as shipped
    among them."""
    from cartoonsegmentation_torch.pipeline.refine import AnimeSegRefiner
    cfg = TConfig(**kw)
    if kw.get('detector') == 'sam':
        pytest.importorskip('yaml')
        from pathlib import Path
        from cartoonsegmentation_torch.config import build_kenburns_cfg
        cfg = build_kenburns_cfg(str(Path(__file__).resolve().parent.parent
                                     / 'configs' / '3dkenburns_sam.yaml'))
        assert (cfg.detector, cfg.inpaint_type) == ('sam', 'ldm')
    pipe = tkb.KenBurnsPipeline(cfg, device='cpu')
    pipe.ensure_detector()
    if cfg.refine_method == 'animeseg' and cfg.detector == 'animeinsseg':
        assert isinstance(pipe._detector.refine, AnimeSegRefiner)
        assert pipe._detector.refine.input_size == 1024
