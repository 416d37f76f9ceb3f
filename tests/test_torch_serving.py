"""The port's interactive Ken Burns server, its browser UI and its two
CLIs (``naive_interface``, ``run_kenburns_batch``) on the CPU.

- ``KenBurnsService`` against the JAX package's on one image, with
  tests/test_serving.py's cfg (max_size 48, 3 frames, ``depth_est:
  default``, no DoF, no playback) and the same weights in both (the
  disparity net made in the port and carried to Flax as
  tests/test_torch_depth_default.py does; the JAX Inpaint net's drawn
  variables carried back through ``inpaint_from_flax``):
  ``load_image``'s meta and camera boxes equal; the ``live_frame``
  frames at t = 0, 0.5, 1 and the ``result_video`` clip within
  tests/test_torch_pipeline.py's tolerance over the frames together
  (>= 98% of values within 1 LSB, >= 99% within 6, mean < 0.5), taken
  before the lossy codecs (the JPEG encoder and the video writer
  patched to lossless ones in both packages; the codecs themselves are
  the HTTP tests'). The clip is rendered from one cloud in both: the
  port's state is made again from the JAX state's disparity. The
  disparity nets' f32 difference (7e-5 of 40) moves hole edges, which
  at 40x48 are a large share of the frame, and the inpainting passes
  grow them: with each package's own disparity the clip measured 96.5%
  of values within 1 LSB (mean 0.53), with the same disparity 99.8%.
- Every route over HTTP on the port alone, with urllib: the Ken Burns
  routes, /segment, the style routes against a stub sd-webui server on
  127.0.0.1, the ``/config`` switches (a ``marigold_*`` key rebuilds
  the Marigold model with the old nets; a detector-family switch keeps
  the box detector's weights), the MJPEG stream, 404 and 500 answers.
- The page's inline JS (balanced brackets, every id and handler
  defined, every fetched route answered by the handler).
- Both CLIs with ``--device cpu``.

JAX is imported inside the CPU fixtures and tests only, so that the
``gpu`` test runs on a machine without it.
"""
import base64
import io
import json
import os
import re
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.instances import Instances as TInstances
from cartoonsegmentation_torch.models.kenburns import (DisparityEstimator,
                                                       Refine)
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from cartoonsegmentation_torch.serving import interface as tsrv
from cartoonsegmentation_torch.serving.webui import PAGE_HTML
from test_torch_refiners import randomize_nets
from torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(max_size=48, num_frame=3, depth_field=False,
           point_capacity_factor=1.2, depth_est='default', playback=False)
IMG_H, IMG_W = 40, 48


def _image(seed=0, h=IMG_H, w=IMG_W):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c)
                    for c in range(3)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _png(img):
    ok, enc = cv2.imencode('.png', img)
    return enc.tobytes()


def _agreement(a, b, lsb=1):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff <= lsb).mean()), float(diff.mean())


def _close(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    close1, mean = _agreement(a, b)
    close6, _ = _agreement(a, b, lsb=6)
    assert close1 >= 0.98 and close6 >= 0.99 and mean < 0.5, \
        (close1, close6, mean)


def _mp4_frames(data: bytes, tmp_path) -> np.ndarray:
    p = tmp_path / f'clip_{len(data)}.mp4'
    p.write_bytes(data)
    cap = cv2.VideoCapture(str(p))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope='module')
def est():
    """The disparity net: a random DisparityEstimator made in the
    port."""
    return randomize_nets(DisparityEstimator(), 3)


def _port_pipeline(est, inpaint_sd=None, **kw):
    tp = TPipeline(TConfig(**dict(CFG, detector='none', **kw)), seed=0,
                   device='cpu')
    tp.disparity_net = est
    if inpaint_sd is not None:
        from cartoonsegmentation_torch.models.kenburns import Inpaint
        tp.inpaint_net = Inpaint()
        tp.inpaint_net.load_state_dict(inpaint_sd)
    return tp


def test_service_vs_jax(est, tmp_path, monkeypatch):
    import jax
    import cartoonsegmentation_torch.pipeline as tpipe
    import cartoonsegmentation_tpu.pipeline as jpipe
    from cartoonsegmentation_tpu.config import KenBurnsConfig as JConfig
    from cartoonsegmentation_tpu.pipeline.kenburns import \
        KenBurnsPipeline as JPipeline
    from cartoonsegmentation_tpu.serving.interface import \
        KenBurnsService as JService
    from cartoonsegmentation_torch.models.convert import inpaint_from_flax
    from test_torch_depth_default import flax_variables
    dvars, _ = flax_variables(est, Refine())
    jp = JPipeline(JConfig(**dict(CFG, detector='none')), seed=0)
    jp.stage_previews = False
    jp._disparity_vars = dvars
    inpaint = inpaint_from_flax(jax.tree_util.tree_map(
        np.asarray, jp._vars('inpaint')['params']))
    tp = _port_pipeline(est, inpaint)
    jsvc, tsvc = JService(jp), tsrv.KenBurnsService(tp)
    data = _png(_image())
    want, got = jsvc.load_image(data), tsvc.load_image(data)
    assert got == json.loads(json.dumps(want))
    assert got['height'] == IMG_H and got['width'] == IMG_W
    assert got['stages'] == ['input']

    png = cv2.imencode
    monkeypatch.setattr(cv2, 'imencode',
                        lambda ext, img, params=None: png('.png', img))

    def raw_video(frames, path, fps=25, playback=True):
        np.save(open(path, 'wb'), np.asarray(frames))
        return path
    for pkg in (tpipe, jpipe):
        monkeypatch.setattr(pkg, 'write_video', raw_video)

    def live(svc):
        return np.stack([cv2.imdecode(np.frombuffer(
            svc.live_frame(t), np.uint8), cv2.IMREAD_COLOR)
            for t in (0.0, 0.5, 1.0)])
    a, b = live(tsvc), live(jsvc)
    assert a.shape == (3, IMG_H, IMG_W, 3)
    _close(a, b)
    assert tsvc.live_frame(0.5) is tsvc.frame_cache[0.5]     # cached
    st = tsvc.state
    tsvc.state = tsvc.pristine_state = tp._prepare_state(
        st.image, torch.from_numpy(np.array(jsvc.state.disparity)),
        st.instances)
    a = np.load(io.BytesIO(tsvc.result_video()))
    b = np.load(io.BytesIO(jsvc.result_video()))
    assert a.shape == (CFG['num_frame'], IMG_H, IMG_W, 3)
    _close(a, b)


class _BoxDetector:
    """A stand-in detector: two boxes of the given image as instances."""
    device = torch.device('cpu')

    def infer(self, img, *a, **k):
        h, w = img.shape[:2]
        m = np.zeros((2, h, w), bool)
        m[0, h // 8:h // 2, w // 8:w // 2] = True
        m[1, h // 2:7 * h // 8, w // 2:7 * w // 8] = True
        boxes = np.array([[w // 8, h // 8, w // 2 - w // 8, h // 2 - h // 8],
                          [w // 2, h // 2, 7 * w // 8 - w // 2,
                           7 * h // 8 - h // 2]], np.float32)
        return TInstances.from_numpy(m, boxes, capacity=4)


@pytest.fixture(scope='module')
def stub_sd():
    from test_torch_style import _StubSD
    srv = HTTPServer(('127.0.0.1', 0), _StubSD)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img', _StubSD
    srv.shutdown()


@pytest.fixture(scope='module')
def server(est):
    srv = tsrv.serve(_port_pipeline(est), '127.0.0.1', 0, block=False,
                     segmentor=_BoxDetector())
    yield srv, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()


def _get(url, data=None):
    """(status, content type, body) of a GET, or a POST with data."""
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers['Content-Type'], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers['Content-Type'], e.read()


def _json(url, payload=None, raw=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    code, ctype, body = _get(url, data)
    assert ctype == 'application/json'
    return code, json.loads(body)


def test_kenburns_routes(server, tmp_path):
    """The Ken Burns tab's routes in the order the page calls them."""
    srv, base = server
    code, h = _json(f'{base}/health')
    assert code == 200 and h['ok'] is True
    assert h['config']['depth_est'] == 'default'
    code, err = _json(f'{base}/get_live?fltTime=0.5')
    assert code == 500 and 'no image loaded' in err['error']
    code, meta = _json(f'{base}/load_image', raw=_png(_image(1)))
    assert code == 200 and (meta['height'], meta['width']) == (IMG_H, IMG_W)
    assert _json(f'{base}/health')[1]['loaded'] is True
    for t in (0.0, 0.5, 1.0):
        code, ctype, body = _get(f'{base}/get_live?fltTime={t}')
        assert code == 200 and ctype == 'image/jpeg'
        assert cv2.imdecode(np.frombuffer(body, np.uint8),
                            cv2.IMREAD_COLOR).shape == (IMG_H, IMG_W, 3)
    for which, box in (('from', {'center_u': 22.0}),
                       ('to', {'center_u': 26.0, 'center_v': 20.0})):
        assert _json(f'{base}/update_{which}', box) == (200, {'ok': True})
    svc = srv.service
    assert svc.obj_to['center_u'] == 26.0 and svc.int_time == 2
    assert _json(f'{base}/update_mode', {'mode': 'manual'}) == \
        (200, {'ok': True})
    assert _json(f'{base}/update_mode', {'mode': 'bogus'})[0] == 500
    code, st = _json(f'{base}/step_inpaint', {})
    assert code == 200 and st['ok'] is True and svc.inpainted
    assert svc.state.cloud.count > svc.pristine_state.cloud.count
    code, st = _json(f'{base}/stages')
    assert code == 200 and 'input' in st['stages']
    for route in ('/stage?name=input', '/path_overlay?fltTime=0.3',
                  '/autozoom_preview'):
        code, ctype, body = _get(base + route)
        assert code == 200 and ctype == 'image/jpeg' and len(body) > 100
    assert _json(f'{base}/stage?name=nope')[0] == 500
    code, gal = _json(f'{base}/frames_gallery?n=3')
    assert code == 200 and gal['count'] == 3 and len(gal['frames']) == 3
    for q, n in (('', 3), ('?inpaint=0', 3)):
        code, ctype, body = _get(f'{base}/get_result{q}')
        assert code == 200 and ctype == 'video/mp4'
        assert _mp4_frames(body, tmp_path).shape == (n, IMG_H, IMG_W, 3)
    assert _json(f'{base}/nope')[0] == 404
    assert _json(f'{base}/nope', {})[0] == 404
    code, _, page = _get(f'{base}/')
    assert code == 200 and b'CartoonSegmentation' in page


def test_segment_route(server):
    """/segment: the instances and the overlay, the draw options in the
    query string; tags unavailable → a note."""
    _, base = server
    img = _image(2, 64, 80)
    code, out = _json(f'{base}/segment?draw_bbox=0&mask_alpha=0.5',
                      raw=_png(img))
    assert code == 200 and len(out['instances']) == 2
    assert 'note' not in out
    assert out['instances'][0]['bbox'] == [10.0, 8.0, 30.0, 24.0]
    ov = cv2.imdecode(np.frombuffer(base64.b64decode(out['overlay']),
                                    np.uint8), cv2.IMREAD_COLOR)
    assert ov.shape == img.shape
    code, out = _json(f'{base}/segment?draw_tags=1', raw=_png(img))
    assert code == 200 and out['note'].startswith('tags unavailable')
    assert _json(f'{base}/segment', raw=b'not an image')[0] == 500


def test_mjpeg_stream(server):
    """/get_live without fltTime: multipart JPEG parts at 25 fps, the
    camera advancing in 'automatic' mode; the client closes after 3."""
    srv, base = server
    svc = srv.service
    _json(f'{base}/load_image', raw=_png(_image(3)))
    _json(f'{base}/update_mode', {'mode': 'automatic'})
    with urllib.request.urlopen(f'{base}/get_live', timeout=120) as r:
        assert r.headers['Content-Type'].startswith(
            'multipart/x-mixed-replace')
        buf = b''
        while buf.count(b'--frame') < 4:
            buf += r.read1(65536)
    parts = buf.split(b'--frame')[1:4]
    for p in parts:
        jpg = p.split(b'\r\n\r\n', 1)[1].rstrip(b'\r\n')
        f = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
        assert f.shape == (IMG_H, IMG_W, 3)
    assert len(svc.frame_cache) >= 2       # the camera moved


def test_style_routes(server, stub_sd, tmp_path):
    """The style tab against the stub sd-webui: options, the model
    switch, /style, /style_prepare then /style_apply with an edited
    prompt, /style_batch over a directory."""
    _, base = server
    url, stub = stub_sd
    code, opts = _json(f'{base}/style_options?url={url}')
    assert code == 200 and opts['live'] is True
    assert opts['samplers'] == ['Euler a', 'DPM++ 2M Karras', 'DDIM']
    code, out = _json(f'{base}/style_model',
                      {'url': url, 'model': 'counterfeit-v3 [def456]'})
    assert code == 200 and out['ok'] is True
    assert stub.options['sd_model_checkpoint'] == 'counterfeit-v3 [def456]'
    img64 = base64.b64encode(_png(_image(4, 64, 96))).decode()
    knobs = {'url': url, 'long_side': 96, 'steps': 2}
    stub.calls.clear()
    code, out = _json(f'{base}/style', dict(knobs, image=img64))
    assert code == 200 and out['outputs'] >= 1 and out['image']
    assert len(stub.calls) == 3            # the background + 2 instances
    code, prep = _json(f'{base}/style_prepare', dict(knobs, image=img64))
    assert code == 200 and len(prep['instances']) == 2
    stub.calls.clear()
    code, out = _json(f'{base}/style_apply', dict(
        knobs, image=prep['image'], bg=prep['bg'], mask_fg=prep['mask_fg'],
        bg_prompt='edited bg',
        instances=[{'mask': prep['instances'][0]['mask'],
                    'prompt': 'edited instance'}]))
    assert code == 200 and out['outputs'] == 1
    assert 'edited instance' in stub.calls[1]['prompt']
    d = tmp_path / 'batch'
    d.mkdir()
    cv2.imwrite(str(d / 'a.png'), _image(5, 64, 96))
    code, out = _json(f'{base}/style_batch',
                      dict(knobs, dir=str(d), save_dir=str(d / 'out')))
    assert code == 200 and out['count'] == 1
    assert out['results'][0]['saved'] and all(
        os.path.isfile(p) for p in out['results'][0]['saved'])
    assert _json(f'{base}/style_batch', {'dir': str(d / 'no')})[0] == 500


def test_config_switches(est):
    """``set_config``: the rebuilt pipeline keeps the device, the seed,
    the nets and the Verbose knob; a ``marigold_*`` key makes a new
    Marigold model with the new steps and the old nets; a detector
    family switch carries the box detector's weights (animeinsseg →
    sam → animeinsseg), and one to maskrcnn works."""
    from cartoonsegmentation_torch.models.marigold import MarigoldDepth
    from cartoonsegmentation_torch.models.rtmdet import AnimeDetector
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import \
        MaskRCNNDetector
    from cartoonsegmentation_torch.pipeline.sam import SamDetector
    from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg
    tp = _port_pipeline(est)
    tp.cfg = tp.cfg.replace(detector='animeinsseg')
    tp._seed = 5
    tp.marigold = MarigoldDepth(denoise_steps=4)      # nets on 'meta'
    tp.ensure_detector()
    box = tp._detector
    box._shape = (0.33, 0.25)
    box.model = randomize_nets(AnimeDetector(0.33, 0.25), 1)
    svc = tsrv.KenBurnsService(tp)

    out = svc.set_config({'num_frame': 4, 'stage_previews': True})
    assert out == {'ok': True, 'changed': ['num_frame', 'stage_previews']}
    p = svc.pipe
    assert p is not tp and p.cfg.num_frame == 4 and p.stage_previews
    assert (p.device, p._seed) == (tp.device, 5)
    assert p.disparity_net is est and p.marigold is tp.marigold
    assert p._detector is box

    svc.set_config({'marigold_steps': 2})
    m = svc.pipe.marigold
    assert m is not tp.marigold and m.denoise_steps == 2
    assert m.unet is tp.marigold.unet and m.vae is tp.marigold.vae

    want = box.model.state_dict()
    for family, cls in (('sam', SamDetector), ('animeinsseg', AnimeInsSeg)):
        svc.set_config({'detector': family})
        d = svc.pipe._detector
        assert isinstance(d, cls)
        nb = d.box_detector if family == 'sam' else d
        got = nb.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    svc.set_config({'detector': 'maskrcnn'})
    assert isinstance(svc.pipe._detector, MaskRCNNDetector)
    assert svc.set_config({}) == {'ok': True, 'changed': []}


def test_page_js_integrity():
    """tests/test_serving.py's check on the port's page, and every route
    the page's script names is one the port's handler answers."""
    blocks = re.findall(r'<script[^>]*>(.*?)</script>', PAGE_HTML, re.S)
    assert blocks
    js = '\n'.join(blocks)
    for o, c in (('{', '}'), ('(', ')'), ('[', ']')):
        assert js.count(o) == js.count(c), (o, c)
    ids_used = set(re.findall(r"getElementById\('([\w-]+)'\)", js))
    ids_defined = set(re.findall(r'id="([\w-]+)"', PAGE_HTML))
    missing = ids_used - ids_defined - {
        i for i in ids_used if i.startswith('ins_')}
    assert not missing, missing
    handlers = set(re.findall(r'on(?:click|change)="(\w+)\(', PAGE_HTML))
    defined = set(re.findall(r'(?:async )?function (\w+)', js))
    assert handlers <= defined, handlers - defined
    routes = set(re.findall(r"['\"](/[a-z_]+)", js))
    src = Path(tsrv.__file__).read_text()
    answered = set(re.findall(r"'(/[a-z_]+)'", src))
    assert routes and routes <= answered, routes - answered
    assert 'TPU' not in PAGE_HTML


def test_server_cli():
    """python -m cartoonsegmentation_torch.naive_interface --device cpu
    --port 0 with the shipped YAML: the page and /health, then shut
    down."""
    from cartoonsegmentation_torch import naive_interface
    srv = naive_interface.main(
        ['--cfg', str(ROOT / 'configs' / '3dkenburns.yaml'), '--host',
         '127.0.0.1', '--port', '0', '--device', 'cpu', '--seed', '3'],
        block=False)
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    try:
        assert srv.service.pipe.device == torch.device('cpu')
        assert srv.service.pipe._seed == 3
        code, _, page = _get(f'{base}/')
        assert code == 200 and b'kbLoad' in page
        code, h = _json(f'{base}/health')
        assert code == 200 and h['config']['num_frame'] == 75
    finally:
        srv.shutdown()


def test_batch_cli(tmp_path, capsys):
    """python -m cartoonsegmentation_torch.run_kenburns_batch --device
    cpu over a directory of two 48-pixel images (and a text file):
    one mp4 an image; the shipped YAML at 6 frames, no detector."""
    from cartoonsegmentation_torch import run_kenburns_batch
    pytest.importorskip('yaml')
    cfg = tmp_path / 'kb.yaml'
    text = (ROOT / 'configs' / '3dkenburns.yaml').read_text()
    cfg.write_text(re.sub(r'(?m)^num_frame: \d+$', 'num_frame: 6', text))
    src = tmp_path / 'in'
    src.mkdir()
    for i, name in enumerate(('a.png', 'b.jpg')):
        cv2.imwrite(str(src / name), _image(i, 36, 48))
    (src / 'notes.txt').write_text('not an image')
    out = tmp_path / 'out'
    run_kenburns_batch.main(['--cfg', str(cfg), '--input-dir', str(src),
                             '--save-dir', str(out), '--no-detector',
                             '--device', 'cpu'])
    assert sorted(os.listdir(out)) == ['a.mp4', 'b.mp4']
    assert capsys.readouterr().out.count('(6 frames)') == 2
    for name in ('a', 'b'):       # with the palindrome tail
        assert _mp4_frames((out / f'{name}.mp4').read_bytes(),
                           tmp_path).shape == (10, 36, 48, 3)


@pytest.mark.gpu
def test_server_on_card(est):
    """The routes' kernels on the card: /load_image, /get_live and
    /get_result at 48 px, the live frame against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.ops import _cuda
    frames = {}
    for dev in ('cuda', 'cpu'):
        tp = TPipeline(TConfig(**dict(CFG, detector='none')), seed=0,
                       device=dev)
        tp.disparity_net = est
        svc = tsrv.KenBurnsService(tp)
        _cuda.reset_launches()
        svc.load_image(_png(_image()))
        frames[dev] = cv2.imdecode(np.frombuffer(svc.live_frame(0.5),
                                                 np.uint8), cv2.IMREAD_COLOR)
        if dev == 'cuda':
            assert len(svc.result_video()) > 0
            assert all(_cuda.LAUNCHES[k] for k in (
                'splat', 'coverage', 'discfill', 'laplacian', 'median5',
                'epilogue', 'compact'))
    _close(frames['cuda'], frames['cpu'])
