"""The port's style/repaint flow against the JAX package's on the CPU:
the sd-webui client, the PNG codecs, ``StyleEditor`` and the
``run_style`` / ``repaint_person`` CLIs, both packages talking to one
stub sd-webui server on 127.0.0.1.

The background fill's random offsets are JAX's draws in the port
(``jitter_offsets`` patched), so the two fills agree; every request
body must then carry the same fields and values (images compared
decoded, PNG being lossless), and the cache files and the saved images
must be equal.
"""
import base64
import copy
import importlib.util
import io
import json
import os
import os.path as osp
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from cartoonsegmentation_tpu.instances import Instances as JInstances
from cartoonsegmentation_tpu.pipeline import style as jstyle
from cartoonsegmentation_tpu.serving import sd_webui as jsd
from cartoonsegmentation_tpu.utils import io as jio
from cartoonsegmentation_torch import repaint_person as trepaint
from cartoonsegmentation_torch import run_style as trun_style
from cartoonsegmentation_torch.instances import Instances as TInstances
from cartoonsegmentation_torch.ops import inpaint_fill as tfill
from cartoonsegmentation_torch.pipeline import style as tstyle
from cartoonsegmentation_torch.serving import sd_webui as tsd
from cartoonsegmentation_torch.utils import io as tio

from test_torch_inpaint_fill import jax_offsets
from torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


class _StubSD(BaseHTTPRequestHandler):
    """sd-webui's routes as the style flow uses them: img2img answers
    n_iter * batch_size images of the requested size (a grid composite
    first when more than one), cv2-encoded."""
    calls = []
    options = {'sd_model_checkpoint': 'anything-v5 [abc123]'}

    def _json(self, obj):
        body = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.endswith('/sdapi/v1/samplers'):
            self._json([{'name': n} for n in
                        ('Euler a', 'DPM++ 2M Karras', 'DDIM')])
        elif self.path.endswith('/sdapi/v1/sd-models'):
            self._json([{'title': 'anything-v5 [abc123]'},
                        {'title': 'counterfeit-v3 [def456]'}])
        elif self.path.endswith('/sdapi/v1/options'):
            self._json(_StubSD.options)
        else:
            self.send_response(404)
            self.end_headers()

    def do_POST(self):
        n = int(self.headers['Content-Length'])
        payload = json.loads(self.rfile.read(n))
        if self.path.endswith('/sdapi/v1/options'):
            _StubSD.options.update(payload)
            self._json({})
            return
        _StubSD.calls.append(payload)
        w, h = payload.get('width', 64), payload.get('height', 64)

        def image(k):
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack([(xx * 7 + 40 * k) % 256, (yy * 5) % 256,
                            np.full((h, w), 60 + 50 * k)], -1)
            ok, buf = cv2.imencode('.png', img.astype(np.uint8))
            return base64.b64encode(buf.tobytes()).decode()

        count = int(payload.get('n_iter', 1)) \
            * int(payload.get('batch_size', 1))
        imgs = [image(k + 1) for k in range(count)]
        if count > 1:
            imgs = [image(0)] + imgs          # the grid
        self._json({'images': imgs})

    def log_message(self, *a):
        pass


@pytest.fixture(scope='module')
def server():
    srv = HTTPServer(('127.0.0.1', 0), _StubSD)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img'
    srv.shutdown()


@pytest.fixture
def calls(server):
    _StubSD.calls.clear()
    return _StubSD.calls


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's fill takes JAX's jitter offsets."""
    monkeypatch.setattr(tfill, 'jitter_offsets',
                        lambda h, w, seed=0, iters=2, device=None:
                        torch.from_numpy(jax_offsets(h, w, seed, iters)).to(
                            device or 'cpu'))


def _pil(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _decoded(payload):
    """The body with each image replaced by its decoded pixels."""
    def px(b64):
        a = _pil(b64)
        return (a.shape, str(a.dtype), a.tobytes())
    p = copy.deepcopy(payload)
    p['init_images'] = [px(s) for s in p['init_images']]
    if 'mask' in p:
        p['mask'] = px(p['mask'])
    for a in p.get('alwayson_scripts', {}).get('controlnet', {}).get(
            'args', []):
        if 'input_image' in a:
            a['input_image'] = px(a['input_image'])
    return p


def _assert_same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _decoded(x), _decoded(y)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k] == y[k], k


# --- the client -------------------------------------------------------


def test_client_payloads_and_trims(server, calls):
    rng = np.random.RandomState(0)
    img = (rng.rand(24, 40, 3) * 255).astype(np.uint8)
    mask = ((rng.rand(24, 40) > 0.7) * 255).astype(np.uint8)
    tmpl = {'width': 40, 'height': 24, 'steps': 3, 'seed': 1,
            'alwayson_scripts': {'controlnet': {'args': [{'module': 'x'}]}}}
    out = {}
    for name, sd in (('jax', jsd), ('torch', tsd)):
        calls.clear()
        data = copy.deepcopy(tmpl)
        many = sd.run_img2img_all(sd.img2b64(img),
                                  dict(data, n_iter=2, batch_size=2),
                                  'p', 'n', server)
        one = sd.run_img2img(sd.img2b64(img), data, 'p', 'n', server,
                             controlnet_input=sd.img2b64(img[::-1]))
        inp = sd.run_sdinpaint_all(sd.img2b64(img), mask, data, 'q', 'm',
                                   server)
        inp1 = sd.run_sdinpaint(sd.img2b64(img), mask, data, 'q', 'm', server)
        # the request template keeps no conditioning image
        assert data == tmpl
        out[name] = dict(calls=list(calls), many=many, one=one, inp=inp,
                         inp1=inp1)
    _assert_same_calls(out['jax']['calls'], out['torch']['calls'])
    assert len(out['torch']['many']) == 4     # the grid trimmed
    for k in ('many', 'one', 'inp', 'inp1'):
        a, b = out['jax'][k], out['torch'][k]
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(_pil(x), _pil(y))
    cn = out['torch']['calls'][1]['alwayson_scripts']['controlnet']['args']
    np.testing.assert_array_equal(_pil(cn[0]['input_image']), img[::-1])


def test_client_queries_and_unreachable_server(server, calls):
    for sd in (jsd, tsd):
        assert sd.list_samplers(server) == ['Euler a', 'DPM++ 2M Karras',
                                            'DDIM']
        assert sd.list_sd_models(server) == ['anything-v5 [abc123]',
                                             'counterfeit-v3 [def456]']
        assert sd.set_sd_model(server, 'counterfeit-v3 [def456]')
        assert sd.current_sd_model(server) == 'counterfeit-v3 [def456]'
        assert sd.set_sd_model(server, 'anything-v5 [abc123]')
    assert tsd.api_base(server) == jsd.api_base(server)
    assert tsd.SAMPLER_FALLBACK == jsd.SAMPLER_FALLBACK
    # a port nothing listens on
    srv = HTTPServer(('127.0.0.1', 0), _StubSD)
    dead = f'http://127.0.0.1:{srv.server_port}/sdapi/v1/img2img'
    srv.server_close()
    assert tsd.list_samplers(dead) == tsd.SAMPLER_FALLBACK
    assert tsd.list_sd_models(dead) == []
    assert tsd.current_sd_model(dead) is None
    assert tsd.set_sd_model(dead, 'x') is False
    with pytest.raises(RuntimeError, match='unreachable'):
        tsd.submit_request(dead, '{}', retries=2, wait_time=0.0)


@pytest.mark.parametrize('shape', [(17, 23, 3), (17, 23, 4), (17, 23)])
def test_codecs_both_ways(shape, tmp_path):
    img = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    np.testing.assert_array_equal(jio.b64_2img(tio.img2b64(img)), img)
    np.testing.assert_array_equal(tio.b64_2img(jio.img2b64(img)), img)
    np.testing.assert_array_equal(tio.b64_2img(tio.img2b64(img)), img)
    p = str(tmp_path / 'x.png')
    tio.save_encoded_image(tio.img2b64(img), p)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


# --- StyleEditor --------------------------------------------------------

IMG_H, IMG_W = 80, 112          # worked at 96x128 (long_side 128)


def _image():
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 9), 128 + 90 * np.cos(yy / 7),
                    rng.rand(IMG_H, IMG_W) * 255], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _instances():
    """Three masks, one over the left edge; xywh boxes."""
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W]
    m1 = ((yy - 30) ** 2 + (xx - 40) ** 2) < 14 ** 2
    m2 = np.zeros((IMG_H, IMG_W), bool)
    m2[50:75, 70:100] = True
    m3 = ((yy - 60) ** 2 + xx ** 2) < 12 ** 2
    boxes = np.array([[26, 16, 28, 28], [70, 50, 30, 25], [0, 48, 12, 24]],
                     np.float32)
    return np.stack([m1, m2, m3]), boxes


class _JDet:
    def infer(self, img, *a, **k):
        m, b = _instances()
        return JInstances.from_numpy(m, b, capacity=5)


class _TDet:
    device = torch.device('cpu')

    def infer(self, img, *a, **k):
        m, b = _instances()
        return TInstances.from_numpy(m, b, capacity=5)


def _tagger(seen):
    def tag(crop):
        seen.append(crop.copy())
        tone = f'tone_{int(crop.mean()) // 64}'
        return ['1girl', 'smile', 'char_a', tone], ['char_a']
    return tag


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = osp.join(d, name)
        if name.endswith('.json'):
            with open(p) as f:
                out[name] = json.load(f)
        else:
            out[name] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    return out


def _assert_same_files(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


MODES = {
    'onebyone': dict(niter=2, apply_bg_tagger=True),
    'joint': dict(onebyone=False),
    'to_grey': dict(to_grey=True),
    'save_intermediate': dict(save_intermediate=True),
    'batch': dict(batch_count=3, batch_size=1),
    'exact_size': dict(exact_size=(96, 64)),
}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_style_editor_matches_jax(mode, server, calls, tmp_path, jax_draws):
    img = _image()
    res = {}
    for name, mod, det in (('jax', jstyle, _JDet()),
                           ('torch', tstyle, _TDet())):
        calls.clear()
        d = tmp_path / name
        cfg = mod.StyleConfig(
            url=server, style_prompt='pixar style', bg_nprompt='person',
            global_nprompt='bad', long_side=128,
            cache_masks_dir=str(d / 'cache'), save_dir=str(d / 'out'),
            sd_params={'steps': 2, 'alwayson_scripts':
                       {'controlnet': {'args': [{}]}}}, **MODES[mode])
        seen = []
        kw = {} if name == 'jax' else {'device': 'cpu'}
        ed = mod.StyleEditor(cfg, detector=det, tagger=_tagger(seen), **kw)
        saved = ed.repaint(img, 'im')
        first = list(calls)
        # the second run reads the cache and needs no detector
        calls.clear()
        ed2 = mod.StyleEditor(cfg, **kw)
        saved2 = ed2.repaint(img, 'im')
        res[name] = dict(calls=first, calls2=list(calls), seen=seen,
                         saved=[osp.basename(p) for p in saved],
                         saved2=[osp.basename(p) for p in saved2],
                         cache=_files(d / 'cache'), out=_files(d / 'out'))
    j, t = res['jax'], res['torch']
    _assert_same_calls(j['calls'], t['calls'])
    _assert_same_calls(j['calls2'], t['calls2'])
    assert j['saved'] == t['saved'] and j['saved2'] == t['saved2']
    _assert_same_files(j['cache'], t['cache'])
    _assert_same_files(j['out'], t['out'])
    assert len(j['seen']) == len(t['seen']) == 4     # 3 crops, the bg
    for a, b in zip(j['seen'], t['seen']):
        np.testing.assert_array_equal(a, b)
    n_fg = 1 if mode == 'joint' else 3
    # the background once, then the instances each round
    assert len(t['calls']) == 1 + n_fg * MODES[mode].get('niter', 1)
    assert 'mask' not in t['calls'][0] and 'mask' in t['calls'][1]
    assert 'pixar style' in t['calls'][1]['prompt']
    assert '1girl' in t['calls'][1]['prompt']
    assert 'char_a' not in t['calls'][1]['prompt']
    h, w = (64, 96) if mode == 'exact_size' else (96, 128)
    assert (t['calls'][0]['height'], t['calls'][0]['width']) == (h, w)
    if mode == 'to_grey':
        for crop in t['seen']:
            assert (crop[..., 0] == crop[..., 2]).all()
    if mode == 'batch':
        assert t['saved'][1].endswith('_var1.png')


def test_repaint_whole_matches_jax(server, calls, tmp_path):
    img = _image()
    res = {}
    for name, mod in (('jax', jstyle), ('torch', tstyle)):
        calls.clear()
        cfg = mod.StyleConfig(url=server, style_prompt='lineart',
                              exact_size=(96, 64), to_grey=True,
                              save_dir=str(tmp_path / name),
                              sd_params={'steps': 2})
        kw = {} if name == 'jax' else {'device': 'cpu'}
        saved = mod.StyleEditor(cfg, **kw).repaint_whole(img, 'whole')
        res[name] = (list(calls), [osp.basename(p) for p in saved],
                     _files(tmp_path / name))
    _assert_same_calls(res['jax'][0], res['torch'][0])
    assert res['jax'][1] == res['torch'][1] == ['repaint-default-whole.png']
    _assert_same_files(res['jax'][2], res['torch'][2])
    assert res['torch'][0][0]['denoising_strength'] == 0.75


def test_style_config_from_yaml_matches_jax(tmp_path):
    raw = {'onebyone': False, 'style_prompt': 'oil painting', 'niter': 2,
           'url': 'http://x/img2img', 'long_side': 512,
           'sd_params': {'steps': 9}, 'not_a_field': 1}
    assert tstyle.style_config_from_yaml(raw).__dict__ == \
        jstyle.style_config_from_yaml(raw).__dict__
    shipped = osp.join(ROOT, 'configs', '3d_pixar.yaml')
    assert tstyle.style_config_from_yaml(shipped).__dict__ == \
        jstyle.style_config_from_yaml(shipped).__dict__
    for hw in ((576, 1024), (1024, 576), (683, 1024), (100, 100)):
        assert tstyle.long_side_to(*hw, 768) == jstyle.long_side_to(*hw, 768)
    assert tstyle.long_side_to(576, 1024, 768) == (448, 768)


# --- the CLIs ------------------------------------------------------------


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}_cli', osp.join(ROOT, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JDetCli(_JDet):
    def __init__(self, *a, **k):
        self.tagger = None

    def set_refine_method(self, *a, **k):
        pass

    def init_tagger(self, *a, **k):
        self.tagger = type('T', (), {'label_cv2_bgr': staticmethod(
            _tagger([]))})()


class _TDetCli(_TDet):
    def __init__(self, *a, device=None, **k):
        self.device = torch.device(device)
        self.tagger = None

    set_refine_method = _JDetCli.set_refine_method
    init_tagger = _JDetCli.init_tagger


def _both_clis(name, argv, tmp_path, monkeypatch, calls):
    """Run the JAX script and the port's module with the same argv
    (--save_dir and --cache_masks_dir apart), each from a directory of
    its own so that neither reads the other's mask cache (repaint_person
    has no flag for it: it caches under the working directory); their
    request bodies, written files and cache files (the port's)."""
    monkeypatch.setattr('cartoonsegmentation_tpu.pipeline.AnimeInsSeg',
                        _JDetCli)
    monkeypatch.setattr(
        'cartoonsegmentation_torch.pipeline.segment.AnimeInsSeg', _TDetCli)
    res = {}
    for pkg in ('jax', 'torch'):
        calls.clear()
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        dirs = ['--save_dir', str(d / 'out')]
        cache = d / 'workspace' / 'style_cache'
        if name == 'run_style':
            cache = d / 'cache'
            dirs += ['--cache_masks_dir', str(cache)]
        if pkg == 'jax':
            monkeypatch.setattr('sys.argv', [f'{name}.py'] + argv + dirs)
            _jax_cli(name).main()
        else:
            mod = trun_style if name == 'run_style' else trepaint
            mod.main(argv + dirs + ['--device', 'cpu'])
        res[pkg] = (list(calls), _files(d / 'out'),
                    _files(cache) if cache.is_dir() else {})
    _assert_same_calls(res['jax'][0], res['torch'][0])
    _assert_same_files(res['jax'][1], res['torch'][1])
    # the port's cache lies in a directory only its own run saw
    _assert_same_files(res['jax'][2], res['torch'][2])
    return res['torch']


def test_repaint_person_cli_whole_image(server, calls, tmp_path,
                                        monkeypatch):
    imgp = str(tmp_path / 'in.png')
    cv2.imwrite(imgp, _image())
    got, files, cache = _both_clis('repaint_person', [
        '--img_path', imgp, '--no-onebyone', '-p', 'lineart girl',
        '-n', 'bad hands', '-W', '64', '-H', '64', '-s', '3', '-c', '7',
        '-S', 'DDIM', '-f', 'fill', '-b', '2', '-d', '0.6', '--to-grey',
        '--url', server], tmp_path, monkeypatch, calls)
    call = got[0]
    assert call['prompt'] == 'lineart girl' and call['steps'] == 3
    assert call['denoising_strength'] == 0.6
    cn = call['alwayson_scripts']['controlnet']['args'][0]
    assert cn['module'] == 'lineart_anime' and cn['processor_res'] == 640
    assert list(files) == ['repaint-default-in.png']


def test_repaint_person_cli_onebyone_and_yaml(server, calls, tmp_path,
                                              monkeypatch, jax_draws):
    imgp = str(tmp_path / 'in.png')
    cv2.imwrite(imgp, _image())
    yamlp = tmp_path / 'style.yaml'
    yamlp.write_text('style_prompt: from yaml\ndenoising_strength: 0.33\n'
                     'mask_blur: 9\nsd_params:\n  steps: 5\n')
    got, files, cache = _both_clis('repaint_person', [
        '--img_path', imgp, '--cfg', str(yamlp), '-W', '128', '-H', '96',
        '-b', '2', '-d0.6', '--url', server], tmp_path, monkeypatch, calls)
    assert len(got) == 4                  # the background, 3 instances
    assert got[1]['mask_blur'] == 2       # explicit -b beats the yaml's 9
    assert got[1]['denoising_strength'] == 0.6
    assert got[0]['steps'] == 5 and got[1]['prompt'].startswith('from yaml')
    assert '1girl' in got[1]['prompt']
    assert (got[0]['width'], got[0]['height']) == (128, 96)
    # the port's own prepare detected, tagged and filled the background
    assert sorted(cache) == ['in_000.png', 'in_001.png', 'in_002.png',
                             'in_bg_repaint.png', 'in_mask_fg.png',
                             'in_prompts.json']


def test_run_style_cli_yaml_and_flags(server, calls, tmp_path, monkeypatch,
                                      jax_draws):
    imgp = str(tmp_path / 'in.png')
    cv2.imwrite(imgp, _image())
    yamlp = tmp_path / 'style.yaml'
    yamlp.write_text(f'style_prompt: pixar\nniter: 2\nurl: {server}\n'
                     'long_side: 512\nsd_params:\n  steps: 5\n'
                     '  sampler_name: DDIM\n')
    got, files, cache = _both_clis('run_style', [
        '--img_path', imgp, '--cfg', str(yamlp), '--long_side', '128',
        '--steps', '7', '-b', '3', '--allow-stub-tagger',
        '--apply-bg-tagger'],
        tmp_path, monkeypatch, calls)
    assert len(got) == 1 + 2 * 3          # niter 2 from the yaml
    assert got[0]['steps'] == 7 and got[0]['sampler_name'] == 'DDIM'
    assert got[1]['mask_blur'] == 3
    assert (got[0]['width'], got[0]['height']) == (128, 96)
    assert 'solo' in got[1]['prompt']     # the stub tagger's tags
    assert len(files) == 2
    assert 'in_prompts.json' in cache


def test_run_style_cli_flags_only(server, calls, tmp_path, monkeypatch,
                                  jax_draws):
    imgp = str(tmp_path / 'in.png')
    cv2.imwrite(imgp, _image())
    got, files, cache = _both_clis('run_style', [
        '--img_path', imgp, '--style-prompt', 'ghibli', '--long_side', '128',
        '--no-onebyone', '-f', 'latent_noise', '--url', server],
        tmp_path, monkeypatch, calls)
    assert len(got) == 2 and got[1]['inpainting_fill'] == 2
    assert got[1]['prompt'] == 'ghibli'   # no tagger given


def test_repaint_person_cli_directory_and_bad_path(server, calls, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)           # the mask cache goes under it
    d = tmp_path / 'imgs'
    d.mkdir()
    for name in ('a.png', 'b.jpg'):
        cv2.imwrite(str(d / name), _image())
    base = ['--no-onebyone', '-W', '64', '-H', '64', '--save_dir',
            str(tmp_path / 'out'), '--url', server, '--device', 'cpu']
    trepaint.main(base + ['--img_path', str(d)])
    assert len(calls) == 2
    assert sorted(os.listdir(tmp_path / 'out')) == [
        'repaint-default-a.png', 'repaint-default-b.png']
    with pytest.raises(SystemExit, match='cannot read image'):
        trepaint.main(base + ['--img_path', str(tmp_path / 'nope.png')])
