"""The port's configuration against the JAX package's, the port's
import boundary, and its device rule."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from cartoonsegmentation_tpu import config as jconfig
from cartoonsegmentation_torch import config as tconfig
from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
from torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'cartoonsegmentation_torch'
YAMLS = sorted(str(p) for p in (ROOT / 'configs').glob('*.yaml'))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'cartoonsegmentation_tpu',
             'transformers', 'diffusers')


def _as_dict(cfg):
    """Field by field, nested option blocks included."""
    return dataclasses.asdict(cfg)


def test_same_fields_and_defaults():
    assert _as_dict(tconfig.KenBurnsConfig()) == \
        _as_dict(jconfig.KenBurnsConfig())
    assert _as_dict(tconfig.LDMInpaintOptions()) == \
        _as_dict(jconfig.LDMInpaintOptions())


@pytest.mark.parametrize('path', YAMLS, ids=lambda p: Path(p).name)
def test_yaml_parity_field_by_field(path):
    pytest.importorskip('yaml')
    assert _as_dict(tconfig.build_kenburns_cfg(path)) == \
        _as_dict(jconfig.build_kenburns_cfg(path))


def test_dict_and_config_sources_need_no_yaml():
    raw = {'detector': 'none', 'num_frame': 7, 'unknown_key': 1,
           'mask_refine_kwargs': {'refine_method': 'none',
                                  'refine_size': '512'},
           'marigold_kwargs': {'denoise_steps': '3',
                               'checkpoint': 'prs-eth/marigold-v1-0'}}
    cfg = tconfig.build_kenburns_cfg(raw)
    assert (cfg.detector, cfg.num_frame, cfg.refine_method,
            cfg.refine_size, cfg.marigold_steps, cfg.marigold_scheduler) \
        == ('none', 7, 'none', 512, 3, 'ddim')
    assert _as_dict(cfg) == _as_dict(jconfig.build_kenburns_cfg(raw))
    assert tconfig.build_kenburns_cfg(cfg) is cfg
    assert tconfig.build_kenburns_cfg(None) == tconfig.KenBurnsConfig()


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_port_imports_no_jax_by_ast():
    """By AST, not by importing: the test process has JAX loaded
    already."""
    files = sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert len(files) > 20
    bad = []
    for f in files:
        for name in _imports(ast.parse(f.read_text(), str(f))):
            if name.split('.')[0] in FORBIDDEN:
                bad.append(f'{f.relative_to(ROOT)}: {name}')
    assert not bad, bad


def test_default_device_is_cuda_and_never_a_quiet_cpu():
    cfg = tconfig.KenBurnsConfig(detector='none')
    if torch.cuda.is_available():
        assert KenBurnsPipeline(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            KenBurnsPipeline(cfg)
    assert KenBurnsPipeline(cfg, device='cpu').device.type == 'cpu'


@pytest.mark.parametrize('kw', [
    {'detector': 'yolo'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_unported_paths_raise(kw):
    """Every depth estimator and inpaint type of the JAX package runs in
    the port; a detector it does not know is refused."""
    from cartoonsegmentation_torch.pipeline import kenburns
    assert kenburns.UNPORTED_DEPTH == () and kenburns.UNPORTED_INPAINT == ()
    with pytest.raises(NotImplementedError, match='not ported'):
        KenBurnsPipeline(tconfig.KenBurnsConfig(**kw), device='cpu')


@pytest.mark.parametrize('kw', [
    {'detector': 'none', 'depth_est': 'marigold'},
    {'detector': 'none', 'inpaint_type': 'ldm_native'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_diffusion_paths_install(kw, monkeypatch):
    """``depth_est: marigold`` and ``inpaint_type: ldm_native`` run: the
    pipeline takes the config and installs, once and from the cfg's
    knobs, the full-size Marigold model or LDMInpainter, its weights not
    yet drawn (that happens on the device at first use, ``ready``, here
    left out; tests/test_torch_marigold.py and
    tests/test_torch_ldm_inpaint.py run small ones)."""
    from cartoonsegmentation_torch.models.ldm_inpaint import LDMInpainter
    from cartoonsegmentation_torch.models.marigold import MarigoldDepth
    cfg = tconfig.KenBurnsConfig(**kw)
    pipe = KenBurnsPipeline(cfg, device='cpu')
    if cfg.depth_est == 'marigold':
        m = pipe._ensure_marigold()
        assert isinstance(m, MarigoldDepth) and m is pipe._ensure_marigold()
        assert (m.processing_res, m.denoise_steps, m.ensemble_size,
                m.scheduler_kind) == (768, 4, 5, 'lcm')
        assert m.unet.conv_in.in_channels == 8 and m.text_embed.is_meta
    else:
        monkeypatch.setattr(LDMInpainter, 'ready', lambda self, dev: self)
        m = pipe._ldm_inpainter()
        assert isinstance(m, LDMInpainter) and m is pipe._ldm_inpainter()
        assert (m.steps, m.guidance, m.seed) == (32, 7, 0)
        assert m.unet.conv_in.in_channels == 9 and m.cond.is_meta
        assert tuple(m.cond.shape) == (1, 77, 768)
    assert m.unet.block_out == (320, 640, 1280, 1280)


@pytest.mark.parametrize('kw', [
    {'detector': 'none', 'depth_est': 'zoe'},
    {'detector': 'none', 'depth_est': 'zoe_nk'},
    {'detector': 'none', 'depth_est': 'leres_boost'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_ported_depth_estimators_run(kw, monkeypatch):
    """The depth estimators this slice ports: the pipeline takes the
    config, installs the estimator's nets (small ones here: ZoeDepth at
    tests/test_torch_zoedepth.py's geometry for a 64x96 grid, a reduced
    LeReS trunk and merge net with the boost's sizes cut) and returns a
    finite disparity of the image's size."""
    import numpy as np
    from cartoonsegmentation_torch.models.leres import LeReS
    from cartoonsegmentation_torch.models.pix2pix4depth import Pix2Pix4Depth
    from cartoonsegmentation_torch.models.zoedepth import ZoeDepthNK
    from cartoonsegmentation_torch.pipeline import boost
    from test_torch_zoedepth import make_zoe
    est = kw['depth_est']
    pipe = KenBurnsPipeline(tconfig.KenBurnsConfig(dtype='float32', **kw),
                            device='cpu')
    torch.manual_seed(0)
    if est == 'leres_boost':
        for k, v in dict(RECEPTIVE_FIELD=64, PATCH_NETSIZE=128,
                         PIX2PIX_SIZE=128, WHOLE_SIZE_THRESHOLD=400).items():
            monkeypatch.setattr(boost, k, v)
        pipe.leres_net = LeReS((1, 1, 1, 1))
        pipe.p2p_net = Pix2Pix4Depth(num_downs=6, ngf=8)
        h, w = 96, 128
    else:
        pipe.zoe_net = make_zoe(est == 'zoe_nk', (64, 96))
        h, w = 40, 72
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(xx / 5 + c) * np.cos(yy / 3) for c in range(3)],
                   -1).astype(np.float32) * 0.4 + 0.5
    disp = pipe._estimate_disparity(torch.from_numpy(img))
    assert tuple(disp.shape) == (h, w, 1)
    assert torch.isfinite(disp).all() and disp.max() > 0
    if est == 'leres_boost':
        assert pipe.last_boost.leres_net is pipe.leres_net
    else:
        assert isinstance(pipe.zoe_net, ZoeDepthNK) == (est == 'zoe_nk')


def test_refine_crf_is_accepted():
    """``refine_crf`` runs in the port (the CRF depth refine)."""
    pipe = KenBurnsPipeline(tconfig.KenBurnsConfig(detector='none',
                                                   refine_crf=True),
                            device='cpu')
    assert pipe.cfg.refine_crf and callable(pipe._refine_crf)


@pytest.mark.parametrize('kw', [
    {'detector': 'maskrcnn'},
    {'detector': 'none', 'discfill_mode': 'exact'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_maskrcnn_and_exact_fill_install(kw, monkeypatch):
    """``detector: maskrcnn`` installs a MaskRCNNDetector on the
    pipeline's device at capacity max_instances, timed by the pipeline;
    the render seam fills with K11 at cfg.discfill_max_steps under
    ``discfill_mode: exact`` and with K3 otherwise."""
    from cartoonsegmentation_torch.ops import discfill, discfill3
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import \
        MaskRCNNDetector
    cfg = tconfig.KenBurnsConfig(**kw)
    pipe = KenBurnsPipeline(cfg, device='cpu')
    pipe.ensure_detector()
    det = pipe._detector
    if cfg.detector == 'maskrcnn':
        assert isinstance(det, MaskRCNNDetector)
        assert det.capacity == cfg.max_instances == 100
        assert det.device.type == 'cpu' and det.timer is pipe.timer
    else:
        assert det is None
    calls = []
    monkeypatch.setattr(discfill, 'fill_disocclusion',
                        lambda im, d, k: calls.append(('exact', k)) or im)
    monkeypatch.setattr(discfill3, 'fill_disocclusion',
                        lambda im, d: calls.append(('fast',)) or im)
    pipe._fill(torch.zeros((2, 3, 4)), torch.zeros((2, 3)))
    assert calls == [('exact', 128) if cfg.discfill_mode == 'exact'
                     else ('fast',)]


def test_shipped_default_with_detector_off_is_supported():
    cfg = tconfig.KenBurnsConfig(detector='none')
    pipe = KenBurnsPipeline(cfg, device='cpu')
    pipe.ensure_detector()
    assert pipe.conv_dtype == torch.float32      # 'auto' on the CPU


def test_shipped_default_with_detector_on_is_supported():
    """The shipped default: AnimeInsSeg with the ISNet refine, made
    lazily on the pipeline's device with the config's sizes."""
    from cartoonsegmentation_torch.pipeline.refine import ISNetRefiner
    from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg
    cfg = tconfig.KenBurnsConfig()
    assert (cfg.detector, cfg.refine_method) == ('animeinsseg',
                                                 'refinenet_isnet')
    pipe = KenBurnsPipeline(cfg, device='cpu')
    pipe.ensure_detector()
    det = pipe._detector
    assert isinstance(det, AnimeInsSeg) and isinstance(det.refine,
                                                       ISNetRefiner)
    assert (det.det_size, det.max_instances, det.refine.refine_size) == \
        (640, 100, 720)
    assert det.device.type == det.refine.device.type == 'cpu'
    pipe.set_detector('none')
    assert pipe._detector is None
