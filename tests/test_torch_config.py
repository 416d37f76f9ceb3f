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

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'cartoonsegmentation_torch'
YAMLS = sorted(str(p) for p in (ROOT / 'configs').glob('*.yaml'))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'cartoonsegmentation_tpu')


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
    {'detector': 'animeinsseg', 'refine_method': 'animeseg'},
    # the SAM detector runs; 3dkenburns_sam.yaml's sd-webui inpaint
    # does not yet
    pytest.param({'detector': 'sam', 'inpaint_type': 'ldm'},
                 id='detector=sam'),
    {'detector': 'none', 'depth_est': 'zoe'},
    {'detector': 'none', 'default_depth_refine': True},
    {'detector': 'none', 'inpaint_type': 'patchmatch'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_unported_paths_raise(kw):
    with pytest.raises(NotImplementedError, match='not ported'):
        KenBurnsPipeline(tconfig.KenBurnsConfig(**kw), device='cpu')


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
