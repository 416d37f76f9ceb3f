"""The port's SAM path against the JAX package's, on the CPU in f32, at
the reduced size of tests/test_sam.py (img 64, window 3, so the
windowed block pads 4 → 6, one global block).

Weights: the checkpoint-schema twin (tests/torch_twins.py::TorchSAM)
randomised from a seed. Its state dict loads into the port unchanged
(the official keys) and into the JAX package through ``convert_sam``;
``sam_from_flax`` carries the JAX variables back. Inputs are made with
numpy and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cartoonsegmentation_tpu.instances import Instances as JIns
from cartoonsegmentation_tpu.models import sam as jsam
from cartoonsegmentation_tpu.pipeline import sam as jpsam
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models import sam as tsam
from cartoonsegmentation_torch.models.convert import sam_from_flax
from cartoonsegmentation_torch.pipeline import sam as tpsam
from torch_twins import TorchSAM, randomize_
from torch_cpu import torch_threads  # noqa: F401  (autouse)

TINY = dict(img_size=64, patch=16, enc_dim=32, enc_depth=2,
            enc_heads=4, window=3, global_idx=(1,), dec_dim=32,
            dec_heads=4, dec_mlp=64)


@pytest.fixture(scope='module')
def models():
    twin = randomize_(TorchSAM(**TINY), seed=0).eval()
    jmodel = jsam.SAM(**TINY)
    variables = jsam.convert_sam(twin.state_dict(), jmodel)
    tmodel = tsam.SAM(**TINY).eval()
    tmodel.load_state_dict(twin.state_dict())
    return dict(twin=twin, jmodel=jmodel, variables=variables,
                tmodel=tmodel)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _img(rng):
    return rng.randn(1, 64, 64, 3).astype(np.float32)


BOXES = np.array([[4., 8., 40., 56.], [0., 0., 63., 63.],
                  [16., 20., 30., 44.]], np.float32)


@pytest.mark.parametrize('window', [3, 0])
def test_sam_attention_plain_vs_jax(rng, window):
    """K15a's plain version inside SamAttention, a padded 3x3 window
    batch and a 4x4 global grid, against the Flax module."""
    side, B = (3, 4) if window else (4, 1)
    dim, heads = 32, 4
    jattn = jsam.SamAttention(dim, heads, rel_pos_dim=2 * side - 1)
    x = rng.randn(B, side, side, dim).astype(np.float32)
    p = {'qkv': {'kernel': rng.randn(dim, 3 * dim).astype(np.float32) * 0.3,
                 'bias': rng.randn(3 * dim).astype(np.float32) * 0.1},
         'proj': {'kernel': rng.randn(dim, dim).astype(np.float32) * 0.3,
                  'bias': rng.randn(dim).astype(np.float32) * 0.1},
         'rel_pos_h': rng.randn(2 * side - 1, dim // heads).astype(np.float32),
         'rel_pos_w': rng.randn(2 * side - 1, dim // heads).astype(np.float32)}
    want = jattn.apply({'params': p}, jnp.asarray(x))
    tattn = tsam.SamAttention(dim, heads, 2 * side - 1)
    with torch.no_grad():
        tattn.qkv.weight.copy_(torch.from_numpy(p['qkv']['kernel'].T))
        tattn.qkv.bias.copy_(torch.from_numpy(p['qkv']['bias']))
        tattn.proj.weight.copy_(torch.from_numpy(p['proj']['kernel'].T))
        tattn.proj.bias.copy_(torch.from_numpy(p['proj']['bias']))
        tattn.rel_pos_h.copy_(torch.from_numpy(p['rel_pos_h']))
        tattn.rel_pos_w.copy_(torch.from_numpy(p['rel_pos_w']))
        got = tattn(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize('part', ['encoder', 'prompt', 'decoder',
                                  'multimask', 'single'])
def test_sam_parts_vs_jax(models, rng, part):
    """Encoder, prompt encoder and decoder alone, and the full model
    with and without multimask: logits within 1e-4 of their range,
    IoUs within 1e-5."""
    jm, v, tm = models['jmodel'], models['variables'], models['tmodel']
    img = _img(rng)
    emb_j = jm.apply(v, jnp.asarray(img), method=lambda m, x: m.encode(x))
    with torch.no_grad():
        emb_t = tm.encode(torch.from_numpy(img))
        if part == 'encoder':
            assert _rel(emb_t.numpy(), emb_j) <= 1e-4
        elif part == 'prompt':
            sj, dj = jm.apply(v, jnp.asarray(BOXES),
                              method=lambda m, b: m.prompt_encoder(b))
            pj = jm.apply(v, method=lambda m: m.prompt_encoder.dense_pe())
            st, dt = tm.prompt_encoder(torch.from_numpy(BOXES))
            assert _rel(st.numpy(), sj) <= 1e-5
            assert _rel(dt.numpy(), dj) == 0.0
            assert _rel(tm.prompt_encoder.dense_pe().numpy(), pj) <= 1e-5
        elif part == 'decoder':
            # the same embedding into both decoders: all four masks
            emb = np.asarray(emb_j[0])

            def jdec(m, e, b):
                s, d = m.prompt_encoder(b)
                return m.mask_decoder(e, m.prompt_encoder.dense_pe(), s, d)
            mj, ij = jm.apply(v, jnp.asarray(emb), jnp.asarray(BOXES),
                              method=jdec)
            pe = tm.prompt_encoder
            s, d = pe(torch.from_numpy(BOXES))
            mt, it = tm.mask_decoder(torch.from_numpy(emb), pe.dense_pe(), s,
                                     d)
            assert mt.shape == (3, 4, 16, 16)
            assert _rel(mt.numpy(), mj) <= 1e-4
            assert np.abs(it.numpy() - np.asarray(ij)).max() <= 1e-5
        else:
            mm = part == 'multimask'
            mj, ij = jm.apply(v, emb_j[0], jnp.asarray(BOXES), mm,
                              method=lambda m, e, b, k: m.decode(
                                  e, b, multimask=k))
            mt, it = tm.decode(emb_t[0], torch.from_numpy(BOXES),
                               multimask=mm)
            assert _rel(mt.numpy(), mj) <= 1e-4
            assert np.abs(it.numpy() - np.asarray(ij)).max() <= 1e-5


def test_sam_from_flax_round_trip(models, rng):
    """JAX variables → the port's state dict gives back the twin's
    tensors key for key (the mask branch the box path never runs keeps
    the module's own), and the port loaded from them computes what the
    port loaded from the twin computes."""
    twin_sd = models['twin'].state_dict()
    fresh = tsam.SAM(**TINY).eval()
    sd = sam_from_flax(unfreeze(models['variables']), fresh)
    skipped = [k for k in sd if k.startswith((
        'prompt_encoder.mask_downscaling', 'prompt_encoder.not_a_point'))]
    assert skipped
    for k, t in sd.items():
        if k not in skipped:
            assert torch.equal(t, twin_sd[k]), k
    fresh.load_state_dict(sd)
    img = torch.from_numpy(_img(rng))
    with torch.no_grad():
        a = fresh(img, torch.from_numpy(BOXES))
        b = models['tmodel'](img, torch.from_numpy(BOXES))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_load_sam_state_dict_resamples_tables(models):
    """A checkpoint made at 64 loads into a model at 96: the position
    grid resampled 4 → 6 and the global block's tables 7 → 11 rows;
    the window's tables keep their size."""
    sd = models['twin'].state_dict()
    big = tsam.SAM(**dict(TINY, img_size=96))
    tsam.load_sam_state_dict(big, sd)
    assert big.image_encoder.pos_embed.shape == (1, 6, 6, 32)
    assert big.image_encoder.blocks[1].attn.rel_pos_h.shape == (11, 8)
    assert torch.equal(big.image_encoder.blocks[0].attn.rel_pos_w,
                       sd['image_encoder.blocks.0.attn.rel_pos_w'])
    # a resample of a constant is that constant
    const = dict(sd)
    const['image_encoder.blocks.1.attn.rel_pos_h'] = torch.full((7, 8), 0.25)
    tsam.load_sam_state_dict(big, const)
    assert torch.allclose(big.image_encoder.blocks[1].attn.rel_pos_h,
                          torch.full((11, 8), 0.25))


def test_load_sam_state_dict_resampling_vs_jax(models):
    """The resampled position grid (bicubic) and global-block tables
    (linear) at img 96 against the JAX ``convert_sam``, which resamples
    with cv2's INTER_CUBIC and INTER_LINEAR."""
    pytest.importorskip('cv2')
    sd = models['twin'].state_dict()
    big = tsam.SAM(**dict(TINY, img_size=96))
    tsam.load_sam_state_dict(big, sd)
    want = jsam.convert_sam(sd, jsam.SAM(**dict(TINY, img_size=96)))
    enc = want['params']['image_encoder']
    enc_t = big.image_encoder
    assert _rel(enc_t.pos_embed.detach().numpy(), enc['pos_embed']) <= 1e-6
    for k in ('rel_pos_h', 'rel_pos_w'):
        got = getattr(enc_t.blocks[1].attn, k).detach().numpy()
        assert got.shape == (11, 8)
        assert _rel(got, enc['block1']['attn'][k]) <= 1e-6, k


def test_normalize_pad_vs_jax(rng):
    canvas = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    want = np.asarray(jpsam.normalize_pad(jnp.asarray(canvas),
                                          jnp.asarray([20, 24], np.int32)))
    got = tpsam.normalize_pad(torch.from_numpy(canvas), (20, 24)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[20:] == 0).all() and (got[:, 24:] == 0).all()


def _native_pair(models, capacity):
    jn = jpsam.NativeSAM(capacity=capacity, model=models['jmodel'])
    jn._variables = models['variables']
    tn = tpsam.NativeSAM(capacity=capacity, model=models['tmodel'],
                         device='cpu')
    return jn, tn


def test_native_sam_segment_boxes_vs_jax(models, rng):
    """A non-square BGR image and 4 boxes against capacity 3: masks
    >= 99.9% equal (the two bilinear resizes of the logits differ by
    ulps at the > 0 threshold), IoUs within 1e-5, the fourth box
    empty; the embedding is cached per canvas."""
    jn, tn = _native_pair(models, 3)
    img = (rng.rand(50, 70, 3) * 255).astype(np.uint8)
    boxes = np.array([[5, 5, 30, 40], [10, 2, 65, 48], [0, 0, 20, 20],
                      [33, 21, 60, 44]], np.float32)
    mj, ij = jn.segment_boxes(img, boxes)
    mt, it = tn.segment_boxes(img, boxes)
    assert mt.shape == (4, 50, 70) and mt.dtype == torch.bool
    assert float((mt.numpy() == mj).mean()) >= 0.999
    assert np.abs(it.numpy() - ij).max() <= 1e-5
    assert not mt[3].any() and float(it[3]) == 0.0
    assert 0 < float(mt[:3].float().mean()) < 1
    emb = tn._emb
    m2, _ = tn.segment_boxes(img.copy(), boxes[:2])
    assert tn._emb is emb and torch.equal(m2, mt[:2])
    tn.segment_boxes(img[::-1].copy(), boxes[:1])
    assert tn._emb is not emb


class _JBoxes:
    """Stub box detector of the JAX package: fixed xywh boxes, slot 2
    invalid, full masks that SAM must replace."""
    max_instances = 4

    def __init__(self, boxes, valid):
        self.boxes, self.valid = boxes, valid

    def infer(self, img, pred_score_thr=0.3, **kw):
        h, w = img.shape[:2]
        return JIns(masks=jnp.ones((4, h, w), bool),
                    bboxes=jnp.asarray(self.boxes),
                    scores=jnp.full((4,), 0.9, jnp.float32),
                    valid=jnp.asarray(self.valid))


class _TBoxes(_JBoxes):
    device = torch.device('cpu')

    def infer(self, img, pred_score_thr=0.3, **kw):
        h, w = img.shape[:2]
        return TIns(masks=torch.ones((4, h, w), dtype=torch.bool),
                    bboxes=torch.from_numpy(self.boxes),
                    scores=torch.full((4,), 0.9),
                    valid=torch.from_numpy(self.valid))


STUB_BOXES = np.array([[4.0, 6.0, 30.0, 25.0], [20.0, 3.0, 27.0, 40.0],
                       [0.0, 0.0, 10.0, 10.0], [33.0, 17.0, 14.5, 20.7]],
                      np.float32)
STUB_VALID = np.array([True, True, False, True])


def test_sam_detector_vs_jax(models, rng):
    """SamDetector.infer with the same stub box detector in both
    packages: identical boxes and validity, masks >= 99.9% equal, the
    invalid slot empty."""
    jn, tn = _native_pair(models, 4)
    img = (rng.rand(48, 56, 3) * 255).astype(np.uint8)
    ij = jpsam.SamDetector(_JBoxes(STUB_BOXES, STUB_VALID), jn).infer(img)
    it = tpsam.SamDetector(_TBoxes(STUB_BOXES, STUB_VALID), tn).infer(img)
    np.testing.assert_array_equal(it.bboxes.numpy(), np.asarray(ij.bboxes))
    np.testing.assert_array_equal(it.valid.numpy(), np.asarray(ij.valid))
    assert float((it.masks.numpy() == np.asarray(ij.masks)).mean()) >= 0.999
    assert not it.masks[2].any()
    assert not bool(it.masks.all())


def test_pipeline_sam_wiring():
    """configs/3dkenburns_sam.yaml as shipped (its sd-webui 'ldm'
    inpainting runs; so does 'ldm_native' in its place): the pipeline
    builds a SamDetector over an AnimeInsSeg without refine, at capacity
    max_instances, and routes checkpoints to it."""
    from pathlib import Path
    from cartoonsegmentation_torch.config import build_kenburns_cfg
    from cartoonsegmentation_torch.pipeline.kenburns import KenBurnsPipeline
    pytest.importorskip('yaml')
    path = Path(__file__).resolve().parent.parent / 'configs' / \
        '3dkenburns_sam.yaml'
    cfg = build_kenburns_cfg(str(path))
    assert (cfg.detector, cfg.inpaint_type) == ('sam', 'ldm')
    native = KenBurnsPipeline(cfg.replace(inpaint_type='ldm_native'),
                              device='cpu')
    assert native.cfg.inpaint_type == 'ldm_native'
    assert native.ldm_inpainter is None
    pipe = KenBurnsPipeline(cfg, device='cpu')
    pipe.ensure_detector()
    det = pipe._detector
    assert isinstance(det, tpsam.SamDetector)
    assert det.sam.capacity == cfg.max_instances
    assert det.box_detector.refine is None
    assert det.box_detector.timer is pipe.timer and det.timer is pipe.timer
    pipe.load_detector_checkpoints()            # None/None: builds, no-op
    none = KenBurnsPipeline(cfg.replace(inpaint_type='default',
                                        detector='none'), device='cpu')
    with pytest.raises(ValueError):
        none.load_detector_checkpoints()
    from cartoonsegmentation_torch.pipeline.maskrcnn_det import \
        MaskRCNNDetector
    mrcnn = KenBurnsPipeline(cfg.replace(inpaint_type='default',
                                         detector='maskrcnn'), device='cpu')
    mrcnn.ensure_detector()
    assert isinstance(mrcnn._detector, MaskRCNNDetector)
    assert mrcnn._detector.capacity == cfg.max_instances


def test_generate_state_with_sam_detector_vs_jax(models):
    """generate_state with a SamDetector over the stub boxes in both
    pipelines (a reduced LeReS from tests/test_torch_pipeline.py): the
    same instances (masks >= 99.9%) and the instance-adjusted disparity
    at that file's bound."""
    from test_torch_pipeline import (CFG, LAYERS, JConfig, JPipeline, TConfig,
                                     TLeReS, TPipeline, _image,
                                     _leres_variables, leres_from_flax)
    cfg = dict(CFG, detector='sam', max_instances=4, pred_score_thr=0.0)
    img = _image()
    boxes = STUB_BOXES * 2.0
    jn, tn = _native_pair(models, 4)
    jp = JPipeline(JConfig(**cfg), seed=0)
    jp.stage_previews = False
    jp._leres_net, jp._leres_vars = _leres_variables()
    jp.set_detector(jpsam.SamDetector(_JBoxes(boxes, STUB_VALID), jn))
    tp = TPipeline(TConfig(**cfg), device='cpu')
    tp.leres_net = TLeReS(LAYERS)
    tp.leres_net.load_state_dict(leres_from_flax(jp._leres_vars,
                                                 tp.leres_net))
    tp.set_detector(tpsam.SamDetector(_TBoxes(boxes, STUB_VALID), tn))
    sj, st = jp.generate_state(img), tp.generate_state(img)
    mj = np.asarray(sj.instances.masks)
    mt = st.instances.masks.numpy()
    assert mj[STUB_VALID].any()
    assert float((mt == mj).mean()) >= 0.999
    np.testing.assert_array_equal(st.instances.valid.numpy(),
                                  np.asarray(sj.instances.valid))
    dt = st.disparity[..., 0].numpy()
    dj = np.asarray(sj.disparity[..., 0])
    assert (np.abs(dt - dj) <= 1e-4).mean() >= 0.99
    assert int(st.cloud.count) == int(sj.cloud.count)
