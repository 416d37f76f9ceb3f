"""The port's latent-diffusion inpainting (``inpaint_type: ldm_native``)
against the JAX package's, on the CPU in f32.

The inpainter runs at the tiny geometry of tests/test_ldm_inpaint.py (2
DDIM steps, guidance 3, block_out (32, 64) with 1x1-conv projections,
context 4 x 16); its weights are drawn in the port and go to Flax
through the JAX package's ``convert_unet`` / ``convert_vae``. The port is
handed the start noise JAX draws with ``jax.random`` (``jax_noise``).
The pass test takes tests/test_torch_inpaint_types.py's clip state and
its one JAX forward of the Inpaint net, handed to both packages, so that
the images filled are the same bytes. Tolerance: the uint8 output at
most one level from JAX's and >= 99.9% of it equal (measured: equal);
the loaded nets and token ids exact. JAX is imported only inside the
fixtures and tests that run it, so the card-side test runs where JAX is
missing.
"""
import types

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import ldm_inpaint as tli
from test_torch_inpaint_types import (CAM, _assert_same_cloud,  # noqa: F401
                                      _fixed_forward, _pipes, _port_state,
                                      clip)
from test_torch_ldm import (CLIP_SD15, TINY_UNET, TINY_VAE, _clip_sd,
                            _vocab_files, randomized)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

TINY = dict(steps=2, guidance=3.0, context_dim=16, context_len=4,
            unet_cfg=dict(TINY_UNET, linear_proj=False), vae_cfg=TINY_VAE)


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.models import ldm_inpaint, marigold
    return types.SimpleNamespace(jax=jax, jnp=jnp, li=ldm_inpaint,
                                 mg=marigold)


def tiny_inpainter(seed: int = 0, **kw):
    m = tli.LDMInpainter(seed=seed, **dict(TINY, **kw))
    m.init_random('cpu')
    randomized(m.unet, seed + 1)
    randomized(m.vae, seed + 2)
    return m


def jax_inpainter(jx, m):
    j = jx.li.LDMInpainter(**TINY)
    ve, vd = jx.mg.convert_vae(m.vae.state_dict(), **TINY_VAE)
    j.variables = {
        'unet': jx.mg.convert_unet(m.unet.state_dict(), block_out=(32, 64),
                                   layers_per_block=1,
                                   cross_attn=(True, False)),
        'encoder': ve, 'decoder': vd,
        'cond': jx.jnp.asarray(m.cond.numpy()),
        'uncond': jx.jnp.asarray(m.uncond.numpy())}
    return j


def jax_noise(jx, lh: int, lw: int, seed: int = 0):
    """The start noise ``LDMInpainter.__call__`` of the JAX package draws
    from ``seed``, NCHW."""
    a = jx.jax.random.normal(jx.jax.random.PRNGKey(seed), (1, lh, lw, 4),
                             jx.jnp.float32)
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


def with_jax_noise(jx, m):
    m.draw_noise = lambda lh, lw, seed=None: jax_noise(
        jx, lh, lw, m.seed if seed is None else seed)
    return m


@pytest.fixture(scope='module')
def models(jx):
    t = tiny_inpainter()
    return t, jax_inpainter(jx, t)


def _case(seed=0, h=40, w=48):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[8:20, 10:30] = 255
    mask[30:, 40:] = 1
    return img, mask


def _assert_u8_close(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert d.max() <= 1 and float((d == 0).mean()) >= 0.999


@pytest.mark.parametrize('res', [48, 24], ids=['at_size', 'resized'])
def test_ldm_inpainter_vs_jax(jx, models, res):
    """LDMInpainter on a 40x48 BGR image with a hole mask, at res 48 (no
    resize: a 20x24 latent) and at 24 (20x24 working size, a 10x12
    latent, the result resized back and composited under the hole at
    full resolution), on JAX's noise: within one level of JAX's; the
    pixels outside the hole unchanged, the hole painted."""
    t, j = models
    img, mask = _case()
    want = j(img, mask, res=res)
    rh, rw, lh, lw = t.size_for(40, 48, res)
    assert (rh, rw) == ((40, 48) if res == 48 else (20, 24))
    got = t(img, mask, res=res, noise=jax_noise(jx, lh, lw))
    _assert_u8_close(got, want)
    hole = mask > 0
    np.testing.assert_array_equal(got[~hole], img[~hole])
    assert (got[hole] != img[hole]).mean() > 0.5


def test_nearest_resize_is_cv2s():
    """The mask's resize, cv2's INTER_NEAREST index rule, on sizes down
    and up and uneven."""
    cv2 = pytest.importorskip('cv2')
    rng = np.random.RandomState(0)
    for h, w, oh, ow in ((40, 48, 20, 24), (37, 53, 64, 64),
                         (100, 77, 33, 21), (576, 1024, 72, 128),
                         (48, 64, 17, 9)):
        m = (rng.rand(h, w) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(
            tli.resize_nearest_u8(m, oh, ow),
            cv2.resize(m, (ow, oh), interpolation=cv2.INTER_NEAREST))


def test_noise_and_random_init_are_seeded():
    """draw_noise and init_random from the seed; cond at 0.02·N(0, 1),
    uncond zeros; the forward deterministic on its own noise."""
    m = tiny_inpainter()
    assert torch.equal(m.draw_noise(5, 6), m.draw_noise(5, 6))
    assert tuple(m.draw_noise(5, 6).shape) == (1, 4, 5, 6)
    assert not torch.equal(m.draw_noise(5, 6), m.draw_noise(5, 6, seed=2))
    a, b = tli.LDMInpainter(**TINY).init_random('cpu', 4), \
        tli.LDMInpainter(**TINY).init_random('cpu', 4)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not a.uncond.any() and 0.01 < float(a.cond.std()) < 0.03
    img, mask = _case(1)
    np.testing.assert_array_equal(m(img, mask), m(img, mask))


def test_load_checkpoint_vs_jax(jx, tmp_path, monkeypatch):
    """A diffusers-layout checkpoint (unet/, vae/, text_encoder/ torch
    files and tokenizer/ vocab.json + merges.txt, the text tower narrow)
    loads as JAX's: the nets equal to the JAX variables carried back;
    each prompt tokenized to the ids JAX embeds, and embedded by the
    port's CLIP tower (held against transformers' in
    tests/test_torch_ldm.py, which this file does not import)."""
    from cartoonsegmentation_torch.models import clip as tclip
    from cartoonsegmentation_torch.models.convert import (unet_from_flax,
                                                          vae_from_flax)
    src = tiny_inpainter(seed=5)
    files = {n: str(tmp_path / f'{n}.pt') for n in ('unet', 'vae', 'text')}
    text_sd = _clip_sd(CLIP_SD15, 6)
    torch.save(src.unet.state_dict(), files['unet'])
    torch.save(src.vae.state_dict(), files['vae'])
    torch.save(text_sd, files['text'])
    _vocab_files(tmp_path)
    embedded = []

    def jax_embed(sd, ids, **k):
        embedded.append(list(ids))
        return jx.jnp.zeros((1, len(ids), 32))
    monkeypatch.setattr(tli, 'SD15_TEXT', CLIP_SD15)
    monkeypatch.setattr(jx.li, 'clip_text_embed', jax_embed)
    args = (files['unet'], files['vae'], files['text'], str(tmp_path),
            'Hi, cat hi', 'cat')
    t = tli.LDMInpainter(**dict(TINY, context_len=77))
    t.load_checkpoint(*args)
    j = jx.li.LDMInpainter(**dict(TINY, context_len=77))
    j.load_checkpoint(*args)
    v = j.variables
    for want, got in ((unet_from_flax(v['unet'], t.unet), t.unet),
                      (vae_from_flax(v['encoder'], v['decoder'], t.vae),
                       t.vae)):
        for k, x in got.state_dict().items():
            assert torch.equal(x, want[k]), k
    assert len(embedded) == 2 and all(len(e) == 77 for e in embedded)
    for name, ids in zip(('cond', 'uncond'), embedded):
        want = tclip.clip_text_embed(text_sd, ids, **CLIP_SD15)
        assert torch.equal(getattr(t, name), want), name
    assert not torch.equal(t.cond, t.uncond)


@pytest.mark.parametrize('size', [64, 32], ids=['at_size', 'resized'])
def test_ldm_native_pass_vs_jax(jx, models, clip, size):  # noqa: F811
    """One inpaint pass with inpaint_type 'ldm_native' from the one JAX
    forward handed to both (48x64; ldm_inpaint_size 64 keeps it, 32
    halves it): the port's LDMInpainter gets the BGR bytes and the hole
    mask dilated by the 5-px ellipse, as JAX's; the appended cloud equal
    to JAX's; the pass timed as inpaint_ldm_native_host."""
    t, j = models
    jp, tp = _pipes(clip, inpaint_type='ldm_native',
                    ldm_inpaint_size=size)
    _fixed_forward(jp, tp, clip)
    jp._ldm_native = j
    tp.ldm_inpainter = with_jax_noise(jx, t)
    seen = []
    real = tli.LDMInpainter.forward

    def rec(self, img, mask, **k):
        seen.append((img.copy(), mask.copy(), k))
        return real(self, img, mask, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tli.LDMInpainter, 'forward', rec)
        st = tp.inpaint_pass(_port_state(clip['sj'], clip['masks'],
                                         clip['boxes']), *CAM)
    sj = jp.inpaint_pass(clip['sj'], *CAM)
    (img, mask, k), = seen
    out = clip['out']
    want_img = (np.clip(out['image'], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img, want_img)
    hole = out['existing'][..., 0] == 0
    assert k == {'res': size}
    assert (mask[hole] == 255).all() and (mask > 0).sum() > hole.sum()
    _assert_same_cloud(st.cloud, sj.cloud)
    assert tp.timer.counts['inpaint_ldm_native_host'] == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('res', [48, 24], ids=['at_size', 'resized'])
def test_ldm_inpainter_card_vs_cpu(cuda, res):
    """The tiny inpainter in f32 on the card (TF32 off) against the CPU
    on the same host-drawn noise: within one level, >= 99.9% equal."""
    m = tiny_inpainter()
    img, mask = _case()
    noise = m.draw_noise(*m.size_for(40, 48, res)[2:])
    want = m(img, mask, res=res, noise=noise)
    got = m.to(cuda)(img, mask, res=res, noise=noise)
    _assert_u8_close(got, want)
