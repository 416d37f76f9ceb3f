"""The port's latent-diffusion backbone (``models/ldm.py``), its CLIP text
tower and tokenizer (``models/clip.py``) and the UNet and VAE
converters against the JAX package's, on the CPU in f32.

The nets run at the tiny geometry of tests/test_marigold.py and
tests/test_ldm_inpaint.py (block_out (32, 64), one resnet a level,
context width 16). Their weights are drawn in the port
(``randomized``) and go to Flax through the JAX package's
``convert_unet`` / ``convert_vae`` (the port keeps diffusers' key
names, so its state dict is a checkpoint); ``unet_from_flax`` /
``vae_from_flax`` bring them back bit for bit. Tolerances: the nets'
outputs within 1e-5 of their largest magnitude (measured ~1e-6), the
CLIP towers within 1e-5 of theirs, the scheduler steps within 1e-6
relative; the tables, the converters' round trip and the token ids are
exact. JAX is imported only inside the fixtures and tests that run it
(``jx``), so the card-side test runs where JAX is missing.
"""
import json
import types

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import clip as tclip
from cartoonsegmentation_torch.models import ldm as tl
from cartoonsegmentation_torch.models.convert import (unet_from_flax,
                                                      vae_from_flax)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

TINY_UNET = dict(out_ch=4, block_out=(32, 64), layers_per_block=1,
                 heads=(1, 2), cross_attn=(True, False))
TINY_VAE = dict(block_out=(32, 64), layers_per_block=1)
NET_TOL = 1e-5          # share of the output's largest magnitude
# narrow CLIP towers in both activations (the vocab stays CLIP's 49,408)
CLIP_SD15 = dict(hidden=32, num_layers=2, heads=4, act='quick_gelu')
CLIP_SD2 = dict(hidden=32, num_layers=3, heads=2, act='gelu')


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.models import ldm, ldm_inpaint, marigold
    return types.SimpleNamespace(jax=jax, jnp=jnp, ldm=ldm, mg=marigold,
                                 li=ldm_inpaint)


def randomized(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``init_random_`` from ``seed``, then every vector (biases, norm
    scales) moved by 0.1·N(0, 1), so that none is 0 or 1."""
    gen = torch.Generator().manual_seed(seed)
    tl.init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module.eval()


def tiny_unet(linear_proj: bool, in_ch: int = 8, seed: int = 0):
    return randomized(tl.UNet2DCondition(
        in_ch=in_ch, linear_proj=linear_proj, context_dim=16, **TINY_UNET),
        seed)


def tiny_vae(seed: int = 1):
    return randomized(tl.AutoencoderKL(**TINY_VAE), seed)


def jax_unet_vars(jx, unet):
    return jx.mg.convert_unet(unet.state_dict(), block_out=(32, 64),
                              layers_per_block=1, cross_attn=(True, False))


def _close(got, want, tol=NET_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_timestep_embedding_vs_jax(jx):
    """[cos | sin] of t · freqs: within 1e-4 (a phase reaches 999 rad,
    where one f32 ulp of a frequency, as XLA and torch round exp, moves
    it by up to ~6e-5; measured 5.7e-5), exact at t = 0."""
    t = np.array([0, 1, 250, 999], np.int32)
    want = np.asarray(jx.ldm.timestep_embedding(jx.jnp.asarray(t), 320))
    got = tl.timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize('linear_proj', [True, False],
                         ids=['linear_sd2', 'conv_sd15'])
def test_unet_vs_jax(jx, linear_proj):
    """UNet2DCondition in both projection modes (SD2's Linear, SD1.5's
    1x1 convs and 9 input channels) at 8x8 against the JAX UNet on the
    converted weights, timesteps 3 and 977."""
    in_ch = 8 if linear_proj else 9
    unet = tiny_unet(linear_proj, in_ch)
    rng = np.random.RandomState(0)
    x = rng.randn(2, in_ch, 8, 8).astype(np.float32)
    t = np.array([3, 977], np.int32)
    ctx = rng.randn(2, 3, 16).astype(np.float32)
    model = jx.ldm.UNet2DCondition(linear_proj=linear_proj, **TINY_UNET)
    want = model.apply(jax_unet_vars(jx, unet),
                       jx.jnp.asarray(x.transpose(0, 2, 3, 1)),
                       jx.jnp.asarray(t), jx.jnp.asarray(ctx))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    assert tuple(got.shape) == (2, 4, 8, 8)
    _close(_nhwc(got), want)


def test_vae_vs_jax(jx):
    """The VAE's encoder (mean and logvar, through quant_conv) at 16x16
    and its decoder (through post_quant_conv) at an 8x8 latent."""
    vae = tiny_vae()
    ve, vd = jx.mg.convert_vae(vae.state_dict(), **TINY_VAE)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 3, 16, 16).astype(np.float32)
    z = rng.randn(1, 4, 8, 8).astype(np.float32)
    mean, logvar = jx.ldm.AutoencoderEncoder(**TINY_VAE).apply(
        ve, jx.jnp.asarray(x.transpose(0, 2, 3, 1)))
    dec = jx.ldm.AutoencoderDecoder(**TINY_VAE).apply(
        vd, jx.jnp.asarray(z.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        tm, tv = vae.encode(torch.from_numpy(x))
        td = vae.decode(torch.from_numpy(z))
    assert tuple(tm.shape) == (1, 4, 8, 8) and tuple(td.shape) == \
        (1, 3, 16, 16)
    _close(_nhwc(tm), mean)
    _close(_nhwc(tv), logvar)
    _close(_nhwc(td), dec)


@pytest.mark.parametrize('net', ['unet_linear', 'unet_conv', 'vae'])
def test_converters_round_trip_exact(jx, net):
    """port → Flax (the JAX converters) → port gives back every tensor
    bit for bit, and every key."""
    if net == 'vae':
        module = tiny_vae()
        ve, vd = jx.mg.convert_vae(module.state_dict(), **TINY_VAE)
        back = vae_from_flax(ve, vd, module)
    else:
        module = tiny_unet(net == 'unet_linear')
        back = unet_from_flax(jax_unet_vars(jx, module), module)
    own = module.state_dict()
    assert sorted(back) == sorted(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def _legacy(sd):
    """The VAE state dict in the legacy attention names (query, key,
    value, proj_attn with 1x1-conv weights; norm for group_norm)."""
    names = {'to_q': 'query', 'to_k': 'key', 'to_v': 'value',
             'to_out.0': 'proj_attn', 'group_norm': 'norm'}
    out = {}
    for k, v in sd.items():
        head, _, tail = k.partition('.attentions.0.')
        if tail:
            name, _, leaf = tail.rpartition('.')
            if name != 'group_norm' and leaf == 'weight':
                v = v[:, :, None, None]
            k = f'{head}.attentions.0.{names[name]}.{leaf}'
        out[k] = v
    return out


def test_legacy_vae_keys(jx):
    """A VAE state dict in the legacy attention names loads into the
    port's VAE as the modern one does, and converts in JAX to the same
    tree."""
    vae = tiny_vae()
    sd = vae.state_dict()
    legacy = _legacy(sd)
    assert any('.proj_attn.' in k for k in legacy)
    mapped = tl.vae_state_dict(legacy)
    assert sorted(mapped) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(mapped[k], v), k
    fresh = tl.AutoencoderKL(**TINY_VAE)
    fresh.load_state_dict(mapped)
    want = jx.mg.convert_vae(sd, **TINY_VAE)
    got = jx.mg.convert_vae({k: v.numpy() for k, v in legacy.items()},
                            **TINY_VAE)
    flat = jx.jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(want), flat(got)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_projection_weights_either_layout():
    """A projection given as 1x1-conv weights loads into a Linear
    projection, and Linear weights into a conv one (``fit_proj_weights``,
    the JAX package's ``_proj``)."""
    lin, conv = tiny_unet(True), tiny_unet(False)
    for src, dst in ((conv, lin), (lin, conv)):
        sd = tl.fit_proj_weights(src.state_dict(), dst)
        dst.load_state_dict(sd)
        key = 'down_blocks.0.attentions.0.proj_in.weight'
        assert torch.equal(dst.state_dict()[key].flatten(),
                           src.state_dict()[key].flatten())


@pytest.mark.parametrize('n,spacing,offset', [
    (4, 'trailing', 0), (10, 'trailing', 0), (32, 'leading', 1),
    (10, 'leading', 0), (50, 'leading', 1)])
def test_scheduler_tables_vs_jax(jx, n, spacing, offset):
    np.testing.assert_array_equal(tl.make_alphas_cumprod(),
                                  jx.ldm.make_alphas_cumprod())
    got = tl.spaced_timesteps(n, spacing=spacing, steps_offset=offset)
    want = jx.ldm.spaced_timesteps(n, spacing=spacing, steps_offset=offset)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('kw', [
    dict(prediction_type='v'),
    dict(prediction_type='epsilon'),
    dict(prediction_type='epsilon', spacing='leading', steps_offset=1,
         set_alpha_to_one=False)], ids=['v', 'eps', 'sd15'])
def test_ddim_steps_vs_jax(jx, kw):
    """Every step of a 10-step DDIM, the last (alpha 1, or
    alpha_cumprod[0] for SD1.x) included."""
    rng = np.random.RandomState(2)
    sj, st = jx.ldm.DDIMScheduler(10, **kw), tl.DDIMScheduler(10, **kw)
    assert st.final_alpha == sj.final_alpha
    for i in range(10):
        out, x = rng.randn(2, 4, 4, 4).astype(np.float32) * 3, \
            rng.randn(2, 4, 4, 4).astype(np.float32)
        want = np.asarray(sj.step(jx.jnp.asarray(out), i, jx.jnp.asarray(x)))
        got = st.step(torch.from_numpy(out), i, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('pred', ['v', 'epsilon'])
def test_lcm_steps_vs_jax(jx, pred):
    """Every step of a 4-step LCM, the port given the noise JAX draws
    from each step's key; the last step returns the denoised estimate."""
    rng = np.random.RandomState(3)
    sj, st = jx.ldm.LCMScheduler(4, prediction_type=pred), \
        tl.LCMScheduler(4, prediction_type=pred)
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(5), 4)
    for i in range(4):
        out, x = rng.randn(2, 4, 4, 4).astype(np.float32), \
            rng.randn(2, 4, 4, 4).astype(np.float32)
        want = np.asarray(sj.step(jx.jnp.asarray(out), i, jx.jnp.asarray(x),
                                  keys[i]))
        noise = np.array(jx.jax.random.normal(keys[i], x.shape))
        got = st.step(torch.from_numpy(out), i, torch.from_numpy(x),
                      torch.from_numpy(noise) if i < 3 else None)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _clip_sd(cfg, seed):
    model = tclip.ClipTextModel(**cfg)
    randomized(model, seed)
    return model.state_dict()


@pytest.mark.parametrize('which', ['sd15_quick_gelu', 'sd2_gelu'])
def test_clip_tower_vs_jax(jx, which):
    """The port's CLIP tower against transformers' CLIPTextModel as the
    JAX package runs it: ``clip_text_embed`` (SD1.5's quick_gelu) on a
    77-token prompt, ``empty_text_embed_from_clip`` (SD2's gelu) on the
    empty prompt; the state dict with its ``text_model.`` prefix."""
    from cartoonsegmentation_torch.models.marigold import empty_text_embed
    if which == 'sd15_quick_gelu':
        cfg = CLIP_SD15
        sd = _clip_sd(cfg, 4)
        ids = [49406, 320, 1125, 539, 49407] + [49407] * 72
        want = jx.li.clip_text_embed(sd, ids, hidden=32, num_layers=2,
                                     heads=4)
        got = tclip.clip_text_embed(sd, ids, **cfg)
        assert tuple(got.shape) == (1, 77, 32)
    else:
        cfg = CLIP_SD2
        sd = _clip_sd(cfg, 5)
        want = jx.mg.empty_text_embed_from_clip(sd, num_layers=3, hidden=32,
                                                heads=2)
        got = empty_text_embed(sd, num_layers=3, hidden=32, heads=2)
        assert tuple(got.shape) == (1, 2, 32)
    _close(got.numpy(), want)


def test_clip_refuses_wrong_schema(jx):
    """A state dict whose keys match under 90% of the tower's tensors
    raises in both packages."""
    sd = {f'model.{k}': v for k, v in _clip_sd(CLIP_SD15, 6).items()}
    with pytest.raises(ValueError, match='matched only'):
        tclip.clip_text_embed(sd, [49406, 49407], **CLIP_SD15)
    with pytest.raises(ValueError, match='matched only'):
        jx.li.clip_text_embed(sd, [49406, 49407], hidden=32, num_layers=2,
                              heads=4)


def _vocab_files(tmp_path):
    """tests/test_ldm_inpaint.py's vocabulary: the 512 byte units (with
    and without </w>), three merges, the two specials."""
    b2u = tclip._bytes_to_unicode()
    vocab = {}
    for u in b2u.values():
        vocab[u] = len(vocab)
    for u in b2u.values():
        vocab[u + '</w>'] = len(vocab)
    merges = []
    for pair, merged in ((('h', 'i</w>'), 'hi</w>'), (('c', 'a'), 'ca'),
                         (('ca', 't</w>'), 'cat</w>')):
        merges.append(f'{pair[0]} {pair[1]}')
        vocab[merged] = len(vocab)
    vocab['<|startoftext|>'] = len(vocab)
    vocab['<|endoftext|>'] = len(vocab)
    (tmp_path / 'vocab.json').write_text(json.dumps(vocab))
    (tmp_path / 'merges.txt').write_text(
        '#version: 0.2\n' + '\n'.join(merges) + '\n')
    return str(tmp_path / 'vocab.json'), str(tmp_path / 'merges.txt')


@pytest.mark.parametrize('text', [
    'Hi, cat hi', '', 'high quality, masterpiece, no_humans',
    "cat's   hat\tisn't 1girl! ÿ é", 'a ' * 90])
def test_tokenizer_ids_equal_jax(jx, tmp_path, text):
    files = _vocab_files(tmp_path)
    assert tclip._bytes_to_unicode() == jx.li._bytes_to_unicode()
    got = tclip.ClipTokenizer(*files).encode(text)
    assert got == jx.li.ClipTokenizer(*files).encode(text)
    assert len(got) == 77 and got[-1] == got[0] + 1     # eos, bos
    assert tclip.ClipTokenizer(*files).encode(text, 9) == \
        jx.li.ClipTokenizer(*files).encode(text, 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('linear_proj', [True, False],
                         ids=['linear_sd2', 'conv_sd15'])
def test_backbone_card_vs_cpu(cuda, linear_proj):
    """The tiny UNet, VAE and CLIP tower in f32 on the card (TF32 off)
    against the CPU, within NET_TOL of the output's largest magnitude."""
    unet, vae = tiny_unet(linear_proj, 8), tiny_vae()
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 8, 16, 16).astype(np.float32))
    t = torch.tensor([3, 977])
    ctx = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    img = torch.from_numpy(rng.randn(1, 3, 32, 32).astype(np.float32))
    sd = _clip_sd(CLIP_SD15, 7)
    ids = [49406, 320, 49407]
    with torch.no_grad():
        want = [unet(x, t, ctx), *vae.encode(img), vae.decode(x[:1, :4]),
                tclip.clip_text_embed(sd, ids, **CLIP_SD15)]
        unet, vae = unet.to(cuda), vae.to(cuda)
        got = [unet(x.to(cuda), t.to(cuda), ctx.to(cuda)),
               *vae.encode(img.to(cuda)), vae.decode(x[:1, :4].to(cuda)),
               tclip.clip_text_embed(sd, ids, device=cuda, **CLIP_SD15)]
    for g, w in zip(got, want):
        _close(g.cpu().numpy(), w.numpy())
