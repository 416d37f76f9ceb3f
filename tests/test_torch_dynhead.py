"""K9t, the dynamic mask heads of the detector loss, forward and
backward (cartoonsegmentation_torch/csrc/dynhead_fwd.cu, dynhead_bwd.cu).

On the CPU:
- the plain version (``dynamic_mask_heads`` under autograd) against the
  JAX package's ``dynamic_mask_heads`` and its ``jax.vjp`` on one random
  cotangent: logits within 1e-6, gradients within 1e-5 of their largest
  magnitude;
- the launch plans (``dynhead_fwd_plan``, ``dynhead_bwd_plan``) at the
  training shape, and the forward's plan writing each logit once;
- the kernels' plans emulated in numpy f32 as they run them (``emulate``):
  the forward's fused layers, the backward's tiles, pixel slots and
  their tree, its layers 1-2 in the plain version's rounding, the
  instance order of d mask_feat and the tile order of d kernels. FMA is
  emulated in float64 (an ulp off __fmaf_rn at rare ties), so the
  logits are held within 1e-6 of the plain version's range and the
  gradients within 1e-5 of its largest magnitude; the backward's
  recomputed layers give the plain logits bit for bit.
On the card (marked ``gpu``): the kernels against the plain version at
the training shape (B = 8, K = 8, 80x80), K = 1, B = 1, a ragged tile
and K = 10, two backward calls bit-equal, one launch each. JAX is
imported only inside the CPU tests:

    python -m pytest --noconftest -m gpu tests/test_torch_dynhead.py
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.ops import _cuda
from torch_cpu import torch_threads  # noqa: F401  (autouse)

F32 = np.float32


def _case(rng, B, K, h, w):
    """Inputs with the detector's scales: features O(1), parameters at
    ~1/sqrt(fan-in), priors on the stride grids of an 8h x 8w image."""
    feat = rng.randn(B, h, w, 8).astype(F32)
    kern = (rng.randn(B, K, 169) * 0.4).astype(F32)
    strides = rng.choice([8.0, 16.0, 32.0], (B, K)).astype(F32)
    priors = np.stack([rng.randint(0, w, (B, K)), rng.randint(0, h, (B, K))],
                      -1).astype(F32) * 8.0
    dlog = rng.randn(B, K, h, w).astype(F32)
    return feat, kern, priors, strides, dlog


def _plain(feat, kern, priors, strides, dlog):
    """The plain version's logits and autograd gradients (f, k)."""
    f = torch.from_numpy(feat).requires_grad_()
    k = torch.from_numpy(kern).requires_grad_()
    out = trtmdet.dynamic_mask_heads_train(f, k, torch.from_numpy(priors),
                                           torch.from_numpy(strides))
    out.backward(torch.from_numpy(dlog))
    return out.detach().numpy(), f.grad.numpy(), k.grad.numpy()


def _within(got, want, tol):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def test_plain_against_jax_and_its_vjp():
    """The plain logits within 1e-6 of JAX's (one image at a time, as
    the loss calls it) and the autograd gradients within 1e-5 of the
    largest magnitude of JAX's vjp."""
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.models import rtmdet as jrtmdet
    rng = np.random.RandomState(0)
    feat, kern, priors, strides, dlog = _case(rng, 2, 5, 12, 16)
    out, gf, gk = _plain(feat, kern, priors, strides, dlog)
    for b in range(2):
        fn = jax.jit(lambda f, k, b=b: jrtmdet.dynamic_mask_heads(
            f, k, jnp.asarray(priors[b]), jnp.asarray(strides[b])))
        want, vjp = jax.vjp(fn, jnp.asarray(feat[b]), jnp.asarray(kern[b]))
        jf, jk = vjp(jnp.asarray(dlog[b]))
        assert float(np.abs(out[b] - np.asarray(want)).max()) <= 1e-6 * max(
            1.0, float(np.abs(np.asarray(want)).max()))
        _within(gf[b], np.asarray(jf), 1e-5)
        _within(gk[b], np.asarray(jk), 1e-5)


def fma(a, b, c):
    """f32 fused multiply-add, in float64: the product is exact there and
    the sum rounds twice (to f64, then f32), which misses the single
    rounding of __fmaf_rn only at rare ties, an ulp apart."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _relu(a):
    return np.where(a > 0, a, F32(0))


def _pixels(feat, b, n, p, priors, strides, w):
    """The inputs [rel_x, rel_y, feat] (len(p), 10) of pixels p of image
    b under instance n: a true f32 division (the kernels multiply by the
    exact reciprocal when stride · 8 is a power of two: the same bits)."""
    s8 = strides[b, n] * F32(8)
    cx = (p % w).astype(F32) * F32(8)
    cy = (p // w).astype(F32) * F32(8)
    return np.concatenate([((priors[b, n, 0] - cx) / s8)[:, None],
                           ((priors[b, n, 1] - cy) / s8)[:, None],
                           feat[b].reshape(-1, 8)[p]], 1)


def _hidden(x, k, fused):
    """Layers 1-2 as the kernels compute them: fused, as dynhead_fwd.cu
    does (each output from its bias, the inputs' products added in order
    by FMA), or in the plain version's rounding, as dynhead_bwd.cu does
    (the first product, each further rounded product added in order,
    then the bias); then ReLU."""
    def unit(v, w, bias):
        if fused:
            acc = np.full(len(v), bias, F32)
            for c in range(v.shape[1]):
                acc = fma(v[:, c], w[c], acc)
            return acc
        acc = v[:, 0] * w[0]
        for c in range(1, v.shape[1]):
            acc = acc + v[:, c] * w[c]
        return acc + bias
    h1 = np.stack([_relu(unit(x, k[o * 10:o * 10 + 10], k[152 + o]))
                   for o in range(8)], 1)
    h2 = np.stack([_relu(unit(h1, k[80 + o * 8:88 + o * 8], k[160 + o]))
                   for o in range(8)], 1)
    return h1, h2


def _plain_order_logits(feat, kern, priors, strides):
    """The logits from the backward's layers 1-2 (the plain version's
    rounding) and layer 3 in the same rounding: equal to the plain
    version's bit for bit, so the backward's ReLU masks are its masks."""
    B, h, w, _ = feat.shape
    K = kern.shape[1]
    out = np.zeros((B, K, h * w), F32)
    for b in range(B):
        for n in range(K):
            k = kern[b, n]
            x = _pixels(feat, b, n, np.arange(h * w), priors, strides, w)
            _, h2 = _hidden(x, k, False)
            acc = h2[:, 0] * k[144]
            for c in range(1, 8):
                acc = acc + h2[:, c] * k[144 + c]
            out[b, n] = acc + k[168]
    return out.reshape(B, K, h, w)


def fwd_cover(B, K, h, w, sms):
    """How many times csrc/dynhead_fwd.cu's plan on ``sms`` SMs writes
    each logit: a warp an (image, instance, chunk of dynhead_fwd_plan),
    lane l pixels l, l + 32, ... of the chunk."""
    hw = h * w
    chunk, chunks = trtmdet.dynhead_fwd_plan(B, K, hw, sms)
    count = np.zeros((B * K, hw), np.int64)
    for blk in range(B * K * chunks):
        bn, q0 = blk // chunks, blk % chunks * chunk
        for lane in range(32):
            q = np.arange(q0 + lane, min(hw, q0 + chunk), 32)
            np.add.at(count[bn], q, 1)
    return count


def emulate(feat, kern, priors, strides, dlog, sms):
    """K9t's kernels in numpy f32 on the plans of a card of ``sms`` SMs:
    (logits, d feat, d kern). The logits as dynhead_fwd.cu's lanes
    compute them. The backward as dynhead_bwd.cu's: a block a tile of
    ``dynhead_bwd_plan`` of one image; for each instance, layers 1-2 in
    the plain version's rounding, 8 pixel slots, slot p taking pixels p,
    p + 8, ... of the tile and adding each parameter's product to its
    sum by FMA in that order (a bias's gradient by an add); the slots by
    the tree ^1, ^2, ^4; the gradients through the layers and the feature
    gradient of each (pixel, instance) from zero by FMA over the layer's
    units in order, the instances added in order; the tiles' partials
    in tile order."""
    B, h, w, _ = feat.shape
    K = kern.shape[1]
    hw = h * w
    tile, tiles = trtmdet.dynhead_bwd_plan(B, K, hw, sms)
    logits = np.zeros((B, K, hw), F32)
    dfeat = np.zeros((B, hw, 8), F32)
    partials = np.zeros((B, K, tiles, 169), F32)
    slots = np.arange(8)
    for b in range(B):
        for n in range(K):
            k = kern[b, n]
            x = _pixels(feat, b, n, np.arange(hw), priors, strides, w)
            _, h2 = _hidden(x, k, True)
            out = np.full(hw, k[168], F32)
            for c in range(8):
                out = fma(h2[:, c], k[144 + c], out)
            logits[b, n] = out
        for t in range(tiles):
            p = np.arange(t * tile, min(hw, (t + 1) * tile))
            df = None
            for n in range(K):
                k = kern[b, n]
                x = _pixels(feat, b, n, p, priors, strides, w)
                h1, h2 = _hidden(x, k, False)
                g = dlog[b, n].reshape(hw)[p]
                d2 = np.where(h2 > 0, g[:, None] * k[144:152][None], F32(0))
                s = np.zeros((len(p), 8), F32)
                for o in range(8):
                    s = fma(d2[:, o:o + 1], k[80 + o * 8:88 + o * 8][None], s)
                d1 = np.where(h1 > 0, s, F32(0))
                dfn = np.zeros((len(p), 8), F32)
                for o in range(8):
                    dfn = fma(d1[:, o:o + 1], k[o * 10 + 2:o * 10 + 10][None],
                              dfn)
                df = dfn if df is None else df + dfn
                # each pixel's 169 (left, right) factors; the biases' 17
                # are added, not multiplied
                X = np.concatenate([np.repeat(d1, 10, 1), np.repeat(d2, 8, 1),
                                    np.repeat(g[:, None], 8, 1), d1, d2,
                                    g[:, None]], 1)
                Y = np.concatenate([np.tile(x, (1, 8)), np.tile(h1, (1, 8)),
                                    h2], 1)
                acc = np.zeros((8, 169), F32)
                for r in range(-(-len(p) // 8)):
                    q = r * 8 + slots
                    live = q < len(p)
                    qq = np.minimum(q, len(p) - 1)
                    step = np.concatenate([fma(X[qq, :152], Y[qq], acc[:, :152]),
                                           acc[:, 152:] + X[qq, 152:]], 1)
                    acc = np.where(live[:, None], step, acc)
                for m in (1, 2, 4):
                    acc = acc + acc[slots ^ m]
                partials[b, n, t] = acc[0]
            dfeat[b, p] = df
    dkern = partials[:, :, 0].copy()
    for t in range(1, tiles):
        dkern = dkern + partials[:, :, t]
    return logits.reshape(B, K, h, w), dfeat.reshape(B, h, w, 8), dkern


def test_launch_plans():
    """The plans at the training shape on 132 SMs: the forward 16 chunks
    of 416 pixels an instance (1,024 warps), the backward 48 tiles of
    136 pixels an image (384 blocks, three an SM); chunks in whole
    rounds of 32, tiles in whole steps of 8 and at most 256 pixels, both
    covering the image."""
    assert trtmdet.dynhead_fwd_plan(8, 8, 6400, 132) == (416, 16)
    assert trtmdet.dynhead_bwd_plan(8, 8, 6400, 132) == (136, 48)
    for B, K, hw, sms in ((1, 1, 6400, 132), (8, 8, 377, 132),
                          (1, 3, 160 * 160, 4), (64, 20, 6400, 132)):
        chunk, chunks = trtmdet.dynhead_fwd_plan(B, K, hw, sms)
        assert chunk % 32 == 0 and (chunks - 1) * chunk < hw <= chunks * chunk
        tile, tiles = trtmdet.dynhead_bwd_plan(B, K, hw, sms)
        assert tile % 8 == 0 and 8 <= tile <= 256
        assert (tiles - 1) * tile < hw <= tiles * tile


@pytest.mark.parametrize('shape,sms', [((1, 3, 5, 7), 132),
                                       ((2, 10, 9, 11), 2),
                                       ((3, 8, 40, 40), 132)])
def test_forward_plan_writes_each_logit_once(shape, sms):
    """dynhead_fwd.cu's warps, lanes and pixels write every logit once:
    two chunks of 32 pixels for 35, one chunk of 128 for 99, 25 chunks
    of 64 for 1,600."""
    assert (fwd_cover(*shape, sms) == 1).all()


@pytest.mark.parametrize('shape,sms', [((2, 3, 16, 16), 132),
                                       ((2, 3, 16, 16), 3),
                                       ((1, 4, 13, 29), 132),
                                       ((1, 10, 9, 11), 2)])
def test_kernel_plan_emulated_against_plain(shape, sms):
    """The backward's layers 1-2 in the plain version's rounding give its
    logits bit for bit (its ReLU masks are the plain version's); the
    emulated forward's logits within 1e-6 of the plain version's range
    (FMA from the bias where the plain version adds rounded products,
    then the bias), the emulated gradients within 1e-5 of the plain
    version's largest magnitude: 16x16 in 32 tiles of 8 pixels on 132
    SMs and in 6 tiles of 48 on 3 (the last 16 pixels); 13x29 in 48
    tiles of 8, the last one pixel (seven slots idle); K = 10 on 2 SMs,
    two groups of instances (8, then 2) over 5 tiles of 24, the last
    3."""
    rng = np.random.RandomState(1)
    args = _case(rng, *shape)
    out, gf, gk = _plain(*args)
    lo, ef, ek = emulate(*args, sms)
    assert np.array_equal(_plain_order_logits(*args[:4]), out)
    assert float(np.abs(lo - out).max()) <= 1e-6 * float(out.max() - out.min())
    _within(ef, gf, 1e-5)
    _within(ek, gk, 1e-5)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    before = dict(_cuda.LAUNCHES)
    rng = np.random.RandomState(2)
    _plain(*_case(rng, 1, 2, 8, 8))
    assert _cuda.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('shape', [(8, 8, 80, 80), (3, 5, 13, 29),
                                   (8, 1, 80, 80), (1, 8, 80, 80),
                                   (1, 1, 13, 29), (2, 10, 24, 40)])
def test_kernels_against_plain(cuda, shape):
    """Logits within 1e-5 of their range, gradients within 1e-4 of their
    largest magnitude; one launch each way; two backward calls bit-equal."""
    rng = np.random.RandomState(3)
    args = _case(rng, *shape)
    out, gf, gk = _plain(*args)
    feat, kern, priors, strides, dlog = (torch.from_numpy(a).to(cuda)
                                         for a in args)
    f = feat.clone().requires_grad_()
    k = kern.clone().requires_grad_()
    before = dict(_cuda.LAUNCHES)
    logits = trtmdet.dynamic_mask_heads_train(f, k, priors, strides)
    logits.backward(dlog)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['dynhead_fwd'] == before['dynhead_fwd'] + 1
    assert _cuda.LAUNCHES['dynhead_bwd'] == before['dynhead_bwd'] + 1
    got = logits.detach().cpu().numpy()
    assert float(np.abs(got - out).max()) <= 1e-5 * float(out.max() - out.min())
    _within(f.grad.cpu().numpy(), gf, 1e-4)
    _within(k.grad.cpu().numpy(), gk, 1e-4)
    again = trtmdet.dynhead_backward(feat, kern, priors, strides, dlog)
    assert torch.equal(again[0], f.grad) and torch.equal(again[1], k.grad)
