"""K9t, the dynamic mask heads of the detector loss, forward and
backward (cartoonsegmentation_torch/csrc/dynhead_fwd.cu, dynhead_bwd.cu).

On the CPU:
- the plain version (``dynamic_mask_heads`` under autograd) against the
  JAX package's ``dynamic_mask_heads`` and its ``jax.vjp`` on one random
  cotangent: logits within 1e-6, gradients within 1e-5 of their largest
  magnitude;
- the kernels' plan emulated in numpy f32 as they run it: a block a
  tile of 256 pixels of one image, a thread a pixel; each instance's
  forward recomputed, the pixel's backward, the feature gradient summed
  over the instances in order; each parameter's partial summed over the
  tile's pixels in pixel order (zeros past the last pixel), then over
  the tiles in order. Its logits equal the plain version's bit for bit
  (the same operations, one rounding each, as -fmad=false keeps them),
  its gradients within 1e-5 of the plain version's largest magnitude.
On the card (marked ``gpu``): the kernels against the plain version at
the training shapes (B = 8, K = 8, 80x80) and a ragged tile, two
backward calls bit-equal, one launch each. JAX is imported only inside
the CPU tests:

    python -m pytest --noconftest -m gpu tests/test_torch_dynhead.py
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.ops import _cuda
from torch_cpu import torch_threads  # noqa: F401  (autouse)

F32 = np.float32
TILE = trtmdet.DYNHEAD_TILE


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


def emulate(feat, kern, priors, strides, dlog):
    """K9t's two kernels in numpy f32: (logits, d feat, d kern)."""
    B, h, w, _ = feat.shape
    K = kern.shape[1]
    hw = h * w
    tiles = -(-hw // TILE)
    logits = np.zeros((B, K, hw), F32)
    dfeat = np.zeros((B, hw, 8), F32)
    partials = np.zeros((B, K, tiles, 169), F32)
    relu = lambda a: np.where(a > 0, a, F32(0))  # noqa: E731
    for b in range(B):
        for t in range(tiles):
            p = np.arange(t * TILE, min(hw, (t + 1) * TILE))
            n_live = len(p)
            cx = (p % w).astype(F32) * F32(8)
            cy = (p // w).astype(F32) * F32(8)
            f = feat[b].reshape(hw, 8)[p]
            df = np.zeros((n_live, 8), F32)
            for n in range(K):
                k = kern[b, n]
                s8 = strides[b, n] * F32(8)
                x = np.concatenate([((priors[b, n, 0] - cx) / s8)[:, None],
                                    ((priors[b, n, 1] - cy) / s8)[:, None],
                                    f], 1)
                a1 = np.zeros((n_live, 8), F32)
                for o in range(8):
                    acc = x[:, 0] * k[o * 10]
                    for c in range(1, 10):
                        acc = acc + x[:, c] * k[o * 10 + c]
                    a1[:, o] = acc + k[152 + o]
                h1 = relu(a1)
                a2 = np.zeros((n_live, 8), F32)
                for o in range(8):
                    acc = h1[:, 0] * k[80 + o * 8]
                    for c in range(1, 8):
                        acc = acc + h1[:, c] * k[80 + o * 8 + c]
                    a2[:, o] = acc + k[160 + o]
                h2 = relu(a2)
                out = h2[:, 0] * k[144]
                for c in range(1, 8):
                    out = out + h2[:, c] * k[144 + c]
                logits[b, n, p] = out + k[168]
                g = dlog[b, n].reshape(hw)[p]
                d2 = np.where(a2 > 0, g[:, None] * k[144:152][None], F32(0))
                d1 = np.zeros((n_live, 8), F32)
                for c in range(8):
                    acc = d2[:, 0] * k[80 + c]
                    for o in range(1, 8):
                        acc = acc + d2[:, o] * k[80 + o * 8 + c]
                    d1[:, c] = np.where(a1[:, c] > 0, acc, F32(0))
                for c in range(8):
                    acc = d1[:, 0] * k[2 + c]
                    for o in range(1, 8):
                        acc = acc + d1[:, o] * k[o * 10 + 2 + c]
                    df[:, c] = df[:, c] + acc
                # the tile's rows, zero past its last pixel
                pad = lambda a: np.concatenate(  # noqa: E731
                    [a, np.zeros((TILE - n_live,) + a.shape[1:], F32)])
                X = np.concatenate([
                    np.repeat(pad(d1), 10, 1),                     # W1 rows
                    np.repeat(pad(d2), 8, 1),                      # W2
                    np.repeat(pad(g[:, None]), 8, 1),              # W3
                    pad(d1), pad(d2), pad(g[:, None])], 1)         # biases
                Y = np.concatenate([
                    np.tile(pad(x), (1, 8)), np.tile(pad(h1), (1, 8)),
                    pad(h2), np.ones((TILE, 17), F32)], 1)
                acc = np.zeros(169, F32)
                bias = np.arange(169) >= 152
                for q in range(TILE):
                    acc = acc + np.where(bias, X[q], X[q] * Y[q])
                partials[b, n, t] = acc
            dfeat[b, p] = df
    dkern = np.zeros((B, K, 169), F32)
    for t in range(tiles):
        dkern = dkern + partials[:, :, t]
    return logits.reshape(B, K, h, w), dfeat.reshape(B, h, w, 8), dkern


@pytest.mark.parametrize('shape', [(2, 3, 16, 16), (1, 4, 13, 29)])
def test_kernel_plan_emulated_against_plain(shape):
    """The emulated plan's logits bit-equal to the plain version's, its
    gradients within 1e-5 of the plain version's largest magnitude; at
    16x16 one whole tile, at 13x29 a ragged second tile."""
    rng = np.random.RandomState(1)
    args = _case(rng, *shape)
    out, gf, gk = _plain(*args)
    lo, ef, ek = emulate(*args)
    assert np.array_equal(lo, out)
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
@pytest.mark.parametrize('shape', [(8, 8, 80, 80), (3, 5, 13, 29)])
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
