"""The port's background fill (K13) against the JAX package's
``ops/inpaint_fill.py`` on the CPU.

Tolerances: push-pull within 1e-6 absolute (the 2x2 sums and the
upsample in another order; measured 2.4e-7); the jitter refine fed
JAX's own offsets byte-equal; the uint8 ``inpaint`` with JAX's offsets
equal outside the hole and >= 99.9% equal inside (a push-pull value
within 1e-7 of a uint8 step may truncate to the next one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.ops import inpaint_fill as jfill
from cartoonsegmentation_torch.ops import inpaint_fill as tfill
from torch_cpu import torch_threads  # noqa: F401  (autouse)


def jax_offsets(h, w, seed=0, iters=2):
    """The offsets jitter_refine draws inside: PRNGKey(seed), one split
    an iteration and radius, randint((2, h, w), -r, r + 1)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        per = []
        for r in (4, 8, 16, 32):
            key, k1 = jax.random.split(key)
            per.append(np.asarray(jax.random.randint(k1, (2, h, w), -r,
                                                     r + 1)))
        out.append(np.stack(per))
    return np.stack(out).astype(np.int32)


def _hole(kind, h, w):
    hole = np.zeros((h, w), bool)
    if kind == 'pixel':
        hole[h // 2, w // 2] = True
    elif kind == 'edge':
        hole[:, :max(1, w // 5)] = True
    elif kind == 'blobs':
        yy, xx = np.mgrid[0:h, 0:w]
        for cy, cx, r in ((h * 0.3, w * 0.4, h / 5), (h * 0.8, 0, h / 4)):
            hole |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    else:
        hole[:] = True
    return hole


def _image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 7), 0.5 + 0.4 * np.cos(yy / 5),
                    rng.rand(h, w)], -1)
    return img.astype(np.float32)


@pytest.mark.parametrize('h,w', [(37, 53), (64, 96), (27, 1)])
@pytest.mark.parametrize('kind', ['pixel', 'edge', 'blobs', 'all'])
def test_push_pull_fill_matches_jax(h, w, kind):
    img, hole = _image(h, w), _hole(kind, h, w)
    want = np.asarray(jfill.push_pull_fill(jnp.asarray(img),
                                           jnp.asarray(hole)))
    got = tfill.push_pull_fill(torch.from_numpy(img),
                               torch.from_numpy(hole)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_array_equal(got[~hole], img[~hole])


def test_fill_levels_and_odd_steps():
    """7 → 8 → 4 at H = 448 and 3 → 4 → 2 at W = 768; the top is one
    pixel; 10 levels at the style path's sizes."""
    sizes = tfill.fill_levels(448, 768)
    assert len(sizes) == 11 and sizes[-1] == (1, 1)
    assert [h for h, _ in sizes][5:8] == [14, 7, 4]
    assert [w for _, w in sizes][7:10] == [6, 3, 2]
    assert len(tfill.fill_levels(768, 768)) == 11
    assert tfill.fill_levels(1, 1) == [(1, 1)]
    # the upsample is jax.image.resize 'linear' for steps that are not 2
    rng = np.random.RandomState(1)
    for (a, b), (c, d) in (((4, 2), (7, 3)), ((1, 1), (2, 2)),
                           ((7, 14), (14, 27))):
        x = rng.rand(a, b, 4).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (c, d, 4),
                                           method='linear'))
        got = tfill._upsample_to(torch.from_numpy(x), c, d).numpy()
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize('h,w,kind', [(37, 53, 'blobs'), (64, 96, 'edge'),
                                      (64, 96, 'pixel')])
def test_jitter_refine_matches_jax_given_its_offsets(h, w, kind):
    base, hole = _image(h, w, 3), _hole(kind, h, w)
    img = np.array(jfill.push_pull_fill(jnp.asarray(base),
                                        jnp.asarray(hole)))
    want = np.asarray(jfill.jitter_refine(jnp.asarray(img),
                                          jnp.asarray(hole), seed=5))
    got = tfill.jitter_refine(torch.from_numpy(img), torch.from_numpy(hole),
                              torch.from_numpy(jax_offsets(h, w, 5))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()                 # the refine moved something


def test_inpaint_uint8_with_jax_offsets(monkeypatch):
    h, w = 64, 96
    rng = np.random.RandomState(7)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = _hole('blobs', h, w).astype(np.uint8) * 255
    want = jfill.inpaint(img, mask)
    monkeypatch.setattr(tfill, 'jitter_offsets',
                        lambda hh, ww, seed=0, iters=2, device=None:
                        torch.from_numpy(jax_offsets(hh, ww, seed, iters)).to(
                            device or 'cpu'))
    got = tfill.inpaint(img, mask, device='cpu')
    assert got.dtype == np.uint8 and got.shape == img.shape
    hole = mask > 0
    np.testing.assert_array_equal(got[~hole], img[~hole])
    assert (got[hole] == want[hole]).mean() >= 0.999


def test_jitter_offsets_repeatable_and_in_range():
    a = tfill.jitter_offsets(9, 13, seed=3)
    b = tfill.jitter_offsets(9, 13, seed=3)
    assert a.dtype == torch.int32 and tuple(a.shape) == (2, 4, 2, 9, 13)
    assert torch.equal(a, b)
    assert not torch.equal(a, tfill.jitter_offsets(9, 13, seed=4))
    for ri, r in enumerate(tfill.RADII):
        assert int(a[:, ri].min()) >= -r and int(a[:, ri].max()) <= r
        assert int(a[:, ri].abs().max()) == r      # the range is reached


def test_wrappers_check_their_arguments():
    img = torch.zeros((5, 6, 3))
    with pytest.raises(ValueError, match='hole'):
        tfill.push_pull_fill(img, torch.zeros((5, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match='offsets'):
        tfill.jitter_refine(img, torch.zeros((5, 6), dtype=torch.bool),
                            tfill.jitter_offsets(5, 6, iters=1))
