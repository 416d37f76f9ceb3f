"""The port's CRF depth refine (``refine_crf``) on the CPU against the
JAX package's: ``quantize_image``, the dense CRF's pieces (``_blur2d``,
``_wide_blur``, ``_kmeans_labels``, the mean-field steps) and
``densecrf_binary`` (kernels K12a and K12b run their plain versions
here), ``refine_depth_crf``, and the Ken Burns pipeline's state with
``refine_crf=True``.

The JAX side re-jits ``densecrf_binary`` for every crop shape (a few
seconds each), so the images are layered flat shapes whose segments
come in few crop shapes, and the JAX results are module fixtures.

Tolerances: ``quantize_image``, ``_blur2d``, the k-means labels, the
CRF masks and the refined disparity exact; ``_wide_blur`` 2e-6 of its
range (JAX resizes with a dense einsum, the port with the upsample's
two taps); q after 5 steps from the same labels 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from cartoonsegmentation_tpu.config import KenBurnsConfig as JConfig
from cartoonsegmentation_tpu.data.augment import \
    quantize_image as jquantize
from cartoonsegmentation_tpu.instances import Instances as JIns
from cartoonsegmentation_tpu.ops import crf as jcrf
from cartoonsegmentation_tpu.pipeline.crf_refine import \
    refine_depth_crf as jrefine
from cartoonsegmentation_tpu.pipeline.kenburns import \
    KenBurnsPipeline as JPipeline
from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.data.augment import \
    quantize_image as tquantize
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.ops import crf as tcrf
from cartoonsegmentation_torch.pipeline.crf_refine import \
    refine_depth_crf as trefine
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline


# (H, W, rectangle rows and columns, disc centre and radius): sizes at
# which the 5-level depth quantization gives each shape a level of its
# own, so that both reach the CRF and get their medians written
LAYERS_64 = (64, 64, (8, 22), (36, 52), (44, 22), 9)
LAYERS_96 = (96, 128, (12, 32), (72, 110), (64, 42), 13)


def _layers(H, W, rows, cols, centre, radius, seed=0):
    """BGR uint8 image and f32 disparity of flat layers: a background,
    a rectangle and a disc, each a colour and a disparity of its own,
    with antialiased (noisy) colours along the shape edges."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    rect = (yy >= rows[0]) & (yy < rows[1]) & (xx >= cols[0]) & \
        (xx < cols[1])
    disc = (yy - centre[0]) ** 2 + (xx - centre[1]) ** 2 < radius ** 2
    img = np.zeros((H, W, 3), np.float32)
    img[:] = (60, 160, 60)
    img[rect] = (40, 40, 200)
    img[disc] = (200, 60, 60)
    edge = cv2.morphologyEx((rect | disc).astype(np.uint8), cv2.MORPH_GRADIENT,
                            np.ones((3, 3), np.uint8)) > 0
    img[edge] += rng.uniform(-30, 30, (int(edge.sum()), 3))
    disp = np.full((H, W), 10.0, np.float32)
    disp[rect] = 20.0
    disp[disc] = 30.0
    return np.clip(img, 0, 255).astype(np.uint8), disp, rect


def test_quantize_image_byte_exact():
    rng = np.random.RandomState(0)
    img = (rng.rand(40, 50, 1) * 255).astype(np.uint8)
    mask = rng.rand(40, 50) > 0.3
    for m in (None, mask):
        qj, cj, lj = jquantize(img, 5, mask=m)
        qt, ct, lt = tquantize(img, 5, mask=m)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(lt, lj)
        assert ct == cj


@pytest.mark.parametrize('shape', [(37, 53, 2), (71, 97, 1)])
def test_blurs_vs_jax(shape):
    """Odd sizes: lattices of 2 x 3 and 4 x 5 cells of 23 pixels."""
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tcrf._blur2d(xt, 1.0, 2).numpy(),
        np.asarray(jcrf._blur2d(jnp.asarray(x), 1.0, 2)))
    want = np.asarray(jax.jit(lambda v: jcrf._wide_blur(v, 46.0))(x))
    got = tcrf._wide_blur(xt, 46.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.fixture(scope='module')
def crf_case():
    """A sloppy mask over a noisy two-tone image (tests/test_crf.py's
    case) and the JAX results: labels, mask, and q after 5 steps from
    the JAX labels."""
    rng = np.random.RandomState(2)
    H = W = 48
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[:, :24] = (200, 40, 40)
    rgb[:, 24:] = (40, 40, 200)
    rgb = np.clip(rgb + rng.randn(H, W, 3) * 8, 0, 255).astype(np.uint8)
    unary = np.zeros((H, W), np.float32)
    unary[:, :20] = 0.9
    unary[:, 20:30] = np.clip(0.5 + 0.1 * rng.randn(H, 10), 0, 1)
    guide = rgb.reshape(-1, 3) * np.float32(1 / 255)

    @jax.jit
    def q_after(unary_fg, guide, labels):
        """densecrf_binary's loop (ops/crf.py:110-136) returning q."""
        p = jnp.clip(unary_fg, 1e-5, 1 - 1e-5)
        un = -jnp.log(jnp.stack([1 - p, p], -1))
        ones = jnp.ones(unary_fg.shape + (1,), jnp.float32)
        gn = jcrf._blur2d(ones, 1.0, 2) - ones + 1e-8
        bn = jcrf.clustered_bilateral(ones, None, 46.0, 10,
                                      labels=labels) - ones + 1e-8
        q = jax.nn.softmax(-un, -1)
        for _ in range(5):
            mg = (jcrf._blur2d(q, 1.0, 2) - q) / gn
            mb = (jcrf.clustered_bilateral(q, None, 46.0, 10,
                                           labels=labels) - q) / bn
            q = jax.nn.softmax(-un - (3.0 * mg + 40.0 * mb)[..., ::-1], -1)
        return q

    labels = np.asarray(jax.jit(lambda g: jcrf._kmeans_labels(g, 10))(guide))
    return dict(
        rgb=rgb, unary=unary, guide=guide, labels=labels,
        q=np.asarray(q_after(unary, guide.reshape(H, W, 3),
                             labels.reshape(H, W))),
        mask=np.asarray(jcrf.densecrf_binary(jnp.asarray(unary),
                                             jnp.asarray(rgb))))


def test_kmeans_labels_vs_jax(crf_case):
    """K12a's plain version: every label equal (the distance is summed
    with XLA's fused multiply-adds)."""
    got = tcrf.kmeans_labels(torch.from_numpy(crf_case['guide']), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), crf_case['labels'])


def test_crf_steps_and_mask_vs_jax(crf_case):
    """K12b's plain version, 5 steps from the JAX labels: q within
    1e-5; densecrf_binary's whole mask exact."""
    H, W = crf_case['unary'].shape
    labels = torch.tensor(crf_case['labels'].reshape(H, W))
    p = torch.clamp(torch.from_numpy(crf_case['unary']), 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    norms, dead = tcrf.crf_norms(labels)
    assert int(dead) == 0
    q = tcrf._softmax2(-unary)
    for _ in range(5):
        q, _ = tcrf.crf_step(q, labels, unary, norms, dead)
    np.testing.assert_allclose(q.numpy(), crf_case['q'], rtol=0, atol=1e-5)
    mask = tcrf.densecrf_binary(torch.from_numpy(crf_case['unary']),
                                torch.from_numpy(crf_case['rgb']))
    np.testing.assert_array_equal(mask.numpy(), crf_case['mask'])
    assert 0.3 < mask.float().mean() < 0.7


def test_zero_norm_empties_the_mask_as_jax():
    """A pixel alone in its colour cluster's reach gets norm 0: the JAX
    version's 0/0 empties its whole mask (under jit XLA folds the norm's
    + 1e-8 away); the port flags it and does the same."""
    rgb = np.full((6, 9, 3), 120, np.uint8)
    rgb[:, 5:] = 20
    rgb[2, 2] = (250, 0, 250)     # a colour of its own, a k-means seed
    unary = np.full((6, 9), 0.9, np.float32)
    for it in (5, 1):
        want = np.asarray(jcrf.densecrf_binary(
            jnp.asarray(unary), jnp.asarray(rgb), iterations=it))
        got = tcrf.densecrf_binary(torch.from_numpy(unary),
                                   torch.from_numpy(rgb), iterations=it)
        np.testing.assert_array_equal(got.numpy(), want)
        # after 1 step only the lone pixel's own NaN
        assert want.sum() == (0 if it > 1 else want.size - 1)


@pytest.fixture(scope='module')
def refine_cases():
    img, disp, rect = _layers(*LAYERS_64)
    ins = np.zeros_like(rect)
    ins[4:20, 30:44] = True                   # over the rectangle's corner
    return [(img, disp, m, jrefine(img, disp, m)) for m in (None, ins)]


@pytest.mark.parametrize('case', [0, 1], ids=['plain', 'instance_mask'])
def test_refine_depth_crf_vs_jax(refine_cases, case):
    img, disp, ins, want = refine_cases[case]
    _cuda.reset_launches()
    got = trefine(img, disp, ins, device='cpu')
    assert _cuda.LAUNCHES['kmeans'] == _cuda.LAUNCHES['crf'] == 0
    np.testing.assert_array_equal(got, want)
    assert (got != disp).any()                # the medians moved pixels


@pytest.fixture(scope='module')
def pipelines():
    """Both pipelines at 96 x 128 with refine_crf, detector off, one
    instance given, the depth estimate replaced by the layered
    disparity (the nets are another test's subject): generate_state."""
    img, disp, rect = _layers(*LAYERS_96)
    H, W = disp.shape
    m = np.zeros((1, H, W), bool)
    m[0, 70:90, 90:120] = True
    box = np.array([[90, 70, 30, 20]], np.float32)
    cfg = dict(detector='none', refine_crf=True, dtype='float32',
               render_payload_dtype='float32', max_size=128)
    jp = JPipeline(JConfig(**cfg), seed=0)
    jp.stage_previews = False
    jp._estimate_disparity = lambda image: jnp.asarray(disp)[..., None]
    tp = TPipeline(TConfig(**cfg), device='cpu')
    tp._est_leres = lambda image: torch.from_numpy(disp)[..., None]
    state_j = jp.generate_state(img, JIns.from_numpy(m, box, capacity=4))
    state_t = tp.generate_state(img, TIns.from_numpy(m, box, capacity=4))
    return dict(disp=disp, mask=m[0], jp=jp, tp=tp, state_j=state_j,
                state_t=state_t)


def test_pipeline_refine_crf_state_vs_jax(pipelines):
    """The refined disparity the state is built from, and the depth,
    exact; the instance and the CRF both moved pixels."""
    st_t, st_j = pipelines['state_t'], pipelines['state_j']
    disp_t = st_t.disparity[..., 0].numpy()
    np.testing.assert_array_equal(
        disp_t, np.asarray(jax.device_get(st_j.disparity))[..., 0])
    np.testing.assert_array_equal(
        st_t.depth.numpy(), np.asarray(jax.device_get(st_j.depth)))
    moved = disp_t != pipelines['disp']
    assert (moved & ~pipelines['mask']).any()
    assert 'depth_refine' in pipelines['tp'].timer.seconds
