"""The port's detector training (cartoonsegmentation_torch/parallel)
against the JAX package's on the CPU:

- ``dynamic_soft_label_assign``: (pos, gt_idx) exact and assigned_iou
  within 1e-6 on continuous random inputs (no near-ties), with padded
  and empty gts;
- train-mode BatchNorm against flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``: output within 1e-5 of its range, running statistics
  within 1e-6;
- ``detector_loss`` at nano (deepen 0.33, widen 0.125), 64x64, batch 2,
  G = 4 with padded gts and ignore masks, on JAX's initial variables
  carried into the port by ``rtmdet_from_flax``: the assignment exact,
  the four terms within 1e-5 relative, every parameter's gradient
  within 1e-3 of its tensor's largest magnitude (JAX's gradients
  carried into the port's layout the same way), the BatchNorm running
  statistics after the step within 1e-5. The gradients' tolerance is
  f32's own: the port's net run in float64 on the same variables (its
  heads' outputs and the loss still f32, as JAX's) puts JAX's f32
  gradients up to 6.0e-4 of a tensor's largest magnitude from it and
  the port's f32 ones up to 3.7e-4 (the BatchNorm weight and bias sums
  of the 2x2 stride-32 maps cancel); port and JAX differ by up to
  5.2e-4, so each of the three pairs is held at 1e-3;
- the optimizer chain (global-norm clip, AdamW, warmup + cosine) over 3
  steps on a small tree against optax's, within 1e-6;
- ``ema_update`` and ``ema_decay_schedule`` against JAX's.

JAX's ``value_and_grad`` of the detector is jitted once, in the
module-scoped fixture ``jax_step`` (this file stands alone so that
``--dist loadfile`` puts it on a worker of its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartoonsegmentation_tpu.models import rtmdet as jrtmdet
from cartoonsegmentation_tpu.parallel import dsla as jdsla
from cartoonsegmentation_tpu.parallel import train as jtrain
from cartoonsegmentation_torch.models import cspnext as tcsp
from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.models.convert import rtmdet_from_flax
from cartoonsegmentation_torch.parallel import dsla as tdsla
from cartoonsegmentation_torch.parallel import train as ttrain
from torch_cpu import torch_threads  # noqa: F401  (autouse)

DEEPEN, WIDEN, SIZE, B, G = 0.33, 0.125, 64, 2, 4


def _np(a):
    return np.asarray(jax.device_get(a))


def _rand_boxes(rng, n, size, lo=12, hi=40):
    x1 = rng.uniform(0, size - lo, n)
    y1 = rng.uniform(0, size - lo, n)
    w = rng.uniform(lo, hi, n)
    h = rng.uniform(lo, hi, n)
    return np.stack([x1, y1, np.minimum(x1 + w, size),
                     np.minimum(y1 + h, size)], -1).astype(np.float32)


def _batch(seed=0):
    """Images in [0, 1], G = 4 gts an image: image 1's last gt padded
    (zeros, invalid), image 0's second gt bbox-only (ignored by the mask
    loss); masks the boxes' pixels."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([_rand_boxes(rng, G, SIZE) for _ in range(B)])
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    boxes[1, -1] = 0.0
    ignore = np.zeros((B, G), bool)
    ignore[0, 1] = True
    masks = np.zeros((B, G, SIZE, SIZE), bool)
    for b in range(B):
        for g in range(G):
            if valid[b, g]:
                x1, y1, x2, y2 = boxes[b, g].astype(int)
                masks[b, g, y1:y2, x1:x2] = True
    return {'images': rng.rand(B, SIZE, SIZE, 3).astype(np.float32),
            'gt_boxes': boxes, 'gt_valid': valid, 'gt_masks': masks,
            'gt_ignore': ignore}


@pytest.fixture(scope='module')
def jax_step():
    """JAX's initial variables, its loss terms, gradients and updated
    batch stats on ``_batch()``, and its assignment of each image from
    its own train-mode head outputs."""
    from cartoonsegmentation_tpu.utils.env import jit_init
    model = jrtmdet.AnimeDetector(deepen=DEEPEN, widen=WIDEN)
    variables = jit_init(model, jax.random.PRNGKey(0),
                         jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = jax.tree_util.tree_map(_np, dict(variables))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jtrain.detector_loss(model, p, variables['batch_stats'], jb)
    (loss, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])

    @jax.jit
    def assign(params):
        (cls_out, reg_out, krn_out, _), _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jb['images'], train=True, mutable=['batch_stats'])
        scores, dists, _, priors, strides = jtrain._flatten_levels(
            cls_out, reg_out, krn_out, (SIZE, SIZE))
        out = []
        for b in range(B):
            boxes = jrtmdet.distance2bbox(priors, dists[b])
            pos, idx, _ = jdsla.dynamic_soft_label_assign(
                priors, strides, scores[b], boxes, jb['gt_boxes'][b],
                jb['gt_valid'][b])
            out.append((pos, idx))
        return out
    return {'variables': variables, 'batch': batch,
            'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': jax.tree_util.tree_map(_np, grads),
            'batch_stats': jax.tree_util.tree_map(_np, new_bs),
            'assign': [(_np(p), _np(i)) for p, i in
                       assign(variables['params'])]}


def _port_step(jax_step, dtype=torch.float32):
    """The port's loss on the same variables and batch, backward run; in
    float64 the net and images are f64 and its heads' outputs f32 (the
    detector casts them, as JAX's)."""
    net = trtmdet.AnimeDetector(DEEPEN, WIDEN)
    net.load_state_dict(rtmdet_from_flax(jax_step['variables'], net))
    net = net.to(dtype).train()
    batch = {k: torch.from_numpy(v) for k, v in jax_step['batch'].items()}
    batch['images'] = batch['images'].to(dtype)
    loss, metrics, extras = ttrain.detector_loss(net, batch)
    loss.backward()
    return net, metrics, extras


@pytest.fixture(scope='module')
def torch_step(jax_step):
    return _port_step(jax_step)


def test_detector_loss_assignment_exact(jax_step, torch_step):
    _, _, extras = torch_step
    for b, (pos, idx) in enumerate(jax_step['assign']):
        assert pos.any()
        assert np.array_equal(extras['pos'][b].numpy(), pos)
        assert np.array_equal(extras['gt_idx'][b].numpy(), idx)


@pytest.mark.parametrize('term', ['loss', 'loss_cls', 'loss_bbox',
                                  'loss_mask'])
def test_detector_loss_terms(jax_step, torch_step, term):
    """Each loss term within 1e-5 relative of JAX's."""
    want = jax_step['metrics'][term]
    got = float(torch_step[1][term])
    assert want > 0
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _grad_err(got, want) -> float:
    """max |got - want| over want's largest magnitude."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-12)


def test_detector_loss_gradients(jax_step, torch_step):
    """Every parameter's gradient within 1e-3 of its tensor's largest
    magnitude (a conv shared across levels once, under its first key):
    port against JAX, and each against the port's float64 gradients."""
    net = torch_step[0]
    net64 = _port_step(jax_step, torch.float64)[0]
    grads64 = {k: p.grad.numpy() for k, p in net64.named_parameters()}
    want = rtmdet_from_flax({'params': jax_step['grads'],
                             'batch_stats': jax_step['batch_stats']}, net)
    n = 0
    for name, p in net.named_parameters():
        w = want[name].numpy()
        g = p.grad.numpy()
        assert _grad_err(g, w) <= 1e-3, (name, _grad_err(g, w))
        assert _grad_err(w, grads64[name]) <= 1e-3, name
        assert _grad_err(g, grads64[name]) <= 1e-3, name
        n += 1
    assert n == len(list(net.parameters()))
    assert float(np.abs(want['bbox_head.rtm_kernel.0.weight'].numpy()).max()) \
        > 0, 'the mask loss reached the dynamic kernels'


def test_detector_loss_batch_stats(jax_step, torch_step):
    """The BatchNorm running statistics after the step within 1e-5 of
    JAX's (flax's biased fast variance, momentum 0.9)."""
    net = torch_step[0]
    want = rtmdet_from_flax({'params': jax_step['variables']['params'],
                             'batch_stats': jax_step['batch_stats']}, net)
    sd = net.state_dict()
    n = 0
    for k, v in sd.items():
        if k.endswith('running_mean') or k.endswith('running_var'):
            w = want[k].numpy()
            err = float(np.abs(v.numpy() - w).max())
            assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (k, err)
            n += 1
    assert n > 100


def test_batchnorm_train_mode_against_flax():
    """One train-mode BatchNorm2d against flax's on data with a large
    mean (where torch's unbiased running variance would drift)."""
    from flax import linen as nn
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 7, 6) * 2.0 + 3.0).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, mut = bn.apply({'params': {'scale': scale, 'bias': bias},
                       'batch_stats': {'mean': mean0, 'var': var0}},
                      jnp.asarray(x), mutable=['batch_stats'])
    t = tcsp.BatchNorm2d(6, eps=1e-5)
    t.load_state_dict({'weight': torch.from_numpy(scale),
                       'bias': torch.from_numpy(bias),
                       'running_mean': torch.from_numpy(mean0),
                       'running_var': torch.from_numpy(var0),
                       'num_batches_tracked': torch.tensor(0)})
    got = t.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    y = _np(y)
    assert float(np.abs(got - y).max()) <= 1e-5 * float(y.max() - y.min())
    for k, kt in (('mean', 'running_mean'), ('var', 'running_var')):
        np.testing.assert_allclose(getattr(t, kt).numpy(),
                                   _np(mut['batch_stats'][k]), rtol=0,
                                   atol=1e-6)
    # eval mode is nn.BatchNorm2d's, on the updated statistics
    ev = t.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = torch.nn.functional.batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), t.running_mean,
        t.running_var, t.weight, t.bias, False, 0.0, 1e-5)
    assert torch.equal(ev, ref)


def _assign_case(rng, A, G, n_valid):
    priors = np.stack(np.meshgrid(np.arange(10) * 8.0, np.arange(A // 10)
                                  * 8.0), -1).reshape(-1, 2)[:A]
    priors = priors.astype(np.float32)
    strides = rng.choice([8.0, 16.0], A).astype(np.float32)
    logits = rng.randn(A, 1).astype(np.float32)
    dist = rng.uniform(2, 30, (A, 4)).astype(np.float32)
    boxes = np.concatenate([priors - dist[:, :2], priors + dist[:, 2:]], 1)
    gt = _rand_boxes(rng, G, 80, 16, 48)
    valid = np.zeros(G, bool)
    valid[:n_valid] = True
    gt[~valid] = 0.0
    return priors, strides, logits, boxes, gt, valid


@pytest.mark.parametrize('n_valid', [4, 2, 0])
def test_dsla_against_jax(n_valid):
    """(pos, gt_idx) exact and assigned_iou within 1e-6; with 4 valid of
    4, 2 valid and 2 padded, and none (no positive, index 0)."""
    rng = np.random.RandomState(10 + n_valid)
    args = _assign_case(rng, 100, 4, n_valid)
    jp, ji, jiou = jax.jit(jdsla.dynamic_soft_label_assign)(
        *[jnp.asarray(a) for a in args])
    tp, ti, tiou = tdsla.dynamic_soft_label_assign(
        *[torch.from_numpy(a) for a in args])
    assert np.array_equal(tp.numpy(), _np(jp))
    assert np.array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tiou.numpy(), _np(jiou), rtol=0, atol=1e-6)
    if n_valid:
        assert tp.numpy().any()
    else:
        assert not tp.numpy().any() and not ti.numpy().any()


def test_optimizer_chain_against_optax():
    """clip_by_global_norm + adamw on warmup_cosine_decay_schedule over 3
    updates (the first at lr 0, the second clipped, the third not) on a
    small tree: the parameters within 1e-6 of optax's."""
    rng = np.random.RandomState(5)
    shapes = [(4, 3), (5,), (2, 2, 3, 3)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * sc).astype(np.float32) for s in shapes]
             for sc in (3.0, 4.0, 0.1)]
    lr, wd, warmup, steps, clip = 0.1, 0.05, 2, 5, 10.0
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                               max(steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    jparams = [jnp.asarray(a) for a in init]
    jstate = tx.init(jparams)
    chain = ttrain.make_optimizer(lr, wd, warmup, steps, clip)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = chain.init(params)
    norms = []
    for count, g in enumerate(grads):
        upd, jstate = tx.update([jnp.asarray(a) for a in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        norms.append(float(ttrain.apply_updates(chain, opt, params, count)))
        for p, j in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), _np(j), rtol=0,
                                       atol=1e-6)
        assert chain.schedule(count) == pytest.approx(float(sched(count)),
                                                      rel=1e-6, abs=1e-12)
    assert chain.schedule(0) == 0.0
    assert norms[1] > clip > norms[2]
    assert not np.allclose(init[0], params[0].detach().numpy())


@pytest.mark.parametrize('step', [1, 5, 3000])
def test_ema_against_jax(step):
    """The decay equal to JAX's; the average within 1e-6 relative."""
    rng = np.random.RandomState(step)
    e = [rng.randn(3, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    p = [rng.randn(3, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    jd = jtrain.ema_decay_schedule(0.9998, step)
    td = ttrain.ema_decay_schedule(0.9998, step)
    assert float(td) == float(jd)
    want = jtrain.ema_update([jnp.asarray(a) for a in e],
                             [jnp.asarray(a) for a in p], jd)
    got = [torch.from_numpy(a.copy()) for a in e]
    ttrain.ema_update(got, [torch.from_numpy(a) for a in p], td)
    for g, w in zip(got, want):
        # one f32 rounding apart (XLA may contract the sum into an FMA)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-7)
