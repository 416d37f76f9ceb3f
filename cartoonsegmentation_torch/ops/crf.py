"""Dense CRF mean-field inference (binary): port of
``cartoonsegmentation_tpu/ops/crf.py`` (the CRF depth refine's snap of
a sloppy segment mask to the colour edges; pydensecrf in the
reference: Gaussian sxy=1, bilateral sxy=46 / srgb=4, 5 mean-field
iterations).

The bilateral message is evaluated as colour-cluster-gated spatial
blurs: k-means the guide into K colours, and for each cluster c blur
q ⊙ 1[label = c] with a wide Gaussian that runs on a lattice of
⌊σ⌋ // 2 cells (a sum pool, an unnormalised blur there, a linear
upsample back); a pixel's message is its own cluster's blur.

Two kernels, each beside its plain version:
- K12a ``kmeans_labels``: the plain ``_kmeans_labels`` (Lloyd
  iterations with one-hot matmul sums, as the JAX version), or
  ``csrc/kmeans.cu`` on CUDA;
- K12b ``crf_step``: one mean-field step (or the norm pass) — the
  plain ``crf_step_plain`` composes ``_blur2d``, ``_wide_blur`` and
  ``clustered_bilateral`` as the JAX version does, or ``csrc/crf.cu``
  on CUDA (lattice pool, lattice blur, one per-pixel pass).
``densecrf_binary`` runs one k-means, the norm pass and the steps, and
reads the mask off the last step.

The plain version fixes the JAX version's unspecified orders of
summation (the lattice pool, the upsample's two taps) to sequential
ones that the kernel repeats, so kernel and plain version agree bit
for bit up to the exp/log of the card's libm.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .pointcloud import true_div

GAUSS_RADIUS = 2
# csrc/kmeans.cu: points a block, clusters at most (csrc/crf.cu too)
KMEANS_BLOCK_POINTS = 1024
KMEANS_MAX_K = 16
# csrc/crf.cu: largest lattice blur radius
CRF_MAX_RADIUS = 15


@functools.lru_cache(maxsize=16)
def _gauss_taps_host(sigma: float, radius: int) -> torch.Tensor:
    """exp(-0.5 (i / σ)²) for i in [-radius, radius], in f32 as the
    JAX version computes it (unnormalised, centre weight 1)."""
    x = true_div(torch.arange(-radius, radius + 1, dtype=torch.float32),
                 sigma)
    return torch.exp(-0.5 * (x * x))


def _blur2d(x: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable unnormalised Gaussian over (H, W, C), zero padding, the
    taps summed in the JAX version's order (rows, then columns)."""
    k = _gauss_taps_host(sigma, radius).to(x.device)
    H, W = x.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, radius, radius))
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + k[i] * xp[i:i + H]
    xp = torch.nn.functional.pad(out, (0, 0, radius, radius))
    out2 = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out2 = out2 + k[i] * xp[:, i:i + W]
    return out2


def lattice(H: int, W: int, sigma: float) -> Tuple[int, int, int, int]:
    """(s, gh, gw, radius) of the wide blur: cells of s = ⌊σ⌋ // 2
    pixels, the lattice covering the zero-padded (gh·s, gw·s) image,
    the lattice blur's radius max(2, int(2σ / s))."""
    s = max(int(sigma) // 2, 1)
    return s, -(-H // s), -(-W // s), max(2, int(2 * sigma / s))


@functools.lru_cache(maxsize=64)
def linear_taps(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two taps of ``jax.image.resize(..., 'linear')`` upsampling
    n_in → n_out: (i0 (n_out,) int32, w (n_out, 2) f32), the output
    o = w[o, 0]·x[i0] + w[o, 1]·x[min(i0 + 1, n_in - 1)]. The weight
    matrix is JAX's (half-pixel centres, triangle weights renormalised
    by their sum, zero where the sample lies outside), in f32; an
    upsample has at most these two taps non-zero."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    idx = torch.arange(n_in, dtype=torch.float32)
    wm = torch.clamp(1.0 - (f[None, :] - idx[:, None]).abs(), min=0.0)
    tot = wm.sum(0, keepdim=True)
    wm = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                     wm / torch.where(tot != 0, tot, torch.ones_like(tot)),
                     torch.zeros_like(wm))
    wm = torch.where(((f >= -0.5) & (f <= n_in - 0.5))[None, :], wm,
                     torch.zeros_like(wm))
    i0 = torch.floor(f).clamp(0, n_in - 1).to(torch.int64)
    i1 = i0 + 1
    o = torch.arange(n_out)
    w0 = wm[i0, o]
    w1 = torch.where(i1 < n_in, wm[i1.clamp(max=n_in - 1), o],
                     torch.zeros_like(w0))
    return i0.to(torch.int32), torch.stack([w0, w1], 1).contiguous()


def _pool_sum(xp: torch.Tensor, s: int) -> torch.Tensor:
    """(gh·s, gw·s, C) → (gh, gw, C) cell sums: down each column of a
    cell first, then across the columns, each sequentially."""
    gh, gw = xp.shape[0] // s, xp.shape[1] // s
    t = xp.reshape(gh, s, gw, s, -1)
    acc = t[:, 0]
    for dy in range(1, s):
        acc = acc + t[:, dy]
    out = acc[:, :, 0]
    for dx in range(1, s):
        out = out + acc[:, :, dx]
    return out


def _upsample(x: torch.Tensor, H: int, W: int, s: int) -> torch.Tensor:
    """(gh, gw, C) → (H, W, C), the first H × W of JAX's linear resize
    to (gh·s, gw·s): rows, then columns, two taps each."""
    gh, gw = x.shape[:2]
    ri, rw = (t.to(x.device) for t in linear_taps(gh, gh * s))
    ci, cw = (t.to(x.device) for t in linear_taps(gw, gw * s))
    ri, rw, ci, cw = ri[:H].long(), rw[:H], ci[:W].long(), cw[:W]
    r1 = (ri + 1).clamp(max=gh - 1)
    c1 = (ci + 1).clamp(max=gw - 1)
    rows = rw[:, 0, None, None] * x[ri] + rw[:, 1, None, None] * x[r1]
    return cw[None, :, 0, None] * rows[:, ci] \
        + cw[None, :, 1, None] * rows[:, c1]


def _wide_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Unnormalised wide Gaussian over (H, W, C): sum-pool to the
    lattice, blur there, linear upsample back (JAX ``_wide_blur``)."""
    H, W, _ = x.shape
    s, gh, gw, radius = lattice(H, W, sigma)
    xp = torch.nn.functional.pad(x, (0, 0, 0, gw * s - W, 0, gh * s - H))
    blurred = _blur2d(_pool_sum(xp, s), sigma / s, radius)
    return _upsample(blurred, H, W, s)


def _sq_dist(colors: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, k) squared distances as XLA's CPU code computes the JAX
    version's ``sum((c - m) ** 2, -1)``: contracted to
    fma(d2, d2, fma(d1, d1, d0·d0)), each fma a single rounding
    (emulated in float64: the products are exact there)."""
    diff = colors[:, None] - centers[None]
    d0, d1, d2 = diff.double().unbind(-1)
    acc = (d0 * d0).float().double()
    acc = (d1 * d1 + acc).float().double()
    return (d2 * d2 + acc).float()


def _kmeans_labels(colors: torch.Tensor, k: int, iters: int = 8
                   ) -> torch.Tensor:
    """K12a's plain version: colors (N, 3) in [0, 1] → (N,) int32
    labels; init from the evenly spaced samples arange(k)·(N // k),
    the first minimum wins, an empty cluster keeps its centre; the
    cluster sums are a one-hot matmul, as the JAX version's."""
    N = colors.shape[0]
    idx = torch.arange(k, device=colors.device) * (N // k)
    centers = colors[idx]
    for _ in range(iters):
        lbl = _sq_dist(colors, centers).argmin(1)
        onehot = torch.nn.functional.one_hot(lbl, k).to(colors.dtype)
        sums = onehot.T @ colors
        cnts = onehot.sum(0)[:, None]
        centers = torch.where(cnts > 0, sums / cnts.clamp(min=1), centers)
    return _sq_dist(colors, centers).argmin(1).to(torch.int32)


def kmeans_labels(colors: torch.Tensor, k: int, iters: int = 8
                  ) -> torch.Tensor:
    """K12a wrapper: the plain version on the CPU, csrc/kmeans.cu on
    CUDA. colors (N, 3) f32 → (N,) int32 labels."""
    if colors.device.type == 'cpu':
        return _kmeans_labels(colors, k, iters)
    dev = colors.device
    colors = colors.contiguous()
    _cuda.check(colors, 'colors', torch.float32, 2, dev)
    N = colors.shape[0]
    if colors.shape[1] != 3 or N == 0:
        raise ValueError(f'colors must be (N > 0, 3), got '
                         f'{tuple(colors.shape)}')
    if not 1 <= k <= KMEANS_MAX_K:
        raise ValueError(f'kmeans takes 1 to {KMEANS_MAX_K} clusters, got '
                         f'{k}')
    n_blocks = -(-N // KMEANS_BLOCK_POINTS)
    centers = torch.empty((k, 3), dtype=torch.float32, device=dev)
    partials = torch.empty((n_blocks, k, 4), dtype=torch.float32, device=dev)
    labels = torch.empty((N,), dtype=torch.int32, device=dev)
    p, i = _cuda.P, _cuda.I
    _cuda.launch('kmeans', 'kb_kmeans', [p, i, i, i, p, p, p, p],
                 colors.data_ptr(), N, k, iters, centers.data_ptr(),
                 partials.data_ptr(), labels.data_ptr(),
                 _cuda.stream_ptr(colors))
    return labels


def clustered_bilateral(q: torch.Tensor, guide: torch.Tensor, sxy: float,
                        num_clusters: int = 10,
                        labels: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Σ_j k_bilateral(i, j) q_j with interaction only inside a colour
    cluster: each pixel takes its own cluster's wide blur of q ⊙
    1[label = c]. ``labels`` (H, W) skips the k-means."""
    H, W, _ = q.shape
    if labels is None:
        labels = kmeans_labels(guide.reshape(-1, guide.shape[-1]),
                               num_clusters).reshape(H, W)
    out = torch.zeros_like(q)
    for c in range(num_clusters):
        mask = (labels == c).to(q.dtype)[..., None]
        out = out + mask * _wide_blur(q * mask, sxy)
    return out


def _softmax2(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis as jax.nn.softmax: exp(x − max) over
    its sum."""
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    return e / e.sum(-1, keepdim=True)


def crf_norms_plain(labels: torch.Tensor, gaussian_sxy: float,
                    bilateral_sxy: float, num_clusters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalising masses without the self weight, (H, W, 2): the
    Gaussian's and the bilateral kernel's sums over 1, less 1. The JAX
    version writes ``x - ones + 1e-8``, which XLA folds under jit into
    x + (1e-8 - 1), that is x - 1 in f32: the port computes what the
    reference runs. Also returns ``dead``, a 0-d bool: some norm is 0
    (a pixel alone in its colour cluster's reach), where the JAX
    version divides by zero and its NaN reaches every pixel in two
    steps through the dense upsample, so that its mask is empty."""
    H, W = labels.shape
    ones = torch.ones((H, W, 1), dtype=torch.float32, device=labels.device)
    g = _blur2d(ones, gaussian_sxy, GAUSS_RADIUS) - ones
    b = clustered_bilateral(ones, None, bilateral_sxy, num_clusters,
                            labels=labels) - ones
    norms = torch.cat([g, b], -1)
    return norms, (norms == 0).any()


def crf_step_plain(q: torch.Tensor, labels: torch.Tensor,
                   unary: torch.Tensor, norms: torch.Tensor,
                   gaussian_sxy: float = 1.0, gaussian_compat: float = 3.0,
                   bilateral_sxy: float = 46.0,
                   bilateral_compat: float = 40.0,
                   num_clusters: int = 10) -> torch.Tensor:
    """K12b's plain version, one mean-field step of the JAX loop: the
    Gaussian and bilateral messages without the self term over their
    norms, the Potts swap, the softmax against the unary. q, unary
    (H, W, 2) f32, labels (H, W) int32, norms (H, W, 2) → new q."""
    m_gauss = (_blur2d(q, gaussian_sxy, GAUSS_RADIUS) - q) / norms[..., :1]
    m_bilat = (clustered_bilateral(q, None, bilateral_sxy, num_clusters,
                                   labels=labels) - q) / norms[..., 1:]
    msg = gaussian_compat * m_gauss + bilateral_compat * m_bilat
    return _softmax2(-unary - msg.flip(-1))


@functools.lru_cache(maxsize=64)
def _crf_tables(H: int, W: int, gaussian_sxy: float, bilateral_sxy: float,
                dev: torch.device):
    """Device copies of the kernel's constant tables: the 5 Gaussian
    taps, the lattice taps, the row and column upsample taps."""
    s, gh, gw, radius = lattice(H, W, bilateral_sxy)
    ri, rw = linear_taps(gh, gh * s)
    ci, cw = linear_taps(gw, gw * s)
    return tuple(t.contiguous().to(dev) for t in (
        _gauss_taps_host(gaussian_sxy, GAUSS_RADIUS),
        _gauss_taps_host(bilateral_sxy / s, radius),
        ri[:H], rw[:H], ci[:W], cw[:W]))


def _crf_launch(q: Optional[torch.Tensor], labels: torch.Tensor,
                unary: Optional[torch.Tensor], norms: torch.Tensor,
                dead: torch.Tensor, q_out: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], gaussian_sxy: float,
                gaussian_compat: float, bilateral_sxy: float,
                bilateral_compat: float, num_clusters: int) -> None:
    dev = labels.device
    H, W = labels.shape
    _cuda.check(labels, 'labels', torch.int32, 2, dev)
    _cuda.check(dead, 'dead', torch.int32, 1, dev)
    for name, t in (('q', q), ('unary', unary), ('norms', norms)):
        if t is not None:
            _cuda.check(t, name, torch.float32, 3, dev)
            if tuple(t.shape) != (H, W, 2):
                raise ValueError(f'{name} is {tuple(t.shape)}, expected '
                                 f'{(H, W, 2)}')
    if not 1 <= num_clusters <= KMEANS_MAX_K:
        raise ValueError(f'crf takes 1 to {KMEANS_MAX_K} clusters')
    s, gh, gw, radius = lattice(H, W, bilateral_sxy)
    if radius > CRF_MAX_RADIUS:
        raise ValueError(f'lattice radius {radius} above {CRF_MAX_RADIUS}')
    g5, glat, ri, rw, ci, cw = _crf_tables(H, W, gaussian_sxy,
                                           bilateral_sxy, dev)
    pooled = torch.empty((num_clusters * 2, gh, gw), dtype=torch.float32,
                         device=dev)
    blurred = torch.empty_like(pooled)
    p, i, f = _cuda.P, _cuda.I, _cuda.F

    def ptr(t):
        return None if t is None else t.data_ptr()
    _cuda.launch('crf', 'kb_crf_step',
                 [p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, f,
                  f, p, p, p, p, p],
                 ptr(q), labels.data_ptr(), ptr(unary), norms.data_ptr(),
                 dead.data_ptr(), H, W, num_clusters, s, gh, gw, radius,
                 g5.data_ptr(), glat.data_ptr(), ri.data_ptr(),
                 rw.data_ptr(), ci.data_ptr(), cw.data_ptr(),
                 gaussian_compat, bilateral_compat, pooled.data_ptr(),
                 blurred.data_ptr(), ptr(q_out), ptr(mask),
                 _cuda.stream_ptr(labels))



def crf_norms(labels: torch.Tensor, gaussian_sxy: float = 1.0,
              bilateral_sxy: float = 46.0, num_clusters: int = 10
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12b wrapper, norm pass: the plain version on the CPU,
    csrc/crf.cu on CUDA. labels (H, W) int32 → norms (H, W, 2) f32 and
    ``dead`` (1,) int32, 1 where some norm is 0 (see
    ``crf_norms_plain``)."""
    if labels.device.type == 'cpu':
        norms, dead = crf_norms_plain(labels, gaussian_sxy, bilateral_sxy,
                                      num_clusters)
        return norms, dead.to(torch.int32).reshape(1)
    labels = labels.contiguous()
    norms = torch.empty(labels.shape + (2,), dtype=torch.float32,
                        device=labels.device)
    dead = torch.zeros((1,), dtype=torch.int32, device=labels.device)
    _crf_launch(None, labels, None, norms, dead, None, None, gaussian_sxy,
                0.0, bilateral_sxy, 0.0, num_clusters)
    return norms, dead


def crf_step(q: torch.Tensor, labels: torch.Tensor, unary: torch.Tensor,
             norms: torch.Tensor, dead: torch.Tensor,
             gaussian_sxy: float = 1.0, gaussian_compat: float = 3.0,
             bilateral_sxy: float = 46.0, bilateral_compat: float = 40.0,
             num_clusters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12b wrapper, one mean-field step: the plain version on the CPU,
    csrc/crf.cu on CUDA. Returns the new q (H, W, 2) f32 and its mask
    q1 > q0 (H, W) bool, empty where ``dead`` (the norm pass's (1,)
    int32 flag) is set."""
    kw = dict(gaussian_sxy=gaussian_sxy, gaussian_compat=gaussian_compat,
              bilateral_sxy=bilateral_sxy, bilateral_compat=bilateral_compat,
              num_clusters=num_clusters)
    if q.device.type == 'cpu':
        q = crf_step_plain(q, labels, unary, norms, **kw)
        return q, (q[..., 1] > q[..., 0]) & (dead == 0)
    q, labels = q.contiguous(), labels.contiguous()
    unary, norms = unary.contiguous(), norms.contiguous()
    q_out = torch.empty_like(q)
    mask = torch.empty(labels.shape, dtype=torch.bool, device=q.device)
    _crf_launch(q, labels, unary, norms, dead.contiguous(), q_out, mask,
                **kw)
    return q_out, mask


def densecrf_binary(unary_fg: torch.Tensor, rgb: torch.Tensor,
                    iterations: int = 5, gaussian_sxy: float = 1.0,
                    gaussian_compat: float = 3.0, bilateral_sxy: float = 46.0,
                    bilateral_compat: float = 40.0,
                    num_clusters: int = 10) -> torch.Tensor:
    """Binary mean-field dense CRF on the tensors' device.

    unary_fg: (H, W) foreground probability in [0, 1]; rgb: (H, W, 3)
    uint8 or f32 guide. Returns the refined foreground mask (H, W)
    bool. Defaults: the reference's crf_refine (kenburns_effect.py:
    651-665); messages are normalised by the kernels' mass without the
    self weight. A zero norm empties the mask from the second step on,
    as the JAX version's NaN does (``crf_norms_plain``)."""
    H, W = unary_fg.shape
    p = torch.clamp(unary_fg.float(), 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    # XLA turns the JAX version's "/ 255.0" into a multiply by the f32
    # reciprocal under jit; so does the port
    guide = rgb if rgb.dtype == torch.float32 else \
        rgb.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32,
                                             device=rgb.device)
    labels = kmeans_labels(guide.reshape(-1, guide.shape[-1]).contiguous(),
                           num_clusters).reshape(H, W)
    norms, dead = crf_norms(labels, gaussian_sxy, bilateral_sxy, num_clusters)
    q = _softmax2(-unary)
    if iterations == 0:
        return q[..., 1] > q[..., 0]
    kw = dict(gaussian_sxy=gaussian_sxy, gaussian_compat=gaussian_compat,
              bilateral_sxy=bilateral_sxy, bilateral_compat=bilateral_compat,
              num_clusters=num_clusters)
    if iterations == 1:
        # a zero norm's NaN has not spread yet after one step
        dead = torch.zeros_like(dead)
    for _ in range(iterations):
        q, mask = crf_step(q, labels, unary, norms, dead, **kw)
    return mask
