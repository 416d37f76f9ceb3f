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
reads the mask off the last step; on CUDA the norm pass and the steps
are one call of csrc/crf.cu.

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
# csrc/kmeans.cu: clusters at most (csrc/crf.cu too); threads a block;
# the most points one thread-block cluster takes, and its most blocks
# (the H100's non-portable cluster size); the points a block keeps in
# shared memory
KMEANS_MAX_K = 16
KMEANS_THREADS = 512
KMEANS_CLUSTER_POINTS = 65536
KMEANS_CLUSTER_BLOCKS = 16
KMEANS_TILE = 8192
# csrc/crf.cu: largest lattice blur radius and cell side
CRF_MAX_RADIUS = 15
CRF_MAX_CELL = 1024


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


def kmeans_plan(N: int, sms: int) -> Tuple[int, bool, int]:
    """(blocks, cooperative, scratch floats) of csrc/kmeans.cu for N
    points on a card of ``sms`` streaming multiprocessors (read only
    past KMEANS_CLUSTER_POINTS). Up to KMEANS_CLUSTER_POINTS points: one
    thread-block cluster of a block per KMEANS_THREADS points, at most
    KMEANS_CLUSTER_BLOCKS (the kernel caps it at the largest cluster
    the card can schedule), its partial sums in shared memory. More: one
    cooperative launch of a block an SM (the kernel caps it at the
    blocks the card holds at once), its partials in two rows of 16 × 4
    floats a block of scratch. Block b owns the points [b·per,
    (b+1)·per), per = ceil(N / blocks)."""
    if N <= KMEANS_CLUSTER_POINTS:
        return (max(1, min(KMEANS_CLUSTER_BLOCKS, -(-N // KMEANS_THREADS))),
                False, 0)
    return sms, True, 2 * sms * KMEANS_MAX_K * 4


def kmeans_labels(colors: torch.Tensor, k: int, iters: int = 8
                  ) -> torch.Tensor:
    """K12a wrapper: the plain version on the CPU, csrc/kmeans.cu on
    CUDA (one launch, ``kmeans_plan``). colors (N, 3) f32 → (N,) int32
    labels (on CUDA a view of one buffer that also holds the launch's
    scratch)."""
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
    blocks, coop, scratch = kmeans_plan(
        N, _cuda.sm_count(colors) if N > KMEANS_CLUSTER_POINTS else 0)
    # the labels, then the scratch from a 16-byte boundary
    n = -(-N // 4) * 4
    buf = torch.empty((n + scratch,), dtype=torch.int32, device=dev)
    _cuda.launch('kmeans', colors.data_ptr(), N, k, iters, blocks, int(coop),
                 buf.data_ptr() + 4 * n, buf.data_ptr(),
                 _cuda.stream_ptr(colors))
    return buf[:N]


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
def _crf_tables(H: int, W: int, gaussian_sxy: float, bilateral_sxy: float
                ) -> Tuple[torch.Tensor, ...]:
    """The kernel's constant tables on the host: the 5 Gaussian taps,
    the lattice taps, the row and column upsample taps (index, 2
    weights)."""
    s, gh, gw, radius = lattice(H, W, bilateral_sxy)
    ri, rw = linear_taps(gh, gh * s)
    ci, cw = linear_taps(gw, gw * s)
    return (_gauss_taps_host(gaussian_sxy, GAUSS_RADIUS),
            _gauss_taps_host(bilateral_sxy / s, radius),
            ri[:H], rw[:H], ci[:W], cw[:W])


@functools.lru_cache(maxsize=64)
def _crf_table_buffer(H: int, W: int, gaussian_sxy: float,
                      bilateral_sxy: float, dev: torch.device
                      ) -> torch.Tensor:
    """``_crf_tables`` as one buffer of 4-byte words on ``dev``, in
    their order (csrc/crf.cu:tables_of), copied to the card once per
    (H, W, sxy): the calls after the first copy nothing, so a step
    captures in a CUDA graph."""
    words = [t.contiguous().view(torch.int32).reshape(-1)
             for t in _crf_tables(H, W, gaussian_sxy, bilateral_sxy)]
    return torch.cat(words).to(dev)


def crf_work(H: int, W: int, K: int, bilateral_sxy: float,
             steps: int) -> int:
    """f32 scratch of a csrc/crf.cu call (its ``work``): the lattice
    sums of K clusters x 2 channels and their blur, and one more q with
    two steps or more (the steps alternate between it and q_out)."""
    _, gh, gw, _ = lattice(H, W, bilateral_sxy)
    return 4 * K * gh * gw + (2 * H * W if steps > 1 else 0)


def _crf_launch(q: Optional[torch.Tensor], labels: torch.Tensor,
                unary: Optional[torch.Tensor], norms: int, dead: int,
                q_out: int, mask: int, gaussian_sxy: float,
                gaussian_compat: float, bilateral_sxy: float,
                bilateral_compat: float, num_clusters: int, norm_pass: bool,
                steps: int, mask_dead: bool, work: int) -> None:
    """One call of csrc/crf.cu: the norm pass if asked, then ``steps``
    steps from q. norms, dead, q_out, mask and work are addresses on
    the card (0 for none) of buffers the caller sized."""
    dev = labels.device
    H, W = labels.shape
    s, gh, gw, radius = lattice(H, W, bilateral_sxy)
    tables = _crf_table_buffer(H, W, gaussian_sxy, bilateral_sxy, dev)
    _cuda.launch('crf',
                 0 if q is None else q.data_ptr(), labels.data_ptr(),
                 0 if unary is None else unary.data_ptr(), norms, dead, H,
                 W, num_clusters, s, gh, gw, radius, tables.data_ptr(),
                 gaussian_compat, bilateral_compat, int(norm_pass), steps,
                 int(mask_dead), work, q_out, mask, _cuda.stream_ptr(labels))


def _crf_check(labels: torch.Tensor, num_clusters: int, bilateral_sxy: float,
               **tensors: Optional[torch.Tensor]) -> None:
    """Raise unless labels (H, W) int32 and each given tensor (H, W, 2)
    f32 (``dead``: (1,) int32) lie contiguous on one card, the (H, W,
    2) ones 8-byte aligned (csrc/crf.cu reads and writes a pixel's two
    values as one float2), and the lattice and the cluster count fit
    csrc/crf.cu."""
    dev = labels.device
    H, W = labels.shape
    _cuda.check(labels, 'labels', torch.int32, 2, dev)
    for name, t in tensors.items():
        if t is None:
            continue
        if name == 'dead':
            _cuda.check(t, name, torch.int32, 1, dev)
            continue
        _cuda.check(t, name, torch.float32, 3, dev)
        if tuple(t.shape) != (H, W, 2):
            raise ValueError(f'{name} is {tuple(t.shape)}, expected '
                             f'{(H, W, 2)}')
        if t.data_ptr() % 8:
            raise ValueError(f'{name} must be 8-byte aligned')
    if not 1 <= num_clusters <= KMEANS_MAX_K:
        raise ValueError(f'crf takes 1 to {KMEANS_MAX_K} clusters')
    s, _, _, radius = lattice(H, W, bilateral_sxy)
    if radius > CRF_MAX_RADIUS or s > CRF_MAX_CELL:
        raise ValueError(f'lattice of {s} px cells, radius {radius}: above '
                         f'{CRF_MAX_CELL} px or {CRF_MAX_RADIUS}')


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
    _crf_check(labels, num_clusters, bilateral_sxy)
    H, W = labels.shape
    dev = labels.device
    norms = torch.empty((H, W, 2), dtype=torch.float32, device=dev)
    dead = torch.empty((1,), dtype=torch.int32, device=dev)
    work = torch.empty((crf_work(H, W, num_clusters, bilateral_sxy, 0),),
                       dtype=torch.float32, device=dev)
    _crf_launch(None, labels, None, norms.data_ptr(), dead.data_ptr(), 0, 0,
                gaussian_sxy, 0.0, bilateral_sxy, 0.0, num_clusters, True, 0,
                False, work.data_ptr())
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
    # a view off its 8-byte boundary is copied: the kernel reads a
    # pixel's two values as one float2
    q, unary, norms = (t.contiguous() if t.data_ptr() % 8 == 0 else
                       t.clone(memory_format=torch.contiguous_format)
                       for t in (q, unary, norms))
    labels, dead = labels.contiguous(), dead.contiguous()
    _crf_check(labels, num_clusters, bilateral_sxy, q=q, unary=unary,
               norms=norms, dead=dead)
    H, W = labels.shape
    q_out = torch.empty_like(q)
    mask = torch.empty((H, W), dtype=torch.bool, device=q.device)
    work = torch.empty((crf_work(H, W, num_clusters, bilateral_sxy, 1),),
                       dtype=torch.float32, device=q.device)
    _crf_launch(q, labels, unary, norms.data_ptr(), dead.data_ptr(),
                q_out.data_ptr(), mask.data_ptr(), gaussian_sxy,
                gaussian_compat, bilateral_sxy, bilateral_compat,
                num_clusters, False, 1, True, work.data_ptr())
    return q_out, mask


@functools.lru_cache(maxsize=None)
def _inv255(device: torch.device) -> torch.Tensor:
    """f32(1/255) as a 0-d tensor on ``device``, made once a device, so
    that densecrf_binary copies nothing to the card on a call (and
    captures in a CUDA graph)."""
    return torch.tensor(1.0 / 255.0, dtype=torch.float32, device=device)


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
        rgb.to(torch.float32) * _inv255(rgb.device)
    labels = kmeans_labels(guide.reshape(-1, guide.shape[-1]).contiguous(),
                           num_clusters).reshape(H, W)
    q = _softmax2(-unary)
    if iterations == 0:
        return q[..., 1] > q[..., 0]
    kw = dict(gaussian_sxy=gaussian_sxy, gaussian_compat=gaussian_compat,
              bilateral_sxy=bilateral_sxy, bilateral_compat=bilateral_compat,
              num_clusters=num_clusters)
    if q.device.type != 'cpu':
        return _densecrf_cuda(q, labels, unary, iterations, **kw)
    norms, dead = crf_norms(labels, gaussian_sxy, bilateral_sxy, num_clusters)
    if iterations == 1:
        # a zero norm's NaN has not spread yet after one step
        dead = torch.zeros_like(dead)
    for _ in range(iterations):
        q, mask = crf_step(q, labels, unary, norms, dead, **kw)
    return mask


def _densecrf_cuda(q: torch.Tensor, labels: torch.Tensor,
                   unary: torch.Tensor, iterations: int, gaussian_sxy: float,
                   gaussian_compat: float, bilateral_sxy: float,
                   bilateral_compat: float, num_clusters: int
                   ) -> torch.Tensor:
    """The norm pass and ``iterations`` steps in one csrc/crf.cu call:
    the norms, the flag, the steps' q and the lattice scratch in one
    buffer (addresses into it), the mask in its own."""
    _crf_check(labels, num_clusters, bilateral_sxy, q=q, unary=unary)
    H, W = labels.shape
    n = 2 * H * W
    work = crf_work(H, W, num_clusters, bilateral_sxy, iterations)
    buf = torch.empty((2 * n + work + 1,), dtype=torch.float32,
                      device=q.device)
    mask = torch.empty((H, W), dtype=torch.bool, device=q.device)
    base = buf.data_ptr()
    # norms, q_out, work, then the flag (an int32 in the last word)
    _crf_launch(q, labels, unary, base, base + 4 * (2 * n + work),
                base + 4 * n, mask.data_ptr(), gaussian_sxy, gaussian_compat,
                bilateral_sxy, bilateral_compat, num_clusters, True,
                iterations, iterations > 1, base + 8 * n)
    return mask
