"""K14b's schedule (cartoonsegmentation_torch/csrc/nms_large.cu) and
K8's (csrc/nms.cu) emulated in numpy, against the JAX package's
``batched_nms_fixed`` and ``nms_fixed`` and the port's plain version,
on the CPU.

The kernels run only on a card; here their steps run as they run
them, so that the order of their work is what the tests hold:
- the sort as a rank: each candidate's place is the number of keys
  (jnp.argsort's: the float canonicalised, -0 as +0 and every NaN as
  +NaN, then its total order; ties by index) below its own, counted a
  staged tile of keys at a time;
- K14b: the IoU mask in f32, one 64-bit word per (row, column tile) of
  the upper triangle, the diagonal tile whole (a row's word there holds
  the rows before it too: the IoU is symmetric bit for bit), IoU > thr
  decided as the kernel decides it, without the division; the walk a
  64-row tile at a time: the tile's rows decided all at once in rounds
  (a row is removed once a kept row suppresses it, kept once every
  candidate that could suppress it is decided and none is kept), from
  each row's suppressors within the tile (its diagonal word's bits
  below it); the next tile's word formed from the kept rows' words in
  that column (the carry), and the other warps' ORs into the tiles
  further out applied one tile behind (tile t's kept rows reach
  removed[t + 2 ..] only before tile t + 2 is resolved);
- K8: the walk a 64-row tile at a time, each row of the tile tested
  against the kept list of the earlier tiles and, while still a
  candidate, against the tile's rows before it, then the same rounds;
- both: the walk stopped once n_out kept rows of score key below that
  of -1 are found, and the three-group output (those rows; the rows
  keyed as -1; the kept rows keyed above it, NaN scores among them)
  placed by a block scan of packed counts when the walk runs to the
  end.
Every early stop is checked against the same walk run to the end.
Exact throughout: every case against the port's plain version
(``rtmdet.nms_fixed_plain``, after the category offsets for K14b),
some (ties, -inf, exactly -1.0, the signed zeros and NaNs, across a
tile's edge) also against JAX's ``batched_nms_fixed`` or
``nms_fixed``, computed once a module (each JAX call compiles its scan
anew, ~1-3 s).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartoonsegmentation_tpu.models import maskrcnn as JM
from cartoonsegmentation_torch.models import maskrcnn as TM
from cartoonsegmentation_torch.models import rtmdet as TR
from torch_cpu import torch_threads  # noqa: F401  (autouse)

TILE = 64
WALK_THREADS = 512
RANK_TILE = 8192


def total_order(x: np.ndarray) -> np.ndarray:
    """f32 → uint32: jnp.argsort's key (nms_common.cuh:kb_sort_key),
    the float canonicalised (-0 → +0, every NaN → +NaN), then
    increasing in its total order."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32).copy()
    u[x == 0] = 0
    u[np.isnan(x)] = 0x7fc00000
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def rank_order(scores: np.ndarray) -> np.ndarray:
    """rank_kernel: order[rank(i)] = i, rank(i) the keys below key(i),
    counted a staged tile of keys at a time: the score keys up to i's
    own before it (<=), below it from i on (<)."""
    K = len(scores)
    key = total_order(-scores)
    idx = np.arange(K)
    rank = np.zeros(K, np.int64)
    for t0 in range(0, K, RANK_TILE):
        kj, j = key[None, t0:t0 + RANK_TILE], idx[None, t0:t0 + RANK_TILE]
        rank += np.where(j < idx[:, None], kj <= key[:, None],
                         kj < key[:, None]).sum(1)
    assert sorted(rank) == list(range(K))        # the keys are unique
    order = np.empty(K, np.int64)
    order[rank] = np.arange(K)
    return order


def iou_hit(inter: np.ndarray, den: np.ndarray, thr) -> np.ndarray:
    """mask_kernel's IoU > thr without the division: RN(inter / den) >
    thr exactly when inter > m * den in float64 (both sides exact: m,
    the midpoint of thr and the next float up, has 25 significant bits,
    den 24), or inter = m * den and round-to-nearest-even goes up;
    non-finite values take the f32 division."""
    thr = np.float32(thr)
    up = np.nextafter(thr, np.float32(np.inf))
    mid = 0.5 * (np.float64(thr) + np.float64(up))
    tie_up = (np.asarray(up).view(np.uint32) & 1) == 0
    i64, p = np.float64(1) * inter, mid * np.asarray(den, np.float64)
    with np.errstate(all='ignore'):
        quot = np.asarray(inter, np.float32) / np.asarray(den, np.float32)
    return np.where(np.isfinite(inter) & np.isfinite(den),
                    (i64 > p) | ((i64 == p) & tie_up), quot > thr)


def mask_words(sb: np.ndarray, thr: float) -> np.ndarray:
    """mask_kernel: (K, words) uint64, bit b of word (i, c) set when
    j = 64c + b != i and IoU(i, j) > thr, in the kernel's f32 order;
    only the words of column tiles c >= i // 64 are written."""
    K = len(sb)
    words = -(-K // TILE)
    zero = np.float32(0)
    area = np.maximum(sb[:, 2] - sb[:, 0], zero) * \
        np.maximum(sb[:, 3] - sb[:, 1], zero)
    out = np.zeros((K, words), np.uint64)
    j = np.arange(words * TILE)
    for r0 in range(0, K, TILE):
        a = sb[r0:r0 + TILE]
        iw = np.maximum(np.minimum(a[:, None, 2], sb[None, :, 2])
                        - np.maximum(a[:, None, 0], sb[None, :, 0]), zero)
        ih = np.maximum(np.minimum(a[:, None, 3], sb[None, :, 3])
                        - np.maximum(a[:, None, 1], sb[None, :, 1]), zero)
        inter = iw * ih
        den = np.maximum(area[r0:r0 + TILE, None] + area[None, :] - inter,
                         np.float32(1e-9))
        hit = np.zeros((len(a), words * TILE), bool)
        hit[:, :K] = iou_hit(inter, den, thr)
        rows = np.arange(r0, r0 + len(a))[:, None]
        hit &= (j[None, :] >= r0) & (j[None, :] != rows)
        diag = hit[:, r0:r0 + len(a)]
        assert (diag == diag.T).all()                # the IoU is symmetric
        packed = np.packbits(hit.reshape(len(a), words, TILE), axis=-1,
                             bitorder='little')
        out[r0:r0 + len(a)] = packed.view('<u8')[..., 0]
    return out


def tile_keep(cand: int, sup: list) -> int:
    """nms_common.cuh:kb_nms_tile_keep: a tile's kept rows as a fixed
    point, in rounds; sup[j] the candidates before row j that suppress
    it."""
    kept, undecided, rounds = 0, cand, 0
    while undecided:
        nk = nr = 0
        for j in range(TILE):
            if (undecided >> j) & 1:
                if sup[j] & kept:
                    nr |= 1 << j
                elif not sup[j] & (kept | undecided):
                    nk |= 1 << j
        assert (nk | nr) & (undecided & -undecided)   # the lowest
        kept |= nk
        undecided &= ~(nk | nr)
        rounds += 1
    assert rounds <= bin(cand).count('1')
    return kept


def walk(mask: np.ndarray, lt: np.ndarray, n_out: int, stop: bool = True):
    """walk_kernel's loop, a step a tile: (kept words, tiles resolved,
    G1 rows in order). lt: the rows whose score key is below that of
    -1."""
    K, words = mask.shape
    removed = [0] * words
    kept_w = [0] * words
    carry = 0                      # tile r - 1's kept rows in column r
    g1 = []
    for r in range(words):
        t = r - 2
        if t >= 0:
            # in step r - 1 the pushers OR-ed tile t's kept rows into t + 2 ..
            rows = [TILE * t + j for j in range(TILE)
                    if (kept_w[t] >> j) & 1]
            if rows:
                acc = np.bitwise_or.reduce(mask[rows, r:], axis=0)
                for w in range(r, words):
                    removed[w] |= int(acc[w - r])
        n = min(TILE, K - TILE * r)
        cand = ~(removed[r] | carry) & ((1 << n) - 1)
        sup = [int(mask[TILE * r + j, r]) & ((1 << j) - 1) & cand
               if j < n else 0 for j in range(TILE)]
        kept = tile_keep(cand, sup)
        carry = 0
        if r + 1 < words:
            for j in range(n):
                if (kept >> j) & 1:
                    carry |= int(mask[TILE * r + j, r + 1])
        kept_w[r] = kept
        g1 += [TILE * r + j for j in range(n)
               if (kept >> j) & 1 and lt[TILE * r + j]]
        if stop and len(g1) >= n_out:
            return kept_w, r + 1, g1
    return kept_w, words, g1


def place(kept_w, g1, key1, e, n_out):
    """The output rows: G1 as the walk wrote them; when it ran to the
    end, G2 and G3 after it by the block scan of packed counts."""
    if len(g1) >= n_out:
        return g1[:n_out]
    K = len(key1)
    kept = np.array([(kept_w[p >> 6] >> (p & 63)) & 1 for p in range(K)],
                    bool)
    is2 = ~kept | (key1 == e)
    is3 = kept & (key1 > e)
    per = -(-K // WALK_THREADS)
    cnt = np.zeros(WALK_THREADS, np.uint32)
    for t in range(WALK_THREADS):
        sl = slice(min(K, t * per), min(K, t * per + per))
        cnt[t] = is2[sl].sum() + 65536 * is3[sl].sum()
    before = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.uint32)
    total2 = int(cnt.sum() & 0xffff)
    top = [None] * n_out
    top[:len(g1)] = g1
    for t in range(WALK_THREADS):
        q2 = len(g1) + int(before[t] & 0xffff)
        q3 = len(g1) + total2 + int(before[t] >> 16)
        for p in range(min(K, t * per), min(K, t * per + per)):
            if is2[p]:
                q, q2 = q2, q2 + 1
            elif is3[p]:
                q, q3 = q3, q3 + 1
            else:
                continue
            if q < n_out:
                top[q] = p
    assert None not in top
    return top


def emulate(boxes, scores, iou_thr, n_out):
    """K14b on one call: (keep_idx, keep_mask, tiles walked, tiles)
    with the early stop, checked against the walk run to the end."""
    order = rank_order(scores)
    mask = mask_words(boxes[order], iou_thr)
    s = scores[order]
    key1 = total_order(-s)
    e = total_order(np.float32(1.0))
    lt = key1 < e
    kept_w, walked, g1 = walk(mask, lt, n_out)
    top = place(kept_w, g1, key1, e, n_out)
    full_w = kept_w
    if walked < mask.shape[1]:                   # an early stop
        full_w, _, full_g1 = walk(mask, lt, n_out, stop=False)
        assert top == place(full_w, full_g1, key1, e, n_out)
    kept_top = np.array([(full_w[p >> 6] >> (p & 63)) & 1 for p in top],
                        bool)
    return order[top], kept_top & (s[top] > -1.0), walked, mask.shape[1]


def offset_boxes(boxes, cats):
    """batched_nms_fixed's category offsets, in f32 as torch adds them."""
    extent = np.float32(boxes.max()) + np.float32(1.0)
    return boxes + (cats.astype(np.float32) * extent)[:, None]


def signed_scores(rng, K: int) -> np.ndarray:
    """Scores in a few values with +0.0, -0.0, NaNs of either sign and
    two payloads, -inf and -1.0 among them (as tests/test_torch_kernels.py
    makes them for the card)."""
    bits = np.array([0x00000000, 0x80000000, 0x7fc00000, 0xffc00000,
                     0x7f800001, 0xff800000, 0xbf800000, 0x3f000000,
                     0x3e800000], np.uint32)
    return bits[rng.randint(0, len(bits), K)].view(np.float32).copy()


def make_case(kind: str, K: int, seed: int):
    """(boxes, scores, cats): clustered boxes with duplicates, and
    scores tied (bf16-valued), -inf, exactly -1.0, +-0.0, the signed
    zeros and NaNs, one cluster (all but one suppressed) or disjoint
    boxes (nothing suppressed)."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 200, (K // 8 + 1, 2))
    c = centres[rng.randint(0, len(centres), K)] + rng.randn(K, 2) * 3
    wh = rng.uniform(10, 40, (K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[K // 2:K // 2 + 5] = boxes[K // 2]
    scores = torch.from_numpy(rng.rand(K).astype(np.float32)).bfloat16()
    scores = scores.float().numpy()
    cats = rng.randint(0, 3, K).astype(np.int32)
    if kind == 'ties':
        scores = (rng.randint(0, 4, K) / 4.0).astype(np.float32)
    elif kind == 'inf':
        scores[rng.rand(K) < 0.3] = -np.inf
    elif kind == 'mixed':
        scores = (rng.randint(-2, 3, K) / 2.0).astype(np.float32)
        scores[rng.rand(K) < 0.2] = -np.inf
    elif kind == 'minus_one':
        scores[rng.rand(K) < 0.3] = -1.0
        scores[rng.rand(K) < 0.1] = -np.inf
        scores[rng.rand(K) < 0.1] = -2.0
    elif kind == 'zeros':
        scores = np.where(rng.rand(K) < 0.5, np.float32(0.0),
                          np.float32(-0.0)).astype(np.float32)
        scores[rng.rand(K) < 0.2] = 0.5
    elif kind == 'signed':
        scores = signed_scores(rng, K)
    elif kind == 'cluster':
        boxes = (np.array([10, 10, 50, 50], np.float32)
                 + rng.uniform(0, 0.5, (K, 4)).astype(np.float32))
        cats[:] = 0
    elif kind == 'disjoint':
        g = np.arange(K, dtype=np.float32)
        boxes = np.stack([g * 20, g * 0, g * 20 + 10, g * 0 + 10], 1)
        cats[:] = 0
    return boxes, scores, cats


# (kind, K, iou_thr, n_out, held against JAX too)
CASES = [('mixed', 2048, 0.5, 2048, True), ('mixed', 65, 0.5, 65, True),
         ('inf', 2048, 0.5, 2048, False),
         ('minus_one', 2048, 0.5, 100, False), ('ties', 200, 0.5, 60, False),
         ('inf', 200, 0.5, 200, False), ('minus_one', 200, 0.5, 200, False),
         ('zeros', 200, 0.5, 150, False), ('signed', 200, 0.5, 150, True),
         ('cluster', 200, 0.5, 200, False),
         ('disjoint', 200, 0.5, 60, False), ('clusters', 1, 0.5, 1, False),
         ('clusters', 63, 0.5, 63, False), ('clusters', 64, 0.5, 64, False),
         ('clusters', 65, 0.5, 65, False)]


@pytest.fixture(scope='module')
def jax_keeps():
    out = {}
    for i, (kind, K, thr, n_out, vs_jax) in enumerate(CASES):
        if vs_jax:
            boxes, scores, cats = make_case(kind, K, i)
            ji, jm = JM.batched_nms_fixed(jnp.asarray(boxes),
                                          jnp.asarray(scores),
                                          jnp.asarray(cats), thr, n_out)
            out[i] = np.asarray(ji), np.asarray(jm)
    return out


@pytest.mark.parametrize('i', range(len(CASES)),
                         ids=[f'{c[0]}-{c[1]}-{c[3]}' for c in CASES])
def test_schedule_vs_reference(jax_keeps, i):
    """Every slot of the emulated kernel equal to the plain version's
    and (where marked) to JAX's batched_nms_fixed, as the port's own
    batched_nms_fixed is; the disjoint boxes stop the walk early, the
    cluster keeps one box."""
    kind, K, thr, n_out, vs_jax = CASES[i]
    boxes, scores, cats = make_case(kind, K, i)
    shifted = offset_boxes(boxes, cats)
    idx, mask, walked, tiles = emulate(shifted, scores, thr, n_out)
    pi, pm = TR.nms_fixed_plain(torch.from_numpy(shifted),
                                torch.from_numpy(scores), thr, n_out)
    np.testing.assert_array_equal(idx, pi.numpy())
    np.testing.assert_array_equal(mask, pm.numpy())
    if vs_jax:
        np.testing.assert_array_equal(idx, jax_keeps[i][0])
        np.testing.assert_array_equal(mask, jax_keeps[i][1])
        # the port's own batched_nms_fixed (its CPU path)
        bi, bm = TM.batched_nms_fixed(*map(torch.from_numpy,
                                           (boxes, scores, cats)),
                                      thr, n_out)
        np.testing.assert_array_equal(bi.numpy(), jax_keeps[i][0])
        np.testing.assert_array_equal(bm.numpy(), jax_keeps[i][1])
    if kind == 'disjoint':
        assert walked == -(-n_out // TILE) < tiles
    if kind == 'cluster':
        assert mask.sum() == 1


def test_schedule_rpn_size():
    """The RPN's call, K = 4,756 over 5 levels (IoU 0.7, 1000 out),
    -inf present, against the port's plain version: the walk stops
    before its last tile."""
    boxes, scores, _ = make_case('inf', 4756, 7)
    boxes = boxes * np.float32(2.0)
    cats = np.repeat(np.arange(5), [1000, 1000, 1000, 1000, 756]).astype(
        np.int32)
    shifted = offset_boxes(boxes, cats)
    idx, mask, walked, tiles = emulate(shifted, scores, 0.7, 1000)
    pi, pm = TR.nms_fixed_plain(torch.from_numpy(shifted),
                                torch.from_numpy(scores), 0.7, 1000)
    np.testing.assert_array_equal(idx, pi.numpy())
    np.testing.assert_array_equal(mask, pm.numpy())
    assert walked < tiles == 75


@pytest.mark.parametrize('thr', [0.5, 0.7, 0.0, 2.0 ** -149],
                         ids=['0.5', '0.7', '0', 'subnormal'])
def test_iou_rule_is_the_division(thr):
    """The division-free rule equals f32 inter / den > thr: on random
    pairs, on the f32 values from 3 ulps below to 3 above m * den (the
    quotient rounding to thr and to the float above it), on non-finite
    values, and on exact midpoints, which f32 inter and den reach only
    where thr is 0 or subnormal (round-to-even going down at 0, up at
    the least subnormal)."""
    rng = np.random.RandomState(3)
    t32 = np.float32(thr)
    up = np.nextafter(t32, np.float32(np.inf))
    mid = 0.5 * (np.float64(t32) + np.float64(up))
    den = rng.uniform(1, 1e4, 4000).astype(np.float32)
    inter = [(den * rng.uniform(0, 1, 4000)).astype(np.float32)]
    near = (mid * den).astype(np.float32)
    for _ in range(4):
        inter.append(near)
        near = np.nextafter(near, np.float32(-np.inf))
    near = inter[1]
    for _ in range(3):
        near = np.nextafter(near, np.float32(np.inf))
        inter.append(near)
    dens = [den] * len(inter)
    odd = [np.float32(np.inf), np.float32(-np.inf), np.float32(np.nan)]
    inter += [np.array(odd, np.float32), np.full(3, 5, np.float32)]
    dens += [np.full(3, 8, np.float32), np.array(odd, np.float32)]
    # inter / 2^10 exactly the midpoint, and the floats either side
    tie = np.float32(mid * 2.0 ** 10)
    assert np.float64(tie) == mid * 2.0 ** 10 or t32 >= 2.0 ** -126
    inter.append(np.array([np.nextafter(tie, np.float32(0)), tie,
                           np.nextafter(tie, np.float32(1))], np.float32))
    dens.append(np.full(3, 2.0 ** 10, np.float32))
    inter, den = np.concatenate(inter), np.concatenate(dens)
    with np.errstate(all='ignore'):
        quot = inter / den
    np.testing.assert_array_equal(iou_hit(inter, den, thr), quot > t32)
    if t32 >= 2.0 ** -126:                  # the boundary is crossed
        assert (quot == t32).any() and (quot == up).any()
    else:                                   # an exact midpoint, both ways
        assert np.float64(inter[-2]) / np.float64(den[-2]) == mid
        assert (quot[-2] > t32) == (thr > 0)


# ---------------------------------------------------------------------------
# K8 (csrc/nms.cu): one block, K <= 512
# ---------------------------------------------------------------------------

def pair_hits(sb: np.ndarray, thr: float) -> np.ndarray:
    """(K, K) bool: IoU(i, j) > thr as kb_iou_above decides it, in f32
    (symmetric bit for bit), a box against itself left out."""
    zero = np.float32(0)
    area = np.maximum(sb[:, 2] - sb[:, 0], zero) * \
        np.maximum(sb[:, 3] - sb[:, 1], zero)
    iw = np.maximum(np.minimum(sb[:, None, 2], sb[None, :, 2])
                    - np.maximum(sb[:, None, 0], sb[None, :, 0]), zero)
    ih = np.maximum(np.minimum(sb[:, None, 3], sb[None, :, 3])
                    - np.maximum(sb[:, None, 1], sb[None, :, 1]), zero)
    inter = iw * ih
    den = np.maximum(area[:, None] + area[None, :] - inter, np.float32(1e-9))
    hit = iou_hit(inter, den, thr)
    assert (hit == hit.T).all()
    np.fill_diagonal(hit, False)
    return hit


def k8_walk(hit: np.ndarray, lt: np.ndarray, n_out: int, stop: bool = True):
    """nms_kernel's walk, a step a tile: each row of the tile is removed
    when a row of the kept list (the earlier tiles' kept rows) suppresses
    it; a row still a candidate gets its suppressors among the tile's
    rows before it; then the tile's fixed point. (kept words, tiles
    walked, G1 rows in order)."""
    K = len(hit)
    tiles = -(-K // TILE)
    kept_rows, kept_w, g1 = [], [0] * tiles, []
    for r in range(tiles):
        n = min(TILE, K - TILE * r)
        removed, sup = 0, [0] * TILE
        for jj in range(n):
            j = TILE * r + jj
            if kept_rows and hit[kept_rows, j].any():
                removed |= 1 << jj
                continue
            sup[jj] = sum(1 << ii for ii in range(jj)
                          if hit[TILE * r + ii, j])
        cand = ~removed & ((1 << n) - 1)
        kept = tile_keep(cand, [x & cand for x in sup])
        rows = [TILE * r + jj for jj in range(n) if (kept >> jj) & 1]
        kept_rows += rows
        kept_w[r] = kept
        g1 += [p for p in rows if lt[p]]
        if stop and len(g1) >= n_out:
            return kept_w, r + 1, g1
    return kept_w, tiles, g1


def emulate_k8(boxes, scores, iou_thr, n_out):
    """K8 on one call: (keep_idx, keep_mask, tiles walked, tiles) with
    the early stop, checked against the walk run to the end."""
    order = rank_order(scores)
    s = scores[order]
    hit = pair_hits(boxes[order], iou_thr)
    key1 = total_order(-s)
    e = total_order(np.float32(1.0))
    lt = key1 < e
    kept_w, walked, g1 = k8_walk(hit, lt, n_out)
    top = place(kept_w, g1, key1, e, n_out)
    full_w = kept_w
    if walked < len(kept_w):                     # an early stop
        full_w, _, full_g1 = k8_walk(hit, lt, n_out, stop=False)
        assert top == place(full_w, full_g1, key1, e, n_out)
    kept_top = np.array([(full_w[p >> 6] >> (p & 63)) & 1 for p in top],
                        bool)
    return order[top], kept_top & (s[top] > -1.0), walked, len(kept_w)


# (kind, K, n_out, held against JAX's nms_fixed too), IoU 0.6
K8_CASES = [('clusters', 512, 100, True), ('signed', 512, 512, True),
            ('signed', 97, 40, False), ('ties', 130, 130, False),
            ('minus_one', 300, 300, False), ('inf', 512, 100, False),
            ('cluster', 512, 100, False), ('disjoint', 512, 100, False),
            ('clusters', 1, 1, False), ('clusters', 65, 65, False)]


@pytest.fixture(scope='module')
def jax_k8_keeps():
    import jax
    from cartoonsegmentation_tpu.models import rtmdet as JR
    nms = jax.jit(JR.nms_fixed, static_argnums=(2, 3))
    out = {}
    for i, (kind, K, n_out, vs_jax) in enumerate(K8_CASES):
        if vs_jax:
            boxes, scores, _ = make_case(kind, K, 100 + i)
            ji, jm = nms(jnp.asarray(boxes), jnp.asarray(scores), 0.6, n_out)
            out[i] = np.asarray(ji), np.asarray(jm)
    return out


@pytest.mark.parametrize('i', range(len(K8_CASES)),
                         ids=[f'{c[0]}-{c[1]}-{c[2]}' for c in K8_CASES])
def test_k8_schedule_vs_reference(jax_k8_keeps, i):
    """Every slot of the emulated K8 equal to the plain version's and
    (where marked) to JAX's nms_fixed; the disjoint boxes stop the walk
    at the tile of the n_out-th box, the cluster keeps one box."""
    kind, K, n_out, vs_jax = K8_CASES[i]
    boxes, scores, _ = make_case(kind, K, 100 + i)
    idx, mask, walked, tiles = emulate_k8(boxes, scores, 0.6, n_out)
    pi, pm = TR.nms_fixed_plain(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.6, n_out)
    np.testing.assert_array_equal(idx, pi.numpy())
    np.testing.assert_array_equal(mask, pm.numpy())
    if vs_jax:
        np.testing.assert_array_equal(idx, jax_k8_keeps[i][0])
        np.testing.assert_array_equal(mask, jax_k8_keeps[i][1])
    if kind == 'disjoint':
        assert walked == -(-n_out // TILE) < tiles
    if kind == 'cluster':
        assert mask.sum() == 1
