"""The arithmetic of the two tensor-core attention kernels, emulated on
the CPU and held against their plain versions.

``csrc/samattn.cu`` (K15a) and ``csrc/swinattn.cu`` (K15b) run their
products as ``mma.sync.m16n8k8`` in TF32 on the tensor cores, three
passes an f32 product ("3xTF32"): each operand x is split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, both rounded as
``cvt.rna.tf32.f32`` does (to a 10-bit mantissa, ties away from zero),
and each 8-deep step of a product accumulates ``hi·lo``, ``lo·hi`` and
then ``hi·hi`` into an f32 accumulator. A CUDA kernel has no CPU mode,
so this file repeats that schedule in numpy: K15a's key tiles (64
keys, 32 at hd 80) with their online softmax (a tile crossing grid
rows where the grid is 14 wide, a ragged last tile, the rescale of the
running sums, each tile's p·v summed apart and added in f32) and K15b's
one 64-key tile with folded norms and an exact softmax, padded keys at
-inf. Both are held to the gate the kernels are held to on the card,
1e-5 of the output's range; the same schedule with single-pass TF32
(``hi·hi`` only) misses it by orders of magnitude, which is why the
kernels pay for three passes. Each mma is summed exactly here: the
tensor cores' truncating accumulation, which the kernels keep short
(fresh accumulators a key tile in K15a, the ``hi·hi`` pass apart from
the small ones in K15b), shows only on the card, where
tests/test_torch_kernels.py holds them to the same gate.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import sam as tsam
from cartoonsegmentation_torch.models import swinv2 as tswin
from torch_cpu import torch_threads  # noqa: F401  (autouse)

F32, F64 = np.float32, np.float64
KEYS = 64  # keys a tile in both kernels (K15a: 32 at hd 80)


def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, F32) - hi)


def mma(a, b, acc, passes=3):
    """acc + a·b in 8-deep steps as the kernels issue them: per step the
    three products hi·lo, lo·hi, hi·hi (or hi·hi alone), each summed
    exactly and added to the f32 accumulator."""
    acc = np.array(acc, F32)
    for k0 in range(0, a.shape[1], 8):
        ah, al = split(a[:, k0:k0 + 8])
        bh, bl = split(b[k0:k0 + 8])
        pairs = ((ah, bl), (al, bh), (ah, bh)) if passes == 3 else \
            ((ah, bh),)
        for x, y in pairs:
            acc = (acc.astype(F64) + x.astype(F64) @ y.astype(F64)
                   ).astype(F32)
    return acc


def pad_rows(x, rows):
    out = np.zeros((rows,) + x.shape[1:], F32)
    out[:len(x)] = x
    return out


def samattn_emulated(qkv, bh, bw, Hs, Ws, passes=3):
    """K15a's schedule: q scaled once, key tiles (zero-filled past N,
    those keys at -inf), rel-pos terms indexed per key, online softmax
    rescaled once a tile, each tile's p·v in a fresh accumulator added
    to the rescaled output, the sum divided out at the end."""
    B, N, _, n, hd = qkv.shape
    keys = KEYS // 2 if hd > 64 else KEYS
    out = np.zeros((B, N, n * hd), F32)
    j_all = np.arange(-(-N // keys) * keys)
    for b in range(B):
        for h in range(n):
            q = qkv[b, :, 0, h] * F32(hd ** -0.5)
            k, v = qkv[b, :, 1, h], qkv[b, :, 2, h]
            m = np.full(N, -np.inf, F32)
            l = np.zeros(N, F32)
            o = np.zeros((N, hd), F32)
            for j0 in range(0, N, keys):
                j = j_all[j0:j0 + keys]
                real = j < N
                jr = np.where(real, j, 0)
                s = mma(q, pad_rows(k[j0:j0 + keys], keys).T,
                        np.zeros((N, keys)), passes)
                s = (s + bh[b, h][:, jr // Ws]) + bw[b, h][:, jr % Ws]
                s[:, ~real] = -np.inf
                m_new = np.maximum(m, s.max(1))
                corr = np.exp(m - m_new).astype(F32)
                p = np.exp(s - m_new[:, None]).astype(F32)
                l = (l * corr + p.sum(1, dtype=F32)).astype(F32)
                pv = mma(p, pad_rows(v[j0:j0 + keys], keys),
                         np.zeros((N, hd)), passes)
                o = (o * corr[:, None] + pv).astype(F32)
                m = m_new
            out[b, :, h * hd:(h + 1) * hd] = o / l[:, None]
    return out


def swinattn_emulated(qkv, scale, bias, mask, passes=3):
    """K15b's schedule: q scaled by scale/‖q‖ and k by 1/‖k‖ (norms
    clamped at 1e-12) before the split, one 64-key tile (zero-filled,
    padded keys at -inf), an exact softmax whose sum is divided out by
    one reciprocal a row after p·v."""
    B, N, _, n, hd = qkv.shape
    out = np.zeros((B, N, n * hd), F32)
    real = np.arange(KEYS) < N
    for b in range(B):
        for h in range(n):
            q, k, v = (qkv[b, :, c, h] for c in range(3))
            nq = np.sqrt((q * q).sum(1, dtype=F32))
            nk = np.sqrt((k * k).sum(1, dtype=F32))
            qs = q * (scale[h] / np.maximum(nq, F32(1e-12)))[:, None]
            ks = k * (F32(1) / np.maximum(nk, F32(1e-12)))[:, None]
            s = mma(qs, pad_rows(ks, KEYS).T, np.zeros((N, KEYS)), passes)
            s[:, :N] = s[:, :N] + bias[h]
            if mask is not None:
                s[:, :N] = s[:, :N] + mask[b % len(mask)]
            s[:, ~real] = -np.inf
            p = np.exp(s - s.max(1, keepdims=True)).astype(F32)
            inv = F32(1) / p.sum(1, dtype=F32)
            o = mma(p, pad_rows(v, KEYS), np.zeros((N, hd)), passes)
            out[b, :, h * hd:(h + 1) * hd] = o * inv[:, None]
    return out


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _sam_case(seed, B, side, n, hd, kind):
    rng = np.random.RandomState(seed)
    N = side * side
    qkv = rng.randn(B, N, 3, n, hd).astype(F32)
    bh = rng.randn(B, n, N, side).astype(F32)
    bw = rng.randn(B, n, N, side).astype(F32)
    if kind == 'k=8q':
        # a sharp diagonal: the running max jumps in the tile of each
        # query's own key, after tiles that set it lower
        qkv[:, :, 1] = 8 * qkv[:, :, 0]
    elif kind == 'rising':
        # each grid row's term outgrows the last: every tile raises the
        # max and rescales the sums
        bh = bh + 4 * np.arange(side, dtype=F32)
    return qkv, bh, bw


@pytest.mark.parametrize('B,side,n,hd,kind', [
    (2, 14, 2, 64, 'random'),   # N = 196: tiles cross rows, 4 keys last
    (1, 16, 2, 64, 'random'),   # a square grid, Ws = 16
    (1, 14, 2, 80, 'random'),   # ViT-L/H's head width: 10 k-steps
    (1, 14, 2, 64, 'k=8q'),
    (1, 12, 2, 64, 'rising'),   # N = 144: 3 tiles, 16 keys last
])
def test_samattn_3xtf32_schedule(B, side, n, hd, kind):
    qkv, bh, bw = _sam_case(0, B, side, n, hd, kind)
    want = tsam.rel_pos_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(bh), torch.from_numpy(bw),
        side, side).numpy()
    got = samattn_emulated(qkv, bh, bw, side, side)
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= 1e-5


def _swin_case(seed, B, N, n, hd, nW, kind):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, N, 3, n, hd).astype(F32)
    scale = rng.uniform(5, 100, n).astype(F32)
    bias = (16 / (1 + np.exp(-rng.randn(n, N, N)))).astype(F32)
    mask = None
    if nW:
        mask = np.where(rng.rand(nW, N, N) < 0.3, -100.0, 0.0).astype(F32)
    if kind == 'k=q':
        # cos(q_i, k_i) = 1 at the top scale: a saturated softmax
        qkv[:, :, 1] = qkv[:, :, 0]
        scale[:] = 100.0
    elif kind == 'zero q':
        qkv[:, 3, 0] = 0.0   # a norm under the 1e-12 clamp
    return qkv, scale, bias, mask


@pytest.mark.parametrize('B,N,n,hd,nW,kind', [
    (4, 64, 2, 32, 0, 'random'),    # SwinV2-B's windows
    (4, 64, 2, 32, 2, 'random'),    # shifted, the mask of window b % 2
    (6, 16, 2, 16, 3, 'random'),    # N and hd under the fragment
    (2, 64, 2, 32, 0, 'k=q'),
    (2, 64, 2, 32, 2, 'zero q'),
])
def test_swinattn_3xtf32_schedule(B, N, n, hd, nW, kind):
    qkv, scale, bias, mask = _swin_case(1, B, N, n, hd, nW, kind)
    want = tswin.window_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(scale),
        torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask)).numpy()
    got = swinattn_emulated(qkv, scale, bias, mask)
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= 1e-5


def test_single_pass_tf32_misses_the_gate():
    """One TF32 pass (hi·hi) on the same schedules: about 1e-3 of the
    range for SwinV2 at logit scale 100 and for SAM, two orders of
    magnitude above the 1e-5 gate that three passes meet."""
    qkv, scale, bias, mask = _swin_case(1, 4, 64, 2, 32, 0, 'random')
    scale[:] = 100.0
    want = tswin.window_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(scale),
        torch.from_numpy(bias)).numpy()
    one = rel_err(swinattn_emulated(qkv, scale, bias, None, passes=1), want)
    three = rel_err(swinattn_emulated(qkv, scale, bias, None), want)
    assert one > 1e-4 and three <= 1e-5, (one, three)

    qkv, bh, bw = _sam_case(0, 1, 14, 2, 64, 'random')
    want = tsam.rel_pos_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(bh), torch.from_numpy(bw),
        14, 14).numpy()
    one = rel_err(samattn_emulated(qkv, bh, bw, 14, 14, passes=1), want)
    three = rel_err(samattn_emulated(qkv, bh, bw, 14, 14), want)
    assert one > 1e-4 and three <= 1e-5, (one, three)


def test_tf32_rounding():
    """cvt.rna: 10 mantissa bits kept, a tie rounds away from zero, the
    remainder is exact in f32."""
    x = np.array([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                  1 + 2 ** -12, 3.0], F32)
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                                1.0, 3.0]
    y = np.random.RandomState(0).randn(1000).astype(F32)
    hi, lo = split(y)
    assert np.array_equal(hi + (y - hi), y)
    assert np.abs(y - hi - lo).max() <= np.abs(y).max() * 2 ** -21
