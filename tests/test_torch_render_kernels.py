"""The launch plans of the tiled render kernels, K1 (csrc/splat.cu) and
K4 (csrc/bokeh.cu), on the CPU: what the wrappers compute in Python
before a launch, held against the JAX package's own tables where it
has them. The kernels themselves are held against their plain versions
on the card (tests/test_torch_kernels.py, marked ``gpu``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartoonsegmentation_tpu.ops import bokeh as jbokeh
from cartoonsegmentation_torch.ops import bokeh as tbokeh
from cartoonsegmentation_torch.ops import pointcloud as tpc
from test_torch_ops import _np, _t, assert_bokeh_close
from torch_cpu import torch_threads  # noqa: F401  (autouse)

# the three pass directions of _bokeh_core, as it passes them
_JAX_DIRS = ((0.0, 1.0),
             (math.cos(-math.pi / 6), math.sin(-math.pi / 6)),
             (math.cos(-math.pi * 5 / 6), math.sin(-math.pi * 5 / 6)))


@pytest.mark.parametrize('H,W', [(64, 96), (192, 256), (448, 768),
                                 (576, 1024), (683, 1024), (1024, 1024)])
def test_bokeh_halo_vs_jax_pass_table(H, W):
    """The kernel's halo of each pass is the largest offset the JAX
    package's exact-f32 cell table reaches (its span less one)."""
    halo = tbokeh._halo(H, W, 32)
    for p, (dx, dy) in enumerate(_JAX_DIRS):
        span = jbokeh._pass_table(dx, dy, H, W, 32, jbokeh._SCALE)[3]
        assert int(halo[p].max()) == span - 1
    # the vertical pass has no x offset; the diagonals mirror each other
    assert halo[0, 0] == 0 and (halo[1] == halo[2]).all()


def test_bokeh_halo_at_the_path_size():
    """576x1024: 5 px vertical, (4, 2) px on the diagonals."""
    assert tbokeh._halo(576, 1024, 32).tolist() == [[0, 5], [4, 2], [4, 2]]


@pytest.mark.parametrize('H,W,S,tiled', [(576, 1024, 32, True),
                                         (1024, 1024, 64, True),
                                         (8000, 8000, 32, True),
                                         (12000, 12000, 32, False),
                                         (5000, 5000, 64, False)])
def test_bokeh_takes_the_global_path_past_shared_memory(H, W, S, tiled):
    """The tiled passes while a 32x16 tile and its halo, 16 bytes a
    pixel, fit 227 KB; the global path beyond."""
    assert tbokeh._tiled(H, W, S) is tiled
    h = tbokeh._halo(H, W, S).astype(np.int64)
    need = 16 * (32 + 2 * h[:, 0]) * (16 + 2 * h[:, 1])
    assert bool(need.max() <= 232448) is tiled


def test_bokeh_core_plain_vs_jax_at_halo(rng):
    """192x256: offsets of up to 2 px (the 40x56 case of test_torch_ops
    rounds every offset to 0)."""
    H, W = 192, 256
    assert tbokeh._halo(H, W, 32).max() >= 2
    img = rng.rand(H, W, 3).astype(np.float32)
    weight = rng.rand(H, W).astype(np.float32) * 5e-4
    weight[:40] = 5e-4
    got = tbokeh.bokeh_core_plain(_t(img), _t(weight), 13.0, 32).numpy()
    want = _np(jbokeh._bokeh_core(jnp.asarray(img), jnp.asarray(weight),
                                  13.0, 32))
    assert_bokeh_close(got, want)


@pytest.mark.parametrize('C', [1, 2, 4, 68, 200, 225, 226, 1000])
def test_splat_plan_fits_shared_memory(C):
    """One block's accumulator, weight and z-buffer of a 16x16 tile
    fit 227 KB; payloads up to 225 channels take one chunk, wider ones
    chunks of 225 that cover C."""
    chunk, n_tiles, smem = tpc.splat_plan(576, 1024, C)
    assert smem == 4 * 16 * 16 * (chunk + 2) <= 232448
    assert chunk == min(C, 225)
    assert n_tiles == 36 * 64


@pytest.mark.parametrize('H,W,C,n_tiles', [(576, 1024, 4, 2304),
                                           (576, 1024, 68, 2304),
                                           (97, 131, 4, 7 * 9),
                                           (1, 1, 2, 1),
                                           (683, 1024, 1000, 43 * 64)])
def test_splat_plan_tile_count(H, W, C, n_tiles):
    """A partial tile at the right and bottom edges counts as a tile."""
    assert tpc.splat_plan(H, W, C)[1] == n_tiles

