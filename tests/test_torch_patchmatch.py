"""The port's PatchMatch binding (``ops/patchmatch_native.py``) against
the JAX package's: the same csrc/patchmatch.cpp built with the same g++
flags into the port's own build folder, byte-equal outputs on the same
inputs and seeds; a failed build raises with g++'s message (model:
tests/test_patchmatch_native.py).
"""
import numpy as np
import pytest

from cartoonsegmentation_tpu.ops import patchmatch_native as jpm
from cartoonsegmentation_torch.ops import patchmatch_native as tpm
from torch_cpu import torch_threads  # noqa: F401  (autouse)


def _case(seed, h=72, w=96, c=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // w + 40 * k) % 256 for k in range(c)],
                   -1).astype(np.uint8)
    img = (img + rng.randint(0, 30, img.shape)).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[20:45, 30:70] = 255
    mask[rng.rand(h, w) < 0.03] = 1               # scattered holes, > 0
    return img, mask


def test_builds_into_the_port_folder():
    lib = tpm.build_library()
    assert lib.parent == tpm.BUILD_DIR and lib.exists()
    assert tpm.BUILD_DIR.name == '_build' and \
        tpm.BUILD_DIR.parent.name == 'cartoonsegmentation_torch'
    assert tpm.SRC.read_bytes() == open(jpm._SRC, 'rb').read()
    assert tpm.build_library() == lib                # built once


@pytest.mark.parametrize('seed,patch,iters,c', [
    (0, 3, 4, 3), (1, 5, 2, 3), (2, 7, 4, 1), (3, 3, 4, 4)],
    ids=['p3', 'p5-2iter', 'grey', 'rgba'])
def test_inpaint_byte_equal(seed, patch, iters, c):
    img, mask = _case(seed, c=c)
    if c == 1:
        img = img[..., 0]
    got = tpm.inpaint(img, mask, patch_size=patch, iterations=iters,
                      seed=seed)
    want = jpm.inpaint(img, mask, patch_size=patch, iterations=iters,
                       seed=seed)
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0])
    assert not np.array_equal(got[mask > 0], img[mask > 0])


def test_inpaint_regularity_byte_equal():
    img, mask = _case(4)
    yy, xx = np.mgrid[0:72, 0:96].astype(np.float32)
    ijmap = np.stack([yy / 72, xx / 96, np.zeros_like(xx)], -1)
    got = tpm.inpaint_regularity(img, mask, ijmap, patch_size=5,
                                 guide_weight=2.0, seed=9)
    want = jpm.inpaint_regularity(img, mask, ijmap, patch_size=5,
                                  guide_weight=2.0, seed=9)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, tpm.inpaint(img, mask, patch_size=5,
                                               seed=9))
    with pytest.raises(ValueError, match='float32'):
        tpm.inpaint_regularity(img, mask, ijmap.astype(np.float64))


def test_failed_build_raises_with_gxx_message(tmp_path, monkeypatch):
    bad = tmp_path / 'patchmatch.cpp'
    bad.write_text('extern "C" void pm_inpaint( { not c++ }\n')
    monkeypatch.setattr(tpm, 'SRC', bad)
    monkeypatch.setattr(tpm, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed') as e:
        tpm.build_library()
    assert 'error' in str(e.value)
    assert not list((tmp_path / 'build').glob('*.so'))
