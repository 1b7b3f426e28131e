"""The PyTorch port's copied tables and BAD parameters equal the JAX package's.

The port keeps a numpy-only copy of `utils/semantics.py` and reads the BAD
assets by file path, so that it never imports jax.  These tests hold the two
copies equal, exactly, and check that the port really imports without jax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from efficient_features_tpu.models import params as JPARAMS
from efficient_features_tpu.utils import semantics as JS
from efficient_features_tpu_torch.models import params as TPARAMS
from efficient_features_tpu_torch.utils import semantics as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [
    "PATCH_SIZE", "HALF_PATCH_SIZE", "HARRIS_BLOCK_SIZE", "HARRIS_K",
    "HARRIS_SCALE", "U_MAX", "FAST_CIRCLE", "FAST_ARC_LEN", "RESIZE_BITS",
    "BLUR_BITS", "ROWS_COUNT"])
def test_constant_tables_equal(name):
    a, b = getattr(JS, name), getattr(TS, name)
    assert type(a) is type(b)
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("scale_factor,nlevels,h,w,nfeatures", [
    (1.2, 8, 2160, 3840, 40000), (1.2, 8, 200, 280, 500),
    (1.5, 4, 97, 131, 1000), (2.0, 3, 480, 640, 7)])
def test_host_math_equal(scale_factor, nlevels, h, w, nfeatures):
    assert (JS.pyramid_scales(scale_factor, nlevels)
            == TS.pyramid_scales(scale_factor, nlevels))
    assert (JS.pyramid_shapes(h, w, scale_factor, nlevels)
            == TS.pyramid_shapes(h, w, scale_factor, nlevels))
    assert (JS.features_per_level(nfeatures, scale_factor, nlevels)
            == TS.features_per_level(nfeatures, scale_factor, nlevels))
    for dst, src in zip(TS.pyramid_shapes(h, w, scale_factor, nlevels)[1:],
                        TS.pyramid_shapes(h, w, scale_factor, nlevels)):
        for d, s in zip(dst, src):
            for a, b in zip(JS.resize_axis_coeffs(d, s),
                            TS.resize_axis_coeffs(d, s)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


@pytest.mark.parametrize("radius", [1, 2, 5, 9, 10, 15, 31, 48])
def test_disc_tables_equal(radius):
    assert JS.disc_offsets(radius) == TS.disc_offsets(radius)
    assert JS.disc_row_extents(radius) == TS.disc_row_extents(radius)
    # the cells kernel indexes its table by dy + (radius - 1)
    assert [dy for dy, _ in TS.disc_row_extents(radius)] == \
        list(range(-(radius - 1), radius))


def test_blur_and_reflect_tables_equal():
    np.testing.assert_array_equal(JS.gaussian_kernel7_fixed(),
                                  TS.gaussian_kernel7_fixed())
    for n in (1, 2, 7, 40):
        idx = np.arange(-3, n + 3)
        if n < 4:
            idx = np.arange(-(n - 1), 2 * n - 1)
        np.testing.assert_array_equal(JS.reflect101_index(idx, n),
                                      TS.reflect101_index(idx, n))


@pytest.mark.parametrize("nbits", [256, 512])
def test_bad_params_carry_over(nbits):
    """`bad_params_from_numpy` takes the JAX package's arrays unchanged."""
    box_pairs, thresholds = JPARAMS.load_bad_params(nbits)
    got = TPARAMS.bad_params_from_numpy(box_pairs, thresholds, "cpu")
    assert got.nbits == nbits
    assert got.boxes.dtype == torch.float32 and got.boxes.shape == (5, nbits)
    np.testing.assert_array_equal(got.boxes.numpy(),
                                  box_pairs.T.astype(np.float32))
    np.testing.assert_array_equal(got.thresholds.numpy(), thresholds)
    mine = TPARAMS.load_bad_params(nbits)
    np.testing.assert_array_equal(mine[0], box_pairs)
    np.testing.assert_array_equal(mine[1], thresholds)
    shipped = TPARAMS.bad_params(nbits, "cpu")
    assert torch.equal(shipped.boxes, got.boxes)
    assert torch.equal(shipped.thresholds, got.thresholds)


def test_bad_params_reject_bad_shapes():
    box_pairs, thresholds = JPARAMS.load_bad_params(256)
    with pytest.raises(ValueError, match="box_pairs"):
        TPARAMS.bad_params_from_numpy(box_pairs[:, :4], thresholds, "cpu")
    with pytest.raises(ValueError, match="thresholds"):
        TPARAMS.bad_params_from_numpy(box_pairs, thresholds[:-1], "cpu")
    with pytest.raises(ValueError, match="256 or 512"):
        TPARAMS.load_bad_params(128)


def test_port_imports_without_jax():
    """The port must start where jax is absent (the GPU machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['efficient_features_tpu'] = None\n"
        "import efficient_features_tpu_torch as T\n"
        "from efficient_features_tpu_torch import _build\n"
        "import importlib, pkgutil\n"
        "names = [m.name for m in pkgutil.walk_packages(T.__path__, "
        "T.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('ops.image', 'ops.window_kernels', 'ops.matcher', "
        "'ops.ransac', 'parallel.sharding', 'parallel.launch', "
        "'samples.hpatches_description', 'samples.sample_image_sequence', "
        "'tools.eval_matching', 'tools.profile_paths', "
        "'tools.dryrun_multichip', 'tools.oncard'):\n"
        "    assert T.__name__ + '.' + want in names, want\n"
        "assert 'jaxlib' not in sys.modules\n"
        "print(sorted(T.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "EfficientFeatures" in out.stdout
