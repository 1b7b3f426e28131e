"""The port's three kernels (plain versions) against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the JAX kernels run
in Pallas interpret mode, as `tests/test_kernels.py` runs them.  Tolerances:
  - cells kernel (K1): bit-exact cell arrays, after cropping the TPU layout's
    (8, 128)-aligned padding to (ceil(H/8), W);
  - IC kernel (K2): exact integer moments, angles within 1e-3 degrees (f32
    atan2 differs by ULPs between backends);
  - BAD kernel (K3): at most int(2e-5 * bytes) + 1 differing descriptor bytes
    (the reference's budget; cos/sin ULPs can flip a rare bit).
`tests/test_torch_cuda.py` holds the same comparisons for the compiled kernels
on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import orientation as JO
from efficient_features_tpu.ops import pallas_kernels as PK
from efficient_features_tpu.ops import window_kernels as JWK
from efficient_features_tpu_torch.ops import detect_kernels as DK
from efficient_features_tpu_torch.ops import orientation as TO
from efficient_features_tpu_torch.ops import window_kernels as WK

from test_torch_cuda import bad_keypoints, tie_image, wrap_image
from util import make_test_image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small inputs gain nothing from intra-op threads, and in a
    parallel test run the threads of each worker contend with the others'
    (measured 13x slower beside one other torch test process)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _budget(n_bytes: int) -> int:
    return int(2e-5 * n_bytes) + 1


IMAGES = {
    "scene": lambda: make_test_image(200, 280, seed=33),
    "odd": lambda: make_test_image(141, 203, seed=8),
    "tie": tie_image,
    "wrap": wrap_image,
}


@pytest.mark.parametrize("which,radius", [
    ("scene", 15), ("scene", 10), ("scene", 1), ("odd", 15), ("odd", 22),
    ("tie", 15), ("wrap", 15), ("wrap", 1)])
def test_cells_plain_matches_pallas(which, radius):
    img = IMAGES[which]()
    h, w = img.shape
    want = [np.asarray(a)[:-(-h // 8), :w]
            for a in PK.fast_harris_nms_cells(jnp.asarray(img), 20, radius)]
    got = DK.fast_harris_nms_cells(_t(img), 20, radius)
    for g, e in zip(got, want):
        assert tuple(g.shape) == e.shape and g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)
    assert (want[2] > 0).any()
    if which == "wrap" and radius == 1:
        assert np.isfinite(want[0][24 // 8, 32])   # the wrap-run corner


def _interior_keypoints(h, w, n, seed):
    rng = np.random.default_rng(seed)
    ys = rng.integers(15, h - 15, n).astype(np.int32)
    xs = rng.integers(15, w - 15, n).astype(np.int32)
    ys[:4] = [15, 15, h - 16, h - 16]
    xs[:4] = [15, w - 16, 15, w - 16]
    return ys, xs


def test_ic_plain_matches_pallas():
    img = make_test_image(200, 280, seed=33)
    h, w = img.shape
    ys, xs = _interior_keypoints(h, w, 64, seed=2)
    valid = np.ones(64, bool)
    valid[::9] = False
    # exact moments, summed over the JAX package's own disc offsets
    patch = img[ys[:, None] + JO._IC_DY[None, :],
                xs[:, None] + JO._IC_DX[None, :]].astype(np.int64)
    m01 = (patch * JO._IC_DY[None, :]).sum(axis=1)
    m10 = (patch * JO._IC_DX[None, :]).sum(axis=1)
    moments = WK.ic_moments_windows(_t(img), _t(ys), _t(xs))
    assert moments.dtype == torch.int32
    np.testing.assert_array_equal(moments.numpy(), np.stack([m01, m10], 1))
    want = np.asarray(JWK.ic_angles_windows(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(valid)))
    got = WK.ic_angles_windows(_t(img), _t(ys), _t(xs), _t(valid)).numpy()
    assert got.dtype == np.float32
    d = np.abs(got - want)
    assert np.minimum(d, 360 - d).max() < 1e-3
    assert (got[~valid] == 0).all()


def test_ic_moments_clamp_at_the_edges():
    """Reads clamp to the image: a keypoint on the edge sees its edge row."""
    img = make_test_image(64, 80, seed=4)
    ys = np.array([0, 63, 0, 30], np.int32)
    xs = np.array([0, 79, 40, 79], np.int32)
    gy = np.clip(ys[:, None] + TO._IC_DY[None, :], 0, 63)
    gx = np.clip(xs[:, None] + TO._IC_DX[None, :], 0, 79)
    v = img[gy, gx].astype(np.int64)
    want = np.stack([(v * TO._IC_DY).sum(1), (v * TO._IC_DX).sum(1)], 1)
    got = WK.ic_moments_windows(_t(img), _t(ys), _t(xs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbits", [256, 512])
def test_bad_plain_matches_pallas(nbits):
    img = make_test_image(200, 280, seed=33)
    h, w = img.shape
    kp = bad_keypoints(h, w, 96, seed=4)
    want = np.asarray(JWK.bad_descriptors_windows(
        jnp.asarray(img), *(jnp.asarray(a) for a in kp), nbits, 1.0,
        formulation="pair"))
    got = WK.bad_descriptors_windows(_t(img), *(_t(a) for a in kp), nbits,
                                     1.0)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert (got.numpy() != want).sum() <= _budget(want.size)
    assert (got.numpy()[~kp[4]] == 0).all()
    assert (got.numpy()[kp[4]] != 0).any()


def test_wrappers_run_the_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    img = _t(make_test_image(96, 128, seed=1))
    ys = torch.tensor([40, 50], dtype=torch.int32)
    xs = torch.tensor([40, 60], dtype=torch.int32)
    kp = [_t(a) for a in bad_keypoints(96, 128, 16, seed=1)]
    counts = (DK.fast_harris_nms_cells.launches,
              WK.ic_moments_windows.launches,
              WK.bad_descriptors_windows.launches)
    for a, b in zip(DK.fast_harris_nms_cells(img, 20, 15),
                    DK.fast_harris_nms_cells_ref(img, 20, 15)):
        assert torch.equal(a, b)
    assert torch.equal(WK.ic_moments_windows(img, ys, xs),
                       TO.ic_moments(img, ys, xs))
    assert torch.equal(WK.bad_descriptors_windows(img, *kp, 256),
                       WK.bad_descriptors_windows_ref(img, *kp, 256))
    assert counts == (DK.fast_harris_nms_cells.launches,
                      WK.ic_moments_windows.launches,
                      WK.bad_descriptors_windows.launches)
