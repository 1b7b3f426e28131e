"""The port's HashSIFT modules (plain versions) against the JAX package.

On the CPU the warp (K4) and histogram (K5) wrappers run their plain PyTorch
versions; the JAX window kernels run in Pallas interpret mode, as
`tests/test_kernels.py` and `tests/test_buckets.py` run them.  Tolerances:
  - projection matrices and spatial weights: exact;
  - patches: |diff| <= 1 on fewer than 1e-3 of the pixels (the JAX window
    kernels' own budget against the gather path);
  - histogram rows: |diff| <= 1 on fewer than 2e-3 of the entries (f32
    summation order and atan2 ULPs, as in `test_hs_hist_kernel_parity`);
  - descriptors: at most int(1e-4 * bytes) + 1 differing bytes, the
    reference's HashSIFT budget.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.models import params as JPR
from efficient_features_tpu.ops import hash_sift as JHS
from efficient_features_tpu.ops import window_kernels as JWK
from efficient_features_tpu_torch import pipeline as TP
from efficient_features_tpu_torch.models import params as TPR
from efficient_features_tpu_torch.ops import hash_sift as THS
from efficient_features_tpu_torch.ops import window_kernels as WK

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

H, W = 160, 224


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _budget(n_bytes: int) -> int:
    return int(1e-4 * n_bytes) + 1


def warp_keypoints(h, w, size, n, seed):
    """(x, y, size, angle, valid): keypoints on the image corners and edges,
    a quarter of them with angle -1 (no rotation), 10% invalid."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w - 1, n).astype(np.float32)
    y = rng.uniform(0, h - 1, n).astype(np.float32)
    x[:6] = [0, w - 1, 0, w - 1, 0.25, w / 2]
    y[:6] = [0, 0, h - 1, h - 1, h / 2, 0.25]
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::4] = -1.0
    valid = rng.random(n) < 0.9
    valid[:6] = True
    return x, y, np.full(n, size, np.float32), angle, valid


@pytest.fixture(scope="module")
def img():
    return make_test_image(H, W, seed=5)


def _jwarp(img, kp, size):
    """The JAX window kernel for this size: the base kernel, the octave
    bucket kernel up to `_S_CAP`, else None (only the gather path)."""
    args = [jnp.asarray(a) for a in (img, *kp)]
    if size <= JWK.max_window_size(1.0) + 1:        # detect-sized: base
        return np.asarray(JWK.warp_patches_windows(*args, 1.0))
    if size / 32.0 <= JWK._S_CAP:
        return np.asarray(JWK.warp_patches_windows_big(
            *args, 1.0, JWK.bucket_scale(size / 32.0)))
    return None


def _close_u8(got: np.ndarray, want: np.ndarray, share: float):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() < share


@pytest.mark.parametrize("nbits", [256, 512])
def test_projection_params_match_jax(nbits):
    B = TPR.load_hash_sift_matrix(nbits)
    np.testing.assert_array_equal(B, JPR.load_hash_sift_matrix(nbits))
    assert B.shape == (nbits, 129) and B.dtype == np.float32
    b0, bp = JHS.hs_fused_projection(nbits)
    prm = TPR.hash_sift_params_from_numpy(B, "cpu")
    np.testing.assert_array_equal(prm.b0.numpy(), b0)
    np.testing.assert_array_equal(prm.bp.numpy(), bp)
    assert TPR.hash_sift_params(nbits, "cpu") is \
        TPR.hash_sift_params(nbits, "cpu")
    with pytest.raises(ValueError, match="256 or 512"):
        TPR.load_hash_sift_matrix(128)
    with pytest.raises(ValueError, match="129"):
        TPR.hash_sift_params_from_numpy(B[:, :128], "cpu")


def test_spatial_weight_core_matches_jax():
    core = THS.spatial_weight_core()
    np.testing.assert_array_equal(core, JHS._spatial_weight_core()[:900, :16])
    np.testing.assert_array_equal(THS._spatial_weight_matrix(),
                                  JHS._spatial_weight_matrix())
    # the histogram kernel sums bin (r, c) over core_bin_rows(r) x
    # core_bin_rows(c) only: every nonzero weight must lie in that window
    yy, xx = np.divmod(np.arange(900), 30)
    yy, xx = yy + 1, xx + 1
    for rc in range(16):
        (ylo, yhi), (xlo, xhi) = (THS.core_bin_rows(rc // 4),
                                  THS.core_bin_rows(rc % 4))
        inside = (yy >= ylo) & (yy < yhi) & (xx >= xlo) & (xx < xhi)
        assert (core[~inside, rc] == 0).all() and (core[inside, rc] > 0).any()


def test_hist_plan_covers_each_weight_once():
    """The histogram kernels' walk (csrc/hs_common.cuh): each core bin's
    window is core_bin_rows(r) x core_bin_rows(c), holds exactly the
    nonzeros of spatial_weight_core's column, and its weights follow in
    ascending pixel order; the bins are sorted by window size so that the
    four bins of each warp run about the same number of trips."""
    plan, wpack = THS.hist_plan()
    core = THS.spatial_weight_core()
    assert plan.dtype == np.int32 and plan.shape == (16, 6)
    assert wpack.dtype == np.float32 and wpack.shape == ((core != 0).sum(),)
    assert sorted(plan[:, 0]) == list(range(16))
    sizes = (plan[:, 3] - plan[:, 2]) * (plan[:, 5] - plan[:, 4])
    assert (np.diff(sizes) <= 0).all()
    np.testing.assert_array_equal(plan[:, 1], np.cumsum(sizes) - sizes)
    for rc, off, y0, y1, x0, x1 in plan:
        assert (y0, y1) == THS.core_bin_rows(rc // 4)
        assert (x0, x1) == THS.core_bin_rows(rc % 4)
        ys, xs = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1),
                             indexing="ij")
        window = ((ys - 1) * 30 + xs - 1).ravel()
        np.testing.assert_array_equal(np.flatnonzero(core[:, rc]), window)
        np.testing.assert_array_equal(wpack[off:off + window.size],
                                      core[window, rc])
    trips = sizes.reshape(4, 4).max(axis=1)       # a warp runs its longest
    assert list(trips) == [225, 165, 150, 121]
    assert wpack.size * 8 / (trips.sum() * 32) > 0.98


def test_hist_walk_adds_each_vote_once_in_the_dense_order():
    """The kernels' walk (one pass over each bin's window, each pixel's
    two votes added to bins oi and (oi + 1) % 8, the window's row wrap as
    in `hist_block`) gives the float32 sums of a dense walk that adds
    w * 0 for every other orientation, bit for bit: every vote and weight
    is >= 0, so the skipped terms are +0."""
    plan, wpack = THS.hist_plan()
    core = THS.spatial_weight_core()
    rng = np.random.default_rng(7)
    n = 16
    oi = rng.integers(0, 8, (n, 900))
    mag = rng.choice([0.0, 1.0, 255.0, 360.62445], (n, 900)).astype(
        np.float32) * rng.random((n, 900)).astype(np.float32)
    hi = (mag * rng.random((n, 900)).astype(np.float32)).astype(np.float32)
    lo = (mag - hi).astype(np.float32)
    rows = np.arange(n)
    for rc, off, y0, y1, x0, x1 in plan:
        dense = np.zeros((n, 8), np.float32)
        for yy in range(y0, y1):
            for xx in range(x0, x1):
                l = (yy - 1) * 30 + xx - 1
                for o in range(8):
                    v = np.where(oi[:, l] == o, lo[:, l],
                                 np.where(oi[:, l] == (o + 7) % 8, hi[:, l],
                                          np.float32(0)))
                    dense[:, o] += core[l, rc] * v
        walk = np.zeros((n, 8), np.float32)
        width = x1 - x0
        l, xx = (y0 - 1) * 30 + x0 - 1, 0
        for i in range((y1 - y0) * width):
            o0, o1 = oi[:, l], (oi[:, l] + 1) & 7
            walk[rows, o0] += wpack[off + i] * lo[:, l]
            walk[rows, o1] += wpack[off + i] * hi[:, l]
            xx += 1
            l += 30 - width + 1 if xx == width else 1
            xx = 0 if xx == width else xx
        np.testing.assert_array_equal(walk.view(np.uint32),
                                      dense.view(np.uint32))


@pytest.mark.parametrize("size", [31.0, 64.0, 111.0, 300.0])
def test_warp_plain_matches_jax(img, size):
    n = 24
    kp = warp_keypoints(H, W, size, n, seed=int(size))
    got = WK.warp_patches_windows(_t(img), *(_t(a) for a in kp), 1.0)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, 1024)
    got = got.numpy()
    assert (got[~kp[4]] == 0).all()
    ok = kp[4]
    gather = np.asarray(JHS.warp_patches(
        jnp.asarray(img), *(jnp.asarray(a) for a in kp[:4]), 1.0))
    _close_u8(got[ok], gather.reshape(n, 1024)[ok], 1e-3)
    window = _jwarp(img, kp, size)
    if window is not None:
        _close_u8(got, window, 1e-3)
    assert (got[ok] > 0).any()


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_warp_cropping_scale_matches_jax(img, scale):
    kp = warp_keypoints(H, W, 48.0, 16, seed=3)
    got = WK.warp_patches_windows(_t(img), *(_t(a) for a in kp), scale)
    want = np.asarray(JHS.warp_patches(
        jnp.asarray(img), *(jnp.asarray(a) for a in kp[:4]), scale))
    ok = kp[4]
    _close_u8(got.numpy()[ok], want.reshape(16, 1024)[ok], 1e-3)


def test_hist_plain_matches_jax(img):
    kp = warp_keypoints(H, W, 31.0, 40, seed=12)
    patches = np.array(JWK.warp_patches_windows(
        *(jnp.asarray(a) for a in (img, *kp)), 1.0))
    patches[5] = 0                                       # an all-zero patch
    got = WK.hs_hist_from_patches(_t(patches))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (40, 128)
    got = got.numpy()
    assert (got[5] == 0).all() and (got[~kp[4]] == 0).all()
    want = np.asarray(JWK.hs_hist_from_patches(jnp.asarray(patches)))
    _close_u8(got, want, 2e-3)
    perm = [(l % 16) * 8 + l // 16 for l in range(128)]
    np.testing.assert_array_equal(TPR.HS_ORIENT_MAJOR, perm)
    resp = np.asarray(JHS.patch_sift_responses(
        jnp.asarray(patches.reshape(-1, 32, 32).astype(np.float32))))
    _close_u8(got, resp[:, 1:][:, perm], 2e-3)
    # the torch responses keep the JAX layout: column 0 is the bias input
    tresp = THS.patch_sift_responses(_t(patches).reshape(-1, 32, 32))
    assert (tresp[:, 0] == 1).all()
    _close_u8(tresp[:, 1:].numpy(), resp[:, 1:], 2e-3)


@pytest.mark.parametrize("nbits", [256, 512])
def test_descriptors_match_jax(img, nbits):
    n = 96
    sizes = np.array([31.0, 44.64, 64.0, 111.0, 300.0], np.float32)
    x, y, _, angle, valid = warp_keypoints(H, W, 31.0, n, seed=nbits)
    size = sizes[np.arange(n) % len(sizes)]
    kp = (x, y, size, angle, valid)
    want = np.asarray(JHS.hash_sift_descriptors(
        jnp.asarray(img), *(jnp.asarray(a) for a in kp), nbits=nbits))
    plain = THS.hash_sift_descriptors(_t(img), *(_t(a) for a in kp),
                                      nbits=nbits)
    # the pipeline's route: warp (K4) -> histogram (K5) -> permuted product
    staged = TP._compute_descriptors(_t(img), *(_t(a) for a in kp),
                                     "hash_sift", nbits, 1.0)
    for got in (plain.numpy(), staged.numpy()):
        assert got.shape == want.shape == (n, nbits // 8)
        assert (got != want).sum() <= _budget(want.size)
        assert (got[~valid] == 0).all() and (got[valid] != 0).any()


def test_projection_stays_full_f32_under_tf32_setting(img):
    """A caller's set_float32_matmul_precision('high') (TF32 on a card)
    does not reach the projection, and the caller's setting is restored."""
    rng = np.random.default_rng(0)
    desc = _t(rng.integers(0, 256, (64, 128), dtype=np.uint8))
    valid = torch.ones(64, dtype=torch.bool)
    want = TP._hs_from_fused(desc, valid, 256)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = TP._hs_from_fused(desc, valid, 256)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)
    b0, bp = JHS.hs_fused_projection(256)
    proj = desc.numpy().astype(np.float64) @ bp.T.astype(np.float64) + b0
    ref = np.packbits(proj > 0, axis=1)
    assert (got.numpy() != ref).sum() <= _budget(ref.size)


def test_hs_wrappers_run_the_plain_versions_on_cpu(img):
    kp = [_t(a) for a in warp_keypoints(H, W, 40.0, 8, seed=1)]
    counts = (WK.warp_patches_windows.launches,
              WK.hs_hist_from_patches.launches)
    p = WK.warp_patches_windows(_t(img), *kp, 1.0)
    assert torch.equal(p, WK.warp_patches_windows_ref(_t(img), *kp, 1.0))
    assert torch.equal(WK.hs_hist_from_patches(p),
                       WK.hs_hist_from_patches_ref(p))
    assert counts == (WK.warp_patches_windows.launches,
                      WK.hs_hist_from_patches.launches)
    empty = WK.hs_hist_from_patches(torch.zeros((0, 1024), dtype=torch.uint8))
    assert tuple(empty.shape) == (0, 128)
