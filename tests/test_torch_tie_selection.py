"""Selection and RANSAC with no host read, on the CPU, against the JAX package.

`ops/detect.select_topk_cells` places every survivor of the kept 8x8 blocks
from K1's survivor bitmap (`cellbits`), where the JAX package takes a dense
fallback whenever a block holds tied co-survivors (`lax.cond`); RANSAC's
9x9 eigenvectors come from Jacobi rotations (`ops/ransac.smallest_eigvec9`)
in place of `torch.linalg.eigh`.  Tolerances:
  - selection, `detect` and `detect(mask=)` slots bit-exact (x, y, octave,
    size, response, valid, count), angles within 1e-3 degrees (f32 atan2);
  - K1's plain `cellbits` bit-exact with the dense survivor map;
  - the Jacobi eigenvector within 1e-6 of `numpy.linalg.eigh`'s, up to
    sign (its float32 rounding is 3e-8).
A guard traces `select_topk_cells` with `torch.compile(fullgraph=True)`,
which fails on a Python branch on device data (a host read on the card);
tests/test_torch_ransac.py holds RANSAC's.  The selection's worst case,
every 8x8 block live and tied with every other, is held to JAX's at quotas
around the block count.  Where a level's quota is 0 (7 features on
123x77), the JAX package's `detect_and_compute` raises ZeroDivisionError
and its `detect` does not: the port's `detect_and_compute` gives JAX's
`detect` slots and the descriptors of JAX's describe stage on them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu import EfficientFeatures as JEF
from efficient_features_tpu import pipeline as JP
from efficient_features_tpu.ops import detect as JD
from efficient_features_tpu.ops import image as JI
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import detect_kernels as DK
from efficient_features_tpu_torch.ops import ransac as TR

from test_torch_cuda import grid_maps, tie_image, tie_mask
from util import make_test_image

EXACT = ("x", "y", "octave", "size", "response", "valid", "count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small inputs gain nothing from intra-op threads, and in a
    parallel test run the threads of each worker contend with the others'."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


IMAGES = {
    "tie": tie_image,
    # equal-valued tied blocks that share block rows (1x4) and rows and
    # columns of blocks (3x3)
    "tie_1x4": lambda: np.tile(tie_image(), (1, 4)),
    "tie_3x3": lambda: np.tile(tie_image(), (3, 3)),
    "scene": lambda: make_test_image(203, 285, seed=21),
}


def _dense(img, mask=None, radius=15):
    """The dense selection inputs, (canonical response, survivor map), from
    the port's dense functions (bit-exact with JAX's:
    tests/test_torch_detect.py), as numpy arrays."""
    t = torch.from_numpy(img)
    corner = DK.border_corners(t, 20)
    if mask is not None:
        corner = corner & torch.from_numpy(mask)
    resp = TD.canonical_zero(TD.harris_response(t))
    return resp.numpy(), TD.radius_nms(resp, corner, radius).numpy()


def _jax_selection(cells, img, quota, mask=None):
    """JAX's `select_topk_cells` on the port's cells, with its dense
    fallback."""
    h, w = img.shape
    resp, surv = _dense(img, mask)
    masked = jnp.where(jnp.asarray(surv), jnp.asarray(resp),
                       jnp.float32(-jnp.inf))

    def dense_fallback(_=None):
        return jax.lax.top_k(masked.reshape(-1), min(quota, h * w))

    return JD.select_topk_cells(*(jnp.asarray(c.numpy()) for c in cells),
                                h, w, quota, dense_fallback)


def _check(got, want):
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)


def _check_slots(got: dict, want: dict):
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    d = np.abs(got["angle"].numpy() - np.asarray(want["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3


@pytest.mark.parametrize("which", ["tie", "tie_1x4", "tie_3x3", "scene"])
def test_cellbits_hold_the_dense_survivors(which):
    img = IMAGES[which]()
    h, w = img.shape
    cm, _, cc, cb = DK.fast_harris_nms_cells(torch.from_numpy(img), 20, 15)
    assert cb.dtype == torch.uint8 and cb.shape == cm.shape
    _, surv = _dense(img)
    surv = np.pad(surv, ((0, -h % 8), (0, 0)))
    rows = surv.reshape(-1, 8, w)
    want = (rows * (1 << np.arange(8))[None, :, None]).sum(axis=1)
    np.testing.assert_array_equal(cb.numpy(), want.astype(np.uint8))
    pop = np.unpackbits(cb.numpy()[..., None], axis=-1).sum(axis=-1)
    np.testing.assert_array_equal(pop, cc.numpy())


@pytest.mark.parametrize("which,quotas", [
    ("tie", (1, 2, 64)), ("tie_1x4", (1, 3, 5, 7, 100)),
    ("tie_3x3", (1, 3, 5, 7, 100))])
@pytest.mark.parametrize("masked", [False, True])
def test_select_topk_cells_matches_jax(which, quotas, masked):
    """Quotas that cut inside groups of equal-valued tied blocks: the
    segment order (value desc, start asc) must interleave their rows."""
    img = IMAGES[which]()
    h, w = img.shape
    mask = np.tile(tie_mask(), (h // 96, w // 160)) != 0 if masked else None
    cm, cr, cc, cb = DK.fast_harris_nms_cells(
        torch.from_numpy(img), 20, 15,
        None if mask is None else torch.from_numpy(mask))
    blocks = cc.reshape(cc.shape[0], -1, 8).sum(dim=2)
    assert int(blocks.max()) > 1          # some block holds a tie
    for quota in quotas:
        want = _jax_selection((cm, cr, cc), img, quota, mask)
        got = TD.select_topk_cells(cm, cr, cb, h, w, quota)
        _check(got, want)


def _jax_select_dense(cells, resp, surv, quota):
    """JAX's `select_topk_cells` on cells with its dense fallback over the
    (response, survivor) maps."""
    h, w = resp.shape
    masked = jnp.where(jnp.asarray(surv), jnp.asarray(resp),
                       jnp.float32(-jnp.inf))

    def dense_fallback(_=None):
        return jax.lax.top_k(masked.reshape(-1), min(quota, h * w))

    return JD.select_topk_cells(*(jnp.asarray(c.numpy()) for c in cells),
                                h, w, quota, dense_fallback)


@pytest.mark.parametrize("quota", ["1", "nb-1", "nb", "2nb"])
@pytest.mark.parametrize("masked", [False, True])
def test_select_topk_cells_every_block_live_matches_jax(quota, masked):
    """Every 8x8 block live, one tie group (`grid_maps`, 61x95: 96 blocks,
    partial last block row and column), quotas around the block count;
    with a mask, a corner of the map dead."""
    h, w = 61, 95
    mask = None
    if masked:
        mask = np.ones((h, w), bool)
        mask[h // 3:, w // 2:] = False
    resp, surv = grid_maps(h, w, mask)
    cm, cr, cc, cb = DK.cells_from_dense(torch.from_numpy(resp),
                                         torch.from_numpy(surv))
    nb = -(-h // 8) * -(-w // 8)
    blocks = TD.select_topk_cells(cm, cr, cb, h, w, nb * 64)[3].sum()
    assert int(blocks) == int(surv.sum())
    if not masked:      # every block live
        alive = np.pad(cm.numpy() != -np.inf, ((0, 0), (0, -w % 8)))
        assert alive.reshape(-1, -(-w // 8), 8).any(axis=2).all()
    q = {"1": 1, "nb-1": nb - 1, "nb": nb, "2nb": 2 * nb}[quota]
    _check(TD.select_topk_cells(cm, cr, cb, h, w, q),
           _jax_select_dense((cm, cr, cc), resp, surv, q))


@pytest.mark.parametrize("descriptor_type", ["bad_256", "hash_sift_256"])
def test_zero_quota_level_matches_jax_detect_and_describe(descriptor_type):
    """7 features on 123x77: the last level's quota is 0.  The JAX
    package's HashSIFT `detect_and_compute` raises there (a zero-size
    reshape), its BAD one does not; the port's gives the slots of JAX's
    `detect` and, row for row, the descriptors of JAX's describe stage
    (`_compute_level_descriptors` on each blurred level that has slots),
    which are BAD's `detect_and_compute` descriptors."""
    img = make_test_image(123, 77, seed=5)
    cfg = dict(nfeatures=7, descriptor_type=descriptor_type)
    jcfg = JP.FeatureConfig(**cfg)
    assert 0 in jcfg.quotas()
    if descriptor_type == "hash_sift_256":
        with pytest.raises(ZeroDivisionError):
            JEF(**cfg).detect_and_compute(img)
    kps, desc = TEF(device="cpu", **cfg).detect_and_compute_async(img)
    if descriptor_type == "bad_256":
        jkps, jdesc = JEF(**cfg).detect_and_compute_async(img)
        want_slots, want = jkps._slots, np.asarray(jdesc)
    else:
        def describe(image):          # detect_core's slots are detect's
            slots, levels, per_level = JP.detect_core(image, jcfg)
            return slots, jnp.concatenate([JP._compute_level_descriptors(
                JI.gaussian_blur7_u8(levels[s]), ys, xs, ang, valid, jcfg)
                for s, ys, xs, valid, ang in per_level if ys.shape[0]])

        want_slots, want = jax.jit(describe)(jnp.asarray(img))
        want = np.asarray(want)
    _check_slots(kps._slots, want_slots)
    assert int(kps._slots["count"]) > 0
    got = desc.numpy()
    assert got.shape == want.shape
    budget = int(1e-4 * want.size) + 1 if descriptor_type == "hash_sift_256" \
        else 0
    assert int((got != want).sum()) <= budget


@pytest.mark.parametrize("which,nfeatures,nlevels,masked", [
    ("tie", 64, 1, False), ("tie", 64, 1, True), ("tie_1x4", 3, 1, False),
    ("tie_1x4", 7, 1, True), ("tie_3x3", 5, 1, True),
    ("tie_3x3", 300, 3, False)])
def test_detect_on_tied_images_matches_jax(which, nfeatures, nlevels,
                                            masked):
    img = IMAGES[which]()
    h, w = img.shape
    cfg = dict(nfeatures=nfeatures, nlevels=nlevels,
               descriptor_type="bad_256")
    jcfg = JP.FeatureConfig(**cfg)
    if masked:
        mask = np.tile(tie_mask(), (h // 96, w // 160))
        want = JP.detect_masked_jit(jnp.asarray(img), jnp.asarray(mask != 0),
                                    jcfg)
    else:
        mask = None
        want = JP.detect_jit(jnp.asarray(img), jcfg)
    got = TEF(device="cpu", **cfg).detect(img, mask=mask)._slots
    _check_slots(got, want)
    assert int(got["count"]) > 0


def test_select_topk_cells_traces_without_a_host_read():
    img = torch.from_numpy(IMAGES["tie_1x4"]())
    h, w = img.shape
    cm, cr, _, cb = DK.fast_harris_nms_cells(img, 20, 15)
    traced = torch.compile(TD.select_topk_cells, fullgraph=True,
                           backend="eager")
    for quota in (5, 100):
        for g, e in zip(traced(cm, cr, cb, h, w, quota),
                        TD.select_topk_cells(cm, cr, cb, h, w, quota)):
            assert torch.equal(g, e)


def test_jacobi_schedule_covers_each_pair_once():
    rounds = TR.jacobi_rounds()
    assert len(rounds) == 9 and all(len(r) == 4 for r in rounds)
    assert all(len({i for pq in r for i in pq}) == 8 for r in rounds)
    assert sorted(pq for r in rounds for pq in r) == [
        (p, q) for p in range(9) for q in range(p + 1, 9)]


def _eigvec_err(ata: np.ndarray) -> float:
    got = TR.smallest_eigvec9(torch.from_numpy(ata)).double().numpy()
    want = np.linalg.eigh(ata.astype(np.float64))[1][..., 0]
    return float(np.minimum(np.abs(got - want).max(-1),
                            np.abs(got + want).max(-1)).max())


def test_jacobi_matches_numpy_on_random_psd():
    m = np.random.default_rng(7).standard_normal((400, 9, 12))
    assert _eigvec_err((m @ m.transpose(0, 2, 1)).astype(np.float32)) < 1e-6


def test_jacobi_matches_numpy_on_exact_four_point_sets():
    """Rank-8 normal matrices of the DLT from 4 exact correspondences: the
    null vector is the homography."""
    rng = np.random.default_rng(8)
    n = 400
    hs = rng.standard_normal((n, 3, 3))
    src = rng.uniform(-1, 1, (n, 4, 2))
    p = np.concatenate([src, np.ones((n, 4, 1))], -1) @ hs.transpose(0, 2, 1)
    dst = p[..., :2] / p[..., 2:]
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    a = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1),
                        np.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)],
                       axis=1)
    ata = (a.transpose(0, 2, 1) @ a).astype(np.float32)
    assert _eigvec_err(ata) < 1e-6
    # and the batch shape is kept
    assert TR.smallest_eigvec9(torch.from_numpy(ata[:6].reshape(2, 3, 9, 9))
                               ).shape == (2, 3, 9)


def test_select_cells_runs_the_plain_version_on_cpu():
    """K13's wrapper takes `select_topk_cells` for a CPU tensor and launches
    nothing."""
    img = torch.from_numpy(IMAGES["tie_3x3"]())
    h, w = img.shape
    cm, cr, _, cb = DK.fast_harris_nms_cells(img, 20, 15)
    before = DK.select_cells.launches
    for quota in (0, 5, 100):
        for g, e in zip(DK.select_cells(cm, cr, cb, h, w, quota),
                        TD.select_topk_cells(cm, cr, cb, h, w, quota)):
            assert torch.equal(g, e)
    assert DK.select_cells.launches == before
