"""The port's RANSAC (ops/ransac.py) against the JAX package's, on the CPU.

`torch.Generator` cannot reproduce `jax.random.gumbel`, so the parity test
draws the minimal sets the JAX way (Gumbel noise from the same key, masked,
top 4) and hands them to the port's `_ransac_from_indices`.  Tolerances:
  - H's action on a 7x7 grid over the scene within 1e-2 px (float32
    `eigh` on two backends);
  - inlier masks equal except for points whose squared error lies within
    1e-3 px^2 of the threshold's square.
The behaviour tests mirror `tests/test_ransac.py` on the port; a guard
traces `_ransac_from_indices` with `torch.compile(fullgraph=True)`, which
fails on a Python branch on device data (a host read on the card).

K12's plain versions, one by one, against the JAX package's functions:
  - the solve (`solve_minimal_sets`) against `_dlt` with weights 1: H's
    action on the 7x7 grid within 1e-2 px, on sets of four inliers, one
    within 200 px of each corner of the frame.  A random 4-point set is
    often nearly degenerate in float32: its H from the JAX package and
    from the port then both stray from a float64 DLT by up to 1e5 px on
    the grid (JAX's float32 `eigh` further; their scores differ too, by
    16 of 141 inliers on one set of `_scene(seed=2)`).  Collinear,
    coincident and identical sets, whose H neither pins down, are held
    by their scores, which must be equal;
  - the scores (`score_homographies`) and the one-H mask (`inlier_mask`)
    against `_reproj_err2(H) <= t2 & valid`: equal except for points
    whose squared error (float64) lies within 1e-3 px^2 of t2, with
    points at infinity and masked rows among them.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import ransac as JR
from efficient_features_tpu_torch.ops import ransac as TR

from test_ransac import _apply_h, _scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small inputs gain nothing from intra-op threads, and in a
    parallel test run the threads of each worker contend with the others'
    (measured 13x slower beside one other torch test process)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid(n=7):
    return np.stack(np.meshgrid(np.linspace(0, 1000, n),
                                np.linspace(0, 1000, n)), -1).reshape(-1, 2)


def _grid_err(H, H_ref, n=7):
    g = _grid(n)
    return np.linalg.norm(_apply_h(np.asarray(H, np.float64), g)
                          - _apply_h(np.asarray(H_ref, np.float64), g),
                          axis=1).max()


def jax_indices(valid, iters, seed):
    """The minimal sets `_ransac_core` draws from PRNGKey(seed)."""
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (iters, len(valid)))
    g = jnp.where(jnp.asarray(valid)[None], g, -jnp.inf)
    return np.array(jax.lax.top_k(g, 4)[1])


def _port(src, dst, valid, thresh, idx):
    return TR._ransac_from_indices(
        torch.from_numpy(src.astype(np.float32)),
        torch.from_numpy(dst.astype(np.float32)),
        torch.from_numpy(valid), thresh, torch.from_numpy(idx).long())


@pytest.mark.parametrize("seed,iters,masked", [(0, 512, False),
                                               (3, 256, True),
                                               (9, 64, False)])
def test_injected_indices_match_jax(seed, iters, masked):
    _, src, dst, _ = _scene(seed=seed)
    valid = np.ones(len(src), bool)
    if masked:
        valid[::5] = False
    thresh = 3.0
    H_j, inl_j, n_j = JR._ransac_core(
        jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
        jnp.asarray(valid), jnp.float32(thresh), jax.random.PRNGKey(seed),
        iters)
    H_t, inl_t, n_t = _port(src, dst, valid, thresh,
                            jax_indices(valid, iters, seed))
    assert H_t.dtype == torch.float32 and H_t.shape == (3, 3)
    assert inl_t.dtype == torch.bool and n_t.dtype == torch.int32
    assert _grid_err(H_t.numpy(), np.asarray(H_j)) < 1e-2
    inl_j = np.asarray(inl_j)
    diff = inl_t.numpy() != inl_j
    e2 = ((_apply_h(np.asarray(H_j, np.float64), src) - dst) ** 2).sum(1)
    assert (np.abs(e2[diff] - thresh * thresh) < 1e-3).all()
    assert int(n_t) == int(inl_t.sum())
    assert abs(int(n_t) - int(n_j)) <= int(diff.sum())


def test_recovers_homography_with_outliers():
    H_true, src, dst, gt_inl = _scene()
    H, inl, n_inl = TR.find_homography_ransac(src, dst, thresh=3.0,
                                              device="cpu")
    inl = inl.numpy()
    assert _grid_err(H.numpy(), H_true) < 1.5
    assert inl[gt_inl].mean() > 0.97
    assert inl[~gt_inl].mean() < 0.03
    assert int(n_inl) == inl.sum()


def test_deterministic_for_one_seed():
    _, src, dst, _ = _scene(seed=3)
    a = TR.find_homography_ransac(src, dst, seed=7, device="cpu")
    b = TR.find_homography_ransac(src, dst, seed=7, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    gen = torch.Generator().manual_seed(7)
    valid = torch.ones(len(src), dtype=torch.bool)
    first = TR._draw_minimal_sets(valid, 32, gen)
    gen.manual_seed(7)
    assert torch.equal(first, TR._draw_minimal_sets(valid, 32, gen))
    # every set holds 4 distinct indices
    assert (first.sort(dim=1).values.diff(dim=1) > 0).all()


def test_valid_mask_excludes_rows():
    H_true, src, dst, _ = _scene(seed=5, outlier_frac=0.0, noise=0.2)
    valid = np.ones(len(src), bool)
    valid[::4] = False
    dst[::4] = 1e6              # poison the masked rows
    H, inl, _ = TR.find_homography_ransac(src, dst, valid=valid,
                                          device="cpu")
    assert not inl.numpy()[::4].any()
    assert _grid_err(H.numpy(), H_true, 5) < 1.5
    idx = TR._draw_minimal_sets(torch.from_numpy(valid), 64,
                                torch.Generator().manual_seed(0))
    assert valid[idx.numpy()].all()


def test_exact_on_clean_minimal_data():
    H_true, src, dst, _ = _scene(seed=9, outlier_frac=0.0, noise=0.0)
    H, inl, n_inl = TR.find_homography_ransac(src, dst, thresh=1.0,
                                              iters=64, device="cpu")
    assert int(n_inl) == len(src)
    assert _grid_err(H.numpy(), H_true, 5) < 1e-2


def test_input_validation():
    with pytest.raises(ValueError, match="at least 4"):
        TR.find_homography_ransac(np.zeros((3, 2)), np.zeros((3, 2)),
                                  device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        TR.find_homography_ransac(np.zeros((5, 3)), np.zeros((5, 3)),
                                  device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        TR.find_homography_ransac(np.zeros((5, 2)), np.zeros((6, 2)),
                                  device="cpu")


@pytest.mark.parametrize("n_valid", [0, 3])
def test_degenerate_too_few_valid(n_valid):
    _, src, dst, _ = _scene(seed=11, n=64)
    valid = np.zeros(64, bool)
    valid[:n_valid] = True
    _, inl, n_inl = TR.find_homography_ransac(src, dst, valid=valid,
                                              iters=32, device="cpu")
    inl = inl.numpy()
    assert int(n_inl) <= n_valid and not inl[~valid].any()


def test_same_h_under_tf32_setting():
    """The products run in full float32 whatever the caller's setting, and
    the caller's setting is restored."""
    _, src, dst, _ = _scene(seed=4)
    want = TR.find_homography_ransac(src, dst, device="cpu")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = TR.find_homography_ransac(src, dst, device="cpu")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ransac_traces_without_a_host_read(monkeypatch):
    """The float32-precision switch around the products is host state, not
    a device read, and dynamo cannot trace it: the guard leaves it out."""
    monkeypatch.setattr(TR, "full_f32_matmul", contextlib.nullcontext)
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.uniform(0, 500, (80, 2)).astype(np.float32))
    dst = src * 1.1 + 3.0
    valid = torch.from_numpy(rng.random(80) < 0.9)
    idx = torch.from_numpy(rng.integers(0, 80, (32, 4)))
    traced = torch.compile(TR._ransac_from_indices, fullgraph=True,
                           backend="eager")
    for g, e in zip(traced(src, dst, valid, 3.0, idx),
                    TR._ransac_from_indices(src, dst, valid, 3.0, idx)):
        assert torch.equal(g, e)


CORNERS = ((0, 0), (1000, 0), (1000, 1000), (0, 1000))


def _corner_sets(seed, m=64):
    """A scene of 2000 pairs (30% outliers, 0.4 px noise) and m minimal
    sets of four inliers, one within 200 px of each corner of the frame."""
    _, src, dst, inl = _scene(seed=seed, n=2000)
    rng = np.random.default_rng(seed)
    near = [np.flatnonzero(inl & (np.abs(src - c).max(axis=1) < 200))
            for c in CORNERS]
    idx = np.stack([[rng.choice(z) for z in near] for _ in range(m)])
    return src.astype(np.float32), dst.astype(np.float32), idx


_JAX_DLT = jax.jit(JR._dlt)
_JAX_ERR2 = jax.jit(JR._reproj_err2)


def _jax_dlt(src, dst, idx):
    return np.asarray(_JAX_DLT(jnp.asarray(src[idx]), jnp.asarray(dst[idx]),
                               jnp.ones(idx.shape, jnp.float32)))


def _solve(src, dst, idx):
    return TR.solve_minimal_sets(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(idx))


@pytest.mark.parametrize("seed", [0, 6])
def test_solve_matches_jax_dlt(seed):
    src, dst, idx = _corner_sets(seed)
    got = _solve(src, dst, idx)
    assert got.dtype == torch.float32 and got.shape == (64, 3, 3)
    want = _jax_dlt(src, dst, idx)
    assert max(_grid_err(a, b) for a, b in zip(got.numpy(), want)) < 1e-2


def _jax_inliers(H, src, dst, valid, thresh):
    e2 = _JAX_ERR2(jnp.asarray(H), jnp.asarray(src), jnp.asarray(dst))
    return np.asarray((e2 <= jnp.float32(thresh) * jnp.float32(thresh))
                      & jnp.asarray(valid)[None])


def test_degenerate_sets_score_as_jax():
    """Collinear sets, sets with coincident pairs and one pair four times:
    the port's H and JAX's may differ (a null space of more than one
    dimension), their scores may not."""
    H_true, src, dst, _ = _scene(seed=2)
    src[0:4] = [(100 + 50 * k, 200 + 25 * k) for k in range(4)]
    dst[0:4] = _apply_h(H_true, src[0:4])
    src[5], dst[5], src[7], dst[7] = src[4], dst[4], src[6], dst[6]
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    valid = np.ones(len(src), bool)
    valid[::5] = False
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 8, 8, 8], [0, 1, 2, 9],
                    [4, 4, 4, 9], [4, 5, 9, 9], [0, 3, 10, 10]])
    got = TR.score_homographies(_solve(src, dst, idx), torch.from_numpy(src),
                                torch.from_numpy(dst),
                                torch.from_numpy(valid), 9.0)
    want = _jax_inliers(_jax_dlt(src, dst, idx), src, dst, valid, 3.0).sum(1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _verify_case(seed):
    """(H (M, 3, 3), src, dst, valid): JAX's homographies of 64 random sets
    of a scene, its true H, and h_inf, whose third row vanishes on the
    scene's points at x = 1000 (a tenth of them) and nearly so at x = 999;
    every fifth row masked and poisoned to fit the true H."""
    H_true, src, dst, _ = _scene(seed=seed, n=600)
    src[::10, 0] = 1000.0
    src[1::10, 0] = 999.0
    valid = np.ones(len(src), bool)
    valid[::5] = False
    dst[::5] = _apply_h(H_true, src[::5])
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    idx = np.random.default_rng(seed).integers(0, len(src), (64, 4))
    h_inf = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1e-3, 0.0, 1.0]])
    H = np.concatenate([_jax_dlt(src, dst, idx), H_true[None], h_inf[None]])
    return H.astype(np.float32), src, dst, valid


def _near_threshold(H, src, dst, t2):
    e2 = ((_apply_h(H.astype(np.float64), src.astype(np.float64))
           - dst) ** 2).sum(1)
    return np.abs(e2 - t2) < 1e-3


@pytest.mark.parametrize("seed", [1, 4])
def test_scores_and_masks_match_jax(seed):
    H, src, dst, valid = _verify_case(seed)
    thresh = 3.0
    t2 = float(np.float32(thresh) * np.float32(thresh))
    want = _jax_inliers(H, src, dst, valid, thresh)
    args = [torch.from_numpy(a) for a in (src, dst, valid)]
    scores = TR.score_homographies(torch.from_numpy(H), *args, t2).numpy()
    far = np.abs(src[:, 0] * np.float32(-1e-3) + np.float32(1.0)) < 1e-6
    assert far.sum() >= 30 and not want[-1][far].any()
    for k in range(len(H)):
        mask, count = TR.inlier_mask(torch.from_numpy(H[k]), *args, t2)
        mask = mask.numpy()
        assert mask.dtype == bool and count.dtype == torch.int32
        assert int(count) == mask.sum() == scores[k]
        assert not mask[~valid].any()
        diff = mask != want[k]
        assert _near_threshold(H[k], src, dst, t2)[diff].all()
        assert abs(int(scores[k]) - int(want[k].sum())) <= diff.sum()
    assert scores[-2] > 0.6 * valid.sum()
