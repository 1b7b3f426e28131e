"""K2's angles, K4's window and the keypoint trig of K3, K4 and K11 on the
CPU.

On a card K2 (csrc/ic_moments.cu) turns the moments into the angle itself,
K4 (csrc/warp_patches.cu) samples a keypoint's window of the image staged in
shared memory, and K3, K4 and K11 compute each keypoint's s, cos*s and
sin*s themselves (`hs::keypoint_trig`).  Here, where the wrappers run their
plain versions:
  - `ic_angles_windows` equals the JAX package's `ic_angles_windows` (Pallas
    in interpret mode) on interior keypoints and `orientation.ic_angles` on
    keypoints at the edges, within 1e-3 degrees (f32 atan2 differs by ULPs
    between backends), and invalid slots are 0;
  - K4's window (`hash_sift.warp_window_plan`, which the kernel mirrors)
    holds every sample's 2x2 support that lies in the image, at 31-300 px,
    on and off the image, at scale factors 1.0 and 1.2, and the shared-
    memory branch takes exactly the keypoints whose window fits;
  - the plain mirror of the device trig (`keypoint_trig_ref`) equals
    `bad.affine_trig` and its products bit for bit on a sweep of angles.
`tests/test_torch_cuda.py` holds the same comparisons for the kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import orientation as JO
from efficient_features_tpu.ops import window_kernels as JWK
from efficient_features_tpu_torch.ops import bad as B
from efficient_features_tpu_torch.ops import hash_sift as HS
from efficient_features_tpu_torch.ops import window_kernels as WK

from test_torch_cuda import ic_keypoints
from util import make_test_image

H, W = 150, 230


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _angle_close(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got - want)
    assert np.minimum(d, 360 - d).max() < 1e-3


def test_ic_angles_match_pallas_with_invalid_slots():
    img = make_test_image(H, W, seed=29)
    rng = np.random.default_rng(4)
    ys = rng.integers(15, H - 15, 200).astype(np.int32)
    xs = rng.integers(15, W - 15, 200).astype(np.int32)
    ys[:4], xs[:4] = [15, 15, H - 16, H - 16], [15, W - 16, 15, W - 16]
    valid = rng.random(200) < 0.7
    want = np.asarray(JWK.ic_angles_windows(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(valid)))
    got = WK.ic_angles_windows(_t(img), _t(ys), _t(xs), _t(valid)).numpy()
    assert got.dtype == np.float32
    _angle_close(got, want)
    assert (got[~valid] == 0).all() and (got[valid] != 0).any()


def test_ic_angles_at_the_edges_match_jax():
    """Keypoints on and next to the corners and edges read clamped pixels,
    as `orientation.ic_angles` of the JAX package does."""
    img = make_test_image(H, W, seed=31)
    ys, xs, valid = ic_keypoints(H, W, 300, seed=6)
    want = np.asarray(JO.ic_angles(jnp.asarray(img), jnp.asarray(ys),
                                   jnp.asarray(xs), jnp.asarray(valid)))
    before = WK.ic_angles_windows.launches
    got = WK.ic_angles_windows(_t(img), _t(ys), _t(xs), _t(valid)).numpy()
    assert WK.ic_angles_windows.launches == before       # the plain version
    _angle_close(got, want)
    assert (got[~valid] == 0).all()


def test_angle_step_of_moments():
    """K2's angle step alone (`ic_angles_from_moments`), on the axes, zeros
    and |m01| = |m10| too: the plain step, which equals JAX's on the same
    moments."""
    rng = np.random.default_rng(8)
    m = rng.integers(-(1 << 21) + 1, 1 << 21, (4000, 2)).astype(np.int32)
    v = np.array([0, 1, 255, (1 << 21) - 1], np.int32)
    special = [(a, b) for a in np.concatenate([v, -v])
               for b in np.concatenate([v, -v])]
    m = np.concatenate([m, np.array(special, np.int32)])
    got = WK.ic_angles_from_moments(_t(m)).numpy()
    ang = np.asarray(jnp.arctan2(jnp.asarray(m[:, 0], jnp.float32),
                                 jnp.asarray(m[:, 1], jnp.float32)))
    ang = np.where(ang < 0, ang + np.float32(2 * np.pi), ang)
    want = (np.float32(180.0 / np.pi) * ang).astype(np.float32)
    _angle_close(got, want)
    # a tiny negative angle plus 2 pi rounds to 2 pi: 360 itself occurs
    assert ((got >= 0) & (got <= 360)).all()


def _samples(x, y, size, angle, scale):
    """(floor u, floor v) int64, each (N, 1024), of every sample of K4's
    plain version (`hash_sift.warp_patches`: the same f32 operations)."""
    m00, m01, m02, m10, m11, m12, _ = B.affine_rows(
        x[:, None], y[:, None], size[:, None], angle[:, None], scale)
    p = torch.arange(1024)
    px = (p % 32).to(torch.float32)[None, :]
    py = (p // 32).to(torch.float32)[None, :]
    u = m00 * px + m01 * py + m02
    v = m10 * px + m11 * py + m12
    return torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)


def _warp_keypoints(seed):
    """(x, y, size, angle) float32: sizes 31-300 px and the 31 * 1.2^k /
    300 px ladder, both sides of the window limit (41.0 / 41.1 px at scale
    1), keypoints on the corners, just off the image and far off it,
    angle -1 on every 5th."""
    rng = np.random.default_rng(seed)
    n = 400
    x = rng.uniform(-80, W + 80, n).astype(np.float32)
    y = rng.uniform(-80, H + 80, n).astype(np.float32)
    size = rng.uniform(31.0, 300.0, n).astype(np.float32)
    size[:9] = 31.0 * 1.2 ** np.arange(9)
    size[9:15] = [40.9, 41.0, 41.1, 41.5, 300.0, 34.2]
    x[:15], y[:15] = W / 2 + 0.25, H / 2 - 0.5
    x[15:23] = [0, W - 1, 0, W - 1, -0.5, W - 0.5, -30.0, 5000.0]
    y[15:23] = [0, 0, H - 1, H - 1, H / 2, -0.75, H + 30.0, -5000.0]
    size[15:23] = 31.0
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::5] = -1.0
    return [torch.from_numpy(a) for a in (x, y, size, angle)]


@pytest.mark.parametrize("scale", [1.0, 1.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_warp_window_holds_every_support(scale, seed):
    x, y, size, angle = _warp_keypoints(seed)
    s = np.float32(scale) * size / 32.0
    plan = HS.warp_window_plan(x, y, s, H, W)
    ui, vi = _samples(x, y, size, angle, scale)
    inside = (ui >= 0) & (ui + 1 < W) & (vi >= 0) & (vi + 1 < H)
    col = lambda t: t[:, None].to(torch.int64)      # noqa: E731
    held = ((ui >= col(plan.x0)) & (ui + 1 < col(plan.x0 + plan.w))
            & (vi >= col(plan.y0)) & (vi + 1 < col(plan.y0 + plan.h)))
    assert bool((held | ~inside).all())
    # before clipping, the window [floor - sup, floor + sup] holds every
    # support, in the image or not
    sup = torch.ceil(s.abs() * np.float32(HS.WARP_SUPPORT)).to(
        torch.int64)[:, None] + 2
    fx, fy = col(torch.floor(x)), col(torch.floor(y))
    assert bool(((ui >= fx - sup) & (ui + 1 <= fx + sup) & (vi >= fy - sup)
                 & (vi + 1 <= fy + sup)).all())
    assert bool(((plan.h <= HS.WARP_WINDOW_SIDE)
                 & (plan.w <= HS.WARP_WINDOW_SIDE))[plan.in_smem].all())


def test_warp_window_branch_at_the_limit():
    x, y, size, angle = _warp_keypoints(0)
    plan = HS.warp_window_plan(x, y, size / 32.0, H, W)
    # interior keypoints: 31 and 37.2 px (and 41.0) fit, 41.1 px does not
    assert bool(plan.in_smem[[0, 1, 10]].all())
    assert not bool(plan.in_smem[[2, 11, 12, 13]].any())
    assert int(plan.h[0]) == int(plan.w[0]) == 49      # s = 31/32: sup 24
    assert int(plan.h[10]) == int(plan.w[10]) == 63    # 41.0 px: sup 31
    # corners and just off the image: clipped windows fit; far off: empty
    assert bool(plan.in_smem[15:22].all())
    assert int(plan.h[22]) == 0 and int(plan.w[22]) == 0


@pytest.mark.parametrize("scale", [1.0, 1.2, 0.75])
def test_keypoint_trig_mirror_equals_affine_trig(scale):
    """The op-by-op mirror of the device trig against `bad.affine_trig`,
    bit for bit, on 2^18 angles spread over [0, 360), negative angles
    (no rotation), 0, 360 and sizes 31-300."""
    bits = np.linspace(0, 0x43B3FFFF, 1 << 18).astype(np.int32)
    angle = np.concatenate([bits.view(np.float32),
                            np.float32([-1.0, -0.0, -270.5, 0.0, 360.0])])
    size = np.random.default_rng(3).uniform(31.0, 300.0, angle.size).astype(
        np.float32)
    size[:4] = [31.0, 300.0, 37.2, 0.5]
    angle_t, size_t = torch.from_numpy(angle), torch.from_numpy(size)
    before = WK.keypoint_trig.launches
    s, c, sn = WK.keypoint_trig(size_t, angle_t, scale)
    assert WK.keypoint_trig.launches == before           # the plain version
    s_ref, cos_ref, sin_ref = B.affine_trig(size_t, angle_t, scale)
    for got, want in ((s, s_ref), (c, cos_ref * s_ref),
                      (sn, sin_ref * s_ref)):
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((c[-5:-2] == s[-5:-2]).all() and (sn[-5:-2] == 0).all())
