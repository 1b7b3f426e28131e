"""The band arguments of the port's kernels' plain versions, on the CPU.

The sharded pipeline describes a band's keypoints on a window of a level
that starts at `origin` of a `frame_hw` frame (`ops/window_kernels.py`:
K3, K4 and K11), and resizes a band of a level from a halo-extended band of
the level below (`ops/image.BandRows`: K10).  Against the JAX package's
`bad_descriptors` and `warp_patches` with the same `origin` / `frame_hw`:
BAD byte for byte, the warp within 1 on fewer than 1e-3 of the samples
(JAX's CPU lerps may contract into FMAs).  Against the whole frame: a
band's patches of keypoints whose support lies in it, and a band's resized
rows, are the frame's, exactly.  The windows that K3 and K4 stage
(`bad.window_plan`, `hash_sift.warp_window_plan`, which the kernels mirror)
hold what each keypoint reads on a band.  And `tools/dryrun_multichip`
over 8 gloo ranks prints the line of MULTICHIP_r05.json.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import bad as JB
from efficient_features_tpu.ops import hash_sift as JHS
from efficient_features_tpu.ops import image as JI
from efficient_features_tpu_torch.ops import bad as B
from efficient_features_tpu_torch.ops import hash_sift as HS
from efficient_features_tpu_torch.ops import image as I
from efficient_features_tpu_torch.ops import window_kernels as WK
from efficient_features_tpu_torch.utils import semantics as S

from test_torch_bad_window import H, W, _keypoints, _window_boxes, \
    _window_integrals
from test_torch_window_trig import _samples, _warp_keypoints
from util import make_test_image

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs gain nothing from intra-op threads, and in a parallel
    test run the threads of each worker contend with the others' (and with
    the rank processes, which run on one thread each)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (oy, ox, rows, cols) of a band of the H x W frame: inside it, starting
# above it (a first band's reflected rows), running past it (a last band's),
# one row, one column, and an inner piece
BANDS = [(100, 0, 60, W), (-40, 0, 90, W), (200, 0, 100, W), (130, 0, 1, W),
         (0, 150, H, 1), (30, 40, 50, 70)]


def _band(frame: np.ndarray, oy, ox, rows, cols, seed=0) -> torch.Tensor:
    """Rows [oy, oy + rows) and columns [ox, ox + cols) of the frame, noise
    where they leave it."""
    out = np.random.default_rng(seed).integers(0, 256, (rows, cols),
                                               dtype=np.uint8)
    fh, fw = frame.shape
    y0, y1 = max(oy, 0), min(oy + rows, fh)
    x0, x1 = max(ox, 0), min(ox + cols, fw)
    if y0 < y1 and x0 < x1:
        out[y0 - oy:y1 - oy, x0 - ox:x1 - ox] = frame[y0:y1, x0:x1]
    return torch.from_numpy(out)


@pytest.fixture(scope="module")
def frame():
    return make_test_image(H, W, seed=21)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("nbits", [256, 512])
def test_bad_on_a_band_matches_jax(frame, band, nbits):
    oy, ox = band[:2]
    img = _band(frame, *band)
    x, y, size, angle = _keypoints(3)
    valid = torch.ones(x.shape, dtype=torch.bool)
    valid[5] = False
    got = WK.bad_descriptors_windows(img, x, y, size, angle, valid, nbits,
                                     1.0, (oy, ox), (H, W))
    want = JB.bad_descriptors(
        JI.integral_image_i32(jnp.asarray(img.numpy())),
        *(jnp.asarray(t.numpy()) for t in (x, y, size, angle, valid)),
        nbits=nbits, origin=(oy, ox), frame_hw=(H, W))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("nbits", [256, 512])
def test_bad_window_plan_on_a_band(frame, band, nbits):
    """K3's rule on a band: each keypoint's boxes summed from its window's
    own integral give the plain version's bytes, the window clipped to the
    band and reaching the frame's edge rows where a border box is clamped
    onto them."""
    oy, ox, rows, cols = band
    img = _band(frame, *band)
    x, y, size, angle = _keypoints(4)
    valid = torch.ones(x.shape, dtype=torch.bool)
    plan = B.window_plan(x, y, size / 32.0, rows, cols, (oy, ox), (H, W))
    assert bool(((plan.h >= 1) & (plan.w >= 1)).all())
    assert bool(((plan.y0 + plan.h <= rows) & (plan.x0 + plan.w <= cols)
                 ).all())
    got = B.bad_descriptors_from_boxes(
        _window_boxes(plan, _window_integrals(img, plan)), H, W, x, y, size,
        angle, valid, nbits=nbits, origin=(oy, ox))
    want = B.bad_descriptors(I.integral_image_i32(img), x, y, size, angle,
                             valid, nbits=nbits, origin=(oy, ox),
                             frame_hw=(H, W))
    assert torch.equal(got, want)


def test_bad_window_plan_of_the_whole_frame_is_unchanged():
    x, y, size, _ = _keypoints(0)
    a = B.window_plan(x, y, size / 32.0, H, W)
    b = B.window_plan(x, y, size / 32.0, H, W, (0, 0), (H, W))
    for f, g in zip(a, b):
        assert torch.equal(f, g)


def _close_u8(got: np.ndarray, want: np.ndarray, share: float):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() < share


@pytest.mark.parametrize("band", BANDS)
def test_warp_on_a_band_matches_jax(frame, band):
    oy, ox = band[:2]
    img = _band(frame, *band)
    x, y, size, angle = _warp_keypoints(5)
    got = HS.warp_patches(img, x, y, size, angle, 1.0, (oy, ox), (H, W))
    want = JHS.warp_patches(jnp.asarray(img.numpy()),
                            *(jnp.asarray(t.numpy()) for t in
                              (x, y, size, angle)), 1.0, origin=(oy, ox),
                            frame_hw=(H, W))
    _close_u8(got.numpy(), np.asarray(want), 1e-3)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("scale", [1.0, 1.2])
def test_warp_window_plan_on_a_band(frame, band, scale):
    """K4's rule on a band: where it stages a window, every valid sample's
    2x2 support lies in the band and in the window (so no read is clamped),
    and those keypoints' patches are the whole frame's; the whole frame as
    its own band gives the plan of old."""
    oy, ox, rows, cols = band
    img = _band(frame, *band)
    x, y, size, angle = _warp_keypoints(6)
    s = np.float32(scale) * size / 32.0
    plan = HS.warp_window_plan(x, y, s, rows, cols, (oy, ox), (H, W))
    ui, vi = _samples(x, y, size, angle, scale)
    ui, vi = ui - ox, vi - oy
    valid = (ui + ox >= 0) & (ui + ox + 1 < W) & (vi + oy >= 0) & \
        (vi + oy + 1 < H)
    col = lambda t: t[:, None].to(torch.int64)      # noqa: E731
    held = ((ui >= col(plan.x0)) & (ui + 1 < col(plan.x0 + plan.w))
            & (vi >= col(plan.y0)) & (vi + 1 < col(plan.y0 + plan.h)))
    assert bool((held | ~valid)[plan.in_smem].all())
    staged = plan.in_smem
    if bool(staged.any()):
        got = HS.warp_patches(img, x[staged], y[staged], size[staged],
                              angle[staged], scale, (oy, ox), (H, W))
        want = HS.warp_patches(torch.from_numpy(frame), x[staged], y[staged],
                               size[staged], angle[staged], scale)
        assert torch.equal(got, want)
    whole = HS.warp_window_plan(x, y, s, H, W)
    same = HS.warp_window_plan(x, y, s, H, W, (0, 0), (H, W))
    for f, g in zip(whole, same):
        assert torch.equal(f, g)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_band_resize_equals_the_level(n):
    """Each band of every level, resized from the band below with the
    sharded pipeline's halo (zero rows beyond the level), is that level's
    rows; in K10's packed words the band's taps hold i1 - i0 in {0, 1}."""
    img = torch.from_numpy(make_test_image(400, 512, seed=91))
    shapes = S.pyramid_shapes(400, 512, 1.2, 4)
    levels = I.build_pyramid(img, 1.2, 4)
    bh = [-(-hs // n) for hs, _ in shapes]
    halo = max(16, int(np.ceil((n - 1) * 1.2)) + 4)
    for s in range(1, 4):
        (hs, ws), (hp, wp) = shapes[s], shapes[s - 1]
        prev = torch.zeros((n * bh[s - 1] + 2 * halo, wp), dtype=torch.uint8)
        prev[halo:halo + hp] = levels[s - 1]
        for i in range(n):
            ext = prev[i * bh[s - 1]:i * bh[s - 1] + bh[s - 1] + 2 * halo]
            band = I.BandRows(hs, hp, i * bh[s], bh[s],
                              i * bh[s - 1] - halo, ext.shape[0])
            i0, i1, _ = I.band_row_taps(band)
            assert set(np.unique(i1 - i0)) <= {0, 1}
            got = I.resize_u8(ext.contiguous(), (bh[s], ws), band)
            rows = min(bh[s], hs - i * bh[s])
            assert torch.equal(got[:rows], levels[s][i * bh[s]:
                                                     i * bh[s] + rows])
    with pytest.raises(ValueError, match="does not resize"):
        I.resize_u8(ext.contiguous(), (bh[3] + 1, ws), band)


def test_dryrun_multichip_prints_the_recorded_line():
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        want = json.load(f)["tail"].strip()
    out = subprocess.run(
        [sys.executable, "-m", "efficient_features_tpu_torch.tools."
         "dryrun_multichip", "--n", "8", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want
