"""K3's window plan on the CPU (`ops/bad.window_plan` and `window_box`,
which csrc/bad_descriptors.cu mirrors).

On the card K3 sums a keypoint's boxes from the integral of a window of the
image built in shared memory, not from the whole image's integral.  Here,
for keypoints of sizes 31-300 px in the interior, on the corners, on and
outside the edges and at the 27.125 px branch boundary: the box sums from
the window's integral equal those of `integral_image_i32` exactly, the
descriptors built from them are the plain version's bytes, and every box
corner lies inside the window.
"""
import numpy as np
import pytest
import torch

from efficient_features_tpu_torch.models.params import bad_params
from efficient_features_tpu_torch.ops import bad as B
from efficient_features_tpu_torch.ops import image as I

H, W = 260, 390


def _image(seed):
    """Uniform noise: every box sum differs from its neighbours'."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (H, W), dtype=np.uint8))


def _keypoints(seed):
    """(x, y, size, angle) float32: random keypoints of sizes 31-300 px,
    the 4 corners, points just outside the image, the fast/border branch
    boundary of size 31 (28 * 31/32 = 27.125 px), and sizes on both sides
    of the shared-memory window limit (s = 1.125, size 36)."""
    rng = np.random.default_rng(seed)
    n = 48
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    size = rng.uniform(31.0, 300.0, n).astype(np.float32)
    x[:12] = [0, W - 1, 0, W - 1, 27.125, 27.0, W - 28.125, -3.5, W + 2.0,
              W / 2, W / 2, W / 2]
    y[:12] = [0, 0, H - 1, H - 1, 27.125, H / 2, H - 28.125, 40.0, 80.0,
              -6.0, H / 2 + 0.5, H / 2 - 0.25]
    size[:12] = [31, 31, 300, 31, 31, 31, 31, 64, 31, 150, 35.9, 36.1]
    x[12:20], y[12:20] = W / 2, H / 2
    size[12:20] = 31.0 * 1.2 ** np.arange(8)
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::5] = -1.0
    return [torch.from_numpy(a) for a in (x, y, size, angle)]


def _window_integrals(image, plan):
    """Per keypoint, the integral of its window crop."""
    return [I.integral_image_i32(image[y0:y0 + h, x0:x0 + w])
            for y0, x0, h, w in zip(plan.y0.tolist(), plan.x0.tolist(),
                                    plan.h.tolist(), plan.w.tolist())]


def _window_boxes(plan, integrals):
    """Box sums (y1, x1, y2, x2), each (N, nbits), from each keypoint's own
    window integral, corners through `window_box` and read unclamped."""
    cols = _rows(plan)

    def box(y1, x1, y2, x2):
        ly1, lx1, ly2, lx2 = B.window_box(cols, y1, x1, y2, x2)
        rows = []
        for k, ii in enumerate(integrals):
            def at(yy, xx):
                return ii[yy[k].long(), xx[k].long()]
            rows.append(at(ly1, lx1) + at(ly2, lx2) - at(ly1, lx2)
                        - at(ly2, lx1))
        return torch.stack(rows)
    return box


def _rows(plan):
    """The plan's fields as (N, 1) columns, to broadcast against bits."""
    return B.WindowPlan(*(t[:, None] for t in plan))


def _boxes(x, y, size, angle, nbits):
    """Every (keypoint, bit) box of both the fast and the border branch, as
    (y1, x1, y2, x2) in image coordinates."""
    tx1, ty1, tx2, ty2, r = B.box_centres(x, y, size, angle,
                                          bad_params(nbits, "cpu"))
    out = []
    for cx, cy in ((tx1, ty1), (tx2, ty2)):
        fast = (cy - r, cx - r, cy + r + 1, cx + r + 1)
        clamped = ((cy - r).clamp(0, H - 1), (cx - r).clamp(0, W - 1),
                   (cy + r + 1).clamp(1, H), (cx + r + 1).clamp(1, W))
        out += [("fast", fast), ("clamped", clamped)]
    return out


@pytest.mark.parametrize("nbits", [256, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_window_box_sums_equal_the_integral_image(nbits, seed):
    image = _image(seed)
    x, y, size, angle = _keypoints(seed)
    plan = B.window_plan(x, y, size / 32.0, H, W)
    whole = B.integral_boxes(I.integral_image_i32(image))
    local = _window_boxes(plan, _window_integrals(image, plan))
    for kind, corners in _boxes(x, y, size, angle, nbits):
        assert torch.equal(local(*corners), whole(*corners)), kind


@pytest.mark.parametrize("nbits", [256, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_every_box_corner_lies_in_its_window(nbits, seed):
    x, y, size, angle = _keypoints(seed)
    plan = _rows(B.window_plan(x, y, size / 32.0, H, W))
    fy = torch.floor(y)[:, None].to(torch.int32)
    fx = torch.floor(x)[:, None].to(torch.int32)
    for kind, (y1, x1, y2, x2) in _boxes(x, y, size, angle, nbits):
        if kind == "fast":     # the window before clipping to the image
            lo_y, hi_y = fy - plan.sup, fy + plan.sup + 2
            lo_x, hi_x = fx - plan.sup, fx + plan.sup + 2
        else:                  # a clamped box lies in the clipped window
            lo_y, hi_y = plan.y0, plan.y0 + plan.h
            lo_x, hi_x = plan.x0, plan.x0 + plan.w
        assert bool(((y1 >= lo_y) & (y2 <= hi_y) & (x1 >= lo_x)
                     & (x2 <= hi_x)).all()), kind


@pytest.mark.parametrize("nbits", [256, 512])
def test_window_descriptors_are_the_plain_bytes(nbits):
    image = _image(2)
    x, y, size, angle = _keypoints(2)
    valid = torch.ones(x.shape, dtype=torch.bool)
    valid[7] = False
    plan = B.window_plan(x, y, size / 32.0, H, W)
    got = B.bad_descriptors_from_boxes(
        _window_boxes(plan, _window_integrals(image, plan)), H, W, x, y,
        size, angle, valid, nbits=nbits)
    want = B.bad_descriptors(I.integral_image_i32(image), x, y, size, angle,
                             valid, nbits=nbits)
    assert torch.equal(got, want)


def test_plan_takes_both_branches_at_the_size_limit():
    x, y, size, angle = _keypoints(0)
    plan = B.window_plan(x, y, size / 32.0, H, W)
    # interior keypoints: 35.9 px fits a warp's integral, 36.1 px does not
    assert plan.in_smem[10] and not plan.in_smem[11]
    assert int(plan.h[10]) == 58 and int(plan.w[10]) == 58
    assert bool(plan.in_smem[:2].all())           # corners, size 31
    assert not bool(plan.in_smem[12:20][1:].any())   # 37.2 px and up
    assert bool((plan.h >= 1).all() and (plan.w >= 1).all())


@pytest.mark.parametrize("nbits", [256, 512])
def test_support_bounds_the_tables(nbits):
    boxes = bad_params(nbits, "cpu").boxes.numpy().astype(np.float64)
    x1, x2, y1, y2, r = boxes
    reach = np.maximum(np.hypot(x1 - 16, y1 - 16),
                       np.hypot(x2 - 16, y2 - 16)) + r
    assert reach.max() <= B.BAD_SUPPORT
