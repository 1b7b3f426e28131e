"""The port's compiled CUDA kernels against their plain versions, on a card.

Marked `cuda`; each test skips where `torch.cuda.is_available()` is false.
This file imports neither jax nor the JAX package, so on a machine without
jax it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in `tests/test_torch_kernels.py`,
`tests/test_torch_detect_config.py`, `tests/test_torch_hash_sift.py`,
`tests/test_torch_resize.py` and `tests/test_torch_hs_fused.py`:
K1 (with and without a mask), K2, K7, K8, K9 and K10 bit-exact, K3 byte for
byte (its box sums are exact integers however they are formed), K4 patches and K5 and K11
rows |diff| <= 1 on fewer than 1e-3 and 2e-3 of the entries, HashSIFT
descriptors at most int(1e-4 * bytes) + 1 differing bytes.  K5 and K11 must
give the same bytes on every run, and K11 the bytes of K5 on K4's patches,
also at the edges of their 8-patch blocks.
"""
import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import detect_kernels as DK
from efficient_features_tpu_torch.ops import orientation as TO
from efficient_features_tpu_torch.ops import window_kernels as WK
from efficient_features_tpu_torch.utils import semantics as TS

from util import make_test_image


def tie_image():
    """Two identical corner patterns 4 px apart: tied co-survivors inside
    one 8x8 block."""
    img = np.full((96, 160), 40, np.uint8)
    img[40:44, 60:64] = 220
    img[44:48, 64:68] = 220
    return img


def tie_mask():
    """ROI mask of `tie_image` (255 = search) that cuts one of its two tied
    8x8 blocks at column 66 and leaves the other tied, so selection still
    takes the dense fallback and the fallback must apply the mask."""
    mask = np.full((96, 160), 255, np.uint8)
    mask[:, 66:] = 0
    return mask


def wrap_image():
    """A FAST-9 darker arc that wraps the index-0 tap of the circle."""
    img = np.full((48, 64), 160, np.uint8)
    for idx in list(range(12, 16)) + list(range(0, 5)):
        dy, dx = TS.FAST_CIRCLE[idx]
        img[24 + dy, 32 + dx] = 100
    return img


def bad_keypoints(h, w, n, seed):
    """(x, y, size, angle, valid) with keypoints on the image corners and
    edges and at the fast/border branch boundary (27.125 px at size 31)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w - 1, n).astype(np.float32)
    y = rng.uniform(0, h - 1, n).astype(np.float32)
    x[:10] = [0, w - 1, 0, w - 1, 0.5, w - 1.5, 14.0, 27.0, 27.125, w / 2]
    y[:10] = [0, 0, h - 1, h - 1, 0.5, h - 1.5, 14.0, 27.0, 27.125, 1.0]
    size = np.full(n, 31.0, np.float32)
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::11] = -1.0
    valid = rng.random(n) < 0.9
    return x, y, size, angle, valid


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _budget(n_bytes: int) -> int:
    return int(2e-5 * n_bytes) + 1


def dense_image():
    """A scene tiled from small corner-rich tiles: many corners per disc."""
    tile = make_test_image(50, 70, seed=4)
    return np.tile(tile, (4, 4))


def noise_image():
    """Uniform noise: a large share of the pixels are FAST corners."""
    return np.random.default_rng(12).integers(0, 256, (150, 210),
                                              dtype=np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 10, 15, 22, 48, 49, 64])
def test_cells_kernel_matches_plain(dev, radius):
    for img in (make_test_image(200, 280, seed=33),
                make_test_image(141, 203, seed=8), tie_image(), wrap_image(),
                dense_image(), noise_image()):
        t = torch.from_numpy(img).to(dev)
        before = DK.fast_harris_nms_cells.launches
        got = DK.fast_harris_nms_cells(t, 20, radius)
        assert DK.fast_harris_nms_cells.launches == before + 1
        for a, b in zip(got, DK.fast_harris_nms_cells_ref(t, 20, radius)):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_ic_and_bad_kernels_match_plain(dev):
    img = torch.from_numpy(make_test_image(200, 280, seed=33)).to(dev)
    rng = np.random.default_rng(3)
    ys = torch.from_numpy(rng.integers(0, 200, 500).astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, 280, 500).astype(np.int32)).to(dev)
    assert torch.equal(WK.ic_moments_windows(img, ys, xs),
                       TO.ic_moments(img, ys, xs))
    kp = [torch.from_numpy(a).to(dev) for a in bad_keypoints(200, 280, 500, 5)]
    for nbits in (256, 512):
        got = WK.bad_descriptors_windows(img, *kp, nbits)
        want = WK.bad_descriptors_windows_ref(img, *kp, nbits)
        assert torch.equal(got, want)


def _bad_sizes(case, n, rng):
    """Keypoint sizes of a K3 case: 31 px (every detect_and_compute call),
    64-300 px (compute() on the raw image), or both sides of the limit of
    the shared-memory window (s = 1.125, size 36, `bad.window_plan`)."""
    if case == "size 31":
        return np.full(n, 31.0, np.float32)
    if case == "sizes 64-300":
        return rng.uniform(64.0, 300.0, n).astype(np.float32)
    return rng.choice(np.float32([34.0, 35.9, 36.0, 36.1, 37.2, 44.6]), n)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [256, 512])
@pytest.mark.parametrize("case", ["size 31", "sizes 64-300",
                                  "window limit"])
def test_bad_kernel_bytes_equal_plain(dev, nbits, case):
    """Zero differing bytes at both bit counts, on keypoints on the four
    corners, the edges and the 27.125 px branch boundary as well."""
    img = torch.from_numpy(make_test_image(400, 560, seed=21)).to(dev)
    if case == "size 31":      # dAC describes on the blurred level
        from efficient_features_tpu_torch.ops import image as TI
        img = TI.gaussian_blur7_u8(img)
    x, y, _, angle, valid = bad_keypoints(400, 560, 2000, seed=len(case))
    size = _bad_sizes(case, 2000, np.random.default_rng(nbits))
    kp = [torch.from_numpy(a).to(dev) for a in (x, y, size, angle, valid)]
    before = WK.bad_descriptors_windows.launches
    got = WK.bad_descriptors_windows(img, *kp, nbits)
    assert WK.bad_descriptors_windows.launches == before + 1
    assert torch.equal(got, WK.bad_descriptors_windows_ref(img, *kp, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1, 1), (1, 40), (40, 1), (2, 3), (3, 2),
                                (3, 50), (120, 160)])
def test_bad_kernel_at_the_edges(dev, hw):
    """Images 1-3 px tall or wide, keypoints in and around them, n = 1 and
    every slot invalid."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    img = torch.from_numpy(rng.integers(0, 256, hw, dtype=np.uint8)).to(dev)
    n = 64
    x = rng.uniform(-40.0, w + 40.0, n).astype(np.float32)
    y = rng.uniform(-40.0, h + 40.0, n).astype(np.float32)
    x[:4], y[:4] = [0, w - 1, 0, w - 1], [0, 0, h - 1, h - 1]
    size = rng.uniform(31.0, 300.0, n).astype(np.float32)
    size[::3] = 31.0
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::4] = -1.0
    kp = [torch.from_numpy(a).to(dev) for a in (x, y, size, angle)]
    for nbits in (256, 512):
        for k, valid in ((n, np.ones(n, bool)), (n, np.zeros(n, bool)),
                         (1, np.ones(1, bool))):
            args = [t[:k] for t in kp] + [torch.from_numpy(valid).to(dev)]
            got = WK.bad_descriptors_windows(img, *args, nbits)
            want = WK.bad_descriptors_windows_ref(img, *args, nbits)
            assert torch.equal(got, want)
            if not valid.any():
                assert not bool(got.any())


@pytest.mark.cuda
def test_slice_on_the_card_matches_the_cpu(dev):
    scene = make_test_image(200, 280, seed=7)
    gpu = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                            device="cuda")
    cpu = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                            device="cpu")
    launches = DK.fast_harris_nms_cells.launches
    (gk, gd), (ck, cd) = (gpu.detect_and_compute_async(scene),
                          cpu.detect_and_compute_async(scene))
    assert DK.fast_harris_nms_cells.launches > launches
    for k in ("x", "y", "octave", "size", "response", "valid", "count"):
        assert torch.equal(gk._slots[k].cpu(), ck._slots[k]), k
    assert int((gd.cpu() != cd).sum()) <= _budget(cd.numel())


@pytest.mark.cuda
def test_tie_fallback_on_the_card_matches_the_cpu(dev):
    before = TD.select_topk_cells.fallbacks
    slots = [EfficientFeatures(nfeatures=64, nlevels=1,
                               descriptor_type="bad_256",
                               device=d).detect(tie_image())._slots
             for d in ("cuda", "cpu")]
    assert TD.select_topk_cells.fallbacks == before + 2
    for k in slots[1]:
        if k != "angle":        # f32 atan2 may differ by ULPs
            assert torch.equal(slots[0][k].cpu(), slots[1][k]), k
    assert float((slots[0]["angle"].cpu() - slots[1]["angle"]).abs().max()) \
        < 1e-3


def _close_u8(got, want, share):
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) < share


@pytest.mark.cuda
@pytest.mark.parametrize("size", [31.0, 64.0, 111.0, 300.0])
def test_warp_and_hist_kernels_match_plain(dev, size):
    img = torch.from_numpy(make_test_image(200, 280, seed=33)).to(dev)
    x, y, _, angle, valid = bad_keypoints(200, 280, 300, seed=int(size))
    kp = [torch.from_numpy(a).to(dev)
          for a in (x, y, np.full(300, size, np.float32), angle, valid)]
    before = (WK.warp_patches_windows.launches,
              WK.hs_hist_from_patches.launches)
    patches = WK.warp_patches_windows(img, *kp, 1.0)
    _close_u8(patches, WK.warp_patches_windows_ref(img, *kp, 1.0), 1e-3)
    patches[7] = 0                                    # an all-zero patch
    rows = WK.hs_hist_from_patches(patches)
    assert (WK.warp_patches_windows.launches,
            WK.hs_hist_from_patches.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _close_u8(rows, WK.hs_hist_from_patches_ref(patches), 2e-3)
    assert int(rows[7].sum()) == 0
    assert torch.equal(rows, WK.hs_hist_from_patches(patches))   # determinism


@pytest.mark.cuda
@pytest.mark.parametrize("descriptor_type", ["hash_sift_256",
                                             "hash_sift_512"])
def test_hash_sift_slice_on_the_card_matches_the_cpu(dev, descriptor_type):
    from efficient_features_tpu_torch import HashSIFT
    scene = make_test_image(200, 280, seed=7)
    gpu = EfficientFeatures(nfeatures=500, descriptor_type=descriptor_type,
                            device="cuda")
    cpu = EfficientFeatures(nfeatures=500, descriptor_type=descriptor_type,
                            device="cpu")
    (gk, gd), (ck, cd) = (gpu.detect_and_compute_async(scene),
                          cpu.detect_and_compute_async(scene))
    for k in ("x", "y", "octave", "size", "response", "valid", "count"):
        assert torch.equal(gk._slots[k].cpu(), ck._slots[k]), k
    budget = int(1e-4 * cd.numel()) + 1
    assert int((gd.cpu() != cd).sum()) <= budget
    nbits = int(descriptor_type.rsplit("_", 1)[1])
    kp = np.stack([np.linspace(0, 279, 64), np.linspace(0, 199, 64),
                   np.linspace(31, 300, 64), np.linspace(-1, 359, 64)],
                  axis=1).astype(np.float32)
    got = HashSIFT(1.0, nbits, device="cuda").compute(scene, kp)
    want = HashSIFT(1.0, nbits, device="cpu").compute(scene, kp)
    assert int((got != want).sum()) <= int(1e-4 * want.size) + 1


def _pool_descriptors(nbytes, n1, n2, seed):
    """Rows from a pool of 6 descriptors (ties everywhere), an exact
    duplicate across K6's 128-row train tiles and its splits."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (6, nbytes), dtype=np.uint8)
    d1 = pool[rng.integers(0, 6, n1)]
    d2 = pool[rng.integers(0, 6, n2)]
    d2[n2 - 3] = d2[17]
    return d1, d2


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [32, 64])
@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("n1,n2", [(700, 1101), (64, 64), (129, 257),
                                   (127, 255), (300, 5000), (40, 20)])
def test_knn2_kernel_matches_plain(dev, nbytes, kind, n1, n2):
    """K6 against its plain version: several train splits (1101, 5000), one
    block (64 x 64), one off a 128-row tile on both sides, fewer train rows
    than a tile; unmasked, masked, no valid train row, no valid query; the
    same bits on a second run."""
    from efficient_features_tpu_torch.ops import matcher as TM
    if kind == "ties":
        d1, d2 = _pool_descriptors(nbytes, n1, n2, seed=nbytes)
    else:
        rng = np.random.default_rng(nbytes)
        d1 = rng.integers(0, 256, (n1, nbytes), dtype=np.uint8)
        d2 = rng.integers(0, 256, (n2, nbytes), dtype=np.uint8)
        d1[::2] = d2[:len(d1[::2])]
    rng = np.random.default_rng(1)
    v1 = torch.from_numpy(rng.random(n1) > 0.2).to(dev)
    v2 = torch.from_numpy(rng.random(n2) > 0.2).to(dev)
    v1[5] = True
    q, t = torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev)
    for vq, vt in ((None, None), (v1, v2), (torch.zeros_like(v1), v2),
                   (v1, torch.zeros_like(v2))):   # no valid pair at all
        before = TM.knn2_topk2.launches
        got = TM.knn2_topk2(q, vq, t, vt)
        assert TM.knn2_topk2.launches == before + 1
        want = TM.knn2_topk2_ref(q, vq, t, vt)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32 and torch.equal(a, b)
        for a, b in zip(got, TM.knn2_topk2(q, vq, t, vt)):
            assert torch.equal(a, b)
    assert int(got[1][5]) == TM.BIG and int(got[0][5]) == 0
    for fn, args in ((TM.match, (q, t)), (TM.knn2_ratio_match, (q, t)),
                     (TM.knn2_ratio_match_masked, (q, v1, t, v2))):
        got = fn(*args)
        want = fn(*(a.cpu() for a in args))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_knn2_kernel_rejects_bad_input(dev):
    from efficient_features_tpu_torch.ops import matcher as TM
    d = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="256- or 512-bit"):
        TM.knn2_topk2(d[:, :16].contiguous(), None, d[:, :16].contiguous(),
                      None)
    with pytest.raises(ValueError, match="contiguous"):
        TM.knn2_topk2(d.t().contiguous().t()[:, :32], None, d, None)
    with pytest.raises(ValueError, match="on"):
        TM.knn2_topk2(d, torch.ones(8, dtype=torch.bool), d, None)


@pytest.mark.cuda
def test_sequence_step_on_the_card_matches_the_cpu(dev):
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.samples import \
        sample_image_sequence as SIS
    base = make_test_image(240, 320, seed=9)
    frames = [SC.warp_image(base, 2.0 * i, 5.0 * i, 1.0) for i in range(3)]
    outs = {}
    for d in ("cuda", "cpu"):
        feat = EfficientFeatures(nfeatures=300, descriptor_type="bad_256",
                                 device=d)
        step, state = SIS.streaming_step_fn(feat._cfg, base.shape,
                                            homography=True, device=d)
        outs[d] = [[t.cpu() for t in step(f)] for f in frames]
        outs[d + "_state"] = {k: v.cpu() for k, v in state.items()}
    assert torch.equal(outs["cuda_state"]["valid"], outs["cpu_state"]["valid"])
    assert int((outs["cuda_state"]["desc"] != outs["cpu_state"]["desc"]).sum()
               ) <= _budget(outs["cpu_state"]["desc"].numel())
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert int(g[0]) == int(c[0])
        assert abs(int(g[1]) - int(c[1])) <= 2
    assert int(outs["cuda"][2][3]) / int(outs["cuda"][2][1]) > 0.6


def _detect_images():
    return (make_test_image(200, 280, seed=33),
            make_test_image(141, 203, seed=8), tie_image(), wrap_image())


def equal_image(h, w):
    """One bright pixel every 6 px each way: all corners have the same
    response, so ties must co-survive (chip_smoke.equal_image)."""
    cell = np.full((6, 6), 40, np.uint8)
    cell[3, 3] = 220
    return np.tile(cell, (-(-h // 6), -(-w // 6)))[:h, :w].copy()


def _nms_images():
    """K7's inputs beyond `_detect_images`: the 4K scene and the scene plus
    noise, equal responses, an image smaller than one 32x64 tile and widths
    that are not a multiple of 64."""
    from efficient_features_tpu_torch.samples import sample_common as SC
    scene = SC.tiled_scene(2160, 3840, seed=2160, distinct=False)
    noise = np.random.default_rng(9).integers(-24, 25, scene.shape)
    noisy = np.clip(scene.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    return (scene, noisy, equal_image(300, 500), equal_image(31, 63),
            scene[1084:1115, 1500:1563].copy(), make_test_image(70, 130, seed=3),
            scene[1000:1097, 1500:1565].copy())


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 5, 9])
def test_fast_harris_nms_kernel_matches_plain(dev, radius):
    for img in _detect_images() + _nms_images():
        t = torch.from_numpy(img).to(dev)
        before = DK.fast_harris_nms.launches
        got = DK.fast_harris_nms(t, 20, radius)
        assert DK.fast_harris_nms.launches == before + 1
        assert torch.equal(got, DK.fast_harris_nms_ref(t, 20, radius))
    got = DK.fast_harris_nms(torch.from_numpy(wrap_image()).to(dev), 20,
                             radius)
    assert bool(torch.isfinite(got[24, 32])) == (radius == 1)   # wrap corner


@pytest.mark.cuda
def test_fast_harris_kernel_matches_plain(dev):
    for img in _detect_images():
        t = torch.from_numpy(img).to(dev)
        before = DK.fast_harris.launches
        got = DK.fast_harris(t, 20)
        assert DK.fast_harris.launches == before + 1
        assert torch.equal(got, DK.fast_harris_ref(t, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [3, 9, 15, 49, 64, 128])
def test_radius_nms_kernel_matches_plain(dev, radius):
    img = torch.from_numpy(make_test_image(200, 280, seed=33)).to(dev)
    resp = DK.fast_harris(img, 20)
    keep = torch.from_numpy(np.random.default_rng(radius).random((200, 280))
                            < 0.5).to(dev)
    for r in (resp, torch.where(keep, resp, TD.RESP_SENTINEL)):
        before = DK.radius_nms.launches
        got = DK.radius_nms(r, radius)
        assert DK.radius_nms.launches == before + 1
        assert got.dtype == torch.bool
        assert torch.equal(got, DK.radius_nms_ref(r, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [10, 15, 22, 48, 49, 64])
def test_masked_cells_kernel_matches_plain(dev, radius):
    from efficient_features_tpu_torch.samples.sample_common import roi_mask
    for img in _detect_images()[:3] + (dense_image(), noise_image()):
        h, w = img.shape
        t = torch.from_numpy(img).to(dev)
        rnd = np.random.default_rng(radius).random((h, w)) < 0.5
        unmasked = DK.fast_harris_nms_cells(t, 20, radius)
        for mask in (roi_mask(h, w) != 0, rnd, np.ones((h, w), bool)):
            m = torch.from_numpy(mask).to(dev)
            got = DK.fast_harris_nms_cells(t, 20, radius, m)
            for a, b in zip(got, DK.fast_harris_nms_cells_ref(t, 20, radius,
                                                              m)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(got, unmasked):         # all-true mask = no mask
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,masked", [(15, True), (5, True),
                                           (5, False), (64, False)])
def test_masked_slice_on_the_card_matches_the_cpu(dev, radius, masked):
    from efficient_features_tpu_torch.samples import sample_common as SC
    scene = SC.make_bench_image(720, 1280, seed=9)
    mask = SC.roi_mask(720, 1280) if masked else None
    slots = []
    for d in ("cuda", "cpu"):
        ef = EfficientFeatures(nfeatures=3000, nonmax_radius=radius,
                               descriptor_type="bad_256", device=d)
        kps, desc = ef.detect_and_compute_async(scene, mask=mask)
        slots.append(({k: v.cpu() for k, v in kps._slots.items()},
                      desc.cpu()))
    (gk, gd), (ck, cd) = slots
    for k in ("x", "y", "octave", "size", "response", "valid", "count"):
        assert torch.equal(gk[k], ck[k]), k
    assert float((gk["angle"] - ck["angle"]).abs().max()) < 1e-3
    assert int((gd != cd).sum()) <= _budget(cd.numel())


@pytest.mark.cuda
def test_masked_tie_fallback_on_the_card_matches_the_cpu(dev):
    before = TD.select_topk_cells.fallbacks
    slots = [EfficientFeatures(nfeatures=64, nlevels=1,
                               descriptor_type="bad_256",
                               device=d).detect(tie_image(),
                                                mask=tie_mask())._slots
             for d in ("cuda", "cpu")]
    assert TD.select_topk_cells.fallbacks == before + 2
    assert int(slots[1]["count"]) == 3
    for k in slots[1]:
        if k != "angle":
            assert torch.equal(slots[0][k].cpu(), slots[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("src_hw,dst_hw", [
    ((200, 300), (167, 250)), ((200, 300), (16, 20)), ((60, 90), (97, 151)),
    ((131, 203), (109, 169)), ((9, 10), (8, 8)), ((50, 70), (41, 59))])
def test_resize_kernel_matches_plain(dev, src_hw, dst_hw):
    """K10 against `resize_u8`, bit for bit: a pyramid step, a tiny level,
    an upscale, widths that are no multiple of 4, a size whose last group
    of 4 is partial (41 * 59), on a scene, on noise and on all-255."""
    from efficient_features_tpu_torch.ops import image as TI
    rng = np.random.default_rng(sum(dst_hw))
    imgs = [rng.integers(0, 256, src_hw, dtype=np.uint8),
            np.full(src_hw, 255, np.uint8)]
    if min(src_hw) > 16:
        imgs.append(make_test_image(*src_hw, seed=3))
    for img in imgs:
        t = torch.from_numpy(img).to(dev)
        before = TI.resize_u8_kernel.launches
        got = TI.resize_u8_fast(t, dst_hw)
        assert TI.resize_u8_kernel.launches == before + 1
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert torch.equal(got, TI.resize_u8(t, dst_hw))
        assert torch.equal(got.cpu(), TI.resize_u8(t.cpu(), dst_hw))
    with pytest.raises(ValueError, match="contiguous"):
        TI.resize_u8_kernel(t.t(), dst_hw)


@pytest.mark.cuda
def test_pyramid_on_the_card_matches_the_cpu(dev):
    from efficient_features_tpu_torch.ops import image as TI
    img = make_test_image(200, 280, seed=5)
    before = TI.resize_u8_kernel.launches
    got = TI.build_pyramid(torch.from_numpy(img).to(dev), 1.2, 8)
    assert TI.resize_u8_kernel.launches == before + 7
    for a, b in zip(got, TI.build_pyramid(torch.from_numpy(img), 1.2, 8)):
        assert torch.equal(a.cpu(), b)


def _edge_image():
    """Hard 0/255 edges: gradients of +-255 in the histogram."""
    img = np.zeros((160, 256), np.uint8)
    img[:, 128:] = 255
    img[40:80, 40:80] = 255
    img[100:140, 160:200] = 0
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("size", [31.0, 64.0, 300.0])
@pytest.mark.parametrize("scene", ["scene", "edges"])
def test_fused_hs_kernel_matches_two_stage_and_plain(dev, size, scene):
    """K11 rows: the bytes of K5 on K4's patches, within the histogram
    tolerance of the plain version, zero for invalid slots, the same on
    every run; keypoints on the image corners included."""
    img = make_test_image(200, 280, seed=33) if scene == "scene" \
        else _edge_image()
    h, w = img.shape
    x, y, _, angle, valid = bad_keypoints(h, w, 300, seed=int(size))
    t = torch.from_numpy(img).to(dev)
    kp = [torch.from_numpy(a).to(dev)
          for a in (x, y, np.full(300, size, np.float32), angle, valid)]
    before = (WK.hs_desc_windows.launches, WK.warp_patches_windows.launches,
              WK.hs_hist_from_patches.launches)
    rows = WK.hs_desc_windows(t, *kp, 1.0)
    assert (WK.hs_desc_windows.launches, WK.warp_patches_windows.launches,
            WK.hs_hist_from_patches.launches) == (before[0] + 1, before[1],
                                                  before[2])
    staged = WK.hs_hist_from_patches(WK.warp_patches_windows(t, *kp, 1.0))
    assert torch.equal(rows, staged)
    _close_u8(rows, WK.hs_desc_windows_ref(t, *kp, 1.0), 2e-3)
    assert int(rows[~kp[4]].to(torch.int32).sum()) == 0
    assert bool((rows[kp[4]] != 0).any())
    assert torch.equal(rows, WK.hs_desc_windows(t, *kp, 1.0))    # determinism


def block_edge_valid(n: int) -> np.ndarray:
    """Valid flags that put empty slots at the edges of the histogram
    kernels' 8-slot blocks: blocks 0-7 each lack the slot at their own
    position, blocks 8-15 hold only that slot, block 16 is all invalid,
    the rest valid (n = 147 covers every pattern and a 3-slot tail)."""
    valid = np.ones(n, bool)
    for b in range(min(8, n // 8)):
        valid[8 * b + b] = False
    for b in range(8, min(16, n // 8)):
        valid[8 * b:8 * b + 8] = False
        valid[8 * b + b - 8] = True
    if n >= 136:
        valid[128:136] = False
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("n,scene", [(1, "scene"), (7, "scene"),
                                     (9, "scene"), (63, "scene"),
                                     (65, "scene"), (147, "scene"),
                                     (147, "edges")])
def test_hist_kernels_at_block_edges(dev, n, scene):
    """K5 and K11 at the edges of their 8-patch blocks: n = 1, one below
    and one above a multiple of 8, empty patches (K5) and invalid slots
    (K11) at every position of a block, a block of only those, blocks with
    one live patch, a valid keypoint whose patch lies off the image, and
    the saturated 0/255 edge image.  Each: within the histogram tolerance
    of plain, zero rows where the patch is empty or the slot invalid, two
    runs bit-identical, and K11 the bytes of K5 on K4's patches."""
    img = make_test_image(200, 280, seed=33) if scene == "scene" \
        else _edge_image()
    h, w = img.shape
    rng = np.random.default_rng(n)
    x = rng.uniform(0, w - 1, n).astype(np.float32)
    y = rng.uniform(0, h - 1, n).astype(np.float32)
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::5] = -1.0
    valid = block_edge_valid(n)
    if n > 1:
        x[n // 2] = -500.0                 # valid, its patch all zero
    t = torch.from_numpy(img).to(dev)
    kp = [torch.from_numpy(a).to(dev)
          for a in (x, y, np.full(n, 31.0, np.float32), angle, valid)]
    patches = WK.warp_patches_windows(t, *kp, 1.0)
    staged = WK.hs_hist_from_patches(patches)
    rows = WK.hs_desc_windows(t, *kp, 1.0)
    assert torch.equal(rows, staged)
    _close_u8(staged, WK.hs_hist_from_patches_ref(patches), 2e-3)
    _close_u8(rows, WK.hs_desc_windows_ref(t, *kp, 1.0), 2e-3)
    empty = (patches == 0).all(dim=1)
    assert bool(empty[~kp[4]].all()) and bool(empty[n // 2]) == (n > 1)
    assert int(staged[empty].to(torch.int32).sum()) == 0
    assert bool((staged != 0).any())
    assert torch.equal(staged, WK.hs_hist_from_patches(patches))
    assert torch.equal(rows, WK.hs_desc_windows(t, *kp, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("descriptor_type", ["hash_sift_256",
                                             "hash_sift_512"])
def test_fused_slice_on_the_card(dev, descriptor_type):
    """dAC with hs_fused=True on the card: the two-stage route's bytes, no
    K4 or K5 launch, and within budget of the CPU port; compute() and the
    batch entry point alike."""
    from efficient_features_tpu_torch import HashSIFT
    scene = make_test_image(200, 280, seed=7)
    kw = dict(nfeatures=500, descriptor_type=descriptor_type)
    fused = EfficientFeatures(device="cuda", hs_fused=True, **kw)
    before = (WK.hs_desc_windows.launches, WK.warp_patches_windows.launches,
              WK.hs_hist_from_patches.launches)
    kf, df = fused.detect_and_compute_async(scene)
    assert (WK.hs_desc_windows.launches, WK.warp_patches_windows.launches,
            WK.hs_hist_from_patches.launches) == (before[0] + 8, before[1],
                                                  before[2])
    ks, ds = EfficientFeatures(device="cuda",
                               **kw).detect_and_compute_async(scene)
    assert torch.equal(df, ds)
    assert all(torch.equal(kf._slots[k], ks._slots[k]) for k in kf._slots)
    kc, dc = EfficientFeatures(device="cpu", hs_fused=True,
                               **kw).detect_and_compute_async(scene)
    for k in ("x", "y", "octave", "size", "response", "valid", "count"):
        assert torch.equal(kf._slots[k].cpu(), kc._slots[k]), k
    assert int((df.cpu() != dc).sum()) <= int(1e-4 * dc.numel()) + 1
    nbits = int(descriptor_type.rsplit("_", 1)[1])
    kp = np.stack([np.linspace(0, 279, 64), np.linspace(0, 199, 64),
                   np.linspace(31, 300, 64), np.linspace(-1, 359, 64)],
                  axis=1).astype(np.float32)
    np.testing.assert_array_equal(
        HashSIFT(1.0, nbits, device="cuda", fused=True).compute(scene, kp),
        HashSIFT(1.0, nbits, device="cuda").compute(scene, kp))
    frames = np.stack([scene, scene[::-1].copy()])
    slots, desc = fused.detect_and_compute_batch(frames)
    for i in range(2):
        k1, d1 = fused.detect_and_compute_async(frames[i])
        assert torch.equal(desc[i], d1)
        assert all(torch.equal(slots[k][i], v) for k, v in k1._slots.items())
