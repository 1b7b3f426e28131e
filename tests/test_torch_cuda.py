"""The port's compiled CUDA kernels against their plain versions, on a card.

Marked `cuda`; each test skips where `torch.cuda.is_available()` is false.
This file imports neither jax nor the JAX package, so on a machine without
jax it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in `tests/test_torch_kernels.py`,
`tests/test_torch_detect_config.py`, `tests/test_torch_hash_sift.py`,
`tests/test_torch_resize.py` and `tests/test_torch_hs_fused.py`:
K1 (with and without a mask), K2 (moments and angles), K7, K8, K9 and K10
bit-exact, K3 byte for byte (its box sums are exact integers however they
are formed), K4 byte for byte (the plain version's arithmetic on the same
pixels, from a staged window or the image), the device trig of K3, K4 and
K11 bit for bit with `bad.affine_trig` on the card, K5 and K11 rows
|diff| <= 1 on fewer than 2e-3 of the entries, HashSIFT descriptors at most
int(1e-4 * bytes) + 1 differing bytes.  K5 and K11 must give the same
bytes on every run, and K11 the bytes of K5 on K4's patches, also at the
edges of their 8-patch blocks.  K12's four kernels (the Jacobi
eigenvectors, the minimal sets' solve, the scores, the one-H mask) and
K13 are bit for bit their plain versions.
"""
import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.ops import bad as TB
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import detect_kernels as DK
from efficient_features_tpu_torch.ops import hash_sift as THS
from efficient_features_tpu_torch.ops import orientation as TO
from efficient_features_tpu_torch.ops import window_kernels as WK
from efficient_features_tpu_torch.tools.oncard import (equal_image, tie_image,
                                                       tie_mask)
from efficient_features_tpu_torch.utils import semantics as TS

from util import make_test_image


def tied_responses(resp: torch.Tensor) -> torch.Tensor:
    """`resp` (-inf where there is no corner) with its corners' responses
    quantised to three levels, 1, 2 and 3 by tercile: a map of heavily tied
    responses, on which tied corners must co-survive."""
    finite = resp != TD.RESP_SENTINEL
    vals = resp[finite].sort().values
    n = vals.numel()
    level = 1.0 + (resp > vals[n // 3]).float() + (resp > vals[2 * n // 3])
    return torch.where(finite, level, TD.RESP_SENTINEL)


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
    64-300 px (compute() on the raw image), both sides of the limit of the
    shared-memory window (s = 1.125, size 36, `bad.window_plan`), or a
    detector's eight octaves at 1.2 (`KeyPoints.xysa()` handed to
    compute(): 31 px in the window, octaves 1-7 through the whole image's
    integral)."""
    if case == "size 31":
        return np.full(n, 31.0, np.float32)
    if case == "sizes 64-300":
        return rng.uniform(64.0, 300.0, n).astype(np.float32)
    if case == "detector octaves":
        octaves = np.float32([s * np.float32(31.0) for s in
                              TS.pyramid_scales(1.2, 8)])
        return octaves[np.arange(n) % 8]
    return rng.choice(np.float32([34.0, 35.9, 36.0, 36.1, 37.2, 44.6]), n)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [256, 512])
@pytest.mark.parametrize("case", ["size 31", "sizes 64-300",
                                  "window limit", "detector octaves"])
def test_bad_kernel_bytes_equal_plain(dev, nbits, case):
    """Zero differing bytes at both bit counts, on keypoints on the four
    corners, the edges and the 27.125 px branch boundary as well."""
    img = torch.from_numpy(make_test_image(400, 560, seed=21)).to(dev)
    if case == "size 31":      # dAC describes on the blurred level
        from efficient_features_tpu_torch.ops import image as TI
        img = TI.gaussian_blur7_u8(img)
    x, y, _, angle, valid = bad_keypoints(400, 560, 2000, seed=len(case))
    size = _bad_sizes(case, 2000, np.random.default_rng(nbits))
    if case == "detector octaves":     # each edge keypoint at every octave
        for a in (x, y, angle):
            a[:80] = np.repeat(a[:10], 8)
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
    """A tied 8x8 block: both tied survivors are selected, from K1's
    bitmap, with no host read, and the card equals the CPU."""
    slots = [EfficientFeatures(nfeatures=64, nlevels=1,
                               descriptor_type="bad_256",
                               device=d).detect(tie_image())._slots
             for d in ("cuda", "cpu")]
    cnt = DK.fast_harris_nms_cells_ref(torch.from_numpy(tie_image()), 20,
                                       15)[2]
    assert int(slots[0]["count"]) == int(cnt.sum())
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
    assert torch.equal(patches, WK.warp_patches_windows_ref(img, *kp, 1.0))
    patches[7] = 0                                    # an all-zero patch
    rows = WK.hs_hist_from_patches(patches)
    assert (WK.warp_patches_windows.launches,
            WK.hs_hist_from_patches.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _close_u8(rows, WK.hs_hist_from_patches_ref(patches), 2e-3)
    assert int(rows[7].sum()) == 0
    assert torch.equal(rows, WK.hs_hist_from_patches(patches))   # determinism


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that equality tells -0 from +0."""
    return t.contiguous().view(torch.int32)


def ic_keypoints(h, w, n, seed):
    """(ys, xs, valid): random keypoints, those on and next to the image
    corners and edges and 15 px in, and a quarter of the slots invalid."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h, n).astype(np.int32)
    xs = rng.integers(0, w, n).astype(np.int32)
    ys[:10] = [0, 0, h - 1, h - 1, 14, 15, h - 16, h - 15, h // 2, 7]
    xs[:10] = [0, w - 1, 0, w - 1, 15, 14, w - 15, w - 16, 3, w // 2]
    valid = rng.random(n) < 0.75
    valid[:10] = True
    return ys, xs, valid


@pytest.mark.cuda
@pytest.mark.parametrize("image", ["scene", "noise", "odd width"])
def test_ic_angles_kernel_exact(dev, image):
    """K2's angles bit for bit those of `angles_from_moments` of the plain
    moments run on the card, 0 where invalid; the moments-only entry
    exact."""
    img = {"scene": lambda: make_test_image(200, 280, seed=33),
           "noise": noise_image,
           "odd width": lambda: make_test_image(97, 131, seed=5)}[image]()
    h, w = img.shape
    t = torch.from_numpy(img).to(dev)
    ys, xs, valid = (torch.from_numpy(a).to(dev)
                     for a in ic_keypoints(h, w, 3000, h + w))
    before = (WK.ic_angles_windows.launches, WK.ic_moments_windows.launches)
    got = WK.ic_angles_windows(t, ys, xs, valid)
    moments = WK.ic_moments_windows(t, ys, xs)
    assert (WK.ic_angles_windows.launches,
            WK.ic_moments_windows.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(moments, TO.ic_moments(t, ys, xs))
    want = WK.ic_angles_windows_ref(t, ys, xs, valid)
    assert got.dtype == torch.float32 and torch.equal(_bits(got), _bits(want))
    assert not bool(got[~valid].any())
    every = WK.ic_angles_windows(t, ys, xs, torch.ones_like(valid))
    assert torch.equal(_bits(every), _bits(WK.ic_angles_windows_ref(
        t, ys, xs, torch.ones_like(valid))))


@pytest.mark.cuda
def test_ic_angle_step_exact(dev):
    """K2's angle step on 2^20 random moment pairs (|m| < 2^21), the axes,
    zeros and |m01| = |m10|: bit for bit the plain step on the card."""
    rng = np.random.default_rng(26)
    m = rng.integers(-(1 << 21) + 1, 1 << 21, (1 << 20, 2)).astype(np.int32)
    v = np.array([0, 1, 7, 255, 1 << 20, (1 << 21) - 1], np.int32)
    special = [(a, 0) for a in np.concatenate([v, -v])] \
        + [(0, a) for a in np.concatenate([v, -v])] \
        + [(sa * a, sb * a) for a in v for sa in (1, -1) for sb in (1, -1)]
    m = torch.from_numpy(np.concatenate([m, np.array(special, np.int32)])
                         ).to(dev)
    got = WK.ic_angles_from_moments(m)
    assert torch.equal(_bits(got), _bits(WK.ic_angles_from_moments_ref(m)))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 1.2])
def test_keypoint_trig_sweep(dev, scale):
    """The device trig of K3, K4 and K11 on 2^24 float32 angles spread over
    [0, 360) and angle -1, at size 31 and 300: s, cos*s and sin*s bit for
    bit those of `bad.affine_trig` run on the card."""
    top = 0x43B40000                       # the bits of 360.0
    bits = torch.linspace(0, top - 1, 1 << 24, dtype=torch.float64,
                          device=dev).to(torch.int32)
    angle = torch.cat([bits.view(torch.float32),
                       torch.tensor([-1.0], device=dev)])
    assert float(angle[:-1].max()) < 360.0
    for size_px in (31.0, 300.0):
        size = torch.full_like(angle, size_px)
        before = WK.keypoint_trig.launches
        s, c, sn = WK.keypoint_trig(size, angle, scale)
        assert WK.keypoint_trig.launches == before + 1
        s_ref, cos_ref, sin_ref = TB.affine_trig(size, angle, scale)
        for a, b in ((s, s_ref), (c, cos_ref * s_ref), (sn, sin_ref * s_ref)):
            assert torch.equal(_bits(a), _bits(b))


def warp_keypoints(h, w, n, seed, sizes):
    """(x, y, size, angle, valid): random keypoints of the given sizes,
    those on the image corners and edges and some off the image, angle -1
    on every 7th, a tenth of the slots invalid."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50.0, w + 50.0, n).astype(np.float32)
    y = rng.uniform(-50.0, h + 50.0, n).astype(np.float32)
    x[:10] = [0, w - 1, 0, w - 1, 0.5, w - 1.5, -3.25, w + 2.0, w / 2, -40.0]
    y[:10] = [0, 0, h - 1, h - 1, 0.5, h - 1.5, h / 2, 3.0, -0.75, h + 40.0]
    size = np.asarray(sizes, np.float32)[rng.integers(0, len(sizes), n)]
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[::7] = -1.0
    valid = rng.random(n) < 0.9
    return x, y, size, angle, valid


WARP_SIZES = [31.0 * 1.2 ** k for k in range(8)] + [300.0]
# the largest window K4 stages is 64 px: size 41.0 at scale 1 (s = 1.28125)
# fits, 41.1 does not
WARP_LIMIT = [40.0, 40.9, 41.0, 41.1, 41.5, 43.0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ladder", "window limit", "size 31"])
@pytest.mark.parametrize("scale", [1.0, 1.2])
def test_warp_kernel_exact(dev, case, scale):
    """K4 byte for byte with its plain version across the window limit, on
    and off the image, at angle -1, and with invalid slots."""
    img = torch.from_numpy(make_test_image(300, 420, seed=17)).to(dev)
    sizes = {"ladder": WARP_SIZES, "window limit": WARP_LIMIT,
             "size 31": [31.0]}[case]
    kp = [torch.from_numpy(a).to(dev)
          for a in warp_keypoints(300, 420, 3000, len(case), sizes)]
    plan = THS.warp_window_plan(kp[0], kp[1], np.float32(scale) * kp[2] / 32.0,
                                300, 420)
    if case != "size 31":        # both branches run
        assert bool((plan.in_smem & kp[4]).any())
        assert bool((~plan.in_smem & kp[4]).any())
    before = WK.warp_patches_windows.launches
    got = WK.warp_patches_windows(img, *kp, scale)
    assert WK.warp_patches_windows.launches == before + 1
    assert torch.equal(got, WK.warp_patches_windows_ref(img, *kp, scale))
    assert not bool(got[~kp[4]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1, 1), (1, 40), (40, 1), (2, 3), (3, 2),
                                (3, 50), (64, 64)])
def test_warp_kernel_at_the_edges(dev, hw):
    """Images 1-3 px tall or wide and one window's size, keypoints in and
    around them of 31-300 px, n = 1 and every slot invalid."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    img = torch.from_numpy(rng.integers(0, 256, hw, dtype=np.uint8)).to(dev)
    x, y, size, angle, _ = warp_keypoints(h, w, 64, h + w,
                                          WARP_SIZES + WARP_LIMIT)
    kp = [torch.from_numpy(a).to(dev) for a in (x, y, size, angle)]
    for k, valid in ((64, np.ones(64, bool)), (64, np.zeros(64, bool)),
                     (1, np.ones(1, bool))):
        args = [t[:k] for t in kp] + [torch.from_numpy(valid).to(dev)]
        got = WK.warp_patches_windows(img, *args, 1.0)
        assert torch.equal(got, WK.warp_patches_windows_ref(img, *args, 1.0))
        if h * w == 1:          # no 2x2 support fits a 1x1 image
            assert not bool(got.any())
        if not valid.any():
            assert not bool(got.any())


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
@pytest.mark.parametrize("radius", [1, 3, 5, 8, 9, 15, 49, 64, 128])
def test_radius_nms_kernel_matches_plain(dev, radius):
    """K9 at the radii of its staged kernel (<= 9) and of its per-pixel
    scan, unmasked, under a random mask, on tied responses and on maps
    smaller than a tile or 65 wide."""
    img = torch.from_numpy(make_test_image(200, 280, seed=33)).to(dev)
    resp = DK.fast_harris(img, 20)
    keep = torch.from_numpy(np.random.default_rng(radius).random((200, 280))
                            < 0.5).to(dev)
    for r in (resp, torch.where(keep, resp, TD.RESP_SENTINEL),
              tied_responses(resp), resp[60:91, 100:163].contiguous(),
              resp[50:147, 100:165].contiguous()):
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
    slots = [EfficientFeatures(nfeatures=64, nlevels=1,
                               descriptor_type="bad_256",
                               device=d).detect(tie_image(),
                                                mask=tie_mask())._slots
             for d in ("cuda", "cpu")]
    assert int(slots[0]["count"]) == int(slots[1]["count"]) == 3
    for k in slots[1]:
        if k != "angle":
            assert torch.equal(slots[0][k].cpu(), slots[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("src_hw,dst_hw", [
    ((200, 300), (167, 250)), ((200, 300), (16, 20)), ((60, 90), (97, 151)),
    ((131, 203), (109, 169)), ((9, 10), (8, 8)), ((50, 70), (41, 59)),
    ((2160, 3840), (1800, 3200)), ((97, 333), (81, 277)),
    ((2160, 3840), (540, 960))])
def test_resize_kernel_matches_plain(dev, src_hw, dst_hw):
    """K10 against `resize_u8`, bit for bit: pyramid steps (the first of a
    4K frame among them), a tiny level, an upscale, widths that are no
    multiple of 4, a size whose last word is partial (41 * 59), a 4x
    downscale whose tiles read the image directly, on a scene, on noise and
    on all-255."""
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
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_resize_kernel_on_rows_that_start_unaligned(dev, offset):
    """A source view `offset` bytes past an aligned allocation: K10 stages
    each row's aligned chunks as they lie."""
    from efficient_features_tpu_torch.ops import image as TI
    img = torch.from_numpy(np.random.default_rng(offset).integers(
        0, 256, (300, 512), dtype=np.uint8)).to(dev)
    flat = torch.zeros(300 * 512 + 16, dtype=torch.uint8, device=dev)
    src = flat[offset:offset + 300 * 512].view(300, 512)
    src.copy_(img)
    assert src.is_contiguous() and src.data_ptr() % 16 == offset
    for dst_hw in ((250, 427), (75, 128), (389, 701)):
        assert torch.equal(TI.resize_u8_kernel(src, dst_hw),
                           TI.resize_u8(img, dst_hw))


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


def band_image(frame: np.ndarray, oy: int, ox: int, rows: int, cols: int,
               seed: int = 0) -> np.ndarray:
    """Rows [oy, oy + rows) and columns [ox, ox + cols) of the frame, noise
    where they leave it."""
    out = np.random.default_rng(seed).integers(0, 256, (rows, cols),
                                               dtype=np.uint8)
    fh, fw = frame.shape
    y0, y1 = max(oy, 0), min(oy + rows, fh)
    x0, x1 = max(ox, 0), min(ox + cols, fw)
    if y0 < y1 and x0 < x1:
        out[y0 - oy:y1 - oy, x0 - ox:x1 - ox] = frame[y0:y1, x0:x1]
    return out


# (oy, ox, rows, cols) of a band of a 300 x 420 frame: inside it, starting
# above it, running past it, one row, one column, an inner piece
CARD_BANDS = [(100, 0, 60, 420), (-40, 0, 90, 420), (200, 0, 140, 420),
              (130, 0, 1, 420), (0, 150, 300, 1), (30, 40, 50, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("band", CARD_BANDS)
def test_descriptor_kernels_on_a_band_match_plain(dev, band):
    """K3, K4 and K11 with `origin` / `frame_hw` (an image that is a band
    of a larger frame, keypoints in frame coordinates): K3 and K4 byte for
    byte their plain versions, K11 the bytes of K5 on K4's patches."""
    oy, ox, rows, cols = band
    frame = make_test_image(300, 420, seed=17)
    img = torch.from_numpy(band_image(frame, *band)).to(dev)
    x, y, size, angle, valid = warp_keypoints(300, 420, 300, 23,
                                              WARP_SIZES + WARP_LIMIT)
    kp = [torch.from_numpy(a).to(dev) for a in (x, y, size, angle, valid)]
    where = dict(origin=(oy, ox), frame_hw=(300, 420))
    for nbits in (256, 512):
        got = WK.bad_descriptors_windows(img, *kp, nbits, 1.0, **where)
        want = WK.bad_descriptors_windows_ref(img, *kp, nbits, 1.0, **where)
        assert torch.equal(got, want), nbits
    for scale in (1.0, 1.2):
        patches = WK.warp_patches_windows(img, *kp, scale, **where)
        assert torch.equal(patches, WK.warp_patches_windows_ref(
            img, *kp, scale, **where))
        fused = WK.hs_desc_windows(img, *kp, scale, **where)
        assert torch.equal(fused, WK.hs_hist_from_patches(patches))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_resize_kernel_on_bands_matches_plain(dev, n):
    """K10 on every band of a 1080 x 1920 pyramid split into n bands, from
    the band below with its halo rows (`ops/image.BandRows`), bit for bit
    the plain band resize and the whole level's rows."""
    from efficient_features_tpu_torch.ops import image as I
    img = torch.from_numpy(make_test_image(1080, 1920, seed=5)).to(dev)
    shapes = TS.pyramid_shapes(1080, 1920, 1.2, 8)
    levels = I.build_pyramid(img, 1.2, 8)
    bh = [-(-hs // n) for hs, _ in shapes]
    halo = max(16, int(np.ceil((n - 1) * 1.2)) + 4)
    before = I.resize_u8_kernel.launches
    for s in range(1, 8):
        (hs, ws), (hp, wp) = shapes[s], shapes[s - 1]
        prev = torch.zeros((n * bh[s - 1] + 2 * halo, wp), dtype=torch.uint8,
                           device=dev)
        prev[halo:halo + hp] = levels[s - 1]
        for i in range(n):
            ext = prev[i * bh[s - 1]:
                       i * bh[s - 1] + bh[s - 1] + 2 * halo].contiguous()
            band = I.BandRows(hs, hp, i * bh[s], bh[s],
                              i * bh[s - 1] - halo, ext.shape[0])
            got = I.resize_u8_kernel(ext, (bh[s], ws), band)
            assert torch.equal(got, I.resize_u8(ext, (bh[s], ws), band))
            rows = min(bh[s], hs - i * bh[s])
            assert torch.equal(got[:rows],
                               levels[s][i * bh[s]:i * bh[s] + rows])
    assert I.resize_u8_kernel.launches == before + 7 * n


@pytest.mark.cuda
def test_jacobi_kernel_matches_plain(dev):
    """K12 bit for bit its plain version (the same float64 rotations in the
    same order), one launch a call, the batch shape kept."""
    from efficient_features_tpu_torch.ops import ransac as TR
    m = np.random.default_rng(12).standard_normal((513, 9, 12))
    ata = torch.from_numpy((m @ m.transpose(0, 2, 1)).astype(np.float32))
    for a in (ata, ata[:1], ata[:6].reshape(2, 3, 9, 9),
              torch.zeros((2, 9, 9))):
        a = a.to(dev)
        before = TR.smallest_eigvec9.launches
        got = TR.smallest_eigvec9(a)
        assert TR.smallest_eigvec9.launches == before + 1
        want = TR.smallest_eigvec9_ref(a)
        assert got.shape == a.shape[:-1] and torch.equal(got, want)


def _ransac_scene(n, m, seed):
    """n pairs under a homography, a fifth of them outliers, every fifth
    slot invalid, a few sent to the plane at infinity; m minimal sets."""
    rng = np.random.default_rng(seed)
    h = np.array([[1.02, 0.03, 5.0], [-0.02, 0.98, -3.0], [1e-4, -5e-5, 1.0]])
    src = rng.uniform(0, 600, (n, 2))
    p = np.concatenate([src, np.ones((n, 1))], 1) @ h.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(0, 0.8, (n, 2))
    out = rng.random(n) < 0.2
    dst[out] = rng.uniform(0, 600, (int(out.sum()), 2))
    valid = np.ones(n, bool)
    valid[::5] = False
    src[7::97] = [-1e4, 0.0]      # 1e-4 x - 5e-5 y + 1 = 0: at infinity
    idx = np.stack([rng.choice(n, 4, replace=False) for _ in range(m)])
    return (torch.from_numpy(src.astype(np.float32)),
            torch.from_numpy(dst.astype(np.float32)),
            torch.from_numpy(valid), torch.from_numpy(idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 64), (777, 129)])
def test_ransac_kernels_match_plain(dev, n, m):
    """K12's solve and verify kernels bit for bit their plain versions (the
    same float steps in the same order), one launch a call: the minimal
    sets' H, every hypothesis's score, one H's mask and count; with n not a
    multiple of a block, more hypotheses than one block's chunk, points at
    infinity, invalid slots and a degenerate set (four equal indices)."""
    from efficient_features_tpu_torch.ops import ransac as TR
    src, dst, valid, idx = _ransac_scene(n, m, 16)
    idx[3] = idx[3, 0]
    src, dst, valid, idx = (t.to(dev) for t in (src, dst, valid, idx))
    before = TR.solve_minimal_sets.launches
    H = TR.solve_minimal_sets(src, dst, idx)
    assert TR.solve_minimal_sets.launches == before + 1
    assert torch.equal(H, TR.solve_minimal_sets_ref(src, dst, idx))
    t2 = 9.0
    before = TR.score_homographies.launches
    scores = TR.score_homographies(H, src, dst, valid, t2)
    assert TR.score_homographies.launches == before + 1
    assert torch.equal(scores,
                       TR.score_homographies_ref(H, src, dst, valid, t2))
    assert int(scores.max()) > 0.5 * int(valid.sum())
    for valid_k in (valid, torch.zeros_like(valid)):
        before = TR.inlier_mask.launches
        got = TR.inlier_mask(H[int(scores.argmax())], src, dst, valid_k, t2)
        assert TR.inlier_mask.launches == before + 1
        want = TR.inlier_mask_ref(H[int(scores.argmax())], src, dst, valid_k,
                                  t2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_detect_and_ransac_read_nothing_back(dev):
    """`detect_and_compute_async` at radius 15 (the cells route, a tied
    block in the image), replayed from its graph and run eagerly, and
    `find_homography_ransac` enqueue work only: torch's sync debug mode
    raises on any host sync.  The key's first call (the device tables) and
    its capture come before."""
    from efficient_features_tpu_torch import graphs as G
    from efficient_features_tpu_torch.ops import ransac as TR
    img = make_test_image(240, 320, seed=3)
    img[100:196, 80:240] = tie_image()
    img = torch.from_numpy(img).to(dev)
    ef = EfficientFeatures(nfeatures=2000, device="cuda")
    G.CACHE.clear()
    kps, _ = ef.detect_and_compute_async(img)
    ef.detect_and_compute_async(img)
    xy = torch.stack([kps._slots["x"], kps._slots["y"]], dim=1)
    ok = kps._slots["valid"]
    want = TR.find_homography_ransac(xy, xy + 2.0, ok, iters=64,
                                     device="cuda")
    torch.cuda.synchronize()
    replays = G.CACHE.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        ef.detect_and_compute_async(img)
        got = TR.find_homography_ransac(xy, xy + 2.0, ok, iters=64,
                                        device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert G.CACHE.replays == replays + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    G.CACHE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ef.detect_and_compute_async(img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (G.CACHE.eager, G.CACHE.captures) == (1, 0)


def grid_maps(h, w, mask=None):
    """(response, survivor) maps whose survivors lie every 6 px each way
    from (3, 3), all with one response (`equal_image`'s corners without its
    15 px border): every 8x8 block is live, holds 1 to 4 tied survivors and
    ties with every other.  mask (bool (h, w)) drops survivors."""
    surv = np.zeros((h, w), bool)
    surv[3::6, 3::6] = True
    if mask is not None:
        surv &= mask
    return np.where(surv, np.float32(1000.0), -np.inf).astype(np.float32), surv


def grid_cells(h, w, mask=None):
    """K1's cells of `grid_maps`."""
    return DK.cells_from_dense(*map(torch.from_numpy, grid_maps(h, w, mask)))


def _select_cases(dev):
    """(label, (cellmax, cellrow, cellbits, h, w) on dev, quotas) of the
    K13 test, made one at a time."""
    from efficient_features_tpu_torch.samples import sample_common as SC

    def k1(img, mask=None):
        m = None if mask is None else torch.from_numpy(mask != 0).to(dev)
        cm, cr, _, cb = DK.fast_harris_nms_cells(torch.from_numpy(img).to(dev),
                                                 20, 15, m)
        return cm, cr, cb, *img.shape

    def grid(h, w, mask=None):
        cm, cr, _, cb = grid_cells(h, w, mask)
        return cm.to(dev), cr.to(dev), cb.to(dev), h, w

    scene = SC.tiled_scene(2160, 3840, seed=2160, distinct=False)
    roi = SC.roi_mask(2160, 3840)
    nb = 270 * 480
    yield "scene", k1(make_test_image(200, 280, seed=33)), (1, 50, 5000)
    yield "odd", k1(make_test_image(141, 203, seed=8)), (3000,)
    yield "tie", k1(tie_image()), (1, 2, 64)
    yield "tie 1x4", k1(np.tile(tie_image(), (1, 4))), (1, 3, 5, 7, 100)
    yield "tie 3x3", k1(np.tile(tie_image(), (3, 3))), (1, 3, 5, 7, 100)
    # every block live, one tie group: K1 on equal responses (its 15 px
    # border dead), and the grid without a border
    yield ("4K equal", k1(equal_image(2160, 3840)),
           (1, 8687, nb - 1, nb, 200000))
    yield "4K grid", grid(2160, 3840), (1, 8687, nb - 1, nb, 200000)
    yield "4K grid, ROI", grid(2160, 3840, roi != 0), (8687, nb)
    # a quota at and past the block count on the dense scene
    yield "4K scene", k1(scene), (8687, nb, 200000)
    yield "4K scene, ROI", k1(scene, roi), (8687, nb)
    # tie groups of thousands of blocks that share block rows
    yield ("4K tie tiling", k1(np.tile(tie_image(), (23, 24))[:2160]),
           (1, 1001, 40000, 200000))
    # levels one block row high
    yield "8-row grid", grid(8, 3840), (1, 5, 1000)
    # one run of 8200 tied blocks: the place kernel's rows one by one
    yield "8-row grid, 65600 wide", grid(8, 65600), (1, 8199, 8200, 20000)
    yield "5-row grid", grid(5, 77), (1, 5, 385)
    yield "8-row image", k1(scene[1000:1008].copy()), (1, 100)


@pytest.mark.cuda
def test_select_cells_kernel_matches_plain(dev):
    """K13 bit for bit its plain version (`ops/detect.select_topk_cells`),
    one launch a call: tied blocks that share block rows, quotas that cut
    inside them, a width and height that are not multiples of 8, every
    block live in one tie group, quotas at and past the block count, a ROI
    mask, tie groups of thousands of blocks and levels one block row high
    (the kernel's shared-memory and device-memory sorts both)."""
    for label, (cm, cr, cb, h, w), quotas in _select_cases(dev):
        for quota in quotas:
            before = DK.select_cells.launches
            got = DK.select_cells(cm, cr, cb, h, w, quota)
            assert DK.select_cells.launches == before + 1
            for a, b in zip(got, TD.select_topk_cells(cm, cr, cb, h, w,
                                                      quota)):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (label, quota)
