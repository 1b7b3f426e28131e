"""The descriptors' 7x7 Gaussian blur: K14 (`ops/image.gaussian_blur7_u8_kernel`,
csrc/blur7_u8.cu) against its plain version `gaussian_blur7_u8`.

The blur is 16-bit fixed-point integer arithmetic, so the tolerance is zero.
On the CPU: `gaussian_blur7_u8_fast` takes the plain version, the core and
the band route blur through it, the wrapper refuses what the kernel does not
take, and a numpy walk of the kernel's tiles (staged rows and columns with
REFLECT_101 at the level's edges, the row pass into bytes, the column pass,
the stores) equals the plain version.  Marked `cuda`: the kernel itself,
bit for bit, on the level shapes of the 4K and KITTI pyramids, odd and small
shapes, extreme images and a band.  This file imports neither jax nor the
JAX package, so on a machine without jax it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_blur.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch import graphs as G
from efficient_features_tpu_torch.ops import image as TI
from efficient_features_tpu_torch.parallel import sharding as SH
from efficient_features_tpu_torch.utils import semantics as TS

from util import make_test_image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs gain nothing from intra-op threads, and in a parallel
    test run the threads of each worker contend with the others'."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _levels(hw):
    return TS.pyramid_shapes(*hw, 1.2, 8)


# every level of the 4K and KITTI pyramids; the smallest sides the blur
# takes; one tile wide or tall; a last tile ragged on both axes
LEVELS = {"4k": _levels((2160, 3840)), "kitti": _levels((376, 1241))}
SMALL = [(4, 5), (5, 4), (7, 300), (300, 7), (97, 333), (33, 129)]


def _image(hw, kind, seed=0):
    """A test image of one kind: noise, all-0, all-255, hard 0/255 edges
    (the extremes of the rounding), or the tests' scene."""
    h, w = hw
    if kind == "noise":
        return np.random.default_rng(seed + h * w).integers(
            0, 256, hw, dtype=np.uint8)
    if kind in ("zeros", "ones"):
        return np.full(hw, 0 if kind == "zeros" else 255, np.uint8)
    if kind == "edges":
        img = np.zeros(hw, np.uint8)
        img[:, w // 2:] = 255
        img[h // 3:h // 2, :w // 3] = 255
        img[::5, 1::7] ^= 255
        return img
    return make_test_image(h, w, seed=seed)


KINDS = ["noise", "zeros", "ones", "edges"]


def _halo_index(first: int, count: int, n: int) -> np.ndarray:
    """K14's source index of positions first .. first + count - 1 along a
    side of n pixels (`reflect101` in csrc/blur7_u8.cu): REFLECT_101 of
    the position clamped to -3 .. n + 2, beyond which a position feeds no
    stored output."""
    i = np.clip(np.arange(first, first + count), -3, n + 2)
    return TS.reflect101_index(i, n)


def _walk_the_tiles(img: np.ndarray) -> np.ndarray:
    """K14 as its blocks compute it, in numpy int32, all tiles at once.  A
    tile (ty, tx) stages rows ty * TH - 3 .. + TH + 2 and columns tx * TW
    - 4 .. + TW + 3 through `_halo_index` (which must stay inside the
    level), runs the row pass into bytes over every staged row and output
    column x0 + q from staged columns q + 1 .. q + 7, then the column pass
    of its TH rows, and keeps what lies in the level."""
    h, w = img.shape
    th, tw = TI.BLUR_TILE_H, TI.BLUR_TILE_W
    nty, ntx = -(-h // th), -(-w // tw)
    rows = np.stack([_halo_index(ty * th - 3, th + 6, h)
                     for ty in range(nty)])
    cols = np.stack([_halo_index(tx * tw - 4, tw + 8, w)
                     for tx in range(ntx)])
    assert rows.min() >= 0 and rows.max() < h
    assert cols.min() >= 0 and cols.max() < w
    k = TS.gaussian_kernel7_fixed().astype(np.int32)
    half = np.int32(1 << (TS.BLUR_BITS - 1))
    stage = img[rows[:, None, :, None], cols[None, :, None, :]].astype(
        np.int32)                                   # (nty, ntx, th+6, tw+8)
    hp = sum(k[t] * stage[..., 1 + t:1 + t + tw] for t in range(7))
    hp = (hp + half) >> TS.BLUR_BITS
    assert hp.dtype == np.int32 and hp.min() >= 0 and hp.max() <= 255
    hp = hp.astype(np.uint8)                        # the row-pass byte tile
    vp = sum(k[t] * hp[..., t:t + th, :].astype(np.int32) for t in range(7))
    vp = ((vp + half) >> TS.BLUR_BITS).astype(np.uint8)
    return vp.transpose(0, 2, 1, 3).reshape(nty * th, ntx * tw)[:h, :w]


@pytest.mark.parametrize("case", ["4k", "kitti", "small"])
def test_a_walk_of_the_blur_tiles_matches_gaussian_blur7_u8(case):
    shapes = SMALL if case == "small" else LEVELS[case]
    kinds = KINDS if case == "small" else ["noise", "edges"]
    for hw in shapes:
        for kind in kinds:
            img = _image(hw, kind)
            want = TI.gaussian_blur7_u8(torch.from_numpy(img)).numpy()
            np.testing.assert_array_equal(_walk_the_tiles(img), want,
                                          err_msg=f"{hw} {kind}")


@pytest.mark.parametrize("m", range(4))
def test_the_column_pass_stores_each_column_once(m):
    """The stores of a tile row whose column x0 lies m bytes past a word
    boundary: lane k stores the aligned word k, whose first m bytes are
    lane k - 1's last m; lane 31 also stores word 32 when m > 0.  Each
    column of the tile inside the level is stored once, from a lane of the
    tile, at the byte it computed."""
    tw = TI.BLUR_TILE_W
    for hi in (tw, tw - 1, 5, 1):                   # the level's last column
        stored = np.zeros(tw, np.int64)
        for k in range(tw // 4 + (1 if m else 0)):
            assert k < tw // 4 or m > 0
            for b in range(4):
                c = 4 * k - m + b                   # column, tile-relative
                if not 0 <= c < hi:
                    continue
                lane, byte = (k - 1, 4 - m + b) if b < m else (k, b - m)
                assert 0 <= lane < tw // 4
                assert 4 * lane + byte == c
                stored[c] += 1
        assert (stored[:hi] == 1).all() and (stored[hi:] == 0).all()


@pytest.mark.parametrize("hw", [(4, 5), (31, 17), (120, 213)])
def test_fast_on_a_cpu_tensor_is_the_plain_version(hw, monkeypatch):
    def no_kernel(img):
        raise AssertionError("the CPU path reached the kernel wrapper")

    monkeypatch.setattr(TI, "gaussian_blur7_u8_kernel", no_kernel)
    img = torch.from_numpy(_image(hw, "noise"))
    got = TI.gaussian_blur7_u8_fast(img)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert torch.equal(got, TI.gaussian_blur7_u8(img))


def _recording(monkeypatch):
    calls = []
    real = TI.gaussian_blur7_u8_fast

    def fast(img):
        calls.append(tuple(img.shape))
        return real(img)

    monkeypatch.setattr(TI, "gaussian_blur7_u8_fast", fast)
    return calls


def test_the_core_blurs_through_the_fast_version(monkeypatch):
    """`pipeline.detect_and_compute_core` blurs each described level
    through `gaussian_blur7_u8_fast` (so a CUDA level takes K14), once a
    level; `detect` blurs nothing."""
    img = make_test_image(144, 256, seed=22)
    ef = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                           device="cpu")
    want = ef.detect_and_compute_async(img)
    calls = _recording(monkeypatch)
    got = ef.detect_and_compute_async(img)
    assert calls == _levels((144, 256))
    ef.detect(img)
    assert len(calls) == 8
    _same(got, want)


def _same(got, want):
    for k, v in want[0]._slots.items():
        assert torch.equal(got[0]._slots[k], v), k
    assert torch.equal(got[1], want[1])


def test_band_descriptors_blur_through_the_fast_version(monkeypatch,
                                                        tmp_path):
    """`sharding._band_descriptors` blurs through `gaussian_blur7_u8_fast`
    on both of its routes (a band's window with its exchanged rows; a
    band shorter than DESC_HALO, the whole level gathered), once a level,
    and the mesh call equals the single-device call."""
    img = make_test_image(144, 256, seed=23)
    ef = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                           device="cpu")
    want = ef.detect_and_compute_async(img)
    calls = _recording(monkeypatch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = ef.detect_and_compute_async(img, mesh=SH.make_mesh())
    finally:
        dist.destroy_process_group()
    shapes = _levels((144, 256))
    band = [(hs + 2 * SH.DESC_HALO, ws) for hs, ws in shapes
            if hs >= SH.DESC_HALO]
    whole = [(hs, ws) for hs, ws in shapes if hs < SH.DESC_HALO]
    assert band and whole
    assert calls == band + whole
    _same(got, want)


@pytest.mark.parametrize("shape,dtype,match", [
    ((10, 12), torch.uint8, "CUDA tensor"),
    ((10, 12), torch.float32, "CUDA tensor|uint8"),
    ((2, 10, 12), torch.uint8, "2-D"),
    ((3, 12), torch.uint8, "at least 4"),
    ((12, 3), torch.uint8, "at least 4")])
def test_the_kernel_wrapper_refuses(shape, dtype, match):
    """The wrapper launches or raises; it never runs the plain version in
    the kernel's place."""
    before = TI.gaussian_blur7_u8_kernel.launches
    with pytest.raises(ValueError, match=match):
        TI.gaussian_blur7_u8_kernel(torch.zeros(shape, dtype=dtype))
    assert TI.gaussian_blur7_u8_kernel.launches == before


# -- on a card ---------------------------------------------------------------

def _check_on_card(img: np.ndarray, dev, label=""):
    t = torch.from_numpy(img).to(dev)
    before = TI.gaussian_blur7_u8_kernel.launches
    got = TI.gaussian_blur7_u8_fast(t)
    assert TI.gaussian_blur7_u8_kernel.launches == before + 1
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert got.shape == t.shape
    assert torch.equal(got, TI.gaussian_blur7_u8(t)), label
    assert torch.equal(got.cpu(), TI.gaussian_blur7_u8(t.cpu())), label


@pytest.mark.cuda
@pytest.mark.parametrize("frame", sorted(LEVELS))
def test_blur_kernel_matches_plain_on_the_pyramid_levels(dev, frame):
    for hw in LEVELS[frame]:
        for kind in ("noise", "scene"):
            _check_on_card(_image(hw, kind, seed=5), dev, f"{hw} {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("hw", SMALL)
def test_blur_kernel_matches_plain_on_odd_shapes_and_extremes(dev, hw):
    for kind in KINDS:
        _check_on_card(_image(hw, kind), dev, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 8])
def test_blur_kernel_on_rows_that_start_unaligned(dev, offset):
    """A source view `offset` bytes past an aligned allocation: the staged
    words come from the aligned words around them, and the level's first
    and last bytes from the byte path."""
    for hw in ((300, 512), (97, 333)):
        img = torch.from_numpy(_image(hw, "noise", seed=offset)).to(dev)
        n = hw[0] * hw[1]
        flat = torch.zeros(n + 16, dtype=torch.uint8, device=dev)
        src = flat[offset:offset + n].view(hw)
        src.copy_(img)
        assert src.is_contiguous() and src.data_ptr() % 16 == offset
        assert torch.equal(TI.gaussian_blur7_u8_kernel(src),
                           TI.gaussian_blur7_u8(img))


@pytest.mark.cuda
def test_blur_kernel_on_a_band(dev):
    """A band's window as `sharding._band_descriptors` takes it: the band
    of rows with DESC_HALO rows each side, global REFLECT_101 rows at the
    level's edges; the kernel's blur of it equals the plain version's, and
    its middle rows equal the whole level's blur."""
    hs, ws = 723, 1286
    level = torch.from_numpy(_image((hs, ws), "scene", seed=9)).to(dev)
    whole = TI.gaussian_blur7_u8(level)
    n = 4
    b = -(-hs // n)
    for i in range(n):
        g = torch.arange(b + 2 * SH.DESC_HALO, device=dev) \
            - SH.DESC_HALO + i * b
        refl = g.abs()
        refl = torch.where(refl >= hs, 2 * (hs - 1) - refl, refl)
        ext = level.index_select(0, refl.clamp(0, hs - 1))
        got = TI.gaussian_blur7_u8_kernel(ext)
        assert torch.equal(got, TI.gaussian_blur7_u8(ext))
        lo, hi = i * b, min((i + 1) * b, hs)
        top = SH.DESC_HALO
        assert torch.equal(got[top:top + hi - lo], whole[lo:hi])


@pytest.mark.cuda
def test_the_kernel_wrapper_refuses_on_the_card(dev):
    with pytest.raises(ValueError, match="uint8"):
        TI.gaussian_blur7_u8_kernel(torch.zeros((8, 8), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        TI.gaussian_blur7_u8_kernel(
            torch.zeros((8, 16), dtype=torch.uint8, device=dev).t())


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [(376, 1241), (2160, 3840)])
def test_one_detect_and_compute_blurs_each_level_once(dev, frame):
    """One eager `detect_and_compute` core launches K14 once a described
    level, 8 at these configurations; `detect` launches none."""
    img = torch.from_numpy(make_test_image(*frame, seed=31))
    ef = EfficientFeatures(nfeatures=2000, descriptor_type="bad_256",
                           device="cuda")
    before = TI.gaussian_blur7_u8_kernel.launches
    G.run_eager(img, ef._cfg, device=dev)
    assert TI.gaussian_blur7_u8_kernel.launches == before + 8
    G.run_eager(img, ef._cfg, with_descriptors=False, device=dev)
    assert TI.gaussian_blur7_u8_kernel.launches == before + 8
