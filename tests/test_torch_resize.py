"""The port's resize (the plain version of the kernel K10) against the JAX
package's tiled resize kernel.

`resize_u8_pallas` runs in Pallas interpret mode, as `tests/test_image.py`
runs it on the CPU.  The resize is 11-bit fixed-point integer arithmetic in
both packages, so the tolerance is zero: every output is bit-identical.  On
the CPU `resize_u8_fast` takes the plain `resize_u8`; the compiled kernel is
held against it on a card in `tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import image as JI
from efficient_features_tpu_torch.ops import image as TI
from efficient_features_tpu_torch.utils import semantics as TS

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


# a pyramid step, a tiny level, an upscale, odd sizes with ragged tiles
CASES = [((200, 300), (167, 250)), ((200, 300), (16, 20)),
         ((60, 90), (97, 151)), ((131, 203), (109, 169))]


@pytest.mark.parametrize("src_hw,dst_hw", CASES)
def test_resize_matches_the_pallas_kernel(src_hw, dst_hw):
    img = make_test_image(*src_hw, seed=sum(src_hw))
    kernel = np.asarray(JI.resize_u8_pallas(jnp.asarray(img), dst_hw))
    xla = np.asarray(JI.resize_u8(jnp.asarray(img), dst_hw))
    np.testing.assert_array_equal(kernel, xla)
    before = TI.resize_u8_kernel.launches
    for fn in (TI.resize_u8, TI.resize_u8_fast):
        got = fn(_t(img), dst_hw)
        assert got.dtype == torch.uint8 and tuple(got.shape) == dst_hw
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), kernel)
    assert TI.resize_u8_kernel.launches == before      # no kernel on the CPU


@pytest.mark.parametrize("kind", ["noise", "all-255", "edges"])
def test_resize_extremes_match_jax(kind):
    """Noise, the largest accumulator (255 * 2048 * 2048 must come back as
    255) and hard 0/255 edges."""
    if kind == "noise":
        img = np.random.default_rng(4).integers(0, 256, (90, 123),
                                                dtype=np.uint8)
    elif kind == "all-255":
        img = np.full((90, 123), 255, np.uint8)
    else:
        img = np.zeros((90, 123), np.uint8)
        img[:, 61:] = 255
        img[20:50, 10:40] = 255
    dst = (75, 103)
    got = TI.resize_u8_fast(_t(img), dst).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JI.resize_u8(jnp.asarray(img), dst)))
    if kind == "all-255":
        assert (got == 255).all()


@pytest.mark.parametrize("src_hw,dst_hw", CASES + [((9, 10), (8, 8)),
                                                   ((50, 70), (41, 59))])
def test_kernel_formula_from_the_int32_tables(src_hw, dst_hw):
    """What K10 evaluates per destination pixel, in numpy int32 from the
    packed tables the wrapper hands it (`resize_table`, unpacked as the
    kernel unpacks them: to `semantics.resize_axis_coeffs`), over its tiles
    (`resize_plan`): equal to `resize_u8`."""
    img = np.random.default_rng(sum(dst_hw)).integers(0, 256, src_hw,
                                                      dtype=np.uint8)
    (h, w), (sh, sw) = dst_hw, src_hw
    for d, s in ((h, sh), (w, sw)):
        t = TI.resize_table(d, s)
        assert t.dtype == np.uint32 and t.shape == (d,)
        i0, i1, w1 = _unpack(t)
        for got, want in zip((i0, i1, w1), TS.resize_axis_coeffs(d, s)):
            np.testing.assert_array_equal(got, want)
        assert 0 <= i0.min() and i1.max() < s and set(i1 - i0) <= {0, 1}
        assert 0 <= w1.min() and w1.max() <= 2048
    out = _walk_the_plan(img, dst_hw)
    np.testing.assert_array_equal(out, TI.resize_u8(_t(img), dst_hw).numpy())


def _unpack(table: np.ndarray):
    """(i0, i1, w1) int32 of a packed `resize_table`, as K10 unpacks it."""
    t = np.asarray(table, np.uint32)
    i0 = t & ((1 << TI.RESIZE_INDEX_BITS) - 1)
    return (i0.astype(np.int32),
            (i0 + ((t >> TI.RESIZE_INDEX_BITS) & 1)).astype(np.int32),
            (t >> (TI.RESIZE_INDEX_BITS + 1)).astype(np.int32))


def _walk_the_plan(img: np.ndarray, dst_hw, band: int = 512) -> np.ndarray:
    """K10 as its blocks compute it, in numpy int32.  A destination row
    whose first byte lies m bytes past a word boundary (y * w % 4 = m for
    an aligned output) has its words start at column -m, so its column c
    belongs to tile (c + m) // RESIZE_TILE_W: every tap of every pixel must
    lie in that tile's staged columns and in its tile row's staged rows.
    The pixels take their table entries unpacked from `resize_table`.
    Bands of `band` destination rows keep the arrays small."""
    (h, w), (sh, sw) = dst_hw, img.shape
    th, tw = TI.RESIZE_TILE_H, TI.RESIZE_TILE_W
    plan = TI.resize_plan(dst_hw, img.shape)
    y0t, y1t, wyt = _unpack(TI.resize_table(h, sh))
    x0t, x1t, wxt = _unpack(TI.resize_table(w, sw))
    # the tiles that stage are exactly those whose rows fit the budget at
    # the widest a row's chunks can lie (an offset of 15 bytes)
    assert plan.staged.shape == (-(-h // th), -(-(w + 3) // tw))
    widest = 16 * -(-(plan.span + 15) // 16)
    assert (plan.stride == widest).all()
    np.testing.assert_array_equal(
        plan.staged, plan.rows * widest <= TI.RESIZE_STAGE_BYTES)
    # rows: each destination row's taps in its tile row's staged rows
    ty = np.arange(h) // th
    first, rows = plan.y0[ty, 0], plan.rows[ty, 0]
    assert ((first <= y0t) & (y1t < first + rows)).all()
    # columns: for each misalignment, each column's taps in its tile's
    c = np.arange(w)
    for m in range(4):
        tx = (c + m) // tw
        lo, hi = plan.c_lo[0, tx], plan.c_hi[0, tx]
        x0, span = plan.x0[0, tx], plan.span[0, tx]
        assert ((lo <= c) & (c < hi)).all()
        assert ((x0 <= x0t) & (x1t < x0 + span)).all()
    src = img.astype(np.int32)
    one = np.int32(2048)
    out = np.empty((h, w), np.uint8)
    wx = wxt[None, :]
    for b in range(0, h, band):
        y = slice(b, min(b + band, h))
        r0, r1, wy = src[y0t[y]], src[y1t[y]], wyt[y][:, None]
        top = r0[:, x0t] * (one - wx) + r0[:, x1t] * wx
        bot = r1[:, x0t] * (one - wx) + r1[:, x1t] * wx
        acc = top * (one - wy) + bot * wy
        assert acc.dtype == np.int32 and acc.min() >= 0
        out[y] = (acc + np.int32(1 << 21)) >> 22
    return out


def _pyramid_steps(hw, scale):
    return list(zip(TS.pyramid_shapes(*hw, scale, 8)[:-1],
                    TS.pyramid_shapes(*hw, scale, 8)[1:]))


# FHD, 4K and 8K pyramids at the scale factors 1.2 and 2.0; an upscale, a
# 16x20 and an 8x8 level of the 4K pyramid's smallest; and downscales by 3
# and 4, where tiles read the image directly
PLAN_CASES = {f"{name}-{scale}": _pyramid_steps(hw, scale)
              for name, hw in (("fhd", (1080, 1920)), ("4k", (2160, 3840)),
                               ("8k", (4320, 7680)))
              for scale in (1.2, 2.0)}
PLAN_CASES["odd"] = [((603, 1072), (1042, 1852)), ((603, 1072), (16, 20)),
                     ((603, 1072), (8, 8)), ((2160, 3840), (720, 1280)),
                     ((2160, 3840), (540, 960)), ((2159, 3837), (1799, 3198))]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_a_walk_of_the_resize_plan_matches_resize_u8(case):
    """`resize_plan` holds every tap of every destination pixel inside its
    tile's staged rows and columns, the tiles that read the image directly
    are exactly those over the budget, and K10's walk of the plan equals
    `resize_u8` (each pyramid level from the one before, as
    `build_pyramid` makes it)."""
    steps = PLAN_CASES[case]
    rng = np.random.default_rng(len(case))
    src = rng.integers(0, 256, steps[0][0], dtype=np.uint8)
    for src_hw, dst_hw in steps:
        if src.shape != src_hw:
            src = rng.integers(0, 256, src_hw, dtype=np.uint8)
        want = TI.resize_u8(_t(src), dst_hw).numpy()
        np.testing.assert_array_equal(_walk_the_plan(src, dst_hw), want)
        staged = TI.resize_plan(dst_hw, src_hw).staged
        if case != "odd":       # a pyramid step always stages
            assert staged.all(), (src_hw, dst_hw)
        src = want
    if case == "odd":           # both branches, and a tile of each in one
        plans = [TI.resize_plan(d, s).staged for s, d in steps]
        assert plans[0].all() and not plans[2].any()
        assert plans[3].any() and not plans[3].all()


def test_resize_table_refuses_a_side_beyond_its_index_bits():
    TI.resize_table(8, 1 << TI.RESIZE_INDEX_BITS)
    with pytest.raises(ValueError, match="source pixels"):
        TI.resize_table(8, (1 << TI.RESIZE_INDEX_BITS) + 1)


def test_pyramid_goes_through_resize_u8_fast(monkeypatch):
    """`build_pyramid` resizes through `resize_u8_fast` (so a CUDA image
    takes K10), level s from level s - 1, and equals the JAX pyramid."""
    img = make_test_image(120, 168, seed=2)
    calls = []
    real = TI.resize_u8_fast
    monkeypatch.setattr(TI, "resize_u8_fast",
                        lambda s, hw: calls.append(hw) or real(s, hw))
    got = TI.build_pyramid(_t(img), 1.2, 6)
    assert calls == TS.pyramid_shapes(120, 168, 1.2, 6)[1:]
    want = JI.build_pyramid(jnp.asarray(img), 1.2, 6, False)
    for a, b in zip(got, want):
        assert a.is_contiguous() and a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_wrapper_takes_no_cpu_tensor():
    """The kernel wrapper launches or raises; it never runs the plain
    version in the kernel's place."""
    img = _t(make_test_image(40, 50, seed=1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        TI.resize_u8_kernel(img, (33, 42))
