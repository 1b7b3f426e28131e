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
    tables the wrapper hands it (`_resize_tables_i32`), over the flattened
    destination as the kernel walks it: equal to `resize_u8`."""
    img = np.random.default_rng(sum(dst_hw)).integers(0, 256, src_hw,
                                                      dtype=np.uint8)
    (h, w), (sh, sw) = dst_hw, src_hw
    ty = TI._resize_tables_i32(h, sh, torch.device("cpu"))
    tx = TI._resize_tables_i32(w, sw, torch.device("cpu"))
    assert ty.dtype == tx.dtype == torch.int32 and ty.is_contiguous()
    assert tuple(ty.shape) == (3, h) and tuple(tx.shape) == (3, w)
    for t, (d, s) in ((ty, (h, sh)), (tx, (w, sw))):
        for row, want in zip(t.numpy(), TS.resize_axis_coeffs(d, s)):
            np.testing.assert_array_equal(row, want)
        assert 0 <= int(t[:2].min()) and int(t[:2].max()) < s
        assert 0 <= int(t[2].min()) and int(t[2].max()) <= 2048
    (y0, y1, wy), (x0, x1, wx) = ty.numpy(), tx.numpy()
    i = np.arange(h * w)
    y, x = i // w, i % w
    src = img.astype(np.int32)
    one = np.int32(2048)
    top = src[y0[y], x0[x]] * (one - wx[x]) + src[y0[y], x1[x]] * wx[x]
    bot = src[y1[y], x0[x]] * (one - wx[x]) + src[y1[y], x1[x]] * wx[x]
    acc = top * (one - wy[y]) + bot * wy[y]
    assert acc.dtype == np.int32 and acc.min() >= 0
    out = ((acc + np.int32(1 << 21)) >> 22).astype(np.uint8).reshape(h, w)
    np.testing.assert_array_equal(out, TI.resize_u8(_t(img), dst_hw).numpy())


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
