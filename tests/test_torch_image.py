"""Image ops of the PyTorch port against `efficient_features_tpu.ops.image`.

Resize, pyramid, blur and integral are integer arithmetic in both packages, so
the tolerance is zero: every output must be bit-identical.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from efficient_features_tpu.ops import image as JI
from efficient_features_tpu_torch.ops import image as TI

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


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((200, 280), (167, 233)), ((97, 131), (81, 109)), ((64, 64), (53, 53)),
    ((30, 41), (25, 34)), ((40, 50), (80, 100))])
def test_resize_bit_exact(src_hw, dst_hw):
    img = make_test_image(*src_hw, seed=sum(src_hw))
    want = np.asarray(JI.resize_u8(jnp.asarray(img), dst_hw))
    got = TI.resize_u8(_t(img), dst_hw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == dst_hw
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale_factor,nlevels", [(1.2, 8), (1.5, 4)])
def test_pyramid_bit_exact(scale_factor, nlevels):
    img = make_test_image(200, 280, seed=5)
    want = JI.build_pyramid(jnp.asarray(img), scale_factor, nlevels, False)
    got = TI.build_pyramid(_t(img), scale_factor, nlevels)
    assert len(got) == len(want) == nlevels
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _image(hw, seed):
    """Synthetic scene, or noise where the scene generator needs more room."""
    if min(hw) > 16:
        return make_test_image(*hw, seed=seed)
    return np.random.default_rng(seed).integers(0, 256, hw, dtype=np.uint8)


@pytest.mark.parametrize("hw", [(200, 280), (31, 17), (8, 9), (4, 5)])
def test_gaussian_blur_bit_exact(hw):
    img = _image(hw, hw[0])
    want = np.asarray(JI.gaussian_blur7_u8(jnp.asarray(img)))
    got = TI.gaussian_blur7_u8(_t(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_blur_hard_edges():
    img = np.zeros((40, 48), np.uint8)
    img[:, 24:] = 255
    img[10:20, 5:9] = 255
    want = np.asarray(JI.gaussian_blur7_u8(jnp.asarray(img)))
    np.testing.assert_array_equal(TI.gaussian_blur7_u8(_t(img)).numpy(), want)


@pytest.mark.parametrize("hw", [(200, 280), (1, 1), (3, 700)])
def test_integral_bit_exact(hw):
    img = _image(hw, 3)
    want = np.asarray(JI.integral_image_i32(jnp.asarray(img)))
    got = TI.integral_image_i32(_t(img))
    assert got.dtype == torch.int32 and tuple(got.shape) == (hw[0] + 1,
                                                             hw[1] + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_integral_wraps_like_int32():
    """Past 2^31 the int32 integral wraps in both packages (255 * 2900 *
    2910 > 2^31); box sums of differences stay exact modulo 2^32."""
    img = np.full((2900, 2910), 255, np.uint8)
    want = np.asarray(JI.integral_image_i32(jnp.asarray(img)))
    got = TI.integral_image_i32(_t(img)).numpy()
    assert want[-1, -1] < 0          # wrapped
    np.testing.assert_array_equal(got, want)
    box = (int(got[-1, -1]) - int(got[-1, 1]) - int(got[1, -1])
           + int(got[1, 1])) % (1 << 32)
    assert box == 255 * 2899 * 2909
