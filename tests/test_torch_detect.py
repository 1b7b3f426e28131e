"""Detection ops of the PyTorch port against `efficient_features_tpu.ops.detect`.

FAST, Harris, NMS and top-k selection are exact in both packages (integers,
or float math whose products are exact), so the tolerance is zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import detect as JD
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import detect_kernels as TDK
from efficient_features_tpu_torch.tools.oncard import tie_image

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


def _border(h, w, b=15):
    m = np.zeros((h, w), bool)
    m[b:h - b, b:w - b] = True
    return m


@pytest.fixture(scope="module")
def scene():
    return make_test_image(203, 285, seed=21)


@pytest.mark.parametrize("threshold", [10, 20, 40])
def test_fast_corner_mask_bit_exact(scene, threshold):
    want = np.asarray(JD.fast_corner_mask(jnp.asarray(scene), threshold))
    got = TD.fast_corner_mask(_t(scene), threshold).numpy()
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(6, 9), (7, 7), (12, 10)])
def test_fast_corner_mask_tiny(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw, dtype=np.uint8)
    want = np.asarray(JD.fast_corner_mask(jnp.asarray(img), 20))
    np.testing.assert_array_equal(TD.fast_corner_mask(_t(img), 20).numpy(),
                                  want)


def test_harris_response_bit_exact(scene):
    want = np.asarray(JD.harris_response(jnp.asarray(scene)))
    got = TD.harris_response(_t(scene))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_harris_response_saturated_edges():
    img = np.zeros((64, 80), np.uint8)
    img[:, 40:] = 255
    img[10:30, 10:30] = 255
    want = np.asarray(JD.harris_response(jnp.asarray(img)))
    np.testing.assert_array_equal(TD.harris_response(_t(img)).numpy(), want)


@pytest.mark.parametrize("radius", [1, 3, 7, 10, 15])
def test_radius_nms_bit_exact(scene, radius):
    h, w = scene.shape
    corner = np.asarray(JD.fast_corner_mask(jnp.asarray(scene), 20)) \
        & _border(h, w)
    resp = np.asarray(JD.harris_response(jnp.asarray(scene)))
    want = np.asarray(JD.radius_nms(jnp.asarray(resp), jnp.asarray(corner),
                                    radius))
    got = TD.radius_nms(_t(resp), _t(corner), radius).numpy()
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def _check_slots(got, want):
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)


@pytest.mark.parametrize("quota", [1, 50, 300, 2000])
def test_select_topk_bit_exact(scene, quota):
    h, w = scene.shape
    corner = np.asarray(JD.fast_corner_mask(jnp.asarray(scene), 20)) \
        & _border(h, w)
    resp = np.asarray(JD.harris_response(jnp.asarray(scene)))
    surv = np.asarray(JD.radius_nms(jnp.asarray(resp), jnp.asarray(corner),
                                    15))
    want = JD.select_topk(jnp.asarray(resp), jnp.asarray(surv), quota,
                          nms_radius=15)
    _check_slots(TD.select_topk(_t(resp), _t(surv), quota), want)


def test_select_topk_ties_and_negative_zero():
    """Equal responses order by flat index, and -0.0 ties +0.0: the cases
    where an unstable `torch.topk` or a total-order sort would differ."""
    rng = np.random.default_rng(5)
    resp = rng.choice(np.array([1.0, 0.5, 0.0, -0.0, -2.0], np.float32),
                      size=(24, 40))
    resp[0, :6] = [1, 0, 1, -0.0, 0.5, 1]
    surv = rng.random((24, 40)) < 0.7
    for quota in (3, 100, 960):
        want = JD.select_topk(jnp.asarray(resp), jnp.asarray(surv), quota)
        got = TD.select_topk(_t(resp), _t(surv), quota)
        _check_slots(got, want)
        assert not bool(((got[2] == 0) & torch.signbit(got[2])).any())


def _jax_cells_selection(cells, img, quota, radius=15):
    h, w = img.shape
    corner = JD.fast_corner_mask(jnp.asarray(img), 20) & \
        jnp.asarray(_border(h, w))
    resp = JD.harris_response(jnp.asarray(img))
    resp = jnp.where(resp == 0, jnp.float32(0.0), resp)
    surv = JD.radius_nms(resp, corner, radius)
    masked = jnp.where(surv, resp, jnp.float32(-jnp.inf))

    def dense_fallback(_=None):
        return jax.lax.top_k(masked.reshape(-1), min(quota, h * w))

    return JD.select_topk_cells(*(jnp.asarray(c.numpy()) for c in cells),
                                h, w, quota, dense_fallback)


@pytest.mark.parametrize("which,quota", [
    ("scene", 40), ("scene", 300), ("scene", 100000), ("tie", 64)])
def test_select_topk_cells_bit_exact(scene, which, quota):
    """The port selects from the cells and their survivor bitmap, with no
    fallback; JAX takes its dense fallback where a block ties."""
    img = scene if which == "scene" else tie_image()
    h, w = img.shape
    cm, cr, cc, cb = TDK.fast_harris_nms_cells(_t(img), 20, 15)
    want = _jax_cells_selection((cm, cr, cc), img, quota)
    got = TD.select_topk_cells(cm, cr, cb, h, w, quota)
    _check_slots(got, want)
    # every survivor fits these quotas: all are selected, tied ones too
    assert int(got[3].sum()) == min(quota, int(cc.sum())) > 0
    blocks = torch.nn.functional.pad(cc, (0, -w % 8)).reshape(
        cc.shape[0], -1, 8).sum(dim=2)
    assert (int(blocks.max()) > 1) == (which == "tie")
