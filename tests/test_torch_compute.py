"""The port's standalone compute() (BAD, HashSIFT, EfficientFeatures) against
the JAX API, on the CPU.

Every input form of the JAX API: detect output (`KeyPoints`, slot-aligned
rows from compute_async, compacted by compute), a host (N, 4) array with
mixed sizes 31-300 px in shuffled order (rows in the caller's order), a
list of keypoint-likes, an (N, 4) tensor, and N = 0; at scale 1.0 and 1.5.
Budgets of differing descriptor bytes: int(1e-4 * bytes) + 1 for HashSIFT,
int(2e-5 * bytes) + 1 for BAD (the reference's budgets).  The same
ValueErrors as the JAX API.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from efficient_features_tpu import BAD as JBAD
from efficient_features_tpu import EfficientFeatures as JEF
from efficient_features_tpu import HashSIFT as JHS
from efficient_features_tpu_torch import BAD as TBAD
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch import HashSIFT as THS

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

H, W = 200, 280
CLASSES = {"bad": (JBAD, TBAD, 2e-5), "hash_sift": (JHS, THS, 1e-4)}


def _budget(share: float, n_bytes: int) -> int:
    return int(share * n_bytes) + 1


@pytest.fixture(scope="module")
def scene():
    return make_test_image(H, W, seed=21)


@pytest.fixture(scope="module")
def detected(scene):
    """(JAX KeyPoints, port KeyPoints) of the scene, default pyramid."""
    j = JEF(nfeatures=400, descriptor_type="bad_256").detect(scene)
    t = TEF(nfeatures=400, descriptor_type="bad_256", device="cpu").detect(
        scene)
    for k in ("x", "y", "size", "valid"):
        np.testing.assert_array_equal(t._slots[k].numpy(),
                                      np.asarray(j._slots[k]))
    return j, t


def mixed_keypoints(n, seed):
    """(N, 4) [x, y, size, angle], sizes 31-300 px, shuffled: corners and
    edges, angle -1 on every fifth keypoint."""
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n),
                   rng.uniform(31.0, 300.0, n), rng.uniform(0, 360, n)],
                  axis=1).astype(np.float32)
    kp[:4, :2] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W / 2, 0.5]]
    kp[:6, 2] = [31.0, 44.64, 64.0, 111.0, 192.5, 300.0]
    kp[::5, 3] = -1.0
    return kp[rng.permutation(n)]


@pytest.mark.parametrize("kind,nbits,scale", [
    ("bad", 256, 1.0), ("bad", 512, 1.5),
    ("hash_sift", 256, 1.0), ("hash_sift", 512, 1.5)])
def test_compute_matches_jax(scene, detected, kind, nbits, scale):
    jcls, tcls, share = CLASSES[kind]
    jd, td = jcls(scale, nbits), tcls(scale, nbits, device="cpu")
    nbytes = nbits // 8
    assert td.descriptor_size() == jd.descriptor_size() == nbytes
    assert td.default_norm() == jd.default_norm()
    assert td.descriptor_type() == jd.descriptor_type()

    # detect output: slot-aligned rows, zero rows for invalid slots
    jkps, tkps = detected
    want = jd.compute(scene, jkps)
    got = td.compute(scene, tkps)
    assert got.shape == want.shape == (tkps.count, nbytes)
    assert (got != want).sum() <= _budget(share, want.size)
    rows = td.compute_async(scene, tkps)
    valid = tkps._slots["valid"]
    assert tuple(rows.shape) == (tkps.capacity, nbytes)
    assert (rows[~valid] == 0).all()
    assert np.array_equal(rows[valid].numpy(), got)

    # host (N, 4) array with mixed sizes: rows in the caller's order
    kp = mixed_keypoints(64, seed=nbits)
    want = jd.compute(scene, kp)
    got = td.compute(scene, kp)
    assert got.shape == want.shape == (64, nbytes)
    assert (got != want).sum() <= _budget(share, want.size)
    # ... each row is the keypoint's own: describing one at a time agrees
    for i in (0, 17, 63):
        one = td.compute(scene, kp[i:i + 1])
        assert np.array_equal(one[0], got[i])

    # a list of keypoint-likes and an (N, 4) tensor give the same rows
    kps = [SimpleNamespace(pt=(float(a), float(b)), size=float(s),
                           angle=float(g)) for a, b, s, g in kp]
    assert np.array_equal(td.compute(scene, kps), got)
    assert np.array_equal(jd.compute(scene, kps), want)
    t = td.compute_async(scene, torch.from_numpy(kp))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    assert np.array_equal(t.numpy(), got)


@pytest.mark.parametrize("kind", ["bad", "hash_sift"])
def test_compute_with_no_keypoints(scene, kind):
    jcls, tcls, _ = CLASSES[kind]
    td = tcls(1.0, 256, device="cpu")
    for empty in (np.zeros((0, 4), np.float32), [],
                  torch.zeros((0, 4))):
        got = td.compute(scene, empty)
        assert got.shape == (0, 32) and got.dtype == np.uint8
    want = jcls(1.0, 256).compute(scene, np.zeros((0, 4), np.float32))
    assert want.shape == (0, 32)


@pytest.mark.parametrize("descriptor_type", ["bad_256", "hash_sift_512"])
def test_efficient_features_compute_matches_jax(scene, detected,
                                                descriptor_type):
    jef = JEF(nfeatures=400, descriptor_type=descriptor_type)
    tef = TEF(nfeatures=400, descriptor_type=descriptor_type, device="cpu")
    share = 2e-5 if descriptor_type.startswith("bad") else 1e-4
    jkps, tkps = detected
    kp = mixed_keypoints(32, seed=5)
    for jin, tin in ((jkps, tkps), (kp, kp)):
        want = jef.compute(scene, jin)
        got = tef.compute(scene, tin)
        assert got.shape == want.shape
        assert (got != want).sum() <= _budget(share, want.size)
    # EfficientFeatures.compute is its describer's compute
    kind, bits = descriptor_type.rsplit("_", 1)
    cls = TBAD if kind == "bad" else THS
    assert torch.equal(tef.compute_async(scene, tkps),
                       cls(1.0, int(bits), device="cpu").compute_async(
                           scene, tkps))


def test_compute_errors_match_jax(scene):
    for jc, tc, nbits in ((JBAD, TBAD, 128), (JHS, THS, 1024)):
        with pytest.raises(ValueError) as jerr:
            jc(1.0, nbits)
        with pytest.raises(ValueError) as terr:
            tc(1.0, nbits, device="cpu")
        assert str(terr.value) == str(jerr.value)
    jd, td = JHS(), THS(device="cpu")
    for bad_kp in (np.zeros((3, 3), np.float32), np.zeros(4, np.float32)):
        with pytest.raises(ValueError) as jerr:
            jd.compute(scene, bad_kp)
        with pytest.raises(ValueError) as terr:
            td.compute(scene, bad_kp)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match=r"device keypoints must be \(N, 4\)"):
        td.compute(scene, torch.zeros((3, 5)))
    for bad_img in (np.zeros((64, 64), np.float32),
                    np.zeros((8, 8, 3), np.uint8)):
        with pytest.raises(ValueError) as jerr:
            jd.compute(bad_img, np.zeros((1, 4), np.float32))
        with pytest.raises(ValueError) as terr:
            td.compute(bad_img, np.zeros((1, 4), np.float32))
        assert str(terr.value) == str(jerr.value)
    # sigma is accepted and has no effect
    kp = mixed_keypoints(8, seed=1)
    assert np.array_equal(THS(1.0, 256, sigma=1.6, device="cpu").compute(
        scene, kp), td.compute(scene, kp))
    assert isinstance(TBAD.create(device="cpu"), TBAD)
    assert isinstance(THS.create(device="cpu"), THS)


def test_descriptor_classes_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TBAD, THS):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (7, 1)])
def test_hash_sift_on_a_one_pixel_image_matches_jax(hw, fused):
    """A 1x1 (and 1xN, Nx1) image: no sample's 2x2 support fits, and the
    plain warp's 2-D index reads the image's only row or column as JAX's
    does, where its flat gather once indexed out of range.  Two-stage and
    fused give JAX's rows."""
    img = np.full(hw, 100, np.uint8)
    kp = np.array([[0, 0, 31, 0], [0.5, 0.25, 64, -1]], np.float32)
    got = THS(device="cpu", fused=fused).compute(img, kp)
    want = np.asarray(JHS().compute(img, kp))
    assert got.shape == (2, 32)
    np.testing.assert_array_equal(got, want)
