"""The port's detect_and_compute slice (BAD and HashSIFT) against the JAX
pipeline.

Same image, same configuration, on the CPU.  Tolerances: keypoint slots (x,
y, octave, size, response, valid, count) bit-exact, because selection is
exact integer math in both packages; angles within 1e-3 degrees (f32 atan2
ULPs); descriptors within the reference's budgets of int(2e-5 * bytes) + 1
(BAD) and int(1e-4 * bytes) + 1 (HashSIFT) differing bytes.  Also the API
surface: the same ValueErrors as the JAX API, TypeError for a `mesh=`
that is not a mesh, and no silent CPU run when CUDA was asked for.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from efficient_features_tpu import EfficientFeatures as JEF
from efficient_features_tpu import pipeline as JP
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch import pipeline as TP

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

EXACT = ("x", "y", "octave", "size", "response", "valid", "count")


def _budget(n_bytes: int, descriptor_type: str = "bad_256") -> int:
    share = 2e-5 if descriptor_type.startswith("bad") else 1e-4
    return int(share * n_bytes) + 1


@pytest.fixture(scope="module")
def scene():
    return make_test_image(200, 280, seed=7)


def _check_slots(got: dict, want: dict):
    assert set(got) == set(want)
    for k in EXACT:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    d = np.abs(got["angle"].numpy() - np.asarray(want["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3


@pytest.mark.parametrize("descriptor_type", ["bad_256", "bad_512",
                                             "hash_sift_256", "hash_sift_512"])
def test_detect_and_compute_matches_jax(scene, descriptor_type):
    jef = JEF(nfeatures=500, descriptor_type=descriptor_type)
    tef = TEF(nfeatures=500, descriptor_type=descriptor_type, device="cpu")
    jkps, jdesc = jef.detect_and_compute_async(scene)
    tkps, tdesc = tef.detect_and_compute_async(scene)
    _check_slots(tkps._slots, jkps._slots)
    assert 100 < tkps.count < tkps.capacity == 500
    jdesc = np.asarray(jdesc)
    assert tdesc.numpy().shape == jdesc.shape == (500, tef.descriptor_size())
    assert (tdesc.numpy() != jdesc).sum() <= _budget(jdesc.size,
                                                     descriptor_type)
    assert (tdesc.numpy()[~tkps._slots["valid"].numpy()] == 0).all()
    # the pipeline function is the same computation as the API
    slots, desc = TP.detect_and_compute(torch.from_numpy(scene),
                                        tef._cfg)
    assert torch.equal(desc, tdesc)
    # compacted host views agree with the JAX API's
    _, jd = jef.detect_and_compute(scene)
    tk, td = tef.detect_and_compute(scene)
    assert td.shape == jd.shape
    assert (td != jd).sum() <= _budget(jd.size, descriptor_type)
    ja, ta = jkps.as_arrays(), tk.as_arrays()
    for k in ("x", "y", "octave", "size", "response"):
        np.testing.assert_array_equal(ta[k], ja[k])
    np.testing.assert_allclose(tk.xysa()[:, :3], jkps.xysa()[:, :3], rtol=0)
    assert len(tef.convert(tk)) == tk.count


def test_detect_small_radius_and_tiny_levels_match_jax():
    """nonmax_radius < 10 takes the fast_harris_nms route (its plain
    version on the CPU), and levels under 31 px get no keypoints, as in the
    JAX pipeline."""
    img = make_test_image(120, 160, seed=3)
    cfg = dict(nfeatures=300, nonmax_radius=5, nlevels=6,
               scale_factor=1.5)
    want = JP.detect_jit(jnp.asarray(img), JP.FeatureConfig(**cfg))
    got = TP.detect(torch.from_numpy(img), TP.FeatureConfig(**cfg))
    _check_slots(got, want)
    tkps = TEF(device="cpu", **cfg).detect(img)
    assert torch.equal(tkps._slots["x"], got["x"])
    assert tkps.count == int(want["count"]) > 0


def _same_static(port, ref) -> None:
    """`KeyPoints.max_size` and `.level_ranges`: static properties of the
    configuration and the image shape, equal to the JAX `KeyPoints`' (no
    tolerance: floats from the same expressions, integers)."""
    assert isinstance(port.max_size, float)
    assert port.max_size == ref.max_size
    assert isinstance(port.level_ranges, tuple)
    assert port.level_ranges == ref.level_ranges
    assert port.level_ranges[-1][1] == port.capacity


@pytest.mark.parametrize("entry", ["detect", "detect_and_compute"])
def test_keypoints_static_properties_match_jax(scene, entry):
    if entry == "detect":          # the configuration of the test above
        img = make_test_image(120, 160, seed=3)
        cfg = dict(nfeatures=300, nonmax_radius=5, nlevels=6,
                   scale_factor=1.5)
        port = TEF(device="cpu", **cfg).detect(img)
        ref = JEF(**cfg).detect(img)
        assert port.max_size == pytest.approx(31 * 1.5 ** 5)
    else:
        cfg = dict(nfeatures=500, descriptor_type="bad_256")
        port = TEF(device="cpu", **cfg).detect_and_compute(scene)[0]
        ref = JEF(**cfg).detect_and_compute(scene)[0]
        assert port.max_size == pytest.approx(31 * 1.2 ** 7)
    _same_static(port, ref)
    assert len(port.level_ranges) == cfg.get("nlevels", 8)


@pytest.mark.parametrize("scale_factor,nlevels,first_level",
                         [(1.2, 8, 0), (1.5, 4, 1), (1.1, 2, 0)])
def test_keypoints_static_properties_follow_the_configuration(
        scene, scale_factor, nlevels, first_level):
    """No detection on the JAX side: its `KeyPoints` takes the same two
    values from `pipeline.level_slot_ranges` and the configuration."""
    kw = dict(nfeatures=200, scale_factor=scale_factor, nlevels=nlevels,
              first_level=first_level, descriptor_type="bad_256")
    roi = np.full(scene.shape, 255, np.uint8)
    for port in (TEF(device="cpu", **kw).detect(scene),
                 TEF(device="cpu", **kw).detect(scene, mask=roi)):
        assert port.level_ranges == JP.level_slot_ranges(
            JP.FeatureConfig(**kw), *scene.shape)
        assert port.max_size == JEF(**kw)._max_kp_size()
        assert len(port.level_ranges) == nlevels - first_level


def test_user_keypoints_have_no_static_properties(scene):
    from efficient_features_tpu_torch.api import KeyPoints
    tef = TEF(nfeatures=200, descriptor_type="bad_256", device="cpu")
    kps = tef.detect(scene)
    user = KeyPoints(dict(kps._slots))
    assert user.max_size is None and user.level_ranges is None
    # compute() takes either and gives the same rows
    np.testing.assert_array_equal(tef.compute(scene, user),
                                  tef.compute(scene, kps))


BAD_CONFIGS = [
    dict(nfeatures=0), dict(nlevels=0), dict(scale_factor=1.0),
    dict(first_level=8), dict(first_level=-1), dict(fast_threshold=0),
    dict(nonmax_radius=0), dict(descriptor_type="orb")]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS)
def test_config_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        JP.FeatureConfig(**kwargs)
    with pytest.raises(ValueError) as terr:
        TP.FeatureConfig(**kwargs)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        TEF(device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)


def test_image_errors_match_jax():
    jef = JEF(descriptor_type="bad_256")
    tef = TEF(descriptor_type="bad_256", device="cpu")
    for bad in (np.zeros((64, 64), np.float32), np.zeros((8, 8, 3), np.uint8),
                np.zeros((20, 30), np.uint8)):
        with pytest.raises(ValueError) as jerr:
            jef.detect_and_compute(bad)
        with pytest.raises(ValueError) as terr:
            tef.detect_and_compute(bad)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jef.set_descriptor_type("bad_128")
    with pytest.raises(ValueError) as terr:
        tef.set_descriptor_type("bad_128")
    assert str(terr.value) == str(jerr.value)


def test_unported_paths_raise(scene):
    """Every path is ported: mesh= takes a `parallel.sharding.Mesh` (the
    mesh forms run in tests/test_torch_sharding.py) and raises TypeError
    for anything else; mask= and every nonmax_radius (9 and 49 take the
    routes that had no kernel before) run, as do HashSIFT (the default) and
    standalone compute()."""
    tef = TEF(device="cpu")
    assert tef.get_descriptor_type() == "hash_sift_256"
    with pytest.raises(TypeError, match="mesh must be"):
        tef.detect_and_compute(scene, mesh=object())
    with pytest.raises(TypeError, match="mesh must be"):
        tef.detect(scene, mask=np.ones_like(scene), mesh=object())
    assert tef.detect(scene, mask=np.ones_like(scene)).count > 0
    assert not hasattr(TP, "require_ported")
    for radius in (9, 49):
        kps = TEF(nonmax_radius=radius, descriptor_type="bad_256",
                  device="cpu").detect(scene)
        assert kps.count > 0
    kps, desc = tef.detect_and_compute(scene)
    assert kps.count > 0 and desc.shape == (kps.count, 32)
    assert tef.compute(scene, kps).shape == (kps.count, 32)
    assert tef.compute(scene, np.zeros((1, 4), np.float32)).shape == (1, 32)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEF(descriptor_type="bad_256", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEF(descriptor_type="bad_256")          # the default device
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        TEF(device="meta")


def test_parameters_round_trip():
    jef = JEF()
    tef = TEF(device="cpu")
    pairs = [("max_features", 123), ("scale_factor", 1.5), ("n_levels", 5),
             ("first_level", 1), ("fast_threshold", 30),
             ("nonmax_radius", 12), ("descriptor_type", "bad_512")]
    for name, value in pairs:
        getattr(jef, f"set_{name}")(value)
        getattr(tef, f"set_{name}")(value)
        assert getattr(tef, f"get_{name}")() == value
        assert getattr(tef, f"get_{name}")() == getattr(jef, f"get_{name}")()
    assert tef.descriptor_size() == jef.descriptor_size() == 64
    assert tef.descriptor_type() == jef.descriptor_type()
    assert tef.default_norm() == jef.default_norm()
    assert tef._cfg.quotas() == jef._cfg.quotas()
    assert TP.level_slot_ranges(tef._cfg, 480, 640) == \
        JP.level_slot_ranges(jef._cfg, 480, 640)


def test_keypoints_do_not_sync_silently(scene):
    kps = TEF(descriptor_type="bad_256", device="cpu").detect(scene)
    assert bool(kps)
    with pytest.raises(TypeError, match="len"):
        len(kps)
    assert kps.capacity == 5000 and kps.block() is kps
