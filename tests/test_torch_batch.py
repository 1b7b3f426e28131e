"""The port's single-device `detect_and_compute_batch` against the JAX
package's batch pipeline on a one-device mesh.

The JAX side is `parallel.sharding.detect_and_compute_batch` (`shard_map`
over a 1-device mesh, `lax.map` over the frames on it); the port loops over
the frames on its device.  Tolerances as for a single frame: keypoint slots
bit-identical, angles within 1e-3 degrees, descriptors within
int(2e-5 * bytes) + 1 (BAD) or int(1e-4 * bytes) + 1 (HashSIFT) differing
bytes per frame.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu import pipeline as JP
from efficient_features_tpu.parallel import sharding as JSH
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch import pipeline as TP
from efficient_features_tpu_torch.parallel import sharding as TSH

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
KW = dict(nfeatures=300, nlevels=3)


@pytest.fixture(scope="module")
def images():
    return np.stack([make_test_image(120, 160, seed=100 + i)
                     for i in range(2)])


@pytest.mark.parametrize("descriptor_type,share", [("bad_256", 2e-5),
                                                   ("hash_sift_256", 1e-4)])
def test_batch_matches_jax_on_a_one_device_mesh(images, descriptor_type,
                                                share):
    mesh = JSH.make_mesh(1)
    want_slots, want_desc = JSH.detect_and_compute_batch(
        JSH.shard_batch(images, mesh),
        JP.FeatureConfig(descriptor_type=descriptor_type, **KW), mesh)
    cfg = TP.FeatureConfig(descriptor_type=descriptor_type, **KW)
    slots, desc = TSH.detect_and_compute_batch(torch.from_numpy(images), cfg)
    assert set(slots) == set(want_slots)
    for k in EXACT:
        want = np.asarray(want_slots[k])
        assert slots[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(slots[k].numpy(), want, err_msg=k)
    d = np.abs(slots["angle"].numpy() - np.asarray(want_slots["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3
    want_desc = np.asarray(want_desc)
    assert desc.dtype == torch.uint8 and desc.shape == want_desc.shape
    for i in range(2):
        assert int(slots["count"][i]) > 20
        assert (desc[i].numpy() != want_desc[i]).sum() <= \
            int(share * want_desc[i].size) + 1


@pytest.mark.parametrize("hs_fused", [False, True])
def test_batch_frames_equal_single_calls(images, hs_fused):
    feat = TEF(device="cpu", hs_fused=hs_fused, **KW)
    slots, desc = feat.detect_and_compute_batch(images)
    assert tuple(desc.shape) == (2, 300, 32)
    assert tuple(slots["count"].shape) == (2,)
    for i in range(2):
        kps, d1 = feat.detect_and_compute_async(images[i])
        assert torch.equal(desc[i], d1)
        for k, v in kps._slots.items():
            assert torch.equal(slots[k][i], v), k
    # a tensor batch gives the same as an array batch
    slots_t, desc_t = feat.detect_and_compute_batch(torch.from_numpy(images))
    assert torch.equal(desc_t, desc)
    assert all(torch.equal(slots_t[k], slots[k]) for k in slots)


def test_batch_as_host_matches_single(images):
    """as_host=True: per-image KeyPoints and compacted descriptors, equal to
    `detect_and_compute` on each image; the KeyPoints feed compute()."""
    feat = TEF(device="cpu", descriptor_type="bad_256", **KW)
    out = feat.detect_and_compute_batch(images, as_host=True)
    assert len(out) == 2
    for i, (kps, desc) in enumerate(out):
        k1, d1 = feat.detect_and_compute(images[i])
        assert kps.count == k1.count > 20
        a, b = kps.as_arrays(), k1.as_arrays()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(desc, d1)
        assert desc.shape == (kps.count, 32)
        np.testing.assert_array_equal(feat.compute(images[i], kps),
                                      feat.compute(images[i], k1))


def test_batch_keypoints_static_properties_match_jax(images):
    """`KeyPoints.max_size` and `.level_ranges` of the batch entry point
    equal the JAX package's (static values, no tolerance)."""
    from efficient_features_tpu import EfficientFeatures as JEF
    kw = dict(descriptor_type="bad_256", **KW)
    port = TEF(device="cpu", **kw).detect_and_compute_batch(images,
                                                            as_host=True)
    ref = JEF(**kw).detect_and_compute_batch(images, mesh=JSH.make_mesh(1),
                                             as_host=True)
    assert len(port) == len(ref) == 2
    for (pk, _), (rk, _) in zip(port, ref):
        assert pk.max_size == rk.max_size == pytest.approx(31 * 1.2 ** 2)
        assert pk.level_ranges == rk.level_ranges
        assert len(pk.level_ranges) == 3
        assert pk.level_ranges[-1][1] == pk.capacity


def test_batch_rejects_bad_input(images):
    feat = TEF(device="cpu", **KW)
    for bad in (images[0], images.astype(np.float32),
                torch.from_numpy(images).to(torch.int32)):
        with pytest.raises(ValueError, match=r"\(B, H, W\) uint8"):
            feat.detect_and_compute_batch(bad)
    with pytest.raises(ValueError, match="too small"):
        feat.detect_and_compute_batch(np.zeros((2, 10, 10), np.uint8))
    with pytest.raises(TypeError, match="mesh must be"):
        feat.detect_and_compute_batch(images, mesh=object())
    with pytest.raises(ValueError, match="B >= 1"):
        TSH.detect_and_compute_batch(torch.zeros((0, 120, 160),
                                                 dtype=torch.uint8),
                                     feat._cfg)
