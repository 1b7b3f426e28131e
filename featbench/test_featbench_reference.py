"""The frozen reference against the program's CPU path on small frames:
the same keypoints slot for slot, angles within a few float32 ulps of a
degree, the same BAD bytes, HashSIFT bytes within the library's budget,
the same matches, the same tables.  (These tests import the program; the
reference itself never does.)"""
import numpy as np
import pytest
import torch

from featbench import frames as FR
from featbench.reference import features as RF
from featbench.reference import hash_sift as HS
from featbench.reference import matching as RM

CFG = dict(nfeatures=600, scale_factor=1.2, nlevels=8, first_level=0,
           fast_threshold=20)


def port_dac(img, radius, descriptor_type="bad_256"):
    from efficient_features_tpu_torch import EfficientFeatures
    feat = EfficientFeatures(**CFG, nonmax_radius=radius,
                             descriptor_type=descriptor_type, device="cpu")
    kps, desc = feat.detect_and_compute(img)
    return kps, kps.as_arrays(), desc


@pytest.fixture(scope="module", autouse=True)
def threads():
    torch.set_num_threads(2)


FRAMES = [((144, 256), 2 ** 31 + 5, 15), ((216, 384), 7, 15),
          ((200, 331), 2 ** 33 + 1, 10), ((160, 240), 3, 24)]


@pytest.mark.parametrize("descriptor_type", RF.DESCRIPTOR_TYPES)
def test_detect_and_describe_matches_the_program(descriptor_type):
    """BAD: the same bytes.  HashSIFT: at most 1e-4 of the bytes differ
    over the frames pooled (one small frame holds too few bytes for a
    share), the library's stated HashSIFT budget: the reference sums its
    histogram vote by vote and its projection in an order of its own, the
    program by other products, so bytes need not match exactly."""
    differ = total = 0
    for hw, seed, radius in FRAMES:
        img = FR.warp(FR.scene(*hw, seed, "cpu"), 1.1, 4.0, -3.0).numpy()
        _, got, desc = port_dac(img, radius, descriptor_type)
        ref = RF.detect_and_describe(
            torch.from_numpy(img), {**CFG, "nonmax_radius": radius,
                                    "descriptor_type": descriptor_type})
        assert len(ref["x"]) > 50
        for k in ("x", "y", "octave", "response"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert RF.angle_gap_deg(got["angle"], ref["angle"]).max() < 1e-4
        nbits = int(descriptor_type.rsplit("_", 1)[1])
        assert desc.shape == ref["desc"].shape == (len(ref["x"]), nbits // 8)
        if descriptor_type.startswith("bad"):
            np.testing.assert_array_equal(desc, ref["desc"])
        differ += np.count_nonzero(desc != ref["desc"])
        total += desc.size
        assert sum(ref["kept"]) == len(ref["x"])
        assert all(s >= k for s, k in zip(ref["survivors"], ref["kept"]))
        assert all(c >= s for c, s in zip(ref["corners"], ref["survivors"]))
    assert differ <= 1e-4 * total


@pytest.mark.parametrize("descriptor_type", ["bad_128", "hash_sift_1024",
                                             "orb_256", "bad256"])
def test_other_descriptor_types_raise(descriptor_type):
    img = torch.zeros((64, 96), dtype=torch.uint8)
    with pytest.raises(ValueError):
        RF.detect_and_describe(img, {**CFG, "nonmax_radius": 15,
                                     "descriptor_type": descriptor_type})


@pytest.mark.parametrize("nbits", [256, 512])
def test_tables_equal_the_programs(nbits):
    from efficient_features_tpu_torch.models import params
    boxes, th = RF.bad_table(nbits, "cpu")
    want_boxes, want_th = params.load_bad_params(nbits)
    assert boxes.dtype == torch.int32 and th.dtype == torch.float32
    np.testing.assert_array_equal(boxes.numpy(), want_boxes)
    np.testing.assert_array_equal(th.numpy(), want_th)
    b = HS.projection(nbits, "cpu")
    assert b.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(),
                                  params.load_hash_sift_matrix(nbits))


def test_matches_equal_the_programs_masked_matcher():
    from efficient_features_tpu_torch.ops import matcher
    base = FR.scene(216, 384, 11, "cpu")
    a, b = (FR.warp(base, *p).numpy() for p in [(0.0, 0.0, 0.0),
                                                 (1.0, 6.0, -4.0)])
    (ka, _, _), (kb, _, _) = port_dac(a, 15), port_dac(b, 15)
    from efficient_features_tpu_torch import EfficientFeatures
    feat = EfficientFeatures(**CFG, nonmax_radius=15,
                             descriptor_type="bad_256", device="cpu")
    (ka, da), (kb, db) = (feat.detect_and_compute_async(x) for x in (a, b))
    j, _, ok = matcher.knn2_ratio_match_masked(
        da, ka._slots["valid"], db, kb._slots["valid"], 0.8)
    va, vb = ka._slots["valid"].numpy(), kb._slots["valid"].numpy()
    ia, ib = np.cumsum(va) - 1, np.cumsum(vb) - 1       # slot -> compacted
    got = {(int(ia[i]), int(ib[j[i]])) for i in np.nonzero(ok.numpy())[0]}
    ri, rj = RM.ratio_cross_matches(da[va], db[vb], 0.8)
    want = set(zip(ri.tolist(), rj.tolist()))
    assert len(want) > 30
    assert got == want


def test_bfloat16_reference_departs():
    img = FR.scene(144, 256, 2 ** 31 + 9, "cpu")
    cfg = {**CFG, "nonmax_radius": 15}
    f32 = RF.detect_and_describe(img, cfg)
    low = RF.detect_and_describe(img, cfg, torch.bfloat16)
    n = min(len(f32["x"]), len(low["x"]))
    assert (f32["response"][:n] != low["response"][:n]).any()


@pytest.mark.parametrize("nbits", [256, 512])
def test_bfloat16_hash_sift_departs(nbits):
    """On the same keypoints of a blurred frame, HashSIFT in bfloat16
    differs from float32 in a large share of its bytes."""
    img = RF.gaussian_blur7_u8(FR.scene(144, 256, 2 ** 31 + 9, "cpu"))
    ref = RF.detect_and_describe(img, {**CFG, "nonmax_radius": 15})
    kp = [torch.from_numpy(v.astype(np.float32)) for v in
          (ref["x"], ref["y"], np.full(len(ref["x"]), 31.0), ref["angle"])]
    f32 = HS.hash_sift(img, *kp, nbits).numpy()
    low = HS.hash_sift(img, *kp, nbits, torch.bfloat16).numpy()
    assert len(f32) > 50 and f32.shape == low.shape == (len(f32), nbits // 8)
    assert np.count_nonzero(f32 != low) / f32.size > 0.1
