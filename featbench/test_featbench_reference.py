"""The frozen reference against the program's CPU path on small frames:
the same keypoints slot for slot, angles within a few float32 ulps of a
degree, the same descriptor bytes, the same matches.  (These tests import
the program; the reference itself never does.)"""
import numpy as np
import pytest
import torch

from featbench import frames as FR
from featbench.reference import features as RF
from featbench.reference import matching as RM

CFG = dict(nfeatures=600, scale_factor=1.2, nlevels=8, first_level=0,
           fast_threshold=20)


def port_dac(img, radius):
    from efficient_features_tpu_torch import EfficientFeatures
    feat = EfficientFeatures(**CFG, nonmax_radius=radius,
                             descriptor_type="bad_256", device="cpu")
    kps, desc = feat.detect_and_compute(img)
    return kps, kps.as_arrays(), desc


@pytest.fixture(scope="module", autouse=True)
def threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("hw,seed,radius", [
    ((144, 256), 2 ** 31 + 5, 15), ((216, 384), 7, 15),
    ((200, 331), 2 ** 33 + 1, 10), ((160, 240), 3, 24)])
def test_detect_and_describe_matches_the_program(hw, seed, radius):
    img = FR.warp(FR.scene(*hw, seed, "cpu"), 1.1, 4.0, -3.0).numpy()
    _, got, desc = port_dac(img, radius)
    ref = RF.detect_and_describe(torch.from_numpy(img),
                                 {**CFG, "nonmax_radius": radius})
    assert len(ref["x"]) > 50
    for k in ("x", "y", "octave", "response"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert RF.angle_gap_deg(got["angle"], ref["angle"]).max() < 1e-4
    np.testing.assert_array_equal(desc, ref["desc"])
    assert sum(ref["kept"]) == len(ref["x"])
    assert all(s >= k for s, k in zip(ref["survivors"], ref["kept"]))
    assert all(c >= s for c, s in zip(ref["corners"], ref["survivors"]))


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
