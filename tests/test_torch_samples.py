"""The port's five samples and its matching-quality tool, run in-process on
the CPU on small scenes.

The same scenes and assertions as `tests/test_samples.py` and
`tests/test_eval.py`: a 240x320 corner-rich scene replaces each synthetic
frame, the HPatches exporter reads a synthetic 3-patch column, the eval tool
the committed real photo, and `--device cpu` runs the plain versions of the
kernels.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.samples import hpatches_description as HPD
from efficient_features_tpu_torch.samples import sample_benchmark as SB
from efficient_features_tpu_torch.samples import sample_common as SC
from efficient_features_tpu_torch.samples import \
    sample_feature_extraction as SFE
from efficient_features_tpu_torch.samples import \
    sample_feature_matching as SFM
from efficient_features_tpu_torch.samples import sample_image_sequence as SIS
from efficient_features_tpu_torch.tools import eval_matching as TEV

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


def _small_load_gray(path=None, h=1080, w=1920, seed=0):
    """Drop-in for sample_common.load_gray: small corner-rich scene."""
    return make_test_image(240, 320, seed=seed)


def _run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(module, "load_gray", _small_load_gray)
    monkeypatch.setattr(sys, "argv", ["x", *argv, "--device", "cpu"])
    module.main()
    return capsys.readouterr().out


def test_sample_feature_extraction(monkeypatch, capsys):
    out = _run_main(SFE, ["--max-keypoints", "500"], monkeypatch, capsys)
    nk = int(re.search(r"(\d+) keypoints", out).group(1))
    assert nk > 50
    assert "sync" in out and "async" in out


@pytest.mark.parametrize("btype,radius", [(0, 15), (1, 5), (1, 49), (2, 15)])
def test_sample_benchmark(btype, radius, monkeypatch, capsys):
    """Every benchmark type runs end to end, and detect-only at a small and
    a large --nonmax-radius (the routes without the cells kernel)."""
    out = _run_main(
        SB, ["--max-keypoints", "300", "--num-iterations", "1",
             "--benchmark-type", str(btype), "--nonmax-radius", str(radius)],
        monkeypatch, capsys)
    assert re.search(r"processing time: [0-9.]+\[milli sec\]", out)
    assert f"nonmax radius   : {radius}" in out
    # a radius-49 disc leaves few keypoints on a 240x320 scene
    floor = 50 if radius < 49 else 5
    assert int(re.search(r"(\d+) keypoints found", out).group(1)) > floor


def test_sample_benchmark_hs_fused(monkeypatch, capsys):
    """--hs-fused reaches the detector's configuration and the run ends as
    the two-stage one does."""
    made = []
    real = SB.EfficientFeatures
    monkeypatch.setattr(SB, "EfficientFeatures",
                        lambda **kw: made.append(real(**kw)) or made[-1])
    out = _run_main(SB, ["--max-keypoints", "300", "--num-iterations", "1",
                         "--descriptor-type", "1", "--hs-fused"],
                    monkeypatch, capsys)
    assert made[0]._cfg.hs_fused
    assert made[0]._cfg.descriptor_type == "hash_sift_256"
    assert int(re.search(r"(\d+) keypoints found", out).group(1)) > 50


@pytest.mark.parametrize("args,name,nbits", [
    (["--descriptor-type", "0"], "bad256", 256),
    (["--descriptor-type", "1"], "hashsift256", 256),
    (["--descriptor-type", "1", "--descriptor-bits", "512", "--hs-fused"],
     "hashsift512", 512),
    (["--descriptor-type", "1", "--use-orientation"], "hashsift256", 256)])
def test_hpatches_description(args, name, nbits, tmp_path, monkeypatch):
    """CSV export on a synthetic 3-patch HPatches column (as
    `tests/test_samples.py`): the bits are the NumPy oracle's descriptors of
    the same synthesized keypoints, within 2e-5 (BAD) or 1e-4 (HashSIFT) of
    the bits."""
    from PIL import Image
    from efficient_features_tpu.cpu import descriptors as DC
    from efficient_features_tpu.cpu.reference import ic_angles

    col = np.vstack([make_test_image(65, 65, seed=s) for s in (1, 2, 3)])
    seq = tmp_path / "in" / "v_test"
    seq.mkdir(parents=True)
    Image.fromarray(col).save(seq / "ref.png")
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "in"),
                                      str(tmp_path / "out"), *args,
                                      "--device", "cpu"])
    HPD.main()
    bits = np.loadtxt(tmp_path / "out" / name / "v_test" / f"ref.{name}.csv",
                      delimiter=",", dtype=np.int64)
    assert bits.shape == (3, nbits) and set(np.unique(bits)) <= {0, 1}

    x = np.full(3, 32.0, np.float32)
    y = (np.arange(3) * 65 + 32.0).astype(np.float32)
    size = np.full(3, 65.0, np.float32)
    angle = np.full(3, -1.0, np.float32)
    if "--use-orientation" in args:
        angle = ic_angles(col, np.clip(y.astype(np.int32), 15, 195 - 16),
                          np.clip(x.astype(np.int32), 15, 65 - 16))
        kps = HPD.patch_keypoints(torch.from_numpy(col), 1.0, True).numpy()
        np.testing.assert_array_equal(kps[:, :3],
                                      np.stack([x, y, size], axis=1))
        assert np.abs(kps[:, 3] - angle).max() < 1e-3
        assert len(set(angle.tolist())) == 3
    if name.startswith("bad"):
        want, share = DC.bad_descriptors(col, x, y, size, angle,
                                         nbits=nbits), 2e-5
    else:
        want, share = DC.hash_sift_descriptors(col, x, y, size, angle,
                                               nbits=nbits), 1e-4
    assert (bits != np.unpackbits(want, axis=1)).mean() <= share


def test_hpatches_description_needs_sequences(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path), str(tmp_path),
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="no sequence dirs"):
        HPD.main()


@pytest.fixture(scope="module")
def photo():
    from PIL import Image
    return np.array(Image.open(os.path.join(
        os.path.dirname(__file__), "data", "real_photo.png")))


@pytest.mark.parametrize("dt", ["bad_256", "hash_sift_256"])
def test_eval_matching_quality(photo, dt):
    """`evaluate_pair` on the real photo under the rigid homography: the
    floors of `tests/test_eval.py`, and the JAX tool's numbers on the same
    pair.  Keypoint selection is bit-identical in the two packages, so the
    keypoint counts and the repeatability are equal; the match counts are
    equal when the descriptor bytes are, and differ by at most 1% (a
    descriptor byte within the parity budget can move a match)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import eval_matching as JEV

    H = TEV._homographies(photo.shape[1], photo.shape[0])["rigid"]
    np.testing.assert_array_equal(
        H, JEV._homographies(photo.shape[1], photo.shape[0])["rigid"])
    r = TEV.evaluate_pair(photo, H, nfeatures=1500, descriptor_type=dt,
                          device="cpu")
    assert r["n_kp1"] > 200 and r["n_kp2"] > 200
    assert r["repeatability"] > 0.5, r
    assert r["n_matches"] > 100, r
    assert r["inlier_rate"] > 0.7, r
    want = JEV.evaluate_pair(photo, H, nfeatures=1500, descriptor_type=dt)
    for k in ("n_kp1", "n_kp2", "n_proj_in_bounds", "repeatability"):
        assert r[k] == want[k], (k, r, want)
    assert abs(r["n_matches"] - want["n_matches"]) <= \
        0.01 * want["n_matches"], (r, want)
    assert abs(r["inlier_rate"] - want["inlier_rate"]) <= 0.01, (r, want)


def test_eval_matching_helpers_are_the_jax_tools(photo):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import eval_matching as JEV

    small = photo[:150, :200]
    for name, H in TEV._homographies(200, 150).items():
        np.testing.assert_array_equal(TEV.apply_homography(small, H),
                                      JEV.apply_homography(small, H))
        xs, ys = np.arange(5.0) * 30, np.arange(5.0) * 20
        for a, b in zip(TEV.project(H, xs, ys), JEV.project(H, xs, ys)):
            np.testing.assert_array_equal(a, b)
    assert TEV.FIXTURES == JEV.FIXTURES
    assert TEV.FIXTURE_THRESHOLD == JEV.FIXTURE_THRESHOLD
    for name in TEV.FIXTURES:
        assert os.path.exists(os.path.join(TEV.REPO, "tests", "data",
                                           name + ".png"))


@pytest.mark.parametrize("homography", [False, True])
def test_sample_feature_matching(homography, monkeypatch, capsys):
    out = _run_main(SFM, ["--max-keypoints", "400"]
                    + (["--homography"] if homography else []),
                    monkeypatch, capsys)
    nm = int(re.search(r"cross-checked matches: (\d+)", out).group(1))
    # a 5-degree/12px rigid warp of the same scene must match heavily
    assert nm > 30
    if homography:
        got = re.search(r"RANSAC homography: (\d+) inliers of (\d+)", out)
        n_inl, nm = int(got.group(1)), int(got.group(2))
        assert n_inl / nm > 0.7


@pytest.mark.parametrize("homography", [False, True])
def test_sample_image_sequence(homography, monkeypatch, capsys):
    out = _run_main(SIS, ["--frames", "3", "--max-keypoints", "300"]
                    + (["--homography"] if homography else []),
                    monkeypatch, capsys)
    rows = re.findall(r"frame (\d+): (\d+) kps, (\d+) matches, [0-9.]+ ms"
                      r"(?:, (\d+) RANSAC inliers)?", out)
    assert [r[0] for r in rows] == ["0", "1", "2"]
    assert all(int(r[1]) > 20 for r in rows)
    nm = int(rows[2][2])
    assert nm > 10                     # consecutive-frame matches
    if homography:
        assert int(rows[2][3]) / nm > 0.6


def test_streaming_state_keeps_its_storage():
    """The state tensors are written in place: same storage every step, and
    they hold the last frame's slots."""
    feat = EfficientFeatures(nfeatures=300, descriptor_type="bad_256",
                             device="cpu")
    base = make_test_image(240, 320, seed=9)
    step, state = SIS.streaming_step_fn(feat._cfg, base.shape,
                                        homography=True, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    for i in range(3):
        frame = SC.warp_image(base, 2.0 * i, 5.0 * i, 1.0)
        count, nmatch, H, n_inl = step(frame)
        assert {k: v.data_ptr() for k, v in state.items()} == ptrs
        assert count.dtype == torch.int32 and H.shape == (3, 3)
        if i == 0:
            assert int(nmatch) == 0 and int(n_inl) == 0
    kps, desc = feat.detect_and_compute_async(frame)
    assert torch.equal(state["valid"], kps._slots["valid"])
    assert torch.equal(state["desc"], desc)
    assert int(nmatch) > 10 and int(n_inl) / int(nmatch) > 0.6


def test_warp_matrix_is_the_warp():
    """A lone bright pixel lands where `warp_matrix` sends it, to the
    nearest pixel."""
    img = np.zeros((120, 160), np.uint8)
    for q in ((40, 30), (100, 90), (80, 60)):
        img[:] = 0
        img[q[1], q[0]] = 255
        out = SC.warp_image(img, 7.0, 4.5, -3.0)
        ys, xs = np.nonzero(out)
        p = SC.warp_matrix(img.shape, 7.0, 4.5, -3.0) @ [q[0], q[1], 1.0]
        assert len(xs) >= 1
        assert np.abs(xs - p[0]).max() <= 1 and np.abs(ys - p[1]).max() <= 1


def test_scenes_are_the_repository_scenes():
    import bench
    np.testing.assert_array_equal(SC.make_bench_image(90, 120, seed=3),
                                  bench.make_bench_image(90, 120, seed=3))
    np.testing.assert_array_equal(SC.make_test_image(90, 120, seed=3),
                                  make_test_image(90, 120, seed=3))
    tiles = SC.tiled_scene(160, 240, seed=5, distinct=True)
    np.testing.assert_array_equal(tiles[20:40, 60:90],
                                  make_test_image(20, 30, seed=5 + 10))
    np.testing.assert_array_equal(SC.tiled_scene(160, 240, 5, False),
                                  np.tile(make_test_image(20, 30, 5), (8, 8)))
