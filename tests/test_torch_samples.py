"""The port's four samples, run in-process on the CPU on small scenes.

The same scenes and assertions as `tests/test_samples.py`: a 240x320
corner-rich scene replaces each synthetic frame, and `--device cpu` runs
the plain versions of the kernels.
"""
import re
import sys

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.samples import sample_benchmark as SB
from efficient_features_tpu_torch.samples import sample_common as SC
from efficient_features_tpu_torch.samples import \
    sample_feature_extraction as SFE
from efficient_features_tpu_torch.samples import \
    sample_feature_matching as SFM
from efficient_features_tpu_torch.samples import sample_image_sequence as SIS

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
