"""The standalone describe's spans: `eff/pipeline.compute` around
`pipeline.compute` (the keypoint columns and the describe) and
`eff/bad.describe` around each call of K3's wrapper
(`ops/window_kernels.bad_descriptors_windows`: the scratch integral, the
flag and the launch).  Under `utils.profiler.trace` a `compute` call opens
each once, inside `eff/api.compute_async`, with host (N, 4) keypoints or
`KeyPoints`; HashSIFT's opens `pipeline.compute` and no `bad.describe`;
nothing is entered with no profiler running; the descriptors are the same
either way.  On a card (`cuda`): an eager `detect_and_compute` and its
capture open `bad.describe` once a level, a replay of the captured graph
neither span, with the same bytes."""
import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch import graphs as G
from test_torch_hash_sift_spans import _host_spans
from test_torch_spans import _parent, _traced
from util import make_test_image

H, W = 120, 160
NLEVELS = 4

# case: (descriptor type, keypoints handed over as, the spans it opens
# with their parents)
CASES = {
    "bad256_host": ("bad_256", "xysa",
                    {"pipeline.compute": "api.compute_async",
                     "bad.describe": "pipeline.compute"}),
    "bad512_keypoints": ("bad_512", "KeyPoints",
                         {"pipeline.compute": "api.compute_async",
                          "bad.describe": "pipeline.compute"}),
    "hs256_host": ("hash_sift_256", "xysa",
                   {"pipeline.compute": "api.compute_async"}),
}


def _describe(case: str):
    """A function that returns the case's `compute` descriptors as a host
    array, on the keypoints of a `detect` made here."""
    dtype, given, _ = CASES[case]
    feat = EfficientFeatures(nfeatures=300, nlevels=NLEVELS, device="cpu",
                             descriptor_type=dtype)
    frame = make_test_image(H, W, seed=33)
    kps = feat.detect(frame)
    keypoints = kps.xysa() if given == "xysa" else kps
    return lambda: np.asarray(feat.compute(frame, keypoints))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each case's descriptors and spans, traced once for the module."""
    return {case: _traced(_describe(case), tmp_path_factory.mktemp(case))
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_opens_each_span_once_inside_its_parent(traced, case):
    _, spans = traced[case]
    want = CASES[case][2]
    for name in ("pipeline.compute", "bad.describe"):
        at = [i for i, s in enumerate(spans) if s[0] == name]
        assert len(at) == (name in want), name
        for i in at:
            assert _parent(spans, i) == want[name], name
    # and both lie inside the entry's own span
    entry = [s for s in spans if s[0] == "api.compute_async"]
    assert len(entry) == 1
    for name, a, b in spans:
        if name in want:
            assert entry[0][1] <= a and b <= entry[0][2], name


@pytest.mark.parametrize("case", list(CASES))
def test_descriptors_equal_with_and_without_the_profiler(traced, case):
    got, _ = traced[case]
    want = _describe(case)()
    assert got.shape == want.shape and got.shape[0] > 0
    assert np.array_equal(got, want)


def test_compute_spans_enter_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler running")
    describe = _describe("bad256_host")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    desc = describe()
    assert desc.shape[0] > 0 and desc.any()


@pytest.mark.cuda
def test_a_replay_opens_neither_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured on a card")
    G.CACHE.clear()
    img = make_test_image(240, 320, seed=11)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    levels = ef._cfg.nlevels
    runs = {call: _host_spans(
                lambda: np.asarray(ef.detect_and_compute(img)[1]),
                tmp_path / call)
            for call in ("eager", "capture", "replay")}
    assert (G.CACHE.eager, G.CACHE.captures, G.CACHE.replays) == (1, 1, 1)
    G.CACHE.clear()
    # a key's second call runs the core once on the side stream, the
    # warm-up, and once more under the capture
    for call, cores in (("eager", 1), ("capture", 2)):
        assert runs[call][1].count("bad.describe") == cores * levels, call
    names = runs["replay"][1]
    assert "pipeline.replay" in names
    assert "bad.describe" not in names and "pipeline.compute" not in names
    assert np.array_equal(runs["eager"][0], runs["replay"][0])
    assert np.array_equal(runs["capture"][0], runs["replay"][0])
