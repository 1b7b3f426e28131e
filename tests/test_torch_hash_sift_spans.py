"""HashSIFT's describe spans (`eff/hash_sift.warp`, `.hist`, `.fused`,
`.project`): which each call opens under `utils.profiler.trace`, once a
level inside `pipeline.describe_level` or once inside `pipeline.compute`;
none for BAD; nothing entered with no profiler running; the same
descriptors either way.  On a card (`cuda`): the eager call and the capture
open them, a replay of the captured graph none, with the same bytes."""
import json

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch import graphs as G
from efficient_features_tpu_torch.utils import profiler
from test_torch_spans import _parent, _traced
from util import make_test_image

H, W = 120, 160
NLEVELS = 4

# case: (descriptor type, hs_fused, entry, the hash_sift spans it opens,
# the span around each, how many times each opens)
CASES = {
    "dac_hs256": ("hash_sift_256", False, "detect_and_compute",
                  ("hash_sift.warp", "hash_sift.hist", "hash_sift.project"),
                  "pipeline.describe_level", NLEVELS),
    "dac_hs512_fused": ("hash_sift_512", True, "detect_and_compute",
                        ("hash_sift.fused", "hash_sift.project"),
                        "pipeline.describe_level", NLEVELS),
    "compute_hs256": ("hash_sift_256", False, "compute",
                      ("hash_sift.warp", "hash_sift.hist",
                       "hash_sift.project"), "pipeline.compute", 1),
    "compute_hs256_fused": ("hash_sift_256", True, "compute",
                            ("hash_sift.fused", "hash_sift.project"),
                            "pipeline.compute", 1),
    "dac_bad256": ("bad_256", False, "detect_and_compute", (), None, 0),
    "compute_bad512": ("bad_512", False, "compute", (), None, 0),
}


def _feat(descriptor_type: str, fused: bool):
    return EfficientFeatures(nfeatures=300, nlevels=NLEVELS, device="cpu",
                             descriptor_type=descriptor_type, hs_fused=fused)


def _frame():
    return make_test_image(H, W, seed=31)


def _describe(case: str):
    """A function that returns the case's descriptors as a host array
    (`compute` on the keypoints of a `detect` made here)."""
    dtype, fused, entry, *_ = CASES[case]
    feat, frame = _feat(dtype, fused), _frame()
    if entry == "compute":
        kps = feat.detect(frame)
        return lambda: np.asarray(feat.compute(frame, kps))
    return lambda: np.asarray(feat.detect_and_compute(frame)[1])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each case's descriptors and spans, traced once for the module."""
    return {case: _traced(_describe(case), tmp_path_factory.mktemp(case))
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_call_opens_its_hash_sift_spans(traced, case):
    _, spans = traced[case]
    opened = {name for name, _, _ in spans if name.startswith("hash_sift.")}
    assert opened == set(CASES[case][3])


@pytest.mark.parametrize("case", list(CASES))
def test_each_hash_sift_span_lies_in_its_parent_once_a_call(traced, case):
    _, spans = traced[case]
    _, _, _, names, parent, times = CASES[case]
    for name in names:
        at = [i for i, s in enumerate(spans) if s[0] == name]
        assert len(at) == times, name
        for i in at:
            assert _parent(spans, i) == parent, name
    # the parent opens once a level or a call around its describe work
    if parent is not None:
        assert sum(1 for s in spans if s[0] == parent) == times


@pytest.mark.parametrize("case", list(CASES))
def test_descriptors_equal_with_and_without_the_profiler(traced, case):
    got, _ = traced[case]
    want = _describe(case)()
    assert got.shape == want.shape and got.shape[0] > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_hash_sift_spans_enter_nothing_without_a_profiler(monkeypatch,
                                                          fused):
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    feat, frame = _feat("hash_sift_256", fused), _frame()
    kps, desc = feat.detect_and_compute(frame)
    assert kps.count > 0 and np.asarray(desc).any()
    assert feat.compute(frame, kps).shape == (kps.count, 32)


def _host_spans(fn, tmp_path):
    """fn's result and the names of the program's host ranges under
    `profiler.trace` (on a card the trace also copies ranges that hold
    device work onto the device's line)."""
    with profiler.trace(str(tmp_path)):
        out = fn()
    trace, = tmp_path.glob("trace-*.json")
    return out, [e["name"].removeprefix(profiler.PREFIX)
                 for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith(profiler.PREFIX)]


@pytest.mark.cuda
def test_a_replay_opens_no_hash_sift_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured on a card")
    G.CACHE.clear()
    img = make_test_image(240, 320, seed=11)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="hash_sift_256",
                           device="cuda")
    levels = ef._cfg.nlevels
    want = ("hash_sift.warp", "hash_sift.hist", "hash_sift.project")
    runs = {call: _host_spans(
                lambda: np.asarray(ef.detect_and_compute(img)[1]),
                tmp_path / call)
            for call in ("eager", "capture", "replay")}
    assert (G.CACHE.eager, G.CACHE.captures, G.CACHE.replays) == (1, 1, 1)
    G.CACHE.clear()
    # a key's second call runs the core once on the side stream, the
    # warm-up, and once more under the capture
    for call, cores in (("eager", 1), ("capture", 2)):
        names = runs[call][1]
        assert all(names.count(n) == cores * levels for n in want), call
    names = runs["replay"][1]
    assert "pipeline.replay" in names
    assert not [n for n in names if n.startswith("hash_sift.")]
    assert np.array_equal(runs["eager"][0], runs["replay"][0])
    assert np.array_equal(runs["capture"][0], runs["replay"][0])
