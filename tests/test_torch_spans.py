"""The port's own spans (`utils/profiler.span`, `eff/<layer>.<what>`): the
names each entry opens under `utils.profiler.trace`, how they nest, the
matcher's and RANSAC's, nothing entered with no profiler running, and the
same outputs either way."""
import json

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.ops import matcher as TM
from efficient_features_tpu_torch.ops import ransac as TR
from efficient_features_tpu_torch.utils import profiler
from util import make_test_image

H, W = 120, 160
NLEVELS = 4
FRAMES = 2

# each entry's spans, as {span: the innermost span around it}; the entry's
# own api span has none
NESTING = {
    "detect_and_compute": {
        "api.detect_and_compute": None,
        "api.detect_and_compute_async": "api.detect_and_compute",
        "api.upload": "api.detect_and_compute_async",
        "pipeline.pyramid": "api.detect_and_compute_async",
        "pipeline.detect_level": "api.detect_and_compute_async",
        "pipeline.describe_level": "api.detect_and_compute_async",
        "bad.describe": "pipeline.describe_level",
        "pipeline.join": "api.detect_and_compute_async",
        "wait.block": "api.detect_and_compute",
        "wait.fetch": "api.detect_and_compute",
    },
    "detect_and_compute_async": {
        "api.detect_and_compute_async": None,
        "api.upload": "api.detect_and_compute_async",
        "pipeline.pyramid": "api.detect_and_compute_async",
        "pipeline.detect_level": "api.detect_and_compute_async",
        "pipeline.describe_level": "api.detect_and_compute_async",
        "bad.describe": "pipeline.describe_level",
        "pipeline.join": "api.detect_and_compute_async",
    },
    "detect_and_compute_batch": {
        "api.detect_and_compute_batch": None,
        "api.upload": "api.detect_and_compute_batch",
        "sharding.frame": "api.detect_and_compute_batch",
        "pipeline.pyramid": "sharding.frame",
        "pipeline.detect_level": "sharding.frame",
        "pipeline.describe_level": "sharding.frame",
        "bad.describe": "pipeline.describe_level",
        "pipeline.join": "sharding.frame",
        "wait.fetch": "api.detect_and_compute_batch",
    },
}


def _feat():
    return EfficientFeatures(nfeatures=300, nlevels=NLEVELS, device="cpu",
                             descriptor_type="bad_256")


def _frames():
    return np.stack([make_test_image(H, W, seed=21 + i)
                     for i in range(FRAMES)])


def _call(entry: str):
    """The entry's outputs as host arrays."""
    feat, frames = _feat(), _frames()
    if entry == "detect_and_compute_batch":
        out = feat.detect_and_compute_batch(frames, as_host=True)
        return [(k._slots["x"].numpy(), d) for k, d in out]
    kps, desc = getattr(feat, entry)(frames[0])
    return [(kps._slots["x"].numpy(), np.asarray(desc))]


def _spans(events) -> list:
    """(name less the prefix, start, end) of the program's spans."""
    return [(e["name"].removeprefix(profiler.PREFIX), float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X"
            and e.get("name", "").startswith(profiler.PREFIX)]


def _traced(fn, tmp_path):
    """fn's result and the program's spans under `profiler.trace`."""
    with profiler.trace(str(tmp_path)):
        out = fn()
    trace, = tmp_path.glob("trace-*.json")
    return out, _spans(json.loads(trace.read_text())["traceEvents"])


def _parent(spans: list, i: int):
    """The innermost span that holds spans[i], else None."""
    _, a, b = spans[i]
    around = [s for j, s in enumerate(spans) if j != i
              and s[1] <= a and b <= s[2] and s[2] - s[1] > b - a]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each entry's outputs and spans, traced once for the module."""
    return {entry: _traced(lambda: _call(entry),
                           tmp_path_factory.mktemp(entry))
            for entry in NESTING}


@pytest.mark.parametrize("entry", list(NESTING))
def test_entry_opens_its_documented_spans(traced, entry):
    _, spans = traced[entry]
    assert {name for name, _, _ in spans} == set(NESTING[entry])


@pytest.mark.parametrize("entry", list(NESTING))
def test_each_span_lies_inside_its_parent_once_a_level(traced, entry):
    _, spans = traced[entry]
    for i, (name, a, b) in enumerate(spans):
        assert a <= b
        assert _parent(spans, i) == NESTING[entry][name], name
    frames = FRAMES if entry == "detect_and_compute_batch" else 1
    count = lambda n: sum(1 for s in spans if s[0] == n)  # noqa: E731
    assert count("pipeline.detect_level") == NLEVELS * frames
    assert count("pipeline.describe_level") == NLEVELS * frames
    assert count("bad.describe") == NLEVELS * frames     # K3, a level
    assert count("pipeline.pyramid") == frames
    # the slots' join and the descriptor rows' join, a frame each
    assert count("pipeline.join") == 2 * frames
    assert count("sharding.frame") == (
        frames if entry == "detect_and_compute_batch" else 0)


@pytest.mark.parametrize("entry", list(NESTING))
def test_outputs_equal_with_and_without_the_profiler(traced, entry):
    got, _ = traced[entry]
    want = _call(entry)
    assert len(got) == len(want)
    for (gx, gd), (wx, wd) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gd, wd)


def _match_and_ransac():
    """The masked matcher on descriptors and a copy with a few bits
    flipped, then RANSAC on pairs moved by (5, -3) px."""
    rng = np.random.default_rng(4)
    d1 = torch.from_numpy(rng.integers(0, 256, (200, 32), dtype=np.uint8))
    d2 = d1 ^ torch.from_numpy(
        (rng.random((200, 32)) < 0.02).astype(np.uint8))
    valid = torch.ones(200, dtype=torch.bool)
    j, best, ok = TM.knn2_ratio_match_masked(d1, valid, d2, valid)
    src = torch.from_numpy(rng.random((200, 2), dtype=np.float32) * 300)
    dst = src[j.long()] + torch.tensor([5.0, -3.0])
    h, inl, n = TR.find_homography_ransac(src, dst, ok, iters=64, seed=2,
                                          device="cpu")
    return [t.numpy() for t in (j, best, ok, h, inl, n)]


def test_matcher_and_ransac_open_their_spans(tmp_path):
    got, spans = _traced(_match_and_ransac, tmp_path)
    want = {"ops.knn2_ratio_match_masked": None,
            "ops.find_homography_ransac": None,
            "ransac.draw": "ops.find_homography_ransac",
            "ransac.solve_score": "ops.find_homography_ransac",
            "ransac.refit": "ops.find_homography_ransac"}
    assert sorted(name for name, _, _ in spans) == sorted(want)
    for i, (name, _, _) in enumerate(spans):
        assert _parent(spans, i) == want[name], name
    for g, w in zip(got, _match_and_ransac()):
        assert np.array_equal(g, w)
    assert int(got[5]) > 150        # the shift is found


def test_annotate_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    with profiler.annotate("eff_no_profiler"), profiler.span("api.x"):
        pass
    feat, frames = _feat(), _frames()
    kps, _ = feat.detect_and_compute(frames[0])
    kps.as_arrays()
    assert kps.count > 0
    feat.detect(frames[1])
    feat.detect_and_compute_batch(frames, as_host=True)
    feat.compute(frames[0], kps)
    _match_and_ransac()
