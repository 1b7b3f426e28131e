"""A run of the harness on the CPU, with the timed path sound and then
broken underneath: `correct` holds for the sound program and falls for
each fault the cells can have (a step that returns its state unchanged,
half of a batch left out and the rest repeated in its place, an answer
altered where it is produced).  No cell spans cards, so no exchange
between them can be left out."""
import functools

import numpy as np
import pytest
import torch

from featbench import harness
from featbench.testutil import tiny_root

PORT = "efficient_features_tpu_torch"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, seconds=0.6):
    return harness.run(cell, 2 ** 31 + 77, seconds, False, "cpu",
                       root=root)


def stale(fn):
    """fn returning its first result on every later call."""
    first = []

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if not first:
            first.append(fn(*a, **kw))
        return first[0]
    return wrapped


@pytest.mark.parametrize("cell", ["tiny.single", "tiny.batch",
                                  "tiny.sequence", "tiny_hs.single"])
def test_sound_program_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert list(r)[-1] == "checks"


def _api():
    import efficient_features_tpu_torch.api as api
    return api.EfficientFeatures


def _flip_desc(fn):
    def wrapped(*a, **kw):
        kps, desc = fn(*a, **kw)
        desc = desc.copy()
        desc[len(desc) // 2, 0] ^= 0x10
        return kps, desc
    return wrapped


def _flip_desc_rows(fn):
    """A bit of every 32nd descriptor flipped: 1 byte in 1024, above
    HashSIFT's budget of 1e-4 at any frame size."""
    def wrapped(*a, **kw):
        kps, desc = fn(*a, **kw)
        desc = desc.copy()
        desc[::32, 0] ^= 0x10
        return kps, desc
    return wrapped


def _shift_kp(fn):
    def wrapped(*a, **kw):
        kps = fn(*a, **kw)
        arrays = dict(kps)
        arrays["x"] = arrays["x"].copy()
        arrays["x"][0] += 1
        return arrays
    return wrapped


def _half_batch(fn):
    def wrapped(self, images, *a, **kw):
        res = fn(self, images, *a, **kw)
        half = len(res) // 2
        return res[:half] + res[:len(res) - half]
    return wrapped


def _move_h(fn):
    def wrapped(*a, **kw):
        H, inl, n = fn(*a, **kw)
        H = H.clone()
        H[0, 2] += 8.0
        return H, inl, n
    return wrapped


def _drop_match(fn):
    def wrapped(*a, **kw):
        j, best, ok = fn(*a, **kw)
        ok = ok.clone()
        ok[torch.nonzero(ok)[:3, 0]] = False
        return j, best, ok
    return wrapped


FAULTS = {
    "single-state-unchanged": ("tiny.single", "api", "detect_and_compute",
                               stale),
    "single-descriptor-altered": ("tiny.single", "api",
                                  "detect_and_compute", _flip_desc),
    "single-keypoint-altered": ("tiny.single", "kps", "as_arrays",
                                _shift_kp),
    "hash-sift-descriptors-altered": ("tiny_hs.single", "api",
                                      "detect_and_compute", _flip_desc_rows),
    "batch-state-unchanged": ("tiny.batch", "api",
                              "detect_and_compute_batch", stale),
    "batch-half-left-out": ("tiny.batch", "api", "detect_and_compute_batch",
                            _half_batch),
    "sequence-state-unchanged": ("tiny.sequence", "api",
                                 "detect_and_compute_async", stale),
    "sequence-homography-state-unchanged": (
        "tiny.sequence", "ransac", "find_homography_ransac", stale),
    "sequence-homography-altered": ("tiny.sequence", "ransac",
                                    "find_homography_ransac", _move_h),
    "sequence-matches-altered": ("tiny.sequence", "matcher",
                                 "knn2_ratio_match_masked", _drop_match),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(root, fault, monkeypatch):
    import importlib
    cell, where, name, wrap = FAULTS[fault]
    if where == "api":
        owner = _api()
    elif where == "kps":
        owner = importlib.import_module(PORT + ".api").KeyPoints
    else:
        owner = importlib.import_module(f"{PORT}.ops.{where}")
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    r = run(root, cell)
    assert not r["correct"], r["checks"]
    bad = [k for k, v in r["checks"].items() if not v["value"] <= v["limit"]]
    assert bad, r["checks"]
    assert np.isfinite([v["value"] for v in r["checks"].values()]).all()
