"""The detector's configuration surface on the port against the JAX package:
the ROI mask and every nonmax_radius.

On the CPU the kernel wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode, as `tests/test_kernels.py` runs them.  Tolerances:
  - the plain versions of K7 (`fast_harris_nms`), K8 (`fast_harris`), K9
    (`radius_nms`) and K1 (`fast_harris_nms_cells`, masked, and at radius 49
    and 64) equal the Pallas kernels exactly: FAST, Harris and the NMS are
    exact math in both;
  - `detect` / `detect_and_compute` slots (x, y, octave, size, response,
    valid, count) bit-exact, angles within 1e-3 degrees (f32 atan2 ULPs),
    descriptors within int(2e-5 * bytes) + 1 (BAD) and int(1e-4 * bytes) + 1
    (HashSIFT) differing bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu import EfficientFeatures as JEF
from efficient_features_tpu import pipeline as JP
from efficient_features_tpu.ops import pallas_kernels as PK
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch import pipeline as TP
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import detect_kernels as DK
from efficient_features_tpu_torch.samples.sample_common import roi_mask
from efficient_features_tpu_torch.utils import semantics as TS

from test_torch_cuda import (tie_image, tie_mask, tied_responses,
                             wrap_image)
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

IMAGES = {
    "scene": lambda: make_test_image(200, 280, seed=33),
    "odd": lambda: make_test_image(141, 203, seed=8),
    "tie": tie_image,
    "wrap": wrap_image,
}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _random_mask(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).random(shape) < 0.5


def _budget(n_bytes: int, descriptor_type: str) -> int:
    share = 2e-5 if descriptor_type.startswith("bad") else 1e-4
    return int(share * n_bytes) + 1


@pytest.mark.parametrize("which,radius", [
    ("scene", 1), ("scene", 5), ("scene", 9), ("odd", 5), ("tie", 3),
    ("wrap", 1)])
def test_fast_harris_nms_plain_matches_pallas(which, radius):
    img = IMAGES[which]()
    want = np.asarray(PK.fast_harris_nms(jnp.asarray(img), 20, radius))
    got = DK.fast_harris_nms(_t(img), 20, radius)
    assert got.dtype == torch.float32 and tuple(got.shape) == img.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).any()
    if which == "wrap":
        assert np.isfinite(want[24, 32])          # the wrap-run corner


@pytest.mark.parametrize("which", sorted(IMAGES))
def test_fast_harris_plain_matches_pallas(which):
    img = IMAGES[which]()
    want = np.asarray(PK.fast_harris(jnp.asarray(img), 20))
    got = DK.fast_harris(_t(img), 20)
    assert got.dtype == torch.float32 and tuple(got.shape) == img.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("radius", [1, 3, 5, 7, 9, 15, 49])
def test_radius_nms_plain_matches_pallas(radius, masked):
    img = make_test_image(200, 280, seed=33)
    resp = DK.fast_harris(_t(img), 20)
    if masked:
        resp = torch.where(_t(_random_mask(img.shape, radius)), resp,
                           TD.RESP_SENTINEL)
    want = np.asarray(PK.radius_nms(jnp.asarray(resp.numpy()), radius))
    got = DK.radius_nms(resp, radius)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 2


@pytest.mark.parametrize("radius", [1, 5, 9, 15])
def test_radius_nms_plain_matches_pallas_on_tied_responses(radius):
    """A map whose corners take three response levels: tied corners must
    co-survive in both."""
    img = make_test_image(200, 280, seed=33)
    resp = tied_responses(DK.fast_harris(_t(img), 20))
    want = np.asarray(PK.radius_nms(jnp.asarray(resp.numpy()), radius))
    got = DK.radius_nms(resp, radius)
    np.testing.assert_array_equal(got.numpy(), want)
    if radius == 1:         # an empty disc: every corner survives
        np.testing.assert_array_equal(want, np.isfinite(resp.numpy()))
    assert want.sum() > 2


@pytest.mark.parametrize("which,mask_kind", [
    ("scene", "roi"), ("scene", "random"), ("odd", "roi"),
    ("tie", "tie")])
@pytest.mark.parametrize("radius", [10, 15, 22])
def test_masked_cells_plain_matches_pallas(which, mask_kind, radius):
    img = IMAGES[which]()
    h, w = img.shape
    mask = {"roi": lambda: roi_mask(h, w) != 0,
            "random": lambda: _random_mask(img.shape, radius),
            "tie": lambda: tie_mask() != 0}[mask_kind]()
    want = [np.asarray(a)[:-(-h // 8), :w]
            for a in PK.fast_harris_nms_cells(jnp.asarray(img), 20, radius,
                                              jnp.asarray(mask))]
    got = DK.fast_harris_nms_cells(_t(img), 20, radius, _t(mask))
    for g, e in zip(got, want):
        assert tuple(g.shape) == e.shape and g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)
    assert (want[2] > 0).any()
    unmasked = DK.fast_harris_nms_cells(_t(img), 20, radius)
    assert not torch.equal(unmasked[2], got[2])   # the mask changed cells
    everywhere = DK.fast_harris_nms_cells(_t(img), 20, radius,
                                          torch.ones(h, w, dtype=torch.bool))
    for a, b in zip(everywhere, unmasked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("radius", [49, 64])
def test_large_radius_cells_plain_matches_pallas(radius, masked):
    """The cells kernel serves every radius >= 10, as in the JAX package:
    its plain version against the Pallas kernel beyond radius 48."""
    img = IMAGES["scene"]()
    h, w = img.shape
    mask = roi_mask(h, w) != 0 if masked else None
    want = [np.asarray(a)[:-(-h // 8), :w]
            for a in PK.fast_harris_nms_cells(
                jnp.asarray(img), 20, radius,
                None if mask is None else jnp.asarray(mask))]
    got = DK.fast_harris_nms_cells(_t(img), 20, radius,
                                   None if mask is None else _t(mask))
    for g, e in zip(got, want):
        assert tuple(g.shape) == e.shape and g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)
    assert (want[2] > 0).any()


@pytest.mark.parametrize("radius", [1, 2, 10, 15, 17, 48, 64, 128])
def test_disc_segments_cover_the_disc(radius):
    """The segment table the cells kernel scans: every pixel of the open
    disc (dx^2 + dy^2 < radius^2, `disc_row_extents`) exactly once, at most
    a warp's width per segment, rows nearest first, padded with empty
    segments to whole groups."""
    segs = DK.disc_segments(radius)
    assert len(segs) % DK.SEGMENT_GROUP == 0
    seen = set()
    for dy, dx0, dx1, pad in segs:
        assert dx1 - dx0 + 1 <= DK.SEGMENT and pad == 0
        for dx in range(dx0, dx1 + 1):
            assert (dy, dx) not in seen
            seen.add((dy, dx))
    assert seen == {(dy, dx) for dy, wdx in TS.disc_row_extents(radius)
                    for dx in range(-wdx, wdx + 1)}
    assert seen == {(dy, dx) for dy in range(-radius, radius + 1)
                    for dx in range(-radius, radius + 1)
                    if dx * dx + dy * dy < radius * radius}
    rows = [s[0] for s in segs if s[1] <= s[2]]
    assert rows[0] == 0 and [abs(r) for r in rows] == sorted(
        abs(r) for r in rows)


@pytest.mark.parametrize("radius", [10, 49, 64])
def test_detect_level_takes_the_cells_route(radius, monkeypatch):
    """Every nonmax_radius >= 10 goes through the cells wrapper and the
    cell-reduced selection, never through K8 -> K9 and the flat top-k."""
    calls = {"cells": 0, "select": 0}

    def counting(fn, key):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    def forbidden(*args, **kwargs):
        raise AssertionError("a radius >= 10 must not take this route")

    monkeypatch.setattr(DK, "fast_harris_nms_cells",
                        counting(DK.fast_harris_nms_cells, "cells"))
    monkeypatch.setattr(TD, "select_topk_cells",
                        counting(TD.select_topk_cells, "select"))
    for name in ("fast_harris", "fast_harris_nms", "radius_nms"):
        monkeypatch.setattr(DK, name, forbidden)
    monkeypatch.setattr(TD, "select_topk", forbidden)
    cfg = TP.FeatureConfig(nfeatures=300, nonmax_radius=radius,
                           descriptor_type="bad_256")
    img = _t(make_test_image(200, 280, seed=7))
    ys, xs, r, ang, valid = TP._detect_level(img, 100, cfg)
    assert calls == {"cells": 1, "select": 1}
    assert valid.any() and ys.shape == (100,)
    slots = TP.detect(img, cfg, _t(roi_mask(200, 280)))
    assert calls == {"cells": 9, "select": 9} and int(slots["count"]) > 0


@pytest.mark.parametrize("hw", [(200, 280), (141, 203), (97, 301),
                                (1080, 1917)])
def test_mask_pyramid_matches_jax(hw):
    mask = np.random.default_rng(hw[0]).integers(0, 3, hw).astype(np.uint8)
    shapes = tuple(TS.pyramid_shapes(*hw, 1.2, 8))
    want = jax.jit(JP._mask_pyramid, static_argnums=1)(jnp.asarray(mask),
                                                        shapes)
    got = TP._mask_pyramid(_t(mask), shapes)
    assert len(got) == len(want) == 8
    for g, e in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _check_slots(got: dict, want: dict):
    for k in EXACT:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    d = np.abs(got["angle"].numpy() - np.asarray(want["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3


@pytest.mark.parametrize("radius,masked,descriptor_type", [
    (15, True, "hash_sift_256"), (15, True, "bad_256"),
    (5, True, "hash_sift_256"), (49, True, "bad_256"),
    (5, False, "bad_256"), (49, False, "hash_sift_256")])
def test_detect_and_compute_config_matches_jax(radius, masked,
                                               descriptor_type):
    img = make_test_image(200, 280, seed=7)
    mask = roi_mask(200, 280) if masked else None
    cfg = dict(nfeatures=500, nonmax_radius=radius,
               descriptor_type=descriptor_type)
    jcfg = JP.FeatureConfig(**cfg)
    if masked:
        want, jdesc = JP.detect_and_compute_masked_jit(
            jnp.asarray(img), jnp.asarray(mask != 0), jcfg)
    else:
        want, jdesc = JP.detect_and_compute_jit(jnp.asarray(img), jcfg)
    tef = TEF(device="cpu", **cfg)
    kps, desc = tef.detect_and_compute_async(img, mask=mask)
    _check_slots(kps._slots, want)
    assert 0 < kps.count < kps.capacity
    jdesc = np.asarray(jdesc)
    assert desc.numpy().shape == jdesc.shape
    assert (desc.numpy() != jdesc).sum() <= _budget(jdesc.size,
                                                    descriptor_type)
    # detect() selects the same slots, through the API and the pipeline
    det = tef.detect(img, mask=mask)._slots
    mt = None if mask is None else torch.from_numpy(mask)
    for slots in (det, TP.detect(torch.from_numpy(img), tef._cfg, mt)):
        for k in EXACT + ("angle",):
            assert torch.equal(slots[k], kps._slots[k]), k
    if masked:      # level-0 keypoints lie inside the mask
        s = kps._slots
        lvl0 = s["valid"] & (s["octave"] == 0)
        ys, xs = s["y"][lvl0].long(), s["x"][lvl0].long()
        assert lvl0.any() and bool((torch.from_numpy(mask)[ys, xs] != 0)
                                   .all())


def test_masked_tie_fallback_matches_jax():
    """The mask cuts one tied 8x8 block and leaves the other tied: JAX
    takes its dense fallback with the mask, the port selects the tied
    survivors from K1's masked bitmap, and the slots are the same."""
    img, mask = tie_image(), tie_mask()
    cfg = dict(nfeatures=64, nlevels=1, descriptor_type="bad_256")
    want = JP.detect_masked_jit(jnp.asarray(img), jnp.asarray(mask != 0),
                                JP.FeatureConfig(**cfg))
    got = TEF(device="cpu", **cfg).detect(img, mask=mask)._slots
    _check_slots(got, want)
    unmasked = TEF(device="cpu", **cfg).detect(img)._slots
    assert int(got["count"]) == int(unmasked["count"]) - 1 == 3


def test_api_mask_matches_jax():
    img = make_test_image(200, 280, seed=7)
    jef = JEF(nfeatures=400, descriptor_type="bad_256")
    tef = TEF(nfeatures=400, descriptor_type="bad_256", device="cpu")
    full = tef.detect(img, mask=np.full_like(img, 255))._slots
    plain = tef.detect(img)._slots
    for k in EXACT:
        assert torch.equal(full[k], plain[k]), k
    # a torch mask, any nonzero value, equals the same numpy mask
    roi = roi_mask(200, 280)
    a = tef.detect(img, mask=roi)._slots
    b = tef.detect(img, mask=torch.from_numpy((roi != 0) * 7))._slots
    for k in EXACT:
        assert torch.equal(a[k], b[k]), k
    for bad in (np.ones((3, 3), np.uint8), np.ones((280, 200), np.uint8)):
        with pytest.raises(ValueError) as jerr:
            jef.detect(img, mask=bad)
        with pytest.raises(ValueError) as terr:
            tef.detect(img, mask=bad)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError) as terr:
            tef.detect_and_compute(img, mask=torch.from_numpy(bad))
        assert str(terr.value) == str(jerr.value)


def test_new_wrappers_run_the_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    img = _t(make_test_image(96, 128, seed=1))
    mask = _t(_random_mask((96, 128), 1))
    counts = (DK.fast_harris_nms.launches, DK.fast_harris.launches,
              DK.radius_nms.launches, DK.fast_harris_nms_cells.launches)
    assert torch.equal(DK.fast_harris_nms(img, 20, 5),
                       DK.fast_harris_nms_ref(img, 20, 5))
    resp = DK.fast_harris(img, 20)
    assert torch.equal(resp, DK.fast_harris_ref(img, 20))
    assert torch.equal(DK.radius_nms(resp, 64), DK.radius_nms_ref(resp, 64))
    for a, b in zip(DK.fast_harris_nms_cells(img, 20, 15, mask),
                    DK.fast_harris_nms_cells_ref(img, 20, 15, mask)):
        assert torch.equal(a, b)
    assert counts == (DK.fast_harris_nms.launches, DK.fast_harris.launches,
                      DK.radius_nms.launches,
                      DK.fast_harris_nms_cells.launches)
