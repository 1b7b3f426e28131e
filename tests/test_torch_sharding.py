"""The port's mesh forms (`efficient_features_tpu_torch/parallel/sharding.py`)
over 8 gloo ranks on the CPU, against the JAX package.

The twelve cases of tests/test_sharding.py, at its image sizes and seeds,
plus: a 1-rank mesh, a corner on a band edge, the halo and `ranges=` and
row-count errors, and `mesh=` through every API entry with and without
`mask=`.  One job of 8 ranks (`parallel.launch.spmd`, spawned once for the
module) makes every call in `_calls` in order; the 2D case runs on a (2, 4)
mesh of the same ranks.  Every rank must return the same result.

References:
  - the port's own single-device call: slots and descriptors equal byte
    for byte (every case);
  - JAX's own sharded function on the 8-device CPU mesh of
    tests/conftest.py for `detect_rows_sharded`, `compute_sharded` and
    `knn2_match_sharded`;
  - JAX's single-device jit (`detect_and_compute_jit`,
    `detect_and_compute_masked_jit`, `compute_jit`) for the pyramid, API,
    batch and 2D forms, whose 8-device compiles would cost minutes; the
    JAX sharded forms equal it (tests/test_sharding.py); and the NumPy
    oracle for the pyramid detect, as tests/test_sharding.py has it.
Tolerances: slots bit-identical (angles within 1e-3 degrees against JAX);
descriptors within int(2e-5 * bytes) + 1 (BAD) and int(1e-4 * bytes) + 1
(HashSIFT) differing bytes against JAX; the matcher exact.
"""
import functools

import numpy as np
import pytest
import torch

import efficient_features_tpu  # noqa: F401
import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """Keep sharded compiles OUT of the persistent compile cache.

    Serializing multi-device XLA:CPU executables segfaults in this jaxlib
    (observed hard crashes in both compilation_cache.put_executable_and_time
    while caching test_sp_pyramid_sharded_with_descriptors and
    get_executable_and_time while loading test_api_mesh_detect...); every
    other module's single-device executables round-trip fine.

    Merely clearing jax_compilation_cache_dir is NOT enough: jax memoizes
    is_cache_used() after the first compile, so the flag flip must be
    followed by compilation_cache.reset_cache() to take effect.

    jax.clear_caches() drops the full suite's live jitted executables before
    this module's huge 8-device compiles: with hundreds of executables still
    resident, XLA:CPU's backend_compile_and_load segfaults on the first big
    multi-device module (reproduced deterministically at
    test_sp_pyramid_sharded_with_descriptors in full-suite runs, never in
    isolation; unlimited stack does not help — the correlate is live
    compiled-code volume)."""
    from jax._src import compilation_cache as cc

    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs gain nothing from intra-op threads, and in a parallel
    test run the threads of each worker contend with the others' (and with
    the rank processes, which run on one thread each)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


from efficient_features_tpu import pipeline as JP  # noqa: E402
from efficient_features_tpu.cpu import reference as R  # noqa: E402
from efficient_features_tpu.ops import matcher as JM  # noqa: E402
from efficient_features_tpu.parallel import sharding as JSH  # noqa: E402
from efficient_features_tpu_torch import EfficientFeatures as TEF  # noqa: E402
from efficient_features_tpu_torch import pipeline as TP  # noqa: E402
from efficient_features_tpu_torch.ops import detect_kernels as DK  # noqa: E402
from efficient_features_tpu_torch.ops import matcher as TM  # noqa: E402
from efficient_features_tpu_torch.parallel import launch  # noqa: E402

from util import make_test_image  # noqa: E402

RANKS = 8
SH = "efficient_features_tpu_torch.parallel.sharding:"
API = "efficient_features_tpu_torch.parallel.launch:call_api"
M8 = launch.MeshSpec((RANKS,))
M2 = launch.MeshSpec((2,))
M1 = launch.MeshSpec((1,))
M24 = launch.MeshSpec((2, 4))
EXACT = ("x", "y", "octave", "size", "response", "valid", "count")
FEAT = dict(nfeatures=600, nlevels=4, descriptor_type="bad_256")


def _budget(n_bytes: int, descriptor_type: str) -> int:
    share = 2e-5 if descriptor_type.startswith("bad") else 1e-4
    return int(share * n_bytes) + 1


def _cfg(**kw):
    return TP.FeatureConfig(**kw), JP.FeatureConfig(**kw)


def _roi(shape):
    mask = np.zeros(shape, np.uint8)
    mask[64:400, 32:200] = 1
    mask[128:160, :] = 0                      # a hole crossing band borders
    return mask


def _band_edge_image():
    """Flat, with bright squares whose corners lie on rows 39 and 40: the
    last row of band 0 and the first of band 1 at 8 bands of 40 rows.  Near
    columns 100-110 the corners of the two bands are close enough across
    the edge for a disc of radius 15 to reach from one to the other."""
    img = np.full((320, 256), 60, np.uint8)
    img[40:70, 30:60] = 200
    img[10:40, 190:225] = 230
    img[40:70, 100:130] = 200
    img[12:40, 108:140] = 230
    return img


def _keypoint_inputs():
    img = make_test_image(200, 256, seed=150)
    rng = np.random.default_rng(151)
    n = 333                                   # not a mesh multiple
    kp = np.stack([
        rng.uniform(5, 250, n), rng.uniform(5, 195, n),
        rng.uniform(20, 120, n), rng.uniform(-1, 360, n)],
        axis=1).astype(np.float32)
    return img, kp, np.ones(n, bool)


def _bucket_inputs():
    img = make_test_image(256, 320, seed=152)
    cfg, _ = _cfg(nfeatures=900, nlevels=4, descriptor_type="bad_256")
    s = TP.detect(torch.from_numpy(img), cfg)
    kp = torch.stack([s["x"], s["y"], s["size"], s["angle"]], dim=1).numpy()
    ranges = TP.level_slot_ranges(cfg, *img.shape)
    return img, kp, s["valid"].numpy(), ranges


def _match_inputs():
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 256, (7, 64), dtype=np.uint8)  # tie-heavy
    d1 = pool[rng.integers(0, 7, 333)]          # not mesh/tile multiples
    d2 = pool[rng.integers(0, 7, 517)]
    return d1, rng.random(333) > 0.15, d2, rng.random(517) > 0.15


def _calls():
    """name -> (target, args, kwargs) of the rank job."""
    dp_cfg, _ = _cfg(nfeatures=300, nlevels=3, descriptor_type="bad_256")
    dp_images = np.stack([make_test_image(96, 128, seed=100 + i)
                          for i in range(8)])
    pyr_cfg, _ = _cfg(nfeatures=600, nlevels=4)
    img92 = make_test_image(400, 512, seed=92)
    rows15, _ = _cfg(nfeatures=128, fast_threshold=20, nonmax_radius=15)
    rows30, _ = _cfg(nfeatures=64, fast_threshold=20, nonmax_radius=30)
    api_img = make_test_image(512, 256, seed=140)
    mask_img = make_test_image(512, 256, seed=141)
    mask = _roi(mask_img.shape)
    feat = dict(FEAT, device="cpu")
    kimg, kp, kvalid = _keypoint_inputs()
    bimg, bkp, bvalid, branges = _bucket_inputs()
    edge15, _ = _cfg(nfeatures=64, nonmax_radius=15, nlevels=2,
                     descriptor_type="bad_256")
    calls = {
        "dp_batch": (SH + "detect_and_compute_batch",
                     (dp_images, dp_cfg, M8), {}),
        "pyramid": (SH + "detect_pyramid_rows_sharded",
                    (make_test_image(400, 512, seed=91), pyr_cfg, M8), {}),
        "rows_r15": (SH + "detect_rows_sharded",
                     (make_test_image(8 * 40, 256, seed=77), rows15, M8),
                     {"quota": 128}),
        "rows_r30": (SH + "detect_rows_sharded",
                     (make_test_image(8 * 48, 256, seed=78), rows30, M8),
                     {"quota": 64}),
        "batch2d": (SH + "detect_and_compute_batch_2d",
                    (np.stack([make_test_image(512, 256, seed=150 + i)
                               for i in range(4)]),
                     TP.FeatureConfig(**FEAT), M24), {}),
        "match": (SH + "knn2_match_sharded", (*_match_inputs(), M8, 0.8),
                  {}),
        "ranges_error": (SH + "compute_sharded", (bimg, bkp, bvalid, M8),
                         {"kind": "bad", "ranges": ((0, 5, None),)}),
        "halo_error": (SH + "detect_pyramid_rows_sharded",
                       (make_test_image(128, 128, seed=3), pyr_cfg, M8), {}),
        "rows_error": (SH + "detect_rows_sharded",
                       (make_test_image(100, 128, seed=3), rows15, M8), {}),
        "one_rank": (API, ("detect_and_compute_async", feat, api_img),
                     {"mesh": M1}),
        "edge_rows": (SH + "detect_rows_sharded",
                      (_band_edge_image(), edge15, M8), {"quota": 64}),
        "edge_pyramid": (API, ("detect_and_compute_async",
                               dict(nfeatures=64, nlevels=2,
                                    descriptor_type="bad_256",
                                    device="cpu"), _band_edge_image()),
                         {"mesh": M8}),
        "api_batch_host": (API, ("detect_and_compute_batch", dict(
            nfeatures=300, nlevels=3, descriptor_type="bad_256",
            device="cpu"), dp_images[:2]),
            {"mesh": M2, "as_host": True}),
        "api_batch_2d": (API, ("detect_and_compute_batch", feat,
                               np.stack([api_img, mask_img])),
                         {"mesh": launch.MeshSpec((2, 4))}),
    }
    for dt in ("bad_256", "hash_sift_256"):
        cfg, _ = _cfg(nfeatures=400, nlevels=3, descriptor_type=dt)
        calls[f"pyramid_desc_{dt}"] = (SH + "detect_pyramid_rows_sharded",
                                       (img92, cfg, M8),
                                       {"with_descriptors": True})
    for kind in ("bad", "hash_sift"):
        calls[f"compute_{kind}"] = (SH + "compute_sharded",
                                    (kimg, kp, kvalid, M8),
                                    {"nbits": 256, "kind": kind})
        calls[f"compute_ranges_{kind}"] = (SH + "compute_sharded",
                                           (bimg, bkp, bvalid, M8),
                                           {"nbits": 256, "kind": kind,
                                            "ranges": branges})
    for method in ("detect", "detect_async", "detect_and_compute",
                   "detect_and_compute_async"):
        calls[f"api_{method}"] = (API, (method, feat, api_img),
                                  {"mesh": M8})
        calls[f"api_{method}_mask"] = (API, (method, feat, mask_img),
                                       {"mesh": M8, "mask": mask})
    calls["api_detect_and_compute_batch"] = (
        API, ("detect_and_compute_batch", feat,
              np.stack([make_test_image(512, 256, seed=150 + i)
                        for i in range(8)])), {"mesh": M8})
    return calls


@pytest.fixture(scope="module")
def ranks():
    """name -> rank 0's result; every other rank in the mesh returned the
    same (ranks outside a smaller mesh return its error)."""
    calls = _calls()
    per_rank = launch.spmd(RANKS, list(calls.values()), "cpu")
    out = {}
    for j, name in enumerate(calls):
        first = per_rank[0][j]
        for r in range(1, RANKS):
            got = per_rank[r][j]
            if name == "one_rank" or (name == "api_batch_host" and r >= 2):
                assert got[:2] == ("error", "ValueError"), (name, r)
                assert "not in the mesh" in got[2]
                continue
            _same(got, first, f"{name} rank {r}")
        out[name] = first
    return out


def _same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what} {k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for a, b in zip(got, want):
            _same(a, b, what)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _host(slots: dict) -> dict:
    return {k: v.numpy() for k, v in slots.items()}


def _check_jax_slots(got: dict, want: dict, keys=EXACT):
    for k in keys:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    d = np.abs(got["angle"] - np.asarray(want["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3


def _check_jax_desc(got, want, descriptor_type):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (got != want).sum() <= _budget(want.size, descriptor_type)


# -- the twelve cases of tests/test_sharding.py -----------------------------


def test_dp_batch_matches_single_image(ranks):
    slots, descs = ranks["dp_batch"]
    tcfg, jcfg = _cfg(nfeatures=300, nlevels=3, descriptor_type="bad_256")
    for i in range(8):
        img = make_test_image(96, 128, seed=100 + i)
        s1, d1 = TP.detect_and_compute(torch.from_numpy(img), tcfg)
        _same({k: v[i] for k, v in slots.items()}, _host(s1), f"frame {i}")
        np.testing.assert_array_equal(descs[i], d1.numpy())
        js, jd = JP.detect_and_compute_jit(jnp.asarray(img), jcfg)
        assert int(slots["count"][i]) == int(js["count"])
        np.testing.assert_array_equal(slots["x"][i], np.asarray(js["x"]))
        _check_jax_desc(descs[i], jd, "bad_256")


def test_sp_pyramid_sharded_matches_oracle(ranks):
    slots = ranks["pyramid"]
    img = make_test_image(400, 512, seed=91)
    _same(slots, _host(TP.detect(torch.from_numpy(img),
                                 TP.FeatureConfig(nfeatures=600, nlevels=4))),
          "pyramid")
    oracle = R.detect(img, nfeatures=600, nlevels=4)
    m = slots["valid"]
    assert int(slots["count"]) == oracle.count
    np.testing.assert_array_equal(slots["x"][m], oracle.x)
    np.testing.assert_array_equal(slots["y"][m], oracle.y)
    np.testing.assert_array_equal(slots["response"][m], oracle.response)
    np.testing.assert_array_equal(slots["octave"][m], oracle.octave)
    d = np.abs(slots["angle"][m] - oracle.angle)
    assert np.minimum(d, 360 - d).max() < 1e-3


@pytest.mark.parametrize("descriptor_type", ["bad_256", "hash_sift_256"])
def test_sp_pyramid_sharded_with_descriptors(ranks, descriptor_type):
    slots, desc = ranks[f"pyramid_desc_{descriptor_type}"]
    img = make_test_image(400, 512, seed=92)
    tcfg, jcfg = _cfg(nfeatures=400, nlevels=3,
                      descriptor_type=descriptor_type)
    s1, d1 = TP.detect_and_compute(torch.from_numpy(img), tcfg)
    _same((slots, desc), (_host(s1), d1.numpy()), descriptor_type)
    js, jd = JP.detect_and_compute_jit(jnp.asarray(img), jcfg)
    _check_jax_slots(slots, js)
    _check_jax_desc(desc, jd, descriptor_type)


def _check_rows(got, shape, seed, radius, quota):
    """The single-level form against JAX's sharded function and the dense
    oracle."""
    ys, xs, resp, valid = got
    img = make_test_image(*shape, seed=seed)
    _, jcfg = _cfg(nfeatures=quota, fast_threshold=20, nonmax_radius=radius)
    jys, jxs, jresp, jvalid = map(np.asarray, JSH.detect_rows_sharded(
        jnp.asarray(img), jcfg, JSH.make_mesh(8), quota=quota))
    np.testing.assert_array_equal(valid, jvalid)
    n = int(valid.sum())
    np.testing.assert_array_equal(ys[:n], jys[:n])
    np.testing.assert_array_equal(xs[:n], jxs[:n])
    np.testing.assert_array_equal(resp, jresp)
    assert not ys[n:].any() and not xs[n:].any()
    corner = R.fast_corner_mask(img, 20)
    border = np.zeros_like(corner)
    border[15:-15, 15:-15] = True
    rmap = R.harris_response(img)
    eys, exs, er = R.select_topk(rmap, R.radius_nms(rmap, corner & border,
                                                    radius), quota)
    assert n == len(eys)
    np.testing.assert_array_equal(ys[:n], eys)
    np.testing.assert_array_equal(xs[:n], exs)
    np.testing.assert_array_equal(resp[:n], er.astype(np.float32))


def test_sp_rows_sharded_matches_dense(ranks):
    _check_rows(ranks["rows_r15"], (8 * 40, 256), 77, 15, 128)


def test_sp_rows_sharded_large_radius(ranks):
    """Radius 30 reaches past JAX's 24-row halo of old and past the port's
    K8 border: the port's halo is radius + 15 rounded up, 48 rows, as tall
    as a band."""
    _check_rows(ranks["rows_r30"], (8 * 48, 256), 78, 30, 64)


@functools.lru_cache(maxsize=None)
def _jax_api_reference(masked: bool):
    """JAX's single-device jit of the API cases' image, once for the four
    entries that share it."""
    img = make_test_image(512, 256, seed=141 if masked else 140)
    jcfg = JP.FeatureConfig(**FEAT)
    if masked:
        js, jd = JP.detect_and_compute_masked_jit(
            jnp.asarray(img), jnp.asarray(_roi(img.shape)), jcfg)
    else:
        js, jd = JP.detect_and_compute_jit(jnp.asarray(img), jcfg)
    return {k: np.asarray(v) for k, v in js.items()}, np.asarray(jd)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["detect", "detect_async",
                                    "detect_and_compute",
                                    "detect_and_compute_async"])
def test_api_mesh_matches_single_chip(ranks, method, masked):
    """mesh= through every single-image API entry, with and without the
    ROI mask (a hole crossing band borders), equals the call without a mesh
    byte for byte, and JAX's single-device jit."""
    img = make_test_image(512, 256, seed=141 if masked else 140)
    mask = _roi(img.shape) if masked else None
    mesh_out = ranks[f"api_{method}" + ("_mask" if masked else "")]
    single = getattr(TEF(**FEAT, device="cpu"), method)(img, mask)
    js, jd = _jax_api_reference(masked)
    if method.startswith("detect_and_compute"):
        kps, desc = single
        single = ({k: v.numpy() for k, v in kps._slots.items()},
                  desc if isinstance(desc, np.ndarray) else desc.numpy())
        got_slots, got_desc = mesh_out
        if method == "detect_and_compute":     # rows of the valid slots
            jd = jd[js["valid"]]
        _check_jax_desc(got_desc, jd, "bad_256")
    else:
        single = {k: v.numpy() for k, v in single._slots.items()}
        got_slots = mesh_out
    _same(mesh_out, single, method)
    assert int(got_slots["count"]) == int(js["count"]) > 0
    _check_jax_slots(got_slots, js)


def test_batch2d_dp_sp_matches_single_chip(ranks):
    slots, desc = ranks["batch2d"]
    tcfg, jcfg = _cfg(**FEAT)
    for i in range(4):
        img = make_test_image(512, 256, seed=150 + i)
        s1, d1 = TP.detect_and_compute(torch.from_numpy(img), tcfg)
        _same(({k: v[i] for k, v in slots.items()}, desc[i]),
              (_host(s1), d1.numpy()), f"frame {i}")
        js, jd = JP.detect_and_compute_jit(jnp.asarray(img), jcfg)
        _check_jax_slots({k: v[i] for k, v in slots.items()}, js)
        v = np.asarray(js["valid"])
        _check_jax_desc(desc[i][v], np.asarray(jd)[v], "bad_256")


@pytest.mark.parametrize("kind", ["bad", "hash_sift"])
def test_compute_sharded_keypoint_axis(ranks, kind):
    got = ranks[f"compute_{kind}"]
    img, kp, valid = _keypoint_inputs()
    want = TP.compute(torch.from_numpy(img), torch.from_numpy(kp),
                      torch.from_numpy(valid), 256, kind, 1.0)
    np.testing.assert_array_equal(got, want.numpy())
    jgot = np.asarray(JSH.compute_sharded(
        jnp.asarray(img), jnp.asarray(kp), jnp.asarray(valid),
        JSH.make_mesh(8), nbits=256, kind=kind))
    _check_jax_desc(got, jgot, kind + "_256")


@pytest.mark.parametrize("kind", ["bad", "hash_sift"])
def test_compute_sharded_bucketed_matches_single_chip(ranks, kind):
    """ranges= (the detector's level layout): rows in caller order, byte
    for byte `pipeline.compute`; a layout that does not tile [0, N) raises
    JAX's ValueError."""
    got = ranks[f"compute_ranges_{kind}"]
    img, kp, valid, _ = _bucket_inputs()
    want = TP.compute(torch.from_numpy(img), torch.from_numpy(kp),
                      torch.from_numpy(valid), 256, kind, 1.0)
    np.testing.assert_array_equal(got, want.numpy())
    jwant = JP.compute_jit(jnp.asarray(img), jnp.asarray(kp),
                           jnp.asarray(valid), 256, kind, 1.0, False)
    _check_jax_desc(got, jwant, kind + "_256")
    err = ranks["ranges_error"]
    assert err[:2] == ("error", "ValueError")
    assert "ranges must tile [0, " in err[2]


def test_api_batch_as_host_matches_single(ranks):
    """detect_and_compute_batch(mesh=make_mesh(2), as_host=True): per
    frame the KeyPoints slots and compacted descriptors of a single call."""
    out = ranks["api_batch_host"]
    feat = TEF(nfeatures=300, nlevels=3, descriptor_type="bad_256",
               device="cpu")
    assert len(out) == 2
    for i, (slots, desc) in enumerate(out):
        k1, d1 = feat.detect_and_compute(make_test_image(96, 128,
                                                         seed=100 + i))
        _same((slots, desc), (_host(k1._slots), d1), f"frame {i}")


def test_api_batch_meshes_match_single_chip(ranks):
    """detect_and_compute_batch(mesh=) on an 8-rank mesh and on a (2, 4)
    mesh: every frame i equals a single call on images[i]."""
    feat = TEF(**FEAT, device="cpu")
    cases = [("api_detect_and_compute_batch",
              [make_test_image(512, 256, seed=150 + i) for i in range(8)]),
             ("api_batch_2d", [make_test_image(512, 256, seed=140),
                               make_test_image(512, 256, seed=141)])]
    for name, frames in cases:
        slots, desc = ranks[name]
        assert desc.shape[0] == len(frames)
        for i, img in enumerate(frames):
            kps, d1 = feat.detect_and_compute_async(img)
            _same(({k: v[i] for k, v in slots.items()}, desc[i]),
                  (_host(kps._slots), d1.numpy()), f"{name} frame {i}")


def test_knn2_match_sharded_matches_single_chip(ranks):
    """Equal row for row to the port's knn2_ratio_match_masked and to the
    JAX dense masked path (the port's sentinel), and where ok holds to
    JAX's sharded matcher."""
    j, best, ok = ranks["match"]
    d1, v1, d2, v2 = _match_inputs()
    want = TM.knn2_ratio_match_masked(*(torch.from_numpy(a) for a in
                                        (d1, v1, d2, v2)), 0.8)
    _same((j, best, ok), tuple(t.numpy() for t in want), "match")
    jr, br, okr = map(np.asarray, JM.knn2_ratio_match_masked(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
        0.8, fused=False))
    np.testing.assert_array_equal(ok, okr)
    np.testing.assert_array_equal(j, jr)
    np.testing.assert_array_equal(best, br)
    js, bs, oks = map(np.asarray, JSH.knn2_match_sharded(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
        JSH.make_mesh(8), 0.8))
    np.testing.assert_array_equal(ok, oks)
    assert ok.any()
    np.testing.assert_array_equal(j[ok], js[ok])
    np.testing.assert_array_equal(best[ok], bs[ok])


# -- beyond tests/test_sharding.py -------------------------------------------


def test_one_rank_mesh_equals_single_device(ranks):
    """make_mesh(1): rank 0 alone runs every band step (its halos are the
    zero rows of the first and last band) and equals the call without a
    mesh; the other ranks are outside the mesh and say so."""
    slots, desc = ranks["one_rank"]
    kps, d1 = TEF(**FEAT, device="cpu").detect_and_compute_async(
        make_test_image(512, 256, seed=140))
    _same((slots, desc), (_host(kps._slots), d1.numpy()), "one rank")


def test_corner_on_a_band_edge(ranks):
    """Corners on rows 39 and 40, the edge between bands 0 and 1, whose
    NMS discs cross it: kept as the whole image keeps them, on one level
    and through the pyramid."""
    img = _band_edge_image()
    ys, xs, resp, valid = ranks["edge_rows"]
    tcfg, _ = _cfg(nfeatures=64, nonmax_radius=15, nlevels=2,
                   descriptor_type="bad_256")
    want = TP.detect(torch.from_numpy(img), tcfg)
    lvl0 = want["octave"].numpy() == 0
    wv = want["valid"].numpy() & lvl0
    n = int(valid.sum())
    assert n == int(wv.sum())
    np.testing.assert_array_equal(ys[:n], want["y"].numpy()[wv])
    np.testing.assert_array_equal(xs[:n], want["x"].numpy()[wv])
    np.testing.assert_array_equal(resp[:n], want["response"].numpy()[wv])
    edge = ys[:n][(ys[:n] >= 36) & (ys[:n] <= 43)]
    assert (edge < 40).any() and (edge >= 40).any()
    # band 1's corners at rows 40-42 near column 101 lose to band 0's
    # keypoint at (38, 106)
    corners = DK.border_corners(torch.from_numpy(img), 20).numpy()
    assert corners[40:43, 99:104].any()
    near = (ys[:n] >= 40) & (ys[:n] < 43) & (xs[:n] >= 99) & (xs[:n] < 104)
    assert not near.any()
    assert ((ys[:n] == 38) & (xs[:n] == 106)).any()
    slots, desc = ranks["edge_pyramid"]
    kps, d1 = TEF(nfeatures=64, nlevels=2, descriptor_type="bad_256",
                  device="cpu").detect_and_compute_async(img)
    _same((slots, desc), (_host(kps._slots), d1.numpy()), "edge pyramid")


def test_pyramid_halo_error_matches_jax(ranks):
    """Bands shorter than the exchange halo: JAX's check and message."""
    err = ranks["halo_error"]
    assert err[:2] == ("error", "ValueError")
    with pytest.raises(ValueError) as jerr:
        JSH.detect_pyramid_rows_sharded(
            jnp.asarray(make_test_image(128, 128, seed=3)),
            JP.FeatureConfig(nfeatures=600, nlevels=4), JSH.make_mesh(8))
    assert err[2] == str(jerr.value)
    assert "pyramid bands shorter than the exchange halo" in err[2]


def test_rows_must_divide_the_mesh(ranks):
    err = ranks["rows_error"]
    assert err == ("error", "ValueError", "image rows must divide the mesh")
