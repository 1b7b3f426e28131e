"""The port's `select_topk`, `utils/profiler.py` and `orientation.ic_angles`
against the JAX package, on the CPU.

JAX's `select_topk` picks a branch by the shape and `nms_radius`: the 8x8
block-reduced selection (nms_radius >= 10), the chunked two-stage top-k
(`chunked`) and its NMS-sparsity cap with a per-chunk count check (`capped`,
which falls back to the flat form when ties overflow the cap), or the flat
form.  Every branch is exact, and the port's one stable sort, which takes
no radius, selects the same.  So the tolerance is zero: on inputs that
send JAX down each branch and each fallback, ys, xs, resp and valid equal
JAX's `select_topk`.
Through the pipeline: `detect` at radius 5 (JAX's level 0 takes the capped
branch) against JAX's `detect_jit`, and a 1-rank gloo `detect(mesh=)` at
radius 15 (JAX's bands take the reduced branch) against the single-device
call.  `ic_angles` against JAX's within 1e-3 degrees circular (f32 atan2
ULPs), and bit for bit against the IC kernel's plain version.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from efficient_features_tpu import pipeline as JP
from efficient_features_tpu.ops import detect as JD
from efficient_features_tpu.ops import orientation as JO
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch.ops import detect as TD
from efficient_features_tpu_torch.ops import matcher as TM
from efficient_features_tpu_torch.ops import orientation as TO
from efficient_features_tpu_torch.ops import window_kernels as WK
from efficient_features_tpu_torch.parallel import sharding as SH
from efficient_features_tpu_torch.utils import profiler

from test_torch_cuda import ic_keypoints
from util import make_test_image

EXACT = ("x", "y", "octave", "size", "response", "valid", "count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs gain nothing from intra-op threads, which contend with
    the other workers of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _check(resp, surv, quota, radius):
    """The port's select_topk equals JAX's at `radius`, whichever branch
    the radius picks there."""
    want = JD.select_topk(jnp.asarray(resp), jnp.asarray(surv), quota,
                          nms_radius=radius)
    got = TD.select_topk(_t(resp), _t(surv), quota)
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)
    return got


def _sparse(h, w, seed, share):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w)).astype(np.float32),
            rng.random((h, w)) < share)


def _tied_everywhere(h, w):
    """Every pixel survives with one of two tied responses: each chunk's
    count overflows the cap."""
    resp = np.where((np.arange(h * w) % 3 == 0).reshape(h, w),
                    np.float32(2.0), np.float32(1.0))
    return resp, np.ones((h, w), bool)


def _nms_spaced(h, w, seed):
    """Survivors on a 16 px grid: at most one per 8x8 block."""
    rng = np.random.default_rng(seed)
    resp = rng.standard_normal((h, w)).astype(np.float32)
    surv = np.zeros((h, w), bool)
    surv[rng.integers(0, h // 16, 300) * 16,
         rng.integers(0, w // 16, 300) * 16] = True
    return resp, surv


def test_topk_capped_path_exact():
    """tests/test_parity.py's capped case: quota > a quarter chunk sends JAX
    to the NMS-sparsity cap; sparse survivors fit it, tied everywhere makes
    it fall back."""
    _check(*_sparse(384, 1024, 11, 0.01), 16384, 15)
    got = _check(*_tied_everywhere(384, 1024), 16384, 15)
    assert bool(got[3].all())


def test_topk_block_reduced_path_exact():
    """tests/test_parity.py's reduced case: NMS-spaced survivors, then two
    tied co-survivors inside one 8x8 block, which make JAX fall back."""
    resp, surv = _nms_spaced(512, 1024, 21)
    _check(resp, surv, 256, 15)
    surv[100, 200] = surv[102, 203] = True
    resp[100, 200] = resp[102, 203] = np.float32(7.25)
    _check(resp, surv, 256, 15)


@pytest.mark.parametrize("case", [
    "chunked",                    # JAX: quota <= a quarter chunk
    "chunked, no radius",         # JAX: chunked
    "large quota, no radius",     # JAX: flat, no cap without a radius
    "reduced, mixed-sign zeros",  # JAX: reduced
    "capped, mixed-sign zeros",   # JAX: capped
    "reduced quota too large",    # JAX: chunked
    "wide rows",                  # JAX: flat, w > 16384 (no chunk of rows)
    "small map"])                 # JAX: flat
def test_topk_branch_conditions(case):
    """Each branch condition of the JAX function, on maps whose ties (value
    ties, -0.0 against +0.0) would show an unstable or total-order sort."""
    rng = np.random.default_rng(len(case))
    h, w, quota, radius = {
        "chunked": (384, 1024, 2000, 5),
        "chunked, no radius": (384, 1024, 2000, None),
        "large quota, no radius": (384, 1024, 16384, None),
        "reduced, mixed-sign zeros": (512, 1024, 500, 12),
        "capped, mixed-sign zeros": (400, 700, 12000, 5),
        "reduced quota too large": (512, 520, 5000, 30),
        "wide rows": (16, 16500, 300, 5),
        "small map": (100, 300, 500, 15)}[case]
    resp = rng.choice(np.array([1.5, 0.25, 0.0, -0.0, -1.0], np.float32),
                      size=(h, w))
    if "reduced" in case:
        resp, surv = _nms_spaced(h, w, h + w)
        resp[surv] = rng.choice(np.array([0.0, -0.0, 0.5], np.float32),
                                int(surv.sum()))
    else:
        surv = rng.random((h, w)) < 0.05
    got = _check(resp, surv, quota, radius)
    assert not bool(((got[2] == 0) & torch.signbit(got[2])).any())


def test_topk_strategies_fuzz():
    """tests/test_parity.py's fuzz: random shapes, quantised responses and
    survivor shares, every radius, against JAX and the flat form."""
    rng = np.random.default_rng(33)
    for trial in range(6):
        h, w = int(rng.integers(64, 600)), int(rng.integers(128, 1100))
        resp = np.round(rng.standard_normal((h, w)).astype(np.float32) * 4) / 4
        surv = rng.random((h, w)) < rng.uniform(0.001, 0.05)
        quota = int(rng.integers(16, 3000))
        _check(resp, surv, quota, [None, 5, 12, 15, 30][trial % 5])


def test_detect_capped_level_matches_jax():
    """detect at radius 5, 384x512, 20000 features, 2 levels: K7's plain
    version and the port's sort, equal to JAX's detect_jit, whose level 0
    takes the capped branch (quota 10909 against a quarter chunk of
    8192)."""
    img = make_test_image(384, 512, seed=12)
    cfg = dict(nfeatures=20000, nlevels=2, nonmax_radius=5,
               descriptor_type="bad_256")
    want = JP.detect_jit(jnp.asarray(img), JP.FeatureConfig(**cfg))
    got = TEF(device="cpu", **cfg).detect(img)._slots
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    d = np.abs(got["angle"].numpy() - np.asarray(want["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3
    assert int(got["count"]) > 0


def test_one_rank_gloo_mesh_takes_the_reduced_branch(tmp_path):
    """detect(mesh=) on a 1-rank gloo group at 512x640, radius 15: the band
    route (K8, K9 plain, `select_topk` with the radius, where JAX's level 0
    takes the reduced branch), equal to the single-device call (the cells
    route) bit for bit."""
    img = make_test_image(512, 640, seed=64)
    feat = TEF(nfeatures=3000, device="cpu")
    want = feat.detect(img)._slots
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = feat.detect(img, mesh=SH.make_mesh())._slots
    finally:
        dist.destroy_process_group()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(got["count"]) > 0


def test_profiler_timeit_and_force_completion():
    d = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (300, 32), dtype=np.uint8))
    calls = []

    def fn():
        calls.append(1)
        return TM.knn2_topk2(d, None, d, None)

    assert profiler.timeit_ms(fn, iters=3, warmup=2) > 0
    assert len(calls) == 5
    kps = TEF(nfeatures=200, device="cpu").detect_async(
        make_test_image(120, 160, seed=5))
    for out in (kps, {"a": [(kps, torch.ones(3))]}, [torch.empty(0)]):
        profiler.force_completion(out)
    with pytest.raises(ValueError):
        profiler.force_completion({"a": [None, 3]})


def test_profiler_trace_holds_the_annotation(tmp_path):
    img = torch.from_numpy(make_test_image(96, 128, seed=1))
    with profiler.trace(str(tmp_path)) as logdir:
        assert logdir == str(tmp_path)
        with profiler.annotate("eff_select_topk_range"):
            WK.ic_angles_windows(img, torch.tensor([40], dtype=torch.int32),
                                 torch.tensor([50], dtype=torch.int32),
                                 torch.tensor([True]))
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "eff_select_topk_range" for e in events)


def test_ic_angles_matches_jax_and_the_kernels_plain_version():
    """Interior and edge keypoints and invalid slots (test_torch_cuda's
    `ic_keypoints`): within 1e-3 degrees of JAX's gather form, 0 where
    invalid, and bit for bit `ic_angles_windows_ref`."""
    img = make_test_image(150, 230, seed=29)
    ys, xs, valid = ic_keypoints(150, 230, 400, 7)
    want = np.asarray(JO.ic_angles(jnp.asarray(img), jnp.asarray(ys),
                                   jnp.asarray(xs), jnp.asarray(valid)))
    got = TO.ic_angles(_t(img), _t(ys), _t(xs), _t(valid))
    assert got.dtype == torch.float32 and got.shape == (400,)
    d = np.abs(got.numpy() - want)
    assert np.minimum(d, 360 - d).max() < 1e-3
    assert (got.numpy()[~valid] == 0).all() and (got.numpy()[valid] != 0).any()
    assert torch.equal(got, WK.ic_angles_windows_ref(_t(img), _t(ys), _t(xs),
                                                     _t(valid)))
