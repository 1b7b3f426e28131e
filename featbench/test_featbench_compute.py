"""The `ref4k_compute_bad256` additions: the configuration and its traffic
differ from `ref4k_bad256`'s `photos` only in the source, the assumptions,
the loop and the limits; `integral_ms` on a hand-made trace counts K3's
three integral kernels and nothing else, and reads nothing where they did
not run; the `compute` loop's check of the given keypoints, its roofline
stage, its run and its control on the CPU; and the port's standalone BAD
equals the reference's byte for byte on keypoints of every octave."""
import json

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import BAD
from efficient_features_tpu_torch.utils import semantics as TS
from featbench import check as C
from featbench import control_compute
from featbench import harness
from featbench import trace as TR
from featbench.loops import compute as LC
from featbench.metrics import integral_ms as IM
from featbench.reference import features as RF
from featbench.testutil import LIMITS, tiny_root

ROOT = harness.ROOT
CELL = "ref4k_compute_bad256.photos"
FRAMES = 2
COMPUTE_LIMITS = {"given_kp_mismatch": LIMITS["kp_mismatch"],
                  "given_angle_gap_deg": LIMITS["angle_gap_deg"],
                  "kp_mismatch": LIMITS["kp_mismatch"],
                  "desc_bytes_share": LIMITS["desc_bytes_share"]}
# (profiler name, us) of one step: K3's flag and integral passes
INTEGRAL = [
    ("(anonymous namespace)::need_integral_kernel(float const*, int)", 2.0),
    ("(anonymous namespace)::integral_rows_kernel(unsigned char const*)",
     30.0),
    ("(anonymous namespace)::integral_cols_kernel(int, int, int*)", 50.0),
]
# what integral_ms leaves out: K3's compare, a torch op with an integral
# kernel's base name, HashSIFT's kernels, a copy
OTHERS = [
    ("void (anonymous namespace)::bad_kernel(unsigned char const*)", 500.0),
    ("void at::native::(anonymous namespace)::integral_rows_kernel<int>()",
     4.0),
    ("void (anonymous namespace)::warp_kernel(unsigned char const*, int)",
     7.0),
    ("void (anonymous namespace)::hs_hist_kernel(unsigned char const*)",
     20.0),
]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {}}


def _events(kernels) -> list:
    """Two steps of 1000 us, each running `kernels` one after another."""
    ev = []
    for o in (0.0, 1000.0):
        ev.append(_x("featbench/step", "user_annotation", o, 1000))
        t = o + 1
        for name, us in kernels:
            ev.append(_x(name, "kernel", t, us))
            t += us
        ev.append(_x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t, 2))
    return ev


def _ctx(events, frames=FRAMES):
    cell = harness.Cell("t", {}, {}, [], [])
    tr = TR.parse(events) if events is not None else None
    return harness.Context(cell, tr=tr, frames_traced=frames,
                           ours=TR.port_kernel_names(IM.CSRC))


def _load(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def test_configuration_is_ref4k_bad256_with_its_own_source():
    conf = _load("featbench/configs/ref4k_compute_bad256.json")
    bad = _load("featbench/configs/ref4k_bad256.json")
    assert conf["frame"] == bad["frame"]
    # the published detector, FAST 20 included: nothing is cut
    assert conf["detector"] == bad["detector"]
    assert conf["reduced"] == []
    # the README's compute rows, not the repository or another row
    assert conf["source"].startswith(bad["source"] + "/")
    assert conf["source"].endswith("#L60-L62")
    entry = {c["name"]: c for c in _load("BENCHMARK.json")["configs"]}
    assert entry["ref4k_compute_bad256"]["source"] == conf["source"]
    assert entry["ref4k_compute_bad256"]["reduced"] == conf["reduced"]
    # the keypoint count the frames give, short of the published 40000
    assert "40000" in " ".join(conf["assumed"])
    assert "2e-5" in conf["guarantees"]["descriptors"]


def test_traffic_is_ref4k_bad256_photos_with_the_compute_loop():
    traffic = _load(f"featbench/traffic/{CELL}.json")
    photos = _load("featbench/traffic/ref4k_bad256.photos.json")
    assert traffic["loop"] == "compute"
    assert traffic["check"]["limits"] == COMPUTE_LIMITS
    for k in ("pool", "rotate_deg", "shift_px", "warmup_steps",
              "trace_steps"):
        assert traffic[k] == photos[k], k
    assert traffic["check"]["steps"] == photos["check"]["steps"]


def test_cell_loads_with_integral_ms():
    cell = harness.load_cell(CELL)
    assert harness.chips(CELL) == 1
    assert harness.detector_cfg(cell.config)["descriptor_type"] == "bad_256"
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"integral_ms", "kernel_ms", "glue_ms", "roofline_share",
            "idle_share"} <= per_layer
    assert "describe_ms" not in per_layer
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frame_ms"}


def test_kernel_names_are_the_integral_kernels_of_k3_source():
    names = IM.kernel_names()
    assert names == {"need_integral_kernel", "integral_rows_kernel",
                     "integral_cols_kernel"}
    assert names < TR.port_kernel_names(IM.CSRC)


def test_reads_exactly_the_integral_kernels():
    got = IM.read(_ctx(_events(INTEGRAL + OTHERS)))
    # 82 us a step, a step a frame
    assert got == pytest.approx(82e-3)
    assert IM.read(_ctx(_events(INTEGRAL))) == got
    # kernel_ms counts them and the compare among the program's
    ctx = _ctx(_events(INTEGRAL + OTHERS))
    ours = sum(us for n, us in INTEGRAL + OTHERS if "at::" not in n)
    assert harness.reader("kernel_ms")(ctx) == pytest.approx(ours * 1e-3)


@pytest.mark.parametrize("case", ["no trace", "empty trace",
                                  "no integral kernel", "no frame"])
def test_reads_nothing_where_nothing_matched(case):
    events, frames = {"no trace": (None, FRAMES),
                      "empty trace": ([], FRAMES),
                      "no integral kernel": (_events(OTHERS), FRAMES),
                      "no frame": (_events(INTEGRAL), 0)}[case]
    assert IM.read(_ctx(events, frames)) is None


def _detected(n=12):
    """A reference detection's keypoints on 3 octaves, and the given
    array the program's detect would make of them."""
    sizes = LC.octave_sizes(1.2, 8)
    octave = np.repeat(np.arange(3, dtype=np.int32), n // 3)
    ref = {"x": np.arange(n, dtype=np.float32) * 7,
           "y": np.arange(n, dtype=np.float32) * 3,
           "angle": np.linspace(0, 350, n, dtype=np.float32),
           "octave": octave}
    xysa = np.stack([ref["x"], ref["y"], sizes[octave], ref["angle"]], 1)
    return ref, xysa, sizes


def test_octave_sizes_are_the_detectors():
    sizes = LC.octave_sizes(1.2, 8)
    want = [float(s * np.float32(31.0)) for s in TS.pyramid_scales(1.2, 8)]
    assert sizes.dtype == np.float32 and sizes.tolist() == want


@pytest.mark.parametrize("fault", [
    "none", "moved to octave 0", "moved a pixel", "one dropped",
    "one added", "angle turned"])
def test_given_keypoints_are_held_to_the_reference_detection(fault):
    ref, xysa, sizes = _detected()
    xysa = xysa.copy()
    if fault == "moved to octave 0":
        xysa[-4:, 2] = sizes[0]
    elif fault == "moved a pixel":
        xysa[5, 0] += 1
    elif fault == "one dropped":
        xysa = xysa[:-1]
    elif fault == "one added":
        xysa = np.concatenate([xysa, xysa[:1]])
    elif fault == "angle turned":
        xysa[2, 3] += 0.5
    r = LC.given_readings(xysa, ref, sizes)
    ok, _ = C.verdict(r, {k: COMPUTE_LIMITS[k] for k in r})
    assert ok == (fault == "none"), r
    want = {"none": 0, "moved to octave 0": 4, "moved a pixel": 1,
            "one dropped": 1, "one added": 1, "angle turned": 0}[fault]
    assert r["given_kp_mismatch"] == want


def test_describe_stage_counts_the_frame_keypoints_and_rows():
    frame = np.zeros((20, 30), np.uint8)
    xysa = np.zeros((7, 4), np.float32)
    item = LC.Item(0, xysa, np.zeros((7, 32), np.uint8), frame, 256,
                   LC.octave_sizes(1.2, 8))
    conf = {"detector": {"descriptor_type": "bad_256"}}
    stages = LC.Loop.stages(item, {}, conf, {})
    assert list(stages) == ["describe"]
    w = stages["describe"]
    assert w.bytes == 600 + 7 * (16 + 32)
    assert w.f32 == 2 * 600 + 9 * 256 * 7
    assert w.int32 == w.b1 == 0


def _tiny_compute_root(tmp_path):
    """The tiny tree with a `compute` cell on its BAD-256 configuration,
    three steps checked."""
    root = tiny_root(tmp_path, checked=3)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.compute", "config": "tiny",
                               "traffic": "compute", "chips": 1,
                               "why": "t"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads(
        (root / "featbench/traffic/tiny.single.json").read_text())
    traffic["loop"] = "compute"
    traffic["check"]["limits"] = COMPUTE_LIMITS
    (root / "featbench/traffic/tiny.compute.json").write_text(
        json.dumps(traffic))
    return root


@pytest.fixture(scope="module")
def compute_root(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny_compute_root(tmp_path_factory.mktemp("bench"))


def test_a_cpu_run_of_the_compute_loop_is_correct(compute_root):
    r = harness.run("tiny.compute", 2 ** 31 + 57, 0.3, True, "cpu",
                    root=compute_root)
    assert r["correct"], r["checks"]
    for k in ("given_kp_mismatch", "kp_mismatch", "desc_bytes_share"):
        assert r["checks"][k]["value"] == 0, k
    assert r["attempted"] > 0 and r["failed"] == 0
    # on the CPU no kernel of the program runs: no 0 is reported
    assert "integral_ms" not in r["metrics"]


def test_control_fails_and_reference_passes(compute_root):
    limits = COMPUTE_LIMITS
    seed = 2 ** 31 + 3
    low = control_compute.readings("tiny.compute", seed, torch.bfloat16,
                                   "cpu", compute_root)
    ok, table = C.verdict(low, limits)
    assert not ok
    for k in ("given_kp_mismatch", "kp_mismatch"):
        assert table[k]["value"] == 0, k
    assert table["desc_bytes_share"]["value"] > 100 * limits[
        "desc_bytes_share"]
    ok, table = C.verdict(control_compute.readings(
        "tiny.compute", seed, None, "cpu", compute_root), limits)
    assert ok, table


def test_port_bad_equals_the_reference_on_every_octave():
    """A seeded random image; keypoints of every octave size 31 * 1.2^o,
    o = 0..7, on its corners and edges and inside it, angles with and
    without rotation: `BAD(device="cpu").compute` equals
    `features.bad` byte for byte, rows in the caller's order."""
    rng = np.random.default_rng(2 ** 31 + 26)
    h, w = 240, 320
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    sizes = [float(s * np.float32(31.0)) for s in TS.pyramid_scales(1.2, 8)]
    edge = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w / 2, 0.5),
            (0.5, h / 2), (w - 1.5, h / 2), (w / 2, h - 1.5)]
    inner = rng.uniform([0, 0], [w - 1, h - 1], (40, 2))
    xy = np.concatenate([np.float32(edge), np.float32(inner)])
    kp = np.float32([[x, y, s, a] for s in sizes for x, y in xy
                     for a in (-1.0, float(rng.uniform(0, 360)))])
    got = BAD(1.0, 256, device="cpu").compute(img, kp)
    want = RF.bad(torch.from_numpy(img), *torch.from_numpy(kp).T, nbits=256)
    assert got.shape == (len(kp), 32)
    assert np.array_equal(got, want.numpy())
