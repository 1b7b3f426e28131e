"""The `ref4k_hs256` additions: `describe_ms` on a hand-made trace counts
the kernels that HashSIFT's describe sources declare and nothing else, and
reads nothing where they did not run; the configuration and its traffic
differ from `ref4k_bad256`'s `photos` only in the descriptor and its
limit."""
import json
import shutil

import pytest
import torch

from featbench import harness
from featbench import trace as TR
from featbench.metrics import describe_ms as D
from featbench.testutil import tiny_root

ROOT = harness.ROOT
FRAMES = 2
# (profiler name, us) of one step: K4's two kernels, K5, K11
DESCRIBE = [
    ("void (anonymous namespace)::warp_kernel(unsigned char const*, int)",
     7.0),
    ("(anonymous namespace)::trig_kernel(float const*, float*, int)", 1.0),
    ("void (anonymous namespace)::hs_hist_kernel(unsigned char const*)",
     20.0),
    ("void (anonymous namespace)::hs_desc_kernel(unsigned char const*)",
     30.0),
]
# what describe_ms leaves out: torch's ops (one of them with a describe
# kernel's base name), K3's kernels, the projection's GEMM, a copy
OTHERS = [
    ("void at::native::vectorized_elementwise_kernel<4>()", 3.0),
    ("void at::native::(anonymous namespace)::warp_kernel<float>()", 4.0),
    ("void (anonymous namespace)::bad_kernel(unsigned char const*)", 5.0),
    ("void (anonymous namespace)::integral_rows_kernel(int*)", 6.0),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_warpgroup"
     "size1x1x1_execute_segment_k_off_kernel__5x_cublas", 8.0),
]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {}}


def _events(kernels) -> list:
    """Two steps of 100 us, each running `kernels` one after another."""
    ev = []
    for o in (0.0, 100.0):
        ev.append(_x("featbench/step", "user_annotation", o, 100))
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
                           ours=TR.port_kernel_names(D.CSRC))


def test_kernel_names_are_those_the_three_sources_declare(tmp_path):
    for name in D.SOURCES:
        shutil.copy(D.CSRC / name, tmp_path / name)
    names = D.kernel_names()
    assert names == TR.port_kernel_names(tmp_path)
    assert {"warp_kernel", "trig_kernel", "hs_hist_kernel",
            "hs_desc_kernel"} <= names
    # nothing of K3's source, which shares HashSIFT's trig
    k3 = tmp_path / "k3"
    k3.mkdir()
    shutil.copy(D.CSRC / "bad_descriptors.cu", k3)
    assert TR.port_kernel_names(k3) and not names & TR.port_kernel_names(k3)


def test_a_renamed_kernel_is_still_counted(tmp_path):
    for name in D.SOURCES:
        text = (D.CSRC / name).read_text()
        (tmp_path / name).write_text(
            text.replace("hs_hist_kernel", "hs_hist2_kernel"))
    names = D.kernel_names(tmp_path)
    assert "hs_hist2_kernel" in names and "hs_hist_kernel" not in names
    renamed = [(n.replace("hs_hist_kernel", "hs_hist2_kernel"), us)
               for n, us in DESCRIBE]
    got = D.read(_ctx(_events(renamed + OTHERS)), tmp_path)
    assert got == pytest.approx(sum(us for _, us in DESCRIBE) * 1e-3)


def test_reads_exactly_the_describe_kernels():
    got = D.read(_ctx(_events(DESCRIBE + OTHERS)))
    # 58 us a step, a step a frame
    assert got == pytest.approx(58e-3)
    assert D.read(_ctx(_events(DESCRIBE))) == got
    # kernel_ms counts them among the program's; glue_ms takes the GEMM
    ctx = _ctx(_events(DESCRIBE + OTHERS))
    assert harness.reader("kernel_ms")(ctx) == pytest.approx(69e-3)
    assert harness.reader("glue_ms")(ctx) == pytest.approx(
        sum(us for n, us in OTHERS if "at::" in n or "gemm" in n) * 1e-3)


@pytest.mark.parametrize("case", ["no trace", "empty trace",
                                  "no describe kernel", "no frame"])
def test_reads_nothing_where_nothing_matched(case):
    events, frames = {"no trace": (None, FRAMES),
                      "empty trace": ([], FRAMES),
                      "no describe kernel": (_events(OTHERS), FRAMES),
                      "no frame": (_events(DESCRIBE), 0)}[case]
    assert D.read(_ctx(events, frames)) is None


def test_a_traced_cpu_run_reads_no_describe_ms(tmp_path):
    """On the CPU no kernel of the program runs: no 0 is reported."""
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    r = harness.run("tiny_hs.single", 2 ** 31 + 91, 0.3, True, "cpu",
                    root=root)
    assert r["correct"], r["checks"]
    assert "describe_ms" not in r["metrics"]


def _load(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def test_configuration_is_ref4k_bad256_with_hash_sift_256():
    hs = _load("featbench/configs/ref4k_hs256.json")
    bad = _load("featbench/configs/ref4k_bad256.json")
    assert hs["detector"] == {**bad["detector"],
                              "descriptor_type": "hash_sift_256"}
    assert hs["frame"] == bad["frame"]
    # the same library's benchmark, down to the README rows of this deployment
    assert hs["source"].startswith(bad["source"] + "/")
    assert hs["source"] != bad["source"]
    entry = {c["name"]: c for c in _load("BENCHMARK.json")["configs"]}
    assert entry["ref4k_hs256"]["source"] == hs["source"]
    assert hs["reduced"] == hs["assumed"] == []
    assert "1e-4" in hs["guarantees"]["descriptors"]


def test_traffic_is_ref4k_bad256_photos_with_the_hash_sift_limit():
    hs = _load("featbench/traffic/ref4k_hs256.photos.json")
    bad = _load("featbench/traffic/ref4k_bad256.photos.json")
    assert hs["check"]["limits"]["desc_bytes_share"] == 1e-4
    bad["check"]["limits"]["desc_bytes_share"] = 1e-4
    assert hs == bad


def test_cell_loads_with_describe_ms():
    cell = harness.load_cell("ref4k_hs256.photos")
    assert harness.chips("ref4k_hs256.photos") == 1
    assert harness.detector_cfg(cell.config)["descriptor_type"] == \
        "hash_sift_256"
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"describe_ms", "kernel_ms", "glue_ms", "roofline_share",
            "idle_share"} <= per_layer
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frame_ms"}
