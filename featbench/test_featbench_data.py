"""The harness is driven by data: a new configuration, traffic, loop and
metric file with their BENCHMARK.json entries are found and run without
an edit to any file that is there; and frames from one seed repeat
exactly."""
import json

import numpy as np
import torch

from featbench import frames as FR
from featbench import harness
from featbench.testutil import tiny_root


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "featbench/configs/tiny.json").read_text())
    conf["frame"] = {"height": 120, "width": 200}
    (root / "featbench/configs/newcfg.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "newcfg", "source": "test",
                             "file": "featbench/configs/newcfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "newcfg.burst", "config": "newcfg",
                               "traffic": "burst", "chips": 1, "why": "t"})
    traffic = json.loads(
        (root / "featbench/traffic/tiny.single.json").read_text())
    traffic["pool"] = 4
    traffic["loop"] = "backwards"
    (root / "featbench/traffic/newcfg.burst.json").write_text(
        json.dumps(traffic))
    (root / "featbench/loops/backwards.py").write_text(
        "from featbench.loops.base import FrameLoop\n\n\n"
        "class Loop(FrameLoop):\n"
        "    def __init__(self, feat, frames, traffic):\n"
        "        self.feat, self.frames = feat, frames\n\n"
        "    def prime(self, k):\n"
        "        pass\n\n"
        "    @classmethod\n"
        "    def step_frames(cls, k, n, traffic):\n"
        "        return [(-k) % n]\n\n"
        "    def step(self, k, sp):\n"
        "        i = self.step_frames(k, len(self.frames), None)[0]\n"
        "        with sp.port('detect_and_compute'):\n"
        "            kps, desc = self.feat.detect_and_compute(\n"
        "                self.frames[i])\n"
        "        return [(i, kps.as_arrays(), desc)]\n")
    (root / "featbench/metrics/frames_per_s.py").write_text(
        "def read(ctx):\n    return ctx.frames_done / ctx.window_s\n")
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["newcfg.burst"]})
    bench["end_to_end"].append({"name": "frame_ms.burst", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["newcfg.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("newcfg.burst", root)
    assert cell.config["frame"]["width"] == 200 and cell.traffic["pool"] == 4
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "frame_ms", "frame_p95_ms", "frames_per_s",
        "frame_ms.burst"]
    assert "frames_per_s" not in [
        m["name"] for m in harness.load_cell("tiny.single", root).end_to_end]
    torch.set_num_threads(2)
    r = harness.run("newcfg.burst", 12, 0.3, False, "cpu", root=root)
    assert r["correct"]
    assert r["metrics"]["frames_per_s"]["unit"] == "1/s"
    assert r["metrics"]["frames_per_s"]["value"] > 0
    # a metric without a file of its own is read by its base name's file
    assert r["metrics"]["frame_ms.burst"]["value"] == \
        r["metrics"]["frame_ms"]["value"]


def test_frames_repeat_for_a_seed_and_move_with_it():
    a, ma = FR.make_pool(128, 192, 2 ** 32 + 3, 4, 3.0, 20.0, "cpu")
    b, mb = FR.make_pool(128, 192, 2 ** 32 + 3, 4, 3.0, 20.0, "cpu")
    c, _ = FR.make_pool(128, 192, 2 ** 32 + 4, 4, 3.0, 20.0, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(ma, mb))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[0].shape == (128, 192)


def test_closed_path_steps_are_alike():
    p = FR.poses(16, 2 ** 31 + 1, 3.0, 20.0)
    steps = [np.subtract(p[(k + 1) % 16], p[k]) for k in range(16)]
    assert max(abs(s[0]) for s in steps) < 1.2
    assert max(max(abs(s[1]), abs(s[2])) for s in steps) < 8.0
    assert max(abs(v[0]) for v in p) <= 3.0
    assert max(max(abs(v[1]), abs(v[2])) for v in p) <= 20.0


def test_pair_homography_follows_the_warp():
    h, w = 64, 96
    maps = [FR.warp_matrix((h, w), *p) for p in [(0.0, 0, 0), (2.0, 5, -3)]]
    H = FR.pair_homography(maps, 0, 1)
    np.testing.assert_allclose(H, maps[1], atol=1e-12)


def test_benchmark_json_holds_together():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, and every per-layer metric's cells report the
    end-to-end metric it moves; each reader and loop file exists."""
    root = harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert harness.applies(e2e[m["moves"]], w["name"]), m["name"]
        assert (root / "featbench/loops" /
                f"{cell.traffic['loop']}.py").exists()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
