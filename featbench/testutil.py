"""A small benchmark tree for the CPU tests: BENCHMARK.json with a
configuration of small frames and one cell per loop, the same frames
described by HashSIFT-256 in a `single` cell, their files, and the
benchmark's loops and metric readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

LIMITS = {"kp_mismatch": 0, "angle_gap_deg": 0.01, "desc_bytes_share": 2e-5}
SEQ_LIMITS = {**LIMITS, "match_mismatch_share": 0.01, "h_corner_px": 4.0,
              "inlier_gap_share": 0.05}
# HashSIFT's descriptor budget is the library's stated 1e-4
HS_LIMITS = {**LIMITS, "desc_bytes_share": 1e-4}
CONFIG = {"name": "tiny", "frame": {"height": 144, "width": 256},
          "detector": {"nfeatures": 400, "scale_factor": 1.2, "nlevels": 8,
                       "first_level": 0, "fast_threshold": 20,
                       "nonmax_radius": 15, "descriptor_type": "bad_256"},
          "assumed": [], "reduced": []}
HS_CONFIG = {**CONFIG, "name": "tiny_hs",
             "detector": {**CONFIG["detector"],
                          "descriptor_type": "hash_sift_256"}}
TRAFFIC = {
    "single": {"loop": "single"},
    "batch": {"loop": "batch", "batch": 4},
    "sequence": {"loop": "sequence",
                 "step": {"max_ratio": 0.8, "ransac_iters": 64,
                          "ransac_thresh": 3.0}},
}
# (configuration, traffic, limits) of each cell
CELLS = [(CONFIG, "single", LIMITS), (CONFIG, "batch", LIMITS),
         (CONFIG, "sequence", SEQ_LIMITS), (HS_CONFIG, "single", HS_LIMITS)]


def tiny_root(tmp: Path, checked: int = 100) -> Path:
    """A tree under tmp with the cells tiny.single, tiny.batch,
    tiny.sequence and tiny_hs.single; every step of a window is checked
    (up to `checked`)."""
    fb = tmp / "featbench"
    (fb / "configs").mkdir(parents=True)
    (fb / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", fb / "metrics")
    shutil.copytree(HERE / "loops", fb / "loops")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = []
    for conf in (CONFIG, HS_CONFIG):
        file = f"featbench/configs/{conf['name']}.json"
        (tmp / file).write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "test",
                                 "file": file, "reduced": [], "why": "test"})
    bench["workloads"] = []
    for conf, kind, limits in CELLS:
        name = f"{conf['name']}.{kind}"
        bench["workloads"].append({"name": name, "config": conf["name"],
                                   "traffic": kind, "chips": 1, "why": "t"})
        traffic = {**TRAFFIC[kind], "pool": 16, "rotate_deg": 3.0,
                   "shift_px": 20.0, "warmup_steps": 1, "trace_steps": 2,
                   "check": {"steps": checked, "limits": limits}}
        (fb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
