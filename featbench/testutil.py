"""A small benchmark tree for the CPU tests: BENCHMARK.json with one
configuration of small frames and one cell per loop, their files, and the
benchmark's loops and metric readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

LIMITS = {"kp_mismatch": 0, "angle_gap_deg": 0.01, "desc_bytes_share": 2e-5}
SEQ_LIMITS = {**LIMITS, "match_mismatch_share": 0.01, "h_corner_px": 4.0,
              "inlier_gap_share": 0.05}
CONFIG = {"name": "tiny", "frame": {"height": 144, "width": 256},
          "detector": {"nfeatures": 400, "scale_factor": 1.2, "nlevels": 8,
                       "first_level": 0, "fast_threshold": 20,
                       "nonmax_radius": 15, "descriptor_type": "bad_256"},
          "assumed": [], "reduced": []}
TRAFFIC = {
    "single": {"loop": "single"},
    "batch": {"loop": "batch", "batch": 4},
    "sequence": {"loop": "sequence",
                 "step": {"max_ratio": 0.8, "ransac_iters": 64,
                          "ransac_thresh": 3.0}},
}


def tiny_root(tmp: Path, checked: int = 100) -> Path:
    """A tree under tmp with the cells tiny.single, tiny.batch and
    tiny.sequence; every step of a window is checked (up to `checked`)."""
    fb = tmp / "featbench"
    (fb / "configs").mkdir(parents=True)
    (fb / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", fb / "metrics")
    shutil.copytree(HERE / "loops", fb / "loops")
    (fb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "featbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for kind, t in TRAFFIC.items():
        name = f"tiny.{kind}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": kind, "chips": 1, "why": "t"})
        traffic = {**t, "pool": 16, "rotate_deg": 3.0, "shift_px": 20.0,
                   "warmup_steps": 1, "trace_steps": 2,
                   "check": {"steps": checked,
                             "limits": SEQ_LIMITS if kind == "sequence"
                             else LIMITS}}
        (fb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
