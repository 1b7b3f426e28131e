"""The check's control for cells of the `compute` loop: the reference,
put in the program's place and computed in bfloat16, read by the same
numbers and limits as the program.

    python3 featbench/control_compute.py --workload <cell> --seeds 1,2,3 \
        [--dtype bfloat16|float32] [--device cuda]

As `featbench/control.py` does for the other loops: for each seed it makes
the cell's frames as a run does and takes as many steps as a run checks,
drawn from the seed.  Each step's keypoints are the program's `detect`, as
a run makes them, held to the reference's detection as a run's are; the
reference describes the raw frame at them in --dtype, and the check
compares that with the reference in float32.  A
compute loop's stand-in needs the frames themselves, which `control.py`
hands no loop.  It prints one JSON line per seed with the readings and
whether the cell's limits pass them.  Benchmark runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import efficient_features_tpu_torch as api  # noqa: E402
from featbench import check as C  # noqa: E402
from featbench import frames as FR  # noqa: E402
from featbench import harness as HN  # noqa: E402


def readings(workload: str, seed: int, lowp, device: str,
             root: Path = ROOT) -> dict:
    """The worst readings of the control (`lowp`: its dtype, None for
    float32) over the steps a run of the cell checks."""
    cell = HN.load_cell(workload, root)
    conf, traffic = cell.config, cell.traffic
    fr = conf["frame"]
    frames, maps = FR.make_pool(fr["height"], fr["width"], seed,
                                traffic["pool"], traffic["rotate_deg"],
                                traffic["shift_px"], device)
    rng = np.random.default_rng([seed, 2])
    steps = [int(v) for v in rng.integers(1, 10 * len(frames),
                                          traffic["check"]["steps"])]
    Loop = HN.loop_class(traffic["loop"], root)
    feat = api.EfficientFeatures(**HN.detector_cfg(conf), device=device)
    kept = Loop.control_items(feat, frames, steps, conf, device, lowp)
    return HN.check(Loop, kept, frames, maps, conf, traffic, device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lowp = None if args.dtype == "float32" else getattr(torch, args.dtype)
    limits = HN.load_cell(args.workload).traffic["check"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, lowp, args.device)
        ok, table = C.verdict(r, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "passes": ok,
                          "readings": {k: v["value"] for k, v in
                                       table.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
