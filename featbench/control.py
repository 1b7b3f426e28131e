"""The check's control: the reference, put in the program's place and
computed in bfloat16, read by the same numbers and limits as the program.

    python3 featbench/control.py --workload <cell> --seeds 1,2,3 \
        [--dtype bfloat16|float32] [--device cuda]

For each seed it makes the cell's frames as a run does, takes as many
frames (steps) as a run checks, drawn from the seed, and computes them with
the reference's float steps (the Harris response, the IC angle, BAD's
affine map and compare) in --dtype; in a sequence cell the matches follow
from those descriptors, and the homography and its inlier count from a
plain RANSAC in the same dtype (the loop's `stand_in`).  It prints one
JSON line per seed with the readings and whether the cell's limits pass
them.  With --dtype float32
the reference stands in for itself: a check of the check.  Benchmark runs
never run this.
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

from featbench import check as C  # noqa: E402
from featbench import frames as FR  # noqa: E402
from featbench import harness as HN  # noqa: E402


def readings(workload: str, seed: int, lowp, device: str,
             root: Path = ROOT) -> dict:
    """The worst readings of the control (`lowp`: its dtype, None for
    float32) over the frames or steps a run of the cell checks."""
    cell = HN.load_cell(workload, root)
    conf, traffic = cell.config, cell.traffic
    fr = conf["frame"]
    frames, maps = FR.make_pool(fr["height"], fr["width"], seed,
                                traffic["pool"], traffic["rotate_deg"],
                                traffic["shift_px"], device)
    n = len(frames)
    rng = np.random.default_rng([seed, 2])
    steps = [int(v) for v in rng.integers(1, 10 * n,
                                          traffic["check"]["steps"])]
    Loop = HN.loop_class(traffic["loop"], root)
    idx = [i for k in steps for i in Loop.step_frames(k, n, traffic)]
    ref = HN.reference_frames(frames, idx, conf, device)
    ctl = HN.reference_frames(frames, idx, conf, device, lowp)
    kept = Loop.stand_in(steps, n, ctl, traffic, device,
                         torch.float32 if lowp is None else lowp)
    return HN.check(Loop, kept, frames, maps, conf, traffic, device, ref)[0]


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
