"""Where the pyramid resize K10's time goes, level by level, on one CUDA card.

    python -m efficient_features_tpu_torch.tools.resize_probe [--out FILE]

K10 (`csrc/resize_u8.cu`, through `ops.image.resize_u8_kernel`) runs the
7 resizes of one pyramid, each level from the one before.
`resize_probe.cu`, beside this file and built by it into a library of its
own, holds the first design of K10 and two cuts of it: `flat` (a thread
per 4 pixels of the flattened destination, six table entries and four
source bytes a pixel from device memory), `flat_no_pixel` (the pixel fetch
replaced by a constant) and `flat_floor` (no load at all: what the 7
launches cost with nothing to read).

Three pyramids at scale factor 1.2, 8 levels: 2160x3840 (the tiled scene of
`chip_smoke.py`), 4320x7680 and 1080x1920 (the same generator's tiles).
For each pyramid, variant and level: device ms of the one launch from
`torch.profiler` over REPS replays of the pyramid's 7 launches after 3, and
whether the bytes of `flat` equal K10's.
Prints one line per pyramid and variant, with the card's name and power
limit, and a JSON summary as the last line.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from efficient_features_tpu_torch.tools import profile_paths as PP

PYRAMIDS = {"4k": (2160, 3840), "8k": (4320, 7680), "fhd": (1080, 1920)}
SCALE, NLEVELS = 1.2, 8
REPS = 20
VARIANTS = ("flat", "flat_no_pixel", "flat_floor")
EXACT = ("flat",)     # K10's bytes


def per_launch_ms(fn, name: str, n: int) -> list[float]:
    """Device ms of each of the n launches of kernels named `name` that one
    call of fn makes, in launch order, averaged over REPS calls after 3
    (`profile_paths.launches_ms`).  A trace that lost a launch's record is
    taken again, twice at most."""
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ms = PP.launches_ms(prof.events(), name, REPS)
        if ms is not None and len(ms) == n:
            return ms
    raise RuntimeError(f"the traces of {name} did not hold {n} launches a "
                       "call")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resize_probe: CUDA is not available", file=sys.stderr)
        return 1
    from efficient_features_tpu_torch import _build
    from efficient_features_tpu_torch.ops import image as I
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.utils import semantics as S

    hw = PP.card()
    dev = torch.device("cuda")
    lib = _build.tool_library(Path(__file__).resolve().parent
                              / "resize_probe.cu")
    P, N = ctypes.c_void_p, ctypes.c_int
    lib.resize_probe.argtypes = [N, P, N, N, P, P, P, N, N, P]
    lib.resize_probe.restype = N

    def table(dst_n, src_n):
        return torch.from_numpy(np.stack(
            [a.astype(np.int32) for a in S.resize_axis_coeffs(dst_n, src_n)])
        ).to(dev)

    summary = {"card": hw, "reps": REPS, "pyramids": {}}
    for label, (h, w) in PYRAMIDS.items():
        scene = torch.from_numpy(SC.tiled_scene(h, w, 2160, False)).to(dev)
        levels = I.build_pyramid(scene, SCALE, NLEVELS)
        steps = [(levels[s - 1], tuple(levels[s].shape))
                 for s in range(1, NLEVELS)]
        tabs = [(table(d[0], s.shape[0]), table(d[1], s.shape[1]))
                for s, d in steps]
        outs = [torch.empty(d, dtype=torch.uint8, device=dev)
                for _, d in steps]

        def run(variant):
            for (src, (dh, dw)), tab, out in zip(steps, tabs, outs):
                _build.check(lib.resize_probe(
                    variant, src.data_ptr(), src.shape[0], src.shape[1],
                    *(t.data_ptr() for t in tab), out.data_ptr(), dh, dw,
                    torch.cuda.current_stream().cuda_stream), "resize_probe")

        def k10():
            for src, d in steps:
                I.resize_u8_kernel(src, d)

        res = {"levels": [list(d) for _, d in steps],
               "K10": per_launch_ms(k10, "resize_kernel", NLEVELS - 1)}
        differ = []
        for variant, name in enumerate(VARIANTS):
            for out in outs:
                out.zero_()
            run(variant)
            torch.cuda.synchronize()
            if name in EXACT and not all(
                    torch.equal(o, lv) for o, lv in zip(outs, levels[1:])):
                differ.append(name)
            res[name] = per_launch_ms(lambda: run(variant),
                                      "resize_flat_kernel", NLEVELS - 1)
        summary["pyramids"][label] = res
        print(f"{label} {h}x{w}, levels {res['levels']}: bytes of "
              f"{', '.join(EXACT)} equal K10's [{hw}]")
        for name in ("K10",) + VARIANTS:
            ms = res[name]
            print(f"  {name:16s} {sum(ms):.4f} ms for {len(ms)} launches: "
                  + " ".join(f"{t:.4f}" for t in ms))
        if differ:
            print(f"resize_probe: {differ} differ from K10", file=sys.stderr)
            return 1
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
