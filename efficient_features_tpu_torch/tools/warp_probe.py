"""Where the HashSIFT warp K4's time goes, on one CUDA card.

    python -m efficient_features_tpu_torch.tools.warp_probe [--out FILE]

K4 (`csrc/warp_patches.cu`) runs a 256-thread block per keypoint and
samples a keypoint whose window fits from that window staged in shared
memory.  `warp_probe.cu`, beside this file and built by it into a library
of its own, holds the shapes it was chosen against, each through the same
`hs::sample_word`: `block_direct` (K4's shape, every sample read from the
image, as the first design), `warp_direct` (a warp per keypoint, 8 to a
block, reading the image), `warp_staged` (a warp per keypoint with the
window staged by funnel shifts) and `floor` (`warp_direct` with the pixel
fetch replaced by a constant: what is left without any load).

Two cases: `dac`, the 8 launches of one `detect_and_compute` call
(HashSIFT-256, 2160x3840, 40000 features, radius 15) on the tiled scene of
`chip_smoke.py`, recorded from the call; `compute`, one launch on 40000
keypoints of 31-300 px (half on the 31 * 1.2^k / 300 px ladder, every 97th
unrotated) on the raw scene, as `profile_paths`' `compute_hs`.  For each
case and shape: device ms from `torch.profiler` over REPS replays after 3,
and whether the bytes equal K4's.  Prints one line per time, with the
card's name and power limit, and a JSON summary as the last line.  Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

H, W = 2160, 3840
NFEATURES = 40000
REPS = 10
SHAPES = ("block_direct", "warp_direct", "warp_staged", "floor")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, names) -> float:
    """Device ms per call of fn, summed over the kernels whose name holds
    one of `names` (torch.profiler, REPS calls after 3)."""
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                any(n in e.key for n in names):
            total += t
    return total / 1e3 / REPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("warp_probe: CUDA is not available", file=sys.stderr)
        return 1
    from efficient_features_tpu_torch import EfficientFeatures, _build
    from efficient_features_tpu_torch.ops import window_kernels as WK
    from efficient_features_tpu_torch.samples import sample_common as SC

    hw = card()
    dev = torch.device("cuda")
    lib = _build.tool_library(Path(__file__).resolve().parent
                              / "warp_probe.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.warp_probe.argtypes = [I, P, I, I, P, P, P, P, P, I, ctypes.c_float,
                               P, P]
    lib.warp_probe.restype = I

    scene = torch.from_numpy(SC.tiled_scene(H, W, 2160, False)).to(dev)
    dac_calls = []
    k4 = WK.warp_patches_windows

    def recording(*a):
        dac_calls.append(a)
        return k4(*a)

    # the wrapper counts on the function its module name is bound to
    recording.launches = 0
    WK.warp_patches_windows = recording
    try:
        EfficientFeatures(nfeatures=NFEATURES,
                          descriptor_type="hash_sift_256",
                          device="cuda").detect_and_compute_async(scene)
    finally:
        WK.warp_patches_windows = k4
    rng = np.random.default_rng(40000)
    ladder = np.float32([31.0 * 1.2 ** k for k in range(8)] + [300.0])
    kps = np.stack([rng.uniform(0, W - 1, NFEATURES),
                    rng.uniform(0, H - 1, NFEATURES),
                    rng.uniform(31.0, 300.0, NFEATURES),
                    rng.uniform(0, 360, NFEATURES)]).astype(np.float32)
    kps[2, ::2] = ladder[np.arange(NFEATURES)[::2] % len(ladder)]
    kps[3, ::97] = -1.0
    kt = torch.from_numpy(kps).to(dev)
    compute_calls = [(scene, *kt, torch.ones(NFEATURES, dtype=torch.bool,
                                             device=dev), 1.0)]

    def run(variant, calls):
        outs = []
        for image, x, y, size, angle, valid, scale in calls:
            out = torch.empty((x.shape[0], 1024), dtype=torch.uint8,
                              device=dev)
            _build.check(lib.warp_probe(
                variant, image.data_ptr(), image.shape[0], image.shape[1],
                x.data_ptr(), y.data_ptr(), size.data_ptr(),
                angle.data_ptr(), valid.view(torch.uint8).data_ptr(),
                x.shape[0], scale, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "warp_probe")
            outs.append(out)
        return outs

    summary = {"card": hw, "reps": REPS, "cases": {}}
    for case, calls in (("dac", dac_calls), ("compute", compute_calls)):
        want = [k4(*c) for c in calls]
        res = {"K4": device_ms(lambda: [k4(*c) for c in calls],
                               ["warp_kernel"])}
        print(f"{case}: {len(calls)} launches, K4 {res['K4']:.4f} ms [{hw}]")
        for variant, name in enumerate(SHAPES):
            same = all(torch.equal(a, b)
                       for a, b in zip(run(variant, calls), want))
            res[name] = device_ms(lambda: run(variant, calls),
                                  ["block_direct", "warp_variant"])
            print(f"{case}: {name} {res[name]:.4f} ms, bytes "
                  f"{'equal to' if same else 'differ from'} K4's [{hw}]")
            if same == (name == "floor"):
                print(f"warp_probe: {name} bytes {'equal' if same else 'differ'}"
                      " unexpectedly", file=sys.stderr)
                return 1
        summary["cases"][case] = res
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
