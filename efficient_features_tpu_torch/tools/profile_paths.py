"""Where the device time goes on the port's main paths, on one CUDA card.

    python -m efficient_features_tpu_torch.tools.profile_paths [--out FILE]

Runs each path at 2160x3840 with 40000 features, HashSIFT-256:
  - `dac`: `EfficientFeatures.detect_and_compute_async` on the tiled scene
    of `chip_smoke.py` (one 270x480 tile repeated 8x8);
  - `masked`: the same call with `mask=` the ROI of
    `samples.sample_common.roi_mask` (K1 with its mask input);
  - `small_radius`: the same masked call at nonmax_radius 5 (K8, the mask,
    K9, then the flat top-k sort of every level's dense map);
  - `sequence`: one image-sequence step (detect and describe, the masked
    matcher in both directions, RANSAC with 256 iterations), alternating
    between two frames of a rigid warp of 64 different tiles.
For each path: the wall time per call (host clock around CALLS calls that
end in a synchronize, no profiler), the device time per call by kernel
from `torch.profiler` over another CALLS calls, and the device's idle
share, 1 - device time / wall time, and the device time of the sort
kernels (top-k selection).  Prints the TOP kernels by device time and a
JSON summary as the last line; `--out` also writes the summary to a
file.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import torch

H, W = 2160, 3840
NFEATURES = 40000
CALLS = 10
TOP = 16         # kernels listed by name; the rest are summed
NAME = 100       # characters kept of a kernel's name


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile(fn) -> dict:
    """Wall ms per call, device ms per call by kernel name, idle share."""
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / CALLS
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3 / CALLS
    device = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall, "n_kernels": len(ranked),
            "kernels_ms": {k[:NAME]: v for k, v in ranked[:TOP]},
            "other_ms": sum(v for _, v in ranked[TOP:]),
            "sort_ms": sum(v for k, v in ranked if "Sort" in k)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 1
    from efficient_features_tpu_torch import EfficientFeatures
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.samples import \
        sample_image_sequence as SIS

    hw = card()
    dev = torch.device("cuda")
    ef = EfficientFeatures(nfeatures=NFEATURES,
                           descriptor_type="hash_sift_256", device="cuda")
    ef5 = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=5,
                            descriptor_type="hash_sift_256", device="cuda")
    scene = torch.from_numpy(SC.tiled_scene(H, W, 2160, False)).to(dev)
    roi = torch.from_numpy(SC.roi_mask(H, W)).to(dev)
    base = SC.tiled_scene(H, W, 2160, True)
    frames = [torch.from_numpy(SC.warp_image(base, 2.0 * i, 5.0 * i, 1.0))
              .to(dev) for i in range(2)]
    step, _ = SIS.streaming_step_fn(ef._cfg, (H, W), homography=True,
                                    ransac_iters=256, device="cuda")
    order = itertools.cycle(frames)     # each step matches the other frame
    paths = {"dac": lambda: ef.detect_and_compute_async(scene),
             "masked": lambda: ef.detect_and_compute_async(scene, mask=roi),
             "small_radius": lambda: ef5.detect_and_compute_async(scene,
                                                                  mask=roi),
             "sequence": lambda: step(next(order))}
    summary = {"card": hw, "calls": CALLS, "paths": {}}
    for name, fn in paths.items():
        res = profile(fn)
        summary["paths"][name] = res
        print(f"{name}: wall {res['wall_ms']:.3f} ms/call, device "
              f"{res['device_ms']:.3f} ms/call, idle share "
              f"{res['idle_share']:.3f} [{hw}]")
        for k, v in res["kernels_ms"].items():
            print(f"  {v:9.3f} ms  {k}")
        print(f"  {res['other_ms']:9.3f} ms  the other "
              f"{res['n_kernels'] - len(res['kernels_ms'])} kernels")
        print(f"  {res['sort_ms']:9.3f} ms  in sort kernels, all told")
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
