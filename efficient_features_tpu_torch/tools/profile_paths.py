"""Where the device time goes on the port's main paths, on one CUDA card.

    python -m efficient_features_tpu_torch.tools.profile_paths [--out FILE]
        [--paths dac,dac_bad,...]

Runs each path at 2160x3840 with 40000 features, HashSIFT-256 but for
`dac_bad`:
  - `dac`: `EfficientFeatures.detect_and_compute_async` on the tiled scene
    of `chip_smoke.py` (one 270x480 tile repeated 8x8);
  - `dac_bad`: the same call with BAD-256, the JAX benchmark's headline
    configuration (K3 in place of K4 + K5);
  - `bad_wrapper`: the 8 calls of K3's wrapper (`bad_descriptors_windows`)
    that one `dac_bad` call makes, replayed: how the wrapper's time splits
    into its kernels and torch ops;
  - `bad_wrapper_integral`: the same calls with one 300 px keypoint added
    to each, whose window no warp holds, so that K3 builds each level's
    whole integral (`integral_rows_kernel`, `integral_cols_kernel`): the
    cost of the integral-image design on these levels;
  - `masked`: the same call with `mask=` the ROI of
    `samples.sample_common.roi_mask` (K1 with its mask input);
  - `small_radius`: the same masked call at nonmax_radius 5 (K8, the mask,
    K9, then the flat top-k sort of every level's dense map);
  - `small_radius_nomask`: the `dac` call at nonmax_radius 5 without a mask
    (K7, then the flat top-k sort);
  - `large_radius`: the `dac` call at nonmax_radius 64 (K1, as at every
    radius >= 10);
  - `fused_hs`: the `dac` call with `hs_fused=True` (the pyramid through
    K10 as everywhere, HashSIFT through the fused kernel K11 instead of
    K4 + K5);
  - `batch4`: `detect_and_compute_batch` of 4 frames (the tiled scene and
    three shifted copies), times per call of 4 frames;
  - `sequence`: one image-sequence step (detect and describe, the masked
    matcher in both directions, RANSAC with 256 iterations), alternating
    between two frames of a rigid warp of 64 different tiles.
For each path: the wall time per call (host clock around CALLS calls that
end in a synchronize, no profiler), the device time per call by kernel
from `torch.profiler` over another CALLS calls, and the device's idle
share, 1 - device time / wall time, the device time of the sort kernels
(top-k selection) and that of each of the port's own kernels (csrc/) by
name.  Prints the TOP kernels by device time and a JSON summary as the last
line; `--out` also writes the summary to a file, `--paths` runs only the
paths named.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

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


def port_kernel_names() -> frozenset:
    """Names of the `__global__` functions in csrc/*.cu and *.cuh."""
    pattern = re.compile(
        r"__global__\s+void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\s*\(")
    csrc = Path(__file__).resolve().parent.parent / "csrc"
    return frozenset(name for src in csrc.glob("*.cu*")
                     for name in pattern.findall(src.read_text()))


def port_kernel(name: str, ours: frozenset) -> str | None:
    """The csrc/ kernel that a profiler kernel name stands for, or None.
    The port's kernels all live in an anonymous namespace (so do a few of
    PyTorch's, hence the check against the sources' names)."""
    prefix = "(anonymous namespace)::"
    name = name.removeprefix("void ")
    if not name.startswith(prefix):
        return None
    short = name[len(prefix):].split("(")[0]
    return short if short.split("<")[0] in ours else None


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
    ours = port_kernel_names()
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall, "n_kernels": len(ranked),
            "kernels_ms": {k[:NAME]: v for k, v in ranked[:TOP]},
            "other_ms": sum(v for _, v in ranked[TOP:]),
            "sort_ms": sum(v for k, v in ranked if "Sort" in k),
            "port_kernels_ms": {port_kernel(k, ours): v for k, v in ranked
                                if port_kernel(k, ours)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", default=None,
                    help="comma-separated path names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 1
    from efficient_features_tpu_torch import EfficientFeatures
    from efficient_features_tpu_torch.ops import window_kernels as WK
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.samples import \
        sample_image_sequence as SIS

    hw = card()
    dev = torch.device("cuda")
    ef = EfficientFeatures(nfeatures=NFEATURES,
                           descriptor_type="hash_sift_256", device="cuda")
    ef_bad = EfficientFeatures(nfeatures=NFEATURES, descriptor_type="bad_256",
                               device="cuda")
    ef_fused = EfficientFeatures(nfeatures=NFEATURES,
                                 descriptor_type="hash_sift_256",
                                 device="cuda", hs_fused=True)
    ef5 = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=5,
                            descriptor_type="hash_sift_256", device="cuda")
    ef64 = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=64,
                             descriptor_type="hash_sift_256", device="cuda")
    scene = torch.from_numpy(SC.tiled_scene(H, W, 2160, False)).to(dev)
    roi = torch.from_numpy(SC.roi_mask(H, W)).to(dev)
    batch = torch.stack([torch.roll(scene, (17 * i, 29 * i), (0, 1))
                         for i in range(4)])
    base = SC.tiled_scene(H, W, 2160, True)
    frames = [torch.from_numpy(SC.warp_image(base, 2.0 * i, 5.0 * i, 1.0))
              .to(dev) for i in range(2)]
    step, _ = SIS.streaming_step_fn(ef._cfg, (H, W), homography=True,
                                    ransac_iters=256, device="cuda")
    order = itertools.cycle(frames)     # each step matches the other frame
    paths = {"dac": lambda: ef.detect_and_compute_async(scene),
             "dac_bad": lambda: ef_bad.detect_and_compute_async(scene),
             "masked": lambda: ef.detect_and_compute_async(scene, mask=roi),
             "small_radius": lambda: ef5.detect_and_compute_async(scene,
                                                                  mask=roi),
             "small_radius_nomask": lambda: ef5.detect_and_compute_async(
                 scene),
             "large_radius": lambda: ef64.detect_and_compute_async(scene),
             "fused_hs": lambda: ef_fused.detect_and_compute_async(scene),
             "batch4": lambda: ef.detect_and_compute_batch(batch),
             "sequence": lambda: step(next(order))}
    k3 = WK.bad_descriptors_windows
    k3_calls = []

    def recording(*a, **k):
        k3_calls.append((a, k))
        return k3(*a, **k)

    # the wrapper counts on the function its module name is bound to
    recording.launches = 0
    WK.bad_descriptors_windows = recording
    try:
        ef_bad.detect_and_compute_async(scene)
    finally:
        WK.bad_descriptors_windows = k3
    paths["bad_wrapper"] = lambda: [k3(*a, **k) for a, k in k3_calls]

    def with_big_keypoint(args):
        image, x, y, size, angle, valid, *rest = args
        h, w = image.shape
        one = torch.ones(1, dtype=torch.float32, device=dev)
        return (image, torch.cat([x, one * (w // 2)]),
                torch.cat([y, one * (h // 2)]), torch.cat([size, one * 300]),
                torch.cat([angle, one * -1]),
                torch.cat([valid, torch.ones(1, dtype=torch.bool,
                                             device=dev)]), *rest)

    big_calls = [(with_big_keypoint(a), k) for a, k in k3_calls]
    paths["bad_wrapper_integral"] = lambda: [k3(*a, **k)
                                             for a, k in big_calls]
    if args.paths:
        unknown = set(args.paths.split(",")) - set(paths)
        if unknown:
            ap.error(f"unknown paths {sorted(unknown)}; known: {list(paths)}")
        paths = {k: v for k, v in paths.items()
                 if k in args.paths.split(",")}
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
        print("  the port's kernels: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["port_kernels_ms"].items()))
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
