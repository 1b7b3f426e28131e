"""The HashSIFT histogram kernels K5 and K11 on the inputs of one 4K call,
on one CUDA card.

    python efficient_features_tpu_torch/tools/hs_probe.py [--root DIR]
        [--out FILE]

Runs `EfficientFeatures.detect_and_compute` (HashSIFT-256, 2160x3840, 40000
features, radius 15) on the tiled scene of `chip_smoke.py` and records the
keypoints that each of its 8 levels hands to the warp K4.  On those inputs
(case `dac`), and on 40000 random keypoints of sizes 31-300 px on the same
scene, 5% of them invalid (case `random`), it runs the two-stage route (K4,
then the histogram K5 on K4's patches) and the fused K11, and prints per
case: the slots, the all-zero patches (every invalid slot and any patch
that lies off the image), whether K11's rows equal K5's, the sha256 of K5's
rows, and the ms of the case's K5 launches and of its K11 launches, each
kernel alone (`torch.profiler` device time, 10 replays after 3) and through
its wrapper (CUDA events, 20 replays after 3).

`--root DIR` imports the package from DIR (default: the tree this file
lies in), so the same inputs can go through another tree's kernels, and
the digests say whether two trees' K5 rows are the same bytes.  The last
line is a JSON summary; `--out` also writes it to a file.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

H, W = 2160, 3840
NFEATURES = 40000
ITERS = 20
PROFILED = 10


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_ms(fn, kernel: str) -> float:
    """Device ms per call of fn spent in kernels named `kernel`
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages() if kernel in e.key) \
        / 1e3 / PROFILED


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hs_probe: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import efficient_features_tpu_torch as pkg
    from efficient_features_tpu_torch import EfficientFeatures
    from efficient_features_tpu_torch.ops import window_kernels as WK
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.utils import profiler
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise SystemExit(f"hs_probe: imported {pkg.__file__}, not {root}")

    hw = card()
    dev = torch.device("cuda")
    scene = torch.from_numpy(SC.tiled_scene(H, W, 2160, False)).to(dev)
    ef = EfficientFeatures(nfeatures=NFEATURES,
                           descriptor_type="hash_sift_256", device="cuda")
    calls = []
    warp = WK.warp_patches_windows

    def recording(*a, **kw):
        calls.append(a)
        return warp(*a, **kw)

    # the wrapper counts its launches on the name its module binds
    recording.launches = 0
    WK.warp_patches_windows = recording
    try:
        ef.detect_and_compute_async(scene)
    finally:
        WK.warp_patches_windows = warp
    rng = np.random.default_rng(31)
    rand = [torch.from_numpy(a).to(dev) for a in (
        rng.uniform(0, W - 1, NFEATURES).astype(np.float32),
        rng.uniform(0, H - 1, NFEATURES).astype(np.float32),
        rng.uniform(31.0, 300.0, NFEATURES).astype(np.float32),
        rng.uniform(0, 360, NFEATURES).astype(np.float32),
        rng.random(NFEATURES) >= 0.05)]
    cases = {"dac": calls, "random": [(scene, *rand, 1.0)]}

    summary = {"card": hw, "root": str(root), "cases": {},
               "blocks_per_sm": (WK.hs_blocks_per_sm()
                                 if hasattr(WK, "hs_blocks_per_sm")
                                 else None)}
    print(f"blocks of 8 patches per SM (K5, K11): "
          f"{summary['blocks_per_sm']}")
    for name, kp in cases.items():
        patches = [WK.warp_patches_windows(*a) for a in kp]
        rows = [WK.hs_hist_from_patches(p) for p in patches]
        fused = [WK.hs_desc_windows(*a) for a in kp]
        torch.cuda.synchronize()

        def k5(patches=patches):
            return [WK.hs_hist_from_patches(p) for p in patches]

        def k11(kp=kp):
            return [WK.hs_desc_windows(*a) for a in kp]

        res = {
            "launches": len(kp),
            "slots": sum(int(p.shape[0]) for p in patches),
            "empty_patches": sum(int((p == 0).all(dim=1).sum())
                                 for p in patches),
            "k11_equals_k5": all(torch.equal(a, b)
                                 for a, b in zip(rows, fused)),
            "k5_sha256": hashlib.sha256(
                torch.cat(rows).cpu().numpy().tobytes()).hexdigest(),
            "k5_kernel_ms": kernel_ms(k5, "hs_hist_kernel"),
            "k11_kernel_ms": kernel_ms(k11, "hs_desc_kernel"),
            "k5_wrapper_ms": profiler.timeit_ms(k5, ITERS, 3),
            "k11_wrapper_ms": profiler.timeit_ms(k11, ITERS, 3)}
        summary["cases"][name] = res
        print(f"{name}: {res['launches']} launches, {res['slots']} slots, "
              f"{res['empty_patches']} all-zero patches; K11 rows "
              f"{'equal' if res['k11_equals_k5'] else 'DIFFER from'} K5's; "
              f"K5 rows sha256 {res['k5_sha256'][:16]}; kernel alone K5 "
              f"{res['k5_kernel_ms']:.4f} ms, K11 {res['k11_kernel_ms']:.4f} "
              f"ms; through the wrappers K5 {res['k5_wrapper_ms']:.4f} ms, "
              f"K11 {res['k11_wrapper_ms']:.4f} ms [{hw}] ({root})")
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(c["k11_equals_k5"] for c in summary["cases"].values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
