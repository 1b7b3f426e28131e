"""Where the device time goes on the port's main paths, on one CUDA card.

    python efficient_features_tpu_torch/tools/profile_paths.py [--out FILE]
        [--paths dac,dac_bad,...] [--root DIR]

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
  - `cells_wrapper`: the 8 calls of K13's wrapper (`select_cells`) that
    one `dac` call makes, replayed: the selection alone, host and device;
  - `masked`: the same call with `mask=` the ROI of
    `samples.sample_common.roi_mask` (K1 with its mask input);
  - `small_radius`: the same masked call at nonmax_radius 5 (K8, the mask,
    K9, then `select_topk` on every level's dense map);
  - `small_radius_nomask`: the `dac` call at nonmax_radius 5 without a mask
    (K7, then `select_topk`);
  - `mesh_dac`: the `dac` call with `mesh=` a 1-rank NCCL group made in
    this process (the band route: K10, K8, K9, then `select_topk` on each
    band);
  - `large_radius`: the `dac` call at nonmax_radius 64 (K1, as at every
    radius >= 10);
  - `dac_equal`: the `dac` call on `equal_image` (a bright pixel every 6 px,
    every corner of one response): every 8x8 block of level 0 inside K1's
    border is live and ties with every other, the selection's worst case;
  - `fused_hs`: the `dac` call with `hs_fused=True` (the pyramid through
    K10 as everywhere, HashSIFT through the fused kernel K11 instead of
    K4 + K5);
  - `batch4`: `detect_and_compute_batch` of 4 frames (the tiled scene and
    three shifted copies), times per call of 4 frames;
  - `sequence`: one image-sequence step (detect and describe, the masked
    matcher in both directions, RANSAC with 256 iterations), alternating
    between two frames of a rigid warp of 64 different tiles;
  - `ransac`: `find_homography_ransac` with 512 iterations on the masked
    matcher's matches between those two frames (40000 slots);
  - `compute_hs`, `compute_bad`: standalone `HashSIFT(1.0, 256).compute`
    (K4 + K5) and `BAD(1.0, 256).compute` (K3) of 40000 keypoints of
    31-300 px (half of them on the 31 * 1.2^k / 300 px ladder, every 97th
    unrotated) on the raw tiled scene.
The port's own kernels are reported by name, the IC kernel (`ic_kernel`,
K2) and the warp (`warp_kernel`, K4) among them.
For each path: the wall time per call (host clock around CALLS calls that
end in a synchronize, no profiler) and the part of it before that
synchronize (the host's enqueue time; equal to the wall where a call reads
back), the device time per call by kernel from `torch.profiler` over
another CALLS calls and the kernel launches per call (memsets among them),
the peak allocation on the card of one call (`max_memory_allocated` above
what was allocated before it), the device time of the sort kernels (top-k selection) and that
of each of the port's own kernels (csrc/) by name, the device time of each
launch of K10 (`resize_kernel`, the pyramid's 7 levels, in launch order,
averaged over the calls), and the
host syncs of one call (torch's sync debug mode).  Prints the TOP kernels
by device time and a JSON summary as the last line; `--out` also writes
the summary to a file, `--paths` runs only the paths named.  `--root DIR`
imports the package from DIR (default: the tree this file lies in), so
that another tree (a parent unpacked with `git archive`) runs the same
paths in the same call; the helpers of `tools/oncard.py` come from DIR
too, so DIR must hold that module.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H, W = 2160, 3840
NFEATURES = 40000
CALLS = 10
TOP = 16         # kernels listed by name; the rest are summed
NAME = 100       # characters kept of a kernel's name
RESIZE = "resize_kernel"    # K10's kernel, listed launch by launch


def port_kernel_names(csrc: Path) -> frozenset:
    """Names of the `__global__` functions in csrc/*.cu and *.cuh."""
    pattern = re.compile(
        r"__global__\s+void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\s*\(")
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


def launches_ms(events, name: str, calls: int) -> list[float] | None:
    """Device ms of each launch of the CUDA kernels whose name holds `name`
    in one call, in launch order, averaged over the `calls` calls that a
    profiler's `events()` traced; None where the trace lost a launch's
    record (a count of launches that `calls` does not divide)."""
    found = sorted((e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and name in e.name), key=lambda e: e.time_range.start)
    if len(found) % calls:
        return None
    us = np.array([e.time_range.elapsed_us() for e in found], np.float64)
    return (us.reshape(calls, -1).mean(axis=0) / 1e3).tolist()


def profile(fn, ours: frozenset) -> dict:
    """Wall ms per call, the host's ms per call to enqueue them, device ms
    per call by kernel name, kernel launches per call, host syncs per call,
    and the peak of what one call allocates on the card."""
    from torch.profiler import ProfilerActivity
    from efficient_features_tpu_torch.tools.oncard import host_syncs
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / CALLS
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3 / CALLS
            launches += evt.count
    device = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall, "enqueue_ms": (t1 - t0) * 1e3 / CALLS,
            "device_ms": device, "n_kernels": len(ranked),
            "launches": launches / CALLS, "peak_mib": peak,
            "kernels_ms": {k[:NAME]: v for k, v in ranked[:TOP]},
            "other_ms": sum(v for _, v in ranked[TOP:]),
            "sort_ms": sum(v for k, v in ranked if "Sort" in k),
            "port_kernels_ms": {port_kernel(k, ours): v for k, v in ranked
                                if port_kernel(k, ours)},
            "resize_launches_ms": launches_ms(prof.events(), RESIZE, CALLS),
            "host_syncs": len(host_syncs(fn))}


def recorded(module, name: str, fn) -> list:
    """The (args, kwargs) of every call of the kernel wrapper `module.name`
    that one call of fn makes."""
    wrapper, calls = getattr(module, name), []

    def recording(*a, **k):
        calls.append((a, k))
        return wrapper(*a, **k)

    # the wrapper counts on the function its module name is bound to
    recording.launches = 0
    setattr(module, name, recording)
    try:
        fn()
    finally:
        setattr(module, name, wrapper)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", default=None,
                    help="comma-separated path names (default: all)")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import efficient_features_tpu_torch as pkg
    import torch.distributed as dist
    from efficient_features_tpu_torch import BAD, EfficientFeatures, HashSIFT
    from efficient_features_tpu_torch.parallel import sharding as SH
    from efficient_features_tpu_torch.ops import detect_kernels as DK
    from efficient_features_tpu_torch.ops import matcher as TM
    from efficient_features_tpu_torch.ops import ransac as RS
    from efficient_features_tpu_torch.ops import window_kernels as WK
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.samples import \
        sample_image_sequence as SIS
    from efficient_features_tpu_torch.tools.oncard import card, equal_image
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise SystemExit(f"profile_paths: imported {pkg.__file__}, not {root}")

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
    equal = torch.from_numpy(equal_image(H, W)).to(dev)
    batch = torch.stack([torch.roll(scene, (17 * i, 29 * i), (0, 1))
                         for i in range(4)])
    base = SC.tiled_scene(H, W, 2160, True)
    frames = [torch.from_numpy(SC.warp_image(base, 2.0 * i, 5.0 * i, 1.0))
              .to(dev) for i in range(2)]
    step, _ = SIS.streaming_step_fn(ef._cfg, (H, W), homography=True,
                                    ransac_iters=256, device="cuda")
    order = itertools.cycle(frames)     # each step matches the other frame
    (k1, d1), (k2, d2) = (ef.detect_and_compute_async(f) for f in frames)
    j, _, ok = TM.knn2_ratio_match_masked(d1, k1._slots["valid"], d2,
                                          k2._slots["valid"])
    xy1 = torch.stack([k1._slots["x"], k1._slots["y"]], dim=1)
    xy2 = torch.stack([k2._slots["x"], k2._slots["y"]], dim=1)[j.long()]
    rng = np.random.default_rng(40000)
    ladder = np.float32([31.0 * 1.2 ** k for k in range(8)] + [300.0])
    kps = np.stack([rng.uniform(0, W - 1, NFEATURES),
                    rng.uniform(0, H - 1, NFEATURES),
                    rng.uniform(31.0, 300.0, NFEATURES),
                    rng.uniform(0, 360, NFEATURES)], axis=1).astype(np.float32)
    kps[::2, 2] = ladder[np.arange(NFEATURES)[::2] % len(ladder)]
    kps[::97, 3] = -1.0
    kps = torch.from_numpy(kps).to(dev)
    hs_256, bad_256 = HashSIFT(1.0, 256, device="cuda"), BAD(1.0, 256,
                                                             device="cuda")
    paths = {"dac": lambda: ef.detect_and_compute_async(scene),
             "dac_bad": lambda: ef_bad.detect_and_compute_async(scene),
             "masked": lambda: ef.detect_and_compute_async(scene, mask=roi),
             "small_radius": lambda: ef5.detect_and_compute_async(scene,
                                                                  mask=roi),
             "small_radius_nomask": lambda: ef5.detect_and_compute_async(
                 scene),
             "large_radius": lambda: ef64.detect_and_compute_async(scene),
             "dac_equal": lambda: ef.detect_and_compute_async(equal),
             "fused_hs": lambda: ef_fused.detect_and_compute_async(scene),
             "batch4": lambda: ef.detect_and_compute_batch(batch),
             "sequence": lambda: step(next(order)),
             "ransac": lambda: RS.find_homography_ransac(xy1, xy2, ok,
                                                         iters=512,
                                                         device="cuda"),
             "compute_hs": lambda: hs_256.compute_async(scene, kps),
             "compute_bad": lambda: bad_256.compute_async(scene, kps),
             "mesh_dac": lambda: ef.detect_and_compute_async(scene,
                                                             mesh=mesh)}
    k3, k3_calls = WK.bad_descriptors_windows, recorded(
        WK, "bad_descriptors_windows",
        lambda: ef_bad.detect_and_compute_async(scene))
    paths["bad_wrapper"] = lambda: [k3(*a, **k) for a, k in k3_calls]
    k13, k13_calls = DK.select_cells, recorded(
        DK, "select_cells", lambda: ef.detect_and_compute_async(scene))
    paths["cells_wrapper"] = lambda: [k13(*a, **k) for a, k in k13_calls]

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
    if "mesh_dac" in paths:
        store = tempfile.TemporaryDirectory()
        dist.init_process_group("nccl", init_method=f"file://{store.name}/s",
                                world_size=1, rank=0)
        mesh = SH.make_mesh()
    ours = port_kernel_names(root / "efficient_features_tpu_torch" / "csrc")
    summary = {"card": hw, "root": str(root), "calls": CALLS, "paths": {}}
    for name, fn in paths.items():
        res = profile(fn, ours)
        summary["paths"][name] = res
        print(f"{name}: wall {res['wall_ms']:.3f} ms/call (enqueued in "
              f"{res['enqueue_ms']:.3f}), device "
              f"{res['device_ms']:.3f} ms/call, host syncs "
              f"{res['host_syncs']}, "
              f"{res['launches']:g} launches and {res['n_kernels']} kernel "
              f"names a call, peak allocation {res['peak_mib']:.3f} MiB "
              f"[{hw}] ({root})")
        for k, v in res["kernels_ms"].items():
            print(f"  {v:9.3f} ms  {k}")
        print(f"  {res['other_ms']:9.3f} ms  the other "
              f"{res['n_kernels'] - len(res['kernels_ms'])} kernels")
        print(f"  {res['sort_ms']:9.3f} ms  in sort kernels, all told")
        print("  the port's kernels: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["port_kernels_ms"].items()))
        if res["resize_launches_ms"] is None:
            print(f"  {RESIZE} by launch: not listed, the trace lost a "
                  "launch's record")
        elif res["resize_launches_ms"]:
            print(f"  {RESIZE} by launch: " + " ".join(
                f"{v:.4f}" for v in res["resize_launches_ms"]))
    if "mesh_dac" in paths:
        dist.destroy_process_group()
        store.cleanup()
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
