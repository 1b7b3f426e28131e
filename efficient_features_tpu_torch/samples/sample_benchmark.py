"""Benchmark CLI (samples/sample_benchmark.cpp:27-37 CLI keys), on the port.

    python -m efficient_features_tpu_torch.samples.sample_benchmark [image]
        [--benchmark-type {0,1,2}] [--nonmax-radius N] [--hs-fused]
        [--device cuda|cpu]
    0: detect-and-compute   1: detect-only   2: compute-only

One warm-up call, then --num-iterations calls (`utils.profiler.timeit_ms`);
on a GPU the mean time per call comes from CUDA events around them, on the
CPU from the host clock.
"""
import argparse

import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.samples.sample_common import (
    descriptor_type, load_gray)
from efficient_features_tpu_torch.utils import profiler

NAMES = ["detect-and-compute", "detect-only", "compute-only"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("--max-keypoints", type=int, default=10000)
    ap.add_argument("--fast-threshold", type=int, default=20)
    ap.add_argument("--num-levels", type=int, default=8)
    ap.add_argument("--nonmax-radius", type=int, default=15)
    ap.add_argument("--descriptor-type", type=int, default=0)
    ap.add_argument("--descriptor-bits", type=int, default=256)
    ap.add_argument("--benchmark-type", type=int, default=0,
                    choices=range(len(NAMES)))
    ap.add_argument("--num-iterations", type=int, default=10)
    ap.add_argument("--hs-fused", action="store_true",
                    help="HashSIFT through the fused kernel (one launch per "
                         "level instead of warp + histogram)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = ap.parse_args()

    img = load_gray(args.image)
    dtype = descriptor_type(args.descriptor_type, args.descriptor_bits)
    feat = EfficientFeatures(
        nfeatures=args.max_keypoints, nlevels=args.num_levels,
        fast_threshold=args.fast_threshold, nonmax_radius=args.nonmax_radius,
        descriptor_type=dtype, device=args.device,
        hs_fused=args.hs_fused)
    img_t = torch.from_numpy(img).to(feat.device)

    print("=== configuration ===")
    print(f"image size      : {img.shape[1]}x{img.shape[0]}")
    print(f"descriptor type : {dtype}")
    print(f"max keypoints   : {args.max_keypoints}")
    print(f"num levels      : {args.num_levels}")
    print(f"nonmax radius   : {args.nonmax_radius}")
    print(f"benchmark type  : {NAMES[args.benchmark_type]}")
    print(f"device          : {feat.device}")

    if args.benchmark_type == 0:
        fn = lambda: feat.detect_and_compute_async(img_t)  # noqa: E731
    elif args.benchmark_type == 1:
        fn = lambda: feat.detect_async(img_t)  # noqa: E731
    else:
        # the reference's compute-only protocol: detector keypoints
        # (sample_benchmark.cpp:125-133), kept on the device
        kps = feat.detect(img_t)
        fn = lambda: feat.compute_async(img_t, kps)  # noqa: E731
    ms = profiler.timeit_ms(fn, iters=args.num_iterations, warmup=1)

    print(f"{feat.detect(img_t).count} keypoints found.")
    print(f"processing time: {ms:.1f}[milli sec]")


if __name__ == "__main__":
    main()
