"""HPatches descriptor exporter (samples/hpatches_description.cpp), on the
port.

Reads HPatches patch-column images (65x65 patches stacked vertically,
hpatches_description.cpp:231-242), synthesizes one centered keypoint per
patch, computes BAD or HashSIFT descriptors with standalone `compute()` and
writes CSV bit rows (hpatches_description.cpp:76-105) for the public
hpatches-benchmark.

    python -m efficient_features_tpu_torch.samples.hpatches_description \
        <hpatches_seq_dir> <out_dir> [--descriptor-type N]
        [--descriptor-bits N] [--use-orientation] [--hs-fused]
        [--device cuda|cpu]
"""
import argparse
import glob
import os

import numpy as np
import torch

from efficient_features_tpu_torch import BAD, HashSIFT
from efficient_features_tpu_torch.api import resolve_device
from efficient_features_tpu_torch.ops import orientation
from efficient_features_tpu_torch.samples.sample_common import load_gray
from efficient_features_tpu_torch.utils import semantics as S

PATCH = 65


def patch_keypoints(img: torch.Tensor, cropping_scale: float,
                    use_orientation: bool) -> torch.Tensor:
    """(npatch, 4) float32 [x, y, size, angle] on the image's device: one
    keypoint per 65-row patch of a patch column, centered, sized so that the
    descriptor window covers the patch.  The angle is -1 (no rotation), or
    with `use_orientation` the IC angle at the centre clipped to where the
    radius-15 disc stays inside the image (the reference's optional CPU
    ICAngles path, hpatches_description.cpp:107-162)."""
    h, w = img.shape
    npatch = h // PATCH
    dev = img.device
    x = torch.full((npatch,), (PATCH - 1) / 2.0, dtype=torch.float32,
                   device=dev)
    y = (torch.arange(npatch, device=dev) * PATCH
         + (PATCH - 1) / 2.0).to(torch.float32)
    size = torch.full_like(x, PATCH / max(cropping_scale, 1e-6))
    if use_orientation:
        r = S.HALF_PATCH_SIZE
        moments = orientation.ic_moments(
            img, y.to(torch.int32).clamp(r, h - 1 - r),
            x.to(torch.int32).clamp(r, w - 1 - r))
        angle = orientation.angles_from_moments(
            moments, torch.ones_like(x, dtype=torch.bool))
    else:
        angle = torch.full_like(x, -1.0)
    return torch.stack([x, y, size, angle], dim=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--descriptor-type", type=int, default=0)
    ap.add_argument("--descriptor-bits", type=int, default=256)
    ap.add_argument("--cropping-scale", type=float, default=1.0)
    ap.add_argument("--use-orientation", action="store_true",
                    help="estimate the IC angle of each patch")
    ap.add_argument("--hs-fused", action="store_true",
                    help="HashSIFT through the fused kernel")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = ap.parse_args()

    if args.descriptor_type == 0:
        extractor = BAD(args.cropping_scale, args.descriptor_bits,
                        device=args.device)
    else:
        extractor = HashSIFT(args.cropping_scale, args.descriptor_bits,
                             device=args.device, fused=args.hs_fused)
    name = f"{type(extractor).__name__.lower()}{args.descriptor_bits}"
    device = resolve_device(args.device)

    seqs = sorted(d for d in glob.glob(os.path.join(args.input_dir, "*"))
                  if os.path.isdir(d))
    if not seqs:
        raise SystemExit(f"no sequence dirs under {args.input_dir}")

    for seq in seqs:
        out_seq = os.path.join(args.output_dir, name, os.path.basename(seq))
        os.makedirs(out_seq, exist_ok=True)
        for png in sorted(glob.glob(os.path.join(seq, "*.png"))):
            img = torch.from_numpy(np.ascontiguousarray(load_gray(png))).to(
                device)
            kps = patch_keypoints(img, args.cropping_scale,
                                  args.use_orientation)
            desc = extractor.compute(img, kps)
            bits = np.unpackbits(desc, axis=1)
            out_csv = os.path.join(
                out_seq, os.path.basename(png).replace(".png", f".{name}.csv"))
            np.savetxt(out_csv, bits, fmt="%d", delimiter=",")
            print(f"{out_csv}: {kps.shape[0]} patches")


if __name__ == "__main__":
    main()
