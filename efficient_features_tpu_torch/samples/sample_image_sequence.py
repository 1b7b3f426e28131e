"""Streaming image-sequence demo (samples/sample_image_sequence.cpp), on the
port.

Runs detect and describe over a stream of frames and matches consecutive
frames with a knn ratio test and cross check (sample_image_sequence.cpp:
114-144), all on the device; --homography adds the batched RANSAC.

    python -m efficient_features_tpu_torch.samples.sample_image_sequence \
        [glob-or-dir] [--frames N] [--device cuda|cpu] [--homography]
"""
import argparse
import glob
import os
import time

import numpy as np
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch import pipeline as P
from efficient_features_tpu_torch.api import resolve_device
from efficient_features_tpu_torch.ops import matcher
from efficient_features_tpu_torch.ops import ransac as RS
from efficient_features_tpu_torch.samples.sample_common import (
    descriptor_type, load_gray, warp_image)


def frame_iter(src, n_frames):
    if src:
        paths = sorted(glob.glob(os.path.join(src, "*"))
                       if os.path.isdir(src) else glob.glob(src))
        for p in paths[:n_frames]:
            yield load_gray(p)
    else:
        base = load_gray(None, 720, 1280, seed=9)
        rng = np.random.default_rng(0)
        for i in range(n_frames):
            yield warp_image(base, angle_deg=2.0 * i,
                             tx=5.0 * i, ty=float(rng.uniform(-3, 3)))


def streaming_step_fn(cfg, hw, max_ratio: float = 0.8,
                      homography: bool = False, ransac_iters: int = 256,
                      ransac_thresh: float = 3.0, ransac_seed: int = 0,
                      device="cuda"):
    """Steady-state streaming step over preallocated state tensors.

    The previous frame's descriptors, validity and coordinates live in
    fixed-capacity state tensors allocated once here; each step matches the
    new frame against them and then writes the new frame over them in place
    with `copy_` (the JAX package donates these buffers to its jitted step
    instead; both reuse the allocations, as the reference's grow-only
    DeviceBuffer does, device_buffer.cpp:42-69).  Returns (step, state):
    step(frame) -> (n_keypoints, n_matches) device scalars, plus (H 3x3,
    n_inliers) when homography=True, where the batched RANSAC verifies the
    frame-to-frame matches in the same step.  A step reads nothing back:
    it only enqueues work on the device (a frame given as a host array is
    copied there first).  The RANSAC draw reseeds with `ransac_seed` every
    step, as the JAX step reuses one key.
    state is the dict of state tensors (exposed for tests)."""
    dev = resolve_device(device)
    h, w = hw
    cap = P.level_slot_ranges(cfg, h, w)[-1][1]
    state = {"desc": torch.zeros((cap, cfg.descriptor_bytes),
                                 dtype=torch.uint8, device=dev),
             "valid": torch.zeros(cap, dtype=torch.bool, device=dev),
             "xy": torch.zeros((cap, 2), dtype=torch.float32, device=dev)}
    gen = torch.Generator(device=dev)

    def step(frame):
        img = frame if isinstance(frame, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(frame))
        img = img.to(dev).contiguous()
        slots, desc = P.detect_and_compute_core(img, cfg, True)
        valid = slots["valid"]
        xy = torch.stack([slots["x"], slots["y"]], dim=1).to(torch.float32)
        j, _, ok = matcher.knn2_ratio_match_masked(
            state["desc"], state["valid"], desc, valid, max_ratio)
        outs = (slots["count"], ok.sum(dtype=torch.int32))
        if homography:
            gen.manual_seed(ransac_seed)
            idx = RS._draw_minimal_sets(ok, ransac_iters, gen)
            H, _, n_inl = RS._ransac_from_indices(
                state["xy"], xy[j.long()], ok, ransac_thresh, idx)
            outs = outs + (H, n_inl)
        state["desc"].copy_(desc)
        state["valid"].copy_(valid)
        state["xy"].copy_(xy)
        return outs

    return step, state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--max-keypoints", type=int, default=3000)
    ap.add_argument("--descriptor-type", type=int, default=0)
    ap.add_argument("--descriptor-bits", type=int, default=256)
    ap.add_argument("--max-ratio", type=float, default=0.8)
    ap.add_argument("--homography", action="store_true",
                    help="RANSAC-verify frame-to-frame matches in the same "
                         "device step (geometric tracking)")
    ap.add_argument("--ransac-thresh", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = ap.parse_args()

    feat = EfficientFeatures(
        nfeatures=args.max_keypoints,
        descriptor_type=descriptor_type(args.descriptor_type,
                                        args.descriptor_bits),
        device=args.device)

    # detect, describe and match chain on fixed-capacity slot tensors kept
    # on the device; the only reads per frame are the printed counts
    step = None
    t_all = []
    for fi, frame in enumerate(frame_iter(args.source, args.frames)):
        if step is None:
            step, _ = streaming_step_fn(feat._cfg, frame.shape,
                                        args.max_ratio,
                                        homography=args.homography,
                                        ransac_thresh=args.ransac_thresh,
                                        device=feat.device)
        t0 = time.perf_counter()
        res = step(frame)
        nk = int(res[0])
        nm = int(res[1]) if fi > 0 else 0
        dt = time.perf_counter() - t0
        t_all.append(dt)
        line = f"frame {fi}: {nk} kps, {nm} matches, {dt*1e3:.1f} ms"
        if args.homography and fi > 0:
            line += f", {int(res[3])} RANSAC inliers"
        print(line)

    if len(t_all) > 2:
        steady = np.mean(t_all[2:]) * 1e3
        print(f"steady-state per frame: {steady:.1f} ms "
              f"({1e3/steady:.1f} fps)")


if __name__ == "__main__":
    main()
