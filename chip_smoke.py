"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficient_features_tpu_torch/csrc` and
checks each against its plain PyTorch version on the card: K1 cells (with
and without its ROI mask input, radius 10-128, on the scene, the dense scene
and 4K uniform noise, and an image whose corners all tie, so that each
scans its whole disc), K7 dense FAST+Harris+NMS
and K8 dense FAST+Harris (radius 1-9, bit-exact; K7 also on the scene
plus noise, on equal responses, where ties co-survive, and on an image
smaller than one tile), K9 disc NMS
(radius 3-128, unmasked and under a random mask, bit-exact), K2 IC
moments, K3 BAD (byte for byte at 256 and 512 bits, at size 31 and at
64-300 px, on both sides of its shared-memory window limit, on the image
corners and the 27.125 px branch boundary, n = 1, every slot invalid,
images 1-3 px tall or wide), K4 HashSIFT warp (sizes
31*1.2^k and 300 px), K5 HashSIFT histogram (deterministic, zero patch ->
zero row), K10 the pyramid's resize (bit-exact on the 7 levels under a
2160x3840 frame, odd sizes, an upscale, 16x20 and 8x8 destinations, noise
and all-255), K11 fused HashSIFT (the bytes of K5 on K4's patches, and
both within K5's tolerance of their plain versions, on detected keypoints,
on sizes 31-300 px, on the image corners, on a saturated 0/255 edge image,
and at the edges of the two kernels' 8-patch blocks: n = 1, one off a
multiple of 8, empty patches and invalid slots at every position of a
block; invalid slots and all-zero patches give zero rows; deterministic)
and K6 best-2 Hamming search
(bit-identical at 40000 x 40000, 256 and 512 bits, unmasked and about 20%
masked on each side, on a tie-heavy pool with a duplicate across train
tiles and n2 not a multiple of the tile, rows with no valid pair, at
64 x 64, 1000 x 40000 and one off a tile multiple on both sides, with every
query invalid, the same bits on a second run, one launch of each of its
three kernels per call; and `match`, `knn2_ratio_match`,
`knn2_ratio_match_masked` against their plain routes).  Then it drives the
port's main paths at 2160x3840 with 40000 features, each with every
launch count set to 0 just before and read just after:
  - `EfficientFeatures.detect_and_compute` with BAD-256, BAD-512,
    HashSIFT-256 and HashSIFT-512, checked against the plain path on the
    card and against the port on the CPU; this path and compute() fail if
    they call `ops.image.integral_image_i32` (K3 sums its own boxes), and
    the kernels of K3's wrapper call are listed (no scan among them);
  - standalone `compute()` (`BAD`, `HashSIFT`, 256 and 512 bits) on the
    slice's detected keypoints and on 40000 host keypoints of mixed size,
    checked against the plain path on the card;
  - the image-sequence step (`samples.sample_image_sequence.
    streaming_step_fn`, HashSIFT-256, RANSAC 256 iterations) over 3 frames
    of a rigid warp, checked for matches, inlier share and the homography's
    error at the image corners against the warp's own;
  - the two-image path of `samples.sample_feature_matching` on frames 0
    and 1: `detect_and_compute` twice, cross-checked `match`,
    `find_homography_ransac` (512 iterations), with the same checks.
  - the detector's configurations through `detect_and_compute`,
    HashSIFT-256 and BAD-256: (a) `mask=` the ROI of
    `sample_common.roi_mask` at radius 15 (K1 with its mask), (b) radius 5
    (K7), (c) radius 5 with the ROI (K8, the mask, K9), (d) radius 64 (K1,
    no K8 or K9 launch), each checked against the plain path on the card,
    each detect kernel launched once per level.
  - the fused HashSIFT route: `detect_and_compute` with `hs_fused=True`,
    HashSIFT-256 and -512 (7 K10 and 8 K11 launches per call, no K4 or K5
    launch; descriptor bytes identical to the two-stage route, slots
    bit-identical to the plain path), `HashSIFT(fused=True).compute` on
    40000 host keypoints, and a 4-frame `detect_and_compute_batch` whose
    frame i equals the single call on frame i.
Every `detect` / `detect_and_compute` call builds its pyramid through K10:
7 launches per call, checked in every path above.
At the samples' own size (720x1280, 3000 features) configurations (a)-(d)
are held against the port on the CPU, as are the fused route and a 4-frame
batch, and the sequence path on the card is held against the port on the
CPU: slots bit-identical, descriptors
within budget, matcher outputs identical on the same descriptors, RANSAC's
homography within SAMPLE_H_TOL on the same minimal sets.
It checks that the HashSIFT projection ignores a caller's TF32 setting, and
times the slices, compute, the sequence step, RANSAC and each kernel (a
replay of one main-path call's launches) beside their plain versions with
CUDA events; host syncs per call come from `torch.cuda.set_sync_debug_mode`.
Exits non-zero without a result when CUDA is absent or any check fails.
The second-to-last stdout line is a JSON object with one entry per kernel
(time, bound, plain and library times); the last is the device summary.

Scenes: `make_test_image` (the tests' scene) at full size holds a few hundred
corner-rich shapes, which at 2160x3840 yield only ~1.4k keypoints for 40000
slots; the slices therefore run on the same generator's 270x480 scene tiled
8x8 (~23k keypoints), and the full-size scene is a K1 check.  A tiled scene
repeats every descriptor 64 times, so a ratio test would drop nearly every
match; the matching paths run on 64 different 270x480 tiles instead
(seeds 2160..2223).
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

H, W = 2160, 3840
NFEATURES = 40000
N_KP = 40000
ITERS = 20
BUDGETS = {"bad": 2e-5, "hash_sift": 1e-4}   # share of bytes that may differ
WARP_SHARE = 1e-3      # K4: |diff| <= 1 on fewer than this share of pixels
HIST_SHARE = 2e-3      # K5: |diff| <= 1 on fewer than this share of entries
ANGLE_TOL = 1e-3       # degrees, CPU vs GPU atan2
SEQ_FRAMES = 3
RANSAC_THRESH = 3.0
# The homography's error at the four image corners against the warp's own.
# warp_image rounds every source coordinate to the nearest pixel (up to
# 0.71 px per point) and a keypoint on pyramid level s sits on a 1.2^s px
# grid; the refit over thousands of inliers averages both (0.20-0.24 px on
# the H100), so an error above 1 px at a corner means a wrong homography.
CORNER_TOL = 1.0       # px
# Floors set from the first H100 run (14682-17265 matches between
# consecutive 4K frames, inlier shares 0.958-0.972), with room for noise.
INLIER_FLOOR = 0.9     # RANSAC inliers / matches
MATCH_FLOOR = 10000    # matches between consecutive 4K frames
SAMPLE_HW = (720, 1280)
SAMPLE_NFEATURES = 3000
# RANSAC on the card vs the CPU, the same minimal sets, at the corners.
# f32 errors of points at the threshold can fall on either side on the two
# backends; that can move the winner among hypotheses of equal score and so
# the refit's inlier set (0.25 px measured at 720p on the H100).  Each H is
# also held to the warp itself within CORNER_TOL.
SAMPLE_H_TOL = 1.0     # px
# Peak rates of one H100 SXM from its datasheet: HBM bytes/s,
# int8 tensor-core ops/s, float32 ops/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_INT8_TC = 1979e12
PEAK_F32 = 67e12
# Two rates the datasheet does not state, for K6's bound.
# 1-bit tensor-core ops/s (wgmma .b1 and.popc): 8 x the int8 rate, the ratio
# of the A100's datasheet (4992 to 624 TOP/s).  The product alone, 40000 x
# 40000, reads 13e15 / 14e15 ops/s at 256 / 512 bits on an NVIDIA H100 80GB
# HBM3 at 700 W (efficient_features_tpu_torch/tools/knn2_probe.py: 0.062 /
# 0.116 ms): 0.83 / 0.89 of this, and 6.7 / 7.1 x the stated int8 rate.
PEAK_B1_TC = 8 * PEAK_INT8_TC
# int32 min/max per second on the CUDA cores: 64 per clock and SM (NVIDIA's
# table of arithmetic instruction throughput for compute capability 9.0) x
# 132 SMs x 1.98 GHz, the clock behind the datasheet's 67 TFLOP/s.
PEAK_INT32 = 64 * 132 * 1.98e9
# K5 / K11: CUDA-core ops per patch that is not all zero (see `_work`), and
# the bytes of the histogram plan (ops/hash_sift.hist_plan) read per call.
HS_PATCH_OPS = 40.0 * 900 + 2.0 * 5202 + 6.0 * 128
HS_PLAN_BYTES = 16 * 6 * 4 + 2601 * 4
REPO = Path(__file__).resolve().parent


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=ITERS, warmup=3) -> float:
    """Mean ms per call over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double()
    b = b.double()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() \
        else 0.0


def byte_budget(kind: str, n_bytes: int) -> int:
    return int(BUDGETS[kind] * n_bytes) + 1


def u8_diff(got: torch.Tensor, want: torch.Tensor):
    """(max |diff|, share of differing entries) of two uint8 tensors."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int(d.max()), float((d != 0).double().mean())


def tie_image() -> np.ndarray:
    """Two identical corner patterns 4 px apart: tied co-survivors inside
    one 8x8 block (the case of tests/test_kernels.py's tie test)."""
    img = np.full((96, 160), 40, np.uint8)
    img[40:44, 60:64] = 220
    img[44:48, 64:68] = 220
    return img


def tie_mask() -> np.ndarray:
    """ROI of `tie_image` that cuts one of its two tied 8x8 blocks and
    leaves the other tied (tests/test_torch_cuda.py's tie mask): selection
    still takes the dense fallback, which must apply the mask."""
    mask = np.full((96, 160), 255, np.uint8)
    mask[:, 66:] = 0
    return mask


def equal_image(h: int, w: int) -> np.ndarray:
    """One bright pixel every 6 px each way: each is a FAST corner and all
    have the same Harris response, so every corner ties with every other,
    all survive, and K1's NMS scans the whole disc of each."""
    cell = np.full((6, 6), 40, np.uint8)
    cell[3, 3] = 220
    return np.tile(cell, (-(-h // 6), -(-w // 6)))[:h, :w].copy()


def wrap_image() -> np.ndarray:
    """A FAST-9 arc wrapping the index-0 tap (tests/test_kernels.py's
    wrap-run test)."""
    from efficient_features_tpu_torch.utils import semantics as S
    img = np.full((48, 64), 160, np.uint8)
    for idx in list(range(12, 16)) + list(range(0, 5)):
        dy, dx = S.FAST_CIRCLE[idx]
        img[24 + dy, 32 + dx] = 100
    return img


def edge_case():
    """(image, x, y, size, angle, valid): the saturated 0/255 edge image and
    its 24 unrotated keypoints at non-integer positions
    (tests/test_kernels.py's saturated-edges test): gradients of +-255."""
    img = np.zeros((160, 256), np.uint8)
    img[:, 128:] = 255
    img[40:80, 40:80] = 255
    img[100:140, 160:200] = 0
    n = 24
    rng = np.random.default_rng(11)
    x = (rng.uniform(34, 222, n) + 0.31).astype(np.float32)
    y = (rng.uniform(34, 126, n) + 0.47).astype(np.float32)
    return (img, x, y, np.full(n, 31.0, np.float32),
            np.full(n, -1.0, np.float32), np.ones(n, bool))


@contextlib.contextmanager
def patched(module_attrs):
    """Temporarily set module attributes: [((module, name), value), ...]."""
    saved = [(m, n, getattr(m, n)) for (m, n), _ in module_attrs]
    for (m, n), v in module_attrs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def kernel_names(fn) -> dict:
    """{kernel name: (launches, device ms)} of the CUDA kernels one call of
    fn makes (torch.profiler)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            out[e.key] = (e.count, t / 1e3)
    return out


def host_syncs(fn) -> int:
    """Host syncs that one call of fn makes (torch's sync debug mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            return sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _work(name: str, args) -> tuple[float, float, float, float]:
    """(bytes, CUDA-core ops at the float32 rate, int32 min/max, 1-bit
    tensor-core ops) of one wrapper call: each input read once and each
    output written once, and the work the function needs on these inputs.
    Op counts are per-element estimates of the algorithm's own arithmetic,
    each op counted once:
      K1  FAST-9 at every pixel: 16 differences, 32 threshold compares;
          per border-valid FAST corner of this image (inside the mask,
          where there is one) 2 x 147 for the Harris sums and one compare
          per pixel of the disc; with a mask, 1 B more read per pixel;
      K7  as K1, dense: 1 B read and 4 B written per pixel;
      K8  FAST-9 at every pixel, 1 B read and 4 B written per pixel;
      K9  4 B read and 1 B of bool written per pixel, one compare per
          pixel and per corner (a response that is not -inf) one compare
          per pixel of the disc;
      K2  a multiply-add per moment per disc pixel: 4 x 705 per keypoint;
      K3  the integral image (2 adds per pixel) and per bit two box sums
          (3 adds each) and the weighted compare (3);
      K4  per sample the affine (4) and the bilinear lerp (8);
      K5  per patch 1024 B read and 128 B written, and the plan and its
          weights (10788 B) once per call; per patch that is not all zero
          (an all-zero patch has a zero row without arithmetic) 40 per
          interior pixel for gradients, magnitude, atan2 and votes, 2 per
          weighted vote (5202: 2601 (pixel, spatial bin) pairs, two votes
          each; a multiply and an add) and 6 per output bin for the two
          norms and the quantisation (HS_PATCH_OPS);
      K6  what any exact best-2 search needs: the n1 * n2 * nbits bit
          products, 2 ops each, at the 1-bit tensor-core rate (the operand
          type of the kernel; PEAK_B1_TC), and one int32 min per distance
          on the CUDA cores (n1 * n2; the kernel's fold spends about 3.5
          ops on each).  `int8_form_ms` gives the same product at the
          stated int8 rate as a yardstick only: it is no bound;
      K10 source and destination pixels once and the six int32 tables; per
          destination pixel 6 multiplies, 3 adds, the rounding add and the
          shift (11);
      K11 the image once, 17 B of keypoint per slot, the 128 B row and
          the plan once; per valid slot K4's affine and lerp per sample,
          and K5's work for each patch that is not all zero (an invalid
          slot costs only its bytes)."""
    if name in ("fast_harris_nms_cells", "fast_harris_nms"):
        from efficient_features_tpu_torch.ops import detect_kernels as DK
        h, w = args[0].shape
        mask = args[3] if len(args) > 3 else None
        corner = DK.border_corners(args[0], args[1])
        if mask is not None:
            corner = corner & mask
        ops = 48.0 * h * w + int(corner.sum()) * (2.0 * 147
                                                  + _disc_pixels(args[2]))
        if name == "fast_harris_nms":
            return 5 * h * w, ops, 0.0, 0.0
        return (h * w * (2 if mask is not None else 1)
                + 12 * -(-h // 8) * w, ops, 0.0, 0.0)
    if name == "fast_harris":
        h, w = args[0].shape
        return 5 * h * w, 48.0 * h * w, 0.0, 0.0
    if name == "radius_nms":
        from efficient_features_tpu_torch.ops import detect as D
        h, w = args[0].shape
        corners = int((args[0] != D.RESP_SENTINEL).sum())
        return (5 * h * w, 1.0 * h * w + corners * _disc_pixels(args[1]),
                0.0, 0.0)
    if name == "ic_moments_windows":
        img, ys = args[0], args[1]
        n = ys.shape[0]
        return img.numel() + 16 * n, 4.0 * 705 * n, 0.0, 0.0
    if name == "bad_descriptors_windows":
        img, n, nbits = args[0], args[1].shape[0], args[6]
        return (img.numel() + 17 * n + n * nbits // 8,
                2.0 * img.numel() + 9.0 * nbits * n, 0.0, 0.0)
    if name == "warp_patches_windows":
        img, n = args[0], args[1].shape[0]
        return img.numel() + 17 * n + 1024 * n, 12.0 * 1024 * n, 0.0, 0.0
    if name == "hs_hist_from_patches":
        n = args[0].shape[0]
        live = n - empty_patches(args[0])
        return 1152 * n + HS_PLAN_BYTES, HS_PATCH_OPS * live, 0.0, 0.0
    if name == "resize_u8_kernel":
        src, (h, w) = args
        return src.numel() + h * w + 12 * (h + w), 11.0 * h * w, 0.0, 0.0
    if name == "hs_desc_windows":
        from efficient_features_tpu_torch.ops import window_kernels as WK
        img, n = args[0], args[1].shape[0]
        valid = int(args[5].sum())
        live = n - empty_patches(WK.warp_patches_windows_ref(*args))
        return (img.numel() + 17 * n + 128 * n + HS_PLAN_BYTES,
                12.0 * 1024 * valid + HS_PATCH_OPS * live, 0.0, 0.0)
    if name == "knn2_topk2":
        q, vq, t, vt = args
        n1, n2, nb = q.shape[0], t.shape[0], q.shape[1]
        masks = (n1 if vq is not None else 0) + (n2 if vt is not None else 0)
        return ((n1 + n2) * nb + masks + 12 * n1, 0.0, 1.0 * n1 * n2,
                2.0 * n1 * n2 * 8 * nb)
    raise KeyError(name)


def empty_patches(patches: torch.Tensor) -> int:
    """All-zero rows of (N, 1024) u8 patches."""
    return int((patches == 0).all(dim=1).sum())


def block_edge_valid(n: int) -> np.ndarray:
    """Valid flags that put empty slots at the edges of the histogram
    kernels' 8-slot blocks: blocks 0-7 each lack the slot at their own
    position, blocks 8-15 hold only that slot, block 16 is all invalid,
    the rest valid (tests/test_torch_cuda.py's block-edge test)."""
    valid = np.ones(n, bool)
    for b in range(min(8, n // 8)):
        valid[8 * b + b] = False
    for b in range(8, min(16, n // 8)):
        valid[8 * b:8 * b + 8] = False
        valid[8 * b + b - 8] = True
    if n >= 136:
        valid[128:136] = False
    return valid


def _disc_pixels(radius: int) -> float:
    """Pixels of the open NMS disc of `radius`."""
    from efficient_features_tpu_torch.utils import semantics as S
    return float(sum(2 * wdx + 1 for _, wdx in S.disc_row_extents(radius)))


def bound(name: str, calls) -> tuple[float, str]:
    """(bound_ms, bound_by) of a list of recorded (args, kwargs) calls: the
    larger of bytes over the HBM rate and ops over their peak rate (the
    CUDA cores and the tensor cores run side by side, so the larger of the
    two, not their sum)."""
    work = np.sum([_work(name, args) for args, _ in calls], axis=0)
    t_bytes, *t_ops = work / (PEAK_BYTES, PEAK_F32, PEAK_INT32,
                              PEAK_B1_TC) * 1e3
    t_ops = max(t_ops)
    return (float(max(t_bytes, t_ops)),
            "bytes" if t_bytes >= t_ops else "operations")


def int8_form_ms(calls) -> float:
    """K6's product as an int8 product of the unpacked bits at the stated
    int8 rate: a yardstick beside the bound, not a bound (the 1-bit form
    runs under it)."""
    return float(sum(_work("knn2_topk2", args)[3] for args, _ in calls)
                 / PEAK_INT8_TC * 1e3)


def corner_err(Hm, H_true, hw) -> float:
    """Largest distance (px) between where Hm and H_true send the four image
    corners."""
    h, w = hw
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                 np.float64)
    a = c @ np.asarray(Hm, np.float64).T
    b = c @ np.asarray(H_true, np.float64).T
    return float(np.linalg.norm(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:],
                                axis=1).max())


def noisy_copies(rng, d2: np.ndarray, n: int, p: float) -> np.ndarray:
    """n rows of d2 (random picks) with each bit flipped with probability
    p: queries with a true nearest neighbour."""
    src = d2[rng.integers(0, len(d2), n)]
    flips = np.packbits(rng.random((n, d2.shape[1] * 8)) < p, axis=1)
    return src ^ flips


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from efficient_features_tpu_torch import (BAD, EfficientFeatures,
                                              HashSIFT, _build)
    from efficient_features_tpu_torch import pipeline as P
    from efficient_features_tpu_torch.models.params import (bad_params,
                                                            hash_sift_params)
    from efficient_features_tpu_torch.ops import bad as B
    from efficient_features_tpu_torch.ops import detect as D
    from efficient_features_tpu_torch.ops import detect_kernels as DK
    from efficient_features_tpu_torch.ops import image as I
    from efficient_features_tpu_torch.ops import matcher as TM
    from efficient_features_tpu_torch.ops import orientation as O
    from efficient_features_tpu_torch.ops import ransac as RS
    from efficient_features_tpu_torch.ops import window_kernels as WK
    from efficient_features_tpu_torch.samples import sample_common as SC
    from efficient_features_tpu_torch.samples.sample_common import \
        make_test_image
    from efficient_features_tpu_torch.samples import \
        sample_image_sequence as SIS
    from efficient_features_tpu_torch.utils import semantics as S

    tpu = "efficient_features_tpu/ops/"
    # (module, wrapper name, plain version, CUDA source, TPU kernel bodies)
    kernels = [
        (DK, "fast_harris_nms_cells", DK.fast_harris_nms_cells_ref,
         "fast_harris_nms_cells.cu", tpu + "pallas_kernels.py:648"),
        (WK, "ic_moments_windows", O.ic_moments,
         "ic_moments.cu", tpu + "window_kernels.py:861"),
        (WK, "bad_descriptors_windows", WK.bad_descriptors_windows_ref,
         "bad_descriptors.cu", tpu + "window_kernels.py:534"),
        (WK, "warp_patches_windows", WK.warp_patches_windows_ref,
         "warp_patches.cu", f"{tpu}window_kernels.py:1034 (_warp_kernel), "
         f"{tpu}window_kernels.py:1741 (_warp_kernel_big)"),
        (WK, "hs_hist_from_patches", WK.hs_hist_from_patches_ref,
         "hs_hist.cu", tpu + "window_kernels.py:1656"),
        (TM, "knn2_topk2", TM.knn2_topk2_ref, "knn2_hamming.cu",
         f"{tpu}matcher.py:144 (_knn2_kernel, launched by _fused_topk2 "
         f"{tpu}matcher.py:183)"),
        (DK, "fast_harris_nms", DK.fast_harris_nms_ref, "fast_harris_nms.cu",
         f"{tpu}pallas_kernels.py:419 (_fast_harris_nms_kernel, launched by "
         f"fast_harris_nms {tpu}pallas_kernels.py:501)"),
        (DK, "fast_harris", DK.fast_harris_ref, "fast_harris.cu",
         f"{tpu}pallas_kernels.py:96 (_fast_harris_kernel, launched by "
         f"fast_harris {tpu}pallas_kernels.py:197)"),
        (DK, "radius_nms", DK.radius_nms_ref, "radius_nms.cu",
         f"{tpu}pallas_kernels.py:241 (_nms_kernel, launched by radius_nms "
         f"{tpu}pallas_kernels.py:297)"),
        (I, "resize_u8_kernel", I.resize_u8, "resize_u8.cu",
         f"{tpu}image.py:115 (_resize_kernel, launched by resize_u8_pallas "
         f"{tpu}image.py:173)"),
        (WK, "hs_desc_windows", WK.hs_desc_windows_ref, "hs_desc.cu",
         f"{tpu}window_kernels.py:1358 (_hs_fused_kernel, launched by "
         f"_hs_desc_windows_impl {tpu}window_kernels.py:1565)"),
    ]
    names = [n for _, n, *_ in kernels]
    pyramid_kernels = ["resize_u8_kernel"]     # every detect call: 7 launches
    detect_kernels = pyramid_kernels + ["fast_harris_nms_cells",
                                        "ic_moments_windows"]
    desc_kernels = {"bad": ["bad_descriptors_windows"],
                    "hash_sift": ["warp_patches_windows",
                                  "hs_hist_from_patches"]}

    def plain_kernels():
        """Route the pipeline through the plain versions (this script
        only: it is the on-card reference)."""
        return patched([((m, n), ref) for m, n, ref, *_ in kernels])

    def no_integral():
        """K3 sums its own boxes: on the card path a call of the integral
        image fails the run."""
        def forbidden(*args, **kwargs):
            fail("ops.image.integral_image_i32 was called on the card path")
        return patched([((I, "integral_image_i32"), forbidden)])

    # -- main-path runs: counts set to 0 just before, read just after -------
    totals = dict.fromkeys(names, 0)
    recorded = {}    # kernel -> its calls in the first run that launched it
    last_calls = {}  # kernel -> its calls in the latest run

    def drive(label, fn, expect, forbid=(), detect_calls=1):
        """Run fn with every launch count at 0 before and read after; fail
        if a kernel of `expect` did not launch, one of `forbid` did, or the
        pyramid's kernel did not launch 7 times per detect call."""
        calls = {n: [] for n in names}

        def recording(f, name):
            def call(*args, **kwargs):
                calls[name].append((args, kwargs))
                return f(*args, **kwargs)
            return call

        # a wrapper counts on the function its module name is bound to, so
        # counts are reset and read while the recorders are in place
        with patched([((m, n), recording(getattr(m, n), n))
                      for m, n, *_ in kernels]):
            for m, n, *_ in kernels:
                getattr(m, n).launches = 0
            out = fn()
            torch.cuda.synchronize()
            counts = {n: getattr(m, n).launches for m, n, *_ in kernels}
        missing = [n for n in expect if counts[n] < 1]
        if missing:
            fail(f"{label}: kernels not launched: {missing} ({counts})")
        if any(counts[n] for n in forbid):
            fail(f"{label}: kernels launched that this route must not "
                 f"take: {[n for n in forbid if counts[n]]} ({counts})")
        if "resize_u8_kernel" in expect and \
                counts["resize_u8_kernel"] != 7 * detect_calls:
            fail(f"{label}: {counts['resize_u8_kernel']} K10 launches, "
                 f"expected 7 for each of {detect_calls} detect calls")
        for n, c in counts.items():
            totals[n] += c
            if c and n not in recorded:
                recorded[n] = calls[n]
        last_calls.clear()
        last_calls.update(calls)
        return out, {n: counts[n] for n in expect}

    hw = card()
    dev = torch.device("cuda")
    started = time.perf_counter()

    def stamp(phase):
        """Seconds since the start, so that a growing script shows where
        its time goes."""
        print(f"[{time.perf_counter() - started:6.1f} s] {phase}")

    print(hw)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s, flags "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log().splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")

    sparse = torch.from_numpy(make_test_image(H, W, seed=2160)).to(dev)
    scene = SC.tiled_scene(H, W, seed=2160, distinct=False)
    img = torch.from_numpy(scene).to(dev)
    blurred = I.gaussian_blur7_u8(img)
    rng = np.random.default_rng(40000)
    errs = dict.fromkeys(names, 0.0)

    stamp("kernels built; K1, K7, K8, K9, K10 against plain")
    def check_same(label, name, got, want):
        """Bit-identical outputs of a kernel and its plain version."""
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or \
                not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist() \
                if got.shape == want.shape else "shape"
            fail(f"{label} differs from plain: shapes {tuple(got.shape)} "
                 f"{tuple(want.shape)}, first differing {bad}")
        errs[name] = max(errs[name], max_abs_err(got, want))

    # -- K1: cells kernel vs plain, bit-exact ---------------------------------
    def check_cells(label, image, radius=15, mask=None):
        got = DK.fast_harris_nms_cells(image, 20, radius, mask)
        ref = DK.fast_harris_nms_cells_ref(image, 20, radius, mask)
        for what, a, b in zip(("cellmax", "cellrow", "cellcnt"), got, ref):
            check_same(f"K1 {label} radius {radius} {what}",
                       "fast_harris_nms_cells", a, b)
        return got

    def check_cells_verbose(label, image, radius=15):
        got = check_cells(label, image, radius)
        print(f"K1 {label} {tuple(image.shape)} radius {radius}: bit-exact, "
              f"{int((got[2] > 0).sum())} live cells, "
              f"{int(got[2].sum())} survivors")
        return got

    check_cells_verbose("scene", sparse)
    check_cells_verbose("dense scene", img)
    tie = torch.from_numpy(tie_image()).to(dev)
    tie_cnt = check_cells_verbose("tie", tie)[2]          # (12, 160)
    if int(tie_cnt.reshape(tie_cnt.shape[0], -1, 8).sum(dim=2).max()) < 2:
        fail("K1 tie image: no 8x8 block with tied co-survivors")
    # the tied block sends selection down the dense fallback on the card
    D.select_topk_cells.fallbacks = 0
    tie_kps = [EfficientFeatures(nfeatures=64, nlevels=1,
                                 descriptor_type="bad_256",
                                 device=d).detect(tie_image())._slots
               for d in ("cuda", "cpu")]
    if D.select_topk_cells.fallbacks != 2 or not all(
            torch.equal(tie_kps[0][k].cpu(), tie_kps[1][k])
            for k in tie_kps[1] if k != "angle") or float(
                (tie_kps[0]["angle"].cpu() - tie_kps[1]["angle"]).abs().max()
            ) >= ANGLE_TOL:
        fail("tie image: the dense fallback on the card differs from the "
             f"CPU ({D.select_topk_cells.fallbacks} fallbacks)")
    print(f"tie image detect: dense fallback taken, {int(tie_kps[0]['count'])}"
          " keypoints, slots bit-identical to the CPU port")
    wrap = torch.from_numpy(wrap_image()).to(dev)
    check_cells_verbose("wrap", wrap)
    # radius 1 suppresses nothing, so the wrap-run corner itself must show
    if not bool(torch.isfinite(check_cells_verbose("wrap", wrap,
                                                   radius=1)[0][3, 32])):
        fail("K1 missed the wrap-run corner")

    # -- K7, K8: dense FAST + Harris (+ NMS) vs plain, bit-exact -------------
    crop = img[:H - 1, :W - 3].contiguous()          # ragged tiles both ways
    noisy = (img.to(torch.int32) + torch.from_numpy(np.random.default_rng(
        9).integers(-24, 25, (H, W))).to(dev)).clamp(0, 255).to(torch.uint8)
    for label, image in (("scene", sparse), ("tiled scene", img),
                         ("tie", tie), ("wrap", wrap), ("crop", crop),
                         ("tiled scene + noise", noisy),
                         ("equal responses",
                          torch.from_numpy(equal_image(H, W)).to(dev)),
                         ("equal responses, less than a tile",
                          torch.from_numpy(equal_image(31, 63)).to(dev)),
                         ("31x63 crop, less than a tile",
                          img[1084:1115, 1500:1563].contiguous()),
                         ("97x65 crop", img[1000:1097, 1500:1565].contiguous())):
        resp8 = DK.fast_harris(image, 20)
        check_same(f"K8 {label}", "fast_harris", resp8,
                   DK.fast_harris_ref(image, 20))
        live = []
        for radius in (1, 3, 5, 9):
            got = DK.fast_harris_nms(image, 20, radius)
            check_same(f"K7 {label} radius {radius}", "fast_harris_nms", got,
                       DK.fast_harris_nms_ref(image, 20, radius))
            live.append(int(torch.isfinite(got).sum()))
        corners = int(torch.isfinite(resp8).sum())
        if label.startswith("equal") and live != [corners] * 4:
            fail(f"K7 {label}: of {corners} tied corners {live} survive")
        print(f"K7, K8 {label} {tuple(image.shape)}: bit-exact; "
              f"{corners} corners, survivors at radius 1/3/5/9: {live}")
        if image.shape == (H, W) and label != "scene":
            k7_ms = [time_ms(lambda: DK.fast_harris_nms(image, 20, r),
                             iters=5, warmup=1) for r in (5, 9)]
            print(f"time K7 {label} {H}x{W}, one launch at radius 5 / 9: "
                  f"{k7_ms[0]:.3f} / {k7_ms[1]:.3f} ms [{hw}]")
    del noisy
    # radius 1 suppresses nothing, so the wrap-run corner itself must show
    if not bool(torch.isfinite(DK.fast_harris_nms(wrap, 20, 1)[24, 32])):
        fail("K7 missed the wrap-run corner")

    # -- K9: disc NMS at any radius vs plain, bit-exact -----------------------
    mask_rng = np.random.default_rng(5)
    rnd = torch.from_numpy(mask_rng.random((H, W)) < 0.5).to(dev)
    resp8 = DK.fast_harris(img, 20)
    for label, resp in (("unmasked", resp8),
                        ("random mask", torch.where(rnd, resp8,
                                                    D.RESP_SENTINEL))):
        live = []
        for radius in (3, 9, 15, 49, 64, 128):
            got = DK.radius_nms(resp, radius)
            check_same(f"K9 {label} radius {radius}", "radius_nms", got,
                       DK.radius_nms_ref(resp, radius))
            live.append(int(got.sum()))
        print(f"K9 tiled scene {H}x{W} {label}: bit-exact; survivors at "
              f"radius 3/9/15/49/64/128: {live}")
    del resp8

    # -- K10: the pyramid's resize vs plain, bit-exact ------------------------
    def check_resize(label, src, dst_hw):
        got = I.resize_u8_kernel(src, dst_hw)
        check_same(f"K10 {label} {tuple(src.shape)} -> {dst_hw}",
                   "resize_u8_kernel", got, I.resize_u8(src, dst_hw))
        return got

    shapes = S.pyramid_shapes(H, W, 1.2, 8)
    level = img
    for lvl in range(1, 8):
        level = check_resize(f"level {lvl}", level, shapes[lvl])
    noise = torch.from_numpy(mask_rng.integers(0, 256, (H, W),
                                               dtype=np.uint8)).to(dev)
    white = torch.full((H, W), 255, dtype=torch.uint8, device=dev)
    check_resize("noise", noise, shapes[1])
    if not bool((check_resize("all-255", white, shapes[1]) == 255).all()):
        fail("K10: an all-255 image did not stay all-255")
    crop_shapes = S.pyramid_shapes(H - 1, W - 3, 1.2, 8)
    check_resize("odd crop", crop, crop_shapes[1])
    check_resize("odd crop of noise", noise[:H - 1, :W - 3].contiguous(),
                 crop_shapes[2])
    check_resize("upscale", level, shapes[4])
    check_resize("tiny", level, (16, 20))
    check_resize("tiny", level, (8, 8))
    print(f"K10 {H}x{W}: bit-exact on the 7 pyramid levels {shapes[1:]}, on "
          f"noise and all-255 (stays 255), on a {H - 1}x{W - 3} source to "
          f"{crop_shapes[1]} and {crop_shapes[2]}, on the upscale "
          f"{tuple(level.shape)} -> {shapes[4]} and on 16x20 and 8x8 "
          "destinations")
    del white, level

    # -- K1 with its ROI mask vs plain, bit-exact -----------------------------
    roi_np = SC.roi_mask(H, W)
    roi = torch.from_numpy(roi_np).to(dev)

    # every radius >= 10 is K1's: beyond the former shared-memory plan (48),
    # and where corners are dense (uniform noise: no list may drop one)
    for radius in (48, 49, 64, 128):
        cnt = [int(check_cells(f"{label}{' roi' if m is not None else ''}",
                               image, radius, m)[2].sum())
               for label, image in (("scene", sparse), ("dense scene", img))
               for m in (None, roi != 0)]
        print(f"K1 {H}x{W} radius {radius}: bit-exact on the scene and the "
              f"dense scene, unmasked and under the ROI (survivors {cnt})")
    for radius in (15, 64):
        got = check_cells("noise", noise, radius)
        print(f"K1 uniform noise {H}x{W} radius {radius}: bit-exact, "
              f"{int(DK.border_corners(noise, 20).sum())} corners, "
              f"{int(got[2].sum())} survivors")
    del noise
    # no corner suppresses another, so each scans its whole disc: the most
    # the NMS can be asked for at a corner count
    equal = torch.from_numpy(equal_image(H, W)).to(dev)
    n_equal = int(DK.border_corners(equal, 20).sum())
    for radius in (15, 64):
        got = check_cells("equal responses", equal, radius)
        if int(got[2].sum()) != n_equal:
            fail(f"K1 equal responses radius {radius}: {int(got[2].sum())} "
                 f"survivors of {n_equal} tied corners")
        e_ms = time_ms(lambda: DK.fast_harris_nms_cells(equal, 20, radius),
                       iters=5, warmup=1)
        e_b, e_by = bound("fast_harris_nms_cells",
                          [((equal, 20, radius), {})])
        print(f"K1 equal responses {H}x{W} radius {radius}: bit-exact, all "
              f"{n_equal} tied corners survive, each scanning its whole "
              f"disc: {e_ms:.3f} ms, bound {e_b:.4f} ms by {e_by} [{hw}]")
    del equal
    for radius in (10, 15, 22, 48):
        unmasked = DK.fast_harris_nms_cells(img, 20, radius)
        cnt = []
        for label, m in (("roi", roi != 0), ("random", rnd),
                         ("all-255", torch.ones_like(rnd))):
            got = check_cells(f"mask {label}", img, radius, m)
            cnt.append(int(got[2].sum()))
        if not all(torch.equal(a, b) for a, b in zip(got, unmasked)):
            fail(f"K1 radius {radius}: an all-255 mask differs from none")
        print(f"K1 masked {H}x{W} radius {radius}: bit-exact under the ROI, "
              f"a random and an all-255 mask (survivors {cnt}; unmasked "
              f"{int(unmasked[2].sum())}, equal to all-255)")

    # the tie image under a mask that cuts one tied block: the masked dense
    # fallback runs on the card
    D.select_topk_cells.fallbacks = 0
    tie_kps = [EfficientFeatures(nfeatures=64, nlevels=1,
                                 descriptor_type="bad_256", device=d).detect(
                                     tie_image(), mask=tie_mask())._slots
               for d in ("cuda", "cpu")]
    if D.select_topk_cells.fallbacks != 2 or int(tie_kps[1]["count"]) != 3 \
            or not all(torch.equal(tie_kps[0][k].cpu(), tie_kps[1][k])
                       for k in tie_kps[1] if k != "angle") or float(
                (tie_kps[0]["angle"].cpu() - tie_kps[1]["angle"]).abs().max()
            ) >= ANGLE_TOL:
        fail("masked tie image: the dense fallback on the card differs from "
             f"the CPU ({D.select_topk_cells.fallbacks} fallbacks)")
    print("masked tie image detect: dense fallback taken with the mask, "
          f"{int(tie_kps[0]['count'])} keypoints (3 expected), slots "
          "bit-identical to the CPU port")

    stamp("K2, K3, K4, K5, K11 against plain")
    # -- K2: IC moments, exact ----------------------------------------------
    ys = rng.integers(0, H, N_KP).astype(np.int32)
    xs = rng.integers(0, W, N_KP).astype(np.int32)
    ys[:8] = [0, 0, H - 1, H - 1, 14, H - 15, 7, H // 2]
    xs[:8] = [0, W - 1, 0, W - 1, W // 2, 14, W - 15, 3]
    ys_t = torch.from_numpy(ys).to(dev)
    xs_t = torch.from_numpy(xs).to(dev)
    m_got = WK.ic_moments_windows(img, ys_t, xs_t)
    m_ref = O.ic_moments(img, ys_t, xs_t)
    if not torch.equal(m_got, m_ref):
        bad = (m_got != m_ref).any(dim=1).nonzero()[:5].flatten().tolist()
        fail(f"K2 moments differ at keypoints {bad}")
    errs["ic_moments_windows"] = max_abs_err(m_got, m_ref)
    print(f"K2 {N_KP} keypoints (edges included): moments exact")

    # -- K3: BAD byte for byte: size 31, 64-300 px, the window limit, edges -
    kx = rng.uniform(0, W - 1, N_KP).astype(np.float32)
    ky = rng.uniform(0, H - 1, N_KP).astype(np.float32)
    kx[:8] = [0, W - 1, 0, W - 1, 0.5, W - 1.5, 14.0, 27.125]
    ky[:8] = [0, 0, H - 1, H - 1, 0.5, H - 1.5, 14.0, 27.125]
    ka = rng.uniform(0, 360, N_KP).astype(np.float32)
    ka[::97] = -1.0
    kvalid = rng.random(N_KP) < 0.95
    big = rng.uniform(64.0, 300.0, N_KP).astype(np.float32)
    big[:8] = [64.0, 300.0, 111.0, 192.5, 300.0, 64.0, 150.0, 300.0]
    # s = 1.125 (size 36) is the largest a warp's window integral takes
    limit = rng.choice(np.float32([34.0, 35.9, 36.0, 36.1, 37.2, 44.6]), N_KP)

    def check_bad(label, image, kp, quiet=False):
        """K3 against its plain version at 256 and 512 bits: 0 bytes may
        differ."""
        for nbits in (256, 512):
            d_got = WK.bad_descriptors_windows(image, *kp, nbits, 1.0)
            d_ref = WK.bad_descriptors_windows_ref(image, *kp, nbits, 1.0)
            ndiff = int((d_got != d_ref).sum())
            if d_got.shape != d_ref.shape or ndiff:
                fail(f"K3 {label} {nbits} bits: {ndiff} bytes differ from "
                     f"the plain version")
            errs["bad_descriptors_windows"] = max(
                errs["bad_descriptors_windows"], max_abs_err(d_got, d_ref))
            if not quiet:
                print(f"K3 {label}, {nbits} bits, {kp[0].shape[0]} keypoints "
                      "(corners, edges and the 27.125 px branch boundary "
                      "included): byte for byte")

    for image, sizes, what in (
            (blurred, np.full(N_KP, 31.0, np.float32), "size 31"),
            (img, big, "sizes 64-300 px"),
            (img, limit, "sizes 34-44.6 px, both sides of the window limit")):
        kp = [torch.from_numpy(a).to(dev) for a in (kx, ky, sizes, ka,
                                                    kvalid)]
        check_bad(what, image, kp)
        plan = B.window_plan(kp[0], kp[1], kp[2] / 32.0, H, W)
        print(f"K3 {what}: {int((plan.in_smem & kp[4]).sum())} valid "
              "keypoints on the window branch, "
              f"{int((~plan.in_smem & kp[4]).sum())} on the integral branch")
        # the border branch, and within it the wide-box (trunc12) compare
        # for box pairs whose area product reaches 2^22, run at these sizes
        s = kp[2] / 32.0
        bw = 28.0 * s
        border = ((kp[0] < bw) | (kp[0] + bw >= W) | (kp[1] < bw)
                  | (kp[1] + bw >= H)) & kp[4]
        side = 2 * torch.round(s[:, None] * bad_params(512, str(dev)).boxes[4]
                               [None, :]) + 1
        wide = border & ((side * side) ** 2 >= 2.0 ** 22).any(dim=1)
        print(f"K3 {what}: {int(border.sum())} valid keypoints on the border "
              f"branch, {int(wide.sum())} of them with 512-bit box pairs of "
              "area product >= 2^22 before clamping")
    # images 1-3 px tall or wide, keypoints in and around them; n = 1 and
    # every slot invalid
    edge_rng = np.random.default_rng(8)
    for shape in ((1, 1), (1, 40), (40, 1), (2, 3), (3, 2), (3, 50)):
        tiny = torch.from_numpy(edge_rng.integers(0, 256, shape,
                                                  dtype=np.uint8)).to(dev)
        n = 64
        ex = edge_rng.uniform(-40.0, shape[1] + 40.0, n).astype(np.float32)
        ey = edge_rng.uniform(-40.0, shape[0] + 40.0, n).astype(np.float32)
        esz = edge_rng.uniform(31.0, 300.0, n).astype(np.float32)
        esz[::3] = 31.0
        ekp = [torch.from_numpy(a).to(dev) for a in (ex, ey, esz, ka[:n])]
        for k, ok in ((n, np.ones(n, bool)), (n, np.zeros(n, bool)),
                      (1, np.ones(1, bool))):
            check_bad(f"{shape[0]}x{shape[1]} image, n = {k}", tiny,
                      [t[:k] for t in ekp] + [torch.from_numpy(ok).to(dev)],
                      quiet=True)
    print("K3 images 1x1, 1x40, 40x1, 2x3, 3x2, 3x50 (64 keypoints in and "
          "around each, all valid / all invalid, and n = 1): byte for byte")

    # -- K4: HashSIFT warp, bit-exact expected --------------------------------
    warp_sizes = np.array([31.0 * 1.2 ** k for k in range(8)] + [300.0],
                          np.float32)
    ksz = warp_sizes[np.arange(N_KP) % len(warp_sizes)]
    wkp = [torch.from_numpy(a).to(dev) for a in (kx, ky, ksz, ka, kvalid)]
    patches = WK.warp_patches_windows(img, *wkp, 1.0)
    p_ref = WK.warp_patches_windows_ref(img, *wkp, 1.0)
    dmax, dshare = u8_diff(patches, p_ref)
    if dmax > 1 or dshare >= WARP_SHARE:
        fail(f"K4 patches differ from plain: max {dmax}, share {dshare}")
    errs["warp_patches_windows"] = max_abs_err(patches, p_ref)
    print(f"K4 {N_KP} keypoints, sizes "
          f"{[round(float(v), 2) for v in warp_sizes]} (edges and angle -1 "
          f"included): max |diff| {dmax}, differing "
          f"share {dshare:.3e} ({'bit-exact' if dmax == 0 else 'not exact'})")

    # -- K5: HashSIFT histogram, deterministic --------------------------------
    zero_rows = torch.arange(5, N_KP, 1001, device=dev)
    patches[zero_rows] = 0
    rows = WK.hs_hist_from_patches(patches)
    r_ref = WK.hs_hist_from_patches_ref(patches)
    dmax, dshare = u8_diff(rows, r_ref)
    if dmax > 1 or dshare >= HIST_SHARE:
        fail(f"K5 rows differ from plain: max {dmax}, share {dshare}")
    if int(rows[zero_rows].to(torch.int32).sum()) != 0:
        fail("K5: an all-zero patch gave a nonzero row")
    again = WK.hs_hist_from_patches(patches)
    if not torch.equal(rows, again):
        fail(f"K5 is not deterministic: {int((rows != again).sum())} bytes "
             "changed between two runs")
    errs["hs_hist_from_patches"] = max_abs_err(rows, r_ref)
    print(f"K5 {N_KP} patches ({empty_patches(patches)} all-zero): max |diff| "
          f"{dmax}, differing share {dshare:.3e}, "
          f"{int((rows != r_ref).sum())} of {rows.numel()} entries differ "
          "from plain (5 with the earlier one-block-per-patch kernel); zero "
          "patches give zero rows; two runs bit-identical; blocks of 8 "
          f"patches per SM (K5, K11): {WK.hs_blocks_per_sm()}")

    # -- projection: full f32 whatever the caller's matmul precision -------
    kvalid_t = wkp[4]
    for nbits in (256, 512):
        want = P._hs_from_fused(rows, kvalid_t, nbits)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            got = P._hs_from_fused(rows, kvalid_t, nbits)
            kept = torch.get_float32_matmul_precision()
            prm = hash_sift_params(nbits, str(dev))
            tf32 = B.pack_bits_msb(
                ((rows.to(torch.float32) @ prm.bp.T + prm.b0) > 0)
                & kvalid_t[:, None])
        finally:
            torch.set_float32_matmul_precision(prev)
        if not torch.equal(got, want) or kept != "high":
            fail(f"projection {nbits}: bytes changed under "
                 f"set_float32_matmul_precision('high') or the setting was "
                 f"not restored ({kept})")
        print(f"projection {nbits} bits: bytes unchanged under "
              f"set_float32_matmul_precision('high'), setting restored; an "
              f"unguarded product there differs in "
              f"{int((tf32 != want).sum())} bytes")

    # -- K11: fused HashSIFT = K5 on K4's patches, bit for bit ---------------
    def check_fused(label, image, kp, quiet=False):
        """K11 against K5 on K4's patches (bytes), both against their plain
        versions (HIST_SHARE), zero rows for invalid slots and all-zero
        patches, the same bytes on a second run of each."""
        rows = WK.hs_desc_windows(image, *kp, 1.0)
        patches = WK.warp_patches_windows(image, *kp, 1.0)
        staged = WK.hs_hist_from_patches(patches)
        torch.cuda.synchronize()
        if not torch.equal(rows, staged):
            bad = (rows != staged).nonzero()[:5].tolist()
            fail(f"K11 {label}: rows differ from K5(K4(.)), first differing "
                 f"(row, entry) {bad}")
        ref = WK.hs_desc_windows_ref(image, *kp, 1.0)
        dmax, dshare = u8_diff(rows, ref)
        d5max, d5share = u8_diff(staged, WK.hs_hist_from_patches_ref(patches))
        if max(dmax, d5max) > 1 or max(dshare, d5share) >= HIST_SHARE:
            fail(f"K11 / K5 {label}: rows differ from plain: max {dmax} / "
                 f"{d5max}, share {dshare} / {d5share}")
        empty = (patches == 0).all(dim=1)
        if int(rows[~kp[4]].to(torch.int32).sum()) != 0 or \
                not bool(empty[~kp[4]].all()):
            fail(f"K11 {label}: an invalid slot gave a nonzero row")
        if int(staged[empty].to(torch.int32).sum()) != 0:
            fail(f"K5 {label}: an all-zero patch gave a nonzero row")
        if not torch.equal(rows, WK.hs_desc_windows(image, *kp, 1.0)) or \
                not torch.equal(staged, WK.hs_hist_from_patches(patches)):
            fail(f"K11 / K5 {label}: two runs differ")
        errs["hs_desc_windows"] = max(errs["hs_desc_windows"],
                                      max_abs_err(rows, ref))
        if not quiet:
            print(f"K11 {label}: {rows.shape[0]} slots "
                  f"({int((~kp[4]).sum())} invalid, {int(empty.sum())} "
                  f"all-zero patches, zero rows): bytes identical to "
                  f"K5(K4(.)); against plain max |diff| {dmax} (K5 {d5max}),"
                  f" differing share {dshare:.3e} (K5 {d5share:.3e}); two "
                  "runs of each bit-identical")

    det = P.detect(img, P.FeatureConfig(nfeatures=NFEATURES))
    check_fused("detected keypoints at size 31 on the blurred level 0",
                blurred, (det["x"], det["y"],
                          torch.full_like(det["x"], 31.0), det["angle"],
                          det["valid"]))
    fsz = np.random.default_rng(11).uniform(31.0, 300.0, N_KP).astype(
        np.float32)
    fsz[:8] = [31.0, 300.0, 31.0, 300.0, 64.0, 111.0, 31.0, 192.5]
    check_fused("host keypoints of sizes 31-300 px (image corners, angle -1 "
                "included)", img,
                [torch.from_numpy(a).to(dev) for a in (kx, ky, fsz, ka,
                                                       kvalid)])
    edge = [torch.from_numpy(a).to(dev) for a in edge_case()]
    check_fused("saturated 0/255 edge image", edge[0], edge[1:])
    del det

    # -- K5 / K11 at the edges of their 8-patch blocks -----------------------
    def block_case(n, image, seed):
        """n keypoints of size 31 on `image` with `block_edge_valid(n)`, and
        one valid keypoint off the image (an all-zero patch) when n > 1."""
        r = np.random.default_rng(seed)
        h, w = image.shape
        x = r.uniform(0, w - 1, n).astype(np.float32)
        y = r.uniform(0, h - 1, n).astype(np.float32)
        if n > 1:
            x[n // 2] = -500.0
        a = r.uniform(0, 360, n).astype(np.float32)
        a[::5] = -1.0
        return [torch.from_numpy(v).to(dev) for v in (
            x, y, np.full(n, 31.0, np.float32), a, block_edge_valid(n))]

    sizes = (1, 7, 9, 999, 1001, 147)
    for n in sizes:
        check_fused(f"block edge n={n}", img, block_case(n, img, n),
                    quiet=True)
    check_fused("block edge n=147 on the 0/255 edge image", edge[0],
                block_case(147, edge[0], 147), quiet=True)
    print(f"K5, K11 at the edges of their 8-patch blocks: n = {sizes} on the "
          "tiled scene and 147 on the saturated 0/255 edge image (empty "
          "patches / invalid slots at every position of a block, a block of "
          "only those, blocks with one live patch, a valid keypoint off the "
          "image): K11 = K5(K4(.)) byte for byte, both within HIST_SHARE of "
          "plain, zero rows where the patch is empty or the slot invalid, "
          "two runs bit-identical")

    stamp("K6 against plain")
    # -- K6: best-2 Hamming search, bit-identical -----------------------------
    def check_knn2(label, q, vq, t, vt):
        got = TM.knn2_topk2(q, vq, t, vt)
        want = TM.knn2_topk2_ref(q, vq, t, vt)
        torch.cuda.synchronize()
        for what, a, b in zip(("idx", "best", "second"), got, want):
            if a.dtype != torch.int32 or not torch.equal(a, b):
                bad = (a != b).nonzero()[:5].flatten().tolist()
                fail(f"K6 {label}: {what} differs from plain at rows {bad}")
        errs["knn2_topk2"] = max([errs["knn2_topk2"]]
                                 + [max_abs_err(a, b) for a, b in
                                    zip(got, want)])
        return got

    def knn2_inputs(nbytes, n1, n2, pool=False):
        if pool:         # ties everywhere, a duplicate across train tiles
            p = rng.integers(0, 256, (6, nbytes), dtype=np.uint8)
            d1, d2 = p[rng.integers(0, 6, n1)], p[rng.integers(0, 6, n2)]
            d2[n2 - 10] = d2[5]
        else:            # random train rows, half the queries near one
            d2 = rng.integers(0, 256, (n2, nbytes), dtype=np.uint8)
            d1 = rng.integers(0, 256, (n1, nbytes), dtype=np.uint8)
            d1[::2] = noisy_copies(rng, d2, len(d1[::2]), 0.05)
        v1 = torch.from_numpy(rng.random(n1) > 0.2).to(dev)
        v2 = torch.from_numpy(rng.random(n2) > 0.2).to(dev)
        return (torch.from_numpy(d1).to(dev), v1,
                torch.from_numpy(d2).to(dev), v2)

    for nbytes in (32, 64):
        q, v1, t, v2 = knn2_inputs(nbytes, N_KP, N_KP)
        check_knn2(f"{8 * nbytes} bits unmasked", q, None, t, None)
        j, best, _ = check_knn2(f"{8 * nbytes} bits masked", q, v1, t, v2)
        if not (bool((j[~v1] == 0).all())
                and bool((best[~v1] == TM.BIG).all())):
            fail("K6: a row with no valid pair is not (j 0, best 1 << 30)")
        for fn, args in (("match", (q, t)), ("knn2_ratio_match", (q, t)),
                         ("knn2_ratio_match_masked", (q, v1, t, v2))):
            before = TM.knn2_topk2.launches
            got = getattr(TM, fn)(*args)
            launched = TM.knn2_topk2.launches - before
            with plain_kernels():
                want = getattr(TM, fn)(*args)
            if launched != 2 or not all(torch.equal(a, b)
                                        for a, b in zip(got, want)):
                fail(f"{fn} {8 * nbytes} bits: {launched} K6 launches, or "
                     "outputs differ from the plain route")
            print(f"{fn} {8 * nbytes} bits {N_KP} x {N_KP}: 2 K6 launches, "
                  f"outputs identical to the plain route, "
                  f"{int(got[2].sum())} kept")
        qp, v1p, tp, v2p = knn2_inputs(nbytes, N_KP, N_KP - 1, pool=True)
        check_knn2(f"{8 * nbytes} bits tie pool", qp, None, tp, None)
        check_knn2(f"{8 * nbytes} bits tie pool masked", qp, v1p, tp, v2p)
        j, best, second = check_knn2(f"{8 * nbytes} bits no valid train row",
                                     qp[:1000], v1p[:1000], tp,
                                     torch.zeros_like(v2p))
        if bool((j != 0).any()) or bool((best != TM.BIG).any()):
            fail("K6: no valid train row did not give (j 0, best 1 << 30)")
        # small and ragged shapes: one block, a skinny query side, one off
        # a 128-row tile on both sides; every query invalid; a second run
        for n1, n2 in ((64, 64), (1000, N_KP), (129, 257), (127, 255)):
            for pool in (False, True):
                qs, v1s, ts, v2s = knn2_inputs(nbytes, n1, n2, pool=pool)
                what = f"{8 * nbytes} bits {n1} x {n2}" \
                    f"{' tie pool' if pool else ''}"
                check_knn2(what, qs, None, ts, None)
                check_knn2(what + " masked", qs, v1s, ts, v2s)
        j, best, second = check_knn2(f"{8 * nbytes} bits every query invalid",
                                     qs, torch.zeros_like(v1s), ts, v2s)
        if bool((j != 0).any()) or bool((best != TM.BIG).any()) or \
                bool((second != TM.BIG).any()):
            fail("K6: invalid queries did not give (0, 1 << 30, 1 << 30)")
        first = TM.knn2_topk2(q, v1, t, v2)
        again = TM.knn2_topk2(q, v1, t, v2)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"K6 {8 * nbytes} bits: two runs differ")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            TM.knn2_topk2(q, v1, t, v2)
            torch.cuda.synchronize()
        k6_launches = {k: sum(e.count for e in prof.key_averages()
                              if k in e.key)
                       for k in ("knn2_prep_kernel", "knn2_mma_kernel",
                                 "knn2_merge_kernel")}
        if any(c != 1 for c in k6_launches.values()):
            fail(f"K6: kernel launches of one wrapper call {k6_launches}, "
                 "expected one of each")
        print(f"K6 {8 * nbytes} bits: bit-identical to plain at {N_KP} x "
              f"{N_KP} unmasked and masked (20% invalid each side; invalid "
              f"rows give j 0, best 1 << 30), on a 6-descriptor tie pool at "
              f"{N_KP} x {N_KP - 1} (duplicate across tiles, n2 not a "
              f"multiple of 128), with no valid train row, at 64 x 64, "
              f"1000 x {N_KP}, 129 x 257 and 127 x 255 (random and tie pool, "
              f"unmasked and masked), with every query invalid; two runs "
              f"bit-identical; one call launches {k6_launches}; split "
              f"{TM.knn2_plan(N_KP, N_KP)[0]} train rows a block")

    stamp("main path 1: detect_and_compute")
    # -- main path 1: detect_and_compute through the kernels ----------------
    selection = ("x", "y", "octave", "size", "response", "valid", "count")
    detected = None
    for dtype in ("bad_256", "bad_512", "hash_sift_256", "hash_sift_512"):
        kind = dtype.rsplit("_", 1)[0]
        ef = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                               device="cuda")
        D.select_topk_cells.fallbacks = 0
        with no_integral():
            (kps, desc), counts = drive(
                f"detect_and_compute {dtype}",
                lambda: ef.detect_and_compute_async(scene),
                detect_kernels + desc_kernels[kind])
        fallbacks = D.select_topk_cells.fallbacks
        n = kps.count
        slots = kps._slots
        if not (0 < n <= NFEATURES) or desc.shape != (kps.capacity,
                                                      ef.descriptor_size()):
            fail(f"{dtype}: {n} keypoints, descriptors {tuple(desc.shape)}")
        for k in ("x", "y", "response", "angle", "size"):
            if not bool(torch.isfinite(slots[k]).all()):
                fail(f"{dtype}: non-finite {k}")
        if bool((desc[~slots["valid"]] != 0).any()):
            fail(f"{dtype}: an invalid slot has a nonzero descriptor row")
        with plain_kernels():
            kps_p, desc_p = ef.detect_and_compute_async(scene)
        for k in selection + ("angle",):
            if not torch.equal(slots[k], kps_p._slots[k]):
                fail(f"{dtype}: slot {k!r} differs from the plain path")
        ndiff_p = int((desc != desc_p).sum())
        ef_cpu = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                                   device="cpu")
        kps_c, desc_c = ef_cpu.detect_and_compute_async(scene)
        for k in selection:
            if not torch.equal(slots[k].cpu(), kps_c._slots[k]):
                fail(f"{dtype}: slot {k!r} differs from the CPU port")
        dang = (slots["angle"].cpu() - kps_c._slots["angle"]).abs()
        dang = float(torch.minimum(dang, 360 - dang).max())
        ndiff_c = int((desc.cpu() != desc_c).sum())
        budget = byte_budget(kind, desc.numel())
        if max(ndiff_p, ndiff_c) > budget or dang >= ANGLE_TOL:
            fail(f"{dtype}: descriptor bytes differ plain {ndiff_p} / cpu "
                 f"{ndiff_c} (budget {budget}), angle {dang}")
        print(f"slice {dtype}: {n} keypoints of {kps.capacity} slots; "
              f"launches {counts}; dense tie fallbacks {fallbacks} of "
              f"{ef.get_n_levels()} levels; slots bit-identical to the plain "
              f"path on the card and to the CPU port (angles max "
              f"{dang:.2e} deg); descriptor bytes differing: plain "
              f"{ndiff_p}, cpu {ndiff_c} (budget {budget})")
        if detected is None:
            detected = kps
        if dtype == "bad_256":
            k3_calls = last_calls["bad_descriptors_windows"]
            with no_integral():
                k3_kernels = kernel_names(lambda: [
                    WK.bad_descriptors_windows(*a, **k) for a, k in k3_calls])
            scans = [k for k in k3_kernels
                     if "scan" in k.lower() or "cumsum" in k.lower()]
            if scans or not any("bad_kernel" in k for k in k3_kernels):
                fail(f"K3's wrapper: scan kernels {scans}, kernels "
                     f"{k3_kernels}")
            # every window fits a warp's integral, so K3's integral passes
            # return at once: no integral of the level is built
            for a, _ in k3_calls:
                image, kx_, ky_, size_, _, valid_, _, scale_ = a
                plan = B.window_plan(kx_, ky_, float(np.float32(scale_))
                                     * size_.to(torch.float32) / 32.0,
                                     *image.shape)
                if not bool((plan.in_smem | ~valid_).all()):
                    fail("K3 on detect_and_compute: a window does not fit "
                         "a warp's integral")
            listed = {k[:48]: (c, round(t, 4))
                      for k, (c, t) in k3_kernels.items()}
            print(f"K3's wrapper, the {len(k3_calls)} calls of this slice: "
                  "no torch integral and no scan kernel; every window in "
                  "shared memory, so K3's own integral passes return at "
                  f"once; kernels (launches, ms) {listed}")

        syncs = host_syncs(lambda: ef.detect_and_compute_async(img))
        slice_ms = time_ms(lambda: ef.detect_and_compute_async(img))
        with plain_kernels():
            plain_slice = time_ms(lambda: ef.detect_and_compute_async(img))
        print(f"time slice {dtype} {H}x{W} nfeatures {NFEATURES}: "
              f"{slice_ms:.3f} ms/call through the kernels, "
              f"{plain_slice:.3f} ms/call plain; host syncs per call "
              f"{syncs} [{hw}]")

    stamp("main path 2: compute()")
    # -- main path 2: standalone compute() through the kernels --------------
    hk = np.stack([kx, ky, rng.uniform(31.0, 300.0, N_KP), ka],
                  axis=1).astype(np.float32)
    hk[::2, 2] = ksz[::2]            # half on the 31*1.2^k / 300 px ladder
    hk_dev = torch.from_numpy(hk).to(dev)
    for cls, nbits in ((BAD, 256), (BAD, 512), (HashSIFT, 256),
                       (HashSIFT, 512)):
        describer = cls(1.0, nbits, device="cuda")
        kind = describer._kind
        label = f"{cls.__name__}-{nbits}"
        for what, kin in (("detected keypoints", detected),
                          (f"{N_KP} host keypoints", hk)):
            with no_integral():
                got, counts = drive(f"compute {label} on {what}",
                                    lambda: describer.compute_async(img, kin),
                                    desc_kernels[kind])
            if label == "BAD-256" and what != "detected keypoints":
                compute_k3_calls = last_calls["bad_descriptors_windows"]
            with plain_kernels():
                want = describer.compute_async(img, kin)
            ndiff = int((got != want).sum())
            budget = byte_budget(kind, want.numel())
            if got.shape != want.shape or ndiff > budget:
                fail(f"compute {label} on {what}: {ndiff} differing bytes "
                     f"(budget {budget}), shapes {tuple(got.shape)} "
                     f"{tuple(want.shape)}")
            print(f"compute {label} on {what}: launches {counts}; "
                  f"{ndiff} bytes differ from the plain path (budget "
                  f"{budget})")
        comp_ms = time_ms(lambda: describer.compute_async(img, hk_dev))
        with plain_kernels():
            plain_comp = time_ms(lambda: describer.compute_async(img, hk_dev))
        print(f"time compute {label}, {N_KP} keypoints of sizes 31-300 px "
              f"on {H}x{W}: {comp_ms:.3f} ms/call through the kernels, "
              f"{plain_comp:.3f} ms/call plain [{hw}]")

    stamp("main paths 3 and 4: sequence, two-image")
    # -- main path 3: the image-sequence step, through the kernels ----------
    match_kernels = (detect_kernels + desc_kernels["hash_sift"]
                     + ["knn2_topk2"])
    base = SC.tiled_scene(H, W, seed=2160, distinct=True)
    ty_rng = np.random.default_rng(0)          # as the sample's frame_iter
    moves = [(2.0 * i, 5.0 * i, float(ty_rng.uniform(-3, 3)))
             for i in range(SEQ_FRAMES)]
    frames = [SC.warp_image(base, *mv) for mv in moves]
    warps = [SC.warp_matrix((H, W), *mv) for mv in moves]
    frames_dev = [torch.from_numpy(f).to(dev) for f in frames]
    ef = EfficientFeatures(nfeatures=NFEATURES,
                           descriptor_type="hash_sift_256", device="cuda")

    def check_geometry(label, n_match, n_inl, Hm, H_true):
        share = n_inl / max(n_match, 1)
        err = corner_err(Hm, H_true, (H, W))
        if n_match < MATCH_FLOOR or share <= INLIER_FLOOR or \
                not err < CORNER_TOL:
            fail(f"{label}: {n_match} matches (floor {MATCH_FLOOR}), "
                 f"inlier share {share:.4f} (floor {INLIER_FLOOR}), corner "
                 f"error {err:.3f} px (tolerance {CORNER_TOL})")
        return (f"{n_match} matches, {n_inl} inliers (share {share:.4f}), "
                f"corner error {err:.4f} px")

    step, state = SIS.streaming_step_fn(
        ef._cfg, (H, W), homography=True, ransac_iters=256,
        ransac_thresh=RANSAC_THRESH, device="cuda")
    seq, counts = drive("image sequence",
                        lambda: [step(f) for f in frames_dev], match_kernels,
                        detect_calls=SEQ_FRAMES)
    for i in range(1, SEQ_FRAMES):
        count, n_match, Hm, n_inl = seq[i]
        got = check_geometry(f"sequence frame {i}", int(n_match), int(n_inl),
                             Hm.cpu().numpy(),
                             warps[i] @ np.linalg.inv(warps[i - 1]))
        print(f"sequence frame {i}: {int(count)} keypoints, {got}")
    seq_syncs = host_syncs(lambda: step(frames_dev[1]))
    seq_ms = time_ms(lambda: step(frames_dev[1]), iters=10)
    print(f"sequence path {H}x{W}, HashSIFT-256, {NFEATURES} features, "
          f"RANSAC 256 iterations: launches {counts}; "
          f"{seq_ms:.3f} ms/step, host syncs per step {seq_syncs} [{hw}]")

    # -- main path 4: the two-image sample path, through the kernels --------
    def two_image():
        k1, d1 = ef.detect_and_compute(frames[0])
        k2, d2 = ef.detect_and_compute(frames[1])
        j, dist, valid = TM.match(torch.from_numpy(d1).to(dev),
                                  torch.from_numpy(d2).to(dev))
        src = k1.xysa()[:, :2]
        dst = k2.xysa()[:, :2][j.cpu().numpy()]
        return (valid,) + RS.find_homography_ransac(
            src, dst, valid, iters=512, thresh=RANSAC_THRESH, device="cuda")

    (valid, Hm, inl, n_inl), counts = drive("two-image matching", two_image,
                                            match_kernels, detect_calls=2)
    got = check_geometry("two-image", int(valid.sum()), int(n_inl),
                         Hm.cpu().numpy(), warps[1] @ np.linalg.inv(warps[0]))
    if bool((inl & ~valid).any()):
        fail("two-image: RANSAC kept a match the cross check dropped")
    print(f"two-image path frames 0 -> 1: launches {counts}; {got}")

    stamp("main path 5: detector configurations")
    # -- main path 5: the detector's configurations, ROI mask and radius ----
    # (tag, nonmax_radius, with the ROI, the detect kernels of its route)
    configs = [("a", 15, True, ["fast_harris_nms_cells"]),
               ("b", 5, False, ["fast_harris_nms"]),
               ("c", 5, True, ["fast_harris", "radius_nms"]),
               ("d", 64, False, ["fast_harris_nms_cells"])]
    detect_routes = ("fast_harris_nms_cells", "fast_harris_nms",
                     "fast_harris", "radius_nms")
    config_calls = {}
    for dtype in ("hash_sift_256", "bad_256"):
        kind = dtype.rsplit("_", 1)[0]
        for tag, radius, masked, route in configs:
            ef = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=radius,
                                   descriptor_type=dtype, device="cuda")
            m_host = roi_np if masked else None
            m_dev = roi if masked else None
            label = (f"config ({tag}) {dtype} radius {radius}"
                     f"{' mask=roi' if masked else ''}")
            (kps, desc), counts = drive(
                label, lambda: ef.detect_and_compute_async(scene,
                                                           mask=m_host),
                pyramid_kernels + ["ic_moments_windows"] + route
                + desc_kernels[kind],
                forbid=[k for k in detect_routes if k not in route])
            if any(counts[k] != ef.get_n_levels() for k in route):
                fail(f"{label}: {counts} launches, expected one per level "
                     "of each detect kernel")
            config_calls.setdefault(tag, {
                k: last_calls[k] for k in route})
            slots = kps._slots
            n = kps.count
            if not (0 < n <= NFEATURES) or not all(
                    bool(torch.isfinite(slots[k]).all())
                    for k in ("x", "y", "response", "angle")):
                fail(f"{label}: {n} keypoints, or non-finite slots")
            if bool((desc[~slots["valid"]] != 0).any()):
                fail(f"{label}: an invalid slot has a nonzero descriptor row")
            with plain_kernels():
                kps_p, desc_p = ef.detect_and_compute_async(scene,
                                                            mask=m_host)
            for k in selection + ("angle",):
                if not torch.equal(slots[k], kps_p._slots[k]):
                    fail(f"{label}: slot {k!r} differs from the plain path")
            ndiff = int((desc != desc_p).sum())
            budget = byte_budget(kind, desc.numel())
            if ndiff > budget:
                fail(f"{label}: {ndiff} descriptor bytes differ from the "
                     f"plain path (budget {budget})")
            inside = ""
            if masked:      # level-0 keypoints lie inside the ROI
                lvl0 = slots["valid"] & (slots["octave"] == 0)
                ys, xs = slots["y"][lvl0].long(), slots["x"][lvl0].long()
                if not bool((roi[ys, xs] != 0).all()):
                    fail(f"{label}: a level-0 keypoint outside the ROI")
                inside = f", {int(lvl0.sum())} level-0 keypoints all inside"
            if tag == "a":
                det = ef.detect(scene, mask=roi_np)._slots
                if not all(torch.equal(det[k], slots[k]) for k in selection):
                    fail(f"{label}: detect() differs from detect_and_compute")
            syncs = host_syncs(
                lambda: ef.detect_and_compute_async(img, mask=m_dev))
            ms = time_ms(lambda: ef.detect_and_compute_async(img, mask=m_dev))
            print(f"{label}: {n} keypoints{inside}; launches {counts}; slots "
                  f"bit-identical to the plain path, {ndiff} descriptor "
                  f"bytes differ (budget {budget}); {ms:.3f} ms/call, host "
                  f"syncs per call {syncs} [{hw}]")

    stamp("main path 6: fused HashSIFT, batch")
    # -- main path 6: the fused HashSIFT route and the batch entry point ----
    two_stage = desc_kernels["hash_sift"]
    fused_kernels = detect_kernels + ["hs_desc_windows"]

    def differing_slots(a, b, keys):
        return [k for k in keys if not torch.equal(a[k], b[k])]

    for dtype in ("hash_sift_256", "hash_sift_512"):
        staged = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                                   device="cuda")
        fused = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                                  device="cuda", hs_fused=True)
        (kps, desc), counts = drive(
            f"fused detect_and_compute {dtype}",
            lambda: fused.detect_and_compute_async(scene), fused_kernels,
            forbid=two_stage)
        if counts["hs_desc_windows"] != fused.get_n_levels():
            fail(f"fused {dtype}: {counts} launches, expected 8 of K11")
        slots = kps._slots
        n = kps.count
        kps_s, desc_s = staged.detect_and_compute_async(scene)
        differ = differing_slots(slots, kps_s._slots, slots)
        if differ or not torch.equal(desc, desc_s):
            bad = (desc != desc_s).nonzero()[:1].tolist()
            fail(f"fused {dtype}: differs from the two-stage route: slots "
                 f"{differ}, first differing descriptor (slot, byte) {bad}")
        with plain_kernels():
            kps_p, desc_p = fused.detect_and_compute_async(scene)
        differ = differing_slots(slots, kps_p._slots, selection + ("angle",))
        ndiff = int((desc != desc_p).sum())
        budget = byte_budget("hash_sift", desc.numel())
        if differ or ndiff > budget or not 0 < n <= NFEATURES:
            fail(f"fused {dtype}: {n} keypoints; slots {differ} differ from "
                 f"the plain path, {ndiff} descriptor bytes (budget "
                 f"{budget})")
        print(f"fused slice {dtype}: {n} keypoints; launches {counts}, no "
              f"K4 or K5 launch; slots and descriptor bytes identical to the "
              f"two-stage route; slots bit-identical to the plain path, "
              f"{ndiff} descriptor bytes differ (budget {budget})")

        nbits = int(dtype.rsplit("_", 1)[1])
        got, counts = drive(
            f"fused compute HashSIFT-{nbits}",
            lambda: HashSIFT(1.0, nbits, device="cuda",
                             fused=True).compute_async(img, hk),
            ["hs_desc_windows"], forbid=two_stage)
        want = HashSIFT(1.0, nbits, device="cuda").compute_async(img, hk)
        with plain_kernels():
            plain = HashSIFT(1.0, nbits, device="cuda",
                             fused=True).compute_async(img, hk)
        ndiff = int((got != plain).sum())
        budget = byte_budget("hash_sift", plain.numel())
        if not torch.equal(got, want) or ndiff > budget:
            fail(f"fused compute HashSIFT-{nbits}: bytes differ from the "
                 f"two-stage route, or {ndiff} from the plain path (budget "
                 f"{budget})")
        print(f"fused compute HashSIFT-{nbits} on {N_KP} host keypoints: "
              f"launches {counts}; bytes identical to the two-stage route, "
              f"{ndiff} differ from the plain path (budget {budget})")

    ef_hs = EfficientFeatures(nfeatures=NFEATURES,
                              descriptor_type="hash_sift_256", device="cuda")
    ef_fused = EfficientFeatures(nfeatures=NFEATURES,
                                 descriptor_type="hash_sift_256",
                                 device="cuda", hs_fused=True)
    batch = torch.stack([img] + frames_dev)
    nb = batch.shape[0]
    (bslots, bdesc), counts = drive(
        "detect_and_compute_batch",
        lambda: ef_hs.detect_and_compute_batch(batch),
        detect_kernels + two_stage, detect_calls=nb)
    for i in range(nb):
        k1, d1 = ef_hs.detect_and_compute_async(batch[i])
        differ = [k for k, v in k1._slots.items()
                  if not torch.equal(bslots[k][i], v)]
        if differ or not torch.equal(bdesc[i], d1):
            fail(f"batch frame {i}: slots {differ} or descriptors differ "
                 "from the single call")
    host = ef_hs.detect_and_compute_batch(batch, as_host=True)
    if [k.count for k, _ in host] != bslots["count"].tolist() or any(
            d.shape != (k.count, 32) for k, d in host):
        fail("batch as_host: counts or descriptor shapes differ")
    print(f"batch of {nb} frames {H}x{W}: launches {counts}; every frame "
          f"equals its single call; keypoints {bslots['count'].tolist()}")

    # times: two-stage, fused, fused, two-stage within this one run
    runs = [("two-stage", ef_hs), ("fused", ef_fused), ("fused", ef_fused),
            ("two-stage", ef_hs)]
    for what, feat in runs:
        ms = time_ms(lambda: feat.detect_and_compute_async(img))
        syncs = host_syncs(lambda: feat.detect_and_compute_async(img))
        print(f"time slice hash_sift_256 {what} {H}x{W} nfeatures "
              f"{NFEATURES}: {ms:.3f} ms/call, host syncs per call {syncs} "
              f"[{hw}]")
    pyr_ms = time_ms(lambda: I.build_pyramid(img, 1.2, 8))
    pyr_syncs = host_syncs(lambda: I.build_pyramid(img, 1.2, 8))
    with plain_kernels():
        pyr_plain = time_ms(lambda: I.build_pyramid(img, 1.2, 8))
        pyr_plain_syncs = host_syncs(lambda: I.build_pyramid(img, 1.2, 8))
    print(f"time pyramid {H}x{W}, 8 levels: {pyr_ms:.3f} ms/call through "
          f"K10 ({pyr_syncs} host syncs), {pyr_plain:.3f} ms/call through "
          f"the plain resize ({pyr_plain_syncs} host syncs) [{hw}]")
    batch_ms = time_ms(lambda: ef_hs.detect_and_compute_batch(batch), iters=10)
    single_ms = time_ms(lambda: ef_hs.detect_and_compute_async(batch[1]))
    batch_syncs = host_syncs(lambda: ef_hs.detect_and_compute_batch(batch))
    print(f"time batch of {nb} frames: {batch_ms:.3f} ms/call, "
          f"{batch_ms / nb:.3f} ms/frame, against {single_ms:.3f} ms for a "
          f"single call on one of them; host syncs per batch call "
          f"{batch_syncs} [{hw}]")
    del batch, bslots, bdesc

    stamp("720p against the CPU port")
    # -- the sequence path on the card vs the port on the CPU, 720x1280 ------
    sample_frames = list(SIS.frame_iter(None, SEQ_FRAMES))
    for dtype in ("bad_256", "hash_sift_256"):
        kind = dtype.rsplit("_", 1)[0]
        runs = {}
        for d in ("cuda", "cpu"):
            feat = EfficientFeatures(nfeatures=SAMPLE_NFEATURES,
                                     descriptor_type=dtype, device=d)
            st, stt = SIS.streaming_step_fn(feat._cfg, SAMPLE_HW,
                                            homography=True, device=d)
            runs[d] = []
            for f in sample_frames:
                out = st(f)
                runs[d].append(({k: v.to("cpu", copy=True)
                                 for k, v in stt.items()},
                                [t.cpu() for t in out]))
        ndiff = n_mdiff = 0
        h_err = 0.0
        for i in range(SEQ_FRAMES):
            (sg, og), (sc, oc) = runs["cuda"][i], runs["cpu"][i]
            if not (torch.equal(sg["valid"], sc["valid"])
                    and torch.equal(sg["xy"], sc["xy"])
                    and int(og[0]) == int(oc[0])):
                fail(f"720p {dtype} frame {i}: slots differ from the CPU")
            ndiff = max(ndiff, int((sg["desc"] != sc["desc"]).sum()))
            if ndiff > byte_budget(kind, sc["desc"].numel()):
                fail(f"720p {dtype} frame {i}: {ndiff} descriptor bytes "
                     "differ from the CPU")
            if i == 0:
                continue
            prev = runs["cuda"][i - 1][0]
            args = (prev["desc"], prev["valid"], sg["desc"], sg["valid"])
            on_card = TM.knn2_ratio_match_masked(*(a.to(dev) for a in args))
            on_cpu = TM.knn2_ratio_match_masked(*args)
            if not all(torch.equal(a.cpu(), b)
                       for a, b in zip(on_card, on_cpu)):
                fail(f"720p {dtype} frame {i}: the matcher on the card "
                     "differs from the CPU on the same descriptors")
            if torch.equal(sg["desc"], sc["desc"]) and \
                    int(og[1]) != int(oc[1]):
                fail(f"720p {dtype} frame {i}: match counts differ")
            n_mdiff = max(n_mdiff, abs(int(og[1]) - int(oc[1])))
            j, _, ok = on_cpu
            src, dst = prev["xy"], sg["xy"][j.long()]
            idx = RS._draw_minimal_sets(ok, 256,
                                        torch.Generator().manual_seed(0))
            Hc, _, nc = RS._ransac_from_indices(src, dst, ok, RANSAC_THRESH,
                                                idx)
            Hg, _, ng = RS._ransac_from_indices(
                src.to(dev), dst.to(dev), ok.to(dev), RANSAC_THRESH,
                idx.to(dev))
            h_true = (SC.warp_matrix(SAMPLE_HW, *moves[i])
                      @ np.linalg.inv(SC.warp_matrix(SAMPLE_HW,
                                                     *moves[i - 1])))
            errs_i = (corner_err(Hg.cpu().numpy(), Hc.numpy(), SAMPLE_HW),
                      corner_err(Hg.cpu().numpy(), h_true, SAMPLE_HW),
                      corner_err(Hc.numpy(), h_true, SAMPLE_HW))
            h_err = max(h_err, errs_i[0])
            if not (errs_i[0] < SAMPLE_H_TOL and max(errs_i[1:]) < CORNER_TOL):
                fail(f"720p {dtype} frame {i}: RANSAC H card vs CPU "
                     f"{errs_i[0]} px, card vs warp {errs_i[1]} px, CPU vs "
                     f"warp {errs_i[2]} px at the corners; inliers card "
                     f"{int(ng)}, CPU {int(nc)} of {int(ok.sum())}")
            print(f"720p {dtype} frame {i}: RANSAC H card vs CPU "
                  f"{errs_i[0]:.4f} px, card vs warp {errs_i[1]:.4f} px, "
                  f"CPU vs warp {errs_i[2]:.4f} px at the corners; inliers "
                  f"card {int(ng)}, CPU {int(nc)} of {int(ok.sum())} "
                  "matches")
        print(f"720p sequence {dtype}, {SAMPLE_NFEATURES} features: slots "
              f"bit-identical to the CPU port, descriptors differ in at "
              f"most {ndiff} bytes, matcher identical on the same "
              f"descriptors, match counts differ by at most {n_mdiff}, "
              f"RANSAC H within {h_err:.2e} px of the CPU at the corners "
              "(same minimal sets)")

    # -- configurations (a)-(d) on the card vs the port on the CPU, 720p -----
    sample_scene = SC.make_bench_image(*SAMPLE_HW, seed=9)
    sample_roi = SC.roi_mask(*SAMPLE_HW)
    for dtype in ("hash_sift_256", "bad_256"):
        kind = dtype.rsplit("_", 1)[0]
        for tag, radius, masked, _ in configs:
            runs = {}
            for d in ("cuda", "cpu"):
                feat = EfficientFeatures(nfeatures=SAMPLE_NFEATURES,
                                         nonmax_radius=radius,
                                         descriptor_type=dtype, device=d)
                k, dsc = feat.detect_and_compute_async(
                    sample_scene, mask=sample_roi if masked else None)
                runs[d] = ({kk: v.cpu() for kk, v in k._slots.items()},
                           dsc.cpu())
            (sg, dg), (sc, dc) = runs["cuda"], runs["cpu"]
            label = f"720p config ({tag}) {dtype} radius {radius}"
            for k in selection:
                if not torch.equal(sg[k], sc[k]):
                    fail(f"{label}: slot {k!r} differs from the CPU port")
            dang = (sg["angle"] - sc["angle"]).abs()
            dang = float(torch.minimum(dang, 360 - dang).max())
            ndiff = int((dg != dc).sum())
            budget = byte_budget(kind, dc.numel())
            if ndiff > budget or dang >= ANGLE_TOL:
                fail(f"{label}: {ndiff} descriptor bytes differ from the CPU "
                     f"(budget {budget}), angles {dang}")
            print(f"{label}{' mask=roi' if masked else ''}: "
                  f"{int(sc['count'])} keypoints, slots bit-identical to the "
                  f"CPU port, angles within {dang:.2e} deg, {ndiff} "
                  f"descriptor bytes differ (budget {budget})")

    # -- the fused route and a batch on the card vs the port on the CPU, 720p
    sample_batch = np.stack(sample_frames + [sample_scene])
    runs = {}
    for d in ("cuda", "cpu"):
        feat = EfficientFeatures(nfeatures=SAMPLE_NFEATURES,
                                 descriptor_type="hash_sift_256", device=d,
                                 hs_fused=True)
        bs, bd = feat.detect_and_compute_batch(sample_batch)
        runs[d] = ({k: v.cpu() for k, v in bs.items()}, bd.cpu())
    (sg, dg), (sc, dc) = runs["cuda"], runs["cpu"]
    differ = [k for k in selection if not torch.equal(sg[k], sc[k])]
    dang = (sg["angle"] - sc["angle"]).abs()
    dang = float(torch.minimum(dang, 360 - dang).max())
    ndiff = [int((dg[i] != dc[i]).sum()) for i in range(len(sample_batch))]
    budget = byte_budget("hash_sift", dc[0].numel())
    if differ or max(ndiff) > budget or dang >= ANGLE_TOL:
        fail(f"720p fused batch: slots {differ} differ from the CPU port, "
             f"descriptor bytes {ndiff} (budget {budget} a frame), angles "
             f"{dang}")
    print(f"720p fused batch of {len(sample_batch)} frames, hash_sift_256: "
          f"keypoints {sc['count'].tolist()}, slots bit-identical to the CPU "
          f"port, angles within {dang:.2e} deg, descriptor bytes differing "
          f"per frame {ndiff} (budget {budget})")

    stamp("RANSAC and kernel times")
    # -- RANSAC alone at 40000 slots ------------------------------------------
    slots1, desc1 = P.detect_and_compute_core(frames_dev[1], ef._cfg)
    slots2, desc2 = P.detect_and_compute_core(frames_dev[2], ef._cfg)
    j, _, ok = TM.knn2_ratio_match_masked(desc1, slots1["valid"], desc2,
                                          slots2["valid"])
    xy1 = torch.stack([slots1["x"], slots1["y"]], dim=1)
    xy2 = torch.stack([slots2["x"], slots2["y"]], dim=1)[j.long()]
    for iters in (256, 512):
        r_ms = time_ms(lambda: RS.find_homography_ransac(
            xy1, xy2, ok, iters=iters, thresh=RANSAC_THRESH, device="cuda"))
        r_syncs = host_syncs(lambda: RS.find_homography_ransac(
            xy1, xy2, ok, iters=iters, thresh=RANSAC_THRESH, device="cuda"))
        print(f"time find_homography_ransac {iters} iterations, "
              f"{xy1.shape[0]} slots ({int(ok.sum())} valid): {r_ms:.3f} "
              f"ms/call, host syncs per call {r_syncs} [{hw}]")

    # -- kernel times: one main-path call's launches, replayed --------------
    times = {}
    for m, name, ref, *_ in kernels:
        calls = recorded[name]
        fn = getattr(m, name)

        def replay(f, calls=calls):
            for args, kwargs in calls:
                f(*args, **kwargs)

        plain_iters = 3 if name == "knn2_topk2" else ITERS
        times[name] = (time_ms(lambda: replay(fn)),
                       time_ms(lambda: replay(ref), iters=plain_iters,
                               warmup=1))
        empty = ""
        if name == "hs_hist_from_patches":
            empty = (f" ({sum(empty_patches(a[0]) for a, _ in calls)} of "
                     f"{sum(a[0].shape[0] for a, _ in calls)} patches all "
                     "zero)")
        elif name == "hs_desc_windows":
            empty = (f" ({sum(int((~a[5]).sum()) for a, _ in calls)} of "
                     f"{sum(a[5].shape[0] for a, _ in calls)} slots invalid)")
        print(f"time {name}: {len(calls)} launches of the first main-path "
              f"call that ran it{empty}, kernel {times[name][0]:.3f} ms, "
              f"plain {times[name][1]:.3f} ms [{hw}]")

    for label, mod, name, calls in (
            ("masked, config (a)", DK, "fast_harris_nms_cells",
             config_calls["a"]["fast_harris_nms_cells"]),
            ("radius 64, config (d)", DK, "fast_harris_nms_cells",
             config_calls["d"]["fast_harris_nms_cells"]),
            (f"compute() BAD-256, {N_KP} host keypoints of 31-300 px", WK,
             "bad_descriptors_windows", compute_k3_calls)):
        fn, ref = getattr(mod, name), getattr(mod, name + "_ref")

        def replay(f, calls=calls):
            for args, kwargs in calls:
                f(*args, **kwargs)

        k_ms = time_ms(lambda: replay(fn))
        p_ms = time_ms(lambda: replay(ref), warmup=1)
        b_ms, b_by = bound(name, calls)
        print(f"time {name} {label}: {len(calls)} launches, kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by "
              f"{b_by} [{hw}]")

    # the dense path's GEMM alone (not the same function): a +-1 f16 product
    # of the unpacked bits of K6's inputs, the yardstick for K6
    pm1 = [(TM.unpack_bits_pm1(a[0]).half(), TM.unpack_bits_pm1(a[2]).half())
           for a, _ in recorded["knn2_topk2"]]
    gemm_out = torch.empty((max(a.shape[0] for a, _ in pm1),
                            max(b.shape[0] for _, b in pm1)),
                           dtype=torch.float16, device=dev)

    def gemms():
        for a, b in pm1:
            torch.matmul(a, b.T, out=gemm_out[:a.shape[0], :b.shape[0]])

    library = dict.fromkeys(names)
    library_call = {"knn2_topk2": "torch.matmul of the +-1 f16 unpacked "
                    "bits: the dense path's GEMM alone, not the same "
                    "function"}
    library["knn2_topk2"] = time_ms(gemms)
    print(f"time knn2_topk2 yardstick: the dense path's +-1 f16 GEMM alone "
          f"(not the same function) on the same {len(pm1)} input pairs: "
          f"{library['knn2_topk2']:.3f} ms [{hw}]")
    del gemm_out, pm1
    # F.interpolate on a float copy of each level (not the same function:
    # float weights and no fixed-point rounding), the yardstick for K10
    floats = [(a[0].float()[None, None], a[1])
              for a, _ in recorded["resize_u8_kernel"]]

    def interpolates():
        for src, dst_hw in floats:
            torch.nn.functional.interpolate(src, size=dst_hw, mode="bilinear",
                                            align_corners=False)

    library["resize_u8_kernel"] = time_ms(interpolates)
    library_call["resize_u8_kernel"] = (
        "torch.nn.functional.interpolate(bilinear) on a float32 copy of each "
        "level: float weights, no 11-bit fixed point, not the same function")
    print(f"time resize_u8_kernel yardstick: F.interpolate on float32 "
          f"copies of the same {len(floats)} levels (not the same "
          f"function): {library['resize_u8_kernel']:.3f} ms [{hw}]")
    del floats
    for nbytes in (32, 64):
        d = torch.from_numpy(rng.integers(0, 256, (N_KP, nbytes),
                                          dtype=np.uint8)).to(dev)
        k6_ms = time_ms(lambda: TM.knn2_topk2(d, None, d, None), iters=5)
        one = [((d, None, d, None), {})]
        b_ms, b_by = bound("knn2_topk2", one)
        print(f"time knn2_topk2 {8 * nbytes} bits, one launch at {N_KP} x "
              f"{N_KP}: {k6_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} (1-bit "
              f"product and one min per distance); yardstick, no bound: the "
              f"product as int8 at the stated rate {int8_form_ms(one):.4f} "
              f"ms [{hw}]")
    bounds = {name: bound(name, recorded[name]) for name in names}
    for name in names:
        print(f"bound {name}: {bounds[name][0]:.4f} ms by "
              f"{bounds[name][1]} for the replayed launches")

    stamp("done")
    print(f"main-path launches (all paths, all runs): {totals}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "efficient_features_tpu_torch/csrc/" + source,
         "replaces": replaces, "launches": totals[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library[name],
         "library_call": library_call.get(name)}
        for _, name, _, source, replaces in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
