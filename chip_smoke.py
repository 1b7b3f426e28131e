"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficient_features_tpu_torch/csrc` and
checks each against its plain PyTorch version on the card: K1 cells (its
four outputs, the survivor bitmap among them, with and without its ROI mask
input, radius 10-128, on the scene, the dense scene and 4K uniform noise,
and an image whose corners all tie, so that each scans its whole disc),
K12 RANSAC's solve and verify (each of its four wrappers bit for bit its
plain version, one launch a use: the Jacobi eigenvectors of 9x9 systems
on random PSD matrices, DLT minimal sets and diagonal ties; the minimal
sets' homographies on 512 random sets of a 40000-pair scene, on collinear,
coincident and identical sets and at iters 1 and 4097; the scores and the
one-H mask at 512 x 40000, at N off a block, with every slot invalid and
with points at infinity; all four on the main path's own calls; the peak
allocation of a RANSAC 512 call), K13 the cells route's selection (bit
for bit its plain version, one launch a call, on the 4K scenes at quotas below, at and past
the block count, with every 8x8 block live in one tie group, under the
ROI, on a 4K tiling of the tie image, odd sizes, levels one block row high
and one run of 8200 tied blocks, and on the main path's own levels; its
time beside the plain version's), K7 dense FAST+Harris+NMS
and K8 dense FAST+Harris (radius 1-9, bit-exact; K7 also on the scene
plus noise, on equal responses, where ties co-survive, and on an image
smaller than one tile), K9 disc NMS
(bit-exact at radius 1, 2, 3, 5, 8 and 9, its staged kernel, and 15, 49,
64 and 128, its per-pixel scan, on the 4K scene's K8 map unmasked, under
the ROI and under a random mask, on that map with its responses quantised
to three levels, so that tied corners must co-survive, and on maps smaller
than one tile, 65 wide and 33 tall; its kernel-only time at radius 5 and
9 and one call at radius 64), K2 IC
moments and angles (the moments exact, the angles bit for bit those of the
plain angle step run on the card, on the 4K scene's slots, on random and
edge keypoints with invalid slots, and the angle step alone on 2^26 random
moment pairs, the axes, zeros and |m01| = |m10|), K3 BAD (byte for byte at
256 and 512 bits, at size 31 and at
64-300 px, on both sides of its shared-memory window limit, on the image
corners and the 27.125 px branch boundary, n = 1, every slot invalid,
images 1-3 px tall or wide), K4 HashSIFT warp (byte for byte at sizes
31*1.2^k and 300 px and on both sides of its shared-memory window limit,
on and off the image corners, angle -1, every slot invalid, n = 1, images
1-3 px tall or wide), the keypoint trig that K3, K4 and K11 compute (bit
for bit with `ops.bad.affine_trig` on the card at every float32 angle in
[0, 360) and at -1, size 31, scale factors 1.0 and 1.2), K5 HashSIFT
histogram (deterministic, zero patch ->
zero row), K10 the pyramid's resize (bit-exact on the 7 levels under
2160x3840, 4320x7680 and 1080x1920 frames, odd sizes, source rows that
all start one byte past a 16-byte boundary, 3x and 4x downscales whose
tiles read the image directly, an upscale, 16x20 and 8x8 destinations,
noise and all-255; the kernel-only time of each 4K level beside its
bound), K14 the descriptors' 7x7 blur (bit-exact on the 8 levels of the
2160x3840 and 1241x376 pyramids, scene and noise, all-0 and all-255, hard
edges, a ragged crop, 4x5 to 300x7, a source that starts unaligned; the
kernel-only time of the 8 levels beside their bound and the plain
version's), K11 fused HashSIFT (the bytes of K5 on K4's patches, and
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
  - the mesh forms (`parallel/sharding.py`) on a 1-rank NCCL group in this
    process: `detect(mesh=)` with and without the ROI, `detect_and_compute(
    mesh=)` for BAD-256, HashSIFT-256 and the fused route (the band route:
    K10, K8, K9, K2, then K3, K4 + K5 or K11 on each band's window; no K1
    or K7 launch), a 4-frame `detect_and_compute_batch(mesh=)`,
    `compute_sharded` of 40000 keypoints of 31-300 px and
    `knn2_match_sharded` at 40000 x 40000 (two K6 calls), each equal to its
    single-device call bit for bit, with the CUDA kernels of one call
    listed from a trace and each call's time beside its single-device
    twin's.  Then, spawned on this card, 2 gloo ranks at 1080x1920, whose
    bands take their halo rows from each other: four `detect_and_compute`
    calls (BAD-256, HashSIFT-256, fused, BAD-256 with the ROI) and a masked
    `detect`, each rank's result equal to the single-device call on the
    card, with each rank's launches and time per call.
  - the selection's cost on the dense maps of (b), (c) and the 1-rank mesh
    `detect_and_compute` (HashSIFT-256): the device ms of the sort
    kernels, the ms and the host syncs per call;
  - the tie scene at 4K: `tie_image`'s pattern in the scene, tied 8x8
    blocks at level 0, `detect_and_compute` BAD-256 at radius 15, slots
    equal to the plain path and the CPU port, with its ms per call;
  - a trace of one cells-route `detect_and_compute` at radius 15, with the
    ROI, at radius 64 and on equal responses: each of K13's three kernels
    launched once a level, and no sort kernel;
  - the async chain `detect_async` -> `compute_async` ->
    `knn2_ratio_match_masked` -> `find_homography_ransac` at 4K under
    `torch.cuda.set_sync_debug_mode("error")`;
  - `tools.eval_matching` with device "cuda" on the five fixtures of
    tests/data: keypoint counts and repeatability equal to the CPU port's,
    matches and inlier rates printed beside the CPU port's and
    tools/EVAL.json's.
Every `detect` / `detect_and_compute` call builds its pyramid through K10:
7 launches per call, checked in every path above; every
`detect_and_compute` call blurs its 8 levels through K14, 8 launches, and
`detect` and `compute` none.  One image on the card
goes through the graph cache (`graphs.py`), whose replays move no wrapper
counter: the counted paths, and the plain versions, run the core eagerly,
and the K13 trace below checks a replay's kernels by name.  `utils.profiler` on the
card: `timeit_ms` within 20% of this script's `time_ms` on one 40000 x
40000 K6 call, and a `trace` of K1 calls that lists K1's two kernels and
the `annotate` range around them.
At the samples' own size (720x1280, 3000 features) configurations (a)-(d)
are held against the port on the CPU, as are the fused route and a 4-frame
batch, and the sequence path on the card is held against the port on the
CPU: slots bit-identical, descriptors
within budget, matcher outputs identical on the same descriptors, RANSAC's
homography within SAMPLE_H_TOL on the same minimal sets.
It checks that the HashSIFT projection ignores a caller's TF32 setting, and
times the slices, compute, the sequence step, RANSAC and each kernel (a
replay of one main-path call's launches) beside their plain versions with
CUDA events; host syncs per call come from `torch.cuda.set_sync_debug_mode`,
and any host sync of a path of the port fails the run.
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
import sys
import time
from pathlib import Path

import numpy as np
import torch

from efficient_features_tpu_torch.tools.oncard import (card, equal_image,
                                                       host_syncs, tie_image,
                                                       tie_mask)

H, W = 2160, 3840
NFEATURES = 40000
N_KP = 40000
ITERS = 20
BUDGETS = {"bad": 2e-5, "hash_sift": 1e-4}   # share of bytes that may differ
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
# float64 ops/s outside the tensor cores (the same datasheet): K12's rate.
PEAK_F64 = 34e12
# Two rates the datasheet does not state, for K6's bound.
# 1-bit tensor-core ops/s (wgmma .b1 and.popc): 8 x the int8 rate, the ratio
# of the A100's datasheet (4992 to 624 TOP/s).  The product alone, 40000 x
# 40000, reads 13e15 / 14e15 ops/s at 256 / 512 bits on an NVIDIA H100 80GB
# HBM3 at 700 W (0.062 / 0.116 ms, timed alone in K6's redesign; PERF.md's
# table of kernels): 0.83 / 0.89 of this, and 6.7 / 7.1 x the stated int8
# rate.
PEAK_B1_TC = 8 * PEAK_INT8_TC
# int32 min/max per second on the CUDA cores: 64 per clock and SM (NVIDIA's
# table of arithmetic instruction throughput for compute capability 9.0) x
# 132 SMs x 1.98 GHz, the clock behind the datasheet's 67 TFLOP/s.
PEAK_INT32 = 64 * 132 * 1.98e9
# K5 / K11: CUDA-core ops per patch that is not all zero (see `_work`), and
# the bytes of the histogram plan (ops/hash_sift.hist_plan) read per call.
HS_PATCH_OPS = 40.0 * 900 + 2.0 * 5202 + 6.0 * 128
HS_PLAN_BYTES = 16 * 6 * 4 + 2601 * 4
# K12: float64 ops of the convergence test before a sweep of one 9x9
# matrix (9 abs and 8 max of the diagonal, 72 abs and compares), and of a
# sweep: the test, and per round 4 rotations of 16 ops (the subtract, the
# doubling, 3 for d^2 + e^2, a square root, 2 for w, 3 for w^2 + e^2, a
# square root, the reciprocal, 2 multiplies, the sign and the zero test)
# and 3 x 54 for each pair's column, V and row updates, 9 rounds.  A
# matrix costs its sweeps, the test that stopped it and 8 compares for the
# pick; the sweeps are this run's (ops/ransac.jacobi_sweeps).
JACOBI_TEST_OPS = 17 + 144
JACOBI_SWEEP_OPS = JACOBI_TEST_OPS + 9 * 4 * (16 + 3 * 54)
# K12: float32 ops of one minimal set's DLT around its Jacobi body: per
# side of the Hartley normalisation 46 (8 for the centroid, 8 differences,
# 12 for the squared distances, 4 square roots, 4 for the mean, the clamp,
# the division, 8 scalings), 36 for the design, 45 entries of A^T A at 15
# (8 products, 7 sums) and 45 conversions, and 54 for the denormalisation
# and the division by h22.
DLT4_OPS = 2 * 46 + 36 + 45 * 16 + 54
# K12: float32 ops of one pair under one hypothesis: 12 for p, the abs, 2
# compares, 2 divisions, 2 differences, 3 for e2 and the threshold compare.
VERIFY_OPS = 23
REPO = Path(__file__).resolve().parent


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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


def traced_launches(listed: dict, names) -> dict:
    """{name: launches of the traced kernels whose name holds it}."""
    return {n: sum(c for k, (c, _) in listed.items() if n in k)
            for n in names}


# Kernels `profiled` launches after the profiler's warm-up step and before
# the traced calls.  Late in this script, traces lost the records of their
# first three or four kernels, however long after the start they ran (K6's
# first call of two in the mesh listing; 1 or 2 of K1's 20 calls in the
# profiler phase; a fresh process lost none): the lead-in takes that loss
# in place of the calls.  Its kernel is `torch.cuda._sleep`'s, which `kernel_names` leaves
# out.
LEAD_IN = 16


def profiled(fn, reps: int = 1, cpu: bool = True):
    """The torch.profiler record of `reps` calls of fn, after a warm-up step
    of the profiler over one call and a lead-in of LEAD_IN spin kernels."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def kernel_names(fn, want: dict | None = None) -> dict:
    """{kernel name: (launches, device ms)} of the CUDA kernels one call of
    fn makes (`profiled`).  want: {string: launches expected of the kernels
    whose name holds it}.  A lost record can only take a launch away, so a
    trace that shows fewer launches than expected of some string is taken
    again, four times at most; the caller checks the counts."""
    want = want or {}
    for _ in range(5):
        out = {}
        for e in profiled(fn).key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if (e.device_type == torch.autograd.DeviceType.CUDA and t > 0
                    and "spin_kernel" not in e.key):
                # one name may head several groups (the grouping key holds
                # more than the name): add them up
                c, ms = out.get(e.key, (0, 0.0))
                out[e.key] = (c + e.count, ms + t / 1e3)
        got = traced_launches(out, want)
        if all(got[w] >= c for w, c in want.items()):
            break
        print(f"trace lost launches of {want}, taken again", file=sys.stderr)
    return out


def launch_ms(fn, name: str, reps: int = 10) -> list[float]:
    """Device ms of each launch of the kernels whose name holds `name` that
    one call of fn makes, in launch order, averaged over `reps` calls after
    2 (`profiled`): a kernel's own time, without its wrapper.  A trace
    that lost a launch's record is taken again, twice at most."""
    for _ in range(2):
        fn()
    for _ in range(3):
        prof = profiled(fn, reps, cpu=False)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and name in e.name),
                        key=lambda e: e.time_range.start)
        if events and len(events) % reps == 0:
            us = np.array([e.time_range.elapsed_us() for e in events],
                          np.float64)
            return (us.reshape(reps, -1).mean(axis=0) / 1e3).tolist()
    fail(f"{len(events)} launches of {name} traced in {reps} calls")


def replay_ms(fn, name: str, reps: int = 10) -> tuple[float, list | None]:
    """fn's launches captured in one CUDA graph, as the core's graph holds
    them: (ms of one replay, by CUDA events over 100 replays; the device ms
    of each launch of the kernels whose name holds `name`, averaged over
    `reps` replays in a profiler trace, or None where the trace lost a
    record)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, iters=100)
    prof = profiled(graph.replay, reps, cpu=False)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and name in e.name), key=lambda e: e.time_range.start)
    if not events or len(events) % reps:
        return ms, None
    us = np.array([e.time_range.elapsed_us() for e in events], np.float64)
    return ms, (us.reshape(reps, -1).mean(axis=0) / 1e3).tolist()


def tied_responses(resp: torch.Tensor) -> torch.Tensor:
    """`resp` (-inf where there is no corner) with its corners' responses
    quantised to three levels, 1, 2 and 3 by tercile: a map of heavily tied
    responses, on which tied corners must co-survive (as in
    tests/test_torch_cuda.py)."""
    finite = resp != float("-inf")
    vals = resp[finite].sort().values
    n = vals.numel()
    level = 1.0 + (resp > vals[n // 3]).float() + (resp > vals[2 * n // 3])
    return torch.where(finite, level, float("-inf"))


def checked_syncs(label: str, fn, check: bool = True) -> int:
    """Host syncs that one call of fn makes (`oncard.host_syncs`), the
    more of two calls: after two unchecked calls (a key's first call runs
    eagerly and its second captures its graph, `graphs.py`), one that
    replays, and, with the graph cache cleared, one that runs eagerly.
    With `check`, any sync fails the run: the port's paths read nothing
    back."""
    from efficient_features_tpu_torch import graphs as G
    fn()
    fn()
    counts = []
    for clear in (False, True):
        if clear:
            G.CACHE.clear()
        syncs = host_syncs(fn)
        if check and syncs:
            fail(f"{label}: {len(syncs)} host syncs in one call, the "
                 f"first: {syncs[0]}")
        counts.append(len(syncs))
    return max(counts)


def _work(name: str, args) -> tuple[float, float, float, float, float]:
    """(bytes, CUDA-core ops at the float32 rate, int32 min/max, 1-bit
    tensor-core ops, float64 ops) of one wrapper call: each input read
    once and each output written once, and the work the function needs on
    these inputs.
    Op counts are per-element estimates of the algorithm's own arithmetic,
    each op counted once:
      K1  FAST-9 at every pixel: 16 differences, 32 threshold compares;
          per border-valid FAST corner of this image (inside the mask,
          where there is one) 2 x 147 for the Harris sums and one compare
          per pixel of the disc; with a mask, 1 B more read per pixel;
          13 B written per cell (its four outputs);
      K7  as K1, dense: 1 B read and 4 B written per pixel;
      K8  FAST-9 at every pixel, 1 B read and 4 B written per pixel;
      K9  4 B read and 1 B of bool written per pixel, one compare per
          pixel and per corner (a response that is not -inf) one compare
          per pixel of the disc;
      K2  4 B of ys and xs and 1 B of valid read and a 4 B angle written
          per slot; a multiply-add per moment per disc pixel, 4 x 705, per
          valid slot (an invalid slot reads no pixel);
      K3  the integral image (2 adds per pixel) and per bit two box sums
          (3 adds each) and the weighted compare (3);
      K4  17 B of keypoint read and the 1 KB row written per slot; per
          sample of a valid slot the affine (4) and the bilinear lerp (8);
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
      K10 source and destination pixels once and the two packed uint32
          tables, 4 B a destination row and column; per destination pixel
          6 multiplies, 3 adds, the rounding add and the shift (11);
      K14 each pixel read and written once; per pixel and pass 3 pair
          adds, 4 multiplies, 3 adds, the rounding add and the shift (24:
          the taps are symmetric);
      K11 the image once, 17 B of keypoint per slot, the 128 B row and
          the plan once; per valid slot K4's affine and lerp per sample,
          and K5's work for each patch that is not all zero (an invalid
          slot costs only its bytes);
      K12 Jacobi (`smallest_eigvec9`): the 324 B matrix read and the
          36 B vector written, and per matrix JACOBI_SWEEP_OPS float64 ops
          a sweep it ran (its sweeps on these inputs, as the kernel stops
          a converged matrix), the test that stopped it and 8 for the
          pick; the solve (`solve_minimal_sets`): per set the 32 B of
          indices, its 4 pairs (64 B) and the 36 B H, DLT4_OPS float32
          ops and the float64 ops of its Jacobi body on these inputs;
          the scores (`score_homographies`): 36 B of H and 4 B of score a
          hypothesis, 17 B a pair, and VERIFY_OPS float32 ops per
          hypothesis and valid pair (an invalid slot needs none); the
          mask (`inlier_mask`): the H, 18 B a pair, VERIFY_OPS per valid
          pair;
      K13 9 B read per cell (cellmax, cellrow, cellbits) and 13 B written
          per slot, the least any selection moves: its keys, select and
          sort can stay on chip; per cell about 10 ops for its key, per
          kept block 64 for its bit transpose and per slot 4 to place it
          (the select and the sort are not charged: a lower bound)."""
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
            return 5 * h * w, ops, 0.0, 0.0, 0.0
        return (h * w * (2 if mask is not None else 1)
                + 13 * -(-h // 8) * w, ops, 0.0, 0.0, 0.0)
    if name == "fast_harris":
        h, w = args[0].shape
        return 5 * h * w, 48.0 * h * w, 0.0, 0.0, 0.0
    if name == "radius_nms":
        from efficient_features_tpu_torch.ops import detect as D
        h, w = args[0].shape
        corners = int((args[0] != D.RESP_SENTINEL).sum())
        return (5 * h * w, 1.0 * h * w + corners * _disc_pixels(args[1]),
                0.0, 0.0, 0.0)
    if name == "ic_angles_windows":
        img, ys, valid = args[0], args[1], args[3]
        n = ys.shape[0]
        return (img.numel() + 13 * n, 4.0 * 705 * int(valid.sum()), 0.0,
                0.0, 0.0)
    if name == "bad_descriptors_windows":
        img, n, nbits = args[0], args[1].shape[0], args[6]
        return (img.numel() + 17 * n + n * nbits // 8,
                2.0 * img.numel() + 9.0 * nbits * n, 0.0, 0.0, 0.0)
    if name == "warp_patches_windows":
        img, n, valid = args[0], args[1].shape[0], int(args[5].sum())
        return img.numel() + 1041 * n, 12.0 * 1024 * valid, 0.0, 0.0, 0.0
    if name == "hs_hist_from_patches":
        n = args[0].shape[0]
        live = n - empty_patches(args[0])
        return (1152 * n + HS_PLAN_BYTES, HS_PATCH_OPS * live, 0.0, 0.0,
                0.0)
    if name == "resize_u8_kernel":
        src, (h, w) = args[:2]
        return (src.numel() + h * w + 4 * (h + w), 11.0 * h * w, 0.0, 0.0,
                0.0)
    if name == "gaussian_blur7_u8_kernel":
        n = args[0].numel()
        return 2 * n, 24.0 * n, 0.0, 0.0, 0.0
    if name == "hs_desc_windows":
        from efficient_features_tpu_torch.ops import window_kernels as WK
        img, n = args[0], args[1].shape[0]
        valid = int(args[5].sum())
        live = n - empty_patches(WK.warp_patches_windows_ref(*args))
        return (img.numel() + 17 * n + 128 * n + HS_PLAN_BYTES,
                12.0 * 1024 * valid + HS_PATCH_OPS * live, 0.0, 0.0, 0.0)
    if name == "knn2_topk2":
        q, vq, t, vt = args
        n1, n2, nb = q.shape[0], t.shape[0], q.shape[1]
        masks = (n1 if vq is not None else 0) + (n2 if vt is not None else 0)
        return ((n1 + n2) * nb + masks + 12 * n1, 0.0, 1.0 * n1 * n2,
                2.0 * n1 * n2 * 8 * nb, 0.0)
    if name == "select_cells":
        cellmax, _, _, h, w, quota = args
        q = min(quota, h * w)
        kq = min(q, -(-h // 8) * -(-w // 8))
        return (9.0 * cellmax.numel() + 13.0 * q,
                10.0 * cellmax.numel() + 64.0 * kq + 4.0 * q, 0.0, 0.0, 0.0)
    if name in ("smallest_eigvec9", "solve_minimal_sets"):
        from efficient_features_tpu_torch.ops import ransac as RS
        if name == "smallest_eigvec9":
            ata, n = args[0], args[0].numel() // 81
            nbytes, f32 = 360.0 * n, 0.0
        else:
            ata, n = RS.minimal_set_systems(*args)[0], args[2].shape[0]
            nbytes, f32 = 132.0 * n, float(DLT4_OPS) * n
        sweeps = RS.jacobi_sweeps(ata).double()
        f64 = float((sweeps * JACOBI_SWEEP_OPS + JACOBI_TEST_OPS
                     * (sweeps < RS.JACOBI_SWEEPS) + 8).sum())
        return nbytes, f32, 0.0, 0.0, f64
    if name == "score_homographies":
        h, src, _, valid, _ = args
        return (40.0 * h.shape[0] + 17.0 * src.shape[0],
                float(VERIFY_OPS) * h.shape[0] * int(valid.sum()), 0.0, 0.0,
                0.0)
    if name == "inlier_mask":
        src, valid = args[1], args[3]
        return (40.0 + 18.0 * src.shape[0],
                float(VERIFY_OPS) * int(valid.sum()), 0.0, 0.0, 0.0)
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
                              PEAK_B1_TC, PEAK_F64) * 1e3
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


# The kernel wrappers whose launches a mesh call of phase (b) reports.
MESH_WRAPPERS = (("ops.image", "resize_u8_kernel"),
                 ("ops.image", "gaussian_blur7_u8_kernel"),
                 ("ops.detect_kernels", "fast_harris"),
                 ("ops.detect_kernels", "radius_nms"),
                 ("ops.detect_kernels", "fast_harris_nms_cells"),
                 ("ops.detect_kernels", "fast_harris_nms"),
                 ("ops.detect_kernels", "select_cells"),
                 ("ops.window_kernels", "ic_angles_windows"),
                 ("ops.window_kernels", "bad_descriptors_windows"),
                 ("ops.window_kernels", "warp_patches_windows"),
                 ("ops.window_kernels", "hs_hist_from_patches"),
                 ("ops.window_kernels", "hs_desc_windows"))


def mesh_rank_call(method: str, features: dict, image, reps: int = 3,
                   **kwargs):
    """One rank's part of a mesh call of phase (b), run by
    `parallel.launch.spmd` in a rank process: (result, ms per call, the
    launches of each kernel wrapper in one call).  One call first, then one
    counted call, then `reps` timed calls (CUDA events; each waits for the
    other rank's collectives)."""
    import importlib
    from efficient_features_tpu_torch.parallel import launch
    mods = {m: importlib.import_module("efficient_features_tpu_torch." + m)
            for m, _ in MESH_WRAPPERS}

    def counts():
        return {n: getattr(mods[m], n).launches for m, n in MESH_WRAPPERS}

    launch.call_api(method, features, image, **kwargs)
    before = counts()
    out = launch.call_api(method, features, image, **kwargs)
    torch.cuda.synchronize()
    after = counts()
    ms = time_ms(lambda: launch.call_api(method, features, image, **kwargs),
                 iters=reps, warmup=0)
    return out, ms, {n: after[n] - before[n] for n in after}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from efficient_features_tpu_torch import (BAD, EfficientFeatures,
                                              HashSIFT, _build)
    from efficient_features_tpu_torch import graphs as G
    from efficient_features_tpu_torch import pipeline as P
    from efficient_features_tpu_torch.models.params import (bad_params,
                                                            hash_sift_params)
    from efficient_features_tpu_torch.ops import bad as B
    from efficient_features_tpu_torch.ops import detect as D
    from efficient_features_tpu_torch.ops import detect_kernels as DK
    from efficient_features_tpu_torch.ops import hash_sift as HS
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
        (WK, "ic_angles_windows", WK.ic_angles_windows_ref,
         "ic_moments.cu", f"{tpu}window_kernels.py:861 (_ic_kernel, "
         f"launched by _ic_angles_windows_impl {tpu}window_kernels.py:934)"),
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
        (I, "gaussian_blur7_u8_kernel", I.gaussian_blur7_u8, "blur7_u8.cu",
         f"no TPU kernel: {tpu}image.py gaussian_blur7_u8 is XLA ops; K14 "
         "stands for the port's torch form of it, ops/image.gaussian_blur7_u8"),
        (WK, "hs_desc_windows", WK.hs_desc_windows_ref, "hs_desc.cu",
         f"{tpu}window_kernels.py:1358 (_hs_fused_kernel, launched by "
         f"_hs_desc_windows_impl {tpu}window_kernels.py:1565)"),
        (DK, "select_cells", D.select_topk_cells, "select_cells.cu",
         f"no TPU kernel: {tpu}detect.py:279 select_topk_cells is XLA ops "
         "and settles a tie with lax.cond (:327); K13 stands for the port's "
         "torch form of it, ops/detect.select_topk_cells"),
        (RS, "smallest_eigvec9", RS.smallest_eigvec9_ref, "jacobi_eigh9.cu",
         f"no TPU kernel: {tpu}ransac.py:71 solves with jnp.linalg.eigh (an "
         "XLA op); K12's jacobi9_kernel solves the refit's system and stands "
         "for torch.linalg.eigh, which reads its status back to the host"),
        (RS, "solve_minimal_sets", RS.solve_minimal_sets_ref,
         "jacobi_eigh9.cu",
         f"no TPU kernel: {tpu}ransac.py:51 _dlt of the minimal sets (XLA "
         "ops, jnp.linalg.eigh at :71); K12's dlt4_solve_kernel"),
        (RS, "score_homographies", RS.score_homographies_ref,
         "ransac_verify.cu",
         f"no TPU kernel: {tpu}ransac.py:93 _reproj_err2 and the mask and "
         "sum at :120-122 (XLA ops); K12's ransac_score_kernel"),
        (RS, "inlier_mask", RS.inlier_mask_ref, "ransac_verify.cu",
         f"no TPU kernel: {tpu}ransac.py:124 and :129-130, the winner's and "
         "the refit's masks (XLA ops); K12's ransac_mask_kernel"),
    ]
    ransac_kernels = ["solve_minimal_sets", "score_homographies",
                      "inlier_mask", "smallest_eigvec9"]
    names = [n for _, n, *_ in kernels]
    pyramid_kernels = ["resize_u8_kernel"]     # every detect call: 7 launches
    blur_kernels = ["gaussian_blur7_u8_kernel"]     # every dAC call: 8
    detect_kernels = pyramid_kernels + ["fast_harris_nms_cells",
                                        "select_cells", "ic_angles_windows"]
    desc_kernels = {"bad": ["bad_descriptors_windows"],
                    "hash_sift": ["warp_patches_windows",
                                  "hs_hist_from_patches"]}

    def eager_run(*args, **kwargs):
        """`G.CACHE.run` as an eager call: the core's own tensors, and no
        packed block."""
        return G.run_eager(*args, **kwargs) + (None,)

    def plain_kernels():
        """Route the pipeline through the plain versions (this script
        only: it is the on-card reference), eagerly: a captured graph
        replays the kernels it captured."""
        return patched([((m, n), ref) for m, n, ref, *_ in kernels]
                       + [((G.CACHE, "run"), eager_run)])

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
        if a kernel of `expect` did not launch, one of `forbid` did, the
        pyramid's kernel did not launch 7 times per detect call, or the blur
        did not launch 8 times per detect call where `expect` holds it (a
        detect_and_compute call) and 0 times where not.  fn runs the core
        eagerly: a graph's replay (`graphs.py`) calls no wrapper."""
        calls = {n: [] for n in names}

        def recording(f, name):
            def call(*args, **kwargs):
                calls[name].append((args, kwargs))
                return f(*args, **kwargs)
            return call

        # a wrapper counts on the function its module name is bound to, so
        # counts are reset and read while the recorders are in place
        with patched([((m, n), recording(getattr(m, n), n))
                      for m, n, *_ in kernels]
                      + [((G.CACHE, "run"), eager_run)]):
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
        blurs = 8 * detect_calls if blur_kernels[0] in expect else 0
        if counts[blur_kernels[0]] != blurs:
            fail(f"{label}: {counts[blur_kernels[0]]} K14 launches, expected "
                 f"{blurs} (8 for each detect_and_compute call, none for "
                 "detect and compute)")
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

    stamp("kernels built; K1, K7, K8, K9, K10, K14 against plain")
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
        for what, a, b in zip(("cellmax", "cellrow", "cellcnt", "cellbits"),
                              got, ref):
            check_same(f"K1 {label} radius {radius} {what}",
                       "fast_harris_nms_cells", a, b)
        pop = sum((got[3] >> k) & 1 for k in range(8)).to(torch.int32)
        if not torch.equal(pop, got[2]):
            fail(f"K1 {label} radius {radius}: cellcnt is not the popcount "
                 "of cellbits")
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
    # the tied block's survivors all come from K1's bitmap on the card
    tie_kps = [EfficientFeatures(nfeatures=64, nlevels=1,
                                 descriptor_type="bad_256",
                                 device=d).detect(tie_image())._slots
               for d in ("cuda", "cpu")]
    if int(tie_kps[0]["count"]) != int(tie_cnt.sum()) or not all(
            torch.equal(tie_kps[0][k].cpu(), tie_kps[1][k])
            for k in tie_kps[1] if k != "angle") or float(
                (tie_kps[0]["angle"].cpu() - tie_kps[1]["angle"]).abs().max()
            ) >= ANGLE_TOL:
        fail("tie image: the selection on the card differs from the CPU or "
             f"drops a survivor ({int(tie_kps[0]['count'])} keypoints of "
             f"{int(tie_cnt.sum())} survivors)")
    print(f"tie image detect: all {int(tie_kps[0]['count'])} survivors "
          "selected, the tied ones too; slots bit-identical to the CPU port")
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
    # radius <= 9 takes K7's staged NMS, radius >= 10 the per-pixel scan
    mask_rng = np.random.default_rng(5)
    rnd = torch.from_numpy(mask_rng.random((H, W)) < 0.5).to(dev)
    roi_np = SC.roi_mask(H, W)
    roi = torch.from_numpy(roi_np).to(dev)
    resp8 = DK.fast_harris(img, 20)
    k9_radii = (1, 2, 3, 5, 8, 9, 15, 49, 64, 128)
    under_roi = torch.where(roi != 0, resp8, D.RESP_SENTINEL)
    k9_maps = [("unmasked", resp8), ("ROI", under_roi),
               ("random mask", torch.where(rnd, resp8, D.RESP_SENTINEL)),
               ("tied responses", tied_responses(resp8)),
               ("31x63, less than a tile",
                resp8[1084:1115, 1500:1563].contiguous()),
               ("97x65", resp8[1000:1097, 1500:1565].contiguous()),
               ("33x200", resp8[1000:1033, 1500:1700].contiguous())]
    for label, resp in k9_maps:
        live = []
        for radius in k9_radii:
            got = DK.radius_nms(resp, radius)
            check_same(f"K9 {label} radius {radius}", "radius_nms", got,
                       DK.radius_nms_ref(resp, radius))
            live.append(int(got.sum()))
        corners = int((resp != D.RESP_SENTINEL).sum())
        if live[0] != corners:
            fail(f"K9 {label} radius 1: {live[0]} of {corners} corners "
                 "survive an empty disc")
        print(f"K9 {label} {tuple(resp.shape)}: bit-exact; {corners} "
              f"corners, survivors at radius "
              f"{'/'.join(map(str, k9_radii))}: {live}")
    for radius in (5, 9):
        k9_ms = launch_ms(lambda: DK.radius_nms(under_roi, radius),
                          "radius_nms")[0]
        b_ms, b_by = bound("radius_nms", [((under_roi, radius), {})])
        print(f"time K9 kernel only, one launch at radius {radius} on the "
              f"{H}x{W} map under the ROI: {k9_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} [{hw}]")
    k9_ms = time_ms(lambda: DK.radius_nms(under_roi, 64), iters=3, warmup=1)
    b_ms, b_by = bound("radius_nms", [((under_roi, 64), {})])
    print(f"time K9 one call at radius 64 (the per-pixel scan) on the "
          f"{H}x{W} map under the ROI: {k9_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"by {b_by} [{hw}]")
    del resp8, under_roi, k9_maps

    # -- K10: the pyramid's resize vs plain, bit-exact ------------------------
    def check_resize(label, src, dst_hw):
        got = I.resize_u8_kernel(src, dst_hw)
        check_same(f"K10 {label} {tuple(src.shape)} -> {dst_hw}",
                   "resize_u8_kernel", got, I.resize_u8(src, dst_hw))
        return got

    def check_pyramid(label, image):
        shapes = S.pyramid_shapes(*image.shape, 1.2, 8)
        levels = [image]
        for lvl in range(1, 8):
            levels.append(check_resize(f"{label} level {lvl}", levels[-1],
                                       shapes[lvl]))
        return levels

    levels = check_pyramid("4K", img)
    shapes = [tuple(lv.shape) for lv in levels]
    k10_ms = launch_ms(lambda: [I.resize_u8_kernel(levels[s - 1], shapes[s])
                                for s in range(1, 8)], "resize_kernel")
    k10_bound = [bound("resize_u8_kernel",
                       [((levels[s - 1], shapes[s]), {})])[0]
                 for s in range(1, 8)]
    print(f"time K10 kernel only, the 7 levels of the {H}x{W} pyramid: "
          f"{sum(k10_ms):.4f} ms (" + " ".join(f"{t:.4f}" for t in k10_ms)
          + f"), bound {sum(k10_bound):.4f} ms by bytes ("
          + " ".join(f"{t:.4f}" for t in k10_bound) + f") [{hw}]")
    level = levels[-1]
    del levels
    for label, (ph, pw) in (("8K", (2 * H, 2 * W)), ("1080p", (H // 2,
                                                                W // 2))):
        check_pyramid(label, torch.from_numpy(
            SC.tiled_scene(ph, pw, seed=2160, distinct=False)).to(dev))
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
    # every source row starts one byte past a 16-byte boundary
    flat = torch.empty(H * W + 16, dtype=torch.uint8, device=dev)
    shifted = flat[1:1 + H * W].view(H, W)
    shifted.copy_(noise)
    check_resize("source rows at 1 mod 16", shifted, shapes[1])
    # a 3x downscale (tiles of both branches) and a 4x one (every tile
    # reads the image directly)
    for dst_hw in ((H // 3, W // 3), (H // 4, W // 4)):
        staged = I.resize_plan(dst_hw, (H, W)).staged
        check_resize("downscale", img, dst_hw)
        print(f"K10 downscale {H}x{W} -> {dst_hw}: bit-exact, "
              f"{int(staged.sum())} of {staged.size} tiles staged, the "
              "others read the image")
    check_resize("upscale", level, shapes[4])
    check_resize("tiny", level, (16, 20))
    check_resize("tiny", level, (8, 8))
    print(f"K10: bit-exact on the 7 pyramid levels of {H}x{W} {shapes[1:]}, "
          f"of {2 * H}x{2 * W} and of {H // 2}x{W // 2}, on noise and "
          f"all-255 (stays 255), on a {H - 1}x{W - 3} source to "
          f"{crop_shapes[1]} and {crop_shapes[2]}, on source rows that all "
          f"start unaligned, on {H // 3}x{W // 3} and {H // 4}x{W // 4} "
          f"downscales, on the upscale {tuple(level.shape)} -> {shapes[4]} "
          "and on 16x20 and 8x8 destinations")
    del white, level, flat, shifted

    # -- K14: the descriptors' blur vs plain, bit-exact ------------------------
    def check_blur(label, src):
        got = I.gaussian_blur7_u8_kernel(src)
        check_same(f"K14 {label} {tuple(src.shape)}",
                   "gaussian_blur7_u8_kernel", got, I.gaussian_blur7_u8(src))
        return got

    for label, (fh, fw) in (("4K", (H, W)), ("KITTI", (376, 1241))):
        frame = (img if (fh, fw) == (H, W) else torch.from_numpy(
            make_test_image(fh, fw, seed=376)).to(dev))
        lvls = I.build_pyramid(frame, 1.2, 8)
        for lv in lvls:
            check_blur(f"{label} level", lv)
            check_blur(f"{label} noise level", torch.from_numpy(
                mask_rng.integers(0, 256, tuple(lv.shape),
                                  dtype=np.uint8)).to(dev))
        k14_replay, k14_ms = replay_ms(
            lambda: [I.gaussian_blur7_u8_kernel(lv) for lv in lvls],
            "blur7_u8_kernel")
        k14_bound = [bound("gaussian_blur7_u8_kernel", [((lv,), {})])
                     for lv in lvls]
        k14_plain = time_ms(lambda: [I.gaussian_blur7_u8(lv) for lv in lvls],
                            iters=5)
        only = ("a record lost" if k14_ms is None else f"{sum(k14_ms):.4f} "
                "ms (" + " ".join(f"{t:.4f}" for t in k14_ms) + ")")
        print(f"time K14, the 8 levels of the {fh}x{fw} pyramid as one graph "
              f"replay: {k14_replay:.4f} ms, kernel only {only}, bound "
              f"{sum(b for b, _ in k14_bound):.4f} ms by "
              f"{k14_bound[0][1]} (" + " ".join(f"{b:.4f}" for b, _ in
                                                 k14_bound)
              + f"); plain {k14_plain:.3f} ms [{hw}]")
        del lvls, frame
    edges = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    edges[:, W // 2:] = 255
    edges[H // 3:H // 2, :W // 3] = 255
    edges[::5, 1::7] ^= 255
    for label, src in (("all-0", torch.zeros((H, W), dtype=torch.uint8,
                                             device=dev)),
                       ("all-255", torch.full((H, W), 255, dtype=torch.uint8,
                                              device=dev)),
                       ("hard edges", edges), ("odd crop", crop)):
        got = check_blur(label, src)
        if label.startswith("all-") and not bool((got == src).all()):
            fail(f"K14: an {label} image did not stay {label[4:]}")
    for hw_ in ((4, 5), (5, 4), (7, 300), (300, 7), (97, 333)):
        check_blur("small", noise[:hw_[0], :hw_[1]].contiguous())
    flat = torch.empty(H * W + 16, dtype=torch.uint8, device=dev)
    shifted = flat[3:3 + H * W].view(H, W)
    shifted.copy_(noise)
    check_blur("source rows from 3 mod 16", shifted)
    print(f"K14: bit-exact on the 8 pyramid levels of {H}x{W} and 376x1241 "
          f"(scene and noise), on all-0 and all-255 (both stay), hard edges, "
          f"a {H - 1}x{W - 3} crop, 4x5 to 300x7 and a source that starts 3 "
          "bytes past a 16-byte boundary")
    del edges, flat, shifted

    # -- K1 with its ROI mask vs plain, bit-exact -----------------------------

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

    # the tie image under a mask that cuts one tied block and leaves the
    # other tied: the masked bitmap on the card
    tie_kps = [EfficientFeatures(nfeatures=64, nlevels=1,
                                 descriptor_type="bad_256", device=d).detect(
                                     tie_image(), mask=tie_mask())._slots
               for d in ("cuda", "cpu")]
    if int(tie_kps[1]["count"]) != 3 \
            or not all(torch.equal(tie_kps[0][k].cpu(), tie_kps[1][k])
                       for k in tie_kps[1] if k != "angle") or float(
                (tie_kps[0]["angle"].cpu() - tie_kps[1]["angle"]).abs().max()
            ) >= ANGLE_TOL:
        fail("masked tie image: the selection on the card differs from the "
             "CPU")
    print("masked tie image detect: "
          f"{int(tie_kps[0]['count'])} keypoints (3 expected), slots "
          "bit-identical to the CPU port")

    stamp("K13 against plain")
    # -- K13: the cells route's selection, bit for bit its plain version ----
    tie_np = tie_image()
    nb4k = -(-H // 8) * -(-W // 8)

    def k1_cells(image, mask=None):
        cm_, cr_, _, cb_ = DK.fast_harris_nms_cells(image, 20, 15, mask)
        return cm_, cr_, cb_, *image.shape

    def grid_cells(h_, w_, mask=None):
        """Cells of survivors every 6 px from (3, 3), all of one response:
        every 8x8 block live and tied with every other (`equal_image`
        without K1's 15 px border)."""
        surv = torch.zeros((h_, w_), dtype=torch.bool, device=dev)
        surv[3::6, 3::6] = True
        if mask is not None:
            surv &= mask
        cm_, cr_, _, cb_ = DK.cells_from_dense(
            torch.where(surv, 1000.0, D.RESP_SENTINEL), surv)
        return cm_, cr_, cb_, h_, w_

    k13_cases = [
        ("4K scene", lambda: k1_cells(sparse), (1, 8687, 100000)),
        ("4K dense scene", lambda: k1_cells(img),
         (8687, 40000, nb4k, 200000)),
        ("4K dense scene, ROI", lambda: k1_cells(img, roi != 0),
         (8687, nb4k)),
        ("4K equal responses", lambda: k1_cells(torch.from_numpy(
            equal_image(H, W)).to(dev)),
         (1, 1000, 8687, 40000, nb4k - 1, nb4k, 200000)),
        ("4K grid, every block live", lambda: grid_cells(H, W),
         (1, 8687, nb4k - 1, nb4k, 200000)),
        ("4K grid, ROI", lambda: grid_cells(H, W, roi != 0), (8687, nb4k)),
        ("4K tie_image tiling", lambda: k1_cells(torch.from_numpy(np.tile(
            tie_np, (-(-H // 96), W // 160))[:H].copy()).to(dev)),
         (1, 1001, 40000, 200000)),
        ("odd 1083x1917 crop",
         lambda: k1_cells(img[:1083, :1917].contiguous()), (3000,)),
        ("tie", lambda: k1_cells(torch.from_numpy(tie_np).to(dev)),
         (1, 2, 64)),
        ("tie 1x4", lambda: k1_cells(torch.from_numpy(
            np.tile(tie_np, (1, 4))).to(dev)), (1, 3, 5, 7, 100)),
        ("tie 3x3", lambda: k1_cells(torch.from_numpy(
            np.tile(tie_np, (3, 3))).to(dev)), (1, 3, 5, 7, 100)),
        ("8-row grid", lambda: grid_cells(8, W), (1, 5, 1000)),
        ("8-row grid, 65600 wide (one run of 8200 blocks)",
         lambda: grid_cells(8, 65600), (1, 8199, 8200, 20000)),
        ("5-row grid", lambda: grid_cells(5, 77), (1, 5, 385)),
        ("8-row crop", lambda: k1_cells(img[1000:1008].contiguous()),
         (1, 100))]
    for label, make, quotas in k13_cases:
        cm_, cr_, cb_, h_, w_ = make()
        for quota in quotas:
            before = DK.select_cells.launches
            got = DK.select_cells(cm_, cr_, cb_, h_, w_, quota)
            if DK.select_cells.launches != before + 1:
                fail(f"K13 {label} quota {quota}: not one launch")
            want = D.select_topk_cells(cm_, cr_, cb_, h_, w_, quota)
            for what, a, b in zip(("ys", "xs", "resp", "valid"), got, want):
                check_same(f"K13 {label} quota {quota} {what}",
                           "select_cells", a, b)
        print(f"K13 {label} {h_}x{w_}, quotas {quotas}: bit-identical to "
              f"its plain version, one launch a call ({int(want[3].sum())} "
              f"slots valid at quota {quotas[-1]})")
    makers = {label: make for label, make, _ in k13_cases}
    for label in ("4K dense scene", "4K grid, every block live"):
        cm_, cr_, cb_, h_, w_ = makers[label]()
        for quota in (8687, nb4k):
            k_ms = time_ms(lambda: DK.select_cells(cm_, cr_, cb_, h_, w_,
                                                   quota), iters=5)
            p_ms = time_ms(lambda: D.select_topk_cells(cm_, cr_, cb_, h_, w_,
                                                       quota), iters=5)
            print(f"time K13 {label} quota {quota}: {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms [{hw}]")

    stamp("K2, K3, K4, K5, K11 against plain")
    # -- K2: IC moments exact, angles bit for bit ---------------------------
    def bits(t):
        """A float32 tensor's bits, so that equality tells -0 from +0."""
        return t.contiguous().view(torch.int32)

    def check_angles(label, image, ys_t, xs_t, valid_t):
        got = WK.ic_angles_windows(image, ys_t, xs_t, valid_t)
        want = WK.ic_angles_windows_ref(image, ys_t, xs_t, valid_t)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(bits(got),
                                                         bits(want)):
            bad = (bits(got) != bits(want)).nonzero()[:5].flatten().tolist()
            fail(f"K2 {label}: angles differ from the plain angle step at "
                 f"slots {bad}")
        errs["ic_angles_windows"] = max(errs["ic_angles_windows"],
                                        max_abs_err(got, want))
        return got

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
    ic_valid = torch.from_numpy(rng.random(N_KP) < 0.75).to(dev)
    ic_valid[:8] = True
    got = check_angles("random and edge keypoints", img, ys_t, xs_t,
                       ic_valid)
    if bool(got[~ic_valid].any()):
        fail("K2: an invalid slot has a nonzero angle")
    check_angles("random and edge keypoints, every slot valid", img, ys_t,
                 xs_t, torch.ones_like(ic_valid))
    # the slots of a 4K detect call, level by level
    level_calls = []
    real_ic = WK.ic_angles_windows

    def recording_ic(*args):
        level_calls.append(args)
        return real_ic(*args)

    recording_ic.launches = 0
    with patched([((WK, "ic_angles_windows"), recording_ic)]):
        P.detect(img, P.FeatureConfig(nfeatures=NFEATURES))
    for lvl, args in enumerate(level_calls):
        check_angles(f"4K scene level {lvl}", *args)
    n_scene = sum(int(a[3].sum()) for a in level_calls)
    # the angle step alone: random moments, the axes, zeros, |m01| = |m10|
    m = rng.integers(-(1 << 21) + 1, 1 << 21, (1 << 26, 2), dtype=np.int32)
    v = np.array([0, 1, 7, 255, 1 << 20, (1 << 21) - 1], np.int32)
    special = ([(a, 0) for a in np.concatenate([v, -v])]
               + [(0, a) for a in np.concatenate([v, -v])]
               + [(sa * a, sb * a) for a in v for sa in (1, -1)
                  for sb in (1, -1)])
    m = torch.from_numpy(np.concatenate([m, np.array(special, np.int32)])
                         ).to(dev)
    a_got = WK.ic_angles_from_moments(m)
    a_ref = WK.ic_angles_from_moments_ref(m)
    n_diff = int((bits(a_got) != bits(a_ref)).sum())
    if n_diff:
        bad = (bits(a_got) != bits(a_ref)).nonzero()[:5].flatten()
        fail(f"K2's angle step: {n_diff} of {m.shape[0]} angles differ from "
             f"the plain step, first at moments {m[bad].tolist()}")
    n_pairs = m.shape[0]
    del m, a_got, a_ref
    print(f"K2 {N_KP} keypoints (edges included): moments exact; angles bit "
          f"for bit the plain angle step's on the card there (a quarter of "
          f"the slots invalid, then none), on the {n_scene} keypoints of a "
          f"4K detect call's {len(level_calls)} levels, and on "
          f"{n_pairs} moment pairs ({n_pairs - len(special)} random with "
          "|m| < 2^21, the axes, zeros, |m01| = |m10|); invalid slots 0")

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

    # -- K4: HashSIFT warp, byte for byte -----------------------------------
    def check_warp(label, image, kp, scale=1.0):
        got = WK.warp_patches_windows(image, *kp, scale)
        want = WK.warp_patches_windows_ref(image, *kp, scale)
        torch.cuda.synchronize()
        if image.numel() == 1 and bool(got.any()):
            fail("K4: a 1x1 image, where no 2x2 support fits, gave a "
                 "nonzero patch")
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
            fail(f"K4 {label}: {int((got != want).sum())} bytes differ from "
                 f"the plain version, first at slots {bad}")
        errs["warp_patches_windows"] = max(errs["warp_patches_windows"],
                                           max_abs_err(got, want))
        return got

    warp_sizes = np.array([31.0 * 1.2 ** k for k in range(8)] + [300.0],
                          np.float32)
    ksz = warp_sizes[np.arange(N_KP) % len(warp_sizes)]
    wkp = [torch.from_numpy(a).to(dev) for a in (kx, ky, ksz, ka, kvalid)]
    patches = check_warp("sizes 31*1.2^k and 300", img, wkp)
    # the largest window staged is 64 px: size 41.0 (s = 1.28125) fits, 41.1
    # does not; keypoints around the image too
    wlim = rng.choice(np.float32([40.0, 40.9, 41.0, 41.1, 41.5, 43.0]), N_KP)
    ox = rng.uniform(-60.0, W + 60.0, N_KP).astype(np.float32)
    oy = rng.uniform(-60.0, H + 60.0, N_KP).astype(np.float32)
    ox[:8], oy[:8] = kx[:8], ky[:8]
    for what, kp in (("sizes 40-43 px, both sides of the window limit",
                      (kx, ky, wlim, ka, kvalid)),
                     ("sizes 31*1.2^k and 300 in and around the image",
                      (ox, oy, ksz, ka, kvalid))):
        kp = [torch.from_numpy(a).to(dev) for a in kp]
        check_warp(what, img, kp)
        for scale in (1.0, 1.2):
            if scale != 1.0:
                check_warp(f"{what}, scale {scale}", img, kp, scale)
            plan = HS.warp_window_plan(kp[0], kp[1], np.float32(scale)
                                       * kp[2] / 32.0, H, W)
            print(f"K4 {what}, scale {scale}: byte for byte; "
                  f"{int((plan.in_smem & kp[4]).sum())} valid keypoints "
                  "sample a staged window, "
                  f"{int((~plan.in_smem & kp[4]).sum())} the image")
    for shape in ((1, 1), (1, 40), (40, 1), (2, 3), (3, 2), (3, 50)):
        tiny = torch.from_numpy(edge_rng.integers(0, 256, shape,
                                                  dtype=np.uint8)).to(dev)
        n = 64
        ex = edge_rng.uniform(-40.0, shape[1] + 40.0, n).astype(np.float32)
        ey = edge_rng.uniform(-40.0, shape[0] + 40.0, n).astype(np.float32)
        ekp = [torch.from_numpy(a).to(dev) for a in (ex, ey, ksz[:n],
                                                    ka[:n])]
        for k, ok in ((n, np.ones(n, bool)), (n, np.zeros(n, bool)),
                      (1, np.ones(1, bool))):
            got = check_warp(f"{shape[0]}x{shape[1]} image, n = {k}", tiny,
                             [t[:k] for t in ekp]
                             + [torch.from_numpy(ok).to(dev)])
            if not ok.any() and bool(got.any()):
                fail("K4: an invalid slot has a nonzero patch")
    print(f"K4 {N_KP} keypoints, sizes "
          f"{[round(float(v), 2) for v in warp_sizes]} (corners, angle -1 "
          f"and invalid slots included): byte for byte; images 1x1, 1x40, "
          "40x1, 2x3, 3x2, 3x50 (64 keypoints in and around each, all valid "
          "/ all invalid, and n = 1): byte for byte")

    stamp("the keypoint trig of K3, K4 and K11, every angle in [0, 360)")
    # -- the device trig against ops.bad.affine_trig on the card ------------
    top = 0x43B40000                      # the bits of 360.0
    chunk = 1 << 28
    n_trig = n_trig_diff = 0
    for scale in (1.0, 1.2):
        for start in list(range(0, top, chunk)) + [None]:
            if start is None:             # the last chunk: angle -1 alone
                angle = torch.tensor([-1.0], device=dev)
            else:
                angle = torch.arange(start, min(start + chunk, top),
                                     dtype=torch.int32,
                                     device=dev).view(torch.float32)
            size = torch.full_like(angle, 31.0)
            got = WK.keypoint_trig(size, angle, scale)
            s_ref, cos_ref, sin_ref = B.affine_trig(size, angle, scale)
            want = (s_ref, cos_ref * s_ref, sin_ref * s_ref)
            del s_ref, cos_ref, sin_ref
            differ = torch.zeros(angle.shape, dtype=torch.bool, device=dev)
            for a, b in zip(got, want):
                differ |= bits(a) != bits(b)
            nd = int(differ.sum())
            if nd:
                at = angle[differ][:5].tolist()
                fail(f"trig, scale {scale}: {nd} of {angle.numel()} angles "
                     f"of the chunk from bit pattern {start} give other s, "
                     f"cos*s or sin*s than ops.bad.affine_trig, first at "
                     f"{at}")
            n_trig += angle.numel()
            n_trig_diff += nd
            del angle, size, got, want, differ
    torch.cuda.empty_cache()
    print(f"trig: {n_trig} (angle, scale) pairs, every float32 angle in "
          f"[0, 360) and -1 at size 31 and scale factors 1.0 and 1.2: "
          f"{n_trig_diff} differ from ops.bad.affine_trig on the card")

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
        k6_names = ("knn2_prep_kernel", "knn2_mma_kernel", "knn2_merge_kernel")
        k6_launches = traced_launches(
            kernel_names(lambda: TM.knn2_topk2(q, v1, t, v2),
                         want=dict.fromkeys(k6_names, 1)), k6_names)
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

    stamp("K12 against plain")
    # -- K12: RANSAC's solve and verify, bit for bit their plain versions ---
    def once(label, name, fn):
        """fn's result; fails unless it launched K12's wrapper `name` once."""
        before = getattr(RS, name).launches
        out = fn()
        if getattr(RS, name).launches != before + 1:
            fail(f"K12 {label}: {getattr(RS, name).launches - before} "
                 f"launches of {name}, not 1")
        return out

    def dlt_systems(n, seed):
        """Normal matrices of the DLT of n exact 4-point sets (rank 8), as
        RANSAC's minimal sets give them."""
        g = np.random.default_rng(seed)
        hs = g.standard_normal((n, 3, 3))
        src = g.uniform(-1, 1, (n, 4, 2))
        ph = np.concatenate([src, np.ones((n, 4, 1))], -1) \
            @ hs.transpose(0, 2, 1)
        dst = ph[..., :2] / ph[..., 2:]
        x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
        z, o = np.zeros_like(x), np.ones_like(x)
        a = np.concatenate(
            [np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1),
             np.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)], axis=1)
        return (a.transpose(0, 2, 1) @ a).astype(np.float32)

    m12 = np.random.default_rng(9).standard_normal((513, 9, 12))
    edge12 = torch.from_numpy(np.stack(
        [np.zeros((9, 9)), np.eye(9), 2 * np.eye(9),
         np.diag([3.0, 1, 1, 2, 1, 5, 1, 1, 4])]).astype(np.float32)).to(dev)
    for label, ata in (("random PSD, 513", m12 @ m12.transpose(0, 2, 1)),
                       ("DLT minimal sets, 257", dlt_systems(257, 12)),
                       ("DLT minimal sets, 1", dlt_systems(1, 13)[0]),
                       ("zero, identity, ties on the diagonal", edge12)):
        if ata is not edge12:
            ata = torch.from_numpy(np.asarray(ata, np.float32)).to(dev)
        got = once(label, "smallest_eigvec9",
                   lambda: RS.smallest_eigvec9(ata))
        check_same(f"K12 {label}", "smallest_eigvec9", got,
                   RS.smallest_eigvec9_ref(ata))
        if ata is edge12:   # repeated eigenvalues: the first smallest pick
            want = torch.eye(9, dtype=torch.float64, device=dev)[[0, 0, 0, 1]]
        else:
            want = torch.linalg.eigh(ata.double())[1][..., 0]
        off = float(torch.minimum((got.double() - want).abs().amax(-1),
                                  (got.double() + want).abs().amax(-1)).max())
        if not off < 1e-5:
            fail(f"K12 {label}: {off} from torch.linalg.eigh's eigenvector")
        print(f"K12 {label}: bit-identical to its plain version, within "
              f"{off:.2e} of torch.linalg.eigh in float64 (up to sign)")
    ata12 = torch.from_numpy(dlt_systems(257, 14)).to(dev)
    k12_ms = launch_ms(lambda: RS.smallest_eigvec9(ata12), "jacobi9_kernel")
    print(f"time K12 jacobi9_kernel only, 257 systems: {sum(k12_ms):.4f} ms, "
          f"bound {bound('smallest_eigvec9', [((ata12,), {})])[0]:.5f} ms by "
          f"operations [{hw}]")

    # 40000 pairs over a 4K frame under h12, 30% outliers, 40% of the slots
    # valid, every 97th source point on h12's line at infinity
    # (1e-5 x - 5e-6 y + 1 = 0), and three degenerate sets: slots 0-3
    # collinear, 4-7 with two coincident pairs, slot 8 four times
    g12 = np.random.default_rng(16)
    h12 = np.array([[1.02, 0.03, 5.0], [-0.02, 0.98, -3.0],
                    [1e-5, -5e-6, 1.0]])
    xy = g12.uniform(0, 1, (N_KP, 2)) * (W, H)
    xy[0:4] = [(100.0 + 50 * k, 200.0 + 25 * k) for k in range(4)]
    xy[5], xy[7] = xy[4], xy[6]
    ph = np.concatenate([xy, np.ones((N_KP, 1))], 1) @ h12.T
    uv = ph[:, :2] / ph[:, 2:] + g12.normal(0, 0.8, (N_KP, 2))
    uv[5], uv[7] = uv[4], uv[6]
    out12 = g12.random(N_KP) < 0.3
    out12[:9] = False
    uv[out12] = g12.uniform(0, 1, (int(out12.sum()), 2)) * (W, H)
    xy[7 + 97::97] = [-1e5, 0.0]
    src12 = torch.from_numpy(xy.astype(np.float32)).to(dev)
    dst12 = torch.from_numpy(uv.astype(np.float32)).to(dev)
    ok12 = torch.from_numpy(g12.random(N_KP) < 0.4).to(dev)
    h12_t = torch.from_numpy(h12.astype(np.float32)).to(dev)
    t2 = float(np.float32(RANSAC_THRESH) ** 2)
    far = int(((h12_t[2, 0] * src12[:, 0] + h12_t[2, 1] * src12[:, 1])
               + h12_t[2, 2]).abs().lt(RS.EPS_INF).sum())
    gen12 = torch.Generator(device=dev)
    sets12 = {}
    for iters in (512, 1, 4097):
        gen12.manual_seed(iters)
        sets12[f"iters {iters}"] = RS._draw_minimal_sets(ok12, iters, gen12)
    sets12["collinear, coincident and identical sets"] = torch.tensor(
        [[0, 1, 2, 3], [4, 5, 6, 7], [8, 8, 8, 8], [0, 1, 2, 4]],
        device=dev)
    for label, idx in sets12.items():
        H12 = once(label, "solve_minimal_sets",
                   lambda: RS.solve_minimal_sets(src12, dst12, idx))
        check_same(f"K12 solve, {label}", "solve_minimal_sets", H12,
                   RS.solve_minimal_sets_ref(src12, dst12, idx))
        if label.startswith("iters 512"):
            H512, idx512 = H12, idx
            H12 = torch.cat([h12_t[None], H12[1:]])   # points at infinity
        sc = once(label, "score_homographies",
                  lambda: RS.score_homographies(H12, src12, dst12, ok12, t2))
        check_same(f"K12 scores, {label}", "score_homographies", sc,
                   RS.score_homographies_ref(H12, src12, dst12, ok12, t2))
        if label.startswith("iters 512"):
            best512 = H12[int(sc.argmax())]
        print(f"K12 {label} ({idx.shape[0]} x {N_KP}): H and scores "
              f"bit-identical to the plain versions, best score "
              f"{int(sc.max())} of {int(ok12.sum())} valid")
    if not far:
        fail("K12: no point at infinity under h12")
    n_off = N_KP - 13
    for label, h, s_, d_, v_ in (
            (f"h12, {far} points at infinity", h12_t, src12, dst12, ok12),
            ("the best of 512 sets", best512, src12, dst12, ok12),
            ("every slot invalid", h12_t, src12, dst12,
             torch.zeros_like(ok12)),
            (f"N = {n_off}, off a block", h12_t, src12[:n_off],
             dst12[:n_off], ok12[:n_off])):
        got = once(label, "inlier_mask",
                   lambda: RS.inlier_mask(h, s_, d_, v_, t2))
        for what, a, b in zip(("mask", "count"), got,
                              RS.inlier_mask_ref(h, s_, d_, v_, t2)):
            check_same(f"K12 mask, {label}, {what}", "inlier_mask", a, b)
        sc = once(label, "score_homographies",
                  lambda: RS.score_homographies(h[None], s_, d_, v_, t2))
        if int(sc[0]) != int(got[1]):
            fail(f"K12 {label}: score {int(sc[0])}, mask count "
                 f"{int(got[1])}")
        print(f"K12 mask, {label}: mask and count {int(got[1])} "
              "bit-identical to the plain version and equal to the score")
    solve_ms = launch_ms(lambda: RS.solve_minimal_sets(src12, dst12, idx512),
                         "dlt4_solve_kernel")
    score_ms = launch_ms(
        lambda: RS.score_homographies(H512, src12, dst12, ok12, t2),
        "ransac_score_kernel")
    mask_ms = launch_ms(
        lambda: RS.inlier_mask(H512[0], src12, dst12, ok12, t2),
        "ransac_mask_kernel")
    for what, ms, name, args in (
            ("dlt4_solve_kernel, 512 sets", solve_ms, "solve_minimal_sets",
             (src12, dst12, idx512)),
            (f"ransac_score_kernel, 512 x {N_KP} ({int(ok12.sum())} valid)",
             score_ms, "score_homographies", (H512, src12, dst12, ok12, t2)),
            (f"ransac_mask_kernel, {N_KP}", mask_ms, "inlier_mask",
             (H512[0], src12, dst12, ok12, t2))):
        b_ms, b_by = bound(name, [(args, {})])
        print(f"time K12 {what}: {sum(ms):.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by} [{hw}]")
    sweeps = RS.jacobi_sweeps(RS.minimal_set_systems(src12, dst12,
                                                     idx512)[0])
    print(f"K12 Jacobi sweeps of the 512 sets: "
          f"{sweeps.bincount(minlength=RS.JACOBI_SWEEPS + 1).tolist()}")

    stamp("main path 1: detect_and_compute")
    # -- main path 1: detect_and_compute through the kernels ----------------
    selection = ("x", "y", "octave", "size", "response", "valid", "count")
    detected = None
    for dtype in ("bad_256", "bad_512", "hash_sift_256", "hash_sift_512"):
        kind = dtype.rsplit("_", 1)[0]
        ef = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                               device="cuda")
        with no_integral():
            (kps, desc), counts = drive(
                f"detect_and_compute {dtype}",
                lambda: ef.detect_and_compute_async(scene),
                detect_kernels + blur_kernels + desc_kernels[kind])
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
              f"launches {counts}; slots bit-identical to the plain "
              f"path on the card and to the CPU port (angles max "
              f"{dang:.2e} deg); descriptor bytes differing: plain "
              f"{ndiff_p}, cpu {ndiff_c} (budget {budget})")
        if detected is None:
            detected = kps
        if dtype == "bad_256":
            k3_calls = last_calls["bad_descriptors_windows"]
            with no_integral():
                k3_kernels = kernel_names(lambda: [
                    WK.bad_descriptors_windows(*a, **k) for a, k in k3_calls],
                    want={"bad_kernel": 1})
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

        syncs = checked_syncs(f"slice {dtype}",
                              lambda: ef.detect_and_compute_async(img))
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
    match_kernels = (detect_kernels + blur_kernels + desc_kernels["hash_sift"]
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
                        lambda: [step(f) for f in frames_dev],
                        match_kernels + ransac_kernels,
                        detect_calls=SEQ_FRAMES)
    for i in range(1, SEQ_FRAMES):
        count, n_match, Hm, n_inl = seq[i]
        got = check_geometry(f"sequence frame {i}", int(n_match), int(n_inl),
                             Hm.cpu().numpy(),
                             warps[i] @ np.linalg.inv(warps[i - 1]))
        print(f"sequence frame {i}: {int(count)} keypoints, {got}")
    seq_syncs = checked_syncs("sequence step", lambda: step(frames_dev[1]))
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

    (valid, Hm, inl, n_inl), counts = drive(
        "two-image matching", two_image, match_kernels + ransac_kernels,
        detect_calls=2)
    got = check_geometry("two-image", int(valid.sum()), int(n_inl),
                         Hm.cpu().numpy(), warps[1] @ np.linalg.inv(warps[0]))
    if bool((inl & ~valid).any()):
        fail("two-image: RANSAC kept a match the cross check dropped")
    print(f"two-image path frames 0 -> 1: launches {counts}; {got}")

    stamp("main path 5: detector configurations")
    # -- main path 5: the detector's configurations, ROI mask and radius ----
    # (tag, nonmax_radius, with the ROI, the detect kernels of its route)
    configs = [("a", 15, True, ["fast_harris_nms_cells", "select_cells"]),
               ("b", 5, False, ["fast_harris_nms"]),
               ("c", 5, True, ["fast_harris", "radius_nms"]),
               ("d", 64, False, ["fast_harris_nms_cells", "select_cells"])]
    detect_routes = ("fast_harris_nms_cells", "select_cells",
                     "fast_harris_nms", "fast_harris", "radius_nms")
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
                pyramid_kernels + ["ic_angles_windows"] + route
                + blur_kernels + desc_kernels[kind],
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
            syncs = checked_syncs(
                label, lambda: ef.detect_and_compute_async(img, mask=m_dev))
            ms = time_ms(lambda: ef.detect_and_compute_async(img, mask=m_dev))
            print(f"{label}: {n} keypoints{inside}; launches {counts}; slots "
                  f"bit-identical to the plain path, {ndiff} descriptor "
                  f"bytes differ (budget {budget}); {ms:.3f} ms/call, host "
                  f"syncs per call {syncs} [{hw}]")

    stamp("main path 6: fused HashSIFT, batch")
    # -- main path 6: the fused HashSIFT route and the batch entry point ----
    two_stage = desc_kernels["hash_sift"]
    fused_kernels = detect_kernels + blur_kernels + ["hs_desc_windows"]

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
        detect_kernels + blur_kernels + two_stage, detect_calls=nb)
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
        syncs = checked_syncs(f"{what} slice",
                              lambda: feat.detect_and_compute_async(img))
        print(f"time slice hash_sift_256 {what} {H}x{W} nfeatures "
              f"{NFEATURES}: {ms:.3f} ms/call, host syncs per call {syncs} "
              f"[{hw}]")
    pyr_ms = time_ms(lambda: I.build_pyramid(img, 1.2, 8))
    pyr_syncs = checked_syncs("pyramid", lambda: I.build_pyramid(img, 1.2, 8))
    with plain_kernels():
        pyr_plain = time_ms(lambda: I.build_pyramid(img, 1.2, 8))
        pyr_plain_syncs = checked_syncs(
            "plain pyramid", lambda: I.build_pyramid(img, 1.2, 8),
            check=False)
    print(f"time pyramid {H}x{W}, 8 levels: {pyr_ms:.3f} ms/call through "
          f"K10 ({pyr_syncs} host syncs), {pyr_plain:.3f} ms/call through "
          f"the plain resize ({pyr_plain_syncs} host syncs) [{hw}]")
    batch_ms = time_ms(lambda: ef_hs.detect_and_compute_batch(batch), iters=10)
    single_ms = time_ms(lambda: ef_hs.detect_and_compute_async(batch[1]))
    batch_syncs = checked_syncs("batch",
                                lambda: ef_hs.detect_and_compute_batch(batch))
    print(f"time batch of {nb} frames: {batch_ms:.3f} ms/call, "
          f"{batch_ms / nb:.3f} ms/frame, against {single_ms:.3f} ms for a "
          f"single call on one of them; host syncs per batch call "
          f"{batch_syncs} [{hw}]")
    del batch, bslots, bdesc

    stamp("main path 7: the mesh forms on a 1-rank NCCL group")
    # -- main path 7: parallel/sharding.py over torch.distributed ----------
    # (a) one NCCL rank in this process, the headline configuration: the
    # band route (K10 per band, K8, the border and ROI rows, K9, K2, then
    # K3 / K4 + K5 / K11 on each band's window), the dp batch, the keypoint
    # axis and the sharded matcher, each equal to its single-device call
    import tempfile
    import torch.distributed as dist
    from efficient_features_tpu_torch.parallel import launch as LA
    from efficient_features_tpu_torch.parallel import sharding as SH
    band_kernels = pyramid_kernels + ["fast_harris", "radius_nms",
                                      "ic_angles_windows"]
    cell_kernels = ["fast_harris_nms_cells", "select_cells",
                    "fast_harris_nms"]
    band_names = ("resize_kernel", "fast_harris_kernel", "radius_nms_scan",
                  "ic_kernel")
    mesh_dir = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{mesh_dir.name}/s",
                            world_size=1, rank=0)

    def mesh_time(what, mesh_fn, single_fn, iters=5):
        ms_mesh = time_ms(mesh_fn, iters=iters, warmup=1)
        ms_single = time_ms(single_fn, iters=iters, warmup=1)
        print(f"time mesh {what}: {ms_mesh:.3f} ms/call on a 1-rank NCCL "
              f"mesh, {ms_single:.3f} ms/call without a mesh [{hw}]")

    def same_result(label, got, want):
        """Slot dicts (or tensors) equal bit for bit."""
        if isinstance(got, dict):
            differ = [k for k in want if not torch.equal(got[k], want[k])]
        else:
            differ = [] if torch.equal(got, want) else ["rows"]
        if differ:
            fail(f"{label}: {differ} differ from the single-device call")

    try:
        mesh = SH.make_mesh()
        ef_bad = EfficientFeatures(nfeatures=NFEATURES,
                                   descriptor_type="bad_256", device="cuda")
        listing = {}
        for label, masked in (("detect", False), ("detect mask=roi", True)):
            m = roi if masked else None
            kps_m, counts = drive(
                f"mesh {label}",
                lambda: ef_bad.detect_async(scene, mask=m, mesh=mesh),
                band_kernels, forbid=cell_kernels)
            same_result(f"mesh {label}", kps_m._slots,
                        ef_bad.detect_async(scene, mask=m)._slots)
            print(f"mesh {label} {H}x{W}, {NFEATURES} features, radius 15: "
                  f"{kps_m.count} keypoints, slots bit-identical to the "
                  f"single-device call; launches {counts}")
            mesh_time(label,
                      lambda: ef_bad.detect_async(scene, mask=m, mesh=mesh),
                      lambda: ef_bad.detect_async(scene, mask=m))
        for dtype, fused in (("bad_256", False), ("hash_sift_256", False),
                             ("hash_sift_256", True)):
            feat = EfficientFeatures(nfeatures=NFEATURES,
                                     descriptor_type=dtype, device="cuda",
                                     hs_fused=fused)
            kind = dtype.rsplit("_", 1)[0]
            expect = band_kernels + blur_kernels + (
                ["hs_desc_windows"] if fused else desc_kernels[kind])
            forbid = cell_kernels + (two_stage if fused else
                                     ["hs_desc_windows"])
            label = f"detect_and_compute {dtype}{' fused' if fused else ''}"
            (kps_m, desc_m), counts = drive(
                f"mesh {label}",
                lambda: feat.detect_and_compute_async(scene, mesh=mesh),
                expect, forbid=forbid)
            kps_s, desc_s = feat.detect_and_compute_async(scene)
            same_result(f"mesh {label}", kps_m._slots, kps_s._slots)
            same_result(f"mesh {label} descriptors", desc_m, desc_s)
            names_k = band_names + {"bad": ("bad_kernel",),
                                    "hash_sift": ("warp_kernel",
                                                  "hs_hist_kernel")}[kind] \
                if not fused else band_names + ("hs_desc_kernel",)
            listing[label] = traced_launches(kernel_names(
                lambda: feat.detect_and_compute_async(scene, mesh=mesh),
                want=dict.fromkeys(names_k, 1)), names_k)
            if not all(listing[label].values()):
                fail(f"mesh {label}: kernels missing from the trace "
                     f"{listing[label]}")
            print(f"mesh {label}: {kps_m.count} keypoints, slots and "
                  f"descriptor bytes identical to the single-device call; "
                  f"launches {counts}; CUDA kernels traced (launches) "
                  f"{listing[label]}")
            mesh_time(label,
                      lambda: feat.detect_and_compute_async(scene, mesh=mesh),
                      lambda: feat.detect_and_compute_async(scene))
        ef_hs = EfficientFeatures(nfeatures=NFEATURES,
                                  descriptor_type="hash_sift_256",
                                  device="cuda")
        batch = torch.stack([img] + frames_dev)
        (bs_m, bd_m), counts = drive(
            "mesh detect_and_compute_batch",
            lambda: ef_hs.detect_and_compute_batch(batch, mesh=mesh),
            detect_kernels + blur_kernels + two_stage,
            detect_calls=batch.shape[0])
        bs_s, bd_s = ef_hs.detect_and_compute_batch(batch)
        same_result("mesh batch", bs_m, bs_s)
        same_result("mesh batch descriptors", bd_m, bd_s)
        print(f"mesh detect_and_compute_batch of {batch.shape[0]} frames "
              f"(make_mesh()): equal to the batch without a mesh; launches "
              f"{counts}")
        mesh_time(f"detect_and_compute_batch of {batch.shape[0]} frames",
                  lambda: ef_hs.detect_and_compute_batch(batch, mesh=mesh),
                  lambda: ef_hs.detect_and_compute_batch(batch), iters=3)
        del batch, bs_m, bd_m, bs_s, bd_s
        all_valid = torch.ones(N_KP, dtype=torch.bool, device=dev)
        for kind in ("bad", "hash_sift"):
            rows_m, counts = drive(
                f"mesh compute_sharded {kind}",
                lambda: SH.compute_sharded(img, hk_dev, all_valid, mesh,
                                           kind=kind),
                desc_kernels[kind])
            rows_s = P.compute(img, hk_dev, all_valid, 256, kind, 1.0)
            same_result(f"mesh compute_sharded {kind}", rows_m, rows_s)
            print(f"mesh compute_sharded {kind}-256, {N_KP} keypoints of "
                  f"31-300 px: bytes identical to pipeline.compute; "
                  f"launches {counts}")
            mesh_time(f"compute_sharded {kind}-256",
                      lambda: SH.compute_sharded(img, hk_dev, all_valid, mesh,
                                                 kind=kind),
                      lambda: P.compute(img, hk_dev, all_valid, 256, kind,
                                        1.0))
        d1, v1, d2, v2 = (t.to(dev) for t in knn2_inputs(32, N_KP, N_KP))
        got, counts = drive(
            "mesh knn2_match_sharded",
            lambda: SH.knn2_match_sharded(d1, v1, d2, v2, mesh),
            ["knn2_topk2"])
        if counts["knn2_topk2"] != 2:
            fail(f"mesh knn2_match_sharded: {counts}, expected 2 K6 calls")
        want = TM.knn2_ratio_match_masked(d1, v1, d2, v2)
        for a, b in zip(got, want):
            same_result("mesh knn2_match_sharded", a, b)
        # both directions: each of K6's three kernels twice
        k6_listed = traced_launches(kernel_names(
            lambda: SH.knn2_match_sharded(d1, v1, d2, v2, mesh),
            want=dict.fromkeys(k6_names, 2)), k6_names)
        if any(c != 2 for c in k6_listed.values()):
            fail(f"mesh knn2_match_sharded: kernel launches of one call "
                 f"{k6_listed}, expected two of each")
        print(f"mesh knn2_match_sharded {N_KP} x {N_KP}, 256 bits, masked: "
              f"(j, best, ok) identical to knn2_ratio_match_masked, "
              f"{int(got[2].sum())} matches; launches {counts}; CUDA "
              f"kernels traced (launches) {k6_listed}")
        mesh_time(f"knn2_match_sharded {N_KP} x {N_KP}",
                  lambda: SH.knn2_match_sharded(d1, v1, d2, v2, mesh),
                  lambda: TM.knn2_ratio_match_masked(d1, v1, d2, v2))

        stamp("main path 8: the selection's cost on (b), (c) and the 1-rank "
              "mesh")
        # -- main path 8: the flat sort's device ms, the ms and the host
        # syncs per call of the slice's three dense-map routes at 4K (JAX
        # would take its chunked and capped branches at radius 5, the 8x8
        # reduced one at radius 15)
        ef5 = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=5,
                                descriptor_type="hash_sift_256",
                                device="cuda")
        ef15 = EfficientFeatures(nfeatures=NFEATURES,
                                 descriptor_type="hash_sift_256",
                                 device="cuda")
        for label, fn, route in (
                ("(b) radius 5", lambda: ef5.detect_and_compute_async(img),
                 ["fast_harris_nms"]),
                ("(c) radius 5 mask=roi",
                 lambda: ef5.detect_and_compute_async(img, mask=roi),
                 ["fast_harris", "radius_nms"]),
                ("1-rank mesh dAC radius 15",
                 lambda: ef15.detect_and_compute_async(img, mesh=mesh),
                 ["fast_harris", "radius_nms"])):
            _, counts = drive(
                f"selection {label}", fn,
                pyramid_kernels + ["ic_angles_windows"] + route
                + blur_kernels + two_stage,
                forbid=[k for k in detect_routes if k not in route])
            syncs = checked_syncs(f"selection {label}", fn)
            ms = time_ms(fn)
            sort_ms = sum(t for k, (_, t) in kernel_names(fn).items()
                          if "Sort" in k)
            print(f"selection {label}: launches {counts}; sort kernels "
                  f"{sort_ms:.3f} ms/call (device), {ms:.3f} ms/call, host "
                  f"syncs per call {syncs} [{hw}]")
    finally:
        dist.destroy_process_group()
        mesh_dir.cleanup()

    stamp("the mesh forms on 2 gloo ranks on the card, 1080x1920")
    # (b) two rank processes on this card, gloo through the host: each rank
    # owns half the rows of every level, so the halos cross ranks
    hw_b = (1080, 1920)
    scene_b = SC.tiled_scene(*hw_b, seed=1080, distinct=False)
    roi_b = SC.roi_mask(*hw_b)
    mesh_b = LA.MeshSpec((2,))
    cases_b = [(f"detect_and_compute {dt}{' fused' if fused else ''}"
                f"{' mask=roi' if masked else ''}", "detect_and_compute_async",
                dict(nfeatures=10000, descriptor_type=dt, hs_fused=fused),
                masked)
               for dt, fused, masked in (("bad_256", False, False),
                                         ("hash_sift_256", False, False),
                                         ("hash_sift_256", True, False),
                                         ("bad_256", False, True))]
    cases_b.append(("detect mask=roi", "detect_async",
                    dict(nfeatures=10000, descriptor_type="bad_256"), True))
    calls_b = [("chip_smoke:mesh_rank_call",
                (method, dict(feat, device="cuda"), scene_b),
                dict(mesh=mesh_b, **({"mask": roi_b} if masked else {})))
               for _, method, feat, masked in cases_b]
    t_b = time.perf_counter()
    ranks_b = LA.spmd(2, calls_b, backend="gloo", device="cuda",
                      timeout_s=300)
    print(f"2 gloo ranks on {torch.cuda.get_device_name(0)}: spawned, "
          f"joined and ran {len(calls_b)} calls in "
          f"{time.perf_counter() - t_b:.1f} s")
    for j, (label, method, feat, masked) in enumerate(cases_b):
        single = getattr(EfficientFeatures(device="cuda", **feat), method)(
            scene_b, roi_b if masked else None)
        if method == "detect_async":
            want = ({k: v.cpu().numpy() for k, v in single._slots.items()},)
        else:
            want = ({k: v.cpu().numpy() for k, v in single[0]._slots.items()},
                    single[1].cpu().numpy())
        ms_single = time_ms(lambda: getattr(
            EfficientFeatures(device="cuda", **feat), method)(
                scene_b, roi_b if masked else None), iters=3, warmup=1)
        for r, res in enumerate(ranks_b):
            out = res[j]
            if out[0] == "error":
                fail(f"2-rank mesh {label}, rank {r}: {out[1]}: {out[2]}")
            got, ms, launches = out
            parts = (got,) if method == "detect_async" else got
            for g, w in zip(parts, want):
                if isinstance(w, dict):
                    differ = [k for k in w if not np.array_equal(g[k], w[k])]
                else:
                    differ = [] if np.array_equal(g, w) else ["descriptors"]
                if differ:
                    fail(f"2-rank mesh {label}, rank {r}: {differ} differ "
                         "from the single-device call on the card")
            used = {k: v for k, v in launches.items() if v}
            missing = [k for k in ("resize_u8_kernel", "fast_harris",
                                   "radius_nms", "ic_angles_windows")
                       if not used.get(k)]
            if missing or any(used.get(k) for k in cell_kernels):
                fail(f"2-rank mesh {label}, rank {r}: launches {used}")
            print(f"2-rank mesh {label} {hw_b[0]}x{hw_b[1]}, rank {r}: "
                  f"bit-identical to the single-device call on the card; "
                  f"launches per call {used}; {ms:.3f} ms/call against "
                  f"{ms_single:.3f} ms/call without a mesh [{hw}]")

    stamp("the tie scene at 4K")
    # -- tie_image's pattern in the 4K scene at (ty, tx), 8-aligned as in
    # tie_image: its two tied corners share an 8x8 block of level 0, whose
    # survivors selection places from K1's bitmap (where the JAX package
    # takes its dense fallback)
    ty, tx = H // 32 * 16 + 8, W // 32 * 16 + 8
    tie_scene = scene.copy()
    tie_scene[ty:ty + 96, tx:tx + 160] = tie_image()
    tie_dev = torch.from_numpy(tie_scene).to(dev)
    tie_cnt = DK.fast_harris_nms_cells(tie_dev, 20, 15)[2]
    tied = int((tie_cnt.reshape(tie_cnt.shape[0], -1, 8).sum(dim=2) > 1)
               .sum())
    if tied < 1:
        fail("4K tie scene: no 8x8 block of level 0 holds tied survivors")
    ef_tie = EfficientFeatures(nfeatures=NFEATURES, descriptor_type="bad_256",
                               device="cuda")
    with no_integral():
        (kps, desc), counts = drive(
            "4K tie scene", lambda: ef_tie.detect_and_compute_async(
                tie_scene),
            detect_kernels + blur_kernels + desc_kernels["bad"])
    with plain_kernels():
        kps_p, desc_p = ef_tie.detect_and_compute_async(tie_scene)
    kps_c, desc_c = EfficientFeatures(
        nfeatures=NFEATURES, descriptor_type="bad_256",
        device="cpu").detect_and_compute_async(tie_scene)
    slots = kps._slots
    differ = [k for k in selection + ("angle",)
              if not torch.equal(slots[k], kps_p._slots[k])]
    differ += [f"{k} (CPU)" for k in selection
               if not torch.equal(slots[k].cpu(), kps_c._slots[k])]
    dang = (slots["angle"].cpu() - kps_c._slots["angle"]).abs()
    dang = float(torch.minimum(dang, 360 - dang).max())
    ndiff = (int((desc != desc_p).sum()), int((desc.cpu() != desc_c).sum()))
    budget = byte_budget("bad", desc.numel())
    if differ or max(ndiff) > budget or dang >= ANGLE_TOL:
        fail(f"4K tie scene: slots {differ} differ from the plain path / "
             f"the CPU port, descriptor bytes {ndiff} (budget {budget}), "
             f"angles {dang}")
    tie_syncs = checked_syncs("4K tie scene",
                              lambda: ef_tie.detect_and_compute_async(tie_dev))
    tie_ms = time_ms(lambda: ef_tie.detect_and_compute_async(tie_dev))
    no_tie_ms = time_ms(lambda: ef_tie.detect_and_compute_async(img))
    print(f"4K tie scene, BAD-256 radius 15: {kps.count} keypoints; "
          f"{tied} tied 8x8 blocks at level 0; "
          f"launches {counts}; slots bit-identical to the plain path and to "
          f"the CPU port (angles max {dang:.2e} deg), descriptor bytes "
          f"differing plain {ndiff[0]} / cpu {ndiff[1]} (budget {budget}); "
          f"{tie_ms:.3f} ms/call, host syncs per call {tie_syncs}; the scene "
          f"without the pattern {no_tie_ms:.3f} ms/call [{hw}]")
    del tie_dev, kps_p, desc_p, kps_c, desc_c

    stamp("K13 on the cells route: its kernels in a trace")
    # -- one cells-route dAC call runs each of K13's three kernels once a
    # level, and no sort kernel runs anywhere in it; the traced calls are
    # replays of the key's graph (its first call and capture come first)
    k13_want = {"cells_live_kernel": 8, "cells_bucket_kernel": 8,
                "cells_place_kernel": 8}
    ef_r15 = EfficientFeatures(nfeatures=NFEATURES,
                               descriptor_type="hash_sift_256", device="cuda")
    ef_r64 = EfficientFeatures(nfeatures=NFEATURES, nonmax_radius=64,
                               descriptor_type="hash_sift_256", device="cuda")
    equal_dev = torch.from_numpy(equal_image(H, W)).to(dev)
    for label, fn in (
            ("radius 15", lambda: ef_r15.detect_and_compute_async(img)),
            ("radius 15 mask=roi",
             lambda: ef_r15.detect_and_compute_async(img, mask=roi)),
            ("radius 64", lambda: ef_r64.detect_and_compute_async(img)),
            ("equal responses, radius 15",
             lambda: ef_r15.detect_and_compute_async(equal_dev))):
        fn()
        fn()
        replays = G.CACHE.replays
        listed = kernel_names(fn, want=k13_want)
        if G.CACHE.replays < replays + 2:
            fail(f"cells-route dAC {label}: the traced calls did not replay")
        got = traced_launches(listed, k13_want)
        sorts = {k: c for k, (c, _) in listed.items() if "sort" in k.lower()}
        if got != k13_want or sorts:
            fail(f"cells-route dAC {label}: K13 launches {got} (expected "
                 f"{k13_want}), sort kernels {sorts}")
        k13_ms = {n: sum(t for k, (_, t) in listed.items() if n in k)
                  for n in k13_want}
        print(f"cells-route dAC {label}, replayed: K13 launches {got} (3 a "
              f"level), no sort kernel; K13 device ms " + ", ".join(
                  f"{n} {t:.4f}" for n, t in k13_ms.items())
              + f" [{hw}]")
    del equal_dev

    stamp("the packed fetch")
    # -- a replayed synchronous call brings its packed block to the host in
    # one pinned copy, and its host arrays equal the eager route's reads
    # field by field, bit for bit
    from efficient_features_tpu_torch.api import KeyPoints
    before = (G.CACHE.packed_fetches, G.CACHE.field_fetches)
    kps_f, desc_f = ef_r15.detect_and_compute(scene)
    arrays_f = kps_f.as_arrays()
    if (G.CACHE.packed_fetches, G.CACHE.field_fetches) != (
            before[0] + 1, before[1]) or kps_f._packed is None:
        fail(f"packed fetch: counters {before} -> {G.CACHE.packed_fetches}, "
             f"{G.CACHE.field_fetches}: the replay was not fetched as one "
             f"block")
    slots_e, desc_e = G.run_eager(torch.from_numpy(scene), ef_r15._cfg,
                                  device=dev)
    kps_e = KeyPoints(slots_e)
    arrays_e = kps_e.as_arrays()
    valid_e = slots_e["valid"].cpu().numpy()
    if not (all(np.array_equal(arrays_f[k], arrays_e[k]) and
                arrays_f[k].dtype == arrays_e[k].dtype for k in arrays_e)
            and np.array_equal(desc_f, desc_e.cpu().numpy()[valid_e])):
        fail("packed fetch: host arrays differ from the eager route's")
    fetch_syncs = host_syncs(
        lambda: ef_r15.detect_and_compute(img)[0].as_arrays())
    print(f"packed fetch: {len(arrays_f['x'])} keypoints, host arrays and "
          f"descriptors bit-identical to the eager route; host syncs of a "
          f"replayed detect_and_compute + as_arrays on a card image "
          f"{len(fetch_syncs)}")
    del kps_f, desc_f, slots_e, desc_e, kps_e

    stamp("the profiler on the card")
    # -- utils/profiler: timeit_ms beside time_ms on one device-bound call,
    # and a trace that holds K1's kernels and an annotate range
    from efficient_features_tpu_torch.utils import profiler as PRF
    d_k6 = torch.from_numpy(rng.integers(0, 256, (N_KP, 32),
                                         dtype=np.uint8)).to(dev)
    k6_call = lambda: TM.knn2_topk2(d_k6, None, d_k6, None)  # noqa: E731
    prof_ms, event_ms = PRF.timeit_ms(k6_call, ITERS, 3), time_ms(k6_call)
    if not abs(prof_ms / event_ms - 1.0) <= 0.2:
        fail(f"profiler.timeit_ms {prof_ms:.4f} ms against time_ms "
             f"{event_ms:.4f} ms on one K6 call")
    range_name = "chip_smoke: K1 on the 4K scene"
    k1_names = ("fast_harris_kernel", "nms_cells_kernel")
    with tempfile.TemporaryDirectory() as trace_dir:
        with PRF.trace(trace_dir):
            with PRF.annotate(range_name):
                for _ in range(20):
                    DK.fast_harris_nms_cells(img, 20, 15)
                torch.cuda.synchronize()
        traced_file, = Path(trace_dir).glob("trace-*.json")
        events = json.loads(traced_file.read_text())["traceEvents"]
    traced = {n: sum(1 for e in events if e.get("cat") == "kernel"
                     and n in e.get("name", "")) for n in k1_names}
    ranges = sum(1 for e in events if e.get("name") == range_name)
    if set(traced.values()) != {20} or not ranges:
        fail(f"profiler.trace of 20 K1 calls: K1's kernels {traced}, "
             f"annotate ranges {ranges}")
    # the trace's lead-in: kernels that ran before the first of K1's
    first_k1 = min(e["ts"] for e in events if e.get("cat") == "kernel"
                   and any(n in e.get("name", "") for n in k1_names))
    lead_in = sum(1 for e in events if e.get("cat") == "kernel"
                  and e["ts"] < first_k1)
    print(f"profiler: timeit_ms {prof_ms:.4f} ms against time_ms "
          f"{event_ms:.4f} ms on one {N_KP} x {N_KP} K6 call (within 20%); "
          f"trace of 20 K1 calls lists {traced} kernel launches and "
          f"{ranges} events of its annotate range, after {lead_in} of the "
          f"{PRF._LEAD_IN + 1} lead-in kernels [{hw}]")
    del d_k6

    stamp("eval_matching on the card")
    # -- tools/eval_matching on the five fixtures of tests/data: keypoints and
    # repeatability are the CPU port's (selection is exact); matches may
    # move where descriptor bytes do, within the budgets
    from efficient_features_tpu_torch.tools import eval_matching as EV
    eval_rows, counts = drive(
        "eval_matching", lambda: EV.evaluate_fixtures("cuda"),
        detect_kernels + blur_kernels + two_stage + desc_kernels["bad"]
        + ["knn2_topk2"],
        detect_calls=8 * len(EV.FIXTURES))
    eval_cpu = EV.evaluate_fixtures("cpu")
    eval_ref = json.loads((REPO / "tools" / "EVAL.json").read_text())["rows"]
    for key, c in eval_cpu.items():
        g, r = eval_rows[key], eval_ref[key]
        differ = [k for k in ("n_kp1", "n_kp2", "n_proj_in_bounds",
                              "repeatability") if g[k] != c[k]]
        if differ:
            fail(f"eval_matching {key}: {differ} differ from the CPU port "
                 f"(card {g}, CPU {c})")
        kind = key.rsplit(".", 1)[1].rsplit("_", 1)[0]
        budgets = [byte_budget(kind, g[k] * 32)      # 256-bit rows
                   for k in ("n_kp1", "n_kp2")]
        print(f"eval {key}: keypoints {g['n_kp1']} / {g['n_kp2']}, "
              f"repeatability {g['repeatability']}, equal to the CPU port "
              f"(tools/EVAL.json {r['repeatability']}); matches card "
              f"{g['n_matches']}, CPU {c['n_matches']}, EVAL.json "
              f"{r['n_matches']}; inlier rate card {g['inlier_rate']}, CPU "
              f"{c['inlier_rate']}, EVAL.json {r['inlier_rate']} (descriptor "
              f"budget {budgets[0]} / {budgets[1]} bytes a view: matches "
              f"may differ only where descriptor bytes do)")

    def eval_mean(rows, metric, sel):
        return float(np.mean([v[metric] for k, v in rows.items() if sel in k]))

    print("eval_matching means, card / CPU port / tools/EVAL.json: "
          + "; ".join(
              f"{metric} {sel.strip('.') or 'all'} " + " / ".join(
                  f"{eval_mean(rows, metric, sel):.4f}"
                  for rows in (eval_rows, eval_cpu, eval_ref))
              for metric, sel in (("repeatability", "."),
                                  ("inlier_rate", ".bad_256"),
                                  ("inlier_rate", ".hash_sift_256")))
          + f"; launches {counts} [{hw}]")

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
    # K12 on these matches, 512 x 40000: each kernel bit for bit its plain
    # version, and the peak allocation of one call from the draw's sets on
    gen_m = torch.Generator(device=dev)
    gen_m.manual_seed(0)
    idx_m = RS._draw_minimal_sets(ok, 512, gen_m)
    H_m = RS.solve_minimal_sets(xy1, xy2, idx_m)
    check_same("K12 solve, the main path's matches", "solve_minimal_sets",
               H_m, RS.solve_minimal_sets_ref(xy1, xy2, idx_m))
    sc_m = RS.score_homographies(H_m, xy1, xy2, ok, t2)
    check_same("K12 scores, the main path's matches", "score_homographies",
               sc_m, RS.score_homographies_ref(H_m, xy1, xy2, ok, t2))
    for what, a, b in zip(
            ("mask", "count"),
            RS.inlier_mask(H_m[int(sc_m.argmax())], xy1, xy2, ok, t2),
            RS.inlier_mask_ref(H_m[int(sc_m.argmax())], xy1, xy2, ok, t2)):
        check_same(f"K12 mask, the main path's matches, {what}",
                   "inlier_mask", a, b)
    peaks = {}
    for what, fn in (
            ("from the minimal sets on (_ransac_from_indices)",
             lambda: RS._ransac_from_indices(xy1, xy2, ok, RANSAC_THRESH,
                                             idx_m)),
            ("the whole call, the draw's (512, N) noise with it",
             lambda: RS.find_homography_ransac(xy1, xy2, ok, iters=512,
                                               thresh=RANSAC_THRESH,
                                               device="cuda"))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks[what] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"K12 on the main path's matches, 512 x {xy1.shape[0]} "
          f"({int(ok.sum())} valid): solve, scores and the best H's mask "
          f"bit-identical to the plain versions; peak allocation of one "
          f"RANSAC 512 call " + ", ".join(f"{v:.3f} MiB {k}"
                                         for k, v in peaks.items())
          + f" [{hw}]")
    if peaks["from the minimal sets on (_ransac_from_indices)"] >= 8:
        fail("K12: RANSAC allocates 8 MiB or more after its draw")
    for iters in (256, 512):
        def ransac(iters=iters):
            return RS.find_homography_ransac(xy1, xy2, ok, iters=iters,
                                             thresh=RANSAC_THRESH,
                                             device="cuda")
        r_ms = time_ms(ransac)
        r_syncs = checked_syncs(f"RANSAC {iters}", ransac)
        with plain_kernels():
            plain_r = time_ms(ransac, iters=3, warmup=1)
        print(f"time find_homography_ransac {iters} iterations, "
              f"{xy1.shape[0]} slots ({int(ok.sum())} valid): {r_ms:.3f} "
              f"ms/call through K12, {plain_r:.3f} ms/call with its plain "
              f"version, host syncs per call {r_syncs} [{hw}]")

    stamp("the async chain under sync debug mode 'error'")
    # -- detect_async -> compute_async -> knn2_ratio_match_masked ->
    # find_homography_ransac at 4K: torch raises on any host sync
    ef_chain = EfficientFeatures(nfeatures=NFEATURES, device="cuda")

    def chain():
        k1 = ef_chain.detect_async(frames_dev[1])
        k2 = ef_chain.detect_async(frames_dev[2])
        d1 = ef_chain.compute_async(frames_dev[1], k1)
        d2 = ef_chain.compute_async(frames_dev[2], k2)
        j, _, ok = TM.knn2_ratio_match_masked(d1, k1._slots["valid"], d2,
                                              k2._slots["valid"])
        src = torch.stack([k1._slots["x"], k1._slots["y"]], dim=1)
        dst = torch.stack([k2._slots["x"], k2._slots["y"]], dim=1)[j.long()]
        return (ok,) + RS.find_homography_ransac(
            src, dst, ok, iters=512, thresh=RANSAC_THRESH, device="cuda")

    want_chain = chain()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_chain = chain()
    except RuntimeError as e:
        fail(f"async chain: a host sync under sync debug mode 'error': {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(torch.equal(a, b) for a, b in zip(got_chain, want_chain)):
        fail("async chain: the call under 'error' differs from the one "
             "before it")
    got = check_geometry("async chain", int(got_chain[0].sum()),
                         int(got_chain[3]), got_chain[1].cpu().numpy(),
                         warps[2] @ np.linalg.inv(warps[1]))
    print(f"async chain frames 1 -> 2 (detect_async, compute_async, "
          f"knn2_ratio_match_masked, find_homography_ransac 512) under sync "
          f"debug mode 'error': no host sync; {got}")

    # -- K12 and K13 on the main path's own inputs: bit-exact with plain --
    for name in ransac_kernels:
        fn, ref = getattr(RS, name), getattr(RS, name + "_ref")
        for args, kwargs in recorded[name]:
            got, want = fn(*args, **kwargs), ref(*args, **kwargs)
            for a, b in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                check_same(f"K12 {name} on the main path's "
                           f"{tuple(args[0].shape)}", name, a, b)
        print(f"K12 {name} on the {len(recorded[name])} calls of the first "
              "main-path run that made any: bit-identical to its plain "
              "version" + (f" (scores of {recorded[name][0][0][0].shape[0]} "
                           f"x {recorded[name][0][0][1].shape[0]})"
                           if name == "score_homographies" else ""))
    for args, kwargs in recorded["select_cells"]:
        for what, a, b in zip(("ys", "xs", "resp", "valid"),
                              DK.select_cells(*args, **kwargs),
                              D.select_topk_cells(*args, **kwargs)):
            check_same(f"K13 on the main path's level {tuple(args[0].shape)}"
                       f" {what}", "select_cells", a, b)
    print(f"K13 on the {len(recorded['select_cells'])} levels of the first "
          "main-path call that selected any: bit-identical to its plain "
          "version")

    # -- kernel times: one main-path call's launches, replayed --------------
    times = {}
    for m, name, ref, *_ in kernels:
        calls = recorded[name]
        fn = getattr(m, name)

        def replay(f, calls=calls):
            for args, kwargs in calls:
                f(*args, **kwargs)

        plain_iters = 3 if name in ["knn2_topk2"] + ransac_kernels \
            else ITERS
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
    # torch.linalg.eigh on K12's systems: all nine eigenpairs in float32,
    # the smallest's vector among them; it reads its status back each call
    eigh_in = [a[0] for a, _ in recorded["smallest_eigvec9"]]

    def eighs():
        for a in eigh_in:
            torch.linalg.eigh(a)

    library["smallest_eigvec9"] = time_ms(eighs)
    library_call["smallest_eigvec9"] = (
        "torch.linalg.eigh on the same systems: every eigenpair in float32, "
        "and a host read of its status per call")
    print(f"time smallest_eigvec9 library call: torch.linalg.eigh on the "
          f"same {len(eigh_in)} systems: {library['smallest_eigvec9']:.3f} "
          f"ms [{hw}]")
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
    print(f"graph cache since its last clear: {G.CACHE.eager} eager calls, "
          f"{G.CACHE.captures} captures, {G.CACHE.replays} replays; fetches "
          f"{G.CACHE.packed_fetches} packed, {G.CACHE.field_fetches} field "
          f"by field")
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
