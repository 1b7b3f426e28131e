"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficient_features_tpu_torch/csrc` and
checks each against its plain PyTorch version on the card: K1 cells, K2 IC
moments, K3 BAD (at size 31 and at 64-300 px), K4 HashSIFT warp (sizes
31*1.2^k and 300 px) and K5 HashSIFT histogram (deterministic, zero patch ->
zero row).  Then it drives the port's two main paths at 2160x3840 with 40000
features, each with every launch count set to 0 just before and read just
after:
  - `EfficientFeatures.detect_and_compute` with BAD-256, BAD-512,
    HashSIFT-256 and HashSIFT-512, checked against the plain path on the
    card and against the port on the CPU;
  - standalone `compute()` (`BAD`, `HashSIFT`, 256 and 512 bits) on the
    slice's detected keypoints and on 40000 host keypoints of mixed size,
    checked against the plain path on the card.
It checks that the HashSIFT projection ignores a caller's TF32 setting, and
times the slices, compute and each kernel (a replay of one call's launches)
beside their plain versions with CUDA events.  Exits non-zero without a
result when CUDA is absent or any check fails.  The second-to-last stdout
line is a JSON object with one entry per kernel; the last is the device
summary.

Scenes: `tests/util.make_test_image` at full size holds a few hundred
corner-rich shapes, which at 2160x3840 yield only ~1.4k keypoints for 40000
slots; the slice therefore runs on the same generator's 270x480 scene tiled
8x8 (~23k keypoints), and the full-size scene is a K1 check.
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


def wrap_image() -> np.ndarray:
    """A FAST-9 arc wrapping the index-0 tap (tests/test_kernels.py's
    wrap-run test)."""
    from efficient_features_tpu_torch.utils import semantics as S
    img = np.full((48, 64), 160, np.uint8)
    for idx in list(range(12, 16)) + list(range(0, 5)):
        dy, dx = S.FAST_CIRCLE[idx]
        img[24 + dy, 32 + dx] = 100
    return img


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from util import make_test_image
    from efficient_features_tpu_torch import (BAD, EfficientFeatures,
                                              HashSIFT, _build)
    from efficient_features_tpu_torch import pipeline as P
    from efficient_features_tpu_torch.models.params import (bad_params,
                                                            hash_sift_params)
    from efficient_features_tpu_torch.ops import bad as B
    from efficient_features_tpu_torch.ops import detect as D
    from efficient_features_tpu_torch.ops import detect_kernels as DK
    from efficient_features_tpu_torch.ops import image as I
    from efficient_features_tpu_torch.ops import orientation as O
    from efficient_features_tpu_torch.ops import window_kernels as WK

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
    ]
    names = [n for _, n, *_ in kernels]
    detect_kernels = ["fast_harris_nms_cells", "ic_moments_windows"]
    desc_kernels = {"bad": ["bad_descriptors_windows"],
                    "hash_sift": ["warp_patches_windows",
                                  "hs_hist_from_patches"]}

    def plain_kernels():
        """Route the pipeline through the plain versions (this script
        only: it is the on-card reference)."""
        return patched([((m, n), ref) for m, n, ref, *_ in kernels])

    # -- main-path runs: counts set to 0 just before, read just after -------
    totals = dict.fromkeys(names, 0)
    recorded = {}    # kernel -> its calls in the first run that launched it

    def drive(label, fn, expect):
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
        for n, c in counts.items():
            totals[n] += c
            if c and n not in recorded:
                recorded[n] = calls[n]
        return out, {n: counts[n] for n in expect}

    hw = card()
    dev = torch.device("cuda")
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
    scene = np.tile(make_test_image(H // 8, W // 8, seed=2160), (8, 8))
    img = torch.from_numpy(scene).to(dev)
    blurred = I.gaussian_blur7_u8(img)
    rng = np.random.default_rng(40000)
    errs = dict.fromkeys(names, 0.0)

    # -- K1: cells kernel vs plain, bit-exact ---------------------------------
    def check_cells(name, image, radius=15):
        got = DK.fast_harris_nms_cells(image, 20, radius)
        ref = DK.fast_harris_nms_cells_ref(image, 20, radius)
        torch.cuda.synchronize()
        for label, a, b in zip(("cellmax", "cellrow", "cellcnt"), got, ref):
            if a.shape != b.shape or not torch.equal(a, b):
                bad = (a != b).nonzero()[:5].tolist() \
                    if a.shape == b.shape else "shape"
                fail(f"K1 {name} {label} differs: shapes {tuple(a.shape)} "
                     f"{tuple(b.shape)}, first cells {bad}")
        print(f"K1 {name} {tuple(image.shape)} radius {radius}: bit-exact, "
              f"{int((ref[2] > 0).sum())} live cells, "
              f"{int(ref[2].sum())} survivors")
        errs["fast_harris_nms_cells"] = max(
            [errs["fast_harris_nms_cells"]]
            + [max_abs_err(a, b) for a, b in zip(got, ref)])
        return got

    check_cells("scene", sparse)
    check_cells("dense scene", img)
    tie = torch.from_numpy(tie_image()).to(dev)
    tie_cnt = check_cells("tie", tie)[2]                  # (12, 160)
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
    check_cells("wrap", wrap)
    # radius 1 suppresses nothing, so the wrap-run corner itself must show
    if not bool(torch.isfinite(check_cells("wrap", wrap, radius=1)[0][3, 32])):
        fail("K1 missed the wrap-run corner")

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

    # -- K3: BAD, within budget, at size 31 and at 64-300 px ----------------
    kx = rng.uniform(0, W - 1, N_KP).astype(np.float32)
    ky = rng.uniform(0, H - 1, N_KP).astype(np.float32)
    kx[:8] = [0, W - 1, 0, W - 1, 0.5, W - 1.5, 14.0, 27.125]
    ky[:8] = [0, 0, H - 1, H - 1, 0.5, H - 1.5, 14.0, 27.125]
    ka = rng.uniform(0, 360, N_KP).astype(np.float32)
    ka[::97] = -1.0
    kvalid = rng.random(N_KP) < 0.95
    big = rng.uniform(64.0, 300.0, N_KP).astype(np.float32)
    big[:8] = [64.0, 300.0, 111.0, 192.5, 300.0, 64.0, 150.0, 300.0]
    for image, sizes, what in (
            (blurred, np.full(N_KP, 31.0, np.float32), "size 31"),
            (img, big, "sizes 64-300 px")):
        kp = [torch.from_numpy(a).to(dev) for a in (kx, ky, sizes, ka,
                                                    kvalid)]
        for nbits in (256, 512):
            d_got = WK.bad_descriptors_windows(image, *kp, nbits, 1.0)
            d_ref = WK.bad_descriptors_windows_ref(image, *kp, nbits, 1.0)
            ndiff = int((d_got != d_ref).sum())
            budget = byte_budget("bad", d_ref.numel())
            if ndiff > budget:
                fail(f"K3 {what} {nbits} bits: {ndiff} differing bytes > "
                     f"budget {budget}")
            errs["bad_descriptors_windows"] = max(
                errs["bad_descriptors_windows"], max_abs_err(d_got, d_ref))
            print(f"K3 {what}, {nbits} bits, {N_KP} keypoints (edges "
                  f"included): {ndiff} differing bytes (budget {budget})")
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
    print(f"K5 {N_KP} patches ({len(zero_rows)} all-zero): max |diff| {dmax},"
          f" differing share {dshare:.3e}; zero patches give zero rows; two "
          "runs bit-identical")

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

    # -- main path 1: detect_and_compute through the kernels ----------------
    selection = ("x", "y", "octave", "size", "response", "valid", "count")
    detected = None
    for dtype in ("bad_256", "bad_512", "hash_sift_256", "hash_sift_512"):
        kind = dtype.rsplit("_", 1)[0]
        ef = EfficientFeatures(nfeatures=NFEATURES, descriptor_type=dtype,
                               device="cuda")
        D.select_topk_cells.fallbacks = 0
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

        syncs = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ef.detect_and_compute_async(img)
                syncs = sum("synchroniz" in str(w.message) for w in caught)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        slice_ms = time_ms(lambda: ef.detect_and_compute_async(img))
        with plain_kernels():
            plain_slice = time_ms(lambda: ef.detect_and_compute_async(img))
        print(f"time slice {dtype} {H}x{W} nfeatures {NFEATURES}: "
              f"{slice_ms:.3f} ms/call through the kernels, "
              f"{plain_slice:.3f} ms/call plain; host syncs per call "
              f"{syncs} [{hw}]")

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
            got, counts = drive(f"compute {label} on {what}",
                                lambda: describer.compute_async(img, kin),
                                desc_kernels[kind])
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

    # -- kernel times: one main-path call's launches, replayed --------------
    times = {}
    for m, name, ref, *_ in kernels:
        calls = recorded[name]
        fn = getattr(m, name)

        def replay(f, calls=calls):
            for args, kwargs in calls:
                f(*args, **kwargs)

        times[name] = (time_ms(lambda: replay(fn)),
                       time_ms(lambda: replay(ref)))
        print(f"time {name}: {len(calls)} launches of the first main-path "
              f"call that ran it, kernel {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms [{hw}]")

    print(f"main-path launches (both paths, all runs): {totals}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "efficient_features_tpu_torch/csrc/" + source,
         "replaces": replaces, "launches": totals[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for _, name, _, source, replaces in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
