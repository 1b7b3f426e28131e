"""Constants and host arithmetic of the detector's documented semantics.

A frozen copy, for the benchmark's reference, of what the detector defines
in exact arithmetic (FAST circle, Harris constants, fixed-point resize and
blur, pyramid sizes and per-level quotas, the NMS disc, the IC patch).  It
is copied so that a later change to the program cannot move the yardstick.
"""
from __future__ import annotations

import numpy as np

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
HARRIS_BLOCK_SIZE = 7
# dyadic 3/64, so that k * tr^2 is exact in float32
HARRIS_K = 3.0 / 64.0
HARRIS_SCALE = 1.0 / (4 * HARRIS_BLOCK_SIZE * 255)

# IC-angle circular patch extents per |dy|
U_MAX = np.array([15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6,
                  3, 0], dtype=np.int32)

# FAST-9 Bresenham circle in circular bit order, (dy, dx)
FAST_CIRCLE = np.array([
    (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2), (3, -1),
], dtype=np.int32)
FAST_ARC_LEN = 9

RESIZE_BITS = 11
BLUR_BITS = 16


def cv_round(x: float) -> int:
    """Round half to even, as OpenCV's cvRound."""
    return int(np.rint(x))


def pyramid_scales(scale_factor: float, nlevels: int) -> list:
    """Cumulative float32 level scales."""
    scales = [np.float32(1.0)]
    s = np.float32(1.0)
    for _ in range(1, nlevels):
        s = np.float32(s * np.float32(scale_factor))
        scales.append(s)
    return scales


def pyramid_shapes(h: int, w: int, scale_factor: float, nlevels: int):
    """(h, w) of each level: cvRound(dim / scale) in float32."""
    shapes = [(h, w)]
    for s in pyramid_scales(scale_factor, nlevels)[1:]:
        inv = np.float32(1.0) / s
        shapes.append((cv_round(np.float32(inv * np.float32(h))),
                       cv_round(np.float32(inv * np.float32(w)))))
    return shapes


def features_per_level(total: int, scale_factor: float, nlevels: int):
    """ORB's geometric split of the feature budget over the levels."""
    factor = 1.0 / scale_factor
    n = total * (1 - factor) / (1 - factor ** nlevels)
    quotas, acc = [], 0
    for _ in range(nlevels - 1):
        q = cv_round(n)
        quotas.append(q)
        acc += q
        n *= factor
    quotas.append(max(total - acc, 0))
    return quotas


def gaussian_kernel7_fixed() -> np.ndarray:
    """7-tap sigma=2 Gaussian in BLUR_BITS fixed point, summing to 2^16."""
    i = np.arange(7, dtype=np.float64) - 3
    k = np.exp(-(i * i) / (2.0 * 2.0 * 2.0))
    k /= k.sum()
    q = np.round(k * (1 << BLUR_BITS)).astype(np.int64)
    q[3] += (1 << BLUR_BITS) - q.sum()
    return q.astype(np.int32)


def resize_axis_coeffs(dst_n: int, src_n: int):
    """Half-pixel-centre bilinear taps of one axis: (i0, i1, w1q), w1q the
    weight of i1 in RESIZE_BITS fixed point."""
    x = (np.arange(dst_n, dtype=np.float64) + 0.5) * (src_n / dst_n) - 0.5
    i0 = np.floor(x).astype(np.int64)
    f = x - i0
    w1 = np.clip(np.round(f * (1 << RESIZE_BITS)), 0,
                 1 << RESIZE_BITS).astype(np.int32)
    i1 = np.clip(i0 + 1, 0, src_n - 1).astype(np.int32)
    i0 = np.clip(i0, 0, src_n - 1).astype(np.int32)
    return i0, i1, w1


def reflect101_index(idx: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101: -1 -> 1, n -> n - 2."""
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def disc_row_extents(radius: int) -> list:
    """[(dy, wdx)]: the NMS disc (squared distance < ceil(radius^2)) as rows
    dx in [-wdx, wdx]."""
    r2 = int(np.ceil(radius * radius))
    rows = []
    for dy in range(-radius, radius + 1):
        m = r2 - 1 - dy * dy
        if m < 0:
            continue
        rows.append((dy, int(np.floor(np.sqrt(m)))))
    return rows


def disc_pixels(radius: int) -> int:
    """Pixels of the NMS disc, its centre included."""
    return sum(2 * wdx + 1 for _, wdx in disc_row_extents(radius))


def ic_offsets():
    """(dy, dx) int32 arrays of the 31 px circular IC patch."""
    offs = [(dy, dx) for dy in range(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1)
            for dx in range(-int(U_MAX[abs(dy)]), int(U_MAX[abs(dy)]) + 1)]
    o = np.array(offs, dtype=np.int32)
    return o[:, 0], o[:, 1]
