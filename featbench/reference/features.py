"""Plain PyTorch reference of multi-scale FAST + Harris detection and the
BAD and HashSIFT descriptors, written from the detector's documented
semantics.

It runs on any torch device, one frame at a time, with no kernel of the
program and nothing that the program made: the benchmark hands it the raw
frame.  Every step that feeds keypoint selection is exact integer
arithmetic or exact float32 products (resize and blur in fixed point,
FAST, the Harris response with 12- and 11-bit significands and k = 3/64,
the NMS disc in which ties co-survive, top-k by (response desc, flat index
asc)).  Angles and descriptors are float32: atan2 of integer moments,
BAD's division-free box compare, and HashSIFT (`hash_sift.py`).

`lowp`: compute the float steps (the Harris response, the angle, BAD's
affine map and compare, HashSIFT's warp, histogram, normalisation and
projection) in that dtype, bfloat16 for the benchmark's control; the
integer steps and the coordinates stay exact.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import hash_sift as HS
from . import patch as P
from . import semantics as S

NEG_INF = float("-inf")
BAD_MARGIN = 1.75
_TWO_PI = float(np.float32(2 * np.pi))
_RAD2DEG = float(np.float32(180.0 / np.pi))
_HERE = Path(__file__).resolve().parent
DESCRIPTOR_TYPES = ("bad_256", "bad_512", "hash_sift_256", "hash_sift_512")


def bad_table(nbits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """BAD's (nbits, 5) int32 box pairs [x1, x2, y1, y2, radius] and
    (nbits,) float32 thresholds."""
    if nbits not in (256, 512):
        raise ValueError(f"BAD has 256 or 512 bits, got {nbits}")
    data = json.loads((_HERE / f"bad_p{nbits}.json").read_text())
    return (torch.tensor(data["box_pairs"], dtype=torch.int32, device=device),
            torch.tensor(data["thresholds"], dtype=torch.float32,
                         device=device))


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx], `fill` outside."""
    h, w = a.shape
    out = torch.full_like(a, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        a[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def resize_u8(src: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize, half-pixel centres, 11-bit fixed point,
    one rounding shift at the end."""
    h, w = hw
    sh, sw = src.shape
    dev = src.device
    x0, x1, wx1 = (torch.from_numpy(v).to(dev)
                   for v in S.resize_axis_coeffs(w, sw))
    y0, y1, wy1 = (torch.from_numpy(v).to(dev)
                   for v in S.resize_axis_coeffs(h, sh))
    one = 1 << S.RESIZE_BITS
    a = src.to(torch.int32)
    hp = (a[:, x0.long()] * (one - wx1)[None, :]
          + a[:, x1.long()] * wx1[None, :])
    acc = (hp[y0.long(), :] * (one - wy1)[:, None]
           + hp[y1.long(), :] * wy1[:, None])
    out = (acc + (1 << (2 * S.RESIZE_BITS - 1))) >> (2 * S.RESIZE_BITS)
    return out.to(torch.uint8)


def build_pyramid(image: torch.Tensor, scale_factor: float, nlevels: int):
    """Level s resized from level s - 1."""
    shapes = S.pyramid_shapes(image.shape[0], image.shape[1], scale_factor,
                              nlevels)
    levels = [image]
    for s in range(1, nlevels):
        levels.append(resize_u8(levels[-1], shapes[s]))
    return levels


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma 2 separable Gaussian, REFLECT_101 border, 16-bit fixed
    point, a rounding shift after each pass."""
    k = [int(v) for v in S.gaussian_kernel7_fixed()]
    h, w = img.shape
    dev = img.device
    half = 1 << (S.BLUR_BITS - 1)
    yy = torch.from_numpy(S.reflect101_index(np.arange(-3, h + 3), h)).to(dev)
    xx = torch.from_numpy(S.reflect101_index(np.arange(-3, w + 3), w)).to(dev)
    a = img.to(torch.int32)[:, xx]
    hp = sum(k[i] * a[:, i:i + w] for i in range(7))
    hp = (hp + half) >> S.BLUR_BITS
    vp = hp[yy, :]
    out = sum(k[i] * vp[i:i + h, :] for i in range(7))
    return ((out + half) >> S.BLUR_BITS).to(torch.uint8)


def _any_run9(mask16: torch.Tensor) -> torch.Tensor:
    """A circular 16-bit mask holds a run of >= 9 set bits."""
    acc = mask16.clone()
    for s in range(1, S.FAST_ARC_LEN):
        acc &= ((mask16 >> s) | (mask16 << (16 - s))) & 0xFFFF
    return acc != 0


def fast_corners(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """FAST-9 corner map, False within 3 px of the edge."""
    v = img.to(torch.int32)
    brighter = torch.zeros_like(v)
    darker = torch.zeros_like(v)
    for bit, (dy, dx) in enumerate(S.FAST_CIRCLE.tolist()):
        shifted = _shift(v, dy, dx, 0)
        brighter |= (shifted > v + threshold).to(torch.int32) << bit
        darker |= (shifted < v - threshold).to(torch.int32) << bit
    corner = _any_run9(brighter) | _any_run9(darker)
    corner[:3, :] = False
    corner[-3:, :] = False
    corner[:, :3] = False
    corner[:, -3:] = False
    return corner


def _box7_sum(a: torch.Tensor) -> torch.Tensor:
    """Centred 7x7 window sums, exact in int64."""
    h, w = a.shape
    p = torch.zeros((h + 8, w + 8), dtype=torch.int64, device=a.device)
    p[4:4 + h, 4:4 + w] = a
    c = p.cumsum(0).cumsum(1)
    return (c[7:7 + h, 7:7 + w] - c[0:h, 7:7 + w]
            - c[7:7 + h, 0:w] + c[0:h, 0:w])


def _trunc_mantissa(x: torch.Tensor, drop_bits: int) -> torch.Tensor:
    return (x.view(torch.int32) & ~((1 << drop_bits) - 1)).view(torch.float32)


def harris_response(img: torch.Tensor, lowp=None) -> torch.Tensor:
    """Dense float32 Harris response: exact Sobel and 7x7 sums, then the
    det / trace arithmetic on truncated significands, every product exact."""
    a = img.to(torch.int32)

    def sh(dy, dx):
        return _shift(a, dy, dx, 0)
    dx = (sh(1, 1) + 2 * sh(0, 1) + sh(-1, 1)) - \
        (sh(1, -1) + 2 * sh(0, -1) + sh(-1, -1))
    dy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)) - \
        (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    s2 = float(np.float32(S.HARRIS_SCALE) * np.float32(S.HARRIS_SCALE))
    sums = [s2 * _box7_sum(p.to(torch.int64)).to(torch.float32)
            for p in (dx * dx, dx * dy, dy * dy)]
    k = float(np.float32(S.HARRIS_K))
    if lowp is not None:
        sxx, sxy, syy = (v.to(lowp) for v in sums)
        tr = sxx + syy
        return (sxx * syy - sxy * sxy - k * (tr * tr)).to(torch.float32)
    sxx, sxy, syy = (_trunc_mantissa(v, 12) for v in sums)
    tr = _trunc_mantissa(sxx + syy, 13)
    det = sxx * syy - sxy * sxy
    return det - k * (tr * tr)


def nms_survivors(resp: torch.Tensor, corner: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """corner & (resp >= every response of a corner in the open disc):
    ties co-survive."""
    masked = torch.where(corner, resp, torch.full_like(resp, NEG_INF))
    rows = {}
    disc_max = torch.full_like(masked, NEG_INF)
    for dy, wdx in S.disc_row_extents(radius):
        if wdx not in rows:
            rows[wdx] = F.max_pool2d(masked[None, None], (1, 2 * wdx + 1),
                                     stride=1, padding=(0, wdx))[0, 0]
        disc_max = torch.maximum(disc_max, _shift(rows[wdx], dy, 0, NEG_INF))
    return corner & (masked >= disc_max)


def select_topk(resp: torch.Tensor, survivor: torch.Tensor, quota: int):
    """(ys, xs, response) of up to `quota` survivors by (response desc,
    flat index asc)."""
    ys, xs = torch.nonzero(survivor, as_tuple=True)      # flat index order
    r = resp[ys, xs]
    # + 0.0 makes -0.0 equal +0.0 for the sort, as it is for a compare
    order = torch.sort(r + 0.0, descending=True, stable=True).indices[:quota]
    return ys[order], xs[order], r[order]


def ic_angles(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              lowp=None) -> torch.Tensor:
    """Intensity-centroid angles in degrees, [0, 360): exact integer
    moments over the 31 px circular patch, then atan2."""
    dev = img.device
    ody, odx = (torch.from_numpy(v).to(dev) for v in S.ic_offsets())
    if ys.numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    w = img.shape[1]
    flat = (ys[:, None] + ody[None, :]) * w + xs[:, None] + odx[None, :]
    vals = img.reshape(-1)[flat.long()].to(torch.int32)
    m10 = (vals * odx[None, :]).sum(1, dtype=torch.int32)
    m01 = (vals * ody[None, :]).sum(1, dtype=torch.int32)
    dt = torch.float32 if lowp is None else lowp
    ang = torch.atan2(m01.to(dt), m10.to(dt))
    ang = torch.where(ang < 0, ang + _TWO_PI, ang)
    return (_RAD2DEG * ang).to(torch.float32)


def integral_i32(img: torch.Tensor) -> torch.Tensor:
    """(H + 1, W + 1) int32 integral image with a zero top row and left
    column, wrapping modulo 2^32."""
    h, w = img.shape
    out = torch.zeros((h + 1, w + 1), dtype=torch.int64, device=img.device)
    out[1:, 1:] = img.to(torch.int64).cumsum(0).cumsum(1)
    return (out & 0xFFFFFFFF).to(torch.int32)


def bad(image: torch.Tensor, x, y, size, angle, nbits: int,
        lowp=None) -> torch.Tensor:
    """(N, nbits // 8) uint8 BAD descriptors of keypoints (x, y, size,
    angle in degrees; angle < 0: no rotation) on `image`, scale factor 1.

    The affine map of the patch's 32 x 32 frame, box centres rounded by
    trunc(v + 0.5), box sums from the integral image; a bit is
    mean1 - mean2 <= threshold, compared without a division: near the
    border on clamped boxes by s1 a2 - s2 a1 <= th a1 a2 (exact int64
    products while a1 a2 < 2^22, else 12-bit significands), inside by the
    unnormalised difference against th * side^2."""
    boxes, th = bad_table(nbits, image.device)
    ii = integral_i32(image)
    fh, fw = ii.shape
    img_h, img_w = fh - 1, fw - 1
    dt = torch.float32 if lowp is None else lowp
    x, y, size, angle = (v.to(dt)[:, None] for v in (x, y, size, angle))
    th = th.to(dt)[None, :]
    bx1, bx2, by1, by2, br = (boxes[:, i].to(dt)[None, :] for i in range(5))

    m00, m01, m02, m10, m11, m12, s = P.affine(x, y, size, angle)

    def rnd(v):
        return torch.trunc(v + 0.5).to(torch.int64)
    tx1 = rnd(m00 * bx1 + m01 * by1 + m02)
    ty1 = rnd(m10 * bx1 + m11 * by1 + m12)
    tx2 = rnd(m00 * bx2 + m01 * by2 + m02)
    ty2 = rnd(m10 * bx2 + m11 * by2 + m12)
    tbr = rnd(s * br)
    flat = ii.reshape(-1)

    def at(iy, ix):
        return flat[iy * fw + ix]

    def box_clamped(cx, cy, r):
        x1 = (cx - r).clamp(0, fw - 2)
        y1 = (cy - r).clamp(0, fh - 2)
        x2 = (cx + r + 1).clamp(1, fw - 1)
        y2 = (cy + r + 1).clamp(1, fh - 1)
        ssum = (at(y1, x1) + at(y2, x2) - at(y1, x2) - at(y2, x1))
        return ssum.to(torch.int64), (y2 - y1) * (x2 - x1)

    def box_fast(cx, cy, r):
        x1 = (cx - r).clamp(0, fw - 1)
        y1 = (cy - r).clamp(0, fh - 1)
        x2 = (cx + r + 1).clamp(0, fw - 1)
        y2 = (cy + r + 1).clamp(0, fh - 1)
        return at(y1, x1) + at(y2, x2) - at(y1, x2) - at(y2, x1)

    s1, a1 = box_clamped(tx1, ty1, tbr)
    s2, a2 = box_clamped(tx2, ty2, tbr)
    a1f, a2f = a1.to(torch.float32), a2.to(torch.float32)
    safe = a1f * a2f < float(1 << 22)
    bit_i = (s1 * a2 - s2 * a1).to(dt) <= th * (a1 * a2).to(dt)
    if lowp is None:
        s1t, s2t, a1t, a2t = (_trunc_mantissa(v.to(torch.float32), 12)
                              for v in (s1, s2, a1, a2))
    else:
        s1t, s2t, a1t, a2t = (v.to(dt) for v in (s1, s2, a1, a2))
    bit_t = (s1t * a2t - s2t * a1t) <= th * (a1t * a2t)
    bit_border = torch.where(safe, bit_i, bit_t)
    side = 1 + 2 * tbr
    diff = box_fast(tx1, ty1, tbr) - box_fast(tx2, ty2, tbr)
    bit_fast = diff.to(dt) <= th * (side * side).to(dt)

    sb = 1.0 * size / 64.0
    bw = 32.0 * sb * BAD_MARGIN
    in_border = (x < bw) | (x + bw >= float(img_w)) | (y < bw) | \
        (y + bw >= float(img_h))
    return P.pack_msb(torch.where(in_border, bit_border, bit_fast))


def describer(descriptor_type: str):
    """describe(image, x, y, size, angle, lowp=None) of one of
    `DESCRIPTOR_TYPES`."""
    if descriptor_type not in DESCRIPTOR_TYPES:
        raise ValueError(f"descriptor_type must be one of "
                         f"{DESCRIPTOR_TYPES}, got {descriptor_type!r}")
    kind, bits = descriptor_type.rsplit("_", 1)
    return functools.partial(bad if kind == "bad" else HS.hash_sift,
                             nbits=int(bits))


def detect_and_describe(image: torch.Tensor, cfg: dict, lowp=None) -> dict:
    """Keypoints and descriptors of one u8 frame under the detector
    settings `cfg` (nfeatures, scale_factor, nlevels, first_level,
    fast_threshold, nonmax_radius, descriptor_type: one of
    `DESCRIPTOR_TYPES`, BAD-256 if absent).  Both descriptors sample the
    level blurred by the 7 x 7 Gaussian, at keypoints (x, y, size 31,
    angle) in level coordinates.

    Returns host numpy arrays in level-major order, each level's keypoints
    by (response desc, index asc): x, y (image coordinates, trunc(scale * v
    + 0.5)), response, angle, octave, desc (N, nbits / 8), and the
    per-level counts that the roofline reads: pixels, searched (the pixels
    of levels large enough to search), corners (FAST corners inside the 15
    px border), survivors (after the NMS) and kept (slots filled)."""
    describe = describer(cfg.get("descriptor_type", "bad_256"))
    sf, nl = cfg["scale_factor"], cfg["nlevels"]
    levels = build_pyramid(image, sf, nl)
    scales = S.pyramid_scales(sf, nl)
    quotas = S.features_per_level(cfg["nfeatures"], sf, nl)
    b = S.HALF_PATCH_SIZE
    out = {k: [] for k in ("x", "y", "response", "angle", "octave", "desc")}
    counts = {k: [] for k in ("pixels", "searched", "corners", "survivors",
                              "kept")}
    for s in range(cfg.get("first_level", 0), nl):
        img = levels[s]
        h, w = img.shape
        counts["pixels"].append(h * w)
        if not (h > 2 * b and w > 2 * b):
            for k in ("searched", "corners", "survivors", "kept"):
                counts[k].append(0)
            continue
        counts["searched"].append(h * w)
        border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        border[b:h - b, b:w - b] = True
        corner = fast_corners(img, cfg["fast_threshold"]) & border
        resp = harris_response(img, lowp)
        surv = nms_survivors(resp, corner, cfg["nonmax_radius"])
        ys, xs, r = select_topk(resp, surv, min(quotas[s], h * w))
        ang = ic_angles(img, ys, xs, lowp)
        desc = describe(gaussian_blur7_u8(img), xs.to(torch.float32),
                        ys.to(torch.float32),
                        torch.full(xs.shape, float(S.PATCH_SIZE),
                                   device=img.device), ang, lowp=lowp)
        sc = float(scales[s])
        out["x"].append(torch.trunc(sc * xs.to(torch.float32) + 0.5))
        out["y"].append(torch.trunc(sc * ys.to(torch.float32) + 0.5))
        out["response"].append(r)
        out["angle"].append(ang)
        out["octave"].append(torch.full(xs.shape, s, dtype=torch.int32,
                                        device=img.device))
        out["desc"].append(desc)
        counts["corners"].append(int(corner.sum()))
        counts["survivors"].append(int(surv.sum()))
        counts["kept"].append(int(ys.numel()))
    res = {k: torch.cat(v).cpu().numpy() if v else np.zeros(0)
           for k, v in out.items()}
    res.update(counts)
    res["hw"] = tuple(image.shape)
    return res


def angle_gap_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Circular |a - b| in degrees."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)) % 360.0
    return np.minimum(d, 360.0 - d)

