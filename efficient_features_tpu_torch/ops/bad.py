"""BAD descriptor (cuda_bad.cu:121-348) over an integral image.

Port of `efficient_features_tpu/ops/bad.py`: an (N, nbits) computation with
the affine transforms as broadcast arithmetic, the integral-image reads as
gathers and MSB-first bit packing.  `bad_descriptors` is the plain version of
the BAD kernel (K3).  Every float step is a single IEEE operation in the same
order as the JAX version; nothing here may be fused into an FMA.

`window_plan` is the window of the image from which K3 sums a keypoint's
boxes (csrc/bad_descriptors.cu computes the same), and `window_box` a box's
corners in that window.

`origin` / `frame_hw` (as the JAX package's): the image may hold only rows
and columns from `origin` (oy, ox) on of a `frame_hw` frame, as a band of a
row-sharded image does; keypoints stay in frame coordinates, box corners
are rounded there, and the border test and the border boxes' clamps use the
frame.  The defaults are the whole image.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.params import bad_params

DEG2RAD = float(np.float32(0.017453292519943295))
MARGIN = 1.75
PATCH_W = PATCH_H = 32

# K3's window, as csrc/bad_descriptors.cu has them.  BAD_SUPPORT bounds, per
# unit of the affine scale s, |box centre - 16| + box radius over both
# tables (22.2132; the JAX package's _BAD_SUPPORT).
BAD_SUPPORT = 22.2133
WINDOW_CAP = 59 * 59      # int32 entries of one warp's window integral
WINDOW_MAX_W = 64         # window columns of the shared-memory branch
COORD_CAP = float(1 << 24)
SUPPORT_CAP = float(1 << 20)


class WindowPlan(NamedTuple):
    """Per keypoint (int32, bool): the window is image rows [y0, y0 + h)
    and columns [x0, x0 + w), clipped to the image; `sup` its half-width
    before clipping; `in_smem` whether K3 builds its integral in shared
    memory (else it reads the whole image's integral, which it then builds
    itself)."""
    y0: torch.Tensor
    x0: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    sup: torch.Tensor
    in_smem: torch.Tensor


def window_plan(x, y, s, img_h: int, img_w: int, origin=(0, 0),
                frame_hw=None) -> WindowPlan:
    """K3's window of each keypoint (x, y) at affine scale s (float32), in
    image rows and columns (`origin`, `frame_hw` as for `bad_descriptors`).

    Every box of the keypoint lies within sup = ceil(BAD_SUPPORT * s) + 3
    px of (floor(x), floor(y)): the 3 px cover the rounding of the box
    centre (trunc(v + 0.5) is up to 1.5 above v for negative v) and of the
    radius, and the exclusive corner.  The window reaches, in frame rows,
    from min(floor - sup, frame_h - 1) to max(floor + sup + 2, 1) (the edge
    row onto which a box wholly outside the frame is clamped), clipped to
    the image: so it holds the part of every box inside the image, and of
    every box clamped to the frame."""
    fh, fw = (img_h, img_w) if frame_hw is None else frame_hw
    oy, ox = origin
    sup = torch.clamp(torch.ceil(s.clamp(min=0.0) * np.float32(BAD_SUPPORT)),
                      max=SUPPORT_CAP).to(torch.int32) + 3
    fy = torch.floor(y.clamp(-COORD_CAP, COORD_CAP)).to(torch.int32)
    fx = torch.floor(x.clamp(-COORD_CAP, COORD_CAP)).to(torch.int32)
    y0 = ((fy - sup).clamp(max=fh - 1) - oy).clamp(0, img_h - 1)
    x0 = ((fx - sup).clamp(max=fw - 1) - ox).clamp(0, img_w - 1)
    h = ((fy + sup + 2).clamp(min=1) - oy).clamp(1, img_h) - y0
    w = ((fx + sup + 2).clamp(min=1) - ox).clamp(1, img_w) - x0
    in_smem = (w <= WINDOW_MAX_W) & ((h + 1) * (w + 1) <= WINDOW_CAP)
    return WindowPlan(y0, x0, h, w, sup, in_smem)


def window_box(plan: WindowPlan, y1, x1, y2, x2):
    """A box's corners (image coordinates, exclusive y2, x2) in the
    window's integral, clamped to it: the box's part inside the window."""
    def at(v, o, n):
        return torch.minimum(torch.clamp(v - o, min=0), n)
    return (at(y1, plan.y0, plan.h), at(x1, plan.x0, plan.w),
            at(y2, plan.y0, plan.h), at(x2, plan.x0, plan.w))


def affine_trig(size, angle, scale_factor):
    """Per-keypoint (s, cos, sin) of the patch->image affine; angle < 0
    means no rotation."""
    s = float(np.float32(scale_factor)) * size / 32.0
    has = angle >= 0
    theta = angle * DEG2RAD
    cost = torch.where(has, torch.cos(theta), torch.ones_like(theta))
    sint = torch.where(has, torch.sin(theta), torch.zeros_like(theta))
    return s, cost, sint


def affine_rows(x, y, size, angle, scale_factor, pw=PATCH_W, ph=PATCH_H):
    """Patch->image affine rows (float32)."""
    s, cost, sint = affine_trig(size, angle, scale_factor)
    m00 = s * cost
    m01 = -s * sint
    m02 = (-s * cost + s * sint) * float(pw * 0.5) + x
    m10 = s * sint
    m11 = s * cost
    m12 = (-s * sint - s * cost) * float(ph * 0.5) + y
    return m00, m01, m02, m10, m11, m12, s


@functools.lru_cache(maxsize=None)
def _msb_weights(device: torch.device) -> torch.Tensor:
    # cached: a fresh host-to-GPU copy per call would cost a host sync
    return torch.tensor([1 << (7 - i) for i in range(8)], dtype=torch.int32,
                        device=device)


def pack_bits_msb(bits: torch.Tensor) -> torch.Tensor:
    """(N, nbits) {0,1} int32 or bool -> (N, nbits//8) uint8, MSB-first."""
    n, nbits = bits.shape
    b = bits.reshape(n, nbits // 8, 8).to(torch.int32)
    weights = _msb_weights(bits.device)
    return (b * weights).sum(dim=2, dtype=torch.int32).to(torch.uint8)


def _round_num(v: torch.Tensor) -> torch.Tensor:
    """CV_ROUNDNUM: trunc(v + 0.5) (cuda_bad.cu:52)."""
    return torch.trunc(v + 0.5).to(torch.int32)


def _trunc12(v: torch.Tensor) -> torch.Tensor:
    """Zero the low 12 mantissa bits: products of two such values carry
    <= 24 significant bits and are exact in f32."""
    return (v.view(torch.int32) & ~0xFFF).view(torch.float32)


def box_centres(x, y, size, angle, params, scale_factor: float = 1.0):
    """(cx1, cy1, cx2, cy2, r) int32, each (N, nbits): the centres and the
    radius of the box pair of every (keypoint, bit), in image coordinates."""
    m00, m01, m02, m10, m11, m12, s = affine_rows(
        x[:, None], y[:, None], size[:, None], angle[:, None], scale_factor)
    bx1, bx2, by1, by2, br = (params.boxes[i][None, :] for i in range(5))
    tx1 = _round_num(m00 * bx1 + m01 * by1 + m02)
    ty1 = _round_num(m10 * bx1 + m11 * by1 + m12)
    tx2 = _round_num(m00 * bx2 + m01 * by2 + m02)
    ty2 = _round_num(m10 * bx2 + m11 * by2 + m12)
    tbr = _round_num(s * br)
    return tx1, ty1, tx2, ty2, tbr


def integral_boxes(integral: torch.Tensor):
    """Box sums (y1, x1, y2, x2) -> int32 from an (H+1, W+1) int32 integral,
    corners clamped to it; the sums wrap modulo 2^32 like the integral."""
    fh, fw = integral.shape
    flat = integral.reshape(-1)

    def gather(iy, ix):
        return flat[(iy.clamp(0, fh - 1) * fw + ix.clamp(0, fw - 1)).long()]

    def box(y1, x1, y2, x2):
        return (gather(y1, x1) + gather(y2, x2)
                - gather(y1, x2) - gather(y2, x1))
    return box


def bad_descriptors(integral: torch.Tensor, x, y, size, angle, valid, *,
                    nbits: int = 256, scale_factor: float = 1.0,
                    origin=(0, 0), frame_hw=None) -> torch.Tensor:
    """(N, nbits//8) uint8 descriptors from an (H+1, W+1) int32 integral of
    the image, which holds the rows and columns from `origin` on of a
    `frame_hw` frame (default: the whole frame).

    Invalid slots give zero rows."""
    fh, fw = integral.shape
    if frame_hw is None:
        frame_hw = (fh - 1, fw - 1)
    return bad_descriptors_from_boxes(integral_boxes(integral), *frame_hw,
                                      x, y, size, angle, valid,
                                      nbits=nbits, scale_factor=scale_factor,
                                      origin=origin)


def bad_descriptors_from_boxes(box, img_h: int, img_w: int, x, y, size,
                               angle, valid, *, nbits: int = 256,
                               scale_factor: float = 1.0,
                               origin=(0, 0)) -> torch.Tensor:
    """`bad_descriptors` with the box sums from `box(y1, x1, y2, x2)`, which
    must give the sum of the image, zero outside it, over the box (exact
    int32 or wrapping alike).  img_h, img_w: the frame; `box` takes corners
    in image coordinates, frame coordinates less `origin`."""
    params = bad_params(nbits, str(x.device))
    tx1, ty1, tx2, ty2, tbr = box_centres(x, y, size, angle, params,
                                          scale_factor)
    th = params.thresholds[None, :]
    x = x[:, None]
    y = y[:, None]
    oy, ox = origin

    def box_sum_clamped(cx, cy, r):
        x1 = (cx - r).clamp(0, img_w - 1)
        y1 = (cy - r).clamp(0, img_h - 1)
        x2 = (cx + r + 1).clamp(1, img_w)
        y2 = (cy + r + 1).clamp(1, img_h)
        return box(y1 - oy, x1 - ox, y2 - oy, x2 - ox), (y2 - y1) * (x2 - x1)

    def box_sum_fast(cx, cy, r):
        # interior path: a box's part outside the image (only at tiny s)
        # counts 0
        return box(cy - r - oy, cx - r - ox, cy + r + 1 - oy, cx + r + 1 - ox)

    # division-free border compare s1*a2 - s2*a1 <= th*a1*a2: exact int32
    # products while a1*a2 < 2^22, else 12-significant-bit operands whose
    # f32 products are exact
    s1b, a1b = box_sum_clamped(tx1, ty1, tbr)
    s2b, a2b = box_sum_clamped(tx2, ty2, tbr)
    a1f = a1b.to(torch.float32)
    a2f = a2b.to(torch.float32)
    safe = a1f * a2f < float(1 << 22)
    lhs_i = (s1b * a2b - s2b * a1b).to(torch.float32)
    rhs_i = th * (a1b * a2b).to(torch.float32)
    s1t = _trunc12(s1b.to(torch.float32))
    s2t = _trunc12(s2b.to(torch.float32))
    a1t = _trunc12(a1f)
    a2t = _trunc12(a2f)
    lhs_t = s1t * a2t - s2t * a1t
    rhs_t = th * (a1t * a2t)
    bit_border = torch.where(safe, lhs_i <= rhs_i, lhs_t <= rhs_t)

    side = 1 + 2 * tbr
    area_resp = box_sum_fast(tx1, ty1, tbr) - box_sum_fast(tx2, ty2, tbr)
    bit_fast = (area_resp.to(torch.float32)
                <= th * (side * side).to(torch.float32))

    sb = float(np.float32(scale_factor)) * size[:, None] / 64.0
    bw = 32.0 * sb * MARGIN
    in_border = ((x < bw) | (x + bw >= float(img_w)) |
                 (y < bw) | (y + bw >= float(img_h)))

    bits = torch.where(in_border, bit_border, bit_fast)
    bits = bits & valid[:, None]
    return pack_bits_msb(bits)
