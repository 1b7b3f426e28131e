"""BAD descriptor (cuda_bad.cu:121-348) over an integral image.

Port of `efficient_features_tpu/ops/bad.py`: an (N, nbits) computation with
the affine transforms as broadcast arithmetic, the integral-image reads as
gathers and MSB-first bit packing.  `bad_descriptors` is the plain version of
the BAD kernel (K3).  Every float step is a single IEEE operation in the same
order as the JAX version; nothing here may be fused into an FMA.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.params import bad_params

DEG2RAD = float(np.float32(0.017453292519943295))
MARGIN = 1.75
PATCH_W = PATCH_H = 32


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


def bad_descriptors(integral: torch.Tensor, x, y, size, angle, valid, *,
                    nbits: int = 256, scale_factor: float = 1.0
                    ) -> torch.Tensor:
    """(N, nbits//8) uint8 descriptors from an (H+1, W+1) int32 integral.

    Invalid slots give zero rows."""
    params = bad_params(nbits, str(integral.device))
    fh, fw = integral.shape
    img_h, img_w = fh - 1, fw - 1
    flat = integral.reshape(-1)

    x = x[:, None]
    y = y[:, None]
    m00, m01, m02, m10, m11, m12, s = affine_rows(
        x, y, size[:, None], angle[:, None], scale_factor)
    bx1, bx2, by1, by2, br = (params.boxes[i][None, :] for i in range(5))
    th = params.thresholds[None, :]

    tx1 = _round_num(m00 * bx1 + m01 * by1 + m02)
    ty1 = _round_num(m10 * bx1 + m11 * by1 + m12)
    tx2 = _round_num(m00 * bx2 + m01 * by2 + m02)
    ty2 = _round_num(m10 * bx2 + m11 * by2 + m12)
    tbr = _round_num(s * br)

    def gather(iy, ix):
        return flat[(iy.clamp(0, fh - 1) * fw + ix.clamp(0, fw - 1)).long()]

    def box_sum_clamped(cx, cy, r):
        x1 = (cx - r).clamp(0, img_w - 1)
        y1 = (cy - r).clamp(0, img_h - 1)
        x2 = (cx + r + 1).clamp(1, img_w)
        y2 = (cy + r + 1).clamp(1, img_h)
        ssum = (gather(y1, x1) + gather(y2, x2)
                - gather(y1, x2) - gather(y2, x1))
        return ssum, (y2 - y1) * (x2 - x1)

    def box_sum_fast(cx, cy, r):
        # interior path; the clamps are for memory safety only (the 1.75
        # margin keeps these reads in bounds)
        return (gather(cy - r, cx - r) + gather(cy + r + 1, cx + r + 1)
                - gather(cy - r, cx + r + 1) - gather(cy + r + 1, cx - r))

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
