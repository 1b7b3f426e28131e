"""The keypoint's patch frame that BAD and HashSIFT share: the affine map
of the 32 x 32 patch onto the image, and the descriptor bits packed most
significant first."""
from __future__ import annotations

import numpy as np
import torch

DEG2RAD = float(np.float32(0.017453292519943295))


def affine(x, y, size, angle):
    """(m00, m01, m02, m10, m11, m12, s) of keypoints (x, y, size, angle
    in degrees; angle < 0: no rotation) at scale factor 1: image point
    (m00 px + m01 py + m02, m10 px + m11 py + m12) of patch point (px,
    py), s = size / 32, in the dtype of the arguments."""
    s = 1.0 * size / 32.0
    theta = angle * DEG2RAD
    has = angle >= 0
    cost = torch.where(has, torch.cos(theta), torch.ones_like(theta))
    sint = torch.where(has, torch.sin(theta), torch.zeros_like(theta))
    m00, m01 = s * cost, -s * sint
    m02 = (-s * cost + s * sint) * 16.0 + x
    m10, m11 = s * sint, s * cost
    m12 = (-s * sint - s * cost) * 16.0 + y
    return m00, m01, m02, m10, m11, m12, s


def pack_msb(bits: torch.Tensor) -> torch.Tensor:
    """(N, nbits) bool -> (N, nbits // 8) uint8, bit 0 the most significant
    of byte 0."""
    n, nbits = bits.shape
    wts = torch.tensor([1 << (7 - i) for i in range(8)], dtype=torch.int32,
                       device=bits.device)
    return (bits.reshape(n, nbits // 8, 8).to(torch.int32) * wts).sum(
        2).to(torch.uint8)
