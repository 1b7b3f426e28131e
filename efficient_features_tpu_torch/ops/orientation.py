"""IC-angle orientation (cuda_efficient_features.cu:141-172).

Port of `efficient_features_tpu/ops/orientation.py`: a gather over the
circular 31x31 patch.  The integer moments are exact; the final atan2 is
float32, whose last-ULP differences between backends the descriptor budgets
absorb.  `ic_angles` is `angles_from_moments` after `ic_moments`, the plain
version of the IC kernel (K2), which on a card writes the angle itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import semantics as S


def _offsets():
    offs = []
    for dy in range(-S.HALF_PATCH_SIZE, S.HALF_PATCH_SIZE + 1):
        d = int(S.U_MAX[abs(dy)])
        for dx in range(-d, d + 1):
            offs.append((dy, dx))
    o = np.array(offs, dtype=np.int32)
    return o[:, 0], o[:, 1]


_IC_DY, _IC_DX = _offsets()

_TWO_PI = float(np.float32(2 * np.pi))
_RAD2DEG = float(np.float32(180.0 / np.pi))


def ic_moments(img: torch.Tensor, ys: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """(N, 2) int32 [m01, m10] over the U_MAX disc; reads clamp to the image
    (detector keypoints lie >= 15 px inside, so the clamp never binds for
    them)."""
    h, w = img.shape
    dy = torch.from_numpy(_IC_DY).to(img.device)
    dx = torch.from_numpy(_IC_DX).to(img.device)
    gy = (ys.to(torch.int32)[:, None] + dy[None, :]).clamp(0, h - 1)
    gx = (xs.to(torch.int32)[:, None] + dx[None, :]).clamp(0, w - 1)
    vals = img.reshape(-1)[(gy * w + gx).long()].to(torch.int32)
    m10 = (vals * dx[None, :]).sum(dim=1, dtype=torch.int32)
    m01 = (vals * dy[None, :]).sum(dim=1, dtype=torch.int32)
    return torch.stack([m01, m10], dim=1)


def angles_from_moments(moments: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Degrees in [0, 360) from (N, 2) [m01, m10] moments; 0 where invalid."""
    m = moments.to(torch.float32)
    ang = torch.atan2(m[:, 0], m[:, 1])
    ang = torch.where(ang < 0, ang + _TWO_PI, ang)
    deg = _RAD2DEG * ang
    return torch.where(valid, deg, torch.zeros_like(deg))



def ic_angles(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Angles in degrees [0, 360) for (quota,) keypoint slots, by the gather
    above.  Invalid slots read from clamped indices and return 0; valid
    detector keypoints lie >= 15 px from the borders, so the clamp never
    binds for them.  (The IC kernel K2, `window_kernels.ic_angles_windows`,
    computes the same on a card.)"""
    return angles_from_moments(ic_moments(img, ys, xs), valid)
