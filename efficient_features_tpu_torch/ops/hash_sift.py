"""HashSIFT descriptor (cuda_hash_sift.cu / cuda_hash_sift.cpp) in PyTorch.

Port of `efficient_features_tpu/ops/hash_sift.py`: a 32x32 bilinear patch
under the keypoint affine, a SIFT histogram over its 30x30 interior (4x4
spatial x 8 orientation bins, trilinear votes, Gaussian weighting), the
two-pass L2 normalise / clip / quantise, and the learned (nbits, 129)
projection whose signs are the descriptor bits.

`warp_patches` is the plain version of the warp kernel (K4) and
`patch_sift_responses` that of the histogram kernel (K5).  The histogram is
nine (N, 900) @ (900, 16) products against the keypoint-independent spatial
weights of the 4x4 core bins, as in the JAX package.  Every float step is a
single IEEE operation in the JAX version's order; products that feed a sign
or a quantisation run in full f32 (`full_f32_matmul`), never TF32.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.params import load_hash_sift_matrix
from .bad import affine_rows, pack_bits_msb

PATCH_W = PATCH_H = 32
R_BINS = C_BINS = 4
ORI_BINS = 8
MAGNITUDE_TH = np.float32(0.2)
INT_DESCR_FACTOR = np.float32(512.0)
KEYPOINT_SCALE = 1.0 / 6.0
SIFT_DESCR_SCL_FCTR = 3.0
# orientation bins per radian, rounded to f32 once (the kernel takes it too)
ORI_SCALE = float(np.float32(ORI_BINS / (2 * np.pi)))
EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=None)
def _spatial_weight_matrix() -> np.ndarray:
    """Constant (900, 36) matrix: interior pixel -> (r6, c6) trilinear
    spatial weights including the Gaussian magnitude scale (all
    keypoint-independent, cuda_hash_sift.cu:211-233,315-351)."""
    xs = np.arange(1, PATCH_W - 1)
    ys = np.arange(1, PATCH_H - 1)
    gx, gy = np.meshgrid(xs, ys)
    kp_radius = KEYPOINT_SCALE * PATCH_H * 0.5
    kernel_sigma = 0.5 * C_BINS * SIFT_DESCR_SCL_FCTR * kp_radius
    dist_scale = -1.0 / (2 * kernel_sigma * kernel_sigma)
    mag_scale = np.exp(np.float32(dist_scale)
                       * ((gx - np.float32(16)) ** 2
                          + (gy - np.float32(16)) ** 2).astype(np.float32)
                       ).astype(np.float32)

    scale_rc = np.float32(1.0 / (SIFT_DESCR_SCL_FCTR * kp_radius))
    rbin = scale_rc * (gy.astype(np.float32) - np.float32(16)) + np.float32(1.5)
    cbin = scale_rc * (gx.astype(np.float32) - np.float32(16)) + np.float32(1.5)
    ri = np.floor(rbin).astype(np.int32)
    rf = (rbin - ri).astype(np.float32)
    ci = np.floor(cbin).astype(np.int32)
    cf = (cbin - ci).astype(np.float32)

    npx = gx.size
    W = np.zeros((npx, (R_BINS + 2) * (C_BINS + 2)), np.float32)
    rif, cif = ri.ravel(), ci.ravel()
    rff, cff = rf.ravel(), cf.ravel()
    msf = mag_scale.ravel()
    px = np.arange(npx)
    for dr, wr in ((0, 1 - rff), (1, rff)):
        for dc, wc in ((0, 1 - cff), (1, cff)):
            W[px, (rif + 1 + dr) * (C_BINS + 2) + (cif + 1 + dc)] += \
                msf * wr * wc
    return W


@functools.lru_cache(maxsize=None)
def spatial_weight_core() -> np.ndarray:
    """(900, 16) float32: the columns of `_spatial_weight_matrix` for the
    4x4 core bins rc = r*4 + c.  The edge bins of the 6x6 grid are dropped
    by the reference's crop, so only these columns reach a descriptor."""
    idx = [(r + 1) * (C_BINS + 2) + (c + 1)
           for r in range(R_BINS) for c in range(C_BINS)]
    return np.ascontiguousarray(_spatial_weight_matrix()[:, idx])


@functools.lru_cache(maxsize=None)
def spatial_weight_core_on(device: str) -> torch.Tensor:
    """`spatial_weight_core` on `device` (cached; read-only)."""
    return torch.from_numpy(spatial_weight_core()).to(device)


def core_bin_rows(r: int) -> tuple[int, int]:
    """[lo, hi) range of interior patch rows (1..30) that can vote into core
    row bin r; the same bound holds for columns and core column bins.  The
    histogram kernel sums only over this window (`hist_plan`)."""
    return max(8 * r - 3, 1), min(8 * r + 12, PATCH_H - 1)


@functools.lru_cache(maxsize=None)
def hist_plan() -> tuple[np.ndarray, np.ndarray]:
    """The histogram kernel's walk (csrc/hs_common.cuh, `hist_block`).

    Returns (plan, weights).  plan is (16, 6) int32, one row per core
    spatial bin: [rc, offset, y0, y1, x0, x1], the window core_bin_rows(r)
    x core_bin_rows(c) of rc = 4r + c, the rows in descending window size
    (stable), so that the kernel's warp g, which takes rows 4g .. 4g + 3,
    has windows of equal or near-equal size.  weights is (sum of the window
    sizes,) float32: for each row in order, starting at its offset,
    `spatial_weight_core()[l, rc]` over the window's pixels in ascending
    pixel order (l = (y - 1) * 30 + x - 1)."""
    wcore = spatial_weight_core()

    def window(rc):
        (y0, y1), (x0, x1) = core_bin_rows(rc // C_BINS), core_bin_rows(
            rc % C_BINS)
        return y0, y1, x0, x1

    def size(rc):
        y0, y1, x0, x1 = window(rc)
        return (y1 - y0) * (x1 - x0)

    plan, weights, offset = [], [], 0
    for rc in sorted(range(R_BINS * C_BINS), key=lambda rc: -size(rc)):
        y0, y1, x0, x1 = window(rc)
        plan.append([rc, offset, y0, y1, x0, x1])
        ys, xs = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1),
                             indexing="ij")
        weights.append(wcore[((ys - 1) * (PATCH_W - 2) + xs - 1).ravel(), rc])
        offset += size(rc)
    return (np.array(plan, np.int32),
            np.ascontiguousarray(np.concatenate(weights), np.float32))


@functools.lru_cache(maxsize=None)
def hist_plan_on(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """`hist_plan` on `device` (cached; read-only)."""
    return tuple(torch.from_numpy(a).to(device) for a in hist_plan())


@contextlib.contextmanager
def full_f32_matmul():
    """Run matrix products in full float32 whatever the caller's
    `torch.set_float32_matmul_precision` says (TF32 would flip sign bits),
    and restore the caller's setting afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# K4's window (csrc/warp_patches.cu has the same).  A patch corner lies
# 16 sqrt(2) = 22.627 |s| px from the keypoint (the JAX package's
# _WARP_SUPPORT rounds it up to 22.63).
WARP_SUPPORT = 22.63
WARP_WINDOW_SIDE = 64       # rows and columns of the shared-memory branch
COORD_CAP = float(1 << 20)  # |x|, |y| of the shared-memory branch


class WarpWindow(NamedTuple):
    """Per keypoint (int32, bool): K4's window is image rows [y0, y0 + h)
    and columns [x0, x0 + w), clipped to the image (h or w may be 0);
    `in_smem` whether K4 stages it in shared memory (else it samples the
    image)."""
    y0: torch.Tensor
    x0: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    in_smem: torch.Tensor


def warp_window_plan(x, y, s, img_h: int, img_w: int, origin=(0, 0),
                     frame_hw=None) -> WarpWindow:
    """K4's window of each keypoint (x, y) at affine scale s (float32,
    finite), in image rows and columns (`origin`, `frame_hw` as for
    `warp_patches`).

    Every sample's 2x2 support lies within sup = ceil(WARP_SUPPORT |s|) + 2
    px of (floor(x), floor(y)): one pixel for the support's far side and
    one for the rounding of the sample's coordinates, which stays below a
    pixel while |x|, |y| < COORD_CAP.  So the window [floor - sup, floor +
    sup] clipped to the image holds every sample's support that lies in
    the image, and the samples read the same pixels from it as from the
    image.  K4 stages it only where, besides, the frame's part of [floor -
    sup, floor + sup] lies in the image, so that no valid sample's read is
    clamped (always, for the whole image as its frame)."""
    fh, fw = (img_h, img_w) if frame_hw is None else frame_hw
    oy, ox = origin
    sup = torch.clamp(torch.ceil(s.abs() * np.float32(WARP_SUPPORT)),
                      max=COORD_CAP).to(torch.int32) + 2
    near = (x.abs() < COORD_CAP) & (y.abs() < COORD_CAP)
    fy = torch.where(near, torch.floor(y), 0.0).to(torch.int32)
    fx = torch.where(near, torch.floor(x), 0.0).to(torch.int32)
    y0 = (fy - oy - sup).clamp(min=0)
    x0 = (fx - ox - sup).clamp(min=0)
    h = ((fy - oy + sup).clamp(max=img_h - 1) - y0 + 1).clamp(min=0)
    w = ((fx - ox + sup).clamp(max=img_w - 1) - x0 + 1).clamp(min=0)

    def span_in_image(c, n, o, m):
        lo, hi = (c - sup).clamp(min=0), (c + sup).clamp(max=n - 1)
        return (lo > hi) | ((lo >= o) & (hi < o + m))

    in_smem = (near & (h <= WARP_WINDOW_SIDE) & (w <= WARP_WINDOW_SIDE)
               & span_in_image(fy, fh, oy, img_h)
               & span_in_image(fx, fw, ox, img_w))
    return WarpWindow(y0, x0, h, w, in_smem)


def warp_patches(image: torch.Tensor, x, y, size, angle,
                 cropping_scale: float, origin=(0, 0),
                 frame_hw=None) -> torch.Tensor:
    """(N, 32, 32) float32 warped patches (values already u8-quantised):
    bilinear samples of the uint8 image under the keypoint affine, 0 where a
    sample's 2x2 support leaves the frame.

    `origin` / `frame_hw` (as the JAX package's): the image may hold the
    rows and columns from `origin` (oy, ox) on of a `frame_hw` frame, a band
    of a row-sharded image; keypoints stay in frame coordinates, the
    validity test uses the frame, and a sample reads the image at its
    support less the origin, clamped into the image.  The index is 2-D, as
    in the JAX package, so a 1-row or 1-column image reads row or column
    -1, which is its only one."""
    h, w = image.shape
    fh, fw = (h, w) if frame_hw is None else frame_hw
    oy, ox = origin
    m00, m01, m02, m10, m11, m12, _ = affine_rows(
        x[:, None, None], y[:, None, None], size[:, None, None],
        angle[:, None, None], cropping_scale)
    dev = image.device
    px = torch.arange(PATCH_W, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(PATCH_H, dtype=torch.float32, device=dev)[None, :, None]
    u = m00 * px + m01 * py + m02
    v = m10 * px + m11 * py + m12

    ui = torch.floor(u).to(torch.int32)
    vi = torch.floor(v).to(torch.int32)
    valid = (ui >= 0) & (ui + 1 < fw) & (vi >= 0) & (vi + 1 < fh)
    uic = (ui - ox).clamp(0, w - 2).long()
    vic = (vi - oy).clamp(0, h - 2).long()
    du = u - ui.to(torch.float32)
    dv = v - vi.to(torch.float32)

    im = image.to(torch.float32)
    p00 = im[vic, uic]
    p01 = im[vic, uic + 1]
    p10 = im[vic + 1, uic]
    p11 = im[vic + 1, uic + 1]
    # the reference's full-f32 lerp (cpu.descriptors.warp_patches)
    h0 = 1.0 - du
    z_top = h0 * p00 + du * p01
    z_bot = h0 * p10 + du * p11
    t2 = (1.0 - dv) * z_top + dv * z_bot
    val = torch.clamp(torch.trunc(t2 + 0.5), max=255.0)
    return torch.where(valid, val, torch.zeros_like(val))


def patch_sift_responses(patches: torch.Tensor) -> torch.Tensor:
    """(N, 129) float32 SIFT response rows [1, d0..d127] from (N, 32, 32)
    patches; d is in the (rc, o) layout d[rc*8 + o]."""
    n = patches.shape[0]
    p = patches.to(torch.float32)
    dx = p[:, 1:-1, 2:] - p[:, 1:-1, :-2]
    dy = p[:, :-2, 1:-1] - p[:, 2:, 1:-1]
    npx = (PATCH_H - 2) * (PATCH_W - 2)
    mag = torch.sqrt(dx * dx + dy * dy).reshape(n, npx)          # (N, 900)
    ori = torch.atan2(dy, dx).reshape(n, npx)

    ob = ORI_SCALE * ori
    oi = torch.floor(ob).to(torch.int32)
    of = ob - oi.to(torch.float32)
    oi = torch.where(oi < 0, oi + ORI_BINS, oi)
    oi = torch.where(oi >= ORI_BINS, oi - ORI_BINS, oi)
    v_hi = of * mag
    v_lo = mag - v_hi

    # bin o gets v_lo where oi == o and v_hi where oi + 1 == o; bin 8 (only
    # v_hi votes) folds into bin 0 after the products
    wcore = spatial_weight_core_on(str(p.device))                 # (900, 16)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    hists = []
    with full_f32_matmul():
        for o in range(ORI_BINS + 1):
            v_o = (torch.where(oi == o, v_lo, zero)
                   + torch.where(oi + 1 == o, v_hi, zero))
            hists.append(v_o @ wcore)
    core = torch.stack(hists, dim=-1)                             # (N, 16, 9)
    core = torch.cat([core[..., :1] + core[..., ORI_BINS:],
                      core[..., 1:ORI_BINS]], dim=-1)
    desc = core.reshape(n, 128)

    def l2n(d):
        nrm = torch.clamp(torch.sqrt((d * d).sum(dim=1)), min=EPS)
        return d / nrm[:, None]

    desc = l2n(desc)
    desc = torch.clamp(desc, max=float(MAGNITUDE_TH))
    desc = l2n(desc)
    desc = torch.clamp(torch.trunc(float(INT_DESCR_FACTOR) * desc + 0.5),
                       0.0, 255.0)
    return torch.cat([torch.ones((n, 1), dtype=torch.float32,
                                 device=p.device), desc], dim=1)


def hash_sift_descriptors(image: torch.Tensor, x, y, size, angle, valid, *,
                          nbits: int = 256, cropping_scale: float = 1.0,
                          origin=(0, 0), frame_hw=None) -> torch.Tensor:
    """(N, nbits//8) uint8 HashSIFT descriptors; invalid slots are zero.
    `origin`, `frame_hw` as for `warp_patches`."""
    B = torch.from_numpy(load_hash_sift_matrix(nbits)).to(image.device)
    responses = patch_sift_responses(
        warp_patches(image, x, y, size, angle, cropping_scale, origin,
                     frame_hw))
    with full_f32_matmul():
        proj = responses @ B.T
    bits = (proj > 0) & valid[:, None]
    return pack_bits_msb(bits)
