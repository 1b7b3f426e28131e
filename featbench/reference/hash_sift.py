"""Plain PyTorch reference of the HashSIFT descriptor (Suarez et al., RA-L
2021, as the reference library's `cuda_hash_sift.cu` and
`cuda_hash_sift.cpp` define it), written from its documented semantics.

Per keypoint (x, y, size, angle; scale factor 1):
- a 32 x 32 patch, bilinear under the keypoint's affine map, each sample
  rounded by trunc(v + 0.5) and capped at 255, 0 where its 2 x 2 support
  leaves the image;
- over the patch's 30 x 30 interior, central differences (dx right minus
  left, dy up minus down), the magnitude weighted by a Gaussian of sigma 16
  about the patch centre (0.5 * 4 bins * 3 * the keypoint radius 32 / 6 / 2),
  the orientation atan2(dy, dx) in 8 bins;
- a 4 x 4 spatial x 8 orientation histogram in a 6 x 6 x 10 grid with a
  ring of spill bins: each pixel casts 8 trilinear votes, rows and columns
  8 px a bin; the core 4 x 4 is kept and orientation bins 8 and 9 fold into
  0 and 1;
- L2 normalise (the norm at least float32's epsilon), clip at 0.2,
  normalise again, quantise by trunc(512 v + 0.5) into [0, 255];
- the learned (nbits, 129) projection of [1, d0 .. d127], column 0 the
  bias, d in (row, column, orientation) order; a bit is set where the
  projection is above 0, most significant first.

Votes are cast pixel by pixel with `index_add_` in a fixed order, and
products run in full float32 (no TF32).  `lowp` computes the warp, the
gradients, the histogram, the normalisation and the projection in that
dtype; the indices stay exact.
"""
from __future__ import annotations

import contextlib
import functools
from pathlib import Path

import numpy as np
import torch

from . import patch as P

HERE = Path(__file__).resolve().parent
PATCH = 32
BINS = 4                      # spatial bins a side
ORI_BINS = 8
GRID = (BINS + 2, BINS + 2, ORI_BINS + 2)
HIST = GRID[0] * GRID[1] * GRID[2]
DIMS = BINS * BINS * ORI_BINS             # 128
ORI_SCALE = float(np.float32(ORI_BINS / (2 * np.pi)))
MAGNITUDE_TH = float(np.float32(0.2))
INT_DESCR_FACTOR = 512.0
EPS = float(np.finfo(np.float32).eps)
KEYPOINT_RADIUS = PATCH / 6.0 / 2.0
GAUSS_SIGMA = 0.5 * BINS * 3.0 * KEYPOINT_RADIUS
BIN_PX = 3.0 * KEYPOINT_RADIUS            # 8 px a spatial bin
BLOCK = 2048                              # keypoints at a time


def projection(nbits: int, device) -> torch.Tensor:
    """The (nbits, 129) float32 projection, column 0 the bias."""
    if nbits not in (256, 512):
        raise ValueError(f"HashSIFT has 256 or 512 bits, got {nbits}")
    b = np.load(HERE / f"hash_sift_p{nbits}.npz")["b_matrix"]
    return torch.from_numpy(b.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _interior() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                         np.ndarray]:
    """Per interior pixel, row-major: the Gaussian weight (float64), the
    spatial bin's row and column (int) and their fractions (exact)."""
    g = np.arange(1, PATCH - 1, dtype=np.float64)
    gy, gx = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    c = PATCH / 2
    gauss = np.exp(-((gx - c) ** 2 + (gy - c) ** 2)
                   / (2 * GAUSS_SIGMA ** 2))
    rb = (gy - c) / BIN_PX + BINS / 2 - 0.5
    cb = (gx - c) / BIN_PX + BINS / 2 - 0.5
    ri, ci = np.floor(rb), np.floor(cb)
    return gauss, ri.astype(np.int64), ci.astype(np.int64), rb - ri, cb - ci


@contextlib.contextmanager
def _fixed_arithmetic():
    """Full float32 products and sums in a fixed order, whatever the
    caller's settings; the caller's are restored afterwards."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])


def patches(image: torch.Tensor, x, y, size, angle, dt) -> torch.Tensor:
    """(N, 32, 32) patches in `dt` (whole values 0 .. 255)."""
    h, w = image.shape
    dev = image.device
    m00, m01, m02, m10, m11, m12, _ = P.affine(
        *(v.to(dt)[:, None, None] for v in (x, y, size, angle)))
    px = torch.arange(PATCH, dtype=dt, device=dev)[None, None, :]
    py = torch.arange(PATCH, dtype=dt, device=dev)[None, :, None]
    u = m00 * px + m01 * py + m02
    v = m10 * px + m11 * py + m12
    fu, fv = torch.floor(u), torch.floor(v)
    du, dv = u - fu, v - fv
    iu, iv = fu.to(torch.int64), fv.to(torch.int64)
    inside = (iu >= 0) & (iu + 1 < w) & (iv >= 0) & (iv + 1 < h)
    iu, iv = iu.clamp(0, max(w - 2, 0)), iv.clamp(0, max(h - 2, 0))
    im = image.to(dt)
    h0 = 1.0 - du
    top = h0 * im[iv, iu] + du * im[iv, iu + 1]
    bot = h0 * im[iv + 1, iu] + du * im[iv + 1, iu + 1]
    val = (1.0 - dv) * top + dv * bot
    val = torch.clamp(torch.trunc(val + 0.5), max=255.0)
    return torch.where(inside, val, torch.zeros_like(val))


def sift_rows(p: torch.Tensor) -> torch.Tensor:
    """(N, 128) quantised SIFT rows of (N, 32, 32) patches, in their dtype,
    d[(r * 4 + c) * 8 + o]."""
    n, dt, dev = p.shape[0], p.dtype, p.device
    gauss, ri, ci, rf, cf = _interior()
    gauss = torch.from_numpy(gauss.astype(np.float32)).to(dev, dt)
    rf, cf = (torch.from_numpy(a).to(dev, dt) for a in (rf, cf))
    npx = (PATCH - 2) ** 2
    dx = (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]).reshape(n, npx)
    dy = (p[:, :-2, 1:-1] - p[:, 2:, 1:-1]).reshape(n, npx)
    mag = gauss * torch.sqrt(dx * dx + dy * dy)
    ob = ORI_SCALE * torch.atan2(dy, dx)
    fo = torch.floor(ob)
    of = ob - fo
    oi = fo.to(torch.int64) % ORI_BINS

    # trilinear votes, (N, 900) each: rows, then columns, then orientation
    r1 = rf * mag
    r0 = mag - r1
    votes, bins = [], []
    for dr, vr in ((0, r0), (1, r1)):
        c1 = cf * vr
        for dc, vc in ((0, vr - c1), (1, c1)):
            o1 = of * vc
            spatial = torch.from_numpy(
                ((ri + 1 + dr) * GRID[1] + ci + 1 + dc) * GRID[2]).to(dev)
            votes += [vc - o1, o1]
            bins += [spatial + oi, spatial + oi + 1]
    votes = torch.stack(votes, dim=2)                      # (N, 900, 8)
    base = torch.arange(n, device=dev)[:, None, None] * HIST
    idx = base + torch.stack(bins, dim=2)
    hist = torch.zeros(n * HIST, dtype=dt, device=dev)
    with _fixed_arithmetic():
        hist.index_add_(0, idx.reshape(-1), votes.reshape(-1))
    hist = hist.reshape(n, *GRID)[:, 1:1 + BINS, 1:1 + BINS]
    d = torch.cat([hist[..., :2] + hist[..., ORI_BINS:],
                   hist[..., 2:ORI_BINS]], dim=-1).reshape(n, DIMS)

    def l2n(d):
        nrm = torch.clamp(torch.sqrt((d * d).sum(dim=1)), min=EPS)
        return d / nrm[:, None]

    d = torch.clamp(l2n(d), max=MAGNITUDE_TH)
    d = l2n(d)
    return torch.clamp(torch.trunc(INT_DESCR_FACTOR * d + 0.5), 0.0, 255.0)


def hash_sift(image: torch.Tensor, x, y, size, angle, nbits: int,
              lowp=None) -> torch.Tensor:
    """(N, nbits // 8) uint8 HashSIFT descriptors of keypoints (x, y,
    size, angle in degrees; angle < 0: no rotation) on the u8 `image`."""
    dt = torch.float32 if lowp is None else lowp
    b = projection(nbits, image.device).to(dt)
    out = [torch.zeros((0, nbits // 8), dtype=torch.uint8,
                       device=image.device)]
    for i in range(0, len(x), BLOCK):
        blk = slice(i, i + BLOCK)
        d = sift_rows(patches(image, x[blk], y[blk], size[blk], angle[blk],
                              dt))
        rows = torch.cat([torch.ones_like(d[:, :1]), d], dim=1)
        with _fixed_arithmetic():
            proj = rows @ b.T
        out.append(P.pack_msb(proj > 0))
    return torch.cat(out)
