"""Homography arithmetic of the reference: transfer errors against a
known map, the corner distance between two maps, and a plain RANSAC (the
control's stand-in for the program's)."""
from __future__ import annotations

import numpy as np
import torch


def transfer(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 2) points under the 3 x 3 map H, in float64."""
    p = np.concatenate([pts.astype(np.float64),
                        np.ones((len(pts), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def corner_gap_px(H: np.ndarray, H_true: np.ndarray, hw) -> float:
    """Largest distance between where H and H_true send the frame's four
    corners (inf where H is not finite)."""
    h, w = hw
    c = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                 np.float64)
    if not np.all(np.isfinite(H)) or abs(H[2, 2]) < 1e-12:
        return float("inf")
    d = np.linalg.norm(transfer(H, c) - transfer(H_true, c), axis=1)
    return float(d.max()) if np.all(np.isfinite(d)) else float("inf")


def inliers(H: np.ndarray, src: np.ndarray, dst: np.ndarray,
            thresh: float) -> int:
    """Pairs whose forward transfer error under H is below thresh px."""
    if len(src) == 0:
        return 0
    e = np.linalg.norm(transfer(H, src) - dst, axis=1)
    return int(np.sum(e < thresh))


def _normalise(p: torch.Tensor, w: torch.Tensor):
    """Hartley normalisation of weighted points (..., N, 2): the moved
    points and the 3 x 3 similarity."""
    ws = w.sum(-1, keepdim=True).clamp(min=1)
    c = (p * w[..., None]).sum(-2) / ws
    d = torch.linalg.vector_norm(p - c[..., None, :], dim=-1)
    s = 1.4142135623730951 / ((d * w).sum(-1) / ws[..., 0]).clamp(min=1e-8)
    T = torch.zeros(p.shape[:-2] + (3, 3), dtype=p.dtype, device=p.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * c[..., 0]
    T[..., 1, 2] = -s * c[..., 1]
    T[..., 2, 2] = 1
    return (p - c[..., None, :]) * s[..., None, None], T


def dlt(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
        dtype=torch.float32) -> torch.Tensor:
    """Weighted normalised DLT of (..., N, 2) pairs: (..., 3, 3) maps,
    the design and its normal matrix in `dtype`, the eigenvectors in
    float32 (float64 for a float64 design)."""
    src, dst, w = src.to(dtype), dst.to(dtype), w.to(dtype)
    a, Ta = _normalise(src, w)
    b, Tb = _normalise(dst, w)
    x, y, u, v = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    z, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, one, -v * x, -v * y, -v], -1)
    r1, r2 = r1 * w[..., None], r2 * w[..., None]
    ata = r1.transpose(-1, -2) @ r1 + r2.transpose(-1, -2) @ r2
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    hn = torch.linalg.eigh(ata.to(solve))[1][..., 0].reshape(
        ata.shape[:-2] + (3, 3))
    H = torch.linalg.solve(Tb.to(solve), hn @ Ta.to(solve))
    return H / H[..., 2:3, 2:3]


def ransac(src: torch.Tensor, dst: torch.Tensor, thresh: float, iters: int,
           seed: int, dtype=torch.float32) -> np.ndarray:
    """Plain RANSAC: `iters` uniform 4-subsets (numpy's generator of
    `seed`), each solved by `dlt`, scored by forward transfer error under
    `thresh`, the best refitted on its inliers; arithmetic in `dtype`."""
    n = src.shape[0]
    if n < 4:
        return np.full((3, 3), np.nan)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.stack([rng.choice(n, 4, replace=False)
                                     for _ in range(iters)])).to(src.device)
    ones = torch.ones(idx.shape, device=src.device)
    Hs = dlt(src[idx], dst[idx], ones, dtype).to(dtype)

    def inl(H):
        p = torch.cat([src.to(dtype), torch.ones_like(src[:, :1]).to(dtype)],
                      1) @ H.transpose(-1, -2)
        e = p[..., :2] / p[..., 2:3] - dst.to(dtype)
        return (e * e).sum(-1) < thresh * thresh
    score = inl(Hs).sum(-1)
    best = Hs[int(torch.argmax(score))]
    H = dlt(src, dst, inl(best).to(torch.float32), dtype)
    return H.to(torch.float64).cpu().numpy()
