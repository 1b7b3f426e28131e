"""Batched RANSAC homography estimation (geometric match check).

Port of `efficient_features_tpu/ops/ransac.py`.  RANSAC's hypothesize and
verify loop runs as a fixed number of batched tensor ops, with no loop over
hypotheses and no host read:

  - all M minimal sets are drawn at once (`_draw_minimal_sets`: Gumbel
    top-4 from the valid-match mask, no duplicate indices within a set),
  - all M homographies are solved together (Hartley-normalised DLT; the
    eigenvector of each 9x9 normal matrix's smallest eigenvalue comes from
    K12, `smallest_eigvec9`, Jacobi rotations in float64),
  - all M x N reprojection errors are scored in one batched product,
  - the best hypothesis (the first of equal scores) is refitted once on its
    inliers (`_ransac_from_indices`).

The random draw is split from the rest because `torch.Generator` cannot
reproduce `jax.random.gumbel`: the parity tests hand JAX's own indices to
`_ransac_from_indices`.  Every matrix product runs in full float32 whatever
the caller's `torch.set_float32_matmul_precision` says: TF32 would cost
pixel-scale error after denormalisation (the JAX package's products use
`precision=HIGHEST` for the same reason).  The JAX package solves with
`jnp.linalg.eigh`; the port does not use `torch.linalg.eigh`, which reads
its solver's status back to the host, so a RANSAC call on the card only
enqueues work, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..api import resolve_device
from .detect_kernels import require_cuda, stream_of
from .hash_sift import full_f32_matmul

JACOBI_SWEEPS = 8


def jacobi_rounds(n: int = 9) -> list[list[tuple[int, int]]]:
    """The round-robin schedule of Jacobi rotations over an odd `n`: n
    rounds of (n - 1) / 2 disjoint pairs (p < q), each pair once a sweep
    (the circle method, index n the bye)."""
    players = list(range(n + 1))
    rounds = []
    for _ in range(n):
        pairs = [tuple(sorted((players[i], players[n - i])))
                 for i in range((n + 1) // 2)]
        rounds.append([pq for pq in pairs if n not in pq])
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


_SCHEDULES: dict = {}


def _device_schedule(device: torch.device) -> torch.Tensor:
    """`jacobi_rounds()` as a (9, 2, 4) int64 tensor on `device`, per round
    the p's then the q's, made once per device: a copy per call would sync
    the host."""
    if device not in _SCHEDULES:
        _SCHEDULES[device] = torch.tensor(
            [[[p for p, _ in r], [q for _, q in r]] for r in jacobi_rounds()],
            dtype=torch.int64, device=device)
    return _SCHEDULES[device]


def smallest_eigvec9_ref(ata: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: the (..., 9) float32 eigenvector of the
    smallest eigenvalue of each symmetric (..., 9, 9) float32 matrix.

    JACOBI_SWEEPS sweeps of `jacobi_rounds` in float64, each round's four
    rotations taken together: the rotations from the matrix as the round
    finds it, then the pairs' columns, then their rows, then the pairs'
    2x2 blocks set to (a_pp - t a_pq, 0; 0, a_qq + t a_pq), then V's
    columns; the column of V at the smallest diagonal entry, the first on
    ties.  Every step is one elementwise op, so K12 repeats it bit for
    bit (see csrc/jacobi_eigh9.cu)."""
    lead = ata.shape[:-2]
    a = ata.reshape(-1, 9, 9).to(torch.float64, copy=True)
    v = torch.eye(9, dtype=torch.float64, device=a.device).expand(
        a.shape[0], 9, 9).clone()
    sched = _device_schedule(a.device)
    for _ in range(JACOBI_SWEEPS):
        for r in range(sched.shape[0]):
            p, q = sched[r]
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            theta = (aqq - app) / (2 * apq)
            rcp = 1.0 / (theta.abs() + torch.sqrt(theta * theta + 1))
            t = torch.where(theta >= 0, rcp, -rcp)
            t = torch.where(apq == 0, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1)
            s = t * c
            cc, ss = c[:, None, :], s[:, None, :]
            gp, gq = a[:, :, p], a[:, :, q]
            a[:, :, p] = cc * gp - ss * gq
            a[:, :, q] = ss * gp + cc * gq
            gp, gq = a[:, p, :], a[:, q, :]
            a[:, p, :] = c[..., None] * gp - s[..., None] * gq
            a[:, q, :] = s[..., None] * gp + c[..., None] * gq
            a[:, p, p] = app - t * apq
            a[:, q, q] = aqq + t * apq
            a[:, p, q] = 0.0
            a[:, q, p] = 0.0
            gp, gq = v[:, :, p], v[:, :, q]
            v[:, :, p] = cc * gp - ss * gq
            v[:, :, q] = ss * gp + cc * gq
    diag = a.diagonal(dim1=1, dim2=2)
    best = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for j in range(1, 9):
        lower = diag[:, j] < diag.gather(1, best[:, None])[:, 0]
        best = torch.where(lower, torch.full_like(best, j), best)
    vec = v.gather(2, best[:, None, None].expand(-1, 9, 1))[..., 0]
    return vec.to(torch.float32).reshape(*lead, 9)


def smallest_eigvec9(ata: torch.Tensor) -> torch.Tensor:
    """The eigenvector of each symmetric (..., 9, 9) float32 matrix's
    smallest eigenvalue; see `smallest_eigvec9_ref`.  One K12 launch on a
    CUDA tensor, which reads nothing back."""
    if ata.device.type == "cpu":
        return smallest_eigvec9_ref(ata)
    if ata.shape[-2:] != (9, 9):
        raise ValueError(f"ata must be (..., 9, 9), got {tuple(ata.shape)}")
    lead = ata.shape[:-2]
    flat = ata.reshape(-1, 9, 9).contiguous()
    require_cuda(flat, torch.float32, "ata")
    n = flat.shape[0]
    vec = torch.empty((n, 9), dtype=torch.float32, device=flat.device)
    if n == 0:
        return vec.reshape(*lead, 9)
    sched = _device_schedule(flat.device)
    lib = _build.library()
    with torch.cuda.device(flat.device):
        rc = lib.eff_jacobi_eigh9(flat.data_ptr(), n, sched.data_ptr(),
                                  JACOBI_SWEEPS, vec.data_ptr(),
                                  stream_of(flat))
        _build.check(rc, "jacobi_eigh9")
        smallest_eigvec9.launches += 1
    return vec.reshape(*lead, 9)


smallest_eigvec9.launches = 0


def _normalization(pts, w):
    """Hartley normalisation transform for weighted points (w in {0,1}).

    Returns (T, pts_n): T is the 3x3 similarity moving the weighted point
    set to centroid 0, mean distance sqrt(2); pts_n the transformed points.
    """
    wsum = w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    c = (pts * w[..., None]).sum(dim=-2) / wsum                   # (..., 2)
    d = torch.linalg.vector_norm(pts - c[..., None, :], dim=-1)
    mean_d = (d * w).sum(dim=-1) / wsum[..., 0]
    s = math.sqrt(2.0) / mean_d.clamp_min(1e-8)                   # (...,)
    pts_n = (pts - c[..., None, :]) * s[..., None, None]
    z = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * c[..., 0]], dim=-1),
        torch.stack([z, s, -s * c[..., 1]], dim=-1),
        torch.stack([z, z, one], dim=-1)], dim=-2)                # (..., 3, 3)
    return T, pts_n


def _dlt(src, dst, w):
    """Weighted normalised DLT: (..., K, 2) point pairs -> (..., 3, 3) H.

    Two design rows per correspondence; H is the eigenvector of A^T A for
    its smallest eigenvalue.  Weights w (..., K) in {0,1} select the
    participating pairs (masked-out rows contribute zero).
    """
    Ts, src_n = _normalization(src, w)
    Td, dst_n = _normalization(dst, w)
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    z = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, one, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([w, w], dim=-1)[..., None]
    with full_f32_matmul():
        AtA = A.transpose(-1, -2) @ A                             # (..., 9, 9)
    Hn = smallest_eigvec9(AtA).reshape(*AtA.shape[:-2], 3, 3)
    # denormalise: H = Td^-1 Hn Ts, with Td^-1 in closed form
    sd = Td[..., 0, 0]
    cdx = -Td[..., 0, 2] / sd
    cdy = -Td[..., 1, 2] / sd
    z0 = torch.zeros_like(sd)
    one0 = torch.ones_like(sd)
    Td_inv = torch.stack([
        torch.stack([1.0 / sd, z0, cdx], dim=-1),
        torch.stack([z0, 1.0 / sd, cdy], dim=-1),
        torch.stack([z0, z0, one0], dim=-1)], dim=-2)
    with full_f32_matmul():
        H = Td_inv @ Hn @ Ts
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-12, torch.ones_like(h22), h22)


def _reproj_err2(H, src, dst):
    """Squared forward-transfer error of every pair under every H:
    H (M, 3, 3), src/dst (N, 2) -> (M, N)."""
    sh = torch.cat([src, torch.ones_like(src[:, :1])], dim=1)    # (N, 3)
    with full_f32_matmul():
        p = torch.matmul(H, sh.T).transpose(1, 2)                 # (M, N, 3)
    zden = p[..., 2]
    den = torch.where(zden.abs() < 1e-12, torch.full_like(zden, 1e-12), zden)
    proj = p[..., :2] / den[..., None]
    e2 = ((proj - dst[None]) ** 2).sum(dim=-1)
    # points mapped to or behind the plane at infinity are never inliers
    return torch.where(zden.abs() < 1e-6, torch.full_like(e2, math.inf), e2)


def _draw_minimal_sets(valid: torch.Tensor, iters: int,
                       generator: torch.Generator) -> torch.Tensor:
    """(iters, 4) int64 indices: i.i.d. Gumbel noise on the valid slots and
    the 4 largest per hypothesis, a uniform 4-subset without replacement.
    `generator` lives on `valid`'s device."""
    u = torch.rand((iters, valid.shape[0]), generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    g = torch.where(valid[None], g, torch.full_like(g, -math.inf))
    return torch.topk(g, 4, dim=1).indices


def _ransac_from_indices(src, dst, valid, thresh: float, idx):
    """Score the hypotheses of the minimal sets `idx` (M, 4) and refit the
    best on its inliers.  Returns (H (3, 3) f32, inliers (N,) bool,
    n_inliers int32), all on the inputs' device, with no host read."""
    t2 = float(np.float32(thresh) * np.float32(thresh))
    H = _dlt(src[idx], dst[idx], torch.ones(idx.shape, dtype=src.dtype,
                                           device=src.device))
    inl = (_reproj_err2(H, src, dst) <= t2) & valid[None]
    scores = inl.sum(dim=1)
    bi = torch.argmax(scores).reshape(1)    # the first maximum
    best_inl = inl.index_select(0, bi)[0]
    best_score = scores.index_select(0, bi)[0]
    # one weighted refit on the winner's inliers; keep the minimal-set
    # estimate when the refit is worse or the winner has < 4 inliers
    H_ref = _dlt(src, dst, best_inl.to(src.dtype))
    inl_ref = (_reproj_err2(H_ref[None], src, dst)[0] <= t2) & valid
    better = (inl_ref.sum() >= best_score) & (best_score >= 4)
    H_out = torch.where(better, H_ref, H.index_select(0, bi)[0])
    inl_out = torch.where(better, inl_ref, best_inl)
    return H_out, inl_out, inl_out.sum(dtype=torch.int32)


def find_homography_ransac(src, dst, valid=None, *, iters: int = 512,
                           thresh: float = 3.0, seed: int = 0,
                           device="cuda"):
    """Estimate the homography mapping src -> dst from noisy matches.

    src, dst: (N, 2) float point pairs (arrays or tensors); valid: optional
    (N,) bool mask (False rows are ignored: fixed-shape slots).  `iters`
    hypotheses from a `torch.Generator` seeded with `seed` are solved and
    scored together; the best is refitted on its inliers.  Returns
    (H 3x3 f32, inlier mask (N,) bool, n_inliers int32) as tensors on
    `device`.  thresh is the forward-transfer inlier radius in pixels (the
    cv::findHomography ransacReprojThreshold convention).
    """
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=dev)
    if src.dim() != 2 or src.shape[1] != 2 or src.shape != dst.shape:
        raise ValueError("src/dst must both be (N, 2)")
    if src.shape[0] < 4:
        raise ValueError("need at least 4 matches")
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    else:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx = _draw_minimal_sets(valid, iters, gen)
    return _ransac_from_indices(src, dst, valid, thresh, idx)
