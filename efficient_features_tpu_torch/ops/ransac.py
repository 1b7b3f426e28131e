"""Batched RANSAC homography estimation (geometric match check).

Port of `efficient_features_tpu/ops/ransac.py`.  RANSAC's hypothesize and
verify loop runs as a fixed number of launches, with no loop over
hypotheses and no host read:

  - all M minimal sets are drawn at once (`_draw_minimal_sets`: Gumbel
    top-4 from the valid-match mask, no duplicate indices within a set),
  - all M homographies are solved in one K12 launch (`solve_minimal_sets`:
    per set the Hartley-normalised DLT, the eigenvector of its 9x9 normal
    matrix's smallest eigenvalue by Jacobi rotations in float64, and the
    denormalisation),
  - all M hypotheses are scored against all N matches in another
    (`score_homographies`), with no (M, N) tensor,
  - the best hypothesis (the first of equal scores) is refitted once on its
    inliers (`_dlt` over the N rows, its 9x9 system through the same
    Jacobi body, `smallest_eigvec9`), and the winner's and the refit's
    inlier masks come from `inlier_mask` (`_ransac_from_indices`).

Each kernel wrapper has a plain version that repeats its float steps one
by one in the kernel's order (`*_ref`), so the two agree bit for bit; the
wrapper takes it only for a CPU tensor.  The random draw is split from the
rest because `torch.Generator` cannot reproduce `jax.random.gumbel`: the
parity tests hand JAX's own indices to `_ransac_from_indices`.  The refit's
product runs in full float32 whatever the caller's
`torch.set_float32_matmul_precision` says: TF32 would cost pixel-scale
error after denormalisation (the JAX package's products use
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
from ..utils.profiler import span

JACOBI_SWEEPS = 8
# A matrix's sweeps stop once every off-diagonal entry is at most its
# largest diagonal magnitude times this.  2^-64 lies below float64's
# rounding (2^-53), so a rotation at that size moves no entry by more than
# rounding would, and it perturbs the smallest eigenvector by about
# 2^-64 / (relative gap to the next eigenvalue): below float32's 2^-24 in
# the output unless the gap is under 2^-40.
JACOBI_TOL = 2.0 ** -64

# The float32 constants of the JAX package's float32 arithmetic, as float32
# values: a kernel and its plain version compare with the same numbers.
SQRT2 = float(np.float32(math.sqrt(2.0)))
EPS_MEAN = float(np.float32(1e-8))     # floor of Hartley's mean distance
EPS_H22 = float(np.float32(1e-12))     # |h22| below it: H is not rescaled
EPS_DEN = float(np.float32(1e-12))     # floor of the projective divisor
EPS_INF = float(np.float32(1e-6))      # |z| below it: at infinity, outlier


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


def _converged(a: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """(B,) bool: every off-diagonal |a_pq| at most JACOBI_TOL times the
    largest diagonal magnitude (false where either holds a NaN)."""
    diag = a.diagonal(dim1=1, dim2=2).abs().amax(dim=1)
    big = torch.where(off, a.abs(), torch.zeros_like(a)).amax(dim=(1, 2))
    return big <= diag * JACOBI_TOL


def _jacobi9(a: torch.Tensor):
    """K12's Jacobi body on a (B, 9, 9) float64 batch: (a, v, sweeps), the
    rotated matrix, the product of the rotations and the sweeps each matrix
    ran.

    Up to JACOBI_SWEEPS sweeps of `jacobi_rounds`; a matrix stops before a
    sweep once `_converged` (its later sweeps leave it as it is).  A round
    takes its four rotations from the matrix as the round finds it, one
    division and two square roots each: d = a_qq - a_pp, e = 2 a_pq,
    r = sqrt(d^2 + e^2), w = |d| + r, n = sqrt(w^2 + e^2), c = w (1 / n),
    s = +-e (1 / n) (+ for d >= 0); c = 1, s = 0 where a_pq = 0.  Then the
    pairs' columns of the matrix and of V, then the matrix's rows, then
    zeros at (p, q) and (q, p).  Every step is one elementwise op, so the
    kernels repeat it bit for bit (csrc/jacobi_eigh9.cu)."""
    b = a.shape[0]
    eye = torch.eye(9, dtype=torch.float64, device=a.device)
    av = torch.cat([a, eye.expand(b, 9, 9)], dim=1)    # (B, 18, 9): A over V
    off = ~eye.bool()
    sweeps = torch.zeros(b, dtype=torch.int64, device=a.device)
    sched = _device_schedule(a.device)
    for _ in range(JACOBI_SWEEPS):
        done = _converged(av[:, :9], off)
        sweeps = sweeps + (~done).to(torch.int64)
        av0 = av.clone()
        for r in range(sched.shape[0]):
            p, q = sched[r]
            app, aqq, apq = av[:, p, p], av[:, q, q], av[:, p, q]
            d = aqq - app
            e = apq + apq
            ee = e * e
            w = d.abs() + torch.sqrt(d * d + ee)
            inv = torch.reciprocal(torch.sqrt(w * w + ee))
            zero = apq == 0
            c = torch.where(zero, 1.0, w * inv)
            s = torch.where(zero, 0.0, torch.where(d >= 0, e, -e) * inv)
            cc, ss = c[:, None, :], s[:, None, :]
            gp, gq = av[:, :, p], av[:, :, q]       # the columns of A and V
            av[:, :, p] = cc * gp - ss * gq
            av[:, :, q] = ss * gp + cc * gq
            cr, sr = c[..., None], s[..., None]
            gp, gq = av[:, p, :], av[:, q, :]       # the rows of A
            av[:, p, :] = cr * gp - sr * gq
            av[:, q, :] = sr * gp + cr * gq
            av[:, p, q] = 0.0
            av[:, q, p] = 0.0
        av = torch.where(done[:, None, None], av0, av)
    return av[:, :9], av[:, 9:], sweeps


def _smallest_column(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """V's column at the smallest diagonal entry of a (the first on ties),
    in float32: (B, 9)."""
    diag = a.diagonal(dim1=1, dim2=2)
    best = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for j in range(1, 9):
        lower = diag[:, j] < diag.gather(1, best[:, None])[:, 0]
        best = torch.where(lower, torch.full_like(best, j), best)
    return v.gather(2, best[:, None, None].expand(-1, 9, 1))[..., 0].to(
        torch.float32)


def jacobi_sweeps(ata: torch.Tensor) -> torch.Tensor:
    """(...,) int64: the sweeps K12 runs on each symmetric (..., 9, 9)
    float32 matrix (the work a bound counts)."""
    return _jacobi9(ata.reshape(-1, 9, 9).to(torch.float64, copy=True))[
        2].reshape(ata.shape[:-2])


def smallest_eigvec9_ref(ata: torch.Tensor) -> torch.Tensor:
    """Plain version of `smallest_eigvec9`: the (..., 9) float32
    eigenvector of the smallest eigenvalue of each symmetric (..., 9, 9)
    float32 matrix, `_jacobi9` in float64 and V's column at the smallest
    diagonal entry, the first on ties."""
    a, v, _ = _jacobi9(ata.reshape(-1, 9, 9).to(torch.float64, copy=True))
    return _smallest_column(a, v).reshape(*ata.shape[:-2], 9)


def smallest_eigvec9(ata: torch.Tensor) -> torch.Tensor:
    """The eigenvector of each symmetric (..., 9, 9) float32 matrix's
    smallest eigenvalue; see `smallest_eigvec9_ref`.  One K12 launch
    (`jacobi9_kernel`) on a CUDA tensor, which reads nothing back."""
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
    lib = _build.library()
    with torch.cuda.device(flat.device):
        rc = lib.eff_jacobi_eigh9(flat.data_ptr(), n, JACOBI_SWEEPS,
                                  JACOBI_TOL, vec.data_ptr(), stream_of(flat))
        _build.check(rc, "jacobi_eigh9")
        smallest_eigvec9.launches += 1
    return vec.reshape(*lead, 9)


smallest_eigvec9.launches = 0


def _sum4(t: torch.Tensor) -> torch.Tensor:
    """((t0 + t1) + t2) + t3 over the last axis of length 4."""
    return ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]


def _hartley4(pts: torch.Tensor):
    """Hartley normalisation of (M, 4, 2) float32 point sets, all weights
    1: (s, cx, cy, xn, yn), the scale, the centroid and the normalised
    coordinates (M, 4), every sum in index order."""
    x, y = pts[..., 0], pts[..., 1]
    cx, cy = _sum4(x) * 0.25, _sum4(y) * 0.25
    dx, dy = x - cx[:, None], y - cy[:, None]
    mean = _sum4(torch.sqrt(dx * dx + dy * dy)) * 0.25
    s = torch.full_like(mean, SQRT2) / mean.clamp_min(EPS_MEAN)
    return s, cx, cy, dx * s[:, None], dy * s[:, None]


def minimal_set_systems(src, dst, idx):
    """The DLT of each minimal set idx (M, 4) of (N, 2) float32 src / dst:
    (ata (M, 9, 9) float32, (ss, csx, csy), (sd, cdx, cdy)), the normal
    matrix A^T A of the Hartley-normalised design and the two
    normalisations.  A's rows are the four (x, y, 1, 0, 0, 0, -ux, -uy, -u)
    then the four (0, 0, 0, x, y, 1, -vx, -vy, -v); each entry of A^T A
    sums its eight products in row order."""
    ss, csx, csy, x, y = _hartley4(src[idx])
    sd, cdx, cdy, u, v = _hartley4(dst[idx])
    z, one = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([
        torch.stack([x, y, one, z, z, z, -u * x, -u * y, -u], dim=-1),
        torch.stack([z, z, z, x, y, one, -v * x, -v * y, -v], dim=-1)],
        dim=1)                                                   # (M, 8, 9)
    ata = A[:, 0, :, None] * A[:, 0, None, :]
    for r in range(1, 8):
        ata = ata + A[:, r, :, None] * A[:, r, None, :]
    return ata, (ss, csx, csy), (sd, cdx, cdy)


def _denormalize(hn, src_norm, dst_norm):
    """(..., 9) float32 null vectors Hn -> (..., 3, 3) H = Td^-1 Hn Ts,
    divided by h22 unless |h22| < EPS_H22.  Ts = (ss, 0, -ss csx; 0, ss,
    -ss csy; 0, 0, 1) and Td^-1 = (1 / sd, 0, cdx; 0, 1 / sd, cdy; 0, 0, 1)
    in closed form: with M = Hn Ts, row i of M is (h_i0 ss, h_i1 ss,
    (h_i0 tx + h_i1 ty) + h_i2), tx = -(ss csx), ty = -(ss csy), and rows
    0 and 1 of H are M_0j (1 / sd) + cdx M_2j and M_1j (1 / sd) + cdy M_2j.
    """
    ss, csx, csy = (t[..., None] for t in src_norm)
    sd, cdx, cdy = (t[..., None] for t in dst_norm)
    h = hn.reshape(*hn.shape[:-1], 3, 3)
    col0, col1 = h[..., 0], h[..., 1]
    m = torch.stack([col0 * ss, col1 * ss,
                     (col0 * -(ss * csx) + col1 * -(ss * csy)) + h[..., 2]],
                    dim=-1)                                      # Hn Ts
    top = m[..., :2, :] * (torch.ones_like(sd) / sd)[..., None] \
        + torch.stack([cdx, cdy], dim=-2) * m[..., 2:, :]
    H = torch.cat([top, m[..., 2:, :]], dim=-2)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < EPS_H22, torch.ones_like(h22), h22)


def solve_minimal_sets_ref(src, dst, idx):
    """Plain version of `solve_minimal_sets`: `minimal_set_systems`, the
    smallest eigenvector of each (`smallest_eigvec9_ref`) and
    `_denormalize`."""
    ata, src_norm, dst_norm = minimal_set_systems(src, dst, idx)
    return _denormalize(smallest_eigvec9_ref(ata), src_norm, dst_norm)


def solve_minimal_sets(src, dst, idx):
    """The homography of each minimal set: src, dst (N, 2) float32, idx
    (M, 4) int64 indices in [0, N) -> H (M, 3, 3) float32, the JAX
    package's `_dlt` of the four pairs with weights 1.  One K12 launch
    (`dlt4_solve_kernel`: the gather, the DLT, the Jacobi eigenvector and
    the denormalisation in one warp a set) on CUDA tensors; the plain
    version for CPU ones."""
    if src.device.type == "cpu":
        return solve_minimal_sets_ref(src, dst, idx)
    require_cuda(src, torch.float32, "src")
    require_cuda(dst, torch.float32, "dst")
    require_cuda(idx, torch.int64, "idx")
    if src.dim() != 2 or src.shape[1] != 2 or dst.shape != src.shape \
            or idx.dim() != 2 or idx.shape[1] != 4:
        raise ValueError(f"src, dst must be (N, 2) and idx (M, 4), got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(idx.shape)}")
    m = idx.shape[0]
    H = torch.empty((m, 3, 3), dtype=torch.float32, device=src.device)
    if m == 0:
        return H
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.eff_dlt4_solve(src.data_ptr(), dst.data_ptr(),
                                idx.data_ptr(), m, JACOBI_SWEEPS,
                                JACOBI_TOL, H.data_ptr(), stream_of(src))
        _build.check(rc, "dlt4_solve")
        solve_minimal_sets.launches += 1
    return H


solve_minimal_sets.launches = 0


def _inliers(H, src, dst, valid, t2: float):
    """(M, N) bool: pair n is an inlier of H[m].  Each evaluation in the
    kernels' order: p = (h0 x + h1 y) + h2 for each of the three rows, the
    divisor p_z floored at EPS_DEN in magnitude, dx = p_x / den - u,
    dy = p_y / den - v, e2 = dx dx + dy dy; an inlier when e2 <= t2, |p_z|
    is not below EPS_INF and the pair is valid."""
    h = H.reshape(-1, 9, 1)
    x, y = src[:, 0], src[:, 1]
    px = (h[:, 0] * x + h[:, 1] * y) + h[:, 2]
    py = (h[:, 3] * x + h[:, 4] * y) + h[:, 5]
    pz = (h[:, 6] * x + h[:, 7] * y) + h[:, 8]
    az = pz.abs()
    den = torch.where(az < EPS_DEN, torch.full_like(pz, EPS_DEN), pz)
    dx = px / den - dst[:, 0]
    dy = py / den - dst[:, 1]
    e2 = dx * dx + dy * dy
    return (e2 <= t2) & ~(az < EPS_INF) & valid


def score_homographies_ref(H, src, dst, valid, t2: float):
    """Plain version of `score_homographies`: the inliers of each H as an
    (M, N) mask, summed."""
    return _inliers(H, src, dst, valid, t2).sum(dim=1, dtype=torch.int32)


def _matches(src, dst, valid):
    """Check the pairs a verify kernel takes; each point is read as one
    8-byte load, so a point array that starts off an 8-byte boundary is
    copied."""
    require_cuda(src, torch.float32, "src")
    require_cuda(dst, torch.float32, "dst")
    require_cuda(valid, torch.bool, "valid")
    if src.dim() != 2 or src.shape[1] != 2 or dst.shape != src.shape \
            or valid.shape != src.shape[:1]:
        raise ValueError(f"src, dst must be (N, 2) and valid (N,), got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(valid.shape)}")
    return tuple(t.clone() if t.data_ptr() % 8 else t for t in (src, dst))


def score_homographies(H, src, dst, valid, t2: float):
    """Inliers of each hypothesis: H (M, 3, 3) float32, src, dst (N, 2)
    float32, valid (N,) bool, t2 the squared threshold (a float32 value)
    -> (M,) int32, the count of valid pairs whose forward transfer error
    under H[m] is at most sqrt(t2) (`_inliers`).  One K12 launch
    (`ransac_score_kernel`, with the scores' zeroing) on CUDA tensors; no
    (M, N) tensor exists.  The plain version for CPU ones."""
    if H.device.type == "cpu":
        return score_homographies_ref(H, src, dst, valid, t2)
    src, dst = _matches(src, dst, valid)
    require_cuda(H, torch.float32, "H")
    if H.dim() != 3 or H.shape[1:] != (3, 3):
        raise ValueError(f"H must be (M, 3, 3), got {tuple(H.shape)}")
    m = H.shape[0]
    scores = torch.empty(m, dtype=torch.int32, device=H.device)
    if m == 0:
        return scores
    lib = _build.library()
    with torch.cuda.device(H.device):
        rc = lib.eff_ransac_score(H.data_ptr(), m, src.data_ptr(),
                                  dst.data_ptr(), valid.data_ptr(),
                                  src.shape[0], t2, scores.data_ptr(),
                                  stream_of(H))
        _build.check(rc, "ransac_score")
        score_homographies.launches += 1
    return scores


score_homographies.launches = 0


def inlier_mask_ref(H, src, dst, valid, t2: float):
    """Plain version of `inlier_mask`: `_inliers` of the one H and its
    sum."""
    inl = _inliers(H[None], src, dst, valid, t2)[0]
    return inl, inl.sum(dtype=torch.int32)


def inlier_mask(H, src, dst, valid, t2: float):
    """The inliers of one homography H (3, 3) float32 among the pairs of
    src, dst (N, 2) float32 and valid (N,) bool: (mask (N,) bool, count ()
    int32), each pair as in `score_homographies`.  One K12 launch
    (`ransac_mask_kernel`, with the count's zeroing) on CUDA tensors; the
    plain version for CPU ones."""
    if H.device.type == "cpu":
        return inlier_mask_ref(H, src, dst, valid, t2)
    src, dst = _matches(src, dst, valid)
    H = H.contiguous()
    require_cuda(H, torch.float32, "H")
    if H.shape != (3, 3):
        raise ValueError(f"H must be (3, 3), got {tuple(H.shape)}")
    n = src.shape[0]
    mask = torch.empty(n, dtype=torch.bool, device=H.device)
    count = torch.empty((), dtype=torch.int32, device=H.device)
    lib = _build.library()
    with torch.cuda.device(H.device):
        rc = lib.eff_ransac_mask(H.data_ptr(), src.data_ptr(),
                                 dst.data_ptr(), valid.data_ptr(), n, t2,
                                 mask.data_ptr(), count.data_ptr(),
                                 stream_of(H))
        _build.check(rc, "ransac_mask")
        inlier_mask.launches += 1
    return mask, count


inlier_mask.launches = 0


def _normalization(pts, w):
    """Hartley normalisation of weighted points (w in {0, 1}): (s, c,
    pts_n), the scale and centroid of the similarity that moves the weighted
    point set to centroid 0 and mean distance sqrt(2), and the moved
    points."""
    wsum = w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    c = (pts * w[..., None]).sum(dim=-2) / wsum                   # (..., 2)
    d = torch.linalg.vector_norm(pts - c[..., None, :], dim=-1)
    mean_d = (d * w).sum(dim=-1) / wsum[..., 0]
    s = math.sqrt(2.0) / mean_d.clamp_min(1e-8)                   # (...,)
    return s, c, (pts - c[..., None, :]) * s[..., None, None]


def _dlt(src, dst, w):
    """Weighted normalised DLT over all rows: (N, 2) point pairs -> (3, 3)
    H, the refit.  Two design rows per correspondence, scaled by its weight;
    A^T A = R1^T R1 + R2^T R2 over the two row blocks in full float32
    (the (2N, 9) design is never formed: RANSAC's peak allocation stays a
    few MB), H the eigenvector of its smallest eigenvalue
    (`smallest_eigvec9`), denormalised as the minimal sets are
    (`_denormalize`)."""
    s, c, pts_n = _normalization(torch.stack([src, dst]), w)  # both sides
    x, y = pts_n[0, :, 0], pts_n[0, :, 1]
    u, v = pts_n[1, :, 0], pts_n[1, :, 1]
    z = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, z, z, z, -u * x, -u * y, -u],
                     dim=-1).mul_(w[..., None])
    r2 = torch.stack([z, z, z, x, y, one, -v * x, -v * y, -v],
                     dim=-1).mul_(w[..., None])
    with full_f32_matmul():
        AtA = r1.T @ r1 + r2.T @ r2                               # (9, 9)
    return _denormalize(smallest_eigvec9(AtA), (s[0], c[0, 0], c[0, 1]),
                        (s[1], c[1, 0], c[1, 1]))


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
    n_inliers int32), all on the inputs' device, with no host read: on the
    card K12's solve and score kernels run back to back, then `argmax`,
    then the winner's mask, the refit and its mask."""
    t2 = float(np.float32(thresh) * np.float32(thresh))
    src, dst, valid = src.contiguous(), dst.contiguous(), valid.contiguous()
    with span("ransac.solve_score"):
        H = solve_minimal_sets(src, dst, idx)
        scores = score_homographies(H, src, dst, valid, t2)
        bi = torch.argmax(scores).reshape(1)    # the first maximum
        H_best = H.index_select(0, bi)[0]
        best_inl, best_score = inlier_mask(H_best, src, dst, valid, t2)
    # one weighted refit on the winner's inliers; keep the minimal-set
    # estimate when the refit is worse or the winner has < 4 inliers
    with span("ransac.refit"):
        H_ref = _dlt(src, dst, best_inl.to(src.dtype))
        inl_ref, n_ref = inlier_mask(H_ref, src, dst, valid, t2)
        better = (n_ref >= best_score) & (best_score >= 4)
        return (torch.where(better, H_ref, H_best),
                torch.where(better, inl_ref, best_inl),
                torch.where(better, n_ref, best_score))


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
    cv::findHomography ransacReprojThreshold convention).  Spans:
    `eff/ops.find_homography_ransac` around the call, and inside it
    `eff/ransac.draw`, `eff/ransac.solve_score` and `eff/ransac.refit`.
    """
    with span("ops.find_homography_ransac"):
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
        with span("ransac.draw"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            idx = _draw_minimal_sets(valid, iters, gen)
        return _ransac_from_indices(src, dst, valid, thresh, idx)
