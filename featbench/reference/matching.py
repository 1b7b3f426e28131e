"""Plain reference of the best-2 Hamming search, Lowe's ratio test and the
cross check, on compacted descriptor lists.

Distances come from a float32 product of +-1 rows (exact: the sums are
integers below 2^24) with TF32 off; ties go to the lowest index, for the
best match, the second-best distance and the cross check alike.
"""
from __future__ import annotations

import contextlib

import torch

CHUNK = 1 << 26          # distance entries per block of query rows


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32 (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _pm1(desc: torch.Tensor) -> torch.Tensor:
    n, b = desc.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(n, 8 * b).to(torch.float32) * 2 - 1


def best2(q: torch.Tensor, t: torch.Tensor):
    """(j, best, second) per query row: the lowest-index nearest train row,
    its distance and the smallest distance of the other rows."""
    nbits = q.shape[1] * 8
    tp = _pm1(t)
    out = ([], [], [])
    step = max(1, CHUNK // max(1, t.shape[0]))
    with full_f32():
        for r0 in range(0, q.shape[0], step):
            d = ((nbits - _pm1(q[r0:r0 + step]) @ tp.T) * 0.5).to(torch.int32)
            j = torch.argmin(d, dim=1, keepdim=True)
            out[0].append(j[:, 0])
            out[1].append(d.gather(1, j)[:, 0])
            out[2].append(d.scatter(1, j, 2 ** 31 - 1).amin(dim=1))
    return tuple(torch.cat(v) for v in out)


def ratio_cross_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                        max_ratio: float):
    """(i, j) index pairs of desc1 -> desc2 that pass the ratio test
    best <= max_ratio * second (float32) and the cross check (i is j's
    best in reverse)."""
    if desc1.shape[0] == 0 or desc2.shape[0] < 2:
        e = torch.zeros(0, dtype=torch.int64, device=desc1.device)
        return e, e
    j, best, second = best2(desc1, desc2)
    back, _, _ = best2(desc2, desc1)
    i = torch.arange(desc1.shape[0], device=desc1.device)
    ok = (best.to(torch.float32) <= max_ratio * second.to(torch.float32)) \
        & (back[j] == i)
    return i[ok], j[ok]
