"""Keypoint detection ops: dense FAST-9, integer Harris, radius NMS, top-k.

Port of `efficient_features_tpu/ops/detect.py`.  These dense functions are the
plain versions behind the cells kernel (`ops/detect_kernels.py`) and the dense
tie fallback of `select_topk_cells`.  Every output is exact (integers, or
float math whose products are exact), so selection is bit-identical to the
JAX package on any device.

Top-k differs in mechanism only: `torch.topk` is not stable, so selection
uses stable sorts that break ties to the lowest flat index, as
`jax.lax.top_k` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import semantics as S

RESP_SENTINEL = float("-inf")
INT32_MAX = 2147483647
# Harris window scale squared, rounded to f32 once (the cells kernel takes it
# as an argument, so both compute s2 * sum in f32 from the same value)
HARRIS_S2 = np.float32(S.HARRIS_SCALE) * np.float32(S.HARRIS_SCALE)


def _shift2d(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx], `fill`-padded (any shift magnitude)."""
    h, w = a.shape
    out = torch.full_like(a, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        a[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    """True on [b, h-b) x [b, w-b)."""
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[b:h - b, b:w - b] = True
    return m


# ---------------------------------------------------------------------------
# FAST-9 (cuda_fast.cu:42-222): dense bitmask formulation
# ---------------------------------------------------------------------------


def fast_corner_mask(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """Dense FAST-9 corner map (bool).  The circle masks are int32: torch's
    uint16 operator coverage is thin, and 16 bits fit with room to spare."""
    v = img.to(torch.int32)
    hi = v + int(threshold)
    lo = v - int(threshold)
    brighter = torch.zeros_like(v)
    darker = torch.zeros_like(v)
    for bit, (dy, dx) in enumerate(S.FAST_CIRCLE):
        sh = _shift2d(v, int(dy), int(dx), 0)
        brighter |= (sh > hi).to(torch.int32) << bit
        darker |= (sh < lo).to(torch.int32) << bit

    def any_run9(m):
        acc = m
        for s in range(1, S.FAST_ARC_LEN):
            acc = acc & (((m >> s) | (m << (16 - s))) & 0xFFFF)
        return acc != 0

    corner = any_run9(brighter) | any_run9(darker)
    h, w = img.shape
    if h <= 6 or w <= 6:
        return torch.zeros_like(corner)
    return corner & border_mask(h, w, 3, img.device)


# ---------------------------------------------------------------------------
# Harris response (cuda_efficient_features.cu:99-139)
# ---------------------------------------------------------------------------
# Exact-integer Sobel + 7x7 window sums (int32), then f32 math whose operand
# significands are truncated so every multiply is exact: an exact product is
# the same whether or not a compiler contracts it into an FMA.


def _trunc_mantissa(x: torch.Tensor, drop_bits: int) -> torch.Tensor:
    return (x.view(torch.int32) & ~((1 << drop_bits) - 1)).view(torch.float32)


def harris_response(img: torch.Tensor) -> torch.Tensor:
    """Dense float32 Harris response (k = 3/64, truncated mantissas)."""
    a = img.to(torch.int32)

    def sh(dy, dx):
        return _shift2d(a, dy, dx, 0)

    dx = ((sh(1, 1) + 2 * sh(0, 1) + sh(-1, 1))
          - (sh(1, -1) + 2 * sh(0, -1) + sh(-1, -1)))
    dy = ((sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)))

    def box7(m):
        rows = sum(_shift2d(m, 0, d, 0) for d in range(-3, 4))
        return sum(_shift2d(rows, d, 0, 0) for d in range(-3, 4))

    s2 = float(HARRIS_S2)
    sxx = _trunc_mantissa(s2 * box7(dx * dx).to(torch.float32), 12)
    sxy = _trunc_mantissa(s2 * box7(dx * dy).to(torch.float32), 12)
    syy = _trunc_mantissa(s2 * box7(dy * dy).to(torch.float32), 12)
    tr = _trunc_mantissa(sxx + syy, 13)
    det = sxx * syy - sxy * sxy
    return det - S.HARRIS_K * (tr * tr)


# ---------------------------------------------------------------------------
# Radius NMS (deterministic disc max-filter; ties co-survive)
# ---------------------------------------------------------------------------


def radius_nms(resp: torch.Tensor, corner: torch.Tensor,
               radius: int) -> torch.Tensor:
    """Survivor mask: corner & (resp >= max over the open disc).  Per-dy
    centered row max-filters from power-of-2 running maxima; float max is
    order-free, so any decomposition is bit-identical."""
    masked = torch.where(corner, resp, RESP_SENTINEL)
    h, w = masked.shape
    padded = torch.full((h, w + 2 * radius), RESP_SENTINEL,
                        dtype=masked.dtype, device=masked.device)
    padded[:, radius:radius + w] = masked

    def shx(arr, k):
        return _shift2d(arr, 0, k, RESP_SENTINEL)

    pows = {1: padded}
    p = 1
    while 2 * p <= 2 * radius + 1:
        pows[2 * p] = torch.maximum(pows[p], shx(pows[p], p))
        p *= 2

    def centered_rowmax(wdx: int) -> torch.Tensor:
        width = 2 * wdx + 1
        k = 1
        while k * 2 <= width:
            k *= 2
        left = pows[k]
        if k != width:
            left = torch.maximum(left, shx(pows[k], width - k))
        return left[:, radius - wdx:radius - wdx + w]

    disc_max = torch.full_like(masked, RESP_SENTINEL)
    by_width: dict[int, list[int]] = {}
    for dy, wdx in S.disc_row_extents(radius):
        by_width.setdefault(wdx, []).append(dy)
    for wdx, dys in by_width.items():
        rm = centered_rowmax(wdx)
        for dy in dys:
            disc_max = torch.maximum(disc_max,
                                     _shift2d(rm, dy, 0, RESP_SENTINEL))
    return corner & (masked >= disc_max)


# ---------------------------------------------------------------------------
# Fixed-shape top-k selection
# ---------------------------------------------------------------------------


def canonical_zero(v: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0, so mixed-sign zero ties order by index on every path."""
    return torch.where(v == 0, torch.zeros_like(v), v)


def topk_stable(values: torch.Tensor, k: int):
    """Top `k` of a 1-D float tensor by (value desc, index asc), like
    `jax.lax.top_k`.  Returns (values, int32 indices)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def _slots(vals, idx, w):
    valid = vals != RESP_SENTINEL
    zero = torch.zeros_like(idx)
    ys = torch.where(valid, idx // w, zero)
    xs = torch.where(valid, idx % w, zero)
    return ys, xs, torch.where(valid, vals, torch.zeros_like(vals)), valid


def select_topk(resp: torch.Tensor, survivor: torch.Tensor, quota: int,
                nms_radius: int | None = None):
    """Top `quota` survivors by (response desc, flat index asc).

    Returns fixed-shape (quota,) ys, xs (int32), resp (f32; 0 where invalid)
    and valid (bool): one stable sort of the whole map.  `nms_radius` is the
    JAX function's argument, which there picks an 8x8-reduced or a chunked
    two-stage branch; both are exact, so it does not change the selection
    here.  Ported as such, the branches made every path measured on the
    H100 slower end to end, and two of them need a host read."""
    h, w = resp.shape
    masked = torch.where(survivor, canonical_zero(resp), RESP_SENTINEL)
    vals, idx = topk_stable(masked.reshape(-1), min(quota, h * w))
    return _slots(vals, idx, w)


def select_topk_cells(cellmax, cellrow, cellcnt, h, w, quota,
                      dense_fallback):
    """Exact top-`quota` selection from `fast_harris_nms_cells` outputs.

    Combines the (ceil(h/8), >= w) 8-row cells into 8x8 blocks (at most one
    untied survivor per block for nonmax_radius >= 10) and sorts the block
    winners by (value desc, global index asc).  When a block holds tied
    co-survivors (count > 1) the merge would drop one, so
    `dense_fallback()` supplies the exact dense (vals, flat_idx) instead.
    Deciding that reads one flag from the device: a host sync per call.
    `select_topk_cells.fallbacks` counts the calls that took the fallback."""
    n = h * w
    quota = min(quota, n)
    cm = canonical_zero(cellmax[:, :w])
    cr = cellrow[:, :w]
    cc = cellcnt[:, :w]
    h8 = cm.shape[0]
    w8 = -(-w // 8)
    padc = w8 * 8 - w
    if padc:
        cm = torch.nn.functional.pad(cm, (0, padc), value=RESP_SENTINEL)
        cr = torch.nn.functional.pad(cr, (0, padc), value=INT32_MAX)
        cc = torch.nn.functional.pad(cc, (0, padc))
    b_m = cm.reshape(h8, w8, 8)
    alive = b_m != RESP_SENTINEL
    bmax = b_m.amax(dim=2)
    counts = cc.reshape(h8, w8, 8).sum(dim=2)
    cols = torch.arange(w8 * 8, dtype=torch.int32,
                        device=cm.device).reshape(1, w8, 8)
    rows = torch.where(alive, cr.reshape(h8, w8, 8), 0)
    dead = torch.full_like(rows, n)
    g3 = torch.where(alive, rows * w + cols, dead)
    cand = (b_m == bmax[..., None]) & alive
    bidx = torch.where(cand, g3, dead).amin(dim=2)

    if bool((counts > 1).any()):
        select_topk_cells.fallbacks += 1
        vals, idx = dense_fallback()
        return _slots(vals, idx, w)
    # two-key sort: stable by index, then stable by value desc
    bv = bmax.reshape(-1)
    bi = bidx.reshape(-1)
    order = torch.sort(bi, stable=True).indices
    order = order[torch.sort(bv[order], descending=True, stable=True).indices]
    kq = min(quota, bv.shape[0])
    vals = bv[order[:kq]]
    idx = bi[order[:kq]]
    if kq < quota:
        vals = torch.nn.functional.pad(vals, (0, quota - kq),
                                       value=RESP_SENTINEL)
        idx = torch.nn.functional.pad(idx, (0, quota - kq))
    return _slots(vals, idx, w)


select_topk_cells.fallbacks = 0
