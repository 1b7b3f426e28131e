"""Keypoint detection ops: dense FAST-9, integer Harris, radius NMS, top-k.

Port of `efficient_features_tpu/ops/detect.py`.  These dense functions are the
plain versions behind the detect kernels (`ops/detect_kernels.py`).  Every
output is exact (integers, or float math whose products are exact), so
selection is bit-identical to the JAX package on any device.

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


def select_topk(resp: torch.Tensor, survivor: torch.Tensor, quota: int):
    """Top `quota` survivors by (response desc, flat index asc).

    Returns fixed-shape (quota,) ys, xs (int32), resp (f32; 0 where invalid)
    and valid (bool): one stable sort of the whole map.  The JAX function
    picks an 8x8-reduced or a chunked two-stage branch by its radius and
    shape; both are exact, so the selection is the same.  Ported as such,
    the branches made every path measured on the H100 slower end to end,
    and two of them need a host read."""
    h, w = resp.shape
    masked = torch.where(survivor, canonical_zero(resp), RESP_SENTINEL)
    vals, idx = topk_stable(masked.reshape(-1), min(quota, h * w))
    return _slots(vals, idx, w)


def _desc_key(v: torch.Tensor) -> torch.Tensor:
    """int64 keys whose ascending order is float32 `v` descending (no NaN),
    in the high 32 bits: an index added below them breaks ties."""
    b = v.view(torch.int32).to(torch.int64)
    ascending = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return (-ascending - 1) * (1 << 32)


def _transpose8(cols: torch.Tensor) -> torch.Tensor:
    """(n, 8) uint8 -> (n, 8) uint8: the 8x8 bit matrix of each row,
    transposed (bit k of byte c becomes bit c of byte k), by three masked
    swaps of one 64-bit word (Hacker's Delight, `transpose8`)."""
    x = cols.contiguous().view(torch.int64)
    for shift, mask in ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                        (28, 0x00000000F0F0F0F0)):
        t = (x ^ (x >> shift)) & mask
        x = x ^ t ^ (t << shift)
    return x.view(torch.uint8)


_BYTE_TABLES: dict = {}


def _byte_tables(device: torch.device):
    """(popcount (256,), position of the r-th set bit (256 * 8,)) int64
    tables on `device`, made once per device: a copy per call would sync
    the host."""
    if device not in _BYTE_TABLES:
        pop = [bin(b).count("1") for b in range(256)]
        sel = [[c for c in range(8) if b >> c & 1] for b in range(256)]
        _BYTE_TABLES[device] = (
            torch.tensor(pop, dtype=torch.int64, device=device),
            torch.tensor([r + [0] * (8 - len(r)) for r in sel],
                         dtype=torch.int64, device=device).reshape(-1))
    return _BYTE_TABLES[device]


def select_topk_cells(cellmax, cellrow, cellbits, h, w, quota):
    """Exact top-`quota` selection from `fast_harris_nms_cells` outputs at
    nonmax_radius >= 10, with fixed shapes and no host read.

    The (ceil(h/8), >= w) 8-row cells combine into 8x8 blocks.  At radius
    >= 10 any two pixels of a block lie inside each other's disc, so the
    survivors of a block all carry its value; the block's winner is its
    smallest survivor index.  Sorting the winners by (value desc, index
    asc) and keeping the first min(quota, blocks) keeps every survivor of
    the top `quota`: a block further back has that many winners ahead of
    all its survivors.  The kept blocks split into their 8 row segments,
    keyed (value, first column's index), each with its byte of survivors
    (`cellbits` transposed); segments never interleave in flat-index
    order, so after one sort of the segments output slot j falls in the
    segment where the running survivor count passes j, at the matching set
    bit of its byte.  The JAX package instead takes a dense fallback when a
    block holds tied co-survivors (`lax.cond`); the slots are the same."""
    n = h * w
    quota = min(quota, n)
    dev = cellmax.device
    cm = canonical_zero(cellmax[:, :w])
    cr = cellrow[:, :w]
    cb = cellbits[:, :w]
    h8 = cm.shape[0]
    w8 = -(-w // 8)
    padc = w8 * 8 - w
    if padc:
        cm = torch.nn.functional.pad(cm, (0, padc), value=RESP_SENTINEL)
        cr = torch.nn.functional.pad(cr, (0, padc), value=INT32_MAX)
        cb = torch.nn.functional.pad(cb, (0, padc))
    b_m = cm.reshape(h8, w8, 8)
    alive = b_m != RESP_SENTINEL
    bmax = b_m.amax(dim=2).reshape(-1)
    cols = torch.arange(w8 * 8, dtype=torch.int32, device=dev).reshape(
        1, w8, 8)
    rows = torch.where(alive, cr.reshape(h8, w8, 8), 0)
    dead = torch.full_like(rows, n)
    g3 = torch.where(alive, rows * w + cols, dead)
    cand = (b_m == bmax.reshape(h8, w8, 1)) & alive
    bidx = torch.where(cand, g3, dead).amin(dim=2).reshape(-1)

    # the blocks: (value desc, winner index asc); dead blocks tie at the end
    kq = min(quota, bmax.shape[0])
    kept = torch.sort(_desc_key(bmax) + bidx.to(torch.int64),
                      stable=True).indices[:kq]
    # their row segments, (value desc, start asc), each a byte of columns
    k8 = torch.arange(8, dtype=torch.int64, device=dev)
    start = ((kept // w8 * 8)[:, None] + k8) * w + (kept % w8 * 8)[:, None]
    value = bmax[kept]
    order = torch.sort((_desc_key(value)[:, None] + start).reshape(-1)
                       ).indices
    segbits = _transpose8(cb.reshape(h8 * w8, 8)[kept]).reshape(-1)[
        order].to(torch.int64)
    start = start.reshape(-1)[order]
    value = value[order // 8]
    # output slot j: the segment whose survivors span it, and its set bit
    pop, select = _byte_tables(dev)
    count = pop[segbits]
    end = torch.cumsum(count, 0)
    j = torch.arange(quota, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(end, j, right=True)
    valid = seg < end.shape[0]
    seg = seg.clamp(max=end.shape[0] - 1)
    rank = (j - end[seg] + count[seg]).clamp(0, 7)
    col = select[segbits[seg] * 8 + rank]
    vals = torch.where(valid, value[seg], RESP_SENTINEL)
    idx = torch.where(valid, start[seg] + col, 0).to(torch.int32)
    return _slots(vals, idx, w)
