"""Hamming brute-force matcher: best-2 search with a Hopper kernel (K6).

Port of `efficient_features_tpu/ops/matcher.py` (cv::BFMatcher(NORM_HAMMING)
with cross check, and the knn-2 ratio test of sample_image_sequence.cpp:
114-144).  Every public function reduces to `knn2_topk2`: for each query
row, the lowest-index nearest train row, its distance and the second
smallest distance.  A CPU tensor runs the plain version `knn2_topk2_ref`;
a CUDA tensor launches K6 (csrc/knn2_hamming.cu: the 1-bit tensor-core
product popc(q & t) over (query strip, train split) blocks, a packed-key
best-2 fold in registers, then a merge of the splits), once forward for
the best-2 and once in reverse (roles and masks swapped) for the cross
check.  `knn2_plan` chooses the split; `knn2_split_merge_ref` is the plain
form of the kernel's key and merge rules, for the tests.
The tensor's device picks the route: the JAX package's `fused=` keyword,
`EFF_TPU_FUSED_MATCH` and `EFF_TPU_MATCH_QB` have no counterpart.

Ties go to the lowest index everywhere (best match, second-best distance,
reverse cross check), as `jnp.argmin` and `jax.lax.top_k` do.  The plain
version uses `torch.argmin` (documented first occurrence) and never
`torch.topk`, which orders ties arbitrarily.

Masked sentinel: a pair with an invalid side has distance `1 << 30`, the
convention of the JAX package's dense path.  A query row with no valid pair
therefore gives `j = 0`, `best = 1 << 30`, `ok = False`, in the kernel and
the plain version alike; on every row this equals the JAX dense path.  The
JAX fused path uses mask-penalty dots instead, so it agrees with the port on
`ok` and on `(j, best)` where `ok` holds.

Dtypes as in the JAX package: indices and distances int32, masks bool.
"""
from __future__ import annotations

import torch

from .. import _build
from .detect_kernels import require_cuda, stream_of
from .hash_sift import full_f32_matmul
from ..utils.profiler import span

BIG = 1 << 30                 # distance of a pair with an invalid side
INT32_MAX = 2147483647        # second-best of a single train row
KERNEL_BYTES = (32, 64)       # descriptor widths K6 takes (256, 512 bits)
KERNEL_TILE = 128             # K6: query rows per block, train rows per tile
KERNEL_BLOCKS = 16 * 132      # K6: blocks aimed at, 16 per SM of an H100
KERNEL_MIN_TILES = 4          # K6: fewest train tiles in a split
KERNEL_MAX_SPLIT = 1 << 16    # K6: a split's columns fit the key's low half
KEY_INVALID = 1 << 14         # K6: high half of an invalid column's key
_CHUNK_ELEMS = 1 << 26        # plain version: distance entries per chunk


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(N, B) uint8 -> (N, 8B) float32 +-1, MSB-first (bit 7 of byte 0
    first)."""
    n, b = desc.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(n, 8 * b).to(torch.float32) * 2 - 1


def _hamming_pm1(a: torch.Tensor, b: torch.Tensor, nbits: int):
    """Hamming distances from +-1 rows: (nbits - a . b) / 2.  The products
    are +-1 and their f32 sums exact, so this is exact integer math."""
    with full_f32_matmul():
        dot = a @ b.T
    return ((nbits - dot) * 0.5).to(torch.int32)


def hamming_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 Hamming distances between packed binary descriptors."""
    nbits = desc1.shape[1] * 8
    return _hamming_pm1(unpack_bits_pm1(desc1), unpack_bits_pm1(desc2), nbits)


def _check_pair(desc_q: torch.Tensor, desc_t: torch.Tensor) -> None:
    for name, d in (("desc_q", desc_q), ("desc_t", desc_t)):
        if d.dim() != 2 or d.dtype != torch.uint8:
            raise ValueError(f"{name} must be a 2-D uint8 tensor, got "
                             f"{d.dtype} {tuple(d.shape)}")
    if desc_q.shape[1] != desc_t.shape[1]:
        raise ValueError(f"descriptor widths differ: {desc_q.shape[1]} vs "
                         f"{desc_t.shape[1]} bytes")
    if desc_t.shape[0] < 1:
        raise ValueError("need at least one train descriptor")


def knn2_topk2_ref(desc_q: torch.Tensor, valid_q: torch.Tensor | None,
                   desc_t: torch.Tensor, valid_t: torch.Tensor | None):
    """Plain version of K6: (best_idx i32, best i32, second i32) per query
    row.  A pair with an invalid side (mask False) has distance 1 << 30;
    with a single train row, second is INT32_MAX.  Chunked over query rows
    so that the (chunk, n_t) distance block stays near 256 MB."""
    _check_pair(desc_q, desc_t)
    n1, n2 = desc_q.shape[0], desc_t.shape[0]
    nbits = desc_q.shape[1] * 8
    dev = desc_q.device
    idx = torch.empty(n1, dtype=torch.int32, device=dev)
    best = torch.empty(n1, dtype=torch.int32, device=dev)
    second = torch.empty(n1, dtype=torch.int32, device=dev)
    bt = unpack_bits_pm1(desc_t)
    step = max(1, _CHUNK_ELEMS // n2)
    for r0 in range(0, n1, step):
        r1 = min(r0 + step, n1)
        d = _hamming_pm1(unpack_bits_pm1(desc_q[r0:r1]), bt, nbits)
        if valid_q is not None or valid_t is not None:
            ok = torch.ones_like(d, dtype=torch.bool)
            if valid_q is not None:
                ok &= valid_q[r0:r1, None].to(torch.bool)
            if valid_t is not None:
                ok &= valid_t[None, :].to(torch.bool)
            d = torch.where(ok, d, BIG)
        j = torch.argmin(d, dim=1, keepdim=True)
        best[r0:r1] = d.gather(1, j)[:, 0]
        second[r0:r1] = d.scatter(1, j, INT32_MAX).amin(dim=1)
        idx[r0:r1] = j[:, 0].to(torch.int32)
    return idx, best, second


def knn2_plan(n1: int, n2: int) -> tuple[int, int]:
    """(split_len, scratch_len) of a K6 call.  The grid is (query strips
    of KERNEL_TILE rows, train splits of split_len rows); the split is cut
    so that about KERNEL_BLOCKS blocks exist whatever the shape, each
    with at least KERNEL_MIN_TILES tiles, and holds at most
    KERNEL_MAX_SPLIT rows.  scratch_len counts the int32 entries of the
    key constants, the query popcounts and the per-split partial results
    (csrc/eff_kernels.h)."""
    strips = -(-n1 // KERNEL_TILE)
    tiles = -(-n2 // KERNEL_TILE)
    want = max(1, -(-KERNEL_BLOCKS // strips))
    per_split = max(-(-tiles // want), min(KERNEL_MIN_TILES, tiles))
    per_split = min(per_split, KERNEL_MAX_SPLIT // KERNEL_TILE)
    split_len = per_split * KERNEL_TILE
    splits = -(-n2 // split_len)
    return split_len, (tiles * KERNEL_TILE + -(-n1 // 4) * 4
                       + 3 * splits * n1)


def knn2_split_merge_ref(desc_q: torch.Tensor, valid_q: torch.Tensor | None,
                         desc_t: torch.Tensor, valid_t: torch.Tensor | None,
                         split_len: int):
    """K6's rules in plain torch, for the tests: per split of `split_len`
    train rows the two smallest keys
        key = ((popc(t) - 2 popc(q & t)) << 16) + column in the split,
    an invalid column keyed (KEY_INVALID << 16) + column and a missing one
    INT32_MAX; the keys decoded to (distance, index, second distance); the
    splits merged in ascending order, a strictly smaller distance winning;
    then the query mask.  Equals `knn2_topk2_ref`."""
    _check_pair(desc_q, desc_t)
    n1, n2 = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    bq = (unpack_bits_pm1(desc_q) > 0).to(torch.float32)
    bt = (unpack_bits_pm1(desc_t) > 0).to(torch.float32)
    pq = bq.sum(dim=1).to(torch.int64)
    best = torch.full((n1,), INT32_MAX, dtype=torch.int64, device=dev)
    second = best.clone()
    idx = torch.zeros(n1, dtype=torch.int64, device=dev)
    for c0 in range(0, n2, split_len):
        c1 = min(c0 + split_len, n2)
        with full_f32_matmul():
            acc = (bq @ bt[c0:c1].T).to(torch.int64)
        high = bt[c0:c1].sum(dim=1).to(torch.int64)
        if valid_t is not None:
            high = torch.where(valid_t[c0:c1].to(torch.bool), high,
                               KEY_INVALID)
        col = torch.arange(c1 - c0, dtype=torch.int64, device=dev)
        key = (-2 << 16) * acc + ((high << 16) + col)[None, :]
        none = torch.full((n1, 1), INT32_MAX, dtype=torch.int64, device=dev)
        two = torch.sort(torch.cat([key, none], dim=1), dim=1).values[:, :2]
        kb, ks = two[:, 0], two[:, 1]
        be, se = kb >> 16, ks >> 16
        bvalid = be < (KEY_INVALID >> 1)
        d = torch.where(bvalid, pq + be, BIG)
        j = torch.where(bvalid, c0 + (kb & 0xffff), 0)
        d2 = torch.where(se >= 3 * (KEY_INVALID >> 1), INT32_MAX,
                         torch.where(se >= (KEY_INVALID >> 1), BIG, pq + se))
        wins = d < best
        second = torch.where(wins, torch.minimum(best, d2),
                             torch.minimum(second, d))
        idx = torch.where(wins, j, idx)
        best = torch.where(wins, d, best)
    if valid_q is not None:
        dead = ~valid_q.to(torch.bool)
        best = torch.where(dead, BIG, best)
        second = torch.where(dead, BIG if n2 >= 2 else INT32_MAX, second)
    idx = torch.where(best == BIG, 0, idx)
    return tuple(v.to(torch.int32) for v in (idx, best, second))


def knn2_topk2(desc_q: torch.Tensor, valid_q: torch.Tensor | None,
               desc_t: torch.Tensor, valid_t: torch.Tensor | None):
    """Streaming best-2 Hamming search: (best_idx i32, best i32, second
    i32) per query row, see `knn2_topk2_ref`.  A CUDA tensor launches K6
    (256- or 512-bit descriptors): its three kernels in one call, the
    distances on the tensor cores; `.launches` counts calls."""
    if desc_q.device.type == "cpu":
        return knn2_topk2_ref(desc_q, valid_q, desc_t, valid_t)
    _check_pair(desc_q, desc_t)
    require_cuda(desc_q, torch.uint8, "desc_q")
    require_cuda(desc_t, torch.uint8, "desc_t")
    nbytes = desc_q.shape[1]
    if nbytes not in KERNEL_BYTES:
        raise ValueError(f"K6 takes 256- or 512-bit descriptors, got "
                         f"{8 * nbytes} bits")
    if desc_q.data_ptr() % 16 or desc_t.data_ptr() % 16:
        raise ValueError("descriptors must be 16-byte aligned (K6 reads "
                         "rows as 16-byte words)")
    dev = desc_q.device
    if desc_t.device != dev:
        raise ValueError(f"desc_t is on {desc_t.device}, desc_q on {dev}")
    n1, n2 = desc_q.shape[0], desc_t.shape[0]
    masks = []
    for name, v, n in (("valid_q", valid_q, n1), ("valid_t", valid_t, n2)):
        if v is None:
            masks.append(None)
            continue
        if v.shape != (n,) or v.device != dev:
            raise ValueError(f"{name} must be ({n},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
        masks.append(v.to(torch.uint8).contiguous())
    out = [torch.empty(n1, dtype=torch.int32, device=dev) for _ in range(3)]
    if n1 == 0:
        return tuple(out)
    vq, vt = (None if m is None else m.data_ptr() for m in masks)
    split_len, scratch_len = knn2_plan(n1, n2)
    scratch = torch.empty(scratch_len, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.eff_knn2_hamming(desc_q.data_ptr(), vq, n1,
                                  desc_t.data_ptr(), vt, n2, nbytes,
                                  split_len, scratch.data_ptr(),
                                  *(t.data_ptr() for t in out),
                                  stream_of(desc_q))
        _build.check(rc, "knn2_topk2")
        knn2_topk2.launches += 1
    return tuple(out)


knn2_topk2.launches = 0


def _cross_ok(j: torch.Tensor, i_back: torch.Tensor) -> torch.Tensor:
    """i is j's best in reverse too (BFMatcher crossCheck)."""
    rows = torch.arange(j.shape[0], dtype=torch.int32, device=j.device)
    return i_back[j.long()] == rows


def _ratio_ok(best, second, max_ratio: float) -> torch.Tensor:
    """Lowe's test in f32, as `matcher.py:109` of the JAX package."""
    return best.to(torch.float32) <= max_ratio * second.to(torch.float32)


def _empty(desc1: torch.Tensor):
    dev = desc1.device
    return (torch.empty(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.bool, device=dev))


def match(desc1: torch.Tensor, desc2: torch.Tensor, cross_check: bool = True):
    """Best match per query: (train_idx i32, distance i32, valid bool).

    cross_check keeps (i, j) only if i is also j's best (BFMatcher
    crossCheck semantics, sample_feature_matching.cpp:99)."""
    _check_pair(desc1, desc2)
    if desc1.shape[0] == 0:
        return _empty(desc1)
    j, dist, _ = knn2_topk2(desc1, None, desc2, None)
    if cross_check:
        i_back, _, _ = knn2_topk2(desc2, None, desc1, None)
        valid = _cross_ok(j, i_back)
    else:
        valid = torch.ones(desc1.shape[0], dtype=torch.bool,
                           device=desc1.device)
    return j, dist, valid


def _need_two(desc2: torch.Tensor) -> None:
    if desc2.shape[0] < 2:
        raise ValueError(f"the knn-2 ratio test needs at least 2 train "
                         f"descriptors, got {desc2.shape[0]}")


def knn2_ratio_match(desc1: torch.Tensor, desc2: torch.Tensor,
                     max_ratio: float = 0.8):
    """Lowe ratio test on the best-2 neighbours + cross check
    (sample_image_sequence.cpp:114-144): (j i32, best i32, ok bool)."""
    _check_pair(desc1, desc2)
    _need_two(desc2)
    if desc1.shape[0] == 0:
        return _empty(desc1)
    j, best, second = knn2_topk2(desc1, None, desc2, None)
    i_back, _, _ = knn2_topk2(desc2, None, desc1, None)
    return j, best, _ratio_ok(best, second, max_ratio) & _cross_ok(j, i_back)


def knn2_ratio_match_masked(desc1: torch.Tensor, valid1: torch.Tensor,
                            desc2: torch.Tensor, valid2: torch.Tensor,
                            max_ratio: float = 0.8):
    """`knn2_ratio_match` over fixed-capacity descriptor slot arrays with
    validity masks, so a streaming pipeline chains detect, describe and
    match on the device without reading anything back.  Pairs with an
    invalid side are at distance 1 << 30 (see the module docstring); `ok`
    also requires a valid query with a valid best pair.  Span:
    `eff/ops.knn2_ratio_match_masked`."""
    with span("ops.knn2_ratio_match_masked"):
        _check_pair(desc1, desc2)
        _need_two(desc2)
        if desc1.shape[0] == 0:
            return _empty(desc1)
        j, best, second = knn2_topk2(desc1, valid1, desc2, valid2)
        i_back, _, _ = knn2_topk2(desc2, valid2, desc1, valid1)
        ok = (_ratio_ok(best, second, max_ratio) & _cross_ok(j, i_back)
              & valid1.to(torch.bool) & (best < BIG))
        return j, best, ok
