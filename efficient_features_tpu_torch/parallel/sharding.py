"""Batched and multi-GPU pipelines over `torch.distributed`.

Counterpart of `efficient_features_tpu/parallel/sharding.py`.  A JAX `Mesh`
with `shard_map` becomes SPMD processes: every rank of a `Mesh` calls the
same function with the same arguments (the whole input), works on its own
shard on the device its tensors are on, and gets back what the
single-device call returns for the whole input.

  dp (batch): `detect_and_compute_batch(images, cfg, mesh)`: each rank
      its frames (`shard_batch`), one after the other, then an all-gather.
      Without a mesh, every frame on the images' device; on a card, each
      frame a replay of one captured graph (`graphs.py`), its results in
      row i of one (B, block) tensor (`batch_block`).
  keypoints: `compute_sharded`: each rank a slice of the keypoints.
  match: `knn2_match_sharded`: each rank a slice of the queries against
      every train row, and a slice of the train rows for the cross check,
      through K6 both ways.
  sp (rows): `detect_rows_sharded` (one level) and
      `detect_pyramid_rows_sharded` (the whole pyramid, with descriptors
      and an ROI mask optional): each rank owns a band of rows of every
      level.  A band is resized from the band below plus halo rows of its
      neighbours (K10 with the band's slice of the level's row table), its
      corners found on the band plus a halo (K8, then the global border
      and ROI rows, then K9), its angles taken there (K2), and the
      candidates merged into the level's quota by an all-gather and the
      single-device order: response descending, then flat index ascending.
      Descriptors are computed by the band that owns a keypoint, on its
      blurred window of the level, with the window's origin in the level
      (K3, K4 + K5 or K11), and the disjoint rows summed.
  dp x sp: `detect_and_compute_batch_2d` on a `make_mesh_2d` mesh.

The collectives (`all_gather`, `all_reduce_sum`, and the halo exchange,
one all-gather of each band's edge rows) move tensors by the rule of the
group's backend: NCCL takes the CUDA tensors as they are, gloo takes CPU
tensors, so a CUDA tensor goes to the host and back.  Nothing switches
route on a failure.

The halo of the band detect is wider than the JAX package's (`_halo_rows`,
max(24, radius + 4)): K8, like every detect kernel, drops corners within
15 px of its array's edges, so the halo is at least radius + 15, and those
rows never reach an owned pixel's disc.  The JAX package's check on the
band height (`_pyramid_plan`) is kept as it is: the exchange takes rows
from as many bands as the halo spans.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import graphs as G
from .. import pipeline as P
from ..ops import detect as OD
from ..ops import detect_kernels as DK
from ..ops import image as OI
from ..ops import matcher as OM
from ..ops import window_kernels as WK
from ..utils import semantics as S
from ..utils.profiler import span

# ---------------------------------------------------------------------------
# The mesh: ranks of the default process group, and their collectives
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh over SPMD processes.  `shape[k]` ranks lie along axis
    `axis_names[k]`; `coords` is this rank's position (None on a rank
    outside the mesh) and `groups[k]` the process group of the ranks that
    differ from it only along axis k."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...] | None
    groups: tuple


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """The first `n_devices` ranks of the default process group (all of
    them by default) as a 1-axis mesh.  Every rank of the group calls it:
    a subgroup is made by all of them."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} devices, have {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return Mesh((axis,), (n,), None, (None,))
    return Mesh((axis,), (n,), (rank,), (group,))


def make_mesh_2d(dp: int, sp: int) -> Mesh:
    """(dp, sp) 2D mesh: batch axis x image-row axis over the first dp * sp
    ranks, rank r at (r // sp, r % sp).  Every rank of the default group
    calls it, and so makes every subgroup in the same order."""
    world = dist.get_world_size()
    if dp * sp > world:
        raise ValueError(f"need {dp * sp} devices, have {world}")
    rank = dist.get_rank()
    grid = np.arange(dp * sp).reshape(dp, sp)
    mine = [None, None]
    for d in range(dp):                     # sp groups: a row of the grid
        g = dist.new_group(grid[d].tolist())
        if rank in grid[d]:
            mine[1] = g
    for j in range(sp):                     # dp groups: a column
        g = dist.new_group(grid[:, j].tolist())
        if rank in grid[:, j]:
            mine[0] = g
    coords = divmod(rank, sp) if rank < dp * sp else None
    return Mesh(("dp", "sp"), (dp, sp), coords, tuple(mine))


def _axis(mesh: Mesh, k: int = 0) -> tuple[object, int, int]:
    """(group, this rank's index, ranks) along mesh axis k."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.coords is None:
        raise ValueError("this rank is not in the mesh")
    return mesh.groups[k], mesh.coords[k], mesh.shape[k]


def _transport(t: torch.Tensor, group) -> torch.Tensor:
    """t as the group's backend takes it: NCCL a CUDA tensor, gloo a CPU
    tensor (a CUDA tensor is copied to the host)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"an NCCL mesh takes CUDA tensors, got one on "
                             f"{t.device}")
        return t.contiguous()
    if backend == "gloo":
        return t.detach().to("cpu").contiguous()
    raise ValueError(f"no transport for a {backend!r} process group")


def all_gather(t: torch.Tensor, mesh: Mesh, k: int = 0) -> torch.Tensor:
    """(n, *t.shape): t of every rank along mesh axis k, in rank order, on
    t's device."""
    group, _, n = _axis(mesh, k)
    x = _transport(t.to(torch.uint8) if t.dtype == torch.bool else t, group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
    out = out.to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, k: int = 0) -> torch.Tensor:
    """The sum of t over the ranks along mesh axis k, on t's device (in t's
    dtype: a sum of disjoint uint8 rows is exact)."""
    group, _, _ = _axis(mesh, k)
    x = _transport(t, group).clone()
    dist.all_reduce(x, group=group)
    return x.to(t.device)


def _rows_of(n_items: int, mesh: Mesh, k: int = 0) -> tuple[int, int]:
    """(chunk, this rank's first item) of n_items dealt in equal chunks."""
    _, r, n = _axis(mesh, k)
    c = -(-n_items // n)
    return c, r * c


def _pad_rows(t: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    pad = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), value,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


# ---------------------------------------------------------------------------
# dp: a batch of images over the ranks
# ---------------------------------------------------------------------------


def shard_batch(images, mesh: Mesh) -> torch.Tensor:
    """This rank's frames of a (B, H, W) batch: frames [r * B/n,
    (r + 1) * B/n) for rank r of n along the mesh's first axis."""
    imgs = torch.as_tensor(images)
    _, r, n = _axis(mesh, 0)
    b = imgs.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} frames does not divide over the "
                         f"mesh's {n} ranks")
    return imgs[r * (b // n):(r + 1) * (b // n)]


def batch_block(images: torch.Tensor, cfg: P.FeatureConfig,
                graphs: bool = False):
    """Every frame's `P.detect_and_compute` packed, one frame after the
    other: ((B, nbytes) uint8 blocks on the images' device, frame i's in
    row i, and their `graphs.Layout`).  graphs: each frame through the
    graph cache (`graphs.CACHE`, one key for the batch), else eagerly; the
    joins of an eager frame write into its row, a replay's block is copied
    there."""
    layout = G.Layout.of(cfg, images.shape[1:], True)
    out = layout.new(images.device, (len(images),))
    run = G.CACHE.run if graphs else G.run_eager
    for i, img in enumerate(images.unbind(0)):
        with span("sharding.frame"):
            run(img, cfg, out=out[i])
    return out, layout


def _gather_batch(slots: dict, desc: torch.Tensor, mesh: Mesh, k: int):
    """Every rank's frames along mesh axis k, in rank order."""
    def cat(t):
        g = all_gather(t, mesh, k)
        return g.reshape((-1,) + tuple(t.shape[1:]))
    return {key: cat(v) for key, v in slots.items()}, cat(desc)


def detect_and_compute_batch(images: torch.Tensor, cfg: P.FeatureConfig,
                             mesh: Mesh | None = None):
    """Batched detect+compute.

    images: (B, H, W) uint8, B >= 1.  Returns the slot dict with a leading
    batch axis, (B, nslots) per field and (B,) for `count`, and descriptors
    (B, nslots, bytes).  Frame i holds exactly what `P.detect_and_compute`
    gives for images[i].  Without a mesh the frames run one after the other
    on the images' device (the JAX package maps them over its chip with
    `lax.map`), on a card through the graph cache; with one, each rank
    runs its frames (B divisible by the mesh size) and every rank gets the
    whole batch back."""
    if images.dim() != 3 or images.dtype != torch.uint8 or \
            images.shape[0] < 1:
        raise ValueError("images must be (B, H, W) uint8 with B >= 1")
    if mesh is None:
        block, layout = batch_block(images, cfg, images.is_cuda)
        return layout.unpack(block)
    block, layout = batch_block(shard_batch(images, mesh), cfg)
    return _gather_batch(*layout.unpack(block), mesh, 0)


# ---------------------------------------------------------------------------
# The keypoint axis
# ---------------------------------------------------------------------------


def _check_ranges(ranges, n: int):
    """The JAX package's tiling check of `ranges=` (sharding.py:124-128)."""
    ranges = tuple((int(a), int(b), None if s is None else float(s))
                   for (a, b, s) in ranges)
    if not ranges or ranges[0][0] != 0 or ranges[-1][1] != n or any(
            ranges[i][1] != ranges[i + 1][0] for i in range(len(ranges) - 1)):
        raise ValueError(f"ranges must tile [0, {n}) in order, got {ranges}")


def compute_sharded(image: torch.Tensor, keypoints_xysa: torch.Tensor,
                    valid: torch.Tensor, mesh: Mesh, *, nbits: int = 256,
                    kind: str = "bad", scale: float = 1.0,
                    ranges=None) -> torch.Tensor:
    """Descriptor-only compute with the keypoint axis over the mesh: each
    rank describes its slice of the (N, 4) [x, y, size, angle] keypoints
    on the whole image, and every rank gets the (N, nbits//8) rows back in
    the caller's order, byte for byte those of `pipeline.compute`.

    ranges: the JAX package's octave-bucket layout ((start, stop, smax),
    ...), checked to tile [0, N) in order as there.  The port's descriptor
    kernels take every keypoint size in one launch, so the buckets route
    nothing."""
    n = keypoints_xysa.shape[0]
    if ranges is not None:
        _check_ranges(ranges, n)
    c, start = _rows_of(n, mesh)
    _, _, n_dev = _axis(mesh)
    kp = _pad_rows(keypoints_xysa.to(torch.float32), n_dev * c)
    v = _pad_rows(valid.to(torch.bool), n_dev * c, False)
    rows = P.compute(image, kp[start:start + c], v[start:start + c], nbits,
                     kind, scale)
    return all_gather(rows, mesh).reshape(n_dev * c, -1)[:n]


# ---------------------------------------------------------------------------
# Matching with the query axis over the mesh
# ---------------------------------------------------------------------------


def knn2_match_sharded(desc1: torch.Tensor, valid1: torch.Tensor,
                       desc2: torch.Tensor, valid2: torch.Tensor,
                       mesh: Mesh, max_ratio: float = 0.8):
    """knn-2 ratio test and cross check with the query axis over the mesh:
    each rank matches its slice of desc1 against all of desc2 (K6 on a
    card), and its slice of desc2 against all of desc1 for the reverse
    best; the reverse bests are all-gathered.  Returns (j i32, best i32,
    ok bool) for every row of desc1 on every rank, equal row for row to
    `ops.matcher.knn2_ratio_match_masked` (its sentinel: a row without a
    valid pair has j = 0, best = 1 << 30, ok False)."""
    OM._check_pair(desc1, desc2)
    OM._need_two(desc2)
    n1, n2 = desc1.shape[0], desc2.shape[0]
    if n1 == 0:
        return OM._empty(desc1)
    _, _, n_dev = _axis(mesh)
    valid1 = valid1.to(torch.bool)
    valid2 = valid2.to(torch.bool)

    def mine(d, v):
        c, start = _rows_of(d.shape[0], mesh)
        d = _pad_rows(d, n_dev * c)
        v = _pad_rows(v, n_dev * c, False)
        return d[start:start + c], v[start:start + c], c, start

    q1, u1, c1, start1 = mine(desc1, valid1)
    j, best, second = OM.knn2_topk2(q1, u1, desc2, valid2)
    q2, u2, _, _ = mine(desc2, valid2)
    i_back, _, _ = OM.knn2_topk2(q2, u2, desc1, valid1)
    i_back = all_gather(i_back, mesh).reshape(-1)[:n2]
    rows = torch.arange(start1, start1 + c1, dtype=torch.int32,
                        device=j.device)
    ok = (OM._ratio_ok(best, second, max_ratio) & (i_back[j.long()] == rows)
          & u1 & (best < OM.BIG))
    return tuple(all_gather(t, mesh).reshape(-1)[:n1] for t in (j, best, ok))


# ---------------------------------------------------------------------------
# sp: one image in row bands, with halo rows
# ---------------------------------------------------------------------------


def _halo_rows(cfg: P.FeatureConfig) -> int:
    """The JAX package's exchange halo (sharding.py:201): an owned pixel's
    NMS disc reaches nonmax_radius rows into the halo, whose FAST (+3) and
    Harris (+4) need their support; at least 24 rows, in multiples of 8."""
    need = cfg.nonmax_radius + 4
    return max(24, -(-need // 8) * 8)


def _band_halo(cfg: P.FeatureConfig) -> int:
    """The port's detect halo: K8 drops corners in the HALF_PATCH_SIZE rows
    at its array's edges, so those rows lie beyond the reach of every owned
    pixel's disc."""
    need = cfg.nonmax_radius + S.HALF_PATCH_SIZE
    return max(_halo_rows(cfg), -(-need // 8) * 8)


def _halo_exchange(band: torch.Tensor, halo: int, mesh: Mesh,
                   k: int) -> torch.Tensor:
    """(halo + bh + halo, w): this rank's band with the `halo` rows of the
    bands above and below it, zeros beyond the first and the last band (the
    JAX package's ppermute pair and its zeroed wrap, sharding.py:395-402).
    One all-gather: of each band's first and last `halo` rows, or of whole
    bands when the halo is as tall as a band."""
    _, i, n = _axis(mesh, k)
    bh, w = band.shape
    zero = band.new_zeros((halo, w))
    if halo < bh:
        edges = all_gather(torch.cat([band[:halo], band[bh - halo:]]), mesh,
                           k)
        top = edges[i - 1, halo:] if i > 0 else zero
        bot = edges[i + 1, :halo] if i < n - 1 else zero
        return torch.cat([top, band, bot])
    full = torch.cat([zero, all_gather(band, mesh, k).reshape(n * bh, w),
                      zero])
    return full[i * bh:i * bh + bh + 2 * halo].contiguous()


def _band_candidates(ext: torch.Tensor, halo: int, bh: int, row0: int,
                     hs: int, quota: int, cfg: P.FeatureConfig,
                     m_ext: torch.Tensor | None = None):
    """A band's top `quota` survivors of its owned rows, in `ext`'s
    coordinates: K8 on the halo-extended band, the level's border rows
    (global rows [15, hs - 15)) and the ROI rows before the NMS, as the
    JAX band does (sharding.py:424-451), then K9 and `select_topk`."""
    e = ext.shape[0]
    resp = DK.fast_harris(ext, cfg.fast_threshold)
    rows = torch.arange(e, device=ext.device) - halo + row0
    keep = ((rows >= S.HALF_PATCH_SIZE)
            & (rows < hs - S.HALF_PATCH_SIZE))[:, None]
    if m_ext is not None:
        keep = keep & m_ext
    resp = torch.where(keep, resp, OD.RESP_SENTINEL)
    surv = DK.radius_nms(resp, cfg.nonmax_radius)
    owned = torch.zeros(e, dtype=torch.bool, device=ext.device)
    owned[halo:halo + bh] = True
    return OD.select_topk(resp, surv & owned[:, None], quota)


def _merge_topk(mesh: Mesh, k: int, quota: int, w: int, ys, xs, r, valid,
                extra=None):
    """The global top `quota` of every band's candidates (global ys), in
    the single-device order: response descending, then flat index
    ascending.  Returns (ys, xs, resp (0 where invalid), valid, extra):
    `extra` (float32 per candidate, or None) follows its candidate."""
    r = torch.where(valid, r, OD.RESP_SENTINEL)
    cols = [ys.to(torch.int32), xs.to(torch.int32), r.view(torch.int32)]
    if extra is not None:
        cols.append(extra.to(torch.float32).view(torch.int32))
    g = all_gather(torch.stack(cols), mesh, k)           # (n, c, quota)
    g = g.permute(1, 0, 2).reshape(len(cols), -1)
    ys_a, xs_a = g[0], g[1]
    r_a = g[2].view(torch.float32)
    flat = ys_a.to(torch.int64) * w + xs_a.to(torch.int64)
    order = torch.sort(flat, stable=True).indices
    order = order[torch.sort(r_a[order], descending=True,
                             stable=True).indices][:quota]
    r_s = r_a[order]
    ok = r_s != OD.RESP_SENTINEL
    ex = None if extra is None else torch.where(
        ok, g[3].view(torch.float32)[order], 0.0)
    return (ys_a[order], xs_a[order], torch.where(ok, r_s, 0.0), ok, ex)


def detect_rows_sharded(image: torch.Tensor, cfg: P.FeatureConfig,
                        mesh: Mesh, quota: int | None = None):
    """Single-level FAST + Harris + NMS over row bands of `image` (h
    divisible by the mesh size): halo exchange, per-band top-k, all-gather
    merge.  Returns (ys, xs, resp, valid), each (quota,), of the global top
    `quota` (default nfeatures), as the whole image's dense selection."""
    h, w = image.shape
    _, i, n = _axis(mesh)
    if h % n:
        raise ValueError("image rows must divide the mesh")
    quota = min(quota or cfg.nfeatures, h * w)
    bh = h // n
    halo = _band_halo(cfg)
    ext = _halo_exchange(image[i * bh:(i + 1) * bh], halo, mesh, 0)
    ys, xs, r, v = _band_candidates(ext, halo, bh, i * bh, h, quota, cfg)
    ys = torch.where(v, ys - halo + i * bh, 0)
    ys, xs, r, v, _ = _merge_topk(mesh, 0, quota, w, ys, xs, r, v)
    return ys, xs, r, v


# ---------------------------------------------------------------------------
# sp: the whole pyramid in row bands
# ---------------------------------------------------------------------------

DESC_HALO = 48        # rows exchanged for a band's blurred descriptor window
DESC_MARGIN = 40      # rows of that window above and below the band


class _PyramidPlan(NamedTuple):
    shapes: list
    scales: np.ndarray
    quotas: list
    bh: list          # band rows per level (the level padded to n bands)
    halo_rs: int      # rows exchanged for the band resize
    halo: int         # rows exchanged for the band detect


@functools.lru_cache(maxsize=64)
def _pyramid_plan(h: int, w: int, cfg: P.FeatureConfig, n: int):
    """Per-level band geometry, with the JAX package's check on the band
    height (sharding.py:357-362)."""
    shapes = S.pyramid_shapes(h, w, cfg.scale_factor, cfg.nlevels)
    bh = [-(-hs // n) for hs, _ in shapes]
    halo_rs = max(16, int(np.ceil((n - 1) * cfg.scale_factor)) + 4)
    if min(bh) < max(_halo_rows(cfg), halo_rs):
        raise ValueError(
            "pyramid bands shorter than the exchange halo; fewer levels, a "
            "smaller mesh, or detect_jit are required for this image size")
    return _PyramidPlan(shapes, S.pyramid_scales(cfg.scale_factor,
                                                 cfg.nlevels),
                        cfg.quotas(), bh, halo_rs, _band_halo(cfg))


def _band_mask(mask0: torch.Tensor, rows: torch.Tensor, s: int,
               shapes) -> torch.Tensor:
    """The level-s ROI mask on the band's extended rows `rows` (global,
    clipped to the level), from the level-0 mask through the
    nearest-neighbour tables of the single-device mask pyramid
    (`pipeline._mask_tables`)."""
    rid = rows.clamp(0, shapes[s][0] - 1)
    if s == 0:
        return mask0.index_select(0, rid)
    yy, xx = P._mask_tables(*shapes[0], *shapes[s], mask0.device)
    return mask0.index_select(0, yy[rid]).index_select(1, xx)


def _band_descriptors(cur: torch.Tensor, i: int, s: int, plan: _PyramidPlan,
                      cfg: P.FeatureConfig, mesh: Mesh, k: int, ys, xs, ang,
                      valid) -> torch.Tensor:
    """The level's descriptor rows: each band describes the keypoints in
    its rows on its blurred window of the level (global REFLECT_101 rows at
    the level's edges), with the window's origin in the level; a band
    shorter than DESC_HALO blurs the whole level, gathered.  The rows are
    disjoint, so their sum is every band's (sharding.py:473-513)."""
    hs, ws = plan.shapes[s]
    b = plan.bh[s]
    if b >= DESC_HALO:
        ext = _halo_exchange(cur, DESC_HALO, mesh, k)
        g = torch.arange(ext.shape[0], device=cur.device) - DESC_HALO + i * b
        refl = g.abs()
        refl = torch.where(refl >= hs, 2 * (hs - 1) - refl, refl)
        src = (refl - (i * b - DESC_HALO)).clamp(0, ext.shape[0] - 1)
        blurred = OI.gaussian_blur7_u8_fast(ext.index_select(0, src))
        top = DESC_HALO - DESC_MARGIN
        win = blurred[top:top + b + 2 * DESC_MARGIN]
        oy = i * b - DESC_MARGIN
    else:
        full = all_gather(cur, mesh, k).reshape(-1, ws)[:hs]
        win = OI.gaussian_blur7_u8_fast(full)
        oy = 0
    in_band = valid & (ys >= i * b) & (ys < (i + 1) * b)
    d = P._compute_level_descriptors(win, ys, xs, ang, in_band, cfg,
                                     (oy, 0), (hs, ws))
    return all_reduce_sum(d, mesh, k)


def _pyramid_bands(image: torch.Tensor, cfg: P.FeatureConfig, mesh: Mesh,
                   k: int, plan: _PyramidPlan, with_descriptors: bool,
                   mask: torch.Tensor | None):
    """The slot dict of `pipeline.detect` (and the descriptors of
    `pipeline.detect_and_compute`) of one image, from its row bands along
    mesh axis k (sharding.py:404-542)."""
    _, i, n = _axis(mesh, k)
    h, w = image.shape
    dev = image.device
    bh = plan.bh
    padded = torch.cat([image, image.new_zeros((n * bh[0] - h, w))])
    cur = padded[i * bh[0]:(i + 1) * bh[0]]
    mask0 = None if mask is None else mask != 0
    parts = []
    descs = []
    for s in range(cfg.nlevels):
        hs, ws = plan.shapes[s]
        if s > 0:
            ext = _halo_exchange(cur, plan.halo_rs, mesh, k)
            band = OI.BandRows(hs, plan.shapes[s - 1][0], i * bh[s], bh[s],
                               i * bh[s - 1] - plan.halo_rs, ext.shape[0])
            cur = OI.resize_u8_fast(ext, (bh[s], ws), band)
        if s < cfg.first_level:
            continue
        quota = min(plan.quotas[s], hs * ws)
        halo = plan.halo
        ext = _halo_exchange(cur, halo, mesh, k)
        rows = torch.arange(ext.shape[0], device=dev) - halo + i * bh[s]
        m_ext = None if mask0 is None else _band_mask(mask0, rows, s,
                                                      plan.shapes)
        ys, xs, r, v = _band_candidates(ext, halo, bh[s], i * bh[s], hs,
                                        quota, cfg, m_ext)
        ang = WK.ic_angles_windows(ext, ys, xs, v)
        ys = torch.where(v, ys - halo + i * bh[s], 0)
        ys, xs, r, v, ang = _merge_topk(mesh, k, quota, ws, ys, xs, r, v,
                                        ang)
        if with_descriptors:
            descs.append(_band_descriptors(cur, i, s, plan, cfg, mesh, k, ys,
                                           xs, ang, v))
        parts.append(P._level_slots(s, plan.scales[s], quota, ys, xs, r,
                                    ang, v))
    slots = P._join_slots(parts)
    if with_descriptors:
        return slots, torch.cat(descs)
    return slots


def detect_pyramid_rows_sharded(image: torch.Tensor, cfg: P.FeatureConfig,
                                mesh: Mesh, with_descriptors: bool = False,
                                mask: torch.Tensor | None = None):
    """`pipeline.detect` (with descriptors `pipeline.detect_and_compute`)
    of one image whose pyramid is split into row bands over the mesh; every
    rank returns the whole result, equal to the single-device call.  Every
    level's band must be at least the exchange halo tall (ValueError).
    mask: the (h, w) ROI, nonzero = search here, on the image's device;
    each band takes its level rows through the single-device mask
    pyramid's nearest-neighbour tables, before the NMS."""
    h, w = image.shape
    P.validate_image_shape(cfg, h, w)
    plan = _pyramid_plan(h, w, cfg, _axis(mesh)[2])
    return _pyramid_bands(image, cfg, mesh, 0, plan, with_descriptors, mask)


def detect_and_compute_batch_2d(images: torch.Tensor, cfg: P.FeatureConfig,
                                mesh: Mesh, mask: torch.Tensor | None = None):
    """Batched detect+compute over a (dp, sp) mesh: the frames shard over
    dp (B divisible by its size) and each frame's pyramid over sp, as
    `detect_pyramid_rows_sharded`; optional per-frame masks (B, H, W).
    Every rank gets back the slot dict with a leading batch axis and the
    descriptors, each frame equal to the single-device call."""
    if len(mesh.shape) != 2:
        raise ValueError("detect_and_compute_batch_2d takes a (dp, sp) mesh")
    b, h, w = images.shape
    P.validate_image_shape(cfg, h, w)
    local = shard_batch(images, mesh)
    masks = [None] * local.shape[0] if mask is None else \
        shard_batch(mask, mesh)
    plan = _pyramid_plan(h, w, cfg, _axis(mesh, 1)[2])
    frames = [_pyramid_bands(img, cfg, mesh, 1, plan, True, m)
              for img, m in zip(local.unbind(0), masks)]
    slots = {key: torch.stack([s[key] for s, _ in frames])
             for key in frames[0][0]}
    return _gather_batch(slots, torch.stack([d for _, d in frames]), mesh, 0)
