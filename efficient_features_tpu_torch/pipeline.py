"""End-to-end detect / detect-and-compute / compute pipelines in PyTorch.

Port of `efficient_features_tpu/pipeline.py` for BAD and HashSIFT.
Keypoint slots: each pyramid level owns a fixed `quota` range of the output
arrays (ORB geometric split); invalid slots are masked; slot order within a
level is (response desc, index asc).  Everything runs eagerly on the input's
device, and no route reads anything back: as in the JAX package, a
`detect_async` / `detect_and_compute_async` call only enqueues work.
Spans (`utils/profiler.span`, recorded only under a torch profiler):
`eff/pipeline.pyramid`, then `eff/pipeline.detect_level` and
`eff/pipeline.describe_level` once a level each, and `eff/pipeline.join`
around each concatenation of the levels.  HashSIFT's steps open
`eff/hash_sift.warp` (K4) and `eff/hash_sift.hist` (K5), or
`eff/hash_sift.fused` (K11), then `eff/hash_sift.project`, once a call of
`_compute_descriptors`: a level's, or a `compute()`'s; BAD opens
`eff/bad.describe` (K3, `ops/window_kernels.py`) there.  `compute()` opens
`eff/pipeline.compute` around its keypoint columns and describe.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .models.params import hash_sift_params
from .utils import semantics as S
from .ops import bad as ops_bad
from .ops import hash_sift as ops_hs
from .ops import image as ops_image
from .ops import detect as ops_detect
from .ops import detect_kernels as DK
from .ops import window_kernels as WK
from .utils.profiler import span

DESCRIPTOR_TYPES = ("bad_256", "bad_512", "hash_sift_256", "hash_sift_512")
MIN_LEVEL_DIM = 8


@dataclass(frozen=True)
class FeatureConfig:
    """Detector configuration (defaults: cuda_efficient_features.h:47-48)."""
    nfeatures: int = 5000
    scale_factor: float = 1.2
    nlevels: int = 8
    first_level: int = 0
    fast_threshold: int = 20
    nonmax_radius: int = 15
    descriptor_type: str = "hash_sift_256"
    # HashSIFT through the fused kernel K11 instead of K4 + K5 (the JAX
    # package's EFF_TPU_FUSED_HS route).  The descriptor bytes are the same.
    hs_fused: bool = False

    def __post_init__(self):
        """Eager parameter validation, with the JAX package's messages."""
        if self.nfeatures < 1:
            raise ValueError(f"nfeatures must be >= 1, got {self.nfeatures}")
        if self.nlevels < 1:
            raise ValueError(f"nlevels must be >= 1, got {self.nlevels}")
        if not self.scale_factor > 1.0:
            raise ValueError(
                "scale_factor must be > 1.0 (the pyramid level-quota split, "
                f"features_per_level, needs a geometric ratio), got "
                f"{self.scale_factor}")
        if not 0 <= self.first_level < self.nlevels:
            raise ValueError(
                f"first_level must be in [0, nlevels), got {self.first_level}")
        if self.fast_threshold < 1:
            raise ValueError(
                f"fast_threshold must be >= 1, got {self.fast_threshold}")
        if self.nonmax_radius < 1:
            raise ValueError(
                f"nonmax_radius must be >= 1, got {self.nonmax_radius}")
        if self.descriptor_type not in DESCRIPTOR_TYPES:
            raise ValueError(
                f"descriptor_type must be one of {DESCRIPTOR_TYPES}, got "
                f"{self.descriptor_type!r}")

    @property
    def descriptor_bits(self) -> int:
        return int(self.descriptor_type.rsplit("_", 1)[1])

    @property
    def descriptor_bytes(self) -> int:
        return self.descriptor_bits // 8

    def quotas(self) -> list[int]:
        return S.features_per_level(self.nfeatures, self.scale_factor,
                                    self.nlevels)


def validate_image_shape(cfg: FeatureConfig, h: int, w: int):
    """Reject images too small for the requested pyramid: every level must
    keep at least MIN_LEVEL_DIM rows and columns."""
    th, tw = S.pyramid_shapes(h, w, cfg.scale_factor, cfg.nlevels)[-1]
    if th < MIN_LEVEL_DIM or tw < MIN_LEVEL_DIM:
        raise ValueError(
            f"image {h}x{w} is too small for nlevels={cfg.nlevels} at "
            f"scale_factor={cfg.scale_factor}: top pyramid level would be "
            f"{th}x{tw} (every level needs >= {MIN_LEVEL_DIM} px per side); "
            "reduce nlevels or scale_factor")


def _detect_level(img, quota, cfg: FeatureConfig, lvl_mask=None):
    """One pyramid level: FAST -> Harris -> NMS -> top-k -> angles.

    lvl_mask (optional bool map): the user's ROI mask at this level, applied
    before the NMS like the border, so masked-out corners never suppress.
    The route follows the JAX package's `_detect_level` on every device (the
    kernel wrappers choose kernel or plain version from the tensor's
    device):
      - radius >= 10: K1, cells, with the mask, then the cell-reduced
        selection, K13 (`efficient_features_tpu/pipeline.py:109`);
      - radius < 10, no mask: K7, dense suppressed map, `select_topk`;
      - radius < 10 with a mask: K8, the mask, K9, `select_topk`.
    """
    h, w = img.shape
    radius = cfg.nonmax_radius
    if min(h, w) > 2 * S.HALF_PATCH_SIZE:
        if radius >= 10:
            cm, crow, _, cbits = DK.fast_harris_nms_cells(
                img, cfg.fast_threshold, radius, lvl_mask)
            ys, xs, r, valid = DK.select_cells(cm, crow, cbits, h, w,
                                               quota)
        else:
            if lvl_mask is None:
                suppressed = DK.fast_harris_nms(img, cfg.fast_threshold,
                                                radius)
            else:
                resp = torch.where(lvl_mask,
                                   DK.fast_harris(img, cfg.fast_threshold),
                                   ops_detect.RESP_SENTINEL)
                surv = DK.radius_nms(resp, radius)
                suppressed = torch.where(surv, resp, ops_detect.RESP_SENTINEL)
            ys, xs, r, valid = ops_detect.select_topk(
                suppressed, suppressed != ops_detect.RESP_SENTINEL, quota)
        ang = WK.ic_angles_windows(img, ys, xs, valid)
        return ys, xs, r, ang, valid
    # a level too small for the 31 px patch selects nothing (its border mask
    # is empty), as in the JAX package: every slot invalid and zero
    idx = torch.zeros(quota, dtype=torch.int32, device=img.device)
    val = torch.zeros(quota, dtype=torch.float32, device=img.device)
    return idx, idx, val, val, torch.zeros(quota, dtype=torch.bool,
                                           device=img.device)


@functools.lru_cache(maxsize=64)
def level_slot_ranges(cfg: FeatureConfig, img_h: int, img_w: int):
    """Static per-level slot layout of detect output: ((start, stop,
    size_bound), ...), one entry per pyramid level in detect_core's order.
    Kept per (cfg, shape): every call of the API asks for it, and working
    it out takes about 0.1 ms of host time."""
    quotas = cfg.quotas()
    shapes = S.pyramid_shapes(img_h, img_w, cfg.scale_factor, cfg.nlevels)
    scales = S.pyramid_scales(cfg.scale_factor, cfg.nlevels)
    out = []
    off = 0
    for s in range(cfg.first_level, cfg.nlevels):
        q = min(quotas[s], int(np.prod(shapes[s])))
        out.append((off, off + q,
                    round(float(scales[s]) * float(S.PATCH_SIZE), 4)))
        off += q
    return tuple(out)


def _mask_tables(h0: int, w0: int, h: int, w: int, dev):
    """The level-0 rows (h,) and columns (w,) that the pixels of an (h, w)
    level take from an (h0, w0) mask: the nearest neighbour of its
    half-pixel center, row (2y + 1) * h0 // (2h), clipped, in exact
    integers as the JAX package's `_mask_pyramid` (float coordinates drift
    by one pixel at some level)."""
    yy = ((torch.arange(h, device=dev) * 2 + 1) * h0 // (2 * h)).clamp(
        0, h0 - 1)
    xx = ((torch.arange(w, device=dev) * 2 + 1) * w0 // (2 * w)).clamp(
        0, w0 - 1)
    return yy, xx


def _mask_pyramid(mask: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Nearest-neighbour ROI mask per pyramid level (bool), through
    `_mask_tables`."""
    base = mask != 0
    levels = [base]
    for (h, w) in shapes[1:]:
        yy, xx = _mask_tables(*shapes[0], h, w, mask.device)
        levels.append(base.index_select(0, yy).index_select(1, xx))
    return levels


def _level_slots(s: int, scale, quota: int, ys, xs, r, ang,
                 valid) -> dict:
    """Level s's `quota` slots in image coordinates, from its selection in
    level coordinates; `scale` the level's (float32) pyramid scale."""
    sc = float(scale)
    dev = ys.device
    # scalePoints (cuda_efficient_features.cu:236-248): trunc(sc*x + 0.5)
    return {
        "x": torch.trunc(sc * xs.to(torch.float32) + 0.5),
        "y": torch.trunc(sc * ys.to(torch.float32) + 0.5),
        "response": r,
        "angle": ang,
        "octave": torch.full((quota,), s, dtype=torch.int32, device=dev),
        "size": torch.full((quota,), float(scale * np.float32(S.PATCH_SIZE)),
                           dtype=torch.float32, device=dev),
        "valid": valid,
    }


def _join_slots(levels: list[dict], out: dict | None = None) -> dict:
    """The per-level slot dicts, concatenated, with their valid count;
    written into `out`'s tensor of a key where it has one."""
    out = out or {}
    slots = {k: torch.cat([lv[k] for lv in levels], out=out.get(k))
             for k in levels[0]}
    slots["count"] = torch.sum(slots["valid"], 0, dtype=torch.int32,
                               out=out.get("count"))
    return slots


def detect_core(image: torch.Tensor, cfg: FeatureConfig,
                mask: torch.Tensor | None = None, out: dict | None = None):
    """Returns (slots, levels, per_level): the per-slot dict over
    sum(quotas[first_level:]) slots, the pyramid, and per-level
    (s, ys, xs, valid, ang) in level coordinates.  `mask` (optional (h, w)
    tensor on the image's device, nonzero = search here) restricts
    detection at every level.  `out`: tensors the join writes the slots
    into (`graphs.Layout.unpack`), by key."""
    h0, w0 = int(image.shape[0]), int(image.shape[1])
    validate_image_shape(cfg, h0, w0)
    with span("pipeline.pyramid"):
        levels = ops_image.build_pyramid(image, cfg.scale_factor,
                                         cfg.nlevels)
        masks = (_mask_pyramid(mask, S.pyramid_shapes(
            h0, w0, cfg.scale_factor, cfg.nlevels))
            if mask is not None else [None] * cfg.nlevels)
    scales = S.pyramid_scales(cfg.scale_factor, cfg.nlevels)
    quotas = cfg.quotas()

    parts = []
    per_level = []
    for s in range(cfg.first_level, cfg.nlevels):
        quota = min(quotas[s], int(np.prod(levels[s].shape)))
        with span("pipeline.detect_level"):
            ys, xs, r, ang, valid = _detect_level(levels[s], quota, cfg,
                                                  masks[s])
            per_level.append((s, ys, xs, valid, ang))
            parts.append(dict(_level_slots(s, scales[s], quota, ys, xs, r,
                                           ang, valid), x_level=xs,
                              y_level=ys))
    with span("pipeline.join"):
        slots = _join_slots(parts, out)
    return slots, levels, per_level


def _hs_from_fused(desc_u8, valid, nbits: int) -> torch.Tensor:
    """Projection tail of HashSIFT for (N, 128) u8 rows in the
    orientation-major layout: permuted-column product plus bias in full
    f32, then sign, valid mask and MSB-first packing.  Equals the
    reference's (N, 129) product up to f32 summation order."""
    prm = hash_sift_params(nbits, str(desc_u8.device))
    with ops_hs.full_f32_matmul():
        proj = desc_u8.to(torch.float32) @ prm.bp.T + prm.b0
    return ops_bad.pack_bits_msb((proj > 0) & valid[:, None])


def _compute_descriptors(image, x, y, size, ang, valid, kind: str,
                         nbits: int, scale: float, hs_fused: bool = False,
                         origin=(0, 0), frame_hw=None) -> torch.Tensor:
    """Descriptor dispatch: BAD through K3; HashSIFT through the warp (K4)
    and the histogram (K5), or with `hs_fused` through the fused kernel
    (K11), then the projection.  Every keypoint size takes the same
    kernels.  `origin`, `frame_hw`: the image is a band of a larger frame
    (`ops/window_kernels.py`)."""
    band = dict(origin=origin, frame_hw=frame_hw)
    if kind == "bad":
        return WK.bad_descriptors_windows(image, x, y, size, ang, valid,
                                          nbits, scale, **band)
    if kind != "hash_sift":
        raise ValueError(f"kind must be 'bad' or 'hash_sift', got {kind!r}")
    if hs_fused:
        with span("hash_sift.fused"):
            rows = WK.hs_desc_windows(image, x, y, size, ang, valid, scale,
                                      **band)
    else:
        with span("hash_sift.warp"):
            patches = WK.warp_patches_windows(image, x, y, size, ang, valid,
                                              scale, **band)
        with span("hash_sift.hist"):
            rows = WK.hs_hist_from_patches(patches)
    with span("hash_sift.project"):
        return _hs_from_fused(rows, valid, nbits)


def _compute_level_descriptors(blurred, ys, xs, ang, valid,
                               cfg: FeatureConfig, origin=(0, 0),
                               frame_hw=None):
    """Descriptors for one level's slots on the blurred level image (or on a
    band of it: `origin`, `frame_hw`), with keypoints (x, y, size=31,
    angle) in level coordinates."""
    x = xs.to(torch.float32)
    y = ys.to(torch.float32)
    size = torch.full(x.shape, float(S.PATCH_SIZE), dtype=torch.float32,
                      device=x.device)
    kind, bits = cfg.descriptor_type.rsplit("_", 1)
    return _compute_descriptors(blurred, x, y, size, ang, valid, kind,
                                int(bits), 1.0, cfg.hs_fused, origin,
                                frame_hw)


def detect_and_compute_core(image: torch.Tensor, cfg: FeatureConfig,
                            with_descriptors: bool = True,
                            mask: torch.Tensor | None = None, out=None):
    """(slots, descriptors or None) with the slots' level coordinates
    `x_level`, `y_level`.  `out`: (slot tensors by key, descriptor rows)
    that the joins write into, as `graphs.Layout.unpack` gives them."""
    slot_out, desc_out = (None, None) if out is None else out
    slots, levels, per_level = detect_core(image, cfg, mask, slot_out)
    if not with_descriptors:
        return slots, None
    descs = []
    for (s, ys, xs, valid, ang) in per_level:
        with span("pipeline.describe_level"):
            blurred = ops_image.gaussian_blur7_u8_fast(levels[s])
            descs.append(_compute_level_descriptors(blurred, ys, xs, ang,
                                                    valid, cfg))
    with span("pipeline.join"):
        descs = torch.cat(descs, dim=0, out=desc_out)
    return slots, descs


def detect(image: torch.Tensor, cfg: FeatureConfig,
           mask: torch.Tensor | None = None) -> dict:
    """Slot dict of one image (counterpart of `detect_jit`, and of
    `detect_masked_jit` with a mask)."""
    slots, _ = detect_and_compute_core(image, cfg, with_descriptors=False,
                                       mask=mask)
    slots.pop("x_level")
    slots.pop("y_level")
    return slots


def detect_and_compute(image: torch.Tensor, cfg: FeatureConfig,
                       mask: torch.Tensor | None = None):
    """(slot dict, (slots, nbits//8) uint8 descriptors) of one image
    (counterpart of `detect_and_compute_jit`, and of
    `detect_and_compute_masked_jit` with a mask)."""
    slots, descs = detect_and_compute_core(image, cfg, with_descriptors=True,
                                           mask=mask)
    slots.pop("x_level")
    slots.pop("y_level")
    return slots, descs


def compute(image: torch.Tensor, xysa: torch.Tensor, valid: torch.Tensor,
            nbits: int, kind: str, scale: float,
            hs_fused: bool = False) -> torch.Tensor:
    """(N, nbits//8) uint8 descriptors of user keypoints, (N, 4) float32
    rows [x, y, size, angle], on the raw image (no blur), as the
    reference's standalone BAD / HashSIFT compute.  Counterpart of
    `compute_jit` and `compute_bucketed_jit`: one call covers every
    keypoint size.  Invalid slots give zero rows.  `hs_fused`: HashSIFT
    through K11 instead of K4 + K5."""
    with span("pipeline.compute"):
        x, y, size, ang = xysa.to(torch.float32).T.contiguous()
        return _compute_descriptors(image, x, y, size, ang, valid, kind,
                                    nbits, scale, hs_fused)
