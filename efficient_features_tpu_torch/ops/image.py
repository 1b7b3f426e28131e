"""Image ops: fixed-point resize, separable Gaussian, integral image.

Port of `efficient_features_tpu/ops/image.py`.  Every op is int32 integer
arithmetic on the input's device, so pyramid levels, blurred levels and
integrals are bit-identical to the JAX package by construction:
  - pyramid resize: cv::cuda::resize INTER_LINEAR chain, 11-bit fixed point
  - 7x7 sigma=2 Gaussian, BORDER_REFLECT_101, 16-bit fixed point
  - integral image, int32 with wrapping overflow
The resize of a CUDA tensor is the kernel K10 (csrc/resize_u8.cu, wrapper
`resize_u8_kernel`, the counterpart of the TPU's `resize_u8_pallas`; its
packed tables `resize_table`, its tiles `resize_plan`); `resize_u8` is its
plain version and what a CPU tensor takes.
`resize_u8_fast` picks by the tensor's device, and `build_pyramid` calls it.
The JAX package's `pallas_resize` switch has no counterpart: the two give
the same bytes, so the card always takes the kernel.
All three take `band=` (`BandRows`): the destination rows of one band of a
row-sharded pyramid level, resized from the band of the level below plus
its exchanged halo rows, with the whole level's row table sliced and
rebased (`parallel/sharding.py`), so that the band's pixels are those of
the whole level.
The blur of a CUDA tensor is the kernel K14 (csrc/blur7_u8.cu, wrapper
`gaussian_blur7_u8_kernel`; the JAX package blurs with XLA ops, so it has
no TPU counterpart); `gaussian_blur7_u8` is its plain version and what a
CPU tensor takes, and `gaussian_blur7_u8_fast` picks by the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils import semantics as S
from .detect_kernels import require_cuda, stream_of

# The index and weight tables below depend only on shapes.  They are cached
# per (shape, device) because each copy of a host array to a GPU waits for
# the copy to finish: built per call, they cost one host sync apiece.  The
# cached tensors are only ever read, and never dropped: a captured CUDA
# graph (`graphs.py`) reads them by address on every replay.


@functools.lru_cache(maxsize=None)
def _resize_tables(dst_n: int, src_n: int, device: torch.device):
    """(i0, i1 int64 indices, w1 int32 weights) of one resize axis."""
    i0, i1, w1 = S.resize_axis_coeffs(dst_n, src_n)
    return (torch.from_numpy(i0.astype(np.int64)).to(device),
            torch.from_numpy(i1.astype(np.int64)).to(device),
            torch.from_numpy(w1).to(device))


# K10's tiles (csrc/resize_u8.cu): destination rows x columns of a block,
# the shared memory that stages a tile's source rows, and the bits of a
# source index in a packed table word.
RESIZE_TILE_H = 8
RESIZE_TILE_W = 256
RESIZE_STAGE_BYTES = 12288
RESIZE_INDEX_BITS = 19


def resize_table(dst_n: int, src_n: int) -> np.ndarray:
    """K10's table of one resize axis: (dst_n,) uint32 words
    i0 | (i1 - i0) << 19 | w1 << 20 of `semantics.resize_axis_coeffs`
    (i1 - i0 is 0 or 1; w1 is 0..2048)."""
    if src_n > 1 << RESIZE_INDEX_BITS:
        raise ValueError(f"K10 takes at most {1 << RESIZE_INDEX_BITS} "
                         f"source pixels a side, got {src_n}")
    return _pack_taps(*S.resize_axis_coeffs(dst_n, src_n))


def _pack_taps(i0, i1, w1) -> np.ndarray:
    """K10's table words i0 | (i1 - i0) << 19 | w1 << 20 (uint32)."""
    i0, i1, w1 = (np.asarray(a).astype(np.uint32) for a in (i0, i1, w1))
    return (i0 | (i1 - i0) << RESIZE_INDEX_BITS
            | w1 << (RESIZE_INDEX_BITS + 1))


class ResizePlan(NamedTuple):
    """What each block of K10 reads, one entry per tile (ty, tx), shape
    (ceil(h / RESIZE_TILE_H), ceil((w + 3) / RESIZE_TILE_W)).  Tile (ty, tx)
    writes destination rows ty * RESIZE_TILE_H on, and of each row y the
    columns tx * RESIZE_TILE_W - m(y) on, m(y) the misalignment of the
    row's first byte (y * w % 4 for an aligned output), clipped to the
    image; so its columns lie in [c_lo, c_hi).  It reads source rows
    y0 .. y0 + rows - 1 and columns x0 .. x0 + span - 1, from shared memory
    at `stride` bytes a row where `staged`, else from the image."""
    c_lo: np.ndarray
    c_hi: np.ndarray
    y0: np.ndarray
    rows: np.ndarray
    x0: np.ndarray
    span: np.ndarray
    stride: np.ndarray
    staged: np.ndarray


def resize_plan(dst_hw: tuple[int, int],
                src_hw: tuple[int, int]) -> ResizePlan:
    """K10's tiles of a (src_hw) -> (dst_hw) resize, as the kernel computes
    them from its tables (`tile_plan` in csrc/resize_u8.cu)."""
    (h, w), (sh, sw) = dst_hw, src_hw
    y0t, y1t, _ = S.resize_axis_coeffs(h, sh)
    x0t, x1t, _ = S.resize_axis_coeffs(w, sw)
    r0 = np.arange(0, h, RESIZE_TILE_H)
    last = np.minimum(r0 + RESIZE_TILE_H, h) - 1
    tx = np.arange(-(-(w + 3) // RESIZE_TILE_W))
    c_lo = np.maximum(tx * RESIZE_TILE_W - 3, 0)
    c_hi = np.minimum(tx * RESIZE_TILE_W + RESIZE_TILE_W, w)
    y0 = y0t[r0].astype(np.int64)
    rows = y1t[last] - y0 + 1
    x0 = x0t[c_lo].astype(np.int64)
    span = x1t[c_hi - 1] - x0 + 1
    stride = 16 * ((span + 30) // 16)
    cells = (len(r0), len(tx))
    staged = ((rows <= RESIZE_STAGE_BYTES // 16)[:, None]
              & (rows[:, None] * stride[None, :] <= RESIZE_STAGE_BYTES))
    return ResizePlan(*(np.broadcast_to(a, cells) for a in (
        c_lo[None, :], c_hi[None, :], y0[:, None], rows[:, None],
        x0[None, :], span[None, :], stride[None, :], staged)))


class BandRows(NamedTuple):
    """Destination rows [start, start + count) of the (dst_n <- src_n) row
    table of a resize, rows past dst_n taking the last row's taps (a band
    padded to the mesh), with the source rows rebased to a band of the
    source that starts at row `base` and holds `src_rows` rows, and clipped
    to it (as `efficient_features_tpu/parallel/sharding.py:408-422`)."""
    dst_n: int
    src_n: int
    start: int
    count: int
    base: int
    src_rows: int


@functools.lru_cache(maxsize=512)
def band_row_taps(band: BandRows) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(i0, i1, w1) of a band's destination rows in its source band:
    `semantics.resize_axis_coeffs`, sliced, rebased and clipped."""
    i0, i1, w1 = S.resize_axis_coeffs(band.dst_n, band.src_n)
    rows = np.minimum(np.arange(band.start, band.start + band.count),
                      band.dst_n - 1)
    return (np.clip(i0[rows] - band.base, 0, band.src_rows - 1),
            np.clip(i1[rows] - band.base, 0, band.src_rows - 1),
            w1[rows])


def _check_band(band: BandRows | None, h: int, sh: int) -> None:
    if band is not None and (band.count, band.src_rows) != (h, sh):
        raise ValueError(f"band {band} does not resize {sh} source rows to "
                         f"{h}")


def _row_taps(h: int, sh: int, band: BandRows | None, device):
    """(i0, i1 int64, w1 int32) tensors of the destination rows."""
    if band is None:
        return _resize_tables(h, sh, device)
    _check_band(band, h, sh)
    return _band_tables(band, device)


@functools.lru_cache(maxsize=None)
def _band_tables(band: BandRows, device: torch.device):
    i0, i1, w1 = band_row_taps(band)
    return (torch.from_numpy(i0.astype(np.int64)).to(device),
            torch.from_numpy(i1.astype(np.int64)).to(device),
            torch.from_numpy(w1.astype(np.int32)).to(device))


@functools.lru_cache(maxsize=None)
def _resize_launch(h: int, w: int, sh: int, sw: int, device: torch.device,
                   band: BandRows | None = None
                   ) -> tuple[torch.Tensor, int, int]:
    """K10's packed tables of one (dst, src) shape, or of one band, on
    `device`: the (h + w,) tensor (held here, so that its pointers stay
    valid) and the raw pointers of its y and x parts."""
    ytab = resize_table(h, sh) if band is None else _pack_taps(
        *band_row_taps(band))
    t = torch.from_numpy(np.concatenate(
        [ytab, resize_table(w, sw)]).view(np.int32)).to(device)
    return t, t.data_ptr(), t.data_ptr() + 4 * h


@functools.lru_cache(maxsize=None)
def _reflect101_pad3(n: int, device: torch.device) -> torch.Tensor:
    """int64 REFLECT_101 source index of positions -3 .. n + 2."""
    idx = S.reflect101_index(np.arange(-3, n + 3), n).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def resize_u8(src: torch.Tensor, dst_hw: tuple[int, int],
              band: BandRows | None = None) -> torch.Tensor:
    """Separable bilinear resize of a (H, W) uint8 image, 11-bit fixed point
    (of one band of a level: `band`, with dst_hw[0] == band.count)."""
    h, w = dst_hw
    sh, sw = src.shape
    x0, x1, wx1 = _resize_tables(w, sw, src.device)
    y0, y1, wy1 = _row_taps(h, sh, band, src.device)
    one = 1 << S.RESIZE_BITS
    a = src.to(torch.int32)
    hpass = (a.index_select(1, x0) * (one - wx1)[None, :]
             + a.index_select(1, x1) * wx1[None, :])
    acc = (hpass.index_select(0, y0) * (one - wy1)[:, None]
           + hpass.index_select(0, y1) * wy1[:, None])
    out = (acc + (1 << (2 * S.RESIZE_BITS - 1))) >> (2 * S.RESIZE_BITS)
    return out.to(torch.uint8)


def resize_u8_kernel(src: torch.Tensor, dst_hw: tuple[int, int],
                     band: BandRows | None = None) -> torch.Tensor:
    """K10: `resize_u8` of a contiguous (H, W) uint8 CUDA tensor, bit for
    bit, in one kernel launch.  The index and weight tables stay the host's
    (`semantics.resize_axis_coeffs`, float64 math), packed by `resize_table`
    and cached on the device per shape (and band) with their pointers, so
    that a call does one lookup, one allocation and one launch.  A band's
    row table starts at any source row; the kernel plans each tile from its
    table entries, wherever they point."""
    require_cuda(src, torch.uint8, "src")
    if src.dim() != 2:
        raise ValueError(f"src must be 2-D, got shape {tuple(src.shape)}")
    h, w = int(dst_hw[0]), int(dst_hw[1])
    sh, sw = src.shape
    if min(h, w, sh, sw) < 1:
        raise ValueError(f"cannot resize {sh}x{sw} to {h}x{w}")
    _check_band(band, h, sh)
    _, ytab, xtab = _resize_launch(h, w, sh, sw, src.device, band)
    out = torch.empty((h, w), dtype=torch.uint8, device=src.device)
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.eff_resize_u8(src.data_ptr(), sh, sw, ytab, xtab,
                               out.data_ptr(), h, w, stream_of(src))
        _build.check(rc, "resize_u8_kernel")
        resize_u8_kernel.launches += 1
    return out


resize_u8_kernel.launches = 0


def resize_u8_fast(src: torch.Tensor, dst_hw: tuple[int, int],
                   band: BandRows | None = None) -> torch.Tensor:
    """`resize_u8`: through K10 for a CUDA tensor, the plain version for a
    CPU tensor.  The same bytes either way."""
    if src.device.type == "cpu":
        return resize_u8(src, dst_hw, band)
    return resize_u8_kernel(src, dst_hw, band)


def build_pyramid(image: torch.Tensor, scale_factor: float,
                  nlevels: int) -> list[torch.Tensor]:
    """Iterated resize chain; level s from level s-1.  Every level is a
    contiguous uint8 tensor."""
    shapes = S.pyramid_shapes(image.shape[0], image.shape[1], scale_factor,
                              nlevels)
    levels = [image]
    for s in range(1, nlevels):
        levels.append(resize_u8_fast(levels[-1], shapes[s]))
    return levels


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 separable Gaussian, REFLECT_101, 16-bit fixed point.

    The border is built from explicit REFLECT_101 index vectors
    (`semantics.reflect101_index`), so it does not depend on how a backend
    implements `F.pad(mode="reflect")` for integer tensors."""
    k = S.gaussian_kernel7_fixed()
    h, w = img.shape
    half = 1 << (S.BLUR_BITS - 1)
    a = img.to(torch.int32).index_select(1, _reflect101_pad3(w, img.device))
    hp = sum(int(k[i]) * a[:, i:i + w] for i in range(7))
    hp = (hp + half) >> S.BLUR_BITS
    vp = hp.index_select(0, _reflect101_pad3(h, img.device))
    out = sum(int(k[i]) * vp[i:i + h] for i in range(7))
    out = (out + half) >> S.BLUR_BITS
    return out.to(torch.uint8)


# K14's tiles (csrc/blur7_u8.cu): output rows x columns of a block.
BLUR_TILE_H = 32
BLUR_TILE_W = 128
BLUR_MIN_SIDE = 4     # REFLECT_101 of a 3-pixel halo needs 4 pixels


@functools.lru_cache(maxsize=None)
def _blur_taps():
    """The seven taps of `semantics.gaussian_kernel7_fixed` as a C array,
    which `eff_blur7_u8` reads on the host into its launch's arguments."""
    return (ctypes.c_int32 * 7)(*S.gaussian_kernel7_fixed().tolist())


def gaussian_blur7_u8_kernel(img: torch.Tensor) -> torch.Tensor:
    """K14: `gaussian_blur7_u8` of a contiguous (H, W) uint8 CUDA tensor,
    H and W at least 4, bit for bit, in one kernel launch.  The taps are
    the host's (symmetric, which the kernel's sums rely on and its entry
    checks), passed by value in the launch, so a captured graph holds no
    pointer to them."""
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D, got shape {tuple(img.shape)}")
    h, w = img.shape
    if min(h, w) < BLUR_MIN_SIDE:
        raise ValueError(f"the blur takes at least {BLUR_MIN_SIDE} pixels "
                         f"a side, got {h}x{w}")
    require_cuda(img, torch.uint8, "img")
    out = torch.empty_like(img)
    lib = _build.library()
    with torch.cuda.device(img.device):
        rc = lib.eff_blur7_u8(img.data_ptr(), h, w, _blur_taps(),
                              out.data_ptr(), stream_of(img))
        _build.check(rc, "gaussian_blur7_u8_kernel")
        gaussian_blur7_u8_kernel.launches += 1
    return out


gaussian_blur7_u8_kernel.launches = 0


def gaussian_blur7_u8_fast(img: torch.Tensor) -> torch.Tensor:
    """`gaussian_blur7_u8`: through K14 for a CUDA tensor, the plain version
    for a CPU tensor.  The same bytes either way."""
    if img.device.type == "cpu":
        return gaussian_blur7_u8(img)
    return gaussian_blur7_u8_kernel(img)


def integral_image_i32(img: torch.Tensor) -> torch.Tensor:
    """(H+1, W+1) int32 integral, zero top row/left col, wrapping overflow.

    `dtype=torch.int32` keeps the scans in int32 (torch promotes integer
    cumsums to int64 otherwise); the sums wrap modulo 2^32 like the JAX
    version, which box sums of differences undo exactly."""
    h, w = img.shape
    c = torch.cumsum(torch.cumsum(img.to(torch.int32), 0, dtype=torch.int32),
                     1, dtype=torch.int32)
    out = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=img.device)
    out[1:, 1:] = c
    return out
