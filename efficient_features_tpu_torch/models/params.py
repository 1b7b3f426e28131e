"""Learned descriptor constants (Suarez et al., RA-L 2021).

The BAD box pairs and thresholds and the HashSIFT projection matrices are the
JAX package's `.npz` assets, read by file path so that the port imports
neither jax nor `efficient_features_tpu`.  `bad_params_from_numpy` and
`hash_sift_params_from_numpy` carry those numpy arrays over to device
tensors.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_ASSETS = (Path(__file__).resolve().parents[2] / "efficient_features_tpu"
           / "assets")


class BadParams(NamedTuple):
    """BAD tables on one device.

    boxes: (5, nbits) float32 rows x1, x2, y1, y2, boxRadius (patch coords).
    thresholds: (nbits,) float32.
    """
    boxes: torch.Tensor
    thresholds: torch.Tensor

    @property
    def nbits(self) -> int:
        return int(self.thresholds.shape[0])


@functools.lru_cache(maxsize=None)
def load_bad_params(nbits: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (box_pairs (nbits, 5) int32, thresholds (nbits,) float32)."""
    if nbits not in (256, 512):
        raise ValueError(f"BAD supports 256 or 512 bits, got {nbits}")
    data = np.load(_ASSETS / f"bad_p{nbits}.npz")
    return data["box_pairs"], data["thresholds"]


def bad_params_from_numpy(box_pairs: np.ndarray, thresholds: np.ndarray,
                          device) -> BadParams:
    """(nbits, 5) box pairs + (nbits,) thresholds -> BadParams on `device`."""
    box_pairs = np.asarray(box_pairs)
    thresholds = np.asarray(thresholds, np.float32)
    if box_pairs.ndim != 2 or box_pairs.shape[1] != 5:
        raise ValueError(f"box_pairs must be (nbits, 5), got {box_pairs.shape}")
    if thresholds.shape != (box_pairs.shape[0],):
        raise ValueError(f"thresholds must be ({box_pairs.shape[0]},), got "
                         f"{thresholds.shape}")
    boxes = np.ascontiguousarray(box_pairs.T.astype(np.float32))
    return BadParams(torch.from_numpy(boxes).to(device),
                     torch.from_numpy(thresholds.copy()).to(device))


@functools.lru_cache(maxsize=None)
def bad_params(nbits: int, device: str) -> BadParams:
    """The shipped BAD tables for `nbits` on `device` (cached; read-only)."""
    return bad_params_from_numpy(*load_bad_params(nbits), device)


class HashSiftParams(NamedTuple):
    """HashSIFT projection on one device, for descriptor rows in the
    orientation-major layout e[o*16 + rc] (ops/hash_sift.py).

    b0: (nbits,) float32 bias column.  bp: (nbits, 128) float32 columns
    1.. of the matrix, permuted so that proj = e @ bp.T + b0.
    """
    b0: torch.Tensor
    bp: torch.Tensor


# HashSIFT rows in the orientation-major layout: entry l = o*16 + rc holds
# entry (l % 16)*8 + l // 16 = rc*8 + o of the reference's (rc, o) layout
# (the JAX package's hash_sift.hs_fused_projection)
HS_ORIENT_MAJOR = np.array([(l % 16) * 8 + l // 16 for l in range(128)])


@functools.lru_cache(maxsize=None)
def load_hash_sift_matrix(nbits: int) -> np.ndarray:
    """Returns the (nbits, 129) float32 projection matrix (col 0 = bias)."""
    if nbits not in (256, 512):
        raise ValueError(f"HashSIFT supports 256 or 512 bits, got {nbits}")
    data = np.load(_ASSETS / f"hash_sift_p{nbits}.npz")
    return data["b_matrix"].astype(np.float32)


def hash_sift_params_from_numpy(B: np.ndarray, device) -> HashSiftParams:
    """(nbits, 129) projection matrix -> HashSiftParams on `device`."""
    B = np.asarray(B, np.float32)
    if B.ndim != 2 or B.shape[1] != 129:
        raise ValueError(f"B must be (nbits, 129), got {B.shape}")
    b0 = np.ascontiguousarray(B[:, 0])
    bp = np.ascontiguousarray(B[:, 1 + HS_ORIENT_MAJOR])
    return HashSiftParams(torch.from_numpy(b0).to(device),
                          torch.from_numpy(bp).to(device))


@functools.lru_cache(maxsize=None)
def hash_sift_params(nbits: int, device: str) -> HashSiftParams:
    """The shipped HashSIFT projection for `nbits` on `device` (cached;
    read-only)."""
    return hash_sift_params_from_numpy(load_hash_sift_matrix(nbits), device)
