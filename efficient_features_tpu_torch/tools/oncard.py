"""Helpers shared by the port's runs on a CUDA card: `chip_smoke.py`,
`tools/profile_paths.py` and the `cuda` tests.

Importing this module needs neither a card nor `nvidia-smi`: only `card()`
and `host_syncs()` touch them, when called.
"""
from __future__ import annotations

import subprocess
import warnings

import numpy as np
import torch


def card() -> str:
    """The first card's name and power limit, as `nvidia-smi` reports them:
    written beside every time measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def host_syncs(fn) -> list[str]:
    """The messages of the host syncs that one call of fn makes (torch's
    sync debug mode); their number is the count of syncs."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
        return [str(w.message) for w in caught
                if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode("default")


def tie_image() -> np.ndarray:
    """Two identical corner patterns 4 px apart: tied co-survivors inside
    one 8x8 block (the case of tests/test_kernels.py's tie test)."""
    img = np.full((96, 160), 40, np.uint8)
    img[40:44, 60:64] = 220
    img[44:48, 64:68] = 220
    return img


def tie_mask() -> np.ndarray:
    """ROI mask of `tie_image` (255 = search) that cuts one of its two tied
    8x8 blocks at column 66 and leaves the other tied, so selection must
    place tied survivors of the masked map."""
    mask = np.full((96, 160), 255, np.uint8)
    mask[:, 66:] = 0
    return mask


def equal_image(h: int, w: int) -> np.ndarray:
    """One bright pixel every 6 px each way: each is a FAST corner and all
    have the same Harris response, so every corner ties with every other,
    all survive, and K1's NMS scans the whole disc of each."""
    cell = np.full((6, 6), 40, np.uint8)
    cell[3, 3] = 220
    return np.tile(cell, (-(-h // 6), -(-w // 6)))[:h, :w].copy()
