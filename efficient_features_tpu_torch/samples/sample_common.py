"""Shared sample utilities (the reference's samples/sample_common.{h,cpp}).

The port's own copies of what `samples/sample_common.py` and `bench.py`
provide: image IO, the descriptor-type flag and the synthetic scenes.  cv2
or PIL is imported only to read an image from a path, so every CLI runs in
a bare environment on synthetic scenes.
"""
from __future__ import annotations

import numpy as np


def make_bench_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Corner-rich synthetic scene (stand-in for SceauxCastle photos); the
    same pixels as `bench.make_bench_image`."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    img += 60 + 60 * (xx / w) + 40 * np.sin(yy / 57.0)
    for _ in range(600):
        x0 = rng.integers(0, w - 8)
        y0 = rng.integers(0, h - 8)
        bw = int(rng.integers(6, w // 12))
        bh = int(rng.integers(6, h // 12))
        img[y0:y0 + bh, x0:x0 + bw] += float(rng.uniform(-90, 90))
    img += rng.normal(0, 3, (h, w))
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.uint8)


def make_test_image(h: int = 480, w: int = 640, seed: int = 0) -> np.ndarray:
    """Corner-rich synthetic scene of textured rectangles and circles; the
    same pixels as `tests/util.make_test_image`, the repository's test
    scene."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    img += 60 + 60 * (xx / w) + 40 * np.sin(yy / 37.0)
    for _ in range(120):
        x0 = rng.integers(0, w - 8)
        y0 = rng.integers(0, h - 8)
        bw = int(rng.integers(4, 60))
        bh = int(rng.integers(4, 60))
        val = float(rng.uniform(-110, 110))
        img[y0:y0 + bh, x0:x0 + bw] += val
    for _ in range(30):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(4, 30)
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img[mask] += rng.uniform(-80, 80)
    img += rng.normal(0, 3, (h, w))
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.uint8)


def tiled_scene(h: int, w: int, seed: int, distinct: bool) -> np.ndarray:
    """(h, w) scene of 8x8 `make_test_image` tiles of (h/8, w/8): one tile
    repeated (seed), or 64 different tiles (seeds seed..seed+63).  A single
    full-size `make_test_image` holds too few corners for 40000 features at
    4K; a repeated tile repeats every descriptor 64 times, which a ratio
    test rejects, so matching needs the distinct tiles."""
    th, tw = h // 8, w // 8
    if not distinct:
        return np.tile(make_test_image(th, tw, seed=seed), (8, 8))
    tiles = [make_test_image(th, tw, seed=seed + k) for k in range(64)]
    return np.block([[tiles[8 * r + c] for c in range(8)] for r in range(8)])


def roi_mask(h: int, w: int) -> np.ndarray:
    """(h, w) uint8 ROI mask, 255 = search here: zero in the bottom 22% of
    rows (a forward dash camera's hood) and outside the ellipse inscribed in
    the frame (a fisheye's image circle)."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    inside = ((yy - cy) / (h / 2.0)) ** 2 + ((xx - cx) / (w / 2.0)) ** 2 <= 1.0
    inside[int(round(0.78 * h)):] = False
    return np.where(inside, 255, 0).astype(np.uint8)


def load_gray(path: str | None, h: int = 1080, w: int = 1920,
              seed: int = 0) -> np.ndarray:
    """Load a grayscale u8 image, or synthesize a corner-rich scene."""
    if path:
        try:
            import cv2
        except ImportError:
            from PIL import Image
            return np.asarray(Image.open(path).convert("L"))
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    return make_bench_image(h, w, seed)


def descriptor_type(desc_kind: int, desc_bits: int) -> str:
    """Map the reference CLI convention (0:BAD 1:HashSIFT x 256/512)."""
    kind = ["bad", "hash_sift"][desc_kind]
    return f"{kind}_{desc_bits}"


def warp_image(img: np.ndarray, angle_deg: float, tx: float, ty: float
               ) -> np.ndarray:
    """Small rigid warp for synthetic sequences (nearest-neighbour): the
    output pixel p takes the input pixel nearest to the point q with
    p = R (q - c + t) + c (see `warp_matrix`)."""
    h, w = img.shape
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = w / 2, h / 2
    sx = c * (xx - cx) + s * (yy - cy) + cx - tx
    sy = -s * (xx - cx) + c * (yy - cy) + cy - ty
    sxi = np.clip(np.round(sx).astype(int), 0, w - 1)
    syi = np.clip(np.round(sy).astype(int), 0, h - 1)
    return img[syi, sxi]


def warp_matrix(hw: tuple[int, int], angle_deg: float, tx: float,
                ty: float) -> np.ndarray:
    """3x3 float64 homography taking input coordinates q to the coordinates
    p = R (q - c + t) + c that `warp_image(img, angle_deg, tx, ty)` moves
    them to (R: rotation by angle_deg, c: the image centre (w/2, h/2))."""
    h, w = hw
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, -s], [s, c]])
    centre = np.array([w / 2, h / 2])
    out = np.eye(3)
    out[:2, :2] = rot
    out[:2, 2] = rot @ (np.array([tx, ty]) - centre) + centre
    return out
