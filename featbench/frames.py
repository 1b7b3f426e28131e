"""Seeded frames: a scene of distinct textured tiles and rigid warps of it
along a closed camera path.

The scene is 8 x 8 tiles, each a corner-rich picture of a gradient, a
sine band, 120 rectangles and 30 discs of random brightness and Gaussian
noise, stretched to 0..255 (the repository's test scene, drawn here with a
torch generator so that a 4K frame takes milliseconds on the card).  Tile k
has its own draws, so no two tiles repeat and a ratio test can match them.
Rectangles and discs are summed in integers, so a seed gives the same
scene however the device orders its adds.

Frame k is the scene under a rigid nearest-neighbour warp (rotation about
the centre, then a shift) by pose k of a closed path: each of angle, x and
y shift follows a sine over the pool with a phase drawn from the seed, so
the last frame is as near the first as any two neighbours are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RECTS, DISCS = 120, 30
FIX = 256                     # fixed-point scale of the brightness steps


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float64)


def scene(h: int, w: int, seed: int, device) -> torch.Tensor:
    """(h, w) uint8 scene of 8 x 8 distinct tiles of ceil(h / 8) x
    ceil(w / 8), cropped to (h, w)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    th, tw = -(-h // 8), -(-w // 8)
    nt = 64

    # rectangles: a difference array per tile, summed by two cumsums
    x0 = torch.randint(0, tw - 8, (nt, RECTS), generator=gen, device=dev)
    y0 = torch.randint(0, th - 8, (nt, RECTS), generator=gen, device=dev)
    bw = torch.randint(4, 60, (nt, RECTS), generator=gen, device=dev)
    bh = torch.randint(4, 60, (nt, RECTS), generator=gen, device=dev)
    val = torch.round(_uniform(gen, (nt, RECTS), -110, 110, dev)
                      * FIX).to(torch.int64)
    x1, y1 = (x0 + bw).clamp(max=tw), (y0 + bh).clamp(max=th)
    diff = torch.zeros((nt, th + 1, tw + 1), dtype=torch.int64, device=dev)
    tile = torch.arange(nt, device=dev)[:, None].expand(nt, RECTS)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_put_((tile, yy, xx), sign * val, accumulate=True)
    acc = diff.cumsum(1).cumsum(2)[:, :th, :tw]

    # discs: each over a 64 x 64 box of offsets around its centre
    cx = _uniform(gen, (nt, DISCS), 0, tw, dev)
    cy = _uniform(gen, (nt, DISCS), 0, th, dev)
    r = _uniform(gen, (nt, DISCS), 4, 30, dev)
    dval = torch.round(_uniform(gen, (nt, DISCS), -80, 80, dev)
                       * FIX).to(torch.int64)
    off = torch.arange(-32, 32, device=dev)
    px = torch.floor(cx)[..., None, None].long() + off[None, None, None, :]
    py = torch.floor(cy)[..., None, None].long() + off[None, None, :, None]
    px, py = torch.broadcast_tensors(px, py)
    inside = (((px - cx[..., None, None]) ** 2 + (py - cy[..., None, None])
               ** 2) < (r * r)[..., None, None]) & (px >= 0) & (px < tw) & \
        (py >= 0) & (py < th)
    t = torch.arange(nt, device=dev)[:, None, None, None].expand_as(inside)
    acc.index_put_((t[inside], py[inside], px[inside]),
                   dval[..., None, None].expand_as(inside)[inside],
                   accumulate=True)

    yy = torch.arange(th, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(tw, device=dev, dtype=torch.float64)[None, :]
    img = (60 + 60 * (xx / tw) + 40 * torch.sin(yy / 37.0))[None] \
        + acc.to(torch.float64) / FIX \
        + 3.0 * torch.randn((nt, th, tw), generator=gen, device=dev,
                            dtype=torch.float64)
    img = img - img.amin(dim=(1, 2), keepdim=True)
    img = img * (255.0 / img.amax(dim=(1, 2), keepdim=True).clamp(min=1e-9))
    tiles = img.to(torch.uint8).reshape(8, 8, th, tw)
    return tiles.permute(0, 2, 1, 3).reshape(8 * th, 8 * tw)[:h, :w] \
        .contiguous()


def poses(n: int, seed: int, rotate_deg: float, shift_px: float):
    """n (angle_deg, tx, ty) poses on a closed path: amplitude times the
    sine of 2 pi k / n plus a phase of the seed's."""
    ph = np.random.default_rng(seed).uniform(0.0, 2 * math.pi, 3)
    k = 2 * math.pi * np.arange(n) / n
    return [(float(rotate_deg * math.sin(a + ph[0])),
             float(shift_px * math.sin(a + ph[1])),
             float(shift_px * math.sin(a + ph[2]))) for a in k]


def warp(img: torch.Tensor, angle_deg: float, tx: float,
         ty: float) -> torch.Tensor:
    """Output pixel p takes the input pixel nearest to the point q with
    p = R (q - c + t) + c, clamped to the image (see `warp_matrix`)."""
    h, w = img.shape
    dev = img.device
    th = math.radians(angle_deg)
    c, s = math.cos(th), math.sin(th)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    cx, cy = w / 2, h / 2
    sx = c * (xx - cx) + s * (yy - cy) + cx - tx
    sy = -s * (xx - cx) + c * (yy - cy) + cy - ty
    sxi = torch.round(sx).long().clamp(0, w - 1)
    syi = torch.round(sy).long().clamp(0, h - 1)
    return img[syi, sxi]


def warp_matrix(hw, angle_deg: float, tx: float, ty: float) -> np.ndarray:
    """3 x 3 float64 map of scene coordinates q to the frame coordinates
    p = R (q - c + t) + c of `warp(img, angle_deg, tx, ty)`."""
    h, w = hw
    th = math.radians(angle_deg)
    c, s = math.cos(th), math.sin(th)
    rot = np.array([[c, -s], [s, c]])
    centre = np.array([w / 2, h / 2])
    out = np.eye(3)
    out[:2, :2] = rot
    out[:2, 2] = rot @ (np.array([tx, ty]) - centre) + centre
    return out


def make_pool(h: int, w: int, seed: int, n: int, rotate_deg: float,
              shift_px: float, device):
    """(frames, maps): n host uint8 frames (numpy) of one scene along the
    closed path, and the 3 x 3 map of each from scene coordinates."""
    base = scene(h, w, seed, device)
    frames, maps = [], []
    for pose in poses(n, seed, rotate_deg, shift_px):
        frames.append(warp(base, *pose).cpu().numpy())
        maps.append(warp_matrix((h, w), *pose))
    return frames, maps


def pair_homography(maps, prev: int, cur: int) -> np.ndarray:
    """The true map from frame `prev`'s coordinates to frame `cur`'s."""
    return maps[cur] @ np.linalg.inv(maps[prev])
