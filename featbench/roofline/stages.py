"""The least work of one frame, stage by stage, counted from the frame's
shapes and the reference's counts, so that it is the same whatever
implements the stages.

Each stage gives (bytes, float32 ops, int32 compares, 1-bit tensor-core
ops); a frame's bound is the larger of its bytes over the memory rate and
each kind of operation over its rate (the units run side by side), which
holds however the stages are fused or overlapped.  Bytes are those no
implementation avoids: the frame read once, and the keypoints and
descriptors it returns written once; every intermediate (levels, response
maps, survivors, blurred levels) could stay on chip.  Operations are the
algorithm's own arithmetic, each counted once:

- pyramid: per destination pixel of levels 1.. 6 multiplies, 3 adds, the
  rounding add and the shift (11);
- detect: FAST at every pixel of every level large enough to search (16
  differences, 32 threshold compares), per FAST corner inside the 15 px
  border 2 x 147 for the Sobel products and 7 x 7 sums of the Harris
  tensor, and one compare per pixel of the NMS disc;
- select: one compare per NMS survivor and 4 per slot placed;
- orientation: a multiply-add per moment per pixel of the 31 px circular
  patch (2 x 2 x 749) per keypoint;
- blur: 7 multiplies, 6 adds and a rounding add and shift per pass, two
  passes, per pixel (30) of each level that holds a keypoint;
- describe, BAD: the integral image of those levels (2 adds a pixel) and
  per bit two box sums (3 adds each) and the weighted compare (3);
- describe, HashSIFT (no integral image), per keypoint, each IEEE
  operation once and a sqrt or atan2 as one, as its reference
  (`reference/hash_sift.py`) computes it:
  - the warp, 26 a sample of 32 x 32: the two coordinates (2 multiplies
    and 2 adds each), their floors and fractions (4), the bilinear lerp
    (11: the weights 1 - du and 1 - dv, 3 for each row, 3 between the
    rows), the rounding add, trunc and the cap at 255 (3);
  - 33 a pixel of the 30 x 30 interior: the gradient (2 differences), its
    magnitude (2 multiplies, an add, a sqrt) times the Gaussian weight, a
    constant of the pixel (1),
    the orientation bin (atan2, the scale, floor, fraction: 4), the
    trilinear weights (2 a row split, 2 x 2 a column split, 4 x 2 an
    orientation split: 14) and the 8 votes' adds;
  - 1570 to finish: the fold of orientation bins 8 and 9 (32 adds), two
    L2 normalisations of 128 entries (128 squares, 127 adds, a sqrt, the
    epsilon max, 128 divides: 385 each), the clip at 0.2 (128), the
    quantisation (a multiply, an add, trunc and two clamps: 5 x 128);
  - the projection of [1, d] on nbits rows of 129: 2 x 129 x nbits;
- match (sequence cells): the best-2 search both ways, n1 n2 nbits bit
  products of 2 ops each at the 1-bit tensor-core rate and an int32 min
  per distance, reading the previous frame's descriptors;
- verify (sequence cells): per hypothesis a 4-point DLT (902 float32 ops:
  Hartley normalisation, design, normal matrix, denormalisation; the
  eigen-solve is not charged) and 23 float32 ops per hypothesis and match
  for the transfer error and the compare, then the refit's 23 per match.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import peaks as PK

DLT4_OPS = 2 * 46 + 36 + 45 * 16 + 54
HS_WARP_OPS = 26 * 32 * 32
HS_PIXEL_OPS = 33 * 30 * 30
HS_FINISH_OPS = 32 + 2 * 385 + 128 + 5 * 128
VERIFY_OPS = 23
SLOT_BYTES = 25      # x, y, response, angle, size (f32), octave (i32), valid


@dataclass
class Work:
    bytes: float = 0.0
    f32: float = 0.0
    int32: float = 0.0
    b1: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.f32 + other.f32,
                    self.int32 + other.int32, self.b1 + other.b1)

    def ms(self) -> float:
        """The least time at the peak rates, in ms."""
        return 1e3 * max(self.bytes / PK.PEAK_BYTES, self.f32 / PK.PEAK_F32,
                         self.int32 / PK.PEAK_INT32, self.b1 / PK.PEAK_B1_TC)


def hash_sift_ops(nbits: int) -> int:
    """float32 operations of one HashSIFT descriptor."""
    return HS_WARP_OPS + HS_PIXEL_OPS + HS_FINISH_OPS + 2 * 129 * nbits


def detect_describe(counts: dict, disc_pixels: int, ic_pixels: int,
                    kind: str, nbits: int) -> dict:
    """Stage work of detecting and describing one frame from the
    reference's per-level counts (pixels, searched, corners, survivors,
    kept), with descriptors of `kind` ("bad" or "hash_sift") and `nbits`
    bits."""
    px, kept = counts["pixels"], sum(counts["kept"])
    lit = sum(p for p, k in zip(px, counts["kept"]) if k)
    if kind == "bad":
        describe = 2.0 * lit + 9.0 * nbits * kept
    elif kind == "hash_sift":
        describe = float(hash_sift_ops(nbits) * kept)
    else:
        raise ValueError(f"no descriptor kind {kind!r}")
    return {
        "pyramid": Work(bytes=px[0], f32=11.0 * sum(px[1:])),
        "detect": Work(f32=48.0 * sum(counts["searched"])
                       + sum(counts["corners"]) * (2.0 * 147 + disc_pixels)),
        "select": Work(f32=float(sum(counts["survivors"])) + 4.0 * kept),
        "orientation": Work(f32=4.0 * ic_pixels * kept),
        "blur": Work(f32=30.0 * lit),
        "describe": Work(bytes=kept * (SLOT_BYTES + nbits // 8),
                         f32=describe),
    }


def match_verify(n1: int, n2: int, nbits: int, matches: int,
                 iters: int) -> dict:
    """Stage work of the best-2 search both ways between n1 and n2 valid
    descriptors and of RANSAC over `matches` pairs."""
    return {
        "match": Work(bytes=n1 * nbits // 8, int32=2.0 * n1 * n2,
                      b1=2 * 2.0 * n1 * n2 * nbits),
        "verify": Work(f32=iters * DLT4_OPS
                       + (iters + 1) * matches * VERIFY_OPS),
    }


def bound_ms(stages: dict) -> float:
    """The frame's least time: its stages' work summed, at the peaks."""
    total = Work()
    for w in stages.values():
        total = total + w
    return total.ms()


def share_pct(bound: float, busy: float) -> float | None:
    """The bound as a percentage of the measured time, None without a
    measured time."""
    return 100.0 * bound / busy if busy > 0 else None
