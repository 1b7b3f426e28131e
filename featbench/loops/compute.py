"""compute: the reference's compute-only benchmark, one frame in flight:
the host frame and its keypoints, a host (N, 4) float32 [x, y, size,
angle] array in level-0 coordinates, handed to
`EfficientFeatures.compute` with BAD; done when the (N, bytes)
descriptors are on the host.  Each pool frame's keypoints are made once,
untimed, by the program's `detect` (`KeyPoints.xysa()`: size 31 *
scale^octave), before the warm-up.

The check holds the given keypoints to the reference's detection of the
same frame (`pool_indices` names the kept frames): `given_kp_mismatch` is
the number of given keypoints whose x, y or size (31 * the scale of the
reference's octave) differ, plus the difference of the counts, and
`given_angle_gap_deg` the widest angle gap over them; a detect fault that
moved keypoints between octaves, or cut their number, cannot leave the
cell's work unseen.  It then describes the raw frame (no blur) at the
given keypoints with the reference's BAD: `kp_mismatch` is the number of
rows that differ from the given count, `desc_bytes_share` the share of
descriptor bytes that differ."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from featbench.loops.base import descriptor
from featbench.reference import features as RF
from featbench.reference import semantics as RS
from featbench.roofline import stages as ST

KEYPOINT_BYTES = 16          # x, y, size, angle (float32), read once


class Item(NamedTuple):
    pool: int                # the pool frame's index
    xysa: np.ndarray         # the given keypoints
    desc: np.ndarray         # the rows described
    frame: np.ndarray        # the host frame
    nbits: int
    sizes: np.ndarray        # float32 31 * scale of each octave


def octave_sizes(scale_factor: float, nlevels: int) -> np.ndarray:
    """A keypoint's size at each octave, in float32 as a detector sets
    it."""
    return np.float32(RS.PATCH_SIZE) * np.float32(
        RS.pyramid_scales(scale_factor, nlevels))


def given_readings(xysa, ref: dict, sizes) -> dict:
    """The given keypoints against the reference's detection."""
    n_g, n_r = len(xysa), len(ref["x"])
    n = min(n_g, n_r)
    want = np.stack([ref["x"][:n], ref["y"][:n],
                     sizes[np.asarray(ref["octave"][:n], np.int64)]], 1)
    differ = np.any(np.asarray(xysa[:n, :3], np.float64)
                    != np.asarray(want, np.float64), axis=1)
    gap = float(RF.angle_gap_deg(xysa[:n, 3], ref["angle"][:n]).max()) \
        if n else float("inf")
    return {"given_kp_mismatch": float(differ.sum() + abs(n_g - n_r)),
            "given_angle_gap_deg": gap}


def describe_readings(item: Item, device) -> dict:
    """The check's numbers of one frame's rows against the reference's."""
    kp = torch.from_numpy(np.ascontiguousarray(item.xysa, np.float32))
    img = torch.from_numpy(item.frame).to(device)
    want = RF.bad(img, *kp.to(device).T, nbits=item.nbits).cpu().numpy()
    desc = np.asarray(item.desc)
    if desc.shape == want.shape:
        share = float(np.count_nonzero(desc != want)) / max(1, want.size)
    else:
        share = 1.0
    return {"kp_mismatch": float(abs(len(desc) - len(item.xysa))),
            "desc_bytes_share": share}


class Loop:
    frames_per_step = 1

    def __init__(self, feat, frames, traffic):
        kind, nbits = feat.get_descriptor_type().rsplit("_", 1)
        if kind != "bad":
            raise ValueError(f"the compute loop describes with BAD, not "
                             f"{feat.get_descriptor_type()}")
        self.feat, self.frames, self.nbits = feat, frames, int(nbits)
        self.sizes = octave_sizes(feat.get_scale_factor(),
                                  feat.get_n_levels())
        self.xysa = [feat.detect(f).xysa() for f in frames]

    def prime(self, k):
        pass

    def step(self, k, sp):
        i = self.step_frames(k, len(self.frames), None)[0]
        with sp.port("compute"):
            desc = self.feat.compute(self.frames[i], self.xysa[i])
        return [Item(i, self.xysa[i], desc, self.frames[i], self.nbits,
                     self.sizes)]

    @staticmethod
    def host(kept):
        return kept

    @staticmethod
    def pool_indices(kept) -> list:
        return [item.pool for item in kept]

    @staticmethod
    def readings(kept, ref, maps, traffic, device) -> list:
        return [{**given_readings(item.xysa, ref[item.pool], item.sizes),
                 **describe_readings(item, device)} for item in kept]

    @staticmethod
    def stages(item, ref, config, traffic) -> dict:
        """One describe stage: the frame read once, each keypoint read and
        its row written once; BAD's integral of the frame (2 adds a pixel)
        and 9 nbits a keypoint."""
        n, px = len(item.xysa), item.frame.size
        return {"describe": ST.Work(
            bytes=px + n * (KEYPOINT_BYTES + item.nbits // 8),
            f32=2.0 * px + 9.0 * item.nbits * n)}

    @classmethod
    def step_frames(cls, k, n, traffic) -> list:
        return [k % n]

    @classmethod
    def stand_in(cls, steps, n, ctl, traffic, device, dtype) -> list:
        raise NotImplementedError(
            "the control of a compute cell describes the frames themselves, "
            "which featbench/control.py hands no loop: run "
            "featbench/control_compute.py")

    @classmethod
    def control_items(cls, feat, frames, steps, config, device,
                      lowp) -> list:
        """The items the reference gives in the program's place for the
        pool frames of `steps`: the program's keypoints, as a run makes
        them, described by the reference's BAD in `lowp` (None:
        float32)."""
        _, nbits = descriptor(config)
        d = config["detector"]
        sizes = octave_sizes(d["scale_factor"], d["nlevels"])
        out = []
        for i in (j for k in steps
                  for j in cls.step_frames(k, len(frames), None)):
            xysa = feat.detect(frames[i]).xysa()
            kp = torch.from_numpy(xysa).to(device)
            img = torch.from_numpy(frames[i]).to(device)
            desc = RF.bad(img, *kp.T, nbits=nbits, lowp=lowp).cpu().numpy()
            out.append(Item(i, xysa, desc, frames[i], nbits, sizes))
        return out
