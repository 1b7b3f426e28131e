"""The numbers that decide `correct`: the program's outputs for frames of
the measured window against the reference's, and the homography against
the warp the frames were made with.

Per frame (host arrays in level-major slot order; x, y, response, angle,
octave, desc):
- kp_mismatch: slots whose x, y, octave or response differ, plus the
  difference of the counts (an exact comparison);
- angle_gap_deg: the widest circular angle gap over the keypoints that
  both sides hold (same octave, x and y);
- desc_bytes_share: descriptor bytes that differ over those keypoints, as
  a share of the bytes compared.
Per step of a sequence cell:
- match_mismatch_share: matches (as pairs of keypoints) that one side has
  and the other lacks, over the reference's matches;
- h_corner_px: the widest distance between where the program's homography
  and the true one send the frame's corners;
- inlier_gap_share: the program's inlier count against the reference's
  matches that lie within the threshold of the true homography, over the
  latter.
A number is the worst over the frames and steps checked; it passes when it
is at most its limit.
"""
from __future__ import annotations

import numpy as np

from .reference import geometry as G
from .reference.features import angle_gap_deg

FIELDS = ("x", "y", "octave", "response")


def keys(a: dict) -> list:
    """(octave, x, y) of each keypoint of host arrays."""
    return list(zip(a["octave"].tolist(), a["x"].tolist(), a["y"].tolist()))


def frame_readings(port: dict, ref: dict) -> dict:
    n_p, n_r = len(port["x"]), len(ref["x"])
    n = min(n_p, n_r)
    differ = np.zeros(n, bool)
    for k in FIELDS:
        differ |= np.asarray(port[k][:n], np.float64) != \
            np.asarray(ref[k][:n], np.float64)
    where = {k: i for i, k in enumerate(keys(ref))}
    pairs = [(i, where[k]) for i, k in enumerate(keys(port)) if k in where]
    if pairs:
        ip, ir = (np.array(v) for v in zip(*pairs))
        gap = float(angle_gap_deg(port["angle"][ip], ref["angle"][ir]).max())
        dp, dr = port["desc"][ip], ref["desc"][ir]
        share = float(np.count_nonzero(dp != dr)) / dp.size
    else:
        gap, share = float("inf"), 1.0
    return {"kp_mismatch": float(differ.sum() + abs(n_p - n_r)),
            "angle_gap_deg": gap, "desc_bytes_share": share}


def pair_readings(port: dict, ref_prev: dict, ref_cur: dict,
                  ref_ij: tuple, H_true: np.ndarray, hw, thresh: float
                  ) -> dict:
    """port: prev_keys / cur_keys (lists of (octave, x, y) per slot),
    pairs ((prev slot, cur slot) of every match), H, n_inliers."""
    kp, kc = port["prev_keys"], port["cur_keys"]
    got = {(kp[i], kc[j]) for i, j in port["pairs"]}
    rp, rc = keys(ref_prev), keys(ref_cur)
    i, j = ref_ij
    want = {(rp[a], rc[b]) for a, b in zip(i.tolist(), j.tolist())}
    src = np.stack([ref_prev["x"][i], ref_prev["y"][i]], 1)
    dst = np.stack([ref_cur["x"][j], ref_cur["y"][j]], 1)
    n_ref = G.inliers(H_true, src, dst, thresh)
    return {"match_mismatch_share": len(got ^ want) / max(1, len(want)),
            "h_corner_px": G.corner_gap_px(np.asarray(port["H"], np.float64),
                                           H_true, hw),
            "inlier_gap_share": abs(float(port["n_inliers"]) - n_ref)
            / max(1, n_ref)}


def worst(readings: list) -> dict:
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}) over the
    limits given; a number that was not read fails."""
    table = {k: {"value": readings.get(k, float("nan")), "limit": lim}
             for k, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return bool(ok), table
