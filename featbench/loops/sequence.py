"""sequence: one step of a VO front end in flight:
`detect_and_compute_async` on the new frame, the masked ratio matcher
(`ops.matcher.knn2_ratio_match_masked`) against the previous frame's
outputs, RANSAC (`ops.ransac.find_homography_ransac`, seeded with the
step's index) on the matches; done when the keypoint count, the match
count, H and the inlier count are on the host.  A kept item is a pair of
frames with its matches and result; the check also compares the matches
with the reference's and H with the warp the frames were made with."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from efficient_features_tpu_torch.ops import matcher, ransac
from featbench import check as C
from featbench import frames as FR
from featbench.loops.base import as_port, descriptor, frame_stages
from featbench.reference import geometry as G
from featbench.reference import matching as RM
from featbench.roofline import stages as ST
from featbench.trace import Spans


@dataclass
class _Frame:
    index: int
    kps: object
    desc: torch.Tensor
    valid: torch.Tensor
    xy: torch.Tensor


@dataclass
class _Pair:
    prev: _Frame
    cur: _Frame
    j: torch.Tensor
    ok: torch.Tensor
    result: torch.Tensor


class Loop:
    frames_per_step = 1

    def __init__(self, feat, frames, traffic):
        self.feat, self.frames = feat, frames
        self.step_cfg = traffic["step"]
        self.prev = None

    def _frame(self, k, sp):
        i = k % len(self.frames)
        with sp.port("detect_and_compute_async"):
            kps, desc = self.feat.detect_and_compute_async(self.frames[i])
        with sp.bench("glue"):
            # KeyPoints keeps its device slots in `_slots` (x, y, valid, ...)
            s = kps._slots
            xy = torch.stack([s["x"], s["y"]], dim=1)
        return _Frame(i, kps, desc, s["valid"], xy)

    def prime(self, k):
        self.prev = self._frame(k, Spans())

    def step(self, k, sp):
        cur, prev, p = self._frame(k, sp), self.prev, self.step_cfg
        with sp.port("knn2_ratio_match_masked"):
            j, _, ok = matcher.knn2_ratio_match_masked(
                prev.desc, prev.valid, cur.desc, cur.valid, p["max_ratio"])
        with sp.bench("glue"):
            dst = cur.xy[j.long()]
        with sp.port("find_homography_ransac"):
            H, _, n_inl = ransac.find_homography_ransac(
                prev.xy, dst, ok, iters=p["ransac_iters"],
                thresh=p["ransac_thresh"], seed=k, device=cur.desc.device)
        with sp.port("count"):
            count = cur.kps.count
        with sp.bench("fetch"):
            result = torch.cat([H.reshape(-1).to(torch.float32),
                                ok.sum().reshape(1).to(torch.float32),
                                n_inl.reshape(1).to(torch.float32)]).cpu()
        if count < 1 or not torch.isfinite(result).all():
            raise RuntimeError(f"step {k}: {count} keypoints, H {result}")
        self.prev = cur
        return [_Pair(prev, cur, j, ok, result)]

    @staticmethod
    def host(kept):
        """Host copies of the kept steps: each frame's compacted arrays
        and descriptors, its slots' keys, and the matches as slot pairs."""
        def frame(f):
            s = {k: v.cpu().numpy() for k, v in f.kps._slots.items()
                 if k != "count"}
            arrays = f.kps.as_arrays()
            return arrays, f.desc.cpu().numpy()[s["valid"]], C.keys(s)
        out = []
        for p in kept:
            (pa, pd, pk), (ca, cd, ck) = frame(p.prev), frame(p.cur)
            ok = p.ok.cpu().numpy()
            j = p.j.cpu().numpy()
            pairs = [(int(i), int(j[i])) for i in np.nonzero(ok)[0]]
            res = p.result.numpy()
            out.append({"prev": (p.prev.index, pa, pd),
                        "cur": (p.cur.index, ca, cd),
                        "port": {"prev_keys": pk, "cur_keys": ck,
                                 "pairs": pairs,
                                 "H": res[:9].reshape(3, 3),
                                 "n_inliers": float(res[10])}})
        return out

    @staticmethod
    def pool_indices(kept) -> list:
        return [st[s][0] for st in kept for s in ("prev", "cur")]

    @staticmethod
    def readings(kept, ref, maps, traffic, device) -> list:
        p, out = traffic["step"], []
        for st in kept:
            (pi, pa, pd), (ci, ca, cd) = st["prev"], st["cur"]
            out.append(C.frame_readings(as_port(pa, pd), ref[pi]))
            out.append(C.frame_readings(as_port(ca, cd), ref[ci]))
            ij = RM.ratio_cross_matches(
                torch.from_numpy(ref[pi]["desc"]).to(device),
                torch.from_numpy(ref[ci]["desc"]).to(device), p["max_ratio"])
            ij = tuple(v.cpu().numpy() for v in ij)
            st["ref_matches"] = len(ij[0])
            out.append(C.pair_readings(
                st["port"], ref[pi], ref[ci], ij,
                FR.pair_homography(maps, pi, ci), ref[ci]["hw"],
                p["ransac_thresh"]))
        return out

    @staticmethod
    def stages(item, ref, config, traffic) -> dict:
        """The new frame's detection and description, the best-2 search
        against the previous frame and RANSAC over the reference's matches
        (counted by `readings`)."""
        pi, ci = item["prev"][0], item["cur"][0]
        stages = frame_stages(ref[ci], config)
        stages.update(ST.match_verify(
            len(ref[pi]["x"]), len(ref[ci]["x"]), descriptor(config)[1],
            item["ref_matches"], traffic["step"]["ransac_iters"]))
        return stages

    @staticmethod
    def step_frames(k, n, traffic) -> list:
        return [(k - 1) % n, k % n]

    @staticmethod
    def stand_in(steps, n, ctl, traffic, device, dtype) -> list:
        """The control's steps: its descriptors matched by the reference's
        matcher, and a plain RANSAC in `dtype` on those matches."""
        p, kept = traffic["step"], []
        for k in steps:
            pi, ci = (k - 1) % n, k % n
            a, b = ctl[pi], ctl[ci]
            i, j = RM.ratio_cross_matches(
                torch.from_numpy(a["desc"]).to(device),
                torch.from_numpy(b["desc"]).to(device), p["max_ratio"])
            i, j = i.cpu().numpy(), j.cpu().numpy()
            src = np.stack([a["x"][i], a["y"][i]], 1)
            dst = np.stack([b["x"][j], b["y"][j]], 1)
            H = G.ransac(torch.from_numpy(src).float().to(device),
                         torch.from_numpy(dst).float().to(device),
                         p["ransac_thresh"], p["ransac_iters"], k, dtype)
            kept.append({"prev": (pi, a, a["desc"]),
                         "cur": (ci, b, b["desc"]),
                         "port": {"prev_keys": C.keys(a),
                                  "cur_keys": C.keys(b),
                                  "pairs": list(zip(i.tolist(), j.tolist())),
                                  "H": H,
                                  "n_inliers": G.inliers(
                                      H, src, dst, p["ransac_thresh"])}})
        return kept
