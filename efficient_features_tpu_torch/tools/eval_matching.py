"""Matching-quality evaluation of the port over the repository's real
fixtures (counterpart of `tools/eval_matching.py`).

For each fixture under `tests/data/` it synthesizes a view pair under a
KNOWN homography, runs the port's detect + describe + match, and reports
  - repeatability: share of view-1 keypoints whose ground-truth projection
    has a view-2 keypoint within `eps` px,
  - inlier rate: share of cross-checked Hamming matches consistent with the
    ground-truth homography within `eps` px,
  - match and keypoint counts.

    python -m efficient_features_tpu_torch.tools.eval_matching \
        [--device cuda|cpu] [--out FILE]

Prints the summary as one JSON line; `--out` also writes summary and rows
to a file.  The homographies, the warp and the metrics are the same as the
JAX tool's, so the two tools' numbers compare directly.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.ops import matcher

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FIXTURES = ("real_montage", "real_photo", "real_hitex",
            "real_lowtex", "real_saturated")

# real_lowtex has no corner passing the default FAST threshold 20
FIXTURE_THRESHOLD = {"real_lowtex": 2}


def _homographies(w, h):
    """One rigid-ish and one projective view change per fixture."""
    cx, cy = w / 2.0, h / 2.0
    th = np.deg2rad(8.0)
    c, s = np.cos(th), np.sin(th)
    # rotate 8 deg about center, shift (12, -7), scale 1.05
    T1 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) * 1.0
    S = np.diag([1.05, 1.05, 1.0])
    T0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    D = np.array([[1, 0, 12.0], [0, 1, -7.0], [0, 0, 1.0]])
    H_rigid = D @ T1 @ R @ S @ T0
    # mild perspective tilt
    H_proj = np.array([[1.02, 0.03, 5.0],
                       [-0.02, 0.98, 3.0],
                       [4e-5, -3e-5, 1.0]])
    return {"rigid": H_rigid, "proj": H_proj}


def apply_homography(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Bilinear inverse-map warp of a u8 image under forward homography H
    (dst(x2) = src(H^-1 x2)); out-of-bounds samples clamp to the border."""
    h, w = img.shape
    Hi = np.linalg.inv(H)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    sx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / d
    sy = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / d
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = np.clip(sx - x0, 0.0, 1.0)
    fy = np.clip(sy - y0, 0.0, 1.0)
    f = img.astype(np.float64)
    v = ((1 - fy) * ((1 - fx) * f[y0, x0] + fx * f[y0, x0 + 1])
         + fy * ((1 - fx) * f[y0 + 1, x0] + fx * f[y0 + 1, x0 + 1]))
    return np.clip(np.round(v), 0, 255).astype(np.uint8)


def project(H: np.ndarray, x: np.ndarray, y: np.ndarray):
    d = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    return ((H[0, 0] * x + H[0, 1] * y + H[0, 2]) / d,
            (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / d)


def evaluate_pair(img1: np.ndarray, H: np.ndarray, *, nfeatures=2000,
                  descriptor_type="bad_256", eps=3.0, threshold=20,
                  device="cuda"):
    """Detect and describe both views of the pair (img1, warp(img1, H)) and
    return the metric dict.  Keypoints whose projection leaves the second
    view (15 px border margin) are excluded from repeatability."""
    img2 = apply_homography(img1, H)
    h, w = img1.shape
    feat = EfficientFeatures(nfeatures=nfeatures, fast_threshold=threshold,
                             descriptor_type=descriptor_type, device=device)
    kps1, d1 = feat.detect_and_compute(img1)
    kps2, d2 = feat.detect_and_compute(img2)
    a1, a2 = kps1.as_arrays(), kps2.as_arrays()
    x1, y1, x2, y2 = a1["x"], a1["y"], a2["x"], a2["y"]
    if len(x1) == 0 or len(x2) == 0:
        return {"n_kp1": int(len(x1)), "n_kp2": int(len(x2)),
                "n_proj_in_bounds": 0, "repeatability": 0.0,
                "n_matches": 0, "inlier_rate": 0.0}

    px, py = project(H, x1, y1)
    m = 15.0
    inb = (px >= m) & (px < w - m) & (py >= m) & (py < h - m)

    # repeatability: nearest view-2 keypoint within eps of the projection
    if inb.sum():
        dx = px[inb, None] - x2[None, :]
        dy = py[inb, None] - y2[None, :]
        nearest = np.sqrt((dx * dx + dy * dy).min(axis=1))
        repeatability = float((nearest <= eps).mean())
    else:
        repeatability = 0.0

    # cross-checked Hamming matches -> ground-truth residuals
    j, _dist, valid_m = (t.cpu().numpy() for t in matcher.match(
        torch.from_numpy(d1).to(feat.device),
        torch.from_numpy(d2).to(feat.device), cross_check=True))
    i1 = np.nonzero(valid_m)[0]
    i2 = j[valid_m]
    mx, my = project(H, x1[i1], y1[i1])
    resid = np.sqrt((mx - x2[i2]) ** 2 + (my - y2[i2]) ** 2)
    # only score matches whose ground truth lands in view 2 at all
    scoreable = ((mx >= 0) & (mx < w) & (my >= 0) & (my < h))
    n_matches = int(scoreable.sum())
    inlier_rate = float((resid[scoreable] <= eps).mean()) if n_matches else 0.0

    return {
        "n_kp1": int(len(x1)), "n_kp2": int(len(x2)),
        "n_proj_in_bounds": int(inb.sum()),
        "repeatability": round(repeatability, 4),
        "n_matches": n_matches,
        "inlier_rate": round(inlier_rate, 4),
    }


def evaluate_fixtures(device="cuda", nfeatures=2000, eps=3.0) -> dict:
    """{"<fixture>.<pair>.<descriptor type>": `evaluate_pair`'s metrics}
    over the five fixtures, both view pairs and BAD-256 / HashSIFT-256."""
    from PIL import Image

    rows = {}
    for name in FIXTURES:
        img1 = np.asarray(Image.open(
            os.path.join(REPO, "tests", "data", name + ".png")))
        for hname, H in _homographies(img1.shape[1], img1.shape[0]).items():
            for dt in ("bad_256", "hash_sift_256"):
                key = f"{name}.{hname}.{dt}"
                rows[key] = evaluate_pair(
                    img1, H, nfeatures=nfeatures, descriptor_type=dt,
                    eps=eps, threshold=FIXTURE_THRESHOLD.get(name, 20),
                    device=device)
                print(key, rows[key], file=sys.stderr)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--nfeatures", type=int, default=2000)
    ap.add_argument("--eps", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = evaluate_fixtures(args.device, args.nfeatures, args.eps)

    def mean(metric, sel):
        vals = [v[metric] for k, v in rows.items() if sel in k]
        return round(float(np.mean(vals)), 4)

    summary = {
        "repeatability_mean": mean("repeatability", "."),
        "bad256_inlier_rate_mean": mean("inlier_rate", ".bad_256"),
        "hash_sift256_inlier_rate_mean": mean("inlier_rate", ".hash_sift_256"),
        "config": {"nfeatures": args.nfeatures, "eps_px": args.eps,
                   "fast_threshold": 20, "device": args.device,
                   "pairs": "rigid(8deg,1.05x,+12,-7) + projective tilt"},
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
