"""Two-image matching demo (samples/sample_feature_matching.cpp), on the
port.

Detects and describes both images, matches them with cross-checked Hamming
brute force (the best-2 kernel on a GPU), optionally verifies the matches
with the batched RANSAC homography (--homography; the CUDA sample stops at
raw matches), and optionally draws them.

    python -m efficient_features_tpu_torch.samples.sample_feature_matching \
        [img1 img2] [--device cuda|cpu] [--homography] [--out out.png]
"""
import argparse

import numpy as np
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.ops import matcher, ransac
from efficient_features_tpu_torch.samples.sample_common import (
    descriptor_type, load_gray, warp_image)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="*", default=[])
    ap.add_argument("--max-keypoints", type=int, default=5000)
    ap.add_argument("--descriptor-type", type=int, default=0)
    ap.add_argument("--descriptor-bits", type=int, default=256)
    ap.add_argument("--out", default=None)
    ap.add_argument("--homography", action="store_true",
                    help="RANSAC-verify matches with a homography model")
    ap.add_argument("--ransac-thresh", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = ap.parse_args()

    if len(args.images) == 2:
        img1 = load_gray(args.images[0])
        img2 = load_gray(args.images[1])
    else:
        img1 = load_gray(None, 720, 1280, seed=7)
        img2 = warp_image(img1, angle_deg=5.0, tx=12.0, ty=-8.0)

    feat = EfficientFeatures(
        nfeatures=args.max_keypoints,
        descriptor_type=descriptor_type(args.descriptor_type,
                                        args.descriptor_bits),
        device=args.device)
    dev = feat.device
    kps1, d1 = feat.detect_and_compute(img1)
    kps2, d2 = feat.detect_and_compute(img2)

    j, dist, valid = matcher.match(torch.from_numpy(d1).to(dev),
                                   torch.from_numpy(d2).to(dev),
                                   cross_check=True)
    j, dist, valid = (t.cpu().numpy() for t in (j, dist, valid))
    print(f"kps: {kps1.count} / {kps2.count}; cross-checked matches: "
          f"{int(valid.sum())}; mean hamming {dist[valid].mean():.1f}")

    if args.homography:
        src = kps1.xysa()[:, :2]        # row i of d1 <-> keypoint i of kps1
        dst = kps2.xysa()[:, :2][np.clip(j, 0, kps2.count - 1)]
        H, inl, n_inl = ransac.find_homography_ransac(
            src, dst, valid, thresh=args.ransac_thresh, device=dev)
        inl = inl.cpu().numpy()
        print(f"RANSAC homography: {int(n_inl)} inliers of "
              f"{int(valid.sum())} matches "
              f"({100.0 * int(n_inl) / max(int(valid.sum()), 1):.1f}%)")
        print(np.array_str(H.cpu().numpy(), precision=4, suppress_small=True))
        valid = valid & inl             # draw verified matches only

    if args.out:
        try:
            import cv2
        except ImportError:
            print("cv2 unavailable; skipping drawing")
            return
        cvm = [cv2.DMatch(int(i), int(j[i]), float(dist[i]))
               for i in np.nonzero(valid)[0]]
        vis = cv2.drawMatches(
            cv2.cvtColor(img1, cv2.COLOR_GRAY2BGR), kps1.cv_keypoints(),
            cv2.cvtColor(img2, cv2.COLOR_GRAY2BGR), kps2.cv_keypoints(),
            cvm[:300], None)
        cv2.imwrite(args.out, vis)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
