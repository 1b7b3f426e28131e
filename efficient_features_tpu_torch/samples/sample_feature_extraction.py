"""Feature extraction demo (samples/sample_feature_extraction.cpp), on the
port.

Detects keypoints and computes descriptors, comparing the sync and async
paths; draws keypoints if cv2 is available.

    python -m efficient_features_tpu_torch.samples.sample_feature_extraction \
        [image] [--descriptor-type N] [--descriptor-bits N] \
        [--max-keypoints N] [--device cuda|cpu] [--out out.png]

The sync and async times are host-clock times of the calls; on a GPU the
async call's device time comes from CUDA events as well
(`utils.profiler.timeit_ms`).
"""
import argparse
import time

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch.samples.sample_common import (
    descriptor_type, load_gray)
from efficient_features_tpu_torch.utils import profiler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("--max-keypoints", type=int, default=10000)
    ap.add_argument("--descriptor-type", type=int, default=0,
                    help="0:BAD 1:HashSIFT")
    ap.add_argument("--descriptor-bits", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    img = load_gray(args.image)
    feat = EfficientFeatures(
        nfeatures=args.max_keypoints,
        descriptor_type=descriptor_type(args.descriptor_type,
                                        args.descriptor_bits),
        device=args.device)
    on_card = feat.device.type == "cuda"

    # sync path: host descriptors of the valid keypoints
    t0 = time.perf_counter()
    kps, desc = feat.detect_and_compute(img)
    t_sync = time.perf_counter() - t0

    # async path: the call returns once enqueued; timeit_ms waits for it
    dispatch = []

    def async_call():
        t0 = time.perf_counter()
        out = feat.detect_and_compute_async(img)
        dispatch.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    call_ms = profiler.timeit_ms(async_call, iters=1, warmup=0)
    t_async = time.perf_counter() - t0
    t_dispatch = dispatch[0]

    print(f"image {img.shape[1]}x{img.shape[0]}: {kps.count} keypoints, "
          f"descriptors {desc.shape}")
    device = f", device {call_ms:.1f} ms (CUDA events)" if on_card else ""
    print(f"sync {t_sync*1e3:.1f} ms | async dispatch {t_dispatch*1e3:.1f} ms,"
          f" total {t_async*1e3:.1f} ms{device}")
    h = kps.as_arrays()
    print("first keypoints:",
          [(round(float(x), 1), round(float(y), 1), int(o))
           for x, y, o in zip(h["x"][:5], h["y"][:5], h["octave"][:5])])

    if args.out:
        try:
            import cv2
        except ImportError:
            print("cv2 unavailable; skipping drawing")
            return
        vis = cv2.drawKeypoints(
            cv2.cvtColor(img, cv2.COLOR_GRAY2BGR), kps.cv_keypoints(),
            None, flags=cv2.DRAW_MATCHES_FLAGS_DRAW_RICH_KEYPOINTS)
        cv2.imwrite(args.out, vis)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
