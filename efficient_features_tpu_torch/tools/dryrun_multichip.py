"""Every mesh form of `parallel/sharding.py` once, over n gloo ranks: the
port's counterpart of `__graft_entry__.dryrun_multichip`, with the same
inputs (`default_rng(0)`, drawn in the same order) and configurations.  The
ranks compute on the card (all on the first one) unless `--device cpu` asks
for the CPU.

    python -m efficient_features_tpu_torch.tools.dryrun_multichip [--n 8] \
        [--device cuda|cpu]

prints one line, which for n = 8 reads

    dryrun_multichip(8): dp desc (8, 200, 32), sp kept 128 kps, sp-pyramid
    128 kps + desc (128, 32), sharded-match 64 matches, dpxsp desc
    (2, 128, 32) — OK

(one line), and exits 1 if the ranks disagree.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def rank_run(n: int, device: str) -> str:
    """One rank's pass over the mesh forms, on `device`; the summary
    line."""
    from .. import pipeline as P
    from ..parallel import sharding as SH
    mesh = SH.make_mesh(n)
    cfg = P.FeatureConfig(nfeatures=200, nlevels=3,
                          descriptor_type="hash_sift_256")
    rng = np.random.default_rng(0)

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(a).to(device)

    # dp: a batch of frames over the ranks
    images = dev(rng.integers(0, 256, (n, 96, 128), dtype=np.uint8))
    _, desc = SH.detect_and_compute_batch(images, cfg, mesh)
    assert desc.shape[0] == n
    # sp: one image in row bands, one level
    big = dev(rng.integers(0, 256, (n * 64, 256), dtype=np.uint8))
    _, _, _, valid = SH.detect_rows_sharded(big, cfg, mesh, quota=128)
    # sp: the whole pyramid in row bands, with descriptors
    big2 = dev(rng.integers(0, 256, (n * 64, 512), dtype=np.uint8))
    slots, sdesc = SH.detect_pyramid_rows_sharded(
        big2, P.FeatureConfig(nfeatures=128, nlevels=2,
                              descriptor_type="bad_256"),
        mesh, with_descriptors=True)
    # the keypoint axis
    kp = dev(torch.stack([torch.linspace(10, 240, 40),
                          torch.linspace(10, 500, 40),
                          torch.full((40,), 31.0), torch.full((40,), -1.0)],
                         dim=1))
    SH.compute_sharded(big, kp, dev(torch.ones(40, dtype=torch.bool)), mesh)
    # the query axis of the matcher
    dm = dev(rng.integers(0, 256, (64, 32), dtype=np.uint8))
    ones = dev(torch.ones(64, dtype=torch.bool))
    mj, _, mok = SH.knn2_match_sharded(dm, ones, dm, ones, mesh)
    n_match = int(mok.sum())
    assert n_match > 0 and bool(
        (mj[mok] == dev(torch.arange(64))[mok]).all())
    # dp x sp
    desc2d_shape = None
    if n >= 4 and n % 2 == 0:
        mesh2d = SH.make_mesh_2d(2, n // 2)
        imgs2d = dev(rng.integers(0, 256, (2, (n // 2) * 64, 256),
                                  dtype=np.uint8))
        _, desc2d = SH.detect_and_compute_batch_2d(
            imgs2d, P.FeatureConfig(nfeatures=128, nlevels=2,
                                    descriptor_type="bad_256"), mesh2d)
        desc2d_shape = tuple(desc2d.shape)
    return (f"dryrun_multichip({n}): dp desc {tuple(desc.shape)}, "
            f"sp kept {int(valid.sum())} kps, "
            f"sp-pyramid {int(slots['count'])} kps + desc "
            f"{tuple(sdesc.shape)}, sharded-match {n_match} matches, "
            f"dpxsp desc {desc2d_shape} — OK")


def main(argv=None) -> int:
    from ..parallel import launch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="gloo ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks compute (default: the card)")
    args = ap.parse_args(argv)
    lines = [r[0] for r in launch.spmd(
        args.n, [("efficient_features_tpu_torch.tools.dryrun_multichip:"
                  "rank_run", (args.n, args.device), {})], args.device)]
    print(lines[0])
    if not isinstance(lines[0], str) or any(line != lines[0]
                                            for line in lines):
        print("ranks disagree:", lines, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
