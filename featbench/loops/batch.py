"""batch: `batch` frames in flight, handed as one (B, H, W) host array to
`EfficientFeatures.detect_and_compute_batch(..., as_host=True)`; done
when every frame's `as_arrays()` is on the host.  A step's frames are
`step_frames`; a batch of B counts B frames."""
import math

import numpy as np

from featbench.loops.base import FrameLoop


class Loop(FrameLoop):
    def __init__(self, feat, frames, traffic):
        b, n = traffic["batch"], len(frames)
        self.frames_per_step, self.feat = b, feat
        self.index = [self.step_frames(s, n, traffic)
                      for s in range(n // math.gcd(n, b))]
        self.batches = [np.stack([frames[i] for i in ix])
                        for ix in self.index]

    def prime(self, k):
        pass

    def step(self, k, sp):
        s = k % len(self.batches)
        with sp.port("detect_and_compute_batch"):
            res = self.feat.detect_and_compute_batch(self.batches[s],
                                                     as_host=True)
        with sp.port("as_arrays"):
            out = [(i, kps.as_arrays(), desc)
                   for i, (kps, desc) in zip(self.index[s], res)]
        return out
