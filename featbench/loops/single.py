"""single: one frame in flight, handed to
`EfficientFeatures.detect_and_compute`; done when its
`KeyPoints.as_arrays()` and descriptors are on the host."""
from featbench.loops.base import FrameLoop


class Loop(FrameLoop):
    def __init__(self, feat, frames, traffic):
        self.feat, self.frames = feat, frames

    def prime(self, k):
        pass

    def step(self, k, sp):
        i = k % len(self.frames)
        with sp.port("detect_and_compute"):
            kps, desc = self.feat.detect_and_compute(self.frames[i])
        with sp.port("as_arrays"):
            arrays = kps.as_arrays()
        return [(i, arrays, desc)]
