"""frame_p95_ms: the 95th percentile (linear interpolation) over all
frames of the window of one frame's latency, from the host array handed
to the program to its results on the host; each frame of a batch has the
batch's latency."""
import numpy as np


def read(ctx):
    if not ctx.latencies_ms:
        return None
    return float(np.percentile(ctx.latencies_ms, 95))
