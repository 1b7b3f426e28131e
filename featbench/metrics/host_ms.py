"""host_ms (host path): the benchmark's clock around each call into the
program, entry to return, summed per frame and averaged over the frames
of the untraced part of the window (the profiler's own host cost is not
in it).  An asynchronous call returns once its work is queued; a call
that returns host results includes the wait for them."""
import numpy as np


def read(ctx):
    return float(np.mean(ctx.host_ms)) if ctx.host_ms else None
