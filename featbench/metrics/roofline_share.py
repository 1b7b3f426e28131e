"""roofline_share (kernels): the least device time of a frame's algorithm
at the H100's peaks (featbench/roofline, from the frame's shapes and the
reference's counts of the frames checked) over the frame's device busy
time in the traced stretch, in %."""
from featbench.roofline.stages import share_pct


def read(ctx):
    if ctx.tr is None or not ctx.frames_traced or ctx.bound_ms is None:
        return None
    busy_ms = ctx.tr.busy_us() * 1e-3 / ctx.frames_traced
    return share_pct(ctx.bound_ms, busy_ms) if busy_ms > 0 else None
