"""idle_share (device): 1 minus the union of the device operations'
intervals over the traced stretch's wall time (first step's start to last
step's end, host spans of the same trace), in %."""


def read(ctx):
    if ctx.tr is None or ctx.tr.window_us <= 0 or not ctx.tr.ops:
        return None
    return 100.0 * (1.0 - ctx.tr.busy_us() / ctx.tr.window_us)
