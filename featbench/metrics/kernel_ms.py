"""kernel_ms (kernels): device ms per frame, in the traced stretch, of the
kernels whose names the program's CUDA sources declare `__global__`."""
from featbench.trace import is_port_kernel


def read(ctx):
    if ctx.tr is None or not ctx.frames_traced:
        return None
    us = sum(op.dur for op in ctx.tr.ops
             if op.cat == "kernel" and is_port_kernel(op.name, ctx.ours))
    return us * 1e-3 / ctx.frames_traced if us > 0 else None
