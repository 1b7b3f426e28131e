"""glue_ms (pipeline glue): device ms per frame, in the traced stretch, of
the kernels that are not the program's own (PyTorch's ops between and
around them)."""
from featbench.trace import is_port_kernel


def read(ctx):
    if ctx.tr is None or not ctx.frames_traced:
        return None
    us = sum(op.dur for op in ctx.tr.ops
             if op.cat == "kernel" and not is_port_kernel(op.name, ctx.ours))
    return us * 1e-3 / ctx.frames_traced if us > 0 else None
