"""setup_s: seconds from the start of the process to the first timed
frame (imports, the CUDA context, the kernel library, the frames, the
warm-up)."""


def read(ctx):
    return ctx.setup_s
