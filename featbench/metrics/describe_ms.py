"""describe_ms (kernels): device ms per frame, in the traced stretch, of
HashSIFT's describe kernels: those that `csrc/warp_patches.cu` (K4, the
warp), `csrc/hs_hist.cu` (K5, the histogram) and `csrc/hs_desc.cu` (K11,
the fused route) declare `__global__`, found by name as `kernel_ms` finds
the program's.  The projection after them is PyTorch's and cuBLAS's work,
read by `glue_ms`."""
from pathlib import Path
from types import SimpleNamespace

import efficient_features_tpu_torch

from featbench.trace import is_port_kernel, port_kernel_names

SOURCES = ("warp_patches.cu", "hs_hist.cu", "hs_desc.cu")
CSRC = Path(efficient_features_tpu_torch.__file__).resolve().parent / "csrc"


def kernel_names(csrc: Path = CSRC) -> frozenset:
    """The `__global__` functions of the describe sources under csrc (those
    of them that exist), read as `port_kernel_names` reads a directory."""
    files = [csrc / n for n in SOURCES if (csrc / n).exists()]
    return port_kernel_names(SimpleNamespace(glob=lambda _: files))


def read(ctx, csrc: Path = CSRC):
    if ctx.tr is None or not ctx.frames_traced:
        return None
    names = kernel_names(csrc)
    us = sum(op.dur for op in ctx.tr.ops
             if op.cat == "kernel" and is_port_kernel(op.name, names))
    return us * 1e-3 / ctx.frames_traced if us > 0 else None
