"""integral_ms (kernels): device ms per frame, in the traced stretch, of
K3's whole-image integral: the kernels that `csrc/bad_descriptors.cu`
declares `__global__` with `integral` in their names (the flag, the row
pass and the column pass), found by name as `kernel_ms` finds the
program's.  `bad_kernel`, the compare, is left to `kernel_ms`; none where
no integral kernel ran."""
from pathlib import Path
from types import SimpleNamespace

import efficient_features_tpu_torch

from featbench.trace import is_port_kernel, port_kernel_names

SOURCE = "bad_descriptors.cu"
CSRC = Path(efficient_features_tpu_torch.__file__).resolve().parent / "csrc"


def kernel_names(csrc: Path = CSRC) -> frozenset:
    """The integral kernels that the source under csrc declares (none if
    it is not there)."""
    src = csrc / SOURCE
    files = [src] if src.exists() else []
    names = port_kernel_names(SimpleNamespace(glob=lambda _: files))
    return frozenset(n for n in names if "integral" in n)


def read(ctx, csrc: Path = CSRC):
    if ctx.tr is None or not ctx.frames_traced:
        return None
    names = kernel_names(csrc)
    us = sum(op.dur for op in ctx.tr.ops
             if op.cat == "kernel" and is_port_kernel(op.name, names))
    return us * 1e-3 / ctx.frames_traced if us > 0 else None
