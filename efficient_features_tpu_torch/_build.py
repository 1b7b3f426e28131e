"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source in `csrc/` for `sm_90a`, one process per
source, all started together, and links the objects into one shared library
with a plain C interface (csrc/eff_kernels.h), loaded with `ctypes`; no
PyTorch headers are compiled, so a build takes seconds.  The library lands in
`_build/`, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file.  `-fmad=false` is
deliberate: the kernels' float steps must round one by one, as the plain
versions do (see the notes in each source).

Only the CUDA branch of a kernel wrapper calls `library()`: importing this
module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "eff_fast_harris_nms_cells": [_P, _P, _I, _I, _I, _I, _P, _I,
                                  ctypes.c_float, _P, _P, _P, _P, _P],
    "eff_fast_harris_nms": [_P, _I, _I, _I, _I, _P, ctypes.c_float, _P, _P,
                            _P],
    "eff_fast_harris": [_P, _I, _I, _I, ctypes.c_float, _P, _P],
    "eff_radius_nms": [_P, _I, _I, _I, _P, _P, _P],
    "eff_ic_moments": [_P, _I, _I, _P, _P, _I, _P, _P],
    "eff_bad_descriptors": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                            _I, _P, _P, _P, _P],
    "eff_warp_patches": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "eff_hs_hist": [_P, _I, _P, _P, ctypes.c_float, _P, _P],
    "eff_knn2_hamming": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                         _P],
    "eff_resize_u8": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "eff_hs_desc": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                    ctypes.c_float, _P, _P],
    "eff_hs_hist_blocks_per_sm": [_P],
    "eff_hs_desc_blocks_per_sm": [_P],
}


class _State:
    lib = None
    build_seconds = None   # wall time of the nvcc run (0.0 when cached)
    log = ""               # nvcc's output (ptxas register/smem report)


def _sources() -> list[Path]:
    return sorted(p for p in _SRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA kernels need nvcc: no CUDA toolkit found "
                           "(set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run(cmds: list[list[str]]) -> None:
    """Run the nvcc commands concurrently; append their output to the build
    log and raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        _State.log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n"
                           + _State.log)


def _compile_and_link(srcs: list[Path], tmp: Path, so: Path) -> None:
    nvcc = _nvcc()
    cus = [p for p in srcs if p.suffix == ".cu"]
    objs = [str(tmp / f"{p.stem}.o") for p in cus]
    _run([[nvcc, *NVCC_FLAGS, "-I", str(_SRC), "-c", "-o", o, str(p)]
          for p, o in zip(cus, objs)])
    lib = str(tmp / so.name)
    _run([[nvcc, "-shared", "-o", lib, *objs]])
    os.replace(lib, so)   # atomic: a concurrent process never sees half


def _built(srcs: list[Path], stem: str) -> tuple[Path, float]:
    """(path, nvcc seconds) of the shared library of `srcs`, built unless a
    build of the same sources and flags is there already (0.0 seconds)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = _OUT / f"{stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, 0.0
    _OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_OUT) as tmp:
        _compile_and_link(srcs, Path(tmp), so)
    return so, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    if _State.lib is not None:
        return _State.lib
    so, _State.build_seconds = _built(_sources(), "libeff_kernels")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.eff_error_string.argtypes = [ctypes.c_int]
    lib.eff_error_string.restype = ctypes.c_char_p
    _State.lib = lib
    return lib


def tool_library(source: Path) -> ctypes.CDLL:
    """A library of one measuring tool's own .cu file, which may include the
    headers of csrc/; built like the kernel library and apart from it.  The
    caller sets the argument types of what it calls."""
    headers = [p for p in _sources() if p.suffix != ".cu"]
    so, _ = _built(headers + [source], f"lib{source.stem}")
    return ctypes.CDLL(str(so))


def build_seconds() -> float | None:
    """nvcc wall time of this process's build (0.0: loaded a cached build;
    None: not loaded yet)."""
    return _State.build_seconds


def build_log() -> str:
    return _State.log


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().eff_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")
