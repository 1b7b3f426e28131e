"""What K6's two exact operand forms cost on the tensor cores of one card.

    python -m efficient_features_tpu_torch.tools.knn2_probe [--out FILE]

K6 (`csrc/knn2_hamming.cu`) computes Hamming distances with the 1-bit
warpgroup MMA on the packed descriptors.  The other exact form is an int8
product of the bits unpacked to a byte each.  `knn2_probe.cu`, beside this
file and built by it into a library of its own, runs either product alone (K6's grid, tile walk and start-and-wait pattern, zeroed
shared-memory operands, no load, unpack or fold).  This tool times, at
40000 x 40000 and at 256 and 512 bits, with CUDA events over ITERS launches:
the int8 product alone, the 1-bit product alone, and K6 itself, each with the
card's name and power limit.  The int8 form would add the unpack and the
same fold to its product; the 1-bit form's fold is K6's time less its
product.  Prints one line per time and a JSON summary as the last line.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N = 40000
ITERS = 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn2_probe: CUDA is not available", file=sys.stderr)
        return 1
    from efficient_features_tpu_torch import _build
    from efficient_features_tpu_torch.ops import matcher as TM
    from efficient_features_tpu_torch.utils import profiler

    hw = card()
    dev = torch.device("cuda")
    lib = _build.tool_library(Path(__file__).with_suffix(".cu"))
    lib.eff_knn2_product_probe.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.eff_knn2_product_probe.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    split_len, _ = TM.knn2_plan(N, N)
    rng = np.random.default_rng(6)
    summary = {"card": hw, "n": N, "split_len": split_len, "iters": ITERS,
               "ms": {}}
    for nbits in (256, 512):
        def probe(int8_form):
            _build.check(lib.eff_knn2_product_probe(
                int8_form, N, N, nbits, split_len, sink.data_ptr(), stream),
                "knn2_product_probe")
            return sink

        d = torch.from_numpy(rng.integers(0, 256, (N, nbits // 8),
                                          dtype=np.uint8)).to(dev)
        times = {k: profiler.timeit_ms(fn, ITERS, 3) for k, fn in (
            ("int8_product_only", lambda: probe(1)),
            ("b1_product_only", lambda: probe(0)),
            ("k6", lambda: TM.knn2_topk2(d, None, d, None)))}
        if int(sink) != 0:
            raise SystemExit("knn2_probe: the probe wrote its sink")
        summary["ms"][str(nbits)] = times
        for what, ms in times.items():
            print(f"{nbits} bits {N} x {N} {what}: {ms:.3f} ms [{hw}]")
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
