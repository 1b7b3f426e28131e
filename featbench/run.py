"""Benchmark of efficient_features_tpu_torch on one CUDA card.

    python3 featbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json in this process: makes the cell's frames
from the seed on the card, warms up, measures for --seconds, checks the
frames and steps of the window against the plain reference, and prints
each compared number beside its limit as the last lines of standard error
and one JSON object as the last line of standard output.  With --trace 1
it reports the cell's per-layer metrics from a profiler trace of a short
stretch after the window, else its end-to-end metrics.  Exits non-zero,
printing no result, without a card, or if JAX or the JAX package is
loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the program's builds stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "featbench" / "cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "featbench" / "cache"
                                         / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from featbench import harness
    chips = harness.chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"featbench: needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"featbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
