"""One run of one cell: frames from the seed, warm-up, the measured window,
the traced stretch, and the check against the reference.

Everything that belongs to a cell is found by name: its entry in
`BENCHMARK.json`, its configuration's file, `featbench/traffic/<cell>.json`
(the loop, the pool of frames and the camera path, the step's parameters,
the check's sample and limits), the loop the traffic names,
`featbench/loops/<loop>.py` (see `featbench/loops/__init__.py`), and, for
each metric the cell reports, `featbench/metrics/<metric>.py`; a metric
`<name>.<part>` without a file of its own is read by
`featbench/metrics/<name>.py`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import efficient_features_tpu_torch as api

from . import check as C
from . import frames as FR
from . import trace as TR
from .reference import features as RF
from .roofline import stages as ST

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "efficient_features_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _workload(bench: dict, name: str) -> dict:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return entry


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell's configuration, traffic and metrics from BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    entry = _workload(bench, name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name, load_json(root / conf["file"]),
                load_json(root / "featbench" / "traffic" / f"{name}.json"),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def chips(name: str, root: Path = ROOT) -> int:
    """The cards the cell asks for."""
    return _workload(load_json(root / "BENCHMARK.json"), name)["chips"]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # as an import would (dataclasses ask)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The `read(ctx)` of featbench/metrics/<metric>.py under `root`, else
    of the file of the name before its first dot."""
    base = root / "featbench" / "metrics"
    path = base / f"{metric}.py"
    if not path.exists():
        path = base / f"{metric.split('.')[0]}.py"
    return _load(path, "featbench.metrics." + path.stem).read


def loop_class(loop: str, root: Path = ROOT):
    """The `Loop` of featbench/loops/<loop>.py under `root`."""
    return _load(root / "featbench" / "loops" / f"{loop}.py",
                 "featbench.loops." + loop).Loop


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def detector_cfg(config: dict) -> dict:
    """The detector's settings: `EfficientFeatures`' arguments and the
    reference's `cfg`."""
    d = config["detector"]
    return {k: d[k] for k in ("nfeatures", "scale_factor", "nlevels",
                              "first_level", "fast_threshold",
                              "nonmax_radius", "descriptor_type")}


def reference_frames(frames, indices, config, device, lowp=None) -> dict:
    """The reference's keypoints and descriptors of the pool frames named,
    with the configuration's descriptor type."""
    cfg = detector_cfg(config)
    out = {}
    for i in sorted(set(indices)):
        img = torch.from_numpy(frames[i]).to(device)
        out[i] = RF.detect_and_describe(img, cfg, lowp)
    return out


def check(loop, kept: list, frames, maps, config, traffic, device,
          ref=None) -> tuple[dict, dict]:
    """(worst readings, reference outputs by pool index) of the kept items
    (`loop.host` form) against the reference."""
    if ref is None:
        ref = reference_frames(frames, loop.pool_indices(kept), config,
                               device)
    return C.worst(loop.readings(kept, ref, maps, traffic, device)), ref


def frame_bound_ms(loop, ref: dict, kept: list, config: dict,
                   traffic: dict) -> float | None:
    """The roofline bound of one frame (a step of a loop whose items are
    steps), averaged over the items checked."""
    bounds = [ST.bound_ms(loop.stages(item, ref, config, traffic))
              for item in kept]
    return float(np.mean(bounds)) if bounds else None


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


@dataclass
class Context:
    """What the metric readers read."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    frames_done: int = 0
    latencies_ms: list = field(default_factory=list)
    host_ms: list = field(default_factory=list)        # per frame
    tr: TR.Trace | None = None
    frames_traced: int = 0
    ours: frozenset = frozenset()
    bound_ms: float | None = None


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None,
        root: Path = ROOT) -> dict:
    """One run; returns the result line's object (checks last)."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [("imports", time.perf_counter())]
    cell = load_cell(workload, root)
    conf, traffic = cell.config, cell.traffic
    Loop = loop_class(traffic["loop"], root)
    fr = conf["frame"]
    frames, maps = FR.make_pool(fr["height"], fr["width"], seed,
                                traffic["pool"], traffic["rotate_deg"],
                                traffic["shift_px"], device)
    marks.append(("frames", time.perf_counter()))
    feat = api.EfficientFeatures(**detector_cfg(conf), device=device)
    loop = Loop(feat, frames, traffic)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    spans = TR.Spans()
    k = 0
    loop.prime(k)
    for k in range(1, 1 + traffic["warmup_steps"]):
        loop.step(k, spans)
        sync()
        marks.append((f"warm-up step {k}", time.perf_counter()))
    spans.take()
    print("featbench: set-up, s: " + ", ".join(
        f"{name} {b - a:.3f}" for (name, b), (_, a)
        in zip(marks, [("start", t0)] + marks)), file=sys.stderr)

    ctx = Context(cell)
    rng = np.random.default_rng([seed, 1])
    sample, kept, seen = traffic["check"]["steps"], [], 0
    attempted = failed = 0
    # what set-up left is never collected again: no collection inside the
    # window walks it
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    ctx.setup_s = start - t0
    end = start
    while end - start < seconds:
        k += 1
        t = time.perf_counter()
        try:
            out = loop.step(k, spans)
        except Exception:                    # a failed step counts, and the
            traceback.print_exc()            # window goes on
            out = None
        end = time.perf_counter()
        attempted += loop.frames_per_step
        host = spans.take()
        if out is None:
            failed += loop.frames_per_step
            continue
        ctx.latencies_ms += [1e3 * (end - t)] * loop.frames_per_step
        ctx.host_ms.append(1e3 * host / loop.frames_per_step)
        seen += 1
        if len(kept) < sample:
            kept.append(out)
        else:
            r = int(rng.integers(0, seen))
            if r < sample:
                kept[r] = out
    ctx.window_s = end - start
    gc.unfreeze()
    ctx.frames_done = attempted - failed
    tenths = np.array_split(np.array(ctx.latencies_ms), 10)
    print("featbench: median latency by tenth of the window, ms: "
          + " ".join(f"{np.median(b):.2f}" for b in tenths if len(b)),
          file=sys.stderr)

    if trace:
        ks = range(k + 1, k + 1 + traffic["trace_steps"])
        ctx.tr = TR.capture(loop.step, ks, spans, device)
        ctx.frames_traced = traffic["trace_steps"] * loop.frames_per_step
        ctx.ours = TR.port_kernel_names(
            Path(api.__file__).resolve().parent / "csrc")
        print(f"featbench: trace: {len(ctx.tr.ops)} device ops, "
              f"{ctx.tr.unattributed} without a launch record",
              file=sys.stderr)

    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" \
        else 0
    kept = Loop.host([s for step in kept for s in step])
    del loop, feat
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, ref = check(Loop, kept, frames, maps, conf, traffic, device)
    correct, table = C.verdict(readings, traffic["check"]["limits"])
    ctx.bound_ms = frame_bound_ms(Loop, ref, kept, conf, traffic)
    print(f"featbench: checked {len(kept)} of {seen} steps in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)

    lat = np.array(ctx.latencies_ms)
    if len(lat):
        q1, q2, q3 = np.percentile(lat, [25, 50, 75])
        print(f"featbench: {len(lat)} frames, latency quartiles {q1:.4f} / "
              f"{q2:.4f} / {q3:.4f} ms, p95 {np.percentile(lat, 95):.4f} "
              f"ms, max {lat.max():.4f} ms; host in the program "
              f"{np.mean(ctx.host_ms):.4f} ms a frame; window "
              f"{ctx.window_s:.3f} s; setup {ctx.setup_s:.3f} s",
              file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.tr is not None:
        dev["busy_s"] = ctx.tr.busy_us() * 1e-6
        dev["window_s"] = ctx.tr.window_us * 1e-6
        result["breakdown"] = TR.breakdown(ctx.tr)
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def _finite(v: float) -> float:
    return float(v) if math.isfinite(v) else 1e30
