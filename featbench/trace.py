"""Spans of the benchmark's calls into the program, and one profiler
trace of a short steady stretch of steps, reduced to device operations
attributed to those spans.

Host spans are taken by the benchmark's clock around each call, with the
profiler off.  The trace runs `torch.profiler` over the stretch with a
lead-in (one warm-up step whose records the profiler drops, then 17 small
kernels): late in a long process a card's trace has lost the records of
its first few kernels, and the lead-in takes that loss.  Each device
operation (kernel, copy, fill) is attributed, through its launch's
correlation id, to the innermost benchmark span the host was in when it
launched it; one whose launch the trace lacks takes the span of the
operation before it on the stream.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

PREFIX = "featbench/"
STEP = PREFIX + "step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LEAD_IN = 16
NAME_CHARS = 96


class Spans:
    """The benchmark's spans around its calls: host seconds in calls into
    the program (`port`), and, while profiling, `record_function` ranges
    around both kinds (`port`, `bench`)."""

    def __init__(self):
        self.profiling = False
        self.port_s = 0.0

    @contextlib.contextmanager
    def _range(self, name):
        if self.profiling:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield

    @contextlib.contextmanager
    def port(self, name: str):
        t = time.perf_counter()
        with self._range(name):
            yield
        self.port_s += time.perf_counter() - t

    def bench(self, name: str):
        return self._range(name)

    def take(self) -> float:
        s, self.port_s = self.port_s, 0.0
        return s


def port_kernel_names(csrc: Path) -> frozenset:
    """Names of the `__global__` functions of the program's CUDA sources."""
    pattern = re.compile(
        r"__global__\s+void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\s*\(")
    return frozenset(n for src in csrc.glob("*.cu*")
                     for n in pattern.findall(src.read_text()))


def kernel_base(name: str) -> str:
    """A profiler kernel name's own identifier: no return type, template
    arguments, parameters or namespace."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def is_port_kernel(name: str, ours: frozenset) -> bool:
    return "at::" not in name and kernel_base(name) in ours


@dataclass
class Op:
    name: str
    cat: str
    start: float             # us
    dur: float               # us
    span: str = ""


@dataclass
class Trace:
    """Device operations inside the traced window (us), with their spans."""
    ops: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    host_spans: list = field(default_factory=list)   # (name, start, end)
    unattributed: int = 0

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """Union of the device operations' intervals, merged, in order."""
        out = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = op.start, op.start + op.dur
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def span_at(self, t: float) -> str:
        """The innermost benchmark span (other than the step) the host was
        in at time t, else the step's, else the gap between steps."""
        best = None
        for name, a, b in self.host_spans:
            if a <= t <= b and name != STEP and (best is None or a > best[1]):
                best = (name, a)
        if best:
            return best[0]
        return "step" if any(a <= t <= b for n, a, b in self.host_spans
                             if n == STEP) else "between steps"

    def idle_by_span(self) -> dict:
        """Idle device us inside the window, by the span the host was in
        at each gap's middle."""
        out = {}
        prev = self.window[0]
        for a, b in self.busy_intervals() + [[self.window[1],
                                              self.window[1]]]:
            if a > prev:
                name = self.span_at(0.5 * (prev + a))
                out[name] = out.get(name, 0.0) + (a - prev)
            prev = max(prev, b)
        return out


def parse(events: list) -> Trace:
    """A Chrome trace's events reduced to the device operations launched
    inside the benchmark's step spans."""
    spans, launches, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((e["name"].removeprefix(PREFIX) if e["name"] != STEP
                          else STEP, float(e["ts"]),
                          float(e["ts"]) + float(e.get("dur", 0))))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            ops.append((e, cat))
    steps = [(a, b) for n, a, b in spans if n == STEP]
    tr = Trace(host_spans=spans)
    if not steps:
        return tr
    tr.window = (min(a for a, _ in steps), max(b for _, b in steps))
    inner = sorted((s for s in spans if s[0] != STEP), key=lambda s: s[1])
    prev_span = ""
    for e, cat in sorted(ops, key=lambda x: float(x[0]["ts"])):
        start = float(e["ts"])
        if start < tr.window[0] or start > tr.window[1]:
            continue
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            tr.unattributed += 1
            span = prev_span
        else:
            span = ""
            for name, a, b in inner:
                if a > t:
                    break
                if t <= b:
                    span = name
        prev_span = span
        tr.ops.append(Op(e.get("name", "?"), cat, start,
                         float(e.get("dur", 0)), span))
    return tr


def capture(step, ks, spans: Spans, device: str) -> Trace:
    """Run step(k, spans) for each k in ks under the profiler, each inside
    a step span, and return the parsed trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="featbench-")
    path = os.path.join(tmp, "trace.json")
    spans.profiling = True
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            torch.zeros(1, device=device).add_(1)
            sync()
            prof.step()
            with torch.profiler.record_function(PREFIX + "lead-in"):
                lead = torch.zeros(1, device=device)
                for _ in range(LEAD_IN):
                    lead.add_(1)
                sync()
            for k in ks:
                with torch.profiler.record_function(STEP):
                    step(k, spans)
            sync()
            prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        spans.profiling = False
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    return parse(events)


def breakdown(tr: Trace) -> dict:
    """The device operations that took the most time and the idle time by
    host span, at most ten each, in seconds."""
    by_name = {}
    for op in tr.ops:
        key = op.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + op.dur * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle_by_span().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [["idle in " + n, us * 1e-6] for n, us in idle]}
