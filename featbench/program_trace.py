"""The program's own spans in a profiler trace, and what they give a frame.

While a torch profiler records, the port opens `record_function` spans
named `eff/<layer>.<what>` at its api, pipeline, sharding and ops
boundaries (`efficient_features_tpu_torch/utils/profiler.span`); its
`eff/wait.*` spans hold the host's waits on the card.  The CUDA runtime's
records of kernel launches and synchronising calls lie on the same clock.
From the Chrome trace that `trace.capture` takes, which `trace.parse`
reduces to device operations and the benchmark's spans, this module reads,
a frame of the traced steps:

- `host_work_ms`: host ms inside the program's spans and outside its wait
  spans (enqueueing, uploading, compacting results);
- `idle_host_ms`: device-idle ms while the host was there, the idle time
  the host's own work in the program leaves (the idle intervals
  intersected with those host intervals);
- `launches_per_frame`: kernel-launch records that start inside a program
  span, torch's own launches included;
- by stage, the innermost span of either kind the host was in: idle ms,
  device ms (by the span its launch lay in), launches and synchronising
  calls;
- coverage: kernel launches inside a benchmark `port` span but outside
  every program span, 0 when every launch of the program has a span.

`trace.parse` keeps only the benchmark's spans, so the harness reads none
of these.  As a script this module traces one cell the way the harness
does, after its warm-up and an untraced stretch, and prints one JSON line:

    python3 featbench/program_trace.py --workload <cell> --seed <n> \\
        [--steps 100] [--out FILE]
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from featbench import trace as TR  # noqa: E402

# the program's span names (`utils/profiler.PREFIX`) and its waits
PREFIX = "eff/"
WAIT = PREFIX + "wait."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


@dataclass
class Records:
    """What the program and the runtime left in a trace (us)."""
    spans: list = field(default_factory=list)     # (name, start, end)
    launches: list = field(default_factory=list)  # kernel-launch starts
    syncs: list = field(default_factory=list)     # starts of syncing calls
    ops: list = field(default_factory=list)       # (start, dur, launch)


def parse(events: list) -> Records:
    """The program's spans, the runtime's kernel launches and syncing
    calls, and each device operation with the start of its launch (None
    where the trace lacks it), from a Chrome trace's events."""
    rec, launched, ops = Records(), {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        start = float(e["ts"])
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            rec.spans.append((name, start, start + float(e.get("dur", 0))))
        elif cat in TR.LAUNCH_CATS:
            if corr is not None:
                launched[corr] = start
            if name.startswith(LAUNCHES):
                rec.launches.append(start)
            elif name.startswith(SYNCS):
                rec.syncs.append(start)
        elif cat in TR.DEVICE_CATS:
            ops.append((start, float(e.get("dur", 0)), corr))
    rec.ops = sorted((a, d, launched.get(c)) for a, d, c in ops)
    rec.launches.sort()
    rec.syncs.sort()
    return rec


# ---------------------------------------------------------------------------
# Sets of intervals: sorted, disjoint [start, end] lists
# ---------------------------------------------------------------------------


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def minus(xs: list, ys: list) -> list:
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append([cur, ys[k][0]])
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append([cur, b])
    return out


def meet(xs: list, ys: list) -> list:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(xs: list) -> float:
    return sum(b - a for a, b in xs)


def within(t: float, xs: list) -> bool:
    i = bisect.bisect_right([a for a, _ in xs], t) - 1
    return i >= 0 and t <= xs[i][1]


# ---------------------------------------------------------------------------
# Readings, a frame of the traced steps
# ---------------------------------------------------------------------------


def idle(tr: TR.Trace) -> list:
    """The device's idle intervals inside the traced window."""
    return minus([list(tr.window)], tr.busy_intervals())


def host_work(rec: Records, tr: TR.Trace) -> list:
    """Host intervals inside a program span and outside every wait span,
    inside the window."""
    inside = meet(merged([(a, b) for _, a, b in rec.spans]),
                  [list(tr.window)])
    return minus(inside, merged([(a, b) for n, a, b in rec.spans
                                 if n.startswith(WAIT)]))


def host_work_ms(rec: Records, tr: TR.Trace, frames: int):
    if not rec.spans or not frames:
        return None
    return length(host_work(rec, tr)) * 1e-3 / frames


def idle_host_ms(rec: Records, tr: TR.Trace, frames: int):
    if not rec.spans or not frames:
        return None
    return length(meet(idle(tr), host_work(rec, tr))) * 1e-3 / frames


def _in_window(ts: list, tr: TR.Trace) -> list:
    return [t for t in ts if tr.window[0] <= t <= tr.window[1]]


def launches_per_frame(rec: Records, tr: TR.Trace, frames: int):
    if not rec.spans or not frames:
        return None
    inside = merged([(a, b) for _, a, b in rec.spans])
    return sum(within(t, inside) for t in _in_window(rec.launches, tr)) \
        / frames


def coverage(rec: Records, tr: TR.Trace, ports) -> tuple[int, int]:
    """(kernel launches in the window, those inside a benchmark span named
    in `ports` and outside every program span)."""
    port = merged([(a, b) for n, a, b in tr.host_spans if n in ports])
    prog = merged([(a, b) for _, a, b in rec.spans])
    ts = _in_window(rec.launches, tr)
    return len(ts), sum(within(t, port) and not within(t, prog) for t in ts)


def segments(rec: Records, tr: TR.Trace) -> list:
    """The window cut into (start, end, name) where the innermost span the
    host was in changes: a program span, else a benchmark span other than
    the step, else "step", else "between steps"."""
    lo, hi = tr.window
    spans = [(n if n != TR.STEP else "step", a, b) for n, a, b
             in rec.spans + tr.host_spans if b > lo and a < hi]
    cuts = sorted({lo, hi} | {t for _, a, b in spans for t in (a, b)
                              if lo < t < hi})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        around = [(s[1], -s[2], s[0]) for s in spans
                  if s[1] <= a and b <= s[2]]
        out.append((a, b, max(around)[2] if around else "between steps"))
    return out


def stages(rec: Records, tr: TR.Trace, frames: int) -> dict:
    """{stage: {idle_ms, device_ms, launches, syncs}} a frame, by the
    innermost span the host was in (`segments`); a device operation by its
    launch, else as the operation before it."""
    segs = segments(rec, tr)
    starts = [a for a, _, _ in segs]
    out = {}

    def add(name, key, v):
        row = out.setdefault(name, dict.fromkeys(
            ("idle_ms", "device_ms", "launches", "syncs"), 0.0))
        row[key] += v / frames

    def at(t):
        return segs[max(bisect.bisect_right(starts, t) - 1, 0)][2]
    gaps, i = idle(tr), 0
    for a, b, name in segs:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        k = i
        while k < len(gaps) and gaps[k][0] < b:
            add(name, "idle_ms", 1e-3 * (min(b, gaps[k][1])
                                         - max(a, gaps[k][0])))
            k += 1
    last = "between steps"
    for start, dur, launch in rec.ops:
        if tr.window[0] <= start <= tr.window[1]:
            last = at(launch) if launch is not None else last
            add(last, "device_ms", 1e-3 * dur)
    for key, ts in (("launches", rec.launches), ("syncs", rec.syncs)):
        for t in _in_window(ts, tr):
            add(at(t), key, 1.0)
    return out


def readings(events: list, frames: int, ports=()) -> dict:
    """Every number above from one trace's events."""
    tr, rec = TR.parse(events), parse(events)
    launches, uncovered = coverage(rec, tr, ports)
    return {
        "frames": frames,
        "idle_share": 100.0 * (1.0 - tr.busy_us() / tr.window_us)
        if tr.window_us > 0 else None,
        "host_work_ms": host_work_ms(rec, tr, frames),
        "idle_host_ms": idle_host_ms(rec, tr, frames),
        "launches_per_frame": launches_per_frame(rec, tr, frames),
        "spans_per_frame": sum(1 for _, a, _ in rec.spans
                               if tr.window[0] <= a <= tr.window[1])
        / frames,
        "launches": launches,
        "launches_uncovered": uncovered,
        "traced_step_ms": [1e-3 * (b - a) for n, a, b in tr.host_spans
                           if n == TR.STEP],
        "stages": stages(rec, tr, frames),
    }


# ---------------------------------------------------------------------------
# One cell's traced steps
# ---------------------------------------------------------------------------


class PortSpans(TR.Spans):
    """The benchmark's spans, keeping the names of its `port` spans."""

    def __init__(self):
        super().__init__()
        self.ports = set()

    def port(self, name: str):
        self.ports.add(name)
        return super().port(name)


def capture_events(step, ks, spans, device: str) -> list:
    """The events of `trace.capture`'s trace of the steps ks: the capture
    the harness makes, with its events kept."""
    kept, parse_trace = [], TR.parse

    def keep(events):
        kept.extend(events)
        return parse_trace(events)
    TR.parse = keep
    try:
        TR.capture(step, ks, spans, device)
    finally:
        TR.parse = parse_trace
    return kept


def span_cost_us(n: int = 100_000) -> float:
    """us an enter and exit of one program span with no profiler running."""
    from efficient_features_tpu_torch.utils.profiler import span
    t = time.perf_counter()
    for _ in range(n):
        with span("api.cost"):
            pass
    return (time.perf_counter() - t) * 1e6 / n


def trace_cell(workload: str, seed: int, steps: int, device: str = "cuda",
               root: Path | None = None) -> dict:
    """One cell as the harness runs it, cut short: set-up and warm-up,
    `steps` untraced steps by the host clock, then the traced steps."""
    import torch

    import efficient_features_tpu_torch as api
    from featbench import frames as FR
    from featbench import harness as H
    root = H.ROOT if root is None else root
    cell = H.load_cell(workload, root)
    conf, traffic = cell.config, cell.traffic
    fr = conf["frame"]
    frames, _ = FR.make_pool(fr["height"], fr["width"], seed,
                             traffic["pool"], traffic["rotate_deg"],
                             traffic["shift_px"], device)
    feat = api.EfficientFeatures(**H.detector_cfg(conf), device=device)
    loop = H.loop_class(traffic["loop"], root)(feat, frames, traffic)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    spans = PortSpans()
    loop.prime(0)
    k = traffic["warmup_steps"]
    for j in range(1, 1 + k):
        loop.step(j, spans)
        sync()
    spans.take()
    step_ms, host_ms = [], []
    for k in range(k + 1, k + 1 + steps):
        t = time.perf_counter()
        loop.step(k, spans)
        step_ms.append(1e3 * (time.perf_counter() - t))
        host_ms.append(1e3 * spans.take() / loop.frames_per_step)
    ks = range(k + 1, k + 1 + traffic["trace_steps"])
    events = capture_events(loop.step, ks, spans, device)
    out = readings(events, traffic["trace_steps"] * loop.frames_per_step,
                   spans.ports)
    out.update(workload=workload, seed=seed, untraced_steps=steps,
               untraced_step_ms=statistics.median(step_ms),
               untraced_host_ms=statistics.mean(host_ms),
               span_cost_us=span_cost_us(),
               device=torch.cuda.get_device_name(0) if device == "cuda"
               else device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 2
    r = trace_cell(args.workload, args.seed, args.steps)
    print(f"program_trace: {r['launches']} kernel launches in the traced "
          f"steps, {r['launches_uncovered']} inside a port span and outside "
          f"every {PREFIX} span", file=sys.stderr)
    line = json.dumps(r)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
