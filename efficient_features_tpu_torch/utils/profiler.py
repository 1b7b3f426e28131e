"""Profiling and timing helpers (port of `efficient_features_tpu/utils/
profiler.py`): wall time per call over queued calls with one final
completion, `torch.profiler` traces and named ranges, among them the
program's own spans (`span`).

Imports only torch and the standard library.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _first_tensor(out):
    """The first tensor in `out`: a tensor, a tuple / list / dict of them
    (nested), or an object with `_slots` (the port's `KeyPoints`)."""
    if isinstance(out, torch.Tensor):
        return out
    if hasattr(out, "_slots"):
        out = out._slots
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def force_completion(out) -> None:
    """Wait for the work that made `out`: a host read of one element of its
    first tensor, which a card's stream runs after all work queued before
    it.  Raises ValueError when `out` holds no tensor."""
    leaf = _first_tensor(out)
    if leaf is None:
        raise ValueError(f"no tensor in {type(out).__name__}")
    if leaf.numel():
        leaf.reshape(-1)[:1].cpu()
    elif leaf.is_cuda:
        torch.cuda.current_stream(leaf.device).synchronize()


def timeit_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """ms per call: `warmup` calls, each completed, then `iters` queued calls
    and one final completion.  CUDA events on the current stream time the
    calls when the output lies on a card, the host clock otherwise."""
    for _ in range(warmup):
        force_completion(fn())
    events = None
    if torch.cuda.is_available():
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    if events is not None:
        events[1].record()
    force_completion(out)
    wall = (time.perf_counter() - t0) * 1e3 / iters
    if events is not None and _first_tensor(out).is_cuda:
        return events[0].elapsed_time(events[1]) / iters
    return wall


# Small kernels the trace launches before the block.  In a process that has
# run for minutes, a trace on the card lost the records of its first three
# or four kernels, however long after its start they ran (not so in a fresh
# process); the lead-in takes that loss in place of the block's kernels.
_LEAD_IN = 16


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Trace the block with `torch.profiler` (CPU activity, and CUDA activity
    when a card is present) and write a Chrome trace, `trace-<pid>-<ns>.json`,
    into `logdir` (default: `eff_torch_trace` in the temporary directory)
    on exit.  Yields `logdir`.

    The profiler first runs a warm-up step over one small op, whose records
    it drops; the trace then opens with a lead-in of `_LEAD_IN` + 1 small
    kernels, completed before the block, under the range
    "profiler.trace lead-in"."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "eff_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    dev = "cpu"
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        dev = "cuda"
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        force_completion(torch.zeros(1, device=dev).add_(1))
        prof.step()
        with torch.profiler.record_function("profiler.trace lead-in"):
            lead = torch.zeros(1, device=dev)
            for _ in range(_LEAD_IN):
                lead.add_(1)
            force_completion(lead)
        yield logdir
        if dev == "cuda":
            torch.cuda.synchronize()
        prof.step()


# The program's own spans are `eff/<layer>.<what>`: `api`, `wait` (the host
# blocks on the card), `pipeline`, `sharding`, `ops`, `ransac`, `hash_sift`,
# `bad`.
PREFIX = "eff/"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A named range (`record_function`) while a torch profiler records,
    and a context that does nothing otherwise: with no profiler running
    no range is entered, so a span costs the guard alone and the program
    keeps its spans on the hot path.  Under `torch.compile` the guard is
    not asked (dynamo cannot trace it) and the range is left out."""
    if not torch.compiler.is_compiling() and _recording():
        return torch.profiler.record_function(name)
    return _OFF


def span(what: str):
    """`annotate` of the program's span `PREFIX + what`."""
    return annotate(PREFIX + what)
