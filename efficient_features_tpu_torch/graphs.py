"""The single-device detect-and-compute core replayed as CUDA graphs.

On a card, with the image's shape and the configuration fixed, the core
(`pipeline.detect_and_compute_core`: the pyramid, each level's detection,
blur and descriptors, the joins) is a fixed chain of kernel launches with
no host read (211 at 2160x3840 with BAD-256, 267 with HashSIFT-256, on an
H100).  `GraphCache.run` launches that chain once per
call as a captured `torch.cuda.CUDAGraph`:

- the first call of a key runs eagerly; it fills every cached device table
  and builds the kernels;
- the second call of that key runs the core on a side stream (its result,
  and the warm-up before a capture), then captures the core from that
  stream into a graph with a memory pool of its own;
- every later call copies the image (and the mask) into the graph's
  static input, replays the graph and copies its outputs into tensors of
  the caller's, which the next replay does not touch.

A key is (device, image shape, `FeatureConfig`, descriptors or not, mask or
not).  The cache holds `MAX_KEYS` keys; a new one evicts the least recently
used, whose graph and memory pool are freed.  One cache serves the process
(`CACHE`), so detectors of one configuration share a key's pool; each
key's lock and its graph's event keep that key's replays on several
threads and streams in order, while other keys run beside them.  A graph
reads the device tables the core caches (`ops/image.py`, `ops/detect.py`,
`ops/detect_kernels.py`, `ops/hash_sift.py`, `ops/bad.py`,
`models/params.py`) by address: those caches never drop an entry.
`EfficientFeatures` goes through it for one image on a card, and so
does `parallel/sharding.detect_and_compute_batch` without a mesh, once a
frame; the CPU, the mesh routes, `compute` and the matcher run eagerly and
never come here.

A replay runs no Python of the pipeline: the kernel wrappers' `launches`
counters do not move (a trace shows its kernels by name), and the span
`eff/pipeline.replay` (around the copies in, the replay and the copies
out) stands in for the pipeline's spans.  Counters:
`eager` (calls that ran eagerly on a card: a key's first call, or a mesh
call), `captures`, `replays`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from . import pipeline as P
from .utils.profiler import span

MAX_KEYS = 4


def device_of(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def graph_key(device, shape, cfg: P.FeatureConfig, with_descriptors: bool,
              masked: bool) -> tuple:
    """The key of one captured core."""
    return (device_of(device), tuple(int(n) for n in shape), cfg,
            bool(with_descriptors), bool(masked))


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t as a contiguous tensor on `device` (one copy from the host)."""
    with span("api.upload"):
        return t.to(device).contiguous()


def _mask_bytes(mask: torch.Tensor) -> torch.Tensor:
    """A mask as uint8, nonzero where the mask is nonzero."""
    if mask.dtype == torch.bool:
        return mask.view(torch.uint8)
    if mask.dtype == torch.uint8:
        return mask
    return (mask != 0).view(torch.uint8)


def _fill(image_buf, mask_buf, image, mask):
    """Copy the image (and the mask, as bytes) into a graph's input."""
    with span("api.upload"):
        image_buf.copy_(image)
        if mask is not None:
            mask_buf.copy_(_mask_bytes(mask))


def _core(image, mask, cfg, with_descriptors):
    """(slots, descriptors or None) of `pipeline.detect_and_compute`."""
    slots, descs = P.detect_and_compute_core(image, cfg, with_descriptors,
                                             mask)
    slots.pop("x_level")
    slots.pop("y_level")
    return slots, descs


def _deliver(result, out):
    """`result` in the caller's tensors: copied into `out` ((slots, descs)
    of the same shapes) when given, else into new ones."""
    slots, descs = result
    if out is None:
        return ({k: v.clone() for k, v in slots.items()},
                None if descs is None else descs.clone())
    for k, v in slots.items():
        out[0][k].copy_(v)
    if descs is not None:
        out[1].copy_(descs)
    return out


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t as a contiguous tensor on `device`, uploaded unless it is one."""
    if t.device == device and t.is_contiguous():
        return t
    return upload(t, device)


def run_eager(image, cfg, mask=None, with_descriptors=True, device=None,
              out=None):
    """The core on `device` (default: the image's), eagerly: `image` a 2-D
    uint8 tensor and `mask` one of its shape, nonzero = search here, on any
    device.  Returns (slots, descriptors or None), copied into `out` when
    given."""
    dev = image.device if device is None else device_of(device)
    img = _on(image, dev)
    m = None if mask is None else _on(mask, dev) != 0
    result = _core(img, m, cfg, with_descriptors)
    return result if out is None else _deliver(result, out)


class _Graph:
    """One key's captured core: static input (and mask), graph, static
    outputs, and the event after the last copies out."""

    def __init__(self, image, mask, cfg, with_descriptors, side):
        self.image, self.mask = image, mask
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = _core(image, mask, cfg, with_descriptors)
        self.done = torch.cuda.Event()

    def release(self):
        self.graph.reset()
        self.graph = self.out = self.image = self.mask = None


class _Entry:
    """One key: its lock, which orders its capture and replays, and its
    graph once captured (None before, and after the key's eviction)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graph = None
        self.evicted = False

    def detach(self):
        """Mark the key evicted and hand over its graph, once no replay of
        it runs."""
        with self.lock:
            self.evicted = True
            g, self.graph = self.graph, None
        return g


class GraphCache:
    """Captured cores by key, least recently used first.

    `_lock` guards `_entries` and the counters and is held only to read or
    change them; each key's own lock orders its capture and its replays,
    so that calls of other keys (and every key's first, eager call) run
    beside them.  `_capture_lock` keeps captures, and the freeing of
    evicted graphs' pools, one at a time: the allocator frees no memory
    while a capture is under way."""

    def __init__(self):
        self._entries = OrderedDict()
        self._lock = threading.Lock()
        self._capture_lock = threading.Lock()
        self.eager = self.captures = self.replays = 0

    def _count(self, what: str):
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)

    def clear(self):
        """Drop every key and graph and zero the counters."""
        with self._lock:
            gone = list(self._entries.values())
            self._entries.clear()
            self.eager = self.captures = self.replays = 0
        self._release(gone)

    def note_eager(self, device):
        """Count a call that ran eagerly on a card outside the cache (a
        mesh call)."""
        if device_of(device).type == "cuda":
            self._count("eager")

    def _admit(self, key) -> list:
        """Put a new key last (under `_lock`), and take out and return the
        least recently used entries beyond MAX_KEYS."""
        self._entries[key] = _Entry()
        gone = []
        while len(self._entries) > MAX_KEYS:
            gone.append(self._entries.popitem(last=False)[1])
        return gone

    def _release(self, entries):
        """Free the graphs and memory pools of evicted entries."""
        graphs = [g for g in (e.detach() for e in entries) if g is not None]
        if graphs:
            with self._capture_lock:
                for g in graphs:
                    g.release()
                torch.cuda.empty_cache()

    def run(self, image, cfg, mask=None, with_descriptors=True, device=None,
            out=None):
        """`run_eager`'s result on a card, through the key's graph once the
        key has been seen.  The tensors returned are the caller's."""
        dev = image.device if device is None else device_of(device)
        if dev.type != "cuda":
            raise ValueError(f"graphs run on a card, not on {dev}")
        key = graph_key(dev, image.shape, cfg, with_descriptors,
                        mask is not None)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                gone = self._admit(key)
            else:
                self._entries.move_to_end(key)
        if entry is None:
            self._release(gone)
            self._count("eager")
            return run_eager(image, cfg, mask, with_descriptors, dev, out)
        with entry.lock:
            if entry.evicted:                  # since the lookup above
                self._count("eager")
                return run_eager(image, cfg, mask, with_descriptors, dev,
                                 out)
            g = entry.graph
            if g is None:
                with self._capture_lock:
                    result, entry.graph = self._capture(
                        image, mask, cfg, with_descriptors, dev)
                self._count("captures")
                return result if out is None else _deliver(result, out)
            with span("pipeline.replay"):
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(g.done)
                _fill(g.image, g.mask, image, mask)
                g.graph.replay()
                result = _deliver(g.out, out)
                g.done.record(cur)
            self._count("replays")
            return result

    @staticmethod
    def _capture(image, mask, cfg, with_descriptors, dev):
        """This call's result, the core run on the capture's side stream
        before the capture (the usual warm-up), and the key's graph."""
        shape = tuple(image.shape)
        static_img = torch.empty(shape, dtype=torch.uint8, device=dev)
        static_mask = None if mask is None else torch.empty(
            shape, dtype=torch.uint8, device=dev)
        _fill(static_img, static_mask, image, mask)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            result = _core(static_img, static_mask, cfg, with_descriptors)
        cur.wait_stream(side)
        for t in list(result[0].values()) + [result[1]]:
            if t is not None:
                t.record_stream(cur)
        g = _Graph(static_img, static_mask, cfg, with_descriptors, side)
        g.done.record(cur)
        return result, g


CACHE = GraphCache()
