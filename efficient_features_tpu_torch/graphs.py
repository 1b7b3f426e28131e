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
  static input, replays the graph and copies its output block into a
  block of the caller's, which the next replay does not touch.

A captured core's outputs lie in one packed uint8 block (`Layout`): the
joins write the slots and the descriptor rows straight into its views,
so a replay hands over its results in one copy, and a caller that wants
them on the host fetches them in one more (`api.KeyPoints`).  The capture
call returns such a block too; a key's first call returns the core's own
tensors, unless the caller gives a block to write into (`out=`, the
single-device batch loop).

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
`eff/pipeline.replay` (around the copy in, the replay and the copy out)
stands in for the pipeline's spans.  Counters:
`eager` (calls that ran eagerly on a card: a key's first call, or a mesh
call), `captures`, `replays`; and the fetches of results from a card to
the host (`api.py`): `packed_fetches` (a block in one copy) and
`field_fetches` (slot by slot, where the results lie in no block).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

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


# The slot fields of four bytes, in the order they lie in a block.
_WORDS = (("x", torch.float32), ("y", torch.float32),
          ("response", torch.float32), ("angle", torch.float32),
          ("octave", torch.int32), ("size", torch.float32))
# Where each field of a block starts, in bytes: as an allocation does, so
# that the joins writing into it launch the same (vectorised) kernels.
_ALIGN = 16


class Layout(NamedTuple):
    """Where one frame's results lie in its packed uint8 block of `nbytes`:
    x, y, response, angle, octave and size (4 bytes a slot each), the
    count (int32), the valid mask (a byte a slot), then the descriptor
    rows, each field starting `_ALIGN`-aligned; `nbytes` is a multiple of
    `_ALIGN`, so that a (B, nbytes) batch of blocks has the same views row
    by row.  n: slots; desc_bytes: bytes a descriptor row (0: none)."""
    n: int
    desc_bytes: int

    @staticmethod
    def of(cfg: P.FeatureConfig, hw, with_descriptors: bool) -> "Layout":
        """The layout of the core's results for an image of shape hw."""
        ranges = P.level_slot_ranges(cfg, int(hw[0]), int(hw[1]))
        return Layout(sum(b - a for a, b, _ in ranges),
                      cfg.descriptor_bytes if with_descriptors else 0)

    def parts(self) -> list:
        """(key, dtype, start, stop) of each field, in block order."""
        n, at, out = self.n, 0, []
        for key, dt, size in ([(k, dt, 4 * n) for k, dt in _WORDS]
                              + [("count", torch.int32, 4),
                                 ("valid", torch.bool, n),
                                 ("descs", torch.uint8,
                                  n * self.desc_bytes)]):
            out.append((key, dt, at, at + size))
            at = -(-(at + size) // _ALIGN) * _ALIGN
        return out

    @property
    def nbytes(self) -> int:
        return -(-self.parts()[-1][3] // _ALIGN) * _ALIGN

    def unpack(self, block: torch.Tensor):
        """(slots, descriptors or None) as views of `block`, (..., nbytes)
        uint8 on any device: the slots as the core returns them (count of
        shape (...)), the descriptors (..., n, desc_bytes)."""
        views = {key: block[..., a:b].view(dt)
                 for key, dt, a, b in self.parts()}
        slots = {k: views[k] for k, _ in _WORDS}
        slots["valid"] = views["valid"]
        slots["count"] = views["count"][..., 0]
        if not self.desc_bytes:
            return slots, None
        return slots, views["descs"].unflatten(-1, (self.n, self.desc_bytes))

    def new(self, device, batch: tuple = ()) -> torch.Tensor:
        """An uninitialised block (or batch of blocks) on `device`."""
        return torch.empty(batch + (self.nbytes,), dtype=torch.uint8,
                           device=device)


def _core(image, mask, cfg, with_descriptors, out=None):
    """(slots, descriptors or None) of `pipeline.detect_and_compute`,
    written into the views of the block `out` when given."""
    views = None
    if out is not None:
        views = Layout.of(cfg, image.shape, with_descriptors).unpack(out)
    slots, descs = P.detect_and_compute_core(image, cfg, with_descriptors,
                                             mask, views)
    slots.pop("x_level")
    slots.pop("y_level")
    return slots, descs


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t as a contiguous tensor on `device`, uploaded unless it is one."""
    if t.device == device and t.is_contiguous():
        return t
    return upload(t, device)


def run_eager(image, cfg, mask=None, with_descriptors=True, device=None,
              out=None):
    """The core on `device` (default: the image's), eagerly: `image` a 2-D
    uint8 tensor and `mask` one of its shape, nonzero = search here, on any
    device.  Returns (slots, descriptors or None): the core's own tensors,
    or views of the block `out` (`Layout`) that the joins wrote into."""
    dev = image.device if device is None else device_of(device)
    img = _on(image, dev)
    m = None if mask is None else _on(mask, dev) != 0
    return _core(img, m, cfg, with_descriptors, out)


class _Graph:
    """One key's captured core: static input (and mask), graph, the static
    output block, and the event after the last copy out."""

    def __init__(self, image, mask, cfg, with_descriptors, side):
        self.image, self.mask = image, mask
        self.layout = Layout.of(cfg, image.shape, with_descriptors)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.block = self.layout.new(image.device)
            _core(image, mask, cfg, with_descriptors, self.block)
        self.done = torch.cuda.Event()

    def release(self):
        self.graph.reset()
        self.graph = self.block = self.image = self.mask = None


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
        self.packed_fetches = self.field_fetches = 0

    def _count(self, what: str):
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)

    def clear(self):
        """Drop every key and graph and zero the counters."""
        with self._lock:
            gone = list(self._entries.values())
            self._entries.clear()
            self.eager = self.captures = self.replays = 0
            self.packed_fetches = self.field_fetches = 0
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
        key has been seen: (slots, descriptors or None, packed).  The
        tensors returned are the caller's; from a capture or a replay, and
        wherever `out` is given, they are views of one packed block, and
        packed is (block, its `Layout`; the block `out` when given), else
        None."""
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
            return self._eager(image, cfg, mask, with_descriptors, dev, out)
        with entry.lock:
            if entry.evicted:                  # since the lookup above
                return self._eager(image, cfg, mask, with_descriptors, dev,
                                   out)
            g = entry.graph
            if g is None:
                with self._capture_lock:
                    block, entry.graph = self._capture(
                        image, mask, cfg, with_descriptors, dev, out)
                self._count("captures")
                return self._packed(block, entry.graph.layout)
            with span("pipeline.replay"):
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(g.done)
                _fill(g.image, g.mask, image, mask)
                g.graph.replay()
                block = g.block.clone() if out is None else out.copy_(g.block)
                g.done.record(cur)
            self._count("replays")
            return self._packed(block, g.layout)

    @staticmethod
    def _packed(block, layout):
        return layout.unpack(block) + ((block, layout),)

    def _eager(self, image, cfg, mask, with_descriptors, dev, out):
        self._count("eager")
        result = run_eager(image, cfg, mask, with_descriptors, dev, out)
        packed = None if out is None else (
            out, Layout.of(cfg, image.shape, with_descriptors))
        return result + (packed,)

    @staticmethod
    def _capture(image, mask, cfg, with_descriptors, dev, out):
        """This call's result block (`out`, or a new one), the core run on
        the capture's side stream before the capture (the usual warm-up),
        and the key's graph."""
        shape = tuple(image.shape)
        static_img = torch.empty(shape, dtype=torch.uint8, device=dev)
        static_mask = None if mask is None else torch.empty(
            shape, dtype=torch.uint8, device=dev)
        _fill(static_img, static_mask, image, mask)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            block = out
            if block is None:
                block = Layout.of(cfg, shape, with_descriptors).new(dev)
            _core(static_img, static_mask, cfg, with_descriptors, block)
        cur.wait_stream(side)
        if out is None:
            block.record_stream(cur)
        g = _Graph(static_img, static_mask, cfg, with_descriptors, side)
        g.done.record(cur)
        return block, g


CACHE = GraphCache()
