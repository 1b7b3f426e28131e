"""Public API: EfficientFeatures, BAD, HashSIFT and KeyPoints.

Port of `efficient_features_tpu/api.py` (cv::Feature2D-shaped surface of
cuda_efficient_features.h:28-98, cuda_efficient_descriptors.h:27-121):
detect / compute / detect_and_compute and their `_async` forms, convert,
and the seven parameter getter/setter pairs.

The device is explicit: `EfficientFeatures(..., device="cuda")` (and `BAD`,
`HashSIFT`) runs every op on the GPU and raises if CUDA is absent;
`device="cpu"` runs the plain versions of the kernels.  The `_async` methods
enqueue on the current CUDA stream and return device tensors, with no
host read on any route (as the JAX package's `_async` calls);
`KeyPoints.block()` waits for that stream.  On a card, `detect*` of one
image, and each frame of `detect_and_compute_batch` without a mesh, run
as a replay of a captured CUDA graph from the second call of a shape and
configuration on (`graphs.py`); the tensors returned are the caller's.

Results reach the host in one of two ways.  Where the slots and the
descriptors are views of one packed block (`graphs.Layout`: a replay or a
capture of a key, and each frame of the single-device batch), the
synchronous entries (`detect_and_compute`,
`detect_and_compute_batch(as_host=True)`) copy that block in one
`cudaMemcpyAsync` into pinned host memory (torch's caching host
allocator, a buffer a call) and wait once; `detect` waits and fetches
nothing, and a later `as_arrays()` fetches its block the same way.
Elsewhere (a key's first, eager call, the CPU, the mesh routes, user
slots) `KeyPoints` reads the slots field by field.  Both give the same
host arrays, cut from the valid slots by runs (`compact_runs`).

`mesh=` (a `parallel.sharding.Mesh` over `torch.distributed` ranks, made by
`make_mesh` or `make_mesh_2d`): every rank of the mesh makes the same call
on the same input, computes its share on the detector's device, and gets
back what the call without a mesh returns.  The collectives take the
group's transport: NCCL for CUDA tensors, gloo through the host.

While a torch profiler records, each public entry opens the span
`eff/api.<entry>`, each host-to-card copy `eff/api.upload`, and each point
where the host blocks on the card `eff/wait.<what>` (`block`, `count`,
`fetch`); `utils/profiler.span`.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import graphs as G
from . import pipeline as P
from .utils.profiler import span


# More runs of valid slots than this are cut by a boolean mask: a slice
# a run costs more than the mask beyond about this many.
_MAX_RUNS = 64


def compact_runs(valid: np.ndarray):
    """A function that takes the rows of an array where the 1-D bool mask
    `valid` holds, in slot order: `v[valid]` for any v with len(valid)
    rows, with v's dtype.  Detector slots hold their valid slots first in
    each level (`csrc/select_cells.cu`), one run a level, so it joins a
    slice a run; past `_MAX_RUNS` runs it takes the mask."""
    edges = np.flatnonzero(np.diff(valid, prepend=False, append=False))
    if len(edges) > 2 * _MAX_RUNS:
        return lambda v: v[valid]
    runs = edges.reshape(-1, 2)
    if not len(runs):
        return lambda v: v[:0].copy()
    return lambda v: np.concatenate([v[a:b] for a, b in runs])


class _Host(NamedTuple):
    """A `KeyPoints`' results on the host: its slots (numpy, `count`
    included only from a block), its descriptor rows or None, and the
    compaction of its valid slots (`compact_runs`)."""
    slots: dict
    descs: np.ndarray | None
    take: object


def _on_host(slots: dict, descs) -> _Host:
    """Host tensors (or arrays) as a `_Host`."""
    h = {k: np.asarray(v) for k, v in slots.items()}
    return _Host(h, None if descs is None else np.asarray(descs),
                 compact_runs(h["valid"]))


def fetch_block(block: torch.Tensor) -> torch.Tensor:
    """A packed block (or batch of blocks) on the host: from a card, one
    copy into a pinned buffer of torch's caching host allocator and one
    wait for the stream; a host block as it is."""
    if block.device.type != "cuda":
        return block
    host = torch.empty(block.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(block, non_blocking=True)
    # the copy is the stream's last work: waiting for the stream is waiting
    # for it, and a stream wait, unlike an event's, is what torch's sync
    # debug mode and the trace's sync count see
    torch.cuda.current_stream(block.device).synchronize()
    G.CACHE._count("packed_fetches")
    return host


class KeyPoints:
    """Device-resident keypoint set (fixed-capacity slots + validity mask),
    fields as in the reference's SoA layout plus octave and size.

    From a replay or a capture on a card, the slots (and the descriptors
    returned beside them) are views of one packed block: the synchronous
    entries bring it to the host in one pinned copy, and `KeyPoints` keeps
    it there, so that `as_arrays()`, `xysa()`, `cv_keypoints()` and
    `compute()` read nothing more from the card.  Other slots (an eager
    call, the CPU, a mesh, user slots) are read field by field, once."""

    def __init__(self, slots: dict, max_size: float | None = None,
                 level_ranges: tuple | None = None, packed=None):
        self._slots = slots
        self._packed = packed      # (block, graphs.Layout) or None
        self._fetched = None       # _Host, once fetched
        self._host = None
        self._max_size = max_size
        self._level_ranges = level_ranges

    @property
    def max_size(self) -> float | None:
        """Static bound on the keypoint sizes of detector output,
        31 * scale_factor**(nlevels - 1); None when unknown (user slots)."""
        return self._max_size

    @property
    def level_ranges(self) -> tuple | None:
        """Static ((start, stop, size), ...) slot layout of detector output
        (`pipeline.level_slot_ranges`), one entry per pyramid level; None
        when unknown (user slots).  The port does not route on it: one
        kernel call covers every keypoint size."""
        return self._level_ranges

    def block(self) -> "KeyPoints":
        """Wait for the stream that computes the slots."""
        dev = self._slots["x"].device
        with span("wait.block"):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return self

    @property
    def capacity(self) -> int:
        return int(self._slots["x"].shape[0])

    @property
    def count(self) -> int:
        """Number of valid keypoints (reads a device scalar: syncs)."""
        with span("api.count"), span("wait.count"):
            return int(self._slots["count"])

    def _fetch(self, descs=None) -> _Host:
        """The slots (and `descs`, the descriptor rows of a call, unless
        the block holds them) on the host, fetched once: a packed block in
        one copy, else field by field."""
        if self._fetched is None:
            with span("wait.fetch"):
                if self._packed is not None:
                    block, layout = self._packed
                    slots, d = layout.unpack(fetch_block(block))
                else:
                    if self._slots["x"].is_cuda:
                        G.CACHE._count("field_fetches")
                    slots = {k: v.cpu() for k, v in self._slots.items()
                             if k != "count"}
                    d = None if descs is None else descs.cpu()
            self._fetched = _on_host(slots, d)
        return self._fetched

    def _take(self):
        """The compaction of the valid slots (`compact_runs`): from the
        fetched host slots, else from a read of the valid mask alone."""
        if self._fetched is not None:
            return self._fetched.take
        return compact_runs(self._slots["valid"].cpu().numpy())

    def _compact(self):
        if self._host is None:
            with span("api.as_arrays"):
                host = self._fetch()
                self._host = {k: host.take(v) for k, v in host.slots.items()
                              if k not in ("valid", "count")}
        return self._host

    def as_arrays(self):
        """Compacted host arrays: dict(x, y, response, angle, octave, size)."""
        return dict(self._compact())

    def xysa(self) -> np.ndarray:
        """(N, 4) float32 [x, y, size, angle] (descriptor-input layout)."""
        h = self._compact()
        return np.stack([h["x"], h["y"], h["size"], h["angle"]],
                        axis=1).astype(np.float32)

    def cv_keypoints(self):
        """List of cv2.KeyPoint (the reference `convert`); without cv2,
        duck-typed keypoints with the same attributes."""
        h = self._compact()
        try:
            import cv2
            make = lambda x, y, sz, a, r, o: cv2.KeyPoint(  # noqa: E731
                float(x), float(y), float(sz), float(a), float(r), int(o))
        except ImportError:
            from types import SimpleNamespace
            make = lambda x, y, sz, a, r, o: SimpleNamespace(  # noqa: E731
                pt=(float(x), float(y)), size=float(sz), angle=float(a),
                response=float(r), octave=int(o), class_id=-1)
        return [make(x, y, sz, a, r, o)
                for x, y, sz, a, r, o in zip(h["x"], h["y"], h["size"],
                                             h["angle"], h["response"],
                                             h["octave"])]

    def __bool__(self):
        # truthiness must not sync the device (len() would)
        return True

    def __len__(self):
        raise TypeError(
            "len(KeyPoints) is disabled: it would silently sync the device. "
            "Use .count (syncs; number of valid keypoints) or .capacity "
            "(static slot count).")


def _as_u8_tensor(image) -> torch.Tensor:
    """A 2-D uint8 array or tensor as a tensor, where it lies."""
    if isinstance(image, torch.Tensor):
        img = image
    else:
        img = np.asarray(image)
        if img.dtype != np.uint8:
            raise ValueError("image must be a 2-D uint8 (grayscale) array")
        img = torch.from_numpy(np.ascontiguousarray(img))
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise ValueError("image must be a 2-D uint8 (grayscale) array")
    return img


def _as_u8_image(image, device: torch.device) -> torch.Tensor:
    """A 2-D uint8 array or tensor as a contiguous tensor on `device`."""
    return G.upload(_as_u8_tensor(image), device)


def _mask_tensor(mask, shape: tuple) -> torch.Tensor:
    """Validate a user ROI mask (8-bit, nonzero = search here; a numpy
    array or a tensor) and return it as a tensor, where it lies.
    Keypoints are detected only where the mask is nonzero, and masked-out
    corners take no part in the NMS (the CUDA reference accepts the argument
    but ignores it; the JAX package implements it, and so does the port)."""
    m = mask if isinstance(mask, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(mask))
    if tuple(m.shape) != shape:
        raise ValueError(f"mask shape {tuple(m.shape)} != image shape "
                         f"{shape}")
    return m


def _keypoints_to_xysa(keypoints) -> np.ndarray:
    """Accept KeyPoints, (N,4) array, or a list of cv2.KeyPoint-likes."""
    if isinstance(keypoints, KeyPoints):
        return keypoints.xysa()
    if isinstance(keypoints, (list, tuple)):
        return np.array([[k.pt[0], k.pt[1], k.size, k.angle]
                         for k in keypoints], np.float32).reshape(-1, 4)
    a = np.asarray(keypoints, np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError("keypoints must be (N, 4) [x, y, size, angle]")
    return a


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available; pass "
                "device='cpu' to run the plain versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class _DescriptorBase:
    """Shared compute path for BAD / HashSIFT (EfficientDescriptorsAsync,
    cuda_efficient_descriptors.h:27-57)."""

    _kind: str
    _scale: float
    _nbits: int
    _device: torch.device
    _fused = False      # HashSIFT only: K11 instead of K4 + K5

    def compute(self, image, keypoints) -> np.ndarray:
        """Host (N, bytes) uint8 descriptors; `KeyPoints` rows are compacted
        to the valid keypoints."""
        with span("api.compute"):
            desc = self.compute_async(image, keypoints)
            with span("wait.fetch"):
                out = desc.cpu().numpy()
                take = keypoints._take() \
                    if isinstance(keypoints, KeyPoints) else None
            return out if take is None else take(out)

    def compute_async(self, image, keypoints) -> torch.Tensor:
        """Descriptors for `keypoints` on `image` (the raw image, no blur),
        as a device tensor.

        `KeyPoints` input stays on the device, and the rows align with its
        slots (invalid slots give zero rows; compact with the valid mask, as
        compute() does).  An (N, 4) [x, y, size, angle] tensor stays on the
        device too.  Host (N, 4) arrays and lists of cv2.KeyPoint-likes give
        rows in the caller's order.  One kernel call covers every keypoint
        size."""
        with span("api.compute_async"):
            img = _as_u8_image(image, self._device)
            if isinstance(keypoints, KeyPoints):
                s = keypoints._slots
                xysa = torch.stack([s["x"], s["y"], s["size"], s["angle"]],
                                   dim=1).to(self._device, torch.float32)
                valid = s["valid"].to(self._device)
                return P.compute(img, xysa, valid, self._nbits, self._kind,
                                 self._scale, self._fused)
            if isinstance(keypoints, torch.Tensor):
                if keypoints.dim() != 2 or keypoints.shape[1] != 4:
                    raise ValueError(
                        "device keypoints must be (N, 4) [x, y, size, angle]")
                xysa = keypoints.to(self._device, torch.float32)
            else:
                xysa = torch.from_numpy(_keypoints_to_xysa(keypoints))
                with span("api.upload"):
                    xysa = xysa.to(self._device)
            n = xysa.shape[0]
            if n == 0:
                return torch.zeros((0, self.descriptor_size()),
                                   dtype=torch.uint8, device=self._device)
            valid = torch.ones(n, dtype=torch.bool, device=self._device)
            return P.compute(img, xysa, valid, self._nbits, self._kind,
                             self._scale, self._fused)

    def descriptor_size(self) -> int:
        return self._nbits // 8

    def descriptor_type(self):
        return np.uint8

    def default_norm(self) -> str:
        return "hamming"


class BAD(_DescriptorBase):
    """Box Average Difference descriptor (cuda_efficient_descriptors.h:67-90).

    scale_factor: sampling-window scale (1.0 for ORB-like keypoints)."""

    SIZE_512_BITS = 512
    SIZE_256_BITS = 256
    _kind = "bad"

    def __init__(self, scale_factor: float = 1.0, nbits: int = 256,
                 device="cuda"):
        if nbits not in (256, 512):
            raise ValueError("BAD supports 256 or 512 bits")
        self._scale = float(scale_factor)
        self._nbits = nbits
        self._device = resolve_device(device)

    @staticmethod
    def create(scale_factor: float = 1.0, nbits: int = 256,
               device="cuda") -> "BAD":
        return BAD(scale_factor, nbits, device)


class HashSIFT(_DescriptorBase):
    """HashSIFT descriptor (cuda_efficient_descriptors.h:101-121).

    cropping_scale: patch diameter = cropping_scale * kp.size.
    sigma: accepted for API parity and has no effect, as in the JAX package
    and the GPU reference (whose Gaussian pre-blur call is commented out,
    cuda_hash_sift.cu:392).
    fused: run the warp and the histogram as one kernel (K11) instead of
    two (K4, K5); the descriptor bytes are the same."""

    SIZE_512_BITS = 512
    SIZE_256_BITS = 256
    _kind = "hash_sift"

    def __init__(self, cropping_scale: float = 1.0, nbits: int = 256,
                 sigma: float = 0.0, device="cuda", fused: bool = False):
        if nbits not in (256, 512):
            raise ValueError("HashSIFT supports 256 or 512 bits")
        self._scale = float(cropping_scale)
        self._nbits = nbits
        self._sigma = float(sigma)
        self._device = resolve_device(device)
        self._fused = bool(fused)

    @staticmethod
    def create(cropping_scale: float = 1.0, nbits: int = 256,
               sigma: float = 0.0, device="cuda",
               fused: bool = False) -> "HashSIFT":
        return HashSIFT(cropping_scale, nbits, sigma, device, fused)


class EfficientFeatures:
    """Multi-scale FAST+Harris detector with BAD/HashSIFT descriptors
    (cuda_efficient_features.h:28-98).

    hs_fused: HashSIFT through the fused kernel (K11) instead of the warp
    and histogram kernels (K4, K5): the same descriptor bytes, one launch
    per level less.  Off by default, as in the JAX package."""

    def __init__(self, nfeatures: int = 5000, scale_factor: float = 1.2,
                 nlevels: int = 8, first_level: int = 0,
                 fast_threshold: int = 20, nonmax_radius: int = 15,
                 descriptor_type: str = "hash_sift_256", device="cuda",
                 hs_fused: bool = False):
        self._cfg = P.FeatureConfig(
            nfeatures=nfeatures, scale_factor=scale_factor, nlevels=nlevels,
            first_level=first_level, fast_threshold=fast_threshold,
            nonmax_radius=nonmax_radius, descriptor_type=descriptor_type,
            hs_fused=bool(hs_fused))
        self._device = resolve_device(device)

    create = staticmethod(lambda *a, **kw: EfficientFeatures(*a, **kw))

    @property
    def device(self) -> torch.device:
        return self._device

    def _inputs(self, image, mask):
        """(image, mask or None) as checked tensors, where they lie."""
        img = _as_u8_tensor(image)
        P.validate_image_shape(self._cfg, *img.shape)
        if mask is not None:
            mask = _mask_tensor(mask, tuple(img.shape))
        return img, mask

    def _run(self, img, mask, mesh, with_descriptors: bool):
        """(slots, descriptors or None, (block, layout) or None) of one
        image: on a card through the graph cache (`graphs.py`; a packed
        block from a capture or a replay), on the CPU eagerly, and over a
        mesh eagerly on its row bands."""
        dev = self._device
        if mesh is None and dev.type == "cuda":
            return G.CACHE.run(img, self._cfg, mask, with_descriptors, dev)
        img = G.upload(img, dev)
        mask = None if mask is None else G.upload(mask, dev) != 0
        if mesh is None:
            return G.run_eager(img, self._cfg, mask, with_descriptors,
                               dev) + (None,)
        from .parallel import sharding as SH
        G.CACHE.note_eager(dev)
        out = SH.detect_pyramid_rows_sharded(img, self._cfg, mesh,
                                             with_descriptors, mask)
        return (out if with_descriptors else (out, None)) + (None,)

    # -- detection ---------------------------------------------------------

    def detect(self, image, mask=None, mesh=None) -> KeyPoints:
        with span("api.detect"):
            return self.detect_async(image, mask, mesh).block()

    def detect_async(self, image, mask=None, mesh=None) -> KeyPoints:
        """Keypoints of one image.  mesh: split the image, and its whole
        pyramid, into row bands over the mesh's ranks
        (`parallel/sharding.detect_pyramid_rows_sharded`); the slots equal
        the call without a mesh.  An image too small for the bands' halos
        raises ValueError."""
        with span("api.detect_async"):
            img, mask = self._inputs(image, mask)
            slots, _, packed = self._run(img, mask, mesh, False)
            return self._keypoints(slots, img.shape, packed)

    def _keypoints(self, slots: dict, hw, packed=None) -> KeyPoints:
        """Detector output with its static size bound and slot layout."""
        cfg = self._cfg
        return KeyPoints(
            slots,
            max_size=float(P.S.PATCH_SIZE
                           * cfg.scale_factor ** (cfg.nlevels - 1)),
            level_ranges=P.level_slot_ranges(cfg, int(hw[0]), int(hw[1])),
            packed=packed)

    def compute(self, image, keypoints) -> np.ndarray:
        return self._describer().compute(image, keypoints)

    def compute_async(self, image, keypoints) -> torch.Tensor:
        return self._describer().compute_async(image, keypoints)

    def _describer(self) -> _DescriptorBase:
        kind, bits = self._cfg.descriptor_type.rsplit("_", 1)
        if kind == "bad":
            return BAD(1.0, int(bits), device=self._device)
        return HashSIFT(1.0, int(bits), device=self._device,
                        fused=self._cfg.hs_fused)

    def detect_and_compute(self, image, mask=None, mesh=None):
        """(KeyPoints, (count, bytes) uint8 numpy descriptors of the valid
        keypoints)."""
        with span("api.detect_and_compute"):
            kps, desc = self.detect_and_compute_async(image, mask, mesh)
            if kps._packed is None:
                kps.block()
            host = kps._fetch(desc)
            return kps, host.take(host.descs)

    def detect_and_compute_async(self, image, mask=None, mesh=None):
        """(KeyPoints, slot-aligned (capacity, bytes) uint8 device tensor);
        invalid slots have zero rows.  mesh: as for `detect_async`, each
        band describing the keypoints in its rows."""
        with span("api.detect_and_compute_async"):
            img, mask = self._inputs(image, mask)
            slots, descs, packed = self._run(img, mask, mesh, True)
            return self._keypoints(slots, img.shape, packed), descs

    def convert(self, keypoints: KeyPoints):
        """KeyPoints -> list of cv2.KeyPoint (reference `convert`)."""
        return keypoints.cv_keypoints()

    def detect_and_compute_batch(self, images, mesh=None, as_host=False):
        """Batched detect+compute on the detector's device.  images:
        (B, H, W) uint8, an array or a tensor.  Returns (slot dict with a
        leading batch axis, (B, capacity, bytes) uint8 descriptors) on the
        device; frame i equals a single call on images[i].

        mesh=None runs the frames one after the other on the detector's one
        device (parallel/sharding.detect_and_compute_batch); the JAX
        package's default is instead a mesh of every device it finds.  A
        1-axis mesh deals the frames over its ranks (B divisible by its
        size); a 2-axis (dp, sp) mesh (`make_mesh_2d`) deals them over dp
        and splits each frame's pyramid into row bands over sp
        (`detect_and_compute_batch_2d`).  Every rank gets the whole batch.

        as_host=True instead fetches everything and returns a list of
        (KeyPoints, descriptors) per image, descriptor rows compacted to the
        valid keypoints, as `detect_and_compute` gives them: without a
        mesh the (B, block) results in one copy into pinned memory, with
        one field by field."""
        with span("api.detect_and_compute_batch"):
            from .parallel import sharding as SH
            imgs = images if isinstance(images, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(images))
            if imgs.dim() != 3 or imgs.dtype != torch.uint8:
                raise ValueError("images must be (B, H, W) uint8")
            P.validate_image_shape(self._cfg, *imgs.shape[1:])
            imgs = G.upload(imgs, self._device)
            block = None
            if mesh is None:
                block, layout = SH.batch_block(imgs, self._cfg, imgs.is_cuda)
                slots, desc = layout.unpack(block)
            else:
                G.CACHE.note_eager(self._device)
                if isinstance(mesh, SH.Mesh) and len(mesh.shape) == 2:
                    slots, desc = SH.detect_and_compute_batch_2d(
                        imgs, self._cfg, mesh)
                else:
                    slots, desc = SH.detect_and_compute_batch(
                        imgs, self._cfg, mesh)
            if not as_host:
                return slots, desc
            with span("wait.fetch"):
                if block is not None:
                    host, desc = layout.unpack(fetch_block(block))
                else:
                    if desc.is_cuda:
                        G.CACHE._count("field_fetches")
                    host = {k: v.cpu() for k, v in slots.items()}
                    desc = desc.cpu()
            out = []
            for i in range(imgs.shape[0]):
                frame = {k: v[i] for k, v in host.items()}
                kps = self._keypoints(frame, imgs.shape[1:])
                kps._fetched = _on_host(frame, desc[i])
                out.append((kps, kps._fetched.take(kps._fetched.descs)))
            return out

    # -- descriptor metadata -------------------------------------------------

    def descriptor_size(self) -> int:
        return self._cfg.descriptor_bytes

    def descriptor_type(self):
        return np.uint8

    def default_norm(self) -> str:
        return "hamming"

    # -- parameters (7 getter/setter pairs, cuda_efficient_features.h:78-97) --

    def set_max_features(self, v: int):
        self._cfg = replace(self._cfg, nfeatures=int(v))

    def get_max_features(self) -> int:
        return self._cfg.nfeatures

    def set_scale_factor(self, v: float):
        self._cfg = replace(self._cfg, scale_factor=float(v))

    def get_scale_factor(self) -> float:
        return self._cfg.scale_factor

    def set_n_levels(self, v: int):
        self._cfg = replace(self._cfg, nlevels=int(v))

    def get_n_levels(self) -> int:
        return self._cfg.nlevels

    def set_first_level(self, v: int):
        self._cfg = replace(self._cfg, first_level=int(v))

    def get_first_level(self) -> int:
        return self._cfg.first_level

    def set_fast_threshold(self, v: int):
        self._cfg = replace(self._cfg, fast_threshold=int(v))

    def get_fast_threshold(self) -> int:
        return self._cfg.fast_threshold

    def set_nonmax_radius(self, v: int):
        self._cfg = replace(self._cfg, nonmax_radius=int(v))

    def get_nonmax_radius(self) -> int:
        return self._cfg.nonmax_radius

    def set_descriptor_type(self, v: str):
        if v not in P.DESCRIPTOR_TYPES:
            raise ValueError(
                f"descriptor_type must be one of {P.DESCRIPTOR_TYPES}")
        self._cfg = replace(self._cfg, descriptor_type=v)

    def get_descriptor_type(self) -> str:
        return self._cfg.descriptor_type
