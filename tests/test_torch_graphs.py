"""The graph cache (`efficient_features_tpu_torch/graphs.py`): the
single-device detect-and-compute core captured once per key and replayed.

On the CPU: nothing is ever captured and the results are those of the
eager pipeline; the key tells apart what a graph depends on; the cache
evicts its least recently used key.  On a card (`cuda`): a replay equals
the eager call bit for bit on every descriptor type, route and shape the
core takes, outputs belong to the caller, the batch equals single calls,
the counters follow each key, a replay launches the eager call's kernels
and outlives the table caches, a mesh call never captures, and calls on
several threads stay in order, on the card and on the host.  The
synchronous entries fetch a replay's packed block in one pinned copy with
one wait, and give the host arrays of the eager route's field-by-field
reads bit for bit.
"""
import json
import socket
import threading

import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures
from efficient_features_tpu_torch import graphs as G
from efficient_features_tpu_torch import pipeline as P
from efficient_features_tpu_torch.api import KeyPoints
from efficient_features_tpu_torch.ops import image as OI
from efficient_features_tpu_torch.samples import sample_common as SC
from efficient_features_tpu_torch.utils import profiler

from util import make_test_image


@pytest.fixture(autouse=True)
def _fresh_cache():
    G.CACHE.clear()
    yield
    G.CACHE.clear()


def counters():
    return G.CACHE.eager, G.CACHE.captures, G.CACHE.replays


def same(a, b):
    """(slots, descriptors or None) pairs equal bit for bit, in dtype."""
    (sa, da), (sb, db) = a, b
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k
    assert (da is None) == (db is None)
    if da is not None:
        assert da.dtype == db.dtype and torch.equal(da, db)


def on_host(kps, desc=None):
    """A call's host results: as_arrays(), xysa() and the compacted
    descriptors (a host array, or device rows compacted here)."""
    if isinstance(desc, torch.Tensor):
        desc = desc.cpu().numpy()[kps._slots["valid"].cpu().numpy()]
    return kps.as_arrays(), kps.xysa(), desc


def same_host(a, b):
    """`on_host` results equal bit for bit, in dtype."""
    (aa, ax, ad), (ba, bx, bd) = a, b
    assert list(aa) == list(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype, k
        assert np.array_equal(aa[k], ba[k]), k
    assert np.array_equal(ax, bx)
    assert (ad is None) == (bd is None)
    if ad is not None:
        assert ad.dtype == bd.dtype and np.array_equal(ad, bd)


def eager_host(img, cfg, with_descriptors, dev):
    """The eager route's host results: the core's own tensors, read field
    by field."""
    slots, desc = G.run_eager(torch.from_numpy(img), cfg,
                              with_descriptors=with_descriptors, device=dev)
    return on_host(KeyPoints(slots), desc)


def fetches():
    return G.CACHE.packed_fetches, G.CACHE.field_fetches


def as_pair(kps, desc=None):
    return kps._slots, desc


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

CFG = P.FeatureConfig(nfeatures=300, descriptor_type="bad_256")


@pytest.mark.parametrize("change", ["shape", "config", "mask",
                                    "with_descriptors"])
def test_key_tells_apart(change):
    base = dict(device="cpu", shape=(96, 128), cfg=CFG,
                with_descriptors=True, masked=False)
    other = dict(base)
    other.update({
        "shape": {"shape": (128, 96)},
        "config": {"cfg": P.FeatureConfig(nfeatures=301,
                                          descriptor_type="bad_256")},
        "mask": {"masked": True},
        "with_descriptors": {"with_descriptors": False}}[change])
    assert G.graph_key(**base) == G.graph_key(**dict(base))
    assert G.graph_key(**base) != G.graph_key(**other)


@pytest.mark.parametrize("call", ["detect_and_compute_async", "detect_async",
                                  "masked", "batch"])
def test_cpu_never_captures(call):
    """On the CPU each call runs the eager pipeline: nothing is captured,
    nothing is counted, and the results are the pipeline's."""
    imgs = [make_test_image(96, 128, seed=s) for s in (1, 2, 3)]
    mask = np.zeros((96, 128), np.uint8)
    mask[10:80, 20:110] = 255
    ef = EfficientFeatures(nfeatures=300, descriptor_type="bad_256",
                           device="cpu")
    for img in imgs * 2:
        t = torch.from_numpy(img)
        if call == "detect_and_compute_async":
            got = as_pair(*ef.detect_and_compute_async(img))
            want = P.detect_and_compute(t, ef._cfg)
        elif call == "detect_async":
            got = as_pair(ef.detect_async(img))
            want = P.detect(t, ef._cfg), None
        elif call == "masked":
            got = as_pair(*ef.detect_and_compute_async(img, mask=mask))
            want = P.detect_and_compute(t, ef._cfg, torch.from_numpy(mask))
        else:
            slots, desc = ef.detect_and_compute_batch(np.stack([img, img]))
            got = {k: v[1] for k, v in slots.items()}, desc[1]
            want = P.detect_and_compute(t, ef._cfg)
        same(got, want)
    assert counters() == (0, 0, 0)
    assert not G.CACHE._entries


def test_run_refuses_the_cpu():
    with pytest.raises(ValueError, match="on a card"):
        G.CACHE.run(torch.zeros((96, 128), dtype=torch.uint8), CFG)


class _Graph:
    released = 0

    def release(self):
        _Graph.released += 1


def test_cache_evicts_the_least_recently_used():
    """Beyond MAX_KEYS keys the least recently used goes, and a captured
    one is released; a key used again moves to the back."""
    cache = G.GraphCache()
    _Graph.released = 0
    for k in range(G.MAX_KEYS):
        assert cache._admit(k) == []
        if k % 2 == 0:
            cache._entries[k].graph = _Graph()
    cache._entries.move_to_end(0)
    gone = cache._admit("new")          # evicts key 1, seen once
    assert list(cache._entries) == [2, 3, 0, "new"]
    cache._release(gone)
    assert _Graph.released == 0 and gone[0].evicted
    captured = cache._entries[2]
    gone = cache._admit("newer")        # evicts key 2, captured
    assert gone == [captured]
    cache._release(gone)
    assert 2 not in cache._entries and _Graph.released == 1
    assert captured.graph is None and captured.evicted


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32,
                                   torch.float32])
def test_mask_bytes_keep_the_nonzero_pixels(dtype):
    m = torch.tensor([[0, 1, 0], [2, 0, 3]]).to(dtype)
    if dtype == torch.float32:
        m = m * 0.25                   # 0.25 and 0.5 are nonzero
    got = G._mask_bytes(m)
    assert got.dtype == torch.uint8
    assert torch.equal(got != 0, m != 0)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured on a card")
    return torch.device("cuda")


SHAPES = {"4k": (2160, 3840, 40000), "kitti": (376, 1241, 2000)}


def frames(shape: str, n: int = 3):
    """n distinct frames of the shape, and its ROI mask."""
    h, w, _ = SHAPES[shape]
    if shape == "4k":
        imgs = [SC.tiled_scene(h, w, seed=40 + s, distinct=False)
                for s in range(n)]
    else:
        imgs = [make_test_image(h, w, seed=40 + s) for s in range(n)]
    return imgs, SC.roi_mask(h, w)


# (descriptor type, hs_fused, nonmax radius, masked, with descriptors)
ROUTES = [
    ("bad_256", False, 15, False, True),
    ("bad_256", False, 15, True, True),
    ("bad_512", False, 15, False, True),
    ("bad_512", False, 15, True, True),
    ("hash_sift_256", False, 15, False, True),
    ("hash_sift_256", False, 15, True, True),
    ("hash_sift_256", True, 15, False, True),
    ("hash_sift_256", True, 15, True, True),
    ("bad_256", False, 15, False, False),     # detect alone
    ("bad_256", False, 15, True, False),
    ("bad_256", False, 5, False, True),       # K7
    ("bad_256", False, 5, True, True),        # K8 + K9
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("route", ROUTES,
                         ids=["-".join(map(str, r)) for r in ROUTES])
def test_replay_equals_the_eager_call(dev, shape, route):
    """Over three distinct frames: call 1 eager, call 2 the capture, calls
    3-5 replays, each bit for bit the eager pipeline's result."""
    dtype, fused, radius, masked, with_desc = route
    imgs, roi = frames(shape)
    mask = roi if masked else None
    ef = EfficientFeatures(nfeatures=SHAPES[shape][2], nonmax_radius=radius,
                           descriptor_type=dtype, hs_fused=fused,
                           device="cuda")
    m = None if mask is None else torch.from_numpy(mask)
    want = [G.run_eager(torch.from_numpy(img), ef._cfg, m, with_desc, dev)
            for img in imgs]
    for i in (0, 1, 2, 0, 1):
        if with_desc:
            got = as_pair(*ef.detect_and_compute_async(imgs[i], mask=mask))
        else:
            got = as_pair(ef.detect_async(imgs[i], mask=mask))
        same(got, want[i])
    assert counters() == (1, 1, 3)


@pytest.mark.cuda
def test_outputs_belong_to_the_caller(dev):
    """Results held from earlier calls (eager, capture, replay) keep their
    values while later replays run on other frames."""
    imgs, _ = frames("4k")
    ef = EfficientFeatures(nfeatures=40000, descriptor_type="bad_256",
                           device="cuda")
    held = [ef.detect_and_compute_async(img) for img in imgs]
    copies = [({k: v.clone() for k, v in kps._slots.items()}, d.clone())
              for kps, d in held]
    for img in imgs[::-1] * 2:
        ef.detect_and_compute_async(img)
    torch.cuda.synchronize()
    for (kps, d), want in zip(held, copies):
        same((kps._slots, d), want)
    assert counters() == (1, 1, 7)


@pytest.mark.cuda
def test_batch_equals_single_calls(dev):
    """Two batches of four frames (one eager frame, one capture, six
    replays) equal four single eager calls."""
    imgs, _ = frames("4k", 4)
    ef = EfficientFeatures(nfeatures=40000, descriptor_type="bad_256",
                           device="cuda")
    want = [G.run_eager(torch.from_numpy(img), ef._cfg, device=dev)
            for img in imgs]
    for _ in range(2):
        slots, desc = ef.detect_and_compute_batch(np.stack(imgs))
        for i in range(4):
            same(({k: v[i] for k, v in slots.items()}, desc[i]), want[i])
    assert counters() == (1, 1, 6)


@pytest.mark.cuda
def test_each_key_captures_once(dev):
    """n calls of one key read (1, 1, n - 2); a mask, descriptors or not
    and a new shape each start a key of their own."""
    a = make_test_image(240, 320, seed=5)
    b = make_test_image(256, 320, seed=6)
    mask = np.full(a.shape, 255, np.uint8)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    for n in range(1, 7):
        ef.detect_and_compute_async(a)
        assert counters() == (1, min(n - 1, 1), max(n - 2, 0))
    ef.detect_and_compute_async(a, mask=mask)
    ef.detect_and_compute_async(a, mask=mask)
    assert counters() == (2, 2, 4)
    ef.detect_async(a)
    ef.detect_async(a)
    assert counters() == (3, 3, 4)
    ef.detect_and_compute_async(b)
    ef.detect_and_compute_async(b)
    ef.detect_and_compute_async(b)
    assert counters() == (4, 4, 5)
    ef.detect_and_compute_async(a)           # the first key: still replayed
    assert counters() == (4, 4, 6)


@pytest.mark.cuda
def test_the_least_recent_key_is_evicted(dev):
    """MAX_KEYS + 1 captured shapes: the first shape's graph is gone, and
    its next call runs eagerly."""
    ef = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                           device="cuda")
    imgs = [make_test_image(200 + 8 * k, 320, seed=k)
            for k in range(G.MAX_KEYS + 1)]
    for img in imgs:
        ef.detect_and_compute_async(img)
        ef.detect_and_compute_async(img)
    assert counters() == (G.MAX_KEYS + 1, G.MAX_KEYS + 1, 0)
    assert len(G.CACHE._entries) == G.MAX_KEYS
    want = G.run_eager(torch.from_numpy(imgs[0]), ef._cfg, device=dev)
    same(as_pair(*ef.detect_and_compute_async(imgs[0])), want)
    assert counters() == (G.MAX_KEYS + 2, G.MAX_KEYS + 1, 0)


def traced_kernels(fn) -> dict:
    """{kernel name: launches} of one call of fn in a torch.profiler trace,
    after a warm-up step and a lead-in of spin kernels (a trace may lose
    the records of its first few kernels)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(16):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
        prof.step()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not any(
                w in e.key for w in ("spin_kernel", "Memcpy", "Memset")):
            out[e.key] = out.get(e.key, 0) + e.count
    return out


@pytest.mark.cuda
def test_a_replay_traces_the_eager_calls_kernels(dev):
    """A replay launches the eager call's kernels, name for name and
    count for count, and calls no wrapper: K10's counter moves 7 on an
    eager call and not at all on a replay, K14's 8; both trace the blur
    as K14's 8 launches."""
    img = make_test_image(240, 320, seed=7)
    t = torch.from_numpy(img)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    ef.detect_and_compute_async(img)
    ef.detect_and_compute_async(img)
    before = OI.resize_u8_kernel.launches
    blurs = OI.gaussian_blur7_u8_kernel.launches
    G.run_eager(t, ef._cfg, device=dev)
    assert OI.resize_u8_kernel.launches == before + 7
    assert OI.gaussian_blur7_u8_kernel.launches == blurs + 8
    ef.detect_and_compute_async(img)
    assert OI.resize_u8_kernel.launches == before + 7
    assert OI.gaussian_blur7_u8_kernel.launches == blurs + 8
    for _ in range(3):                  # a lost record takes a launch away
        eager = traced_kernels(lambda: G.run_eager(t, ef._cfg, device=dev))
        replay = traced_kernels(lambda: ef.detect_and_compute_async(img))
        if eager == replay:
            break
    assert eager == replay
    assert sum(n for k, n in eager.items() if "resize_kernel" in k) == 7
    assert sum(n for k, n in eager.items() if "blur7_u8_kernel" in k) == 8


@pytest.mark.cuda
def test_replays_outlive_the_table_caches(dev):
    """A key replays between eager calls of ten other shapes, more than a
    bounded cache of the core's device tables would hold: every replay,
    which reads those tables by address, equals the eager call."""
    ef = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                           device="cuda")
    a = make_test_image(240, 320, seed=12)
    want = G.run_eager(torch.from_numpy(a), ef._cfg, device=dev)
    ef.detect_and_compute_async(a)
    ef.detect_and_compute_async(a)
    for k in range(10):
        other = make_test_image(248 + 8 * k, 328 + 8 * k, seed=20 + k)
        ef.detect_and_compute_async(other)
        same(as_pair(*ef.detect_and_compute_async(a)), want)
    assert counters() == (11, 1, 10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_a_mesh_call_never_captures(dev):
    """Mesh calls on a 1-rank group run eagerly every time, and equal the
    call without a mesh."""
    import torch.distributed as dist
    from efficient_features_tpu_torch.parallel import sharding as SH
    img = make_test_image(240, 320, seed=8)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    want = G.run_eager(torch.from_numpy(img), ef._cfg, device=dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = SH.make_mesh()
        for _ in range(3):
            same(as_pair(*ef.detect_and_compute_async(img, mesh=mesh)), want)
    finally:
        dist.destroy_process_group()
    assert counters() == (3, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [1, 4])
def test_replays_on_threads_stay_in_order(dev, keys):
    """Six threads, each on a stream of its own, call `keys` shapes over
    two frames each; every result equals the eager call of its frame.  One
    key is seen twice first, so its threads only replay; four keys start
    in the threads, whose first calls, captures and replays of different
    keys run beside each other."""
    imgs = [[make_test_image(240 + 16 * k, 320, seed=9 + 2 * k + f)
             for f in (0, 1)] for k in range(keys)]
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    want = [[G.run_eager(torch.from_numpy(img), ef._cfg, device=dev)
             for img in pair] for pair in imgs]
    want_host = [[eager_host(img, ef._cfg, True, dev) for img in pair]
                 for pair in imgs]
    G.CACHE.clear()                     # eager_host's reads are no call's
    if keys == 1:
        ef.detect_and_compute_async(imgs[0][0])
        ef.detect_and_compute_async(imgs[0][1])
    errors = []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for n in range(8):
                    k, f = t % keys, (t + n) % 2
                    got = as_pair(*ef.detect_and_compute_async(imgs[k][f]))
                    torch.cuda.current_stream(dev).synchronize()
                    same(got, want[k][f])
                    same_host(on_host(*ef.detect_and_compute(imgs[k][f])),
                              want_host[k][f])
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    calls = 96 + (2 if keys == 1 else 0)
    assert counters() == (keys, keys, calls - 2 * keys)
    assert G.CACHE.packed_fetches + G.CACHE.field_fetches == 48


@pytest.mark.cuda
def test_a_replay_opens_the_replay_span(dev, tmp_path):
    """Under a replay the pipeline's spans do not open: `pipeline.replay`
    does, inside the entry's, around the upload (host ranges; the trace
    also copies ranges that hold device work onto the device's line)."""
    img = make_test_image(240, 320, seed=11)
    ef = EfficientFeatures(nfeatures=1000, descriptor_type="bad_256",
                           device="cuda")
    ef.detect_and_compute_async(img)
    ef.detect_and_compute_async(img)
    with profiler.trace(str(tmp_path)):
        ef.detect_and_compute_async(img)
    trace, = tmp_path.glob("trace-*.json")
    spans = [(e["name"].removeprefix(profiler.PREFIX), float(e["ts"]),
              float(e["ts"]) + float(e["dur"]))
             for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(profiler.PREFIX)]
    assert sorted(n for n, _, _ in spans) == [
        "api.detect_and_compute_async", "api.upload", "pipeline.replay"]
    at = {n: (a, b) for n, a, b in spans}
    for inner, outer in (("api.upload", "pipeline.replay"),
                         ("pipeline.replay", "api.detect_and_compute_async")):
        assert at[outer][0] <= at[inner][0] <= at[inner][1] <= at[outer][1]
    assert counters() == (1, 1, 1)


# (entry, with descriptors): the synchronous entries and `detect`, whose
# `as_arrays()` fetches
SYNC = [("detect_and_compute", True), ("detect", False),
        ("detect_and_compute_batch", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,with_desc", SYNC, ids=[e for e, _ in SYNC])
def test_sync_entries_fetch_one_block(dev, entry, with_desc):
    """Over three distinct 4K frames: a key's first, eager call fetches
    field by field, every later call its packed block in one copy, and
    every call's host arrays and descriptors equal the eager route's bit
    for bit.  The batch: one packed fetch a call, frame 0 of the first
    eager."""
    imgs, _ = frames("4k")
    ef = EfficientFeatures(nfeatures=40000, descriptor_type="bad_256",
                           device="cuda")
    want = [eager_host(img, ef._cfg, with_desc, dev) for img in imgs]
    G.CACHE.clear()                     # eager_host's reads are no call's
    if entry == "detect_and_compute_batch":
        for n in range(2):
            got = ef.detect_and_compute_batch(np.stack(imgs), as_host=True)
            for (kps, d), w in zip(got, want):
                same_host(on_host(kps, d), w)
            assert fetches() == (n + 1, 0)
        assert counters() == (1, 1, 4)
        return
    for n, i in enumerate((0, 1, 2, 0, 1)):
        if entry == "detect":
            kps, d = ef.detect(imgs[i]), None
            assert fetches() == (max(n - 1, 0), min(n, 1))  # none yet
        else:
            kps, d = ef.detect_and_compute(imgs[i])
        got = on_host(kps, d)
        assert fetches() == (n, 1)
        same_host(got, want[i])
        assert (kps._packed is None) == (n == 0)
    assert counters() == (1, 1, 3)


@pytest.mark.cuda
def test_a_replayed_fetch_waits_once(dev):
    """A replayed `detect_and_compute` + `as_arrays` of an image on the
    card syncs the host once (a host image adds its blocking upload), and
    after the warm-up its pinned buffers come from torch's caching host
    allocator: no `cudaHostAlloc` in a trace of three more calls."""
    from efficient_features_tpu_torch.tools.oncard import host_syncs
    imgs, _ = frames("4k")
    ef = EfficientFeatures(nfeatures=40000, descriptor_type="bad_256",
                           device="cuda")

    def call(img):
        kps, _ = ef.detect_and_compute(img)
        kps.as_arrays()

    for img in imgs:
        call(img)
    on_card = torch.from_numpy(imgs[0]).to(dev)
    assert len(host_syncs(lambda: call(on_card))) == 1
    assert len(host_syncs(lambda: call(imgs[0]))) == 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for img in imgs:
            call(img)
    names = {e.key for e in prof.key_averages()}
    assert any("cudaMemcpyAsync" in k for k in names), sorted(names)
    assert not any("cudaHostAlloc" in k or "cudaHostRegister" in k
                   for k in names), sorted(names)
