"""Results on the host (`efficient_features_tpu_torch/api.py`) and the packed
block they travel in (`graphs.Layout`), on the CPU.

Compaction by runs of valid slots equals the boolean mask on every mask,
the joins of the core write into a block's views exactly what they return
on their own, and a `KeyPoints` read from a block gives the host arrays
of one read field by field.  The card's side (one pinned copy, one wait,
the counters) is in `tests/test_torch_graphs.py`.
"""
import numpy as np
import pytest
import torch

from efficient_features_tpu_torch import EfficientFeatures, KeyPoints
from efficient_features_tpu_torch import api as A
from efficient_features_tpu_torch import graphs as G
from efficient_features_tpu_torch import pipeline as P

from util import make_test_image


def _level_prefix(rng, n):
    """Valid slots first in each of 8 levels, as the selection places
    them; a level may hold none or be full."""
    valid = np.zeros(n, bool)
    cuts = np.linspace(0, n, 9).astype(int)
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        valid[a:a + (0 if i == 3 else (b - a if i == 5 else
                                       rng.integers(0, b - a + 1)))] = True
    return valid


MASKS = {
    "empty": lambda rng: np.zeros(0, bool),
    "none": lambda rng: np.zeros(300, bool),
    "all": lambda rng: np.ones(300, bool),
    "one": lambda rng: np.eye(1, 300, 299, dtype=bool)[0],
    "random": lambda rng: rng.random(4000) < 0.5,
    "sparse_runs": lambda rng: np.repeat(rng.random(40) < 0.5, 100),
    "level_prefix": lambda rng: _level_prefix(rng, 40000),
}


@pytest.mark.parametrize("rows", ["fields", "descriptors"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_compact_runs_equals_the_boolean_mask(mask, rows):
    """`compact_runs(valid)(v)` is `v[valid]` in values, slot order, shape
    and dtype: for each slot field's dtype, and for (N, bytes) rows."""
    rng = np.random.default_rng(7)
    valid = MASKS[mask](rng)
    n = len(valid)
    if rows == "fields":
        arrays = [rng.random(n, dtype=np.float32),
                  rng.integers(0, 8, n, dtype=np.int32), valid.copy()]
    else:
        arrays = [rng.integers(0, 256, (n, 32), dtype=np.uint8),
                  rng.integers(0, 256, (n, 64), dtype=np.uint8)]
    take = A.compact_runs(valid)
    for v in arrays:
        got, want = take(v), v[valid]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        assert not np.shares_memory(got, v)


CFG = P.FeatureConfig(nfeatures=500, descriptor_type="bad_256")


@pytest.mark.parametrize("with_descriptors", [True, False])
def test_the_joins_write_into_a_block(with_descriptors):
    """The core writing into a block's views equals the core on its own,
    field for field, dtype and shape; a batch's rows equal single
    frames."""
    imgs = [make_test_image(120, 160, seed=s) for s in (3, 4)]
    layout = G.Layout.of(CFG, imgs[0].shape, with_descriptors)
    assert layout.nbytes % 16 == 0
    assert all(a % 16 == 0 for _, _, a, _ in layout.parts())
    for img in imgs:
        t = torch.from_numpy(img)
        want = G.run_eager(t, CFG, with_descriptors=with_descriptors)
        block = layout.new("cpu")
        in_block = lambda v: (v.untyped_storage().data_ptr()  # noqa: E731
                              == block.untyped_storage().data_ptr())
        got = G.run_eager(t, CFG, with_descriptors=with_descriptors,
                          out=block)
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            assert got[0][k].dtype == want[0][k].dtype, k
            assert got[0][k].shape == want[0][k].shape, k
            assert torch.equal(got[0][k], want[0][k]), k
            assert in_block(got[0][k]), k
        assert (got[1] is None) == (not with_descriptors)
        if with_descriptors:
            assert torch.equal(got[1], want[1]) and in_block(got[1])
    if with_descriptors:
        from efficient_features_tpu_torch.parallel import sharding as SH
        batch, layout = SH.batch_block(torch.from_numpy(np.stack(imgs)),
                                       CFG)
        slots, descs = layout.unpack(batch)
        for i, img in enumerate(imgs):
            want = G.run_eager(torch.from_numpy(img), CFG)
            for k in want[0]:
                assert torch.equal(slots[k][i], want[0][k]), k
            assert torch.equal(descs[i], want[1])


def test_a_block_gives_the_host_arrays_of_the_fields():
    """`KeyPoints` over a packed block and over the same slots as separate
    tensors give the same host arrays, descriptors and compute() rows."""
    img = make_test_image(120, 160, seed=5)
    t = torch.from_numpy(img)
    layout = G.Layout.of(CFG, img.shape, True)
    block = layout.new("cpu")
    slots, descs = G.run_eager(t, CFG, out=block)
    packed = KeyPoints(slots, packed=(block, layout))
    fields = KeyPoints({k: v.clone() for k, v in slots.items()})
    hp, hf = packed._fetch(), fields._fetch(descs.clone())
    assert np.array_equal(hp.take(hp.descs), hf.take(hf.descs))
    a, b = packed.as_arrays(), fields.as_arrays()
    assert list(a) == list(b) == ["x", "y", "response", "angle", "octave",
                                  "size"]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert np.array_equal(packed.xysa(), fields.xysa())
    bad = A.BAD(1.0, 256, device="cpu")
    assert np.array_equal(bad.compute(img, packed), bad.compute(img, fields))


def test_sync_entries_on_the_cpu_read_field_by_field():
    """On the CPU a single image runs eagerly (no block) and the batch in
    blocks; both give the arrays and descriptors of the plain pipeline,
    and no fetch from a card is counted."""
    G.CACHE.clear()
    ef = EfficientFeatures(nfeatures=500, descriptor_type="bad_256",
                           device="cpu")
    imgs = [make_test_image(120, 160, seed=s) for s in (6, 7)]
    got = [ef.detect_and_compute(img) for img in imgs]
    assert all(kps._packed is None for kps, _ in got)
    got_batch = ef.detect_and_compute_batch(np.stack(imgs), as_host=True)
    for img, one, batched in zip(imgs, got, got_batch):
        slots, descs = P.detect_and_compute(torch.from_numpy(img), ef._cfg)
        valid = slots["valid"].numpy()
        for kps, d in (one, batched):
            assert np.array_equal(d, descs.numpy()[valid])
            arrays = kps.as_arrays()
            for k, v in arrays.items():
                assert np.array_equal(v, slots[k].numpy()[valid]), k
    assert (G.CACHE.packed_fetches, G.CACHE.field_fetches) == (0, 0)
