"""The port's matcher (plain version, the CPU route) against the JAX matcher.

The same descriptors, made with numpy from a seed, go through both.  The
port follows the JAX dense path's sentinel (a pair with an invalid side is
at distance 1 << 30), so against the dense path (`fused=False`) every
output is equal on every row.  Against the JAX streaming path
(`_fused_topk2` in Pallas interpret mode, as `tests/test_matcher.py` runs
it) `ok` is equal, and `(j, best)` where `ok` holds.  No tolerance:
Hamming distances are integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu.ops import matcher as JM
from efficient_features_tpu_torch.ops import matcher as TM

BIG = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small inputs gain nothing from intra-op threads, and in a
    parallel test run the threads of each worker contend with the others'
    (measured 13x slower beside one other torch test process)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def descriptors(kind, nbytes, n1, n2, seed):
    """(d1, d2) uint8: uniform random bits, every other query row a copy of
    a train row with one byte changed (so the ratio test keeps some); or
    rows drawn from a pool of 6 descriptors (ties everywhere) with an exact
    duplicate across the JAX kernel's 512-row train tiles."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        d1 = rng.integers(0, 256, (n1, nbytes), dtype=np.uint8)
        d2 = rng.integers(0, 256, (n2, nbytes), dtype=np.uint8)
        d1[::2] = d2[rng.integers(0, n2, len(d1[::2]))]
        d1[::2, 0] ^= 0x0F
        return d1, d2
    pool = rng.integers(0, 256, (6, nbytes), dtype=np.uint8)
    d1 = pool[rng.integers(0, 6, n1)]
    d2 = pool[rng.integers(0, 6, n2)]
    if n2 > 600:
        d2[n2 - 100] = d2[100]
    return d1, d2


def masks(n1, n2, seed):
    """(valid1, valid2) bool, about 20% invalid on each side."""
    rng = np.random.default_rng(seed + 1)
    return rng.random(n1) > 0.2, rng.random(n2) > 0.2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, jax_out):
    for p, j in zip(port, jax_out):
        j = np.asarray(j)
        assert p.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool}[j.dtype]
        np.testing.assert_array_equal(p.numpy(), j)


CASES = [(kind, nbytes) for kind in ("random", "ties") for nbytes in (32, 64)]


@pytest.mark.parametrize("kind,nbytes", CASES)
def test_hamming_matrix_equals_jax(kind, nbytes):
    d1, d2 = descriptors(kind, nbytes, 37, 53, seed=nbytes)
    got = TM.hamming_matrix(_t(d1), _t(d2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JM.hamming_matrix(jnp.asarray(d1),
                                                  jnp.asarray(d2))))


@pytest.mark.parametrize("kind,nbytes", CASES)
@pytest.mark.parametrize("fn", ["match", "match_no_cross", "knn2",
                                "knn2_masked"])
def test_public_functions_equal_jax_dense(fn, kind, nbytes):
    d1, d2 = descriptors(kind, nbytes, 150, 230, seed=3 * nbytes)
    v1, v2 = masks(150, 230, seed=nbytes)
    v1[:4] = False                         # invalid query rows
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    t1, t2 = _t(d1), _t(d2)
    if fn == "match":
        port = TM.match(t1, t2, True)
        ref = JM.match(j1, j2, True, fused=False)
    elif fn == "match_no_cross":
        port = TM.match(t1, t2, False)
        ref = JM.match(j1, j2, False, fused=False)
    elif fn == "knn2":
        port = TM.knn2_ratio_match(t1, t2, 0.8)
        ref = JM.knn2_ratio_match(j1, j2, 0.8, fused=False)
    else:
        port = TM.knn2_ratio_match_masked(t1, _t(v1), t2, _t(v2), 0.8)
        ref = JM.knn2_ratio_match_masked(j1, jnp.asarray(v1), j2,
                                         jnp.asarray(v2), 0.8, fused=False)
    _eq(port, ref)
    if fn.startswith("knn2") and kind == "random":
        assert bool(port[2].any())


@pytest.mark.parametrize("nbytes", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_equals_jax_fused_where_ok(nbytes, masked):
    """Multi-tile: 513 queries, 1100 train rows (three 512-row JAX train
    tiles), heavy ties, a duplicate across train tiles."""
    d1, d2 = descriptors("ties", nbytes, 513, 1100, seed=9)
    v1, v2 = masks(513, 1100, seed=9)
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    if masked:
        ref = JM.knn2_ratio_match_masked_fused(j1, jnp.asarray(v1), j2,
                                               jnp.asarray(v2), 0.8)
        port = TM.knn2_ratio_match_masked(_t(d1), _t(v1), _t(d2), _t(v2),
                                          0.8)
    else:
        ref = JM.knn2_ratio_match_fused(j1, j2, 0.8)
        port = TM.knn2_ratio_match(_t(d1), _t(d2), 0.8)
    ok = np.asarray(ref[2])
    np.testing.assert_array_equal(port[2].numpy(), ok)
    assert ok.any()
    for p, r in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(p.numpy()[ok], np.asarray(r)[ok])


@pytest.mark.parametrize("nbytes", [32, 64])
def test_topk2_ref_equals_fused_topk2(nbytes):
    """(idx, best, second) of the plain version against the JAX kernel's
    (idx, hamming(best dot), hamming(second dot)), unmasked, multi-tile,
    duplicate across train tiles."""
    d1, d2 = descriptors("ties", nbytes, 513, 1700, seed=7)
    nbits = 8 * nbytes
    j, bd, sd = map(np.asarray, JM._fused_topk2(jnp.asarray(d1),
                                                jnp.asarray(d2), None))
    idx, best, second = TM.knn2_topk2_ref(_t(d1), None, _t(d2), None)
    np.testing.assert_array_equal(idx.numpy(), j)
    np.testing.assert_array_equal(best.numpy(),
                                  ((nbits - bd) / 2).astype(np.int32))
    np.testing.assert_array_equal(second.numpy(),
                                  ((nbits - sd) / 2).astype(np.int32))
    # the wrapper takes the plain route for CPU tensors
    for a, b in zip(TM.knn2_topk2(_t(d1), None, _t(d2), None),
                    (idx, best, second)):
        assert torch.equal(a, b)


def test_row_with_no_valid_pair():
    """An invalid query row, and a valid query row facing only invalid train
    rows, both give j = 0 and best = 1 << 30 (the dense sentinel)."""
    d1, d2 = descriptors("random", 32, 6, 9, seed=4)
    v1 = np.array([True, False, True, True, True, True])
    idx, best, second = TM.knn2_topk2_ref(_t(d1), _t(v1), _t(d2),
                                          _t(np.zeros(9, bool)))
    assert idx.tolist() == [0] * 6 and best.tolist() == [BIG] * 6
    assert second.tolist() == [BIG] * 6
    v2 = np.ones(9, bool)
    j, best, ok = TM.knn2_ratio_match_masked(_t(d1), _t(v1), _t(d2),
                                             _t(v2))
    assert int(j[1]) == 0 and int(best[1]) == BIG and not bool(ok[1])
    ref = JM.knn2_ratio_match_masked(jnp.asarray(d1), jnp.asarray(v1),
                                     jnp.asarray(d2), jnp.asarray(v2),
                                     fused=False)
    _eq((j, best, ok), ref)


def test_edge_cases():
    d1, d2 = descriptors("random", 32, 5, 1, seed=5)
    with pytest.raises(ValueError, match="at least 2 train"):
        TM.knn2_ratio_match(_t(d1), _t(d2))
    with pytest.raises(ValueError, match="at least 2 train"):
        TM.knn2_ratio_match_masked(_t(d1), _t(np.ones(5, bool)), _t(d2),
                                   _t(np.ones(1, bool)))
    j, dist, valid = TM.match(_t(d1), _t(d2))    # one train row is enough
    assert j.tolist() == [0] * 5 and bool(valid[0])
    empty = torch.zeros((0, 32), dtype=torch.uint8)
    for out in (TM.match(empty, _t(d1)), TM.knn2_ratio_match(empty, _t(d1)),
                TM.knn2_ratio_match_masked(empty, torch.zeros(0, dtype=bool),
                                           _t(d1), torch.ones(5, dtype=bool))):
        assert [t.shape for t in out] == [(0,)] * 3
        assert [t.dtype for t in out] == [torch.int32, torch.int32,
                                          torch.bool]
    with pytest.raises(ValueError, match="widths differ"):
        TM.match(_t(d1), torch.zeros((3, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        TM.match(_t(d1).to(torch.int32), _t(d1))


# -- K6's split, packed-key and merge rules, in plain torch ------------------


@pytest.mark.parametrize("nbytes", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind,n2,split", [
    ("ties", 300, 128),      # ties and duplicates across three splits
    ("ties", 257, 128),      # n2 one past a split: a split of one row
    ("ties", 255, 128),      # one short of it
    ("random", 256, 128),    # exactly two splits
    ("random", 1, 128),      # one train row: second is INT32_MAX
    ("random", 700, 256)])
def test_split_merge_rule_equals_plain(kind, n2, split, masked, nbytes):
    """`knn2_split_merge_ref`, the kernel's rules, against the plain version:
    (idx, best, second) equal on every row, rows with no valid pair and an
    invalid query included."""
    d1, d2 = descriptors(kind, nbytes, 90, n2, seed=n2 + nbytes)
    if kind == "ties" and n2 > 140:
        d2[n2 - 1] = d2[3]               # a duplicate in the first and last
    v1, v2 = masks(90, n2, seed=n2) if masked else (None, None)
    args = (_t(d1), None if v1 is None else _t(v1),
            _t(d2), None if v2 is None else _t(v2))
    want = TM.knn2_topk2_ref(*args)
    got = TM.knn2_split_merge_ref(*args, split)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    if masked:                           # no valid train row at all
        dead = (args[0], args[1], args[2], torch.zeros(n2, dtype=torch.bool))
        got = TM.knn2_split_merge_ref(*dead, split)
        for g, w in zip(got, TM.knn2_topk2_ref(*dead)):
            assert torch.equal(g, w)
        assert got[0].tolist() == [0] * 90 and got[1].tolist() == [BIG] * 90


@pytest.mark.parametrize("nbytes", [32, 64])
@pytest.mark.parametrize("fn", ["match", "knn2", "knn2_masked"])
def test_split_merge_rule_equals_jax_dense(fn, nbytes, monkeypatch):
    """The public functions over the kernel's rules (a 128-row split, so
    1100 train rows make nine splits) against the JAX dense path."""
    d1, d2 = descriptors("ties", nbytes, 200, 1100, seed=5 * nbytes)
    v1, v2 = masks(200, 1100, seed=nbytes)
    v1[:3] = False
    monkeypatch.setattr(
        TM, "knn2_topk2",
        lambda q, vq, t, vt: TM.knn2_split_merge_ref(q, vq, t, vt, 128))
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    if fn == "match":
        port = TM.match(_t(d1), _t(d2), True)
        ref = JM.match(j1, j2, True, fused=False)
    elif fn == "knn2":
        port = TM.knn2_ratio_match(_t(d1), _t(d2), 0.8)
        ref = JM.knn2_ratio_match(j1, j2, 0.8, fused=False)
    else:
        port = TM.knn2_ratio_match_masked(_t(d1), _t(v1), _t(d2), _t(v2), 0.8)
        ref = JM.knn2_ratio_match_masked(j1, jnp.asarray(v1), j2,
                                         jnp.asarray(v2), 0.8, fused=False)
    _eq(port, ref)


@pytest.mark.parametrize("n1,n2", [(40000, 40000), (1000, 40000),
                                   (3000, 3000), (64, 64), (5, 1),
                                   (10, 200000), (40000, 39999)])
def test_knn2_plan(n1, n2):
    """The split is whole tiles, fits the key's 16-bit column field, covers
    the train axis, and the scratch holds what the kernels write."""
    split, scratch = TM.knn2_plan(n1, n2)
    tile = TM.KERNEL_TILE
    assert split % tile == 0 and tile <= split <= TM.KERNEL_MAX_SPLIT
    splits = -(-n2 // split)
    assert (splits - 1) * split < n2 <= splits * split
    assert scratch == (-(-n2 // tile) * tile + -(-n1 // 4) * 4
                       + 3 * splits * n1)
    blocks = -(-n1 // tile) * splits
    if n1 * n2 >= 1000 * 40000:          # a large call fills the card
        assert blocks >= 4 * 132
