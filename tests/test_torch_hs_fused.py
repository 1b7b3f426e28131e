"""The port's fused HashSIFT route (plain version of the kernel K11) against
the JAX package's fused kernel, and the `hs_fused=True` slice against the JAX
pipeline.

`WK.hs_desc_windows` of the JAX package runs in Pallas interpret mode, as
`tests/test_kernels.py` runs it on the CPU.  Tolerances, the JAX package's
own for this kernel (`test_hs_fused_kernel_desc_parity`,
`test_hs_fused_end_to_end_budget`):
  - fused rows: |diff| <= 1 on fewer than 2e-3 of the entries (the TPU body
    has a polynomial atan2 and Newton reciprocals; f32 summation order);
  - packed descriptors: at most int(1e-4 * bytes) + 1 differing bytes;
  - keypoint slots of the slice: bit-identical; angles within 1e-3 degrees.
On the CPU the fused route is the plain histogram of the plain warp, so it
gives the bytes of the two-stage route exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_features_tpu import pipeline as JP
from efficient_features_tpu.ops import window_kernels as JWK
from efficient_features_tpu_torch import EfficientFeatures as TEF
from efficient_features_tpu_torch import HashSIFT as THashSIFT
from efficient_features_tpu_torch import pipeline as TP
from efficient_features_tpu_torch.ops import window_kernels as WK

from util import make_keypoints, make_test_image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small inputs gain nothing from intra-op threads, and in a
    parallel test run the threads of each worker contend with the others'
    (measured 13x slower beside one other torch test process)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


N = 24
EXACT = ("x", "y", "octave", "size", "response", "valid", "count")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _budget(n_bytes: int) -> int:
    return int(1e-4 * n_bytes) + 1


def _scene_case():
    """The scene of `test_hs_fused_kernel_desc_parity`: 24 rotated keypoints,
    three of them 2 px from an image edge, one slot invalid."""
    img = make_test_image(200, 280, seed=33)
    h, w = img.shape
    x, y, size, angle = make_keypoints(h, w, N, seed=8)
    x[:3] = [2, w - 3, w / 2]
    y[:3] = [h / 2, 2, h - 3]
    valid = np.ones(N, bool)
    valid[7] = False
    return img, (x, y, size, angle, valid)


def _edge_case():
    """The saturated 0/255 edge image of
    `test_warp_window_kernel_saturated_edges`: gradients of +-255."""
    img = np.zeros((160, 256), np.uint8)
    img[:, 128:] = 255
    img[40:80, 40:80] = 255
    img[100:140, 160:200] = 0
    rng = np.random.default_rng(11)
    x = (rng.uniform(34, 222, N) + 0.31).astype(np.float32)
    y = (rng.uniform(34, 126, N) + 0.47).astype(np.float32)
    return img, (x, y, np.full(N, 31.0, np.float32),
                 np.full(N, -1.0, np.float32), np.ones(N, bool))


@pytest.fixture(scope="module", params=["scene", "edges"])
def case(request):
    """(image, keypoints, the JAX fused kernel's rows, the port's rows)."""
    img, kp = _scene_case() if request.param == "scene" else _edge_case()
    want = np.asarray(JWK.hs_desc_windows(
        *(jnp.asarray(a) for a in (img, *kp)), 1.0))
    got = WK.hs_desc_windows(_t(img), *(_t(a) for a in kp), 1.0)
    return img, kp, want, got


def test_fused_rows_match_the_pallas_kernel(case):
    img, kp, want, got = case
    assert got.dtype == torch.uint8 and tuple(got.shape) == (N, 128)
    valid = kp[4]
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))[valid]
    assert d.max() <= 1
    assert (d != 0).mean() < 2e-3
    assert (got.numpy()[~valid] == 0).all()
    assert (got.numpy()[valid] != 0).any()


@pytest.mark.parametrize("nbits", [256, 512])
def test_fused_descriptors_match_jax(case, nbits):
    img, kp, want, got = case
    valid = kp[4]
    a = np.asarray(JP._hs_from_fused(jnp.asarray(want), jnp.asarray(valid),
                                     nbits))
    b = TP._hs_from_fused(got, _t(valid), nbits).numpy()
    assert a.shape == b.shape == (N, nbits // 8)
    assert (a != b).sum() <= _budget(a.size)
    assert (b[~valid] == 0).all()
    # the pipeline's dispatch with the fused route on gives these bytes
    via = TP._compute_descriptors(_t(img), *(_t(k) for k in kp), "hash_sift",
                                  nbits, 1.0, hs_fused=True)
    assert torch.equal(via, _t(b))


def test_fused_wrapper_runs_the_plain_version_on_cpu(case):
    """On a CPU tensor: the plain histogram of the plain warp, no launch
    counted, the bytes of the two-stage route."""
    img, kp, _, got = case
    args = [_t(img), *(_t(a) for a in kp)]
    before = WK.hs_desc_windows.launches
    again = WK.hs_desc_windows(*args, 1.0)
    assert WK.hs_desc_windows.launches == before
    assert torch.equal(again, got)
    assert torch.equal(got, WK.hs_desc_windows_ref(*args, 1.0))
    assert torch.equal(got, WK.hs_hist_from_patches(
        WK.warp_patches_windows(*args, 1.0)))
    empty = WK.hs_desc_windows(_t(img), *(_t(a[:0]) for a in kp), 1.0)
    assert tuple(empty.shape) == (0, 128)


@pytest.mark.parametrize("size,scale", [(64.0, 1.0), (300.0, 1.0),
                                        (48.0, 1.5)])
def test_fused_takes_every_keypoint_size(size, scale):
    """One route for every size and cropping scale (the JAX package's fused
    kernel stops at `_S_BASE`): equal to the two-stage route."""
    img, kp = _scene_case()
    kp = (kp[0], kp[1], np.full(N, size, np.float32), kp[3], kp[4])
    args = [_t(img), *(_t(a) for a in kp)]
    fused = TP._compute_descriptors(*args, "hash_sift", 256, scale,
                                    hs_fused=True)
    staged = TP._compute_descriptors(*args, "hash_sift", 256, scale)
    assert torch.equal(fused, staged) and bool((fused != 0).any())


@pytest.fixture(scope="module")
def scene():
    return make_test_image(200, 280, seed=7)


@pytest.mark.parametrize("descriptor_type,nlevels,hw", [
    ("hash_sift_256", 8, (200, 280)), ("hash_sift_512", 4, (120, 168))])
def test_fused_slice_matches_two_stage_and_jax(descriptor_type, nlevels, hw):
    """dAC with hs_fused=True: bytes of the two-stage route on the CPU,
    slots bit-identical to the JAX pipeline, descriptors within budget."""
    scene = make_test_image(*hw, seed=7)
    kw = dict(nfeatures=500, nlevels=nlevels,
              descriptor_type=descriptor_type, device="cpu")
    fused = TEF(hs_fused=True, **kw)
    assert fused._cfg.hs_fused and not TEF(**kw)._cfg.hs_fused
    kf, df = fused.detect_and_compute_async(scene)
    ks, ds = TEF(**kw).detect_and_compute_async(scene)
    assert torch.equal(df, ds)
    for k in kf._slots:
        assert torch.equal(kf._slots[k], ks._slots[k]), k
    cfg = JP.FeatureConfig(nfeatures=500, nlevels=nlevels,
                           descriptor_type=descriptor_type)
    want_slots, want_desc = JP.detect_and_compute_jit(jnp.asarray(scene), cfg)
    for k in EXACT:
        np.testing.assert_array_equal(kf._slots[k].numpy(),
                                      np.asarray(want_slots[k]), err_msg=k)
    d = np.abs(kf._slots["angle"].numpy() - np.asarray(want_slots["angle"]))
    assert np.minimum(d, 360 - d).max() < 1e-3
    want_desc = np.asarray(want_desc)
    assert int(kf._slots["count"]) > 30
    assert (df.numpy() != want_desc).sum() <= _budget(want_desc.size)


def test_fused_keyword_reaches_compute(scene):
    """`HashSIFT(fused=True)` and `EfficientFeatures(hs_fused=True).compute`
    go through `hs_desc_windows`, and give the two-stage bytes."""
    kp = np.stack([np.linspace(5, 270, 40), np.linspace(5, 190, 40),
                   np.linspace(31, 120, 40), np.linspace(-1, 359, 40)],
                  axis=1).astype(np.float32)
    want = THashSIFT(1.0, 256, device="cpu").compute(scene, kp)
    calls = []
    real = WK.hs_desc_windows

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WK, "hs_desc_windows", spy)
        a = THashSIFT(1.0, 256, device="cpu", fused=True).compute(scene, kp)
        b = TEF(descriptor_type="hash_sift_256", device="cpu",
                hs_fused=True).compute(scene, kp)
        THashSIFT(1.0, 256, device="cpu").compute(scene, kp)
    assert calls == [40, 40]
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(b, want)
    assert THashSIFT.create(1.0, 512, 0.0, "cpu", True)._fused
