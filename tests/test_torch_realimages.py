"""The port on the five real fixtures of tests/data/ (tools/make_fixtures.py
has their provenance), against the JAX package and on the card.

On the CPU, `EfficientFeatures(device="cpu")`'s `detect` and
`detect_and_compute` against the JAX package's `detect_and_compute` of the
same configuration (2000 features, 4 levels): keypoint slots bit-identical
(angles within 1e-3 degrees: f32 atan2 ULPs), descriptors within the
reference's budgets, int(2e-5 * bytes) + 1 differing bytes for BAD and
int(1e-4 * bytes) + 1 for HashSIFT.  The descriptor type differs over the
scenes so that both
families meet real texture (the three 1280x1024 scenes at threshold 20
share one JAX compile); lowtex takes FAST threshold 2, as in
tests/test_realimages.py.  The `cuda` twin holds the card's slots and
descriptors to the CPU port's: slots equal, descriptors within the budget.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from efficient_features_tpu_torch import EfficientFeatures as TEF

DATA = os.path.join(os.path.dirname(__file__), "data")
SCENES = {"real_photo.png": "bad_256", "real_montage.png": "hash_sift_256",
          "real_hitex.png": "hash_sift_256", "real_lowtex.png": "bad_256",
          "real_saturated.png": "hash_sift_256"}
DETECT_TH = {"real_lowtex.png": 2}
EXACT = ("x", "y", "octave", "size", "response", "valid", "count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(name):
    return np.array(Image.open(os.path.join(DATA, name)))


def _kw(name):
    return dict(nfeatures=2000, nlevels=4,
                fast_threshold=DETECT_TH.get(name, 20),
                descriptor_type=SCENES[name])


def _budget(n_bytes: int, descriptor_type: str) -> int:
    share = 2e-5 if descriptor_type.startswith("bad") else 1e-4
    return int(share * n_bytes) + 1


def _angles_close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert np.minimum(d, 360 - d).max() < 1e-3


@pytest.mark.parametrize("name", list(SCENES))
def test_real_image_matches_jax(name):
    import jax.numpy as jnp
    from efficient_features_tpu import pipeline as JP
    img = _load(name)
    kw = _kw(name)
    feat = TEF(device="cpu", **kw)
    kps = feat.detect(img)
    kps2, desc = feat.detect_and_compute(img)
    js, jd = JP.detect_and_compute_jit(jnp.asarray(img),
                                       JP.FeatureConfig(**kw))
    assert kps.count > 50
    for k in EXACT:
        want = np.asarray(js[k])
        np.testing.assert_array_equal(kps._slots[k].numpy(), want, k)
        np.testing.assert_array_equal(kps2._slots[k].numpy(), want, k)
    _angles_close(kps._slots["angle"].numpy(), js["angle"])
    valid = np.asarray(js["valid"])
    want = np.asarray(jd)[valid]
    assert desc.shape == want.shape
    assert (desc != want).sum() <= _budget(want.size, kw["descriptor_type"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_real_image_on_the_card_matches_the_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img = _load(name)
    kw = _kw(name)
    gpu, gdesc = TEF(device="cuda", **kw).detect_and_compute(img)
    cpu, cdesc = TEF(device="cpu", **kw).detect_and_compute(img)
    for k in EXACT:
        np.testing.assert_array_equal(gpu._slots[k].cpu().numpy(),
                                      cpu._slots[k].numpy(), k)
    _angles_close(gpu._slots["angle"].cpu().numpy(),
                  cpu._slots["angle"].numpy())
    assert gdesc.shape == cdesc.shape
    assert (gdesc != cdesc).sum() <= _budget(cdesc.size,
                                             kw["descriptor_type"])
