"""Batched pipelines; the place of the multi-GPU ones.

Counterpart of `efficient_features_tpu/parallel/sharding.py`.  Ported so far:
the batch of images on ONE device (`detect_and_compute_batch`).  The JAX
package shards the batch axis over a device mesh and, on each chip, maps the
single-image pipeline over its frames one after the other (`lax.map`: one
detect already fills a chip).  On one GPU that is a loop over the frames on
the current stream.  The mesh forms (`compute_sharded`,
`detect_pyramid_rows_sharded`, `detect_and_compute_batch_2d`,
`knn2_match_sharded`) are not ported yet.
"""
from __future__ import annotations

import torch

from .. import pipeline as P


def detect_and_compute_batch(images: torch.Tensor, cfg: P.FeatureConfig):
    """Batched detect+compute on the images' device.

    images: (B, H, W) uint8, B >= 1.  Returns the slot dict with a leading
    batch axis, (B, nslots) per field and (B,) for `count`, and descriptors
    (B, nslots, bytes).  Frame i holds exactly what `P.detect_and_compute`
    gives for images[i]."""
    if images.dim() != 3 or images.dtype != torch.uint8 or \
            images.shape[0] < 1:
        raise ValueError("images must be (B, H, W) uint8 with B >= 1")
    frames = [P.detect_and_compute(img, cfg) for img in images.unbind(0)]
    slots = {k: torch.stack([s[k] for s, _ in frames]) for k in frames[0][0]}
    return slots, torch.stack([d for _, d in frames])
