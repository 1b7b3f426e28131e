"""PyTorch + CUDA port of efficient_features_tpu.

Multi-scale FAST + Harris detection, IC-angle orientation, and BAD and
HashSIFT descriptors (`detect_and_compute` and standalone `compute()`),
Hamming matching (`ops.matcher`) and batched RANSAC (`ops.ransac`), with
hand-written Hopper kernels for the detect cells, the IC moments, BAD, the
HashSIFT patch warp, the HashSIFT histogram and the best-2 Hamming search
(csrc/).  The JAX package
`efficient_features_tpu` is the reference this port is tested against; this
package imports neither it nor jax.
"""
from .api import BAD, EfficientFeatures, HashSIFT, KeyPoints
from .pipeline import DESCRIPTOR_TYPES, FeatureConfig

__all__ = ["BAD", "EfficientFeatures", "FeatureConfig", "HashSIFT",
           "KeyPoints", "DESCRIPTOR_TYPES"]
