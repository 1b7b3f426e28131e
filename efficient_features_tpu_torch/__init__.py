"""PyTorch + CUDA port of efficient_features_tpu.

Multi-scale FAST + Harris detection, IC-angle orientation, and BAD and
HashSIFT descriptors (`detect_and_compute`, its batch form and standalone
`compute()`), Hamming matching (`ops.matcher`) and batched RANSAC
(`ops.ransac`), with hand-written Hopper kernels for the pyramid's resize,
the detect stages, the IC moments, BAD, the HashSIFT patch warp and
histogram (two kernels, or one fused) and the best-2 Hamming search
(csrc/).  The JAX package
`efficient_features_tpu` is the reference this port is tested against; this
package imports neither it nor jax.
"""
from .api import BAD, EfficientFeatures, HashSIFT, KeyPoints
from .pipeline import DESCRIPTOR_TYPES, FeatureConfig

__all__ = ["BAD", "EfficientFeatures", "FeatureConfig", "HashSIFT",
           "KeyPoints", "DESCRIPTOR_TYPES"]
