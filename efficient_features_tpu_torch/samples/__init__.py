"""Command-line samples of the port (counterparts of `samples/`).

    python -m efficient_features_tpu_torch.samples.sample_feature_extraction
    python -m efficient_features_tpu_torch.samples.sample_feature_matching
    python -m efficient_features_tpu_torch.samples.sample_image_sequence
    python -m efficient_features_tpu_torch.samples.sample_benchmark
    python -m efficient_features_tpu_torch.samples.hpatches_description
"""
