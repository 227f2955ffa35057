"""Tensor ops of the slice: norm, attention (with its CUDA kernel),
resampling, warps and the entropy decomposition."""
