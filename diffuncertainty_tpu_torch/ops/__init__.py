"""Tensor ops of the ported slices: norm (with its GroupNorm+activation
CUDA kernel), attention (with its CUDA kernel), time embedding, resampling,
warps and the entropy decomposition."""
