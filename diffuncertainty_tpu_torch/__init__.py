"""PyTorch/CUDA port of ``diffuncertainty_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference. This package keeps its module names and
its public layouts (NHWC images and probabilities, ``(B, T, 3C)`` fused qkv),
imports ``torch``, numpy and scipy only, and runs its entry points on
``cuda`` unless the caller passes ``device="cpu"``.

Slice ported so far: the unet16 MC-dropout + TTA softmax uncertainty path
(config, weights, DiffUnet forward with the hand-written fused-qkv attention
kernel, TTA warps, sampler, heatmaps, per-image metrics and the toy-128
quality eval).
"""
