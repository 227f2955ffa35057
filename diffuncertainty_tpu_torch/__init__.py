"""PyTorch/CUDA port of ``diffuncertainty_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference. This package keeps its module names and
its public layouts (NHWC images and probabilities, ``(B, T, 3C)`` fused qkv),
imports ``torch``, numpy and scipy only, and runs its entry points on
``cuda`` unless the caller passes ``device="cpu"``.

Slices ported so far: the unet16 MC-dropout + TTA softmax uncertainty path
(config, weights, DiffUnet forward, TTA warps, sampler, heatmaps, per-image
metrics and the toy-128 quality eval), the unet16 diffusion, SSN and
prob-U-Net paths, stacked members (SWAG, ensembles, sub-ensembles), the
HRNet backbone and the multiclass full-frame sliding-window family, the
inference job (``python -m diffuncertainty_tpu_torch.infer``), the
trainer of every family (``python -m diffuncertainty_tpu_torch.train``) and
the evaluation stack (``evaln``: the downstream tasks over the job's results
tree, ``python -m diffuncertainty_tpu_torch.evaln.experiments``).
Both TPU kernels of the JAX package run as hand-written CUDA kernels: the
fused-qkv attention and the GroupNorm+activation, each differentiable
through an autograd Function whose backward is its plain twin's VJP.
"""
