"""QKV self-attention with the ADM "legacy" head split (port of
``diffuncertainty_tpu/ops/attention.py``).

The fused projection ``(B, T, 3C)`` is split head-major: head h's q, k and v
are contiguous at channels ``[3ch*h, 3ch*(h+1))`` (q first, then k, then v),
with ``ch = C / heads``. Scores are the f32 product scaled by ``ch**-0.5``
(the reference's ``ch**-0.25`` on each operand), softmax in f32.

Gate: bf16 -> the hand-written kernel, which takes every head width the
repo's networks use and any token count, and raises on a CUDA tensor of any
other width; fp32 (the "exact" path, which the JAX package keeps on XLA) ->
the plain twin. On the CPU the kernel's wrapper runs the twin.
"""

from __future__ import annotations

import torch

from .cuda_attention import qkv_attention_cuda, qkv_attention_reference


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, T, 3C)`` fused projections -> ``(B, T, C)`` attention output."""
    if qkv.dtype == torch.bfloat16:
        return qkv_attention_cuda(qkv, num_heads)
    return qkv_attention_reference(qkv, num_heads)
