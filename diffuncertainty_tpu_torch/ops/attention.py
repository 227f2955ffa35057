"""QKV self-attention with the ADM "legacy" head split (port of
``diffuncertainty_tpu/ops/attention.py``).

The fused projection ``(B, T, 3C)`` is split head-major: head h's q, k and v
are contiguous at channels ``[3ch*h, 3ch*(h+1))`` (q first, then k, then v),
with ``ch = C / heads``. Scores are the f32 product scaled by ``ch**-0.5``
(the reference's ``ch**-0.25`` on each operand), softmax in f32.

Gate (as ``pallas_attention_usable`` on the TPU): bf16 on a CUDA device with
a token count and head width the kernel takes -> the hand-written kernel;
otherwise (fp32, the "exact" path) the plain twin.
"""

from __future__ import annotations

import torch

from .cuda_attention import kernel_supports, qkv_attention_cuda, qkv_attention_reference


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, T, 3C)`` fused projections -> ``(B, T, C)`` attention output."""
    b, t, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    if qkv.dtype == torch.bfloat16 and kernel_supports(t, ch):
        return qkv_attention_cuda(qkv, num_heads)
    return qkv_attention_reference(qkv, num_heads)
