"""GroupNorm with float32 statistics (port of ``diffuncertainty_tpu/ops/norm.py``).

32 groups when the channel count is divisible by 32, else one group per
channel. Statistics in float32 with var = E[x^2] - mean^2 (clamped at 0),
the affine folded into ``x * a + b``, the result cast back to the input
dtype. Layout is channels-last: ``(B, ..., C)``.
"""

from __future__ import annotations

import torch


def num_groups_for(num_channels: int) -> int:
    return 32 if num_channels % 32 == 0 else num_channels


def group_norm_32(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of ``(B, ..., C)``; affine (C,)."""
    c = x.shape[-1]
    groups = num_groups_for(c) if num_groups is None else num_groups
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    batch = x.shape[0]
    cpg = c // groups
    xf = x.float()
    spatial = tuple(range(1, x.ndim - 1))
    n = float(xf[0].numel() // c * cpg)
    ch_sum = xf.sum(dim=spatial)  # (B, C)
    ch_sumsq = (xf * xf).sum(dim=spatial)
    g_mean = ch_sum.view(batch, groups, cpg).sum(-1) / n  # (B, G)
    g_var = torch.clamp(ch_sumsq.view(batch, groups, cpg).sum(-1) / n - g_mean * g_mean, min=0.0)
    inv = torch.rsqrt(g_var + eps).repeat_interleave(cpg, dim=-1)  # (B, C)
    a = inv * scale.float()
    b = bias.float() - g_mean.repeat_interleave(cpg, dim=-1) * a
    bshape = (batch,) + (1,) * len(spatial) + (c,)
    return (xf * a.view(bshape) + b.view(bshape)).to(x.dtype)
