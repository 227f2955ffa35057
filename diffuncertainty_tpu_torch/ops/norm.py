"""GroupNorm with float32 statistics (port of ``diffuncertainty_tpu/ops/norm.py``;
float64 inputs keep float64).

32 groups when the channel count is divisible by 32, else one group per
channel. Statistics in float32 with var = E[x^2] - mean^2 (clamped at 0),
the affine folded into ``x * a + b``, the result cast back to the input
dtype. Layout is channels-last: ``(B, ..., C)``.

The affine is ``(C,)``, or ``(M, C)`` for member-folded rows
(``ops/member_fold.py``): the B rows are M member-major blocks of B / M rows
and row ``r`` takes member ``r // (B / M)``'s affine.
"""

from __future__ import annotations

import torch


def num_groups_for(num_channels: int) -> int:
    return 32 if num_channels % 32 == 0 else num_channels


def member_rows(affine: torch.Tensor, rows: int) -> torch.Tensor:
    """A ``(C,)`` affine as it is, an ``(M, C)`` one repeated to ``(rows, C)``
    over M member-major blocks; ``rows`` not a multiple of M raises (a silent
    repeat would give one member's affine to another's rows)."""
    if affine.ndim == 1:
        return affine
    m = affine.shape[0]
    if rows % m:
        raise ValueError(f"folded rows ({rows}) not divisible by the member count ({m}): "
                         f"a member's affine would reach another member's rows")
    return affine.repeat_interleave(rows // m, dim=0)


def group_norm_32(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of ``(B, ..., C)``; affine
    ``(C,)`` or ``(M, C)``."""
    return group_norm_f32(x, scale, bias, num_groups=num_groups, eps=eps).to(x.dtype)


def group_norm_f32(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """:func:`group_norm_32` before the cast back: the float32 result."""
    c = x.shape[-1]
    groups = num_groups_for(c) if num_groups is None else num_groups
    batch = x.shape[0]
    cpg = c // groups
    acc = torch.promote_types(x.dtype, torch.float32)  # float32, or float64 for gradcheck
    xf = x.to(acc)
    g_mean, g_var = group_stats(xf, groups)  # on xf: one cast, one gradient to round
    inv = torch.rsqrt(torch.clamp(g_var, min=0.0) + eps).repeat_interleave(cpg, dim=-1)  # (B, C)
    scale, bias = member_rows(scale, batch), member_rows(bias, batch)
    a = inv * scale.to(acc)
    b = bias.to(acc) - g_mean.repeat_interleave(cpg, dim=-1) * a
    bshape = (batch,) + (1,) * (x.ndim - 2) + (c,)
    return xf * a.view(bshape) + b.view(bshape)


def group_stats(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's group mean and variance E[x^2] - mean^2 before
    :func:`group_norm_f32` clamps it at 0 (``(B, G)``, float32 or float64)."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    batch = x.shape[0]
    cpg = c // groups
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    spatial = tuple(range(1, x.ndim - 1))
    n = float(xf[0].numel() // c * cpg)
    ch_sum = xf.sum(dim=spatial)  # (B, C)
    ch_sumsq = (xf * xf).sum(dim=spatial)
    g_mean = ch_sum.view(batch, groups, cpg).sum(-1) / n  # (B, G)
    return g_mean, ch_sumsq.view(batch, groups, cpg).sum(-1) / n - g_mean * g_mean
