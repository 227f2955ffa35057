"""Member-folded linear ops: per-member weights on member-major folded rows
(port of ``diffuncertainty_tpu/ops/member_fold.py``).

A stacked ensemble (deep ensemble, SWAG draws, a materialized sub-ensemble)
of M members runs as one forward: activations are ``(M*B, H, W, C)`` with
member-major row blocks (row ``r`` belongs to member ``r // B``) and every
parameterized op takes the ``(M, ...)`` weights of all members at once.
The port's kernels are bound through ctypes on ``data_ptr()``, so a
``torch.func.vmap`` over ``functional_call`` cannot reach them: folded rows
are how the port batches members. Everything row-local (GroupNorm
statistics, attention, dropout, pooling, resampling) needs no member
awareness; the GroupNorm affine takes ``(M, C)`` (``ops/norm.py``).

- dense and 1x1 conv: one batched matmul ``(M, rows, Cin) x (M, Cin, Cout)``
  with the bias added in the same call (``torch.baddbmm``);
- a k x k conv: one cuDNN ``F.conv2d`` per member on its block of rows.
  Of the three formulations timed on the folded 16-member unet16 ensemble
  (16 images at 128x128 x TTA, bf16, an H100 80GB HBM3 at 700 W, PERF.md
  §6), this loop and one grouped conv over a member-in-channels view tied
  on the wall, and the JAX formulation (im2col patches times the member
  kernels in one batched matmul) took five times as long.

Weights are in the port's layout: conv ``(M, Cout, Cin, kh, kw)``, dense
``(M, Cout, Cin)``, bias ``(M, Cout)``; a conv kernel whose members are
channels-last (the sampler stores its stacks so) reaches cuDNN with no copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _members(rows: int, m: int, op: str) -> int:
    if rows % m:
        raise ValueError(f"{op}: folded rows ({rows}) not divisible by the member count ({m}): "
                         f"a silent reshape would mix rows across members")
    return rows // m


def member_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None
                 ) -> torch.Tensor:
    """Per-member dense on ``(M*B, ..., Cin)`` with ``(M, Cout, Cin)`` weights
    and ``(M, Cout)`` bias -> ``(M*B, ..., Cout)``."""
    m, cout, cin = weight.shape
    _members(x.shape[0], m, "member_dense")
    xm = x.reshape(m, -1, cin)
    wt = weight.transpose(1, 2)
    y = torch.bmm(xm, wt) if bias is None else torch.baddbmm(bias[:, None, :], xm, wt)
    return y.reshape(x.shape[:-1] + (cout,))


def member_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *,
                  stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Per-member conv on member-major folded rows.

    ``x`` ``(M*B, H, W, Cin)`` NHWC, ``weight`` ``(M, Cout, Cin, kh, kw)``,
    ``bias`` ``(M, Cout)`` or None, symmetric ``stride`` and ``pad`` (torch
    ``Conv2d(k, p)``) -> ``(M*B, Ho, Wo, Cout)`` in ``x``'s dtype.
    """
    m, _, _, kh, kw = weight.shape
    b = _members(x.shape[0], m, "member_conv2d")
    if kh == kw == 1 and stride == 1 and pad == 0:
        return member_dense(x, weight[..., 0, 0], bias)
    return torch.cat([F.conv2d(x[i * b:(i + 1) * b].permute(0, 3, 1, 2), weight[i],
                               None if bias is None else bias[i], stride=stride,
                               padding=pad).permute(0, 2, 3, 1)
                      for i in range(m)])
