"""Stochastic Segmentation Networks: a low-rank multivariate normal over the
flattened logits (port of ``diffuncertainty_tpu/models/ssn.py:28-95``).

The distribution is three tensors from the SSN DiffUnet: mean (B, N), diag
(B, N) and factor (B, N, R), with N = H*W*C flattened in (H, W, C) order.

- ``build_distribution`` validates the covariance as torch's
  ``LowRankMultivariateNormal`` does, by a Cholesky factor of the capacitance
  matrix I + W^T D^-1 W. JAX's Cholesky returns NaN where it fails; torch's
  ``cholesky_ex`` reports ``info > 0`` and may leave a finite partial factor,
  so an element fails where ``info != 0``, the factor is not finite or an
  input is not finite. Its factor is zeroed (the diag-only fallback).
  ``cholesky_ex`` does not wait for the device the way ``cholesky`` does.
- The capacitance and its Cholesky factor are taken in float64. For a
  positive diag the matrix is positive definite by construction, but for
  the trained unet16 SSN at 128x128 it is ill-conditioned, and the rounding
  of a float32 sum over N = 32768 terms can make it indefinite: on the H100
  a float32 capacitance failed for 15 of 16 test images, whose draws then
  fell back to the diagonal. In float64 only a truly invalid covariance
  fails.
- ``sample``/``sample_n``: mean + W eps_R + sqrt(D) eps_N, the
  reparameterization torch uses; the normals come from :func:`draw_normal`.
- ``log_prob``: the Woodbury/capacitance form, O(N R^2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.mesh import draw_rows


class SSNDistribution(NamedTuple):
    mean: torch.Tensor  # (B, N)
    cov_diag: torch.Tensor  # (B, N) > 0
    cov_factor: torch.Tensor  # (B, N, R)
    cov_failed: torch.Tensor  # (B,) bool: fallback to diag-only


def draw_normal(shape: tuple, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """Standard normals of ``shape`` (S, rows, ...), drawn on the generator's
    device (per row, axis 1: ``draw_rows``)."""
    return draw_rows(lambda n, g: torch.randn((shape[0], n) + tuple(shape[2:]), generator=g,
                                              device=g.device, dtype=dtype),
                     shape[1], generator, axis=1)


def _capacitance(cov_diag: torch.Tensor, cov_factor: torch.Tensor) -> torch.Tensor:
    """I_R + W^T D^-1 W, per batch element, in float64."""
    w = cov_factor.double()
    wd = w / cov_diag.double()[..., None]  # (B, N, R)
    cap = torch.einsum("bnr,bns->brs", wd, w)
    return cap + torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)


def build_distribution(mean: torch.Tensor, cov_diag: torch.Tensor,
                       cov_factor: torch.Tensor) -> SSNDistribution:
    """Flag the elements whose low-rank covariance is invalid and zero their
    factor."""
    chol, info = torch.linalg.cholesky_ex(_capacitance(cov_diag, cov_factor))
    finite_inputs = (torch.isfinite(mean).all(dim=-1) & torch.isfinite(cov_diag).all(dim=-1)
                     & torch.isfinite(cov_factor).all(dim=(-2, -1)))
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1)) & finite_inputs
    failed = ~ok
    safe_factor = torch.where(failed[:, None, None], torch.zeros((), dtype=cov_factor.dtype,
                                                                 device=cov_factor.device),
                              cov_factor)
    return SSNDistribution(mean, cov_diag, safe_factor, failed)


def sample(dist: SSNDistribution, generator: torch.Generator) -> torch.Tensor:
    """One draw from the distribution; (B, N)."""
    return sample_n(dist, generator, 1)[0]


def sample_n(dist: SSNDistribution, generator: torch.Generator, num_samples: int) -> torch.Tensor:
    """(S, B, N) stack of draws, as ``distribution.sample([S])``: eps_R
    (S, B, R) first, then eps_N (S, B, N)."""
    b, n = dist.mean.shape
    r = dist.cov_factor.shape[-1]
    eps_r = draw_normal((num_samples, b, r), generator, dist.mean.dtype)
    eps_n = draw_normal((num_samples, b, n), generator, dist.mean.dtype)
    low_rank = torch.einsum("bnr,sbr->sbn", dist.cov_factor, eps_r)
    return dist.mean + low_rank + torch.sqrt(dist.cov_diag) * eps_n


def log_prob(dist: SSNDistribution, value: torch.Tensor) -> torch.Tensor:
    """Log density of (B, N) values; (B,), in ``value``'s dtype. Uses the
    Woodbury identity, in float64 like the capacitance."""
    diag, factor = dist.cov_diag.double(), dist.cov_factor.double()
    delta = value.double() - dist.mean.double()
    d_inv_delta = delta / diag
    quad_diag = (delta * d_inv_delta).sum(dim=-1)
    wt_d_delta = torch.einsum("bnr,bn->br", factor, d_inv_delta)
    chol, _ = torch.linalg.cholesky_ex(_capacitance(diag, factor))
    sol = torch.cholesky_solve(wt_d_delta[..., None], chol)[..., 0]
    quad = quad_diag - (wt_d_delta * sol).sum(dim=-1)
    logdet = (2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
              + torch.log(diag).sum(dim=-1))
    n = dist.mean.shape[-1]
    return (-0.5 * (quad + logdet + n * math.log(2.0 * math.pi))).to(value.dtype)
