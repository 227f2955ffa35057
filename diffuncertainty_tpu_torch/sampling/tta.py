"""Test-time augmentation on the device, invertible by construction (port of
``diffuncertainty_tpu/sampling/tta.py``).

Per image: a flip (probability ``hflip_p``), a rotation uniform in
``[-rotation_limit, rotation_limit]`` degrees and a scale ``1 + U[lo, hi]``
about the center, composed into one affine. The input is warped by the
forward map (constant-0 border), the prediction by the exact inverse
(replicate border), and the class simplex is renormalized.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.warp import (
    compose_affine,
    hflip_matrix,
    invert_affine,
    rotation_matrix,
    separable_margins,
    warp_affine,
    warp_affine_separable,
)


@dataclasses.dataclass(frozen=True)
class TTAConfig:
    hflip_p: float = 0.5
    rotation_limit: float = 22.5  # degrees, uniform in [-limit, limit]
    scale_limit: tuple[float, float] = (-0.2, 0.2)  # factor = 1 + U[lo, hi]
    separable_warp: bool = True  # two-pass warp; False -> composed single resample


class TTAParams(NamedTuple):
    forward: torch.Tensor  # (B, 2, 3) src->dst forward affine
    inverse: torch.Tensor  # (B, 2, 3) its inverse == the forward warp's dst->src
    separable: bool = False
    margin_x: int = 0
    margin_y: int = 0


def sample_tta_params(cfg: TTAConfig, generator: torch.Generator, batch: int,
                      height: int, width: int) -> TTAParams:
    """Draw per-image flip/rotation/scale on ``generator``'s device."""
    dev = generator.device
    flip = torch.rand(batch, generator=generator, device=dev) < cfg.hflip_p
    lim = cfg.rotation_limit
    angle = -lim + 2.0 * lim * torch.rand(batch, generator=generator, device=dev)
    lo, hi = cfg.scale_limit
    scale = 1.0 + (lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev))
    center = ((width - 1) / 2.0, (height - 1) / 2.0)
    rot = rotation_matrix(angle, scale, center)  # (B, 2, 3)
    flip_m = hflip_matrix(width, dev).expand(batch, 2, 3)
    ident = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], device=dev).expand(batch, 2, 3)
    forward = compose_affine(rot, torch.where(flip[:, None, None], flip_m, ident))
    if cfg.separable_warp:
        m_x, m_y = separable_margins(
            float(cfg.rotation_limit), 1.0 + float(lo), 1.0 + float(hi),
            cfg.hflip_p > 0.0, height, width,
        )
    else:
        m_x = m_y = 0
    return TTAParams(forward=forward, inverse=invert_affine(forward),
                     separable=cfg.separable_warp, margin_x=m_x, margin_y=m_y)


def apply_tta(images: torch.Tensor, params: TTAParams) -> torch.Tensor:
    """Warp the input batch by the forward transform (constant-0 border)."""
    if params.separable:
        return warp_affine_separable(images, params.inverse, border_mode="constant",
                                     margin_x=params.margin_x, margin_y=params.margin_y)
    return warp_affine(images, params.inverse, border_mode="constant")


def invert_tta(probs: torch.Tensor, params: TTAParams, eps: float = 1e-12) -> torch.Tensor:
    """Warp predictions back (replicate border) and renormalize the simplex."""
    if params.separable:
        restored = warp_affine_separable(probs, params.forward, border_mode="replicate",
                                         margin_x=params.margin_x, margin_y=params.margin_y)
    else:
        restored = warp_affine(probs, params.forward, border_mode="replicate")
    normalizer = restored.sum(dim=-1, keepdim=True)
    return torch.where(normalizer > eps, restored / normalizer.clamp(min=eps), restored)
